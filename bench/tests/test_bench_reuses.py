"""The reader of the program's kept-run counter (`sampler.reuses`) on
synthetic call records, as `test_bench_program_trace.py` reads the others."""
import types

import pytest

from bench.common import load_module
from bench_tiny import REPO
from repro_torch import tracing


def _record(reuses):
    """A call record whose counters hold `reuses` (left out where None)."""
    counts = {"sampler.calls": 1, "sampler.captures": 0}
    if reuses is not None:
        counts["sampler.reuses"] = reuses
    return {"name": "sampler.run", "start_ns": 0, "end_ns": 1, "spans": [], "counts": counts}


def _read(records, monkeypatch, traced_jobs=2):
    monkeypatch.setattr(tracing, "calls", lambda: list(records))
    run = types.SimpleNamespace(trace=object(), traced_jobs=traced_jobs, root=REPO)
    return load_module("metrics", "reuses_per_job", REPO / "bench").read(run)


@pytest.mark.parametrize("records,want", [
    ([_record(0), _record(1), _record(1)], 1.0),  # the warm job's record, then two hits
    ([_record(1), _record(0), _record(1)], 0.5),
    ([_record(0), _record(0), _record(0)], 0.0),  # a program that keeps runs and missed
])
def test_reuses_are_the_mean_over_the_traced_records(records, want, monkeypatch):
    assert _read(records, monkeypatch) == want


def test_a_program_without_the_counter_reads_none(monkeypatch):
    assert _read([_record(None), _record(None), _record(None)], monkeypatch) is None
    assert _read([_record(1)], monkeypatch) is None  # fewer records than traced jobs
    program = load_module("metrics", "_program", REPO / "bench")
    monkeypatch.setattr(program, "_tracing", lambda: None)
    assert _read([_record(1), _record(1)], monkeypatch) is None
