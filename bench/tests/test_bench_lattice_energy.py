"""The reader of the program's lattice energy counter
(`launch.lattice_energy`) on synthetic call records, as
`test_bench_reuses.py` reads the kept-run counter."""
import types

import pytest

from bench.common import load_module
from bench_tiny import REPO
from repro_torch import tracing

STEPS = 500  # the sweeps of a king16.cal_solve or king16.cal_anneal job


def _record(launches):
    """A call record whose counters hold `launches` (left out where None)."""
    counts = {"sampler.calls": 1, "launch.lattice_gibbs_sweep": STEPS}
    if launches is not None:
        counts["launch.lattice_energy"] = launches
    return {"name": "sampler.run", "start_ns": 0, "end_ns": 1, "spans": [], "counts": counts}


def _read(records, monkeypatch, traced_jobs=2):
    monkeypatch.setattr(tracing, "calls", lambda: list(records))
    run = types.SimpleNamespace(trace=object(), traced_jobs=traced_jobs, root=REPO,
                                cell=types.SimpleNamespace(steps_per_job=STEPS))
    return load_module("metrics", "lattice_energy_per_step", REPO / "bench").read(run)


@pytest.mark.parametrize("launches,want", [
    (STEPS + 2, 1.004),  # first hit: a launch a sweep, the start state's, the samples'
    (2, 0.004),  # no first hit: the start state's and the samples'
])
def test_launches_a_step_over_the_traced_records(launches, want, monkeypatch):
    records = [_record(0), _record(launches), _record(launches)]  # the warm job's, then two
    assert _read(records, monkeypatch) == pytest.approx(want, rel=1e-12)


def test_a_program_without_the_counter_reads_none(monkeypatch):
    assert _read([_record(None), _record(None), _record(None)], monkeypatch) is None
    assert _read([_record(2)], monkeypatch) is None  # fewer records than traced jobs
    program = load_module("metrics", "_program", REPO / "bench")
    monkeypatch.setattr(program, "_tracing", lambda: None)
    assert _read([_record(2), _record(2)], monkeypatch) is None
