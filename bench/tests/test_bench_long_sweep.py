"""The readers this configuration's cell adds: the long-row sweep's frozen
work (its bound at the cell's shape, the one `chip_smoke.py` publishes) and
`colour_plan_ms` over synthetic call records, None on a program without the
span."""
import types

import pytest

from bench import peaks
from bench.common import load_module
from bench_tiny import REPO
from repro_torch import tracing

S = 1_000_000_000  # ns
SHAPE = {"chains": 64, "sites": 512000, "degree": 6, "colours": 2}


def test_the_long_sweeps_bound_at_the_cells_shape():
    module = load_module("roofline", "colored_gibbs_sweep_long")
    nbytes, ops, rate = module.work(SHAPE)
    assert nbytes == 4 * (3 * 64 * 512000 + 2 * 512000 * 6 + 512000 + 2 * 512000 + 64)
    assert nbytes == pytest.approx(423.9e6, rel=1e-4) and ops == pytest.approx(0.59e9, rel=1e-2)
    assert peaks.bound_s(nbytes, ops, rate) * 1e6 == pytest.approx(126.5, abs=0.05)
    assert ops / rate * 1e6 == pytest.approx(8.8, abs=0.05)  # bound by bytes
    # counted as the shared-memory kernel's work is
    short = load_module("roofline", "colored_gibbs_sweep").work(SHAPE)
    assert (nbytes, ops, rate) == short
    # the pack names a call once; the phases and the unpack add their time
    assert module.TRACE_NAMES[0] == "colored_gibbs_long_pack" and len(module.TRACE_NAMES) == 3


def _record(start, spans):
    t0 = int(start * S)
    return {"name": "sampler.run", "start_ns": t0, "end_ns": t0 + 5 * S, "counts": {},
            "spans": [{"name": n, "start_ns": t0 + int(a * S), "end_ns": t0 + int(b * S)}
                      for n, a, b in spans]}


PLAN = [("sampler.validate", 0.0, 0.1), ("sampler.init", 0.1, 0.5),
        ("sampler.colour_plan", 0.2, 0.4)]


def _read(records, monkeypatch, traced=2):
    monkeypatch.setattr(tracing, "calls", lambda: list(records))
    run = types.SimpleNamespace(trace=object(), traced_jobs=traced, root=REPO)
    return load_module("metrics", "colour_plan_ms", REPO / "bench").read(run)


def test_colour_plan_ms_is_the_mean_host_time_in_the_span(monkeypatch):
    records = [_record(0.0, PLAN), _record(9.0, PLAN),
               _record(20.0, PLAN[:2] + [("sampler.colour_plan", 0.2, 0.3)])]
    assert _read(records, monkeypatch) == pytest.approx(150.0)  # (200 + 100) / 2 ms


def test_colour_plan_ms_reads_none_without_the_span(monkeypatch):
    # the parent's program: the same calls with no colour plan span
    assert _read([_record(0.0, PLAN[:2]), _record(9.0, PLAN[:2])], monkeypatch) is None
    # fewer records than traced jobs
    assert _read([_record(0.0, PLAN)], monkeypatch) is None
