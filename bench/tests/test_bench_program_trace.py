"""The readers of the program's own spans and counters (`repro_torch.tracing`)
on a synthetic trace and synthetic call records."""
import types

import pytest

from bench import trace
from bench.common import load_module
from bench_tiny import REPO
from repro_torch import tracing

READERS = ("captures_per_job", "allocs_per_job", "capture_ms", "eager_ms", "capture_idle_ms",
           "eager_idle_ms")


def _trace():
    # two jobs, [0, 10] and [12, 20] s; in the first the device is busy [1, 3]
    # and [5, 6], in the second [13, 15]
    jobs = [(0.0, 10.0), (12.0, 20.0)]
    ops = [("warm_kernel", -4.0, -3.0, "kernel"), ("tau_leap_kernel", 1.0, 3.0, "kernel"),
           ("uniform_kernel", 5.0, 6.0, "kernel"), ("tau_leap_kernel", 13.0, 15.0, "kernel")]
    host = [("bench.job", 0.0, 10.0), ("cudaFree", 4.2, 4.8), ("bench.job", 12.0, 20.0)]
    return trace.Trace(jobs, ops, host)


S = 1_000_000_000  # ns


def _record(start, spans, captures=1, eager=1, segments=(3, 2), length=7.5):
    """A call record starting at `start` s on the program's clock, with
    (name, start, end) spans in s from its start."""
    counts = {"sampler.captures": captures, "sampler.eager_blocks": eager, "sampler.calls": 1,
              "tau_leap.launches": 4000}
    if segments is not None:
        counts.update({"cuda.segment.all.allocated": segments[0],
                       "cuda.segment.all.freed": segments[1]})
    t0 = int(start * S)
    return {"name": "sampler.run", "start_ns": t0, "end_ns": t0 + int(length * S),
            "spans": [{"name": n, "start_ns": t0 + int(a * S), "end_ns": t0 + int(b * S)}
                      for n, a, b in spans],
            "counts": counts}


JOB1 = [("sampler.validate", 0.0, 0.4), ("sampler.eager", 0.5, 2.0),  # idle 0.5 of it
        ("sampler.capture", 4.0, 8.0)]  # idle 3 of its 4
JOB2 = [("sampler.eager", 0.5, 2.0),  # [12.5, 14]: idle 0.5
        ("sampler.capture", 4.0, 5.0)]  # [16, 17]: idle 1
# the warm job's record first, then the two traced jobs'
RECORDS = [_record(0.5, [("sampler.capture", 0.0, 99.0)], 9, 9, (50, 50), 99.0),
           _record(1.0, JOB1, segments=(3, 2)), _record(50.0, JOB2, segments=(5, 0))]


@pytest.fixture
def run(monkeypatch):
    monkeypatch.setattr(tracing, "calls", lambda: list(RECORDS))
    return types.SimpleNamespace(trace=_trace(), traced_jobs=2, root=REPO)


def _read(name, run):
    return load_module("metrics", name, REPO / "bench").read(run)


def test_counters_and_host_spans_are_means_over_the_last_traced_records(run):
    assert _read("captures_per_job", run) == 1.0
    assert _read("allocs_per_job", run) == 5.0
    assert _read("capture_ms", run) == pytest.approx(2.5e3)
    assert _read("eager_ms", run) == pytest.approx(1.5e3)


def test_device_idle_while_a_span_is_open(run):
    # capture: 3 (job 1) + 1 (job 2); eager: 0.5 + 0.5; ms a job
    assert _read("capture_idle_ms", run) == pytest.approx(2e3)
    assert _read("eager_idle_ms", run) == pytest.approx(0.5e3)
    assert _read("capture_idle_ms", run) + _read("eager_idle_ms", run) <= load_module(
        "metrics", "job_idle_ms").read(run)


@pytest.mark.parametrize("name", READERS)
def test_fewer_records_than_traced_jobs_read_none(name, run, monkeypatch):
    monkeypatch.setattr(tracing, "calls", lambda: RECORDS[-1:])
    assert _read(name, run) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_tracing_or_a_run_without_a_trace_reads_none(name, run, monkeypatch):
    program = load_module("metrics", "_program", REPO / "bench")
    monkeypatch.setattr(program, "_tracing", lambda: None)
    assert _read(name, run) is None
    monkeypatch.undo()
    assert _read(name, types.SimpleNamespace(trace=None, traced_jobs=0, root=REPO)) is None


def test_a_record_that_outlasts_its_job_reads_none(run, monkeypatch):
    long = [RECORDS[0], RECORDS[1], _record(50.0, JOB2, length=8.5)]  # job 2 spans 8 s
    monkeypatch.setattr(tracing, "calls", lambda: long)
    assert _read("capture_idle_ms", run) is None and _read("eager_idle_ms", run) is None
    assert _read("eager_ms", run) == pytest.approx(1.5e3)


def test_a_record_without_allocator_counters_reads_none(run, monkeypatch):
    bare = [_record(1.0, JOB1, 2, segments=None), _record(50.0, JOB2, 2, segments=None)]
    monkeypatch.setattr(tracing, "calls", lambda: bare)
    assert _read("allocs_per_job", run) is None
    assert _read("captures_per_job", run) == 2.0
