"""What the readers of the program's own spans and counters share
(`repro_torch.tracing`, imported when read): the call records of the traced
jobs, and the device's idle time while a span was open. A program without
that module, or a run without a trace, reads None."""
from bench.trace import covered, union


def _tracing():
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing


def traced_calls(run):
    """The call records of the traced jobs: the last `run.traced_jobs` the
    program kept (the profiler's warm job comes before them); None where
    there are fewer."""
    tracing = _tracing()
    if run.trace is None or tracing is None or not run.traced_jobs:
        return None
    calls = tracing.calls()
    return calls[-run.traced_jobs:] if len(calls) >= run.traced_jobs else None


def per_job(run, value):
    """The mean over the traced jobs' call records of `value(record)`."""
    calls = traced_calls(run)
    if calls is None:
        return None
    values = [value(c) for c in calls]
    return None if None in values else sum(values) / len(values)


def span_ms(record, name: str) -> float:
    """Host ms of a call record inside its spans named `name`."""
    return sum(s["end_ns"] - s["start_ns"] for s in record["spans"] if s["name"] == name) * 1e-6


def idle_ms(run, name: str):
    """Device idle ms a traced job while a span `name` was open on the host.
    The call record's spans are put on the profiler's clock by its job: the
    record's outermost span starts as the job's `bench.job` span does (the
    job's first call). None where a record outlasts its job's span, which
    would mean the two do not belong together."""
    calls = traced_calls(run)
    if calls is None or len(run.trace.jobs) != len(calls):
        return None
    merged = run.trace.merged()
    idle = 0.0
    for (a, b), call in zip(run.trace.jobs, calls):
        if (call["end_ns"] - call["start_ns"]) * 1e-9 > b - a:
            return None

        def at(t_ns):
            return a + (t_ns - call["start_ns"]) * 1e-9

        spans = union((at(s["start_ns"]), min(at(s["end_ns"]), b))
                      for s in call["spans"] if s["name"] == name)
        idle += sum((y - x) - covered(merged, x, y) for x, y in spans)
    return idle / len(calls) * 1e3
