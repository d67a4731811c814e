"""Host ms a traced job inside `sampler.capture` spans (the program's call
records): graph captures, with torch's device sync and cache emptying on
entering each."""
from bench.common import load_module


def read(run):
    program = load_module("metrics", "_program", run.root / "bench")
    return program.per_job(run, lambda c: program.span_ms(c, "sampler.capture"))
