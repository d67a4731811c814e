"""Host ms a traced job inside `sampler.eager` spans (the program's call
records): the step loop's blocks run eagerly."""
from bench.common import load_module


def read(run):
    program = load_module("metrics", "_program", run.root / "bench")
    return program.per_job(run, lambda c: program.span_ms(c, "sampler.eager"))
