"""Device idle ms a traced job while a `sampler.capture` span was open (the
call records' spans on the profiler's clock): the part of `job_idle_ms`
that graph captures hold."""
from bench.common import load_module


def read(run):
    program = load_module("metrics", "_program", run.root / "bench")
    return program.idle_ms(run, "sampler.capture")
