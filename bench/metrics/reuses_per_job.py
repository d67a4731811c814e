"""`run()` calls a traced job that took the run an earlier call kept
(`sampler.reuses` over its call record): calls that replayed that run's
graphs instead of warming up and capturing their own. A program without
the counter reads None."""
from bench.common import load_module


def read(run):
    program = load_module("metrics", "_program", run.root / "bench")
    return program.per_job(run, lambda c: c["counts"].get("sampler.reuses"))
