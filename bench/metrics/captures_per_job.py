"""CUDA graphs captured a traced job (`sampler.captures` over its call
record): what each `run()` pays before its first replay."""
from bench.common import load_module


def read(run):
    program = load_module("metrics", "_program", run.root / "bench")
    return program.per_job(run, lambda c: c["counts"].get("sampler.captures", 0))
