"""Launches of the per-sample colour sweep a step (the program's
`launch.colored_gibbs_sweep_samples` counter over a traced job's call
record, graph replays included, over the job's steps): 1.0 where a sweep of
every sample's replicas is one launch. A program without the counter reads
None."""
from bench.common import load_module


def read(run):
    program = load_module("metrics", "_program", run.root / "bench")
    launches = program.per_job(run, lambda c: c["counts"].get("launch.colored_gibbs_sweep_samples"))
    return None if launches is None else launches / run.cell.steps_per_job
