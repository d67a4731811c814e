"""Launches of the CTMC's event kernel a step (the program's
`launch.ctmc_event` counter over a traced job's call record, graph replays
included, over the job's steps): 1.0 where an event of every chain is one
launch. A program without the counter reads None."""
from bench.common import load_module


def read(run):
    program = load_module("metrics", "_program", run.root / "bench")
    launches = program.per_job(run, lambda c: c["counts"].get("launch.ctmc_event"))
    return None if launches is None else launches / run.cell.steps_per_job
