"""Launches of the lattice energy kernel a step (the program's
`launch.lattice_energy` counter over a traced job's call record, graph
replays included, over the job's steps): 1.004 in a first-hit job of 500
sweeps (a launch a sweep, the start state's and the samples'), 0.004 without
first hit. A program without the counter reads None."""
from bench.common import load_module


def read(run):
    program = load_module("metrics", "_program", run.root / "bench")
    launches = program.per_job(run, lambda c: c["counts"].get("launch.lattice_energy"))
    return None if launches is None else launches / run.cell.steps_per_job
