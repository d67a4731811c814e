"""Device idle ms inside each traced job's span, averaged over the jobs:
the call's host work (validation and its sync, init, eager blocks, graph
captures, result copies)."""


def read(run):
    if run.trace is None:
        return None
    idle = run.trace.job_idle_s()
    return sum(idle) / len(idle) * 1e3
