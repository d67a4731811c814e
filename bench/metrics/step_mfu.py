"""The least time of one step's needed work at the published peaks over the
window's seconds a step (host clock, every job the profiler did not see),
%."""
from bench.readers import step_bound_s


def read(run):
    latencies, seconds = run.untraced
    steps = len(latencies) * run.cell.steps_per_job
    if not steps:
        return None
    return 100.0 * step_bound_s(run) / (seconds / steps)
