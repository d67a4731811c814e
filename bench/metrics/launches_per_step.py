"""Device kernels in the trace over the traced steps (graph replays count
each kernel they run)."""


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    return run.trace.kernel_seconds()[1] / run.traced_steps
