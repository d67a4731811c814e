"""Device us a step in kernels other than the cell's hand-written step
kernel (uniforms, first-hit energy, bookkeeping); all of the step where the
cell has no step kernel."""


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    total, _ = run.trace.kernel_seconds()
    kernel = run.spec.traffic.get("step_kernel")
    own = run.trace.kernel_seconds(run.roofline(kernel).TRACE_NAMES)[0] if kernel else 0.0
    return (total - own) / run.traced_steps * 1e6
