"""Arithmetic that several metric readers share: a kernel's share of its
roofline and the least time of a cell's step."""
from __future__ import annotations

from bench import peaks


def roofline_pct(run, kernel: str):
    """The least time of one call of `kernel` (its frozen bytes and
    operations at the cell's shape) over the mean traced time of a call, in
    %; None where the cell's step kernel is another or the trace holds no
    call of it."""
    if run.trace is None or run.spec.traffic.get("step_kernel") != kernel:
        return None
    module = run.roofline(kernel)
    secs, _ = run.trace.kernel_seconds(module.TRACE_NAMES)
    _, calls = run.trace.kernel_seconds(module.TRACE_NAMES[:1])
    if calls == 0 or secs <= 0:
        return None
    return 100.0 * peaks.bound_s(*module.work(run.cell.shape)) / (secs / calls)


def step_bound_s(run) -> float:
    """Least time of one step's needed work: the step's own (`step_work`'s
    frozen bytes and operations), plus, where first-hit is tracked, an
    energy of O(chains * sites) f32 operations."""
    nbytes, ops, rate = run.roofline(run.spec.traffic["step_work"]).work(run.cell.shape)
    t = peaks.bound_s(nbytes, ops, rate)
    if getattr(run.cell, "first_hit", None) is not None:
        t += 2.0 * run.cell.shape["chains"] * run.cell.shape["sites"] / peaks.FP32_OPS_PER_S
    return t
