"""The lattice Gibbs sweep kernel (`kernels/lattice_gibbs.py::
lattice_gibbs_sweep`, the plan kernel of `csrc/lattice_gibbs.cu`) in f32:
the work its inputs need, as `chip_smoke.py` counts it, frozen here. The
spins read and written once (2 B HW), one uniform a free site (B * sites
updated, not the whole (C, B, H, W) draw), the weight planes, b, the clamp
value, the colour and frozen planes (8 + 1 + 4 + 2 planes of HW) and beta
(B), all f32; 22 f32 operations a site updated (8 multiplies and 9 adds,
beta, -2, exp, an add, a divide)."""
from __future__ import annotations

from bench import peaks

TRACE_NAMES = ("lattice_gibbs_plan",)


def work(shape: dict) -> tuple[float, float, float]:
    """(bytes, operations, peak operations a second) of one sweep with every
    site free."""
    B, HW = shape["chains"], shape["sites"]
    updated = HW
    return (4 * (2 * B * HW + B * updated + 8 * HW + HW + 4 * HW + 2 * HW + B),
            B * updated * 22, peaks.FP32_OPS_PER_S)
