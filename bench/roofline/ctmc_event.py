"""The dense CTMC's event kernel (`kernels/ctmc_event.py::ctmc_event`,
`csrc/ctmc_event.cu`: one Gillespie event of every chain): the work its
inputs need, frozen here. A chain's spins and fields read once, its fields
written once and one row of J read (4 * 4 B n bytes), and its scalars: beta,
the Exp(1) draw, the uniform, the energy and the time read, the energy and
the time written (7 * 4 B). Operations: a chain's n rates, 8 each (beta h,
2 x, x s, the negation, exp, 1 + e, the divide, lambda0 p), its tree's
m - 1 adds (m the next power of two >= n) and its n field updates, 2 each,
at the f32 peak."""
from __future__ import annotations

from bench import peaks

TRACE_NAMES = ("ctmc_event_kernel",)
RATE_OPS = 8


def work(shape: dict) -> tuple[float, float, float]:
    """(bytes, operations, peak operations a second) of one call."""
    B, n = shape["chains"], shape["sites"]
    m = 1 << (n - 1).bit_length()
    return 16 * B * n + 7 * 4 * B, B * (RATE_OPS * n + (m - 1) + 2 * n), peaks.FP32_OPS_PER_S
