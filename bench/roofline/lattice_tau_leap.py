"""One tau-leap step of chains on the king's lattice (CD's model phase,
plain torch in the program: no kernel of its own): the work its inputs
need. The spins read and written once and one uniform a site (3 * 4 B HW),
the weight planes and b (9 * 4 HW); per site 8 multiplies and 8 adds, b,
2 h s, sigma (exp, add, divide), dt * rate, exp, 1 - p and the compare:
24 f32 operations."""
from __future__ import annotations

from bench import peaks

TRACE_NAMES = ()


def work(shape: dict) -> tuple[float, float, float]:
    B, HW = shape["chains"], shape["sites"]
    return 3 * 4 * B * HW + 9 * 4 * HW, 24.0 * B * HW, peaks.FP32_OPS_PER_S
