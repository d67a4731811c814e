"""The coloured Gibbs sweep kernel (`kernels/sparse_gather.py::
colored_gibbs_sweep`, `csrc/colored_gibbs.cu` over a colour plan) in f32:
the work its inputs need, as `chip_smoke.py` counts it, frozen here. Each
input read once and the output written once: the spins read and written
(2 B n), one uniform a site updated (B n, every site in one colour class,
not the whole (C, B, n) draw), the neighbour indices and couplings (2 n D),
b (n), the colour masks (C n) and beta (B), all 4 bytes; 2 D + 6 f32
operations a site updated (D multiplies and D adds, b, beta, -2, exp, an
add, a divide). At (256, 16384), D = 3, C = 4: 51.1 MB, 15.2 us."""
from __future__ import annotations

from bench import peaks

TRACE_NAMES = ("colored_gibbs_kernel",)


def work(shape: dict) -> tuple[float, float, float]:
    """(bytes, operations, peak operations a second) of one sweep; `shape`
    gives chains, sites, degree (the neighbour slots D) and colours (C)."""
    B, n = shape["chains"], shape["sites"]
    D, C = shape["degree"], shape["colours"]
    updated = n
    return (4 * (2 * B * n + B * updated + 2 * n * D + n + C * n + B),
            B * updated * (2 * D + 6), peaks.FP32_OPS_PER_S)
