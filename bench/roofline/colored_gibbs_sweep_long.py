"""The long-row coloured Gibbs sweep (`kernels/sparse_gather.py::
colored_gibbs_sweep` for rows of n > 116224 sites, `csrc/colored_gibbs_long.cu`:
a pack, one launch a colour, an unpack) in f32: the work its inputs need,
counted as `colored_gibbs_sweep.py` counts the shared-memory kernel's,
frozen here. Each input read once and the output written once: the spins
read and written (2 B n), one uniform a site updated (B n, every site in one
colour class, not the whole (C, B, n) draw), the neighbour indices and
couplings (2 n D), b (n), the colour masks (C n) and beta (B), all 4 bytes;
2 D + 6 f32 operations a site updated. At (64, 512000), D = 6, C = 2 (the 3D
EA lattice at L = 80): 423.9 MB, 126.5 us; 0.59 GFLOP, 8.8 us.

A call's time is the sum of its launches' (`TRACE_NAMES`); the first name,
the pack, runs once a call and counts the calls."""
from __future__ import annotations

from bench import peaks

TRACE_NAMES = ("colored_gibbs_long_pack", "colored_gibbs_long_phase",
               "colored_gibbs_long_unpack")


def work(shape: dict) -> tuple[float, float, float]:
    """(bytes, operations, peak operations a second) of one sweep; `shape`
    gives chains, sites, degree (the neighbour slots D) and colours (C)."""
    B, n = shape["chains"], shape["sites"]
    D, C = shape["degree"], shape["colours"]
    return 4 * (3 * B * n + 2 * n * D + n + C * n + B), B * n * (2 * D + 6), peaks.FP32_OPS_PER_S
