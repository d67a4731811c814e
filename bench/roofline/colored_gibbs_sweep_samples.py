"""The coloured Gibbs sweep of many disorder samples (`kernels/sparse_gather.py::
colored_gibbs_sweep` on per-sample couplings, `csrc/colored_gibbs.cu`'s
`colored_gibbs_samples_kernel`: one launch for all B rows, row r on sample
r // (B / S)) in f32: the work its inputs need, counted as
`colored_gibbs_sweep.py` counts the one-table kernel's, frozen here. Each
input read once and the output written once: the spins read and written
(2 B n), one uniform a site updated (B n), the neighbour indices (n D), the
S samples' couplings (S n D), b (n), the colour masks (C n) and beta (B),
all 4 bytes; 2 D + 6 f32 operations a site updated. At (B, n, S, D, C) =
(512, 32768, 128, 6, 2) (the 3D EA glass at L = 32, 128 samples x 4
replicas): 303.2 MB, 90.5 us at 3.35 TB/s; 0.30 GFLOP, 4.5 us."""
from __future__ import annotations

from bench import peaks

TRACE_NAMES = ("colored_gibbs_samples_kernel",)


def work(shape: dict) -> tuple[float, float, float]:
    """(bytes, operations, peak operations a second) of one sweep; `shape`
    gives chains, sites, samples, degree (the neighbour slots D) and
    colours (C)."""
    B, n, S = shape["chains"], shape["sites"], shape["samples"]
    D, C = shape["degree"], shape["colours"]
    return (4 * (3 * B * n + n * D + S * n * D + n + C * n + B), B * n * (2 * D + 6),
            peaks.FP32_OPS_PER_S)
