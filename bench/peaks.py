"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its 700 W limit) and the least time of a piece of work on it: the
arithmetic of `chip_smoke.py`'s `bound()`, frozen here."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12  # outside the tensor cores


def bound_s(bytes_moved: float, ops: float, ops_per_s: float) -> float:
    """Least seconds for the work: the larger of its bytes over the memory's
    bandwidth and its operations over the peak rate."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s)
