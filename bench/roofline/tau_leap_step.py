"""The dense tau-leap step kernel (`kernels/tau_leap.py::tau_leap_step`,
`csrc/tau_leap.cu`: a spin-packing launch, then the int8 product with the
flip in its epilogue): the work its inputs need, as `chip_smoke.py` counts
it, frozen here. Each input read once, the output written once: J as int8
codes (N^2), the f32 spins, uniforms and new spins (3 * 4 B N), b (4 N),
beta (4 B), scale and dt (8); 2 B N^2 int8 operations."""
from __future__ import annotations

from bench import peaks

# the kernels of one call, as the device trace names them; the first is
# launched once a call
TRACE_NAMES = ("tau_leap_kernel", "pack_spins_kernel")


def work(shape: dict) -> tuple[float, float, float]:
    """(bytes, operations, peak operations a second) of one call."""
    B, N = shape["chains"], shape["sites"]
    return N * N + 3 * 4 * B * N + 4 * N + 4 * B + 8, 2.0 * B * N * N, peaks.INT8_OPS_PER_S
