"""CUDA kernel: int8 binary dot-product engine (dense local fields).

h = (s @ J^T) * scale + b with int8 operands and exact int32 accumulation;
source `csrc/dense_field.cu` over the shared mainloop `csrc/int8_field.cuh`.

Replaces the TPU kernel `repro/kernels/dense_field.py::dense_field`
(`_dense_field_kernel`, the `pl.pallas_call` at line 72).

What bounds it on the H100: at B = 256 chains and N = 2048 sites it moves
about 6.8 MB (J 4.2 MB, s 0.5 MB, h out 2.1 MB), about 2.0 µs at
3.35 TB/s, against 2.15 G int8 operations, about 1.1 µs at 1,979 TOPS: it
is memory-bound, bound about 2.0 µs.

What the design does about it: the mainloop it shares with tau_leap_step
(`int8_field.cuh`) reads J in place, row-major (site i reads row i of J
along k, no transposed or padded copy as the TPU wrapper makes), through a
4-stage cp.async ring of 128-byte k tiles that keeps three tiles in flight
during the MMAs (16-byte copies when N % 16 == 0, a scalar path
otherwise); the int8 products run on the tensor cores (mma.sync m16n8k32,
exact int32 sums) in 64 x 64 output tiles of 8 warps, k split between the
two blocks of a thread-block cluster, so (256, 2048) runs 256 blocks; the
partial sums meet in distributed shared memory; ragged B, N and k edges
are zero-filled in shared memory, not padded in device memory; the
epilogue writes coalesced rows.
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_cuda, check_spins, check_tensor


def dense_field(
    s_i8: torch.Tensor, j_i8: torch.Tensor, b: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """Launch the CUDA kernel: (B,N) int8 spins, (N,N) int8 codes, (N,) f32
    bias and () f32 scale, all contiguous on one sm_90 device -> (B,N) f32."""
    dev = check_cuda(s_i8)
    B, N = check_spins("s_i8", s_i8)
    check_tensor("s_i8", s_i8, torch.int8, (B, N), dev)
    check_tensor("j_i8", j_i8, torch.int8, (N, N), dev)
    check_tensor("b", b, torch.float32, (N,), dev)
    check_tensor("scale", scale, torch.float32, (), dev)
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    if B == 0 or N == 0:
        return out
    code = _build.launcher("dense_field")(
        s_i8.data_ptr(), j_i8.data_ptr(), b.data_ptr(), scale.data_ptr(),
        out.data_ptr(), B, N, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("dense_field", code)
    tracing.count("launch.dense_field")
    return out
