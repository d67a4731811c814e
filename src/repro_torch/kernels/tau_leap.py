"""CUDA kernel: fused dense tau-leap PASS update step.

One asynchronous-model step for a dense problem, all chains at once as the
B rows of one launch: int8 tensor-core field product -> flip rates ->
Bernoulli flips against the given uniforms -> new state, with the flip in
the product's epilogue (fields never round-trip to device memory). Source
`csrc/tau_leap.cu` over the shared mainloop `csrc/int8_field.cuh`.

Replaces the TPU kernel `repro/kernels/tau_leap.py::tau_leap_step`
(`_tau_leap_kernel`, the `pl.pallas_call` at line 82). The JAX driver
vmaps a B = 1 call per chain; here each row carries its own beta, folded
as f32(beta*scale) and f32(beta*b_j), so a row rounds as that B = 1 call.

What bounds it on the H100: at B = 256 chains and N = 2048 sites it moves
about 10.5 MB (J 4.2 MB, s, u and the new s 2.1 MB each), about 3.1 µs at
3.35 TB/s, against 2.15 G int8 operations, about 1.1 µs at 1,979 TOPS: it
is memory-bound, bound about 3.1 µs.

What the design does about it: the f32 spins are converted to int8 once
per step by a small packing launch into a scratch tensor whose rows are
padded to 16 bytes and zero past N (the TPU wrapper casts them in a
separate pass too), so the mainloop reads s in 16-byte cp.async copies at
any N, through a 4-stage ring that keeps three tiles in flight during the
MMAs; J is read in place, row-major and unpadded (16-byte copies when
N % 16 == 0, a scalar path otherwise); the products run on the tensor
cores (mma.sync m16n8k32, exact int32 sums) in 64 x 64 output tiles of 8
warps, k split between the two blocks of a thread-block cluster, so
(256, 2048) runs 256 blocks; the epilogue (dequantize, sigmoid, exp,
compare, flip) runs on the summed int32 tile with coalesced reads of s and
u, issued before the mainloop, and coalesced writes of the new s. One C
launcher issues both launches on the current stream; a call counts one
`launch.tau_leap_step` in `repro_torch.tracing`.

The fault variant (field noise): given a (B,N) bias, the whole per-row
b + eta, the epilogue reads bias[r][c] in place of b[c], each with the
coalesced loads of s and u before the mainloop, and forms f32(beta_r *
bias[r][c]) as the base kernel forms f32(beta_r * b_c): row r rounds as
the JAX B = 1 call with b = beta_r * (b + eta_r). It is the same kernel
with a template flag, its own C entry point, counted as `launch.tau_leap_step_faults`.
It moves 2.1 MB more at (256, 2048): about 12.6 MB, bound 3.8 µs. Stuck
and dropped sites need no variant: the caller warps their uniforms to 1.0
(a flip needs u < p <= 1).
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_cuda, check_spins, check_tensor

SPIN_ROW_ALIGN = 16  # bytes: the packed int8 spins' row stride is a multiple of this


def padded_cols(n: int) -> int:
    """Row stride, in int8 columns, of the packed spins of an n-site state."""
    return -(-n // SPIN_ROW_ALIGN) * SPIN_ROW_ALIGN


def _launch(s, s8, j_i8, b, scale, beta, uniforms, dt, out, device) -> None:
    """Both launches of one step (pack the spins into s8, then the fused
    product and flip) on the device's current stream; raise on a CUDA error.
    A (B,N) b takes the per-row bias variant."""
    B, N = s.shape
    code = _build.launcher("tau_leap" if b.ndim == 1 else "tau_leap_faults")(
        s.data_ptr(), s8.data_ptr(), j_i8.data_ptr(), b.data_ptr(), scale.data_ptr(),
        beta.data_ptr(), uniforms.data_ptr(), dt.data_ptr(), out.data_ptr(), B, N,
        s8.shape[1], torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check("tau_leap_step", code)


def tau_leap_step(
    s: torch.Tensor,
    j_i8: torch.Tensor,
    b: torch.Tensor,
    scale: torch.Tensor,
    uniforms: torch.Tensor,
    dt: torch.Tensor,
    beta: torch.Tensor,
) -> torch.Tensor:
    """Launch the CUDA kernel: (B,N) f32 ±1 spins, (N,N) int8 codes, (N,)
    f32 bias, () f32 scale, (B,N) f32 uniforms, () f32 dt and (B,) f32
    per-row beta, all contiguous on one sm_90 device -> new (B,N) f32 spins
    in a fresh tensor (never aliasing `s`). A (B,N) bias, one row per chain,
    takes the fault variant (`launch.tau_leap_step_faults`)."""
    dev = check_cuda(s)
    B, N = check_spins("s", s)
    check_tensor("s", s, torch.float32, (B, N), dev)
    check_tensor("j_i8", j_i8, torch.int8, (N, N), dev)
    check_tensor("b", b, torch.float32, (B, N) if b.ndim == 2 else (N,), dev)
    check_tensor("scale", scale, torch.float32, (), dev)
    check_tensor("uniforms", uniforms, torch.float32, (B, N), dev)
    check_tensor("dt", dt, torch.float32, (), dev)
    check_tensor("beta", beta, torch.float32, (B,), dev)
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    if B == 0 or N == 0:
        return out
    # the kernel writes every byte, padding included (torch.empty is 16-byte aligned)
    s8 = torch.empty((B, padded_cols(N)), dtype=torch.int8, device=dev)
    _launch(s, s8, j_i8, b, scale, beta, uniforms, dt, out, dev)
    tracing.count("launch.tau_leap_step_faults" if b.ndim == 2 else "launch.tau_leap_step")
    return out
