"""Plain PyTorch versions of the ported kernels.

The CPU tests use them, `ops` dispatches CPU tensors to them, and
`chip_smoke.py` holds each CUDA kernel against them on the card. They
mirror `repro/kernels/ref.py` operation for operation, so each rounding
step is the JAX one.
"""
from __future__ import annotations

import torch


def dense_acc_ref(s_i8: torch.Tensor, j_i8: torch.Tensor) -> torch.Tensor:
    """int32 accumulators acc = s @ J^T of the int8 binary dot product.

    The product is taken in float64, which is exact for int8 operands up to
    K = 2^53 / 127^2 terms, and runs on CPU and CUDA alike (torch has no
    int32 matmul on CUDA)."""
    acc = torch.matmul(s_i8.to(torch.float64), j_i8.to(torch.float64).T)
    return acc.to(torch.int32)


def dense_field_ref(
    s_i8: torch.Tensor, j_i8: torch.Tensor, b: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """int8 binary dot-product engine: h = (s @ J^T) * scale + b.

    s_i8: (B,N) int8 in {-1,+1}; j_i8: (N,N) int8 weight codes;
    scale: () f32 dequant scale (or (B,1) per row); b: (N,) f32 (or (B,N)).
    Returns (B,N) f32.
    """
    return dense_acc_ref(s_i8, j_i8).to(torch.float32) * scale + b


def tau_leap_flip_prob_ref(
    s: torch.Tensor,
    j_i8: torch.Tensor,
    b: torch.Tensor,
    scale: torch.Tensor,
    dt: torch.Tensor,
) -> torch.Tensor:
    """Flip probability of the fused tau-leap step: 1-exp(-dt*sigma(2 h s))."""
    h = dense_field_ref(s.to(torch.int8), j_i8, b, scale)
    rate = torch.sigmoid(2.0 * h * s)
    return 1.0 - torch.exp(-dt * rate)


def tau_leap_step_ref(
    s: torch.Tensor,
    j_i8: torch.Tensor,
    b: torch.Tensor,
    scale: torch.Tensor,
    uniforms: torch.Tensor,
    dt: torch.Tensor,
) -> torch.Tensor:
    """Fused dense tau-leap PASS update.

    s: (B,N) f32 ±1. Flip each spin w.p. 1-exp(-dt*sigma(2 h s)).
    """
    p_flip = tau_leap_flip_prob_ref(s, j_i8, b, scale, dt)
    return torch.where(uniforms < p_flip, -s, s)
