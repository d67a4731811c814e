"""Public entry points for the ported kernels, mirroring `repro/kernels/ops.py`.

`mode` selects the implementation from where the tensors live:

  'auto'      — CUDA tensor: the hand-written kernel; CPU tensor: the plain
                PyTorch version (`ref`).
  'kernel'    — the kernel; a CPU tensor raises.
  'reference' — the plain version, on any device.

A CUDA tensor never reaches the plain version under 'auto' or 'kernel': a
card the kernels were not built for (compute capability other than 9.0)
raises, and so does a failed build or launch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dense_field as _df
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import tau_leap as _tl

MODES = ("auto", "kernel", "reference")


def _use_kernel(t: torch.Tensor, mode: str) -> bool:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "auto":
        return t.device.type == "cuda"
    return mode == "kernel"


def dense_field(s_i8, j_i8, b, scale, mode: str = "auto") -> torch.Tensor:
    """h = (s @ J^T) * scale + b from int8 spins and codes (int32 sums)."""
    if _use_kernel(s_i8, mode):
        return _df.dense_field(s_i8, j_i8, b, scale)
    return _ref.dense_field_ref(s_i8, j_i8, b, scale)


def tau_leap_step(
    s, j_i8, b, scale, uniforms, dt, beta: Optional[torch.Tensor] = None,
    mode: str = "auto",
) -> torch.Tensor:
    """One fused dense tau-leap step over the B rows (chains) of `s`.

    The JAX signature, plus `beta`: an optional (B,) per-row inverse
    temperature, folded in as f32(beta*scale) and f32(beta*b) — row r then
    rounds exactly as the JAX call with scale=beta[r]*scale and
    b=beta[r]*b. `dt` may be a float or a () tensor."""
    dt = torch.as_tensor(dt, dtype=torch.float32, device=s.device)
    if _use_kernel(s, mode):
        if beta is None:
            beta = torch.ones((s.shape[0],), dtype=torch.float32, device=s.device)
        return _tl.tau_leap_step(s, j_i8, b, scale, uniforms, dt, beta)
    if beta is not None:
        scale = (beta * scale)[:, None]
        b = beta[:, None] * b
    return _ref.tau_leap_step_ref(s, j_i8, b, scale, uniforms, dt)


def quantize_dense(J: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a float coupling matrix to (int8 codes, f32 scale).

    Rounds half to even, as `jnp.round` does; an all-zero J gets scale 1."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.max(torch.abs(J)) / qmax
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(J / scale), -qmax, qmax).to(torch.int8)
    return codes, scale.to(torch.float32)
