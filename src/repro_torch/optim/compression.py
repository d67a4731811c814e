"""int8 gradient compression with error feedback.

The port of `repro/optim/compression.py`: each gradient, plus the carried
residual, is quantized to int8 with a per-tensor scale and dequantized (the
value a compressed all-reduce would transmit); the quantization error is
carried in float32 to the next step (Karimireddy et al., 2019). The
compressed gradient comes back in the gradient's dtype. `torch.round`
rounds half to even, as `jnp.round` does. Gradients and residuals are dicts
keyed by parameter name.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_F32 = torch.float32


class EFState(NamedTuple):
    residual: dict  # name -> float32 tensor, the parameter's shape


def init(params: dict) -> EFState:
    return EFState(residual={n: torch.zeros_like(p, dtype=_F32) for n, p in params.items()})


def _q8(x: torch.Tensor) -> torch.Tensor:
    amax = torch.max(torch.abs(x))
    scale = torch.where(amax == 0, 1.0, amax / 127.0)
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def compress(grads: dict, ef: EFState) -> tuple[dict, EFState]:
    """Returns (the compressed grads, the new EF state)."""
    out, residual = {}, {}
    for name, g in grads.items():
        g32 = g.to(_F32) + ef.residual[name]
        gq = _q8(g32)
        out[name], residual[name] = gq.to(g.dtype), g32 - gq
    return out, EFState(residual=residual)
