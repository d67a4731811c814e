"""Shared layer primitives: norms, RoPE, MLPs, embeddings.

The port of `repro/models/layers.py`. Weights live in modules: a dense
weight is an `nn.Linear` of shape (d_out, d_in), the transpose of the JAX
package's (d_in, d_out) array applied as `x @ W`. Initialisers draw from an
explicit `torch.Generator` on the device the weights are made on, at the JAX
package's scales (1/sqrt(d_in); 0.02 for the embedding and the untied head);
torch cannot replay JAX's random stream, so `convert.params_from_jax` carries
JAX weights across where the two must agree.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """N(0, scale^2) drawn in float32 on the generator's device, then cast."""
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, scale: Optional[float] = None,
               bias: bool = False) -> nn.Linear:
    """An `nn.Linear(d_in, d_out)` with weights N(0, scale^2), scale
    1/sqrt(d_in) by default, and a zero bias when `bias`; made on the
    generator's device, never on the host."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    lin = nn.utils.skip_init(nn.Linear, d_in, d_out, bias=bias, device=gen.device, dtype=dtype)
    lin.weight = nn.Parameter(normal(gen, (d_out, d_in), scale, dtype))
    if bias:
        lin.bias = nn.Parameter(torch.zeros((d_out,), dtype=dtype, device=gen.device))
    return lin


class Norm(nn.Module):
    """The scale of an rmsnorm or a layernorm (no bias, as in the JAX package)."""

    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((d,), dtype=dtype, device=device))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In float32, cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """In float32, cast back to x's dtype; no bias (the JAX package's norms
    have none)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def apply_norm(kind: str, norm: Norm, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(x, norm.scale) if kind == "rmsnorm" else layernorm(x, norm.scale)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). The head splits
    into halves (not interleaved pairs); angles in float32."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)  # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, dtype, device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


# ---------------------------------------------------------------------------
# MLP (dense FFN): swiglu / geglu / gelu
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """w_gate (gated activations only), w_up, w_down."""

    def __init__(self, gen, d_model: int, d_ff: int, act: str, dtype):
        super().__init__()
        if act in ("swiglu", "geglu"):
            self.w_gate = dense_init(gen, d_model, d_ff, dtype)
        self.w_up = dense_init(gen, d_model, d_ff, dtype)
        self.w_down = dense_init(gen, d_ff, d_model, dtype)


def mlp_init(gen, d_model: int, d_ff: int, act: str, dtype) -> MLP:
    return MLP(gen, d_model, d_ff, act, dtype)


def mlp_apply(mlp: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    """gelu is the tanh approximation, as in the JAX package."""
    if act == "swiglu":
        h = F.silu(mlp.w_gate(x)) * mlp.w_up(x)
    elif act == "geglu":
        h = F.gelu(mlp.w_gate(x), approximate="tanh") * mlp.w_up(x)
    else:
        h = F.gelu(mlp.w_up(x), approximate="tanh")
    return mlp.w_down(h)


# ---------------------------------------------------------------------------
# Embeddings / unembedding
# ---------------------------------------------------------------------------


def embed_init(gen, vocab: int, d_model: int, dtype) -> nn.Parameter:
    return nn.Parameter(normal(gen, (vocab, d_model), 0.02, dtype))


def embed_lookup(embed_w: torch.Tensor, tokens: torch.Tensor, scale_by_dim: bool) -> torch.Tensor:
    """With `scale_by_dim` the rows are scaled by sqrt(D) computed in their
    dtype (bf16-rounded at full width), as the JAX package does."""
    x = embed_w[tokens]
    if scale_by_dim:  # the scalar on the host: no device scalar to wait for
        x = x * float(torch.tensor(embed_w.shape[-1], dtype=x.dtype).sqrt())
    return x


def unembed(x: torch.Tensor, w_out: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    """x (..., D) against w_out (vocab, D): the embedding itself when tied."""
    logits = F.linear(x, w_out)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
