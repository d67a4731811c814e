"""AdamW by hand, as in the JAX package (no torch.optim).

The port of `repro/optim/adamw.py`. The state holds the first and second
moments in float32 whatever the parameter's dtype (bf16 parameters, f32
optimizer), and the step count. Parameters, gradients and moments are dicts
keyed by the model's parameter names; `update` writes the new parameters
and moments in place.

Where `torch.optim.AdamW` would differ, this follows the JAX package: the
moments stay float32 (torch keeps them in the parameter's dtype); the
update is computed in float32 and cast back; weight decay is added to the
step (`step + wd * p`, scaled by lr with it), not applied as a separate
multiplicative shrink; eps is added to sqrt(v_hat); the gradients are
clipped by their global norm with 1e-9 in the denominator (torch's
`clip_grad_norm_` takes 1e-6).

Decay: the JAX package decays a leaf whose *stacked* array has ndim >= 2,
so the norm scales and vectors of scanned layers (stacked over the units)
decay and those of tail layers, `final_norm` and `enc_norm` do not. Every
port tensor of a norm is 1-D, so the caller passes the mask that the JAX
layout gives (`convert.decay_mask`), never the tensors' own ndim.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0


class OptState(NamedTuple):
    mu: dict  # name -> float32 tensor, the parameter's shape
    nu: dict
    count: int


def init(params: dict) -> OptState:
    def zeros():
        return {n: torch.zeros_like(p, dtype=_F32) for n, p in params.items()}

    return OptState(mu=zeros(), nu=zeros(), count=0)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every tensor's squares in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(_F32))) for t in tree.values()))


def update(grads: dict, state: OptState, params: dict, cfg: AdamWConfig, lr_scale=1.0,
           *, decay: dict) -> tuple[OptState, dict]:
    """One AdamW step: the parameters and moments written in place.
    `decay` maps each name to whether its parameter decays. Returns (the new
    state, {"grad_norm"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    count = state.count + 1
    c = torch.tensor(count, dtype=_F32)
    # float32 scalars on the host, as JAX holds them
    b1c = float(1.0 - cfg.b1 ** c)
    b2c = float(1.0 - cfg.b2 ** c)
    lr = float(cfg.lr * torch.as_tensor(lr_scale, dtype=_F32))
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name].to(_F32) * scale
            m, v = state.mu[name], state.nu[name]
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            v.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
            step = (m / b1c) / ((v / b2c).sqrt_() + cfg.eps)
            pf = p.to(_F32)
            if decay[name]:
                step = step + cfg.weight_decay * pf
            p.copy_(pf - lr * step)
    return OptState(mu=state.mu, nu=state.nu, count=count), {"grad_norm": gnorm}
