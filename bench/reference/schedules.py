"""Inverse-temperature schedules as the model defines them, in float32.

  constant(beta)          beta at every step
  linear(beta0, beta1)    beta0 (1 - r) + beta1 r
  geometric(beta0, beta1) beta0 (beta1 / beta0) ** r

with r_i = i / (T - 1) for i < T - 1 and r_{T-1} = 1 exactly, formed as
0 (1 - step) + 1 step with step = i / (T - 1) (the JAX linspace).
"""
from __future__ import annotations

import torch


def _ramp(start: float, stop: float, num: int, device) -> torch.Tensor:
    a = torch.tensor(start, dtype=torch.float32, device=device)
    z = torch.tensor(stop, dtype=torch.float32, device=device)
    if num == 1:
        return a[None]
    step = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    return torch.cat([a * (1 - step) + z * step, z[None]])


def betas(spec: dict, n_steps: int, device) -> torch.Tensor:
    """The (n_steps,) f32 betas of a schedule given as {"kind": ..., params}."""
    kind = spec["kind"]
    if kind == "constant":
        return torch.full((n_steps,), spec["beta"], dtype=torch.float32, device=device)
    if kind == "linear":
        return _ramp(spec["beta0"], spec["beta1"], n_steps, device)
    if kind == "geometric":
        b0, b1 = spec["beta0"], spec["beta1"]
        return b0 * (b1 / b0) ** _ramp(0.0, 1.0, n_steps, device)
    raise ValueError(f"unknown schedule kind {kind!r}")
