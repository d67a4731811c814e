"""Glauber-dynamics primitives shared by all samplers.

Rates and conditionals are derived from the energy convention in
`repro_torch.core.ising` (E counts each pair once, p ∝ exp(-E)):

  P(s_i=+1 | rest) = sigma(-2 h_i)
  flip probability of spin i at a clock tick = sigma(+2 h_i s_i)
  CTMC flip rate of spin i:  lambda_i = lambda0 * sigma(2 h_i s_i)

The chip's non-ideal activation (Eq. 5 of the paper) is modeled by an
optional per-neuron trim: sigma_trim(x) = sigma(a * (x - b)). An ideal chip
has a=1, b=0. Dead neurons have rate 0 and read -1.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# The chip's extracted free-running flip rate (Fig. S6): 150 MHz.
LAMBDA0_CHIP_HZ = 150e6


@dataclasses.dataclass(frozen=True)
class SigmoidTrim:
    """Per-neuron activation trim sigma(a*(x-b)) — paper Eq. 5."""

    a: torch.Tensor  # slope, broadcastable to the spin array
    b: torch.Tensor  # offset

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.a * (x - self.b))


def activation(x: torch.Tensor, trim: Optional[SigmoidTrim] = None) -> torch.Tensor:
    """Sigmoid flip-rate activation, optionally trimmed."""
    return torch.sigmoid(x) if trim is None else trim(x)


def prob_up(h: torch.Tensor, trim: Optional[SigmoidTrim] = None) -> torch.Tensor:
    """P(s=+1 | field h)."""
    return activation(-2.0 * h, trim)


def flip_prob(
    h: torch.Tensor, s: torch.Tensor, trim: Optional[SigmoidTrim] = None
) -> torch.Tensor:
    """Probability that a clock tick flips the spin: sigma(2 h s)."""
    return activation(2.0 * h * s, trim)


def flip_rates(
    h: torch.Tensor,
    s: torch.Tensor,
    lambda0: float = 1.0,
    trim: Optional[SigmoidTrim] = None,
    frozen: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """CTMC flip rates lambda_i; frozen (clamped/dead) sites get rate 0."""
    r = lambda0 * flip_prob(h, s, trim)
    if frozen is not None:
        r = torch.where(frozen, torch.zeros_like(r), r)
    return r
