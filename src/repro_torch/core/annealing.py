"""Annealing schedules (the paper's 'future systems' counter: uniformly
scaling weights during computation == inverse-temperature schedule), the
port of `repro.core.annealing`.

E_beta(s) = beta * E(s); scaling (J, b) by beta is exactly Glauber dynamics
at inverse temperature beta. `sampler_api.run(..., schedule=...)` takes
constant / linear / geometric schedules (or a raw beta tensor) for any
kernel; the helpers below are the deprecated thin wrappers.
"""
from __future__ import annotations

import torch

from repro_torch.core import sampler_api
from repro_torch.core.ising import DenseIsing, LatticeIsing


def linear_schedule(beta0: float, beta1: float, n_steps: int, device=None) -> torch.Tensor:
    """Deprecated alias for sampler_api.linear(beta0, beta1).betas(n_steps)."""
    return sampler_api.linear(beta0, beta1).betas(n_steps, device)


def geometric_schedule(beta0: float, beta1: float, n_steps: int, device=None) -> torch.Tensor:
    """Deprecated alias for sampler_api.geometric(beta0, beta1).betas(n_steps)."""
    return sampler_api.geometric(beta0, beta1).betas(n_steps, device)


def annealed_tau_leap_dense(problem: DenseIsing, seed, s0: torch.Tensor, betas: torch.Tensor,
                            n_steps: int, dt: float = 0.25) -> tuple[torch.Tensor, torch.Tensor]:
    """Deprecated: tau-leap PASS dynamics under a beta ramp; use
    sampler_api.run(..., schedule=betas). Returns (s, E(s))."""
    res = sampler_api.run(problem, sampler_api.TauLeap(dt=dt), seed, n_steps=n_steps, s0=s0,
                          schedule=betas)
    return res.s, problem.energy(res.s)


def annealed_tau_leap_lattice(problem: LatticeIsing, seed, s0: torch.Tensor, betas: torch.Tensor,
                              n_steps: int, dt: float = 0.25) -> tuple[torch.Tensor, torch.Tensor]:
    """Deprecated: lattice form of `annealed_tau_leap_dense`."""
    res = sampler_api.run(problem, sampler_api.TauLeap(dt=dt), seed, n_steps=n_steps, s0=s0,
                          schedule=betas)
    return res.s, problem.energy(res.s)
