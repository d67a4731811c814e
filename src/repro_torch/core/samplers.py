"""Deprecated sampler entry points — thin wrappers over `sampler_api.run`,
the port of `repro.core.samplers`.

The implementation lives in `repro_torch.core.sampler_api`; these keep the
historical signatures (one chain, beta = 1) and return the legacy
`SampleRun`. Each takes an int seed or a torch.Generator on the problem's
device where the JAX one takes a key. New code calls `sampler_api.run`:

    old                                   new
    ------------------------------------  -------------------------------------
    gibbs_random_scan(p, seed, s0, n, ...) run(p, "random_scan_gibbs", seed,
                                              n_steps=n, s0=s0, ...)
    chromatic_gibbs(p, seed, s0, n, ...)  run(p, ChromaticGibbs(trim=...), seed,
                                              n_steps=n, s0=s0, ...)
    tau_leap_lattice / tau_leap_dense     run(p, TauLeap(dt=dt), seed, ...)
    gibbs_first_hit(p, seed, s0, e, n)    run(p, "random_scan_gibbs", seed,
                                              n_steps=n, s0=s0, first_hit=e)
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import glauber, sampler_api
from repro_torch.core.ising import DenseIsing, LatticeIsing
from repro_torch.core.sampler_api import random_init  # noqa: F401  (re-export)


class SampleRun(NamedTuple):
    """Result of a sampling run (legacy shape of sampler_api.RunResult).

    s: final state.
    samples: (n_samples, ...) recorded states (empty leading dim if none).
    t: final model time (seconds of chip time).
    energies: (n_samples,) energy at each recorded state.
    """

    s: torch.Tensor
    samples: torch.Tensor
    t: torch.Tensor
    energies: torch.Tensor


def _legacy(res: sampler_api.RunResult) -> SampleRun:
    return SampleRun(s=res.s, samples=res.samples, t=res.t, energies=res.energies)


def gibbs_random_scan(problem: DenseIsing, seed, s0: torch.Tensor, n_steps: int,
                      lambda0: float = 1.0, sample_every: int = 0) -> SampleRun:
    """Deprecated: serial random-scan Gibbs; use sampler_api.run."""
    return _legacy(sampler_api.run(problem, sampler_api.RandomScanGibbs(lambda0=lambda0), seed,
                                   n_steps=n_steps, s0=s0, sample_every=sample_every))


def gibbs_first_hit(problem: DenseIsing, seed, s0: torch.Tensor, e_target: float, n_steps: int,
                    lambda0: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Deprecated: (first model time energy<=e_target, hit?) for the sync
    baseline; use sampler_api.run(..., first_hit=e_target)."""
    res = sampler_api.run(problem, sampler_api.RandomScanGibbs(lambda0=lambda0), seed,
                          n_steps=n_steps, s0=s0, first_hit=float(e_target))
    return res.t_hit, res.hit


def chromatic_gibbs(problem: LatticeIsing, seed, s0: torch.Tensor, n_sweeps: int,
                    lambda0: float = 1.0, sample_every: int = 0,
                    trim: Optional[glauber.SigmoidTrim] = None) -> SampleRun:
    """Deprecated: exact parallel Gibbs via the king's-graph 4-coloring;
    use sampler_api.run."""
    return _legacy(sampler_api.run(problem, sampler_api.ChromaticGibbs(lambda0=lambda0, trim=trim),
                                   seed, n_steps=n_sweeps, s0=s0, sample_every=sample_every))


def tau_leap_lattice(problem: LatticeIsing, seed, s0: torch.Tensor, n_steps: int,
                     dt: float = 0.1, lambda0: float = 1.0, sample_every: int = 0,
                     trim: Optional[glauber.SigmoidTrim] = None) -> SampleRun:
    """Deprecated: PASS async dynamics on the chip lattice; use
    sampler_api.run with a TauLeap kernel."""
    return _legacy(sampler_api.run(problem, sampler_api.TauLeap(dt=dt, lambda0=lambda0, trim=trim),
                                   seed, n_steps=n_steps, s0=s0, sample_every=sample_every))


def tau_leap_dense(problem: DenseIsing, seed, s0: torch.Tensor, n_steps: int, dt: float = 0.1,
                   lambda0: float = 1.0, sample_every: int = 0) -> SampleRun:
    """Deprecated: PASS async dynamics with a dense coupling matrix; use
    sampler_api.run with a TauLeap kernel (backend="cuda" for the int8
    kernel)."""
    return _legacy(sampler_api.run(problem, sampler_api.TauLeap(dt=dt, lambda0=lambda0), seed,
                                   n_steps=n_steps, s0=s0, sample_every=sample_every))
