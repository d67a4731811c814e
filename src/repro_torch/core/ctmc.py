"""Exact event-driven continuous-time Glauber dynamics (Gillespie/SSA).

The port of `repro.core.ctmc`. This is the paper's asynchronous simulation
model (Methods, Eqs. 10-11): every neuron carries an independent Poisson
clock; the next flip happens after an Exp(sum_i lambda_i) waiting time at a
site drawn proportionally to its flip rate lambda_i = lambda0 *
sigma(2 h_i s_i). The embedded chain is statistically exact and is the
fidelity reference for the tau-leap sampler and the hardware.

The step rule lives in `sampler_api.CTMC` (registered as "ctmc"); the
functions here are thin wrappers over `sampler_api.run` plus the
distribution estimators. The estimators take one chain's (n_samples, n)
samples or work per row of (..., n_samples, n) ones.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import sampler_api
from repro_torch.core.ising import DenseIsing


class CTMCRun(NamedTuple):
    """A recorded CTMC trajectory: states, model times, energies (with a
    leading chain dimension for several chains)."""

    s: Any         # final state
    t: Any         # final model time
    samples: Any   # (..., n_recorded, n) states at event times (strided)
    times: Any     # (..., n_recorded) event times
    energies: Any  # (..., n_recorded)

    @classmethod
    def from_result(cls, res: sampler_api.RunResult) -> "CTMCRun":
        """Adapt a driver RunResult (for the estimators below)."""
        return cls(
            s=res.s, t=res.t, samples=res.samples, times=res.times, energies=res.energies
        )


def gillespie(
    problem: DenseIsing,
    seed,
    s0: torch.Tensor,
    n_events: int,
    lambda0: float = 1.0,
    sample_every: int = 0,
) -> CTMCRun:
    """Run n_events exact CTMC flip events from s0; the same as
    sampler_api.run(problem, sampler_api.CTMC(lambda0), seed, ...)."""
    res = sampler_api.run(
        problem, sampler_api.CTMC(lambda0=lambda0), seed, n_steps=n_events, s0=s0,
        sample_every=sample_every,
    )
    return CTMCRun.from_result(res)


def gillespie_first_hit(
    problem: DenseIsing,
    seed,
    s0: torch.Tensor,
    e_target: float,
    n_events: int,
    lambda0: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(first model time at which energy <= e_target, hit?) — the
    asynchronous system's time-to-solution; the same as
    sampler_api.run(..., first_hit=e_target).

    n flips at total rate sum_i lambda_i means model time advances
    ~n/(n*lambda0) per event — the n-fold parallelism of the paper's Eq. 16
    appears automatically."""
    res = sampler_api.run(
        problem, sampler_api.CTMC(lambda0=lambda0), seed, n_steps=n_events, s0=s0,
        first_hit=e_target,
    )
    return res.t_hit, res.hit


def _codes(samples: torch.Tensor, n: int) -> torch.Tensor:
    """Integer code sum_i [s_i > 0] 2^i of each ±1 state (int64)."""
    bits = (samples > 0).to(torch.int64)
    return torch.sum(bits * (2 ** torch.arange(n, device=samples.device)), dim=-1)


def _histogram(codes: torch.Tensor, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Per-row sums of `weights` by code: (..., m) -> (..., 2^n), f32, added
    in sample order."""
    out = torch.zeros(codes.shape[:-1] + (2**n,), dtype=torch.float32, device=codes.device)
    return out.scatter_add(-1, codes, weights.to(torch.float32))


def empirical_distribution(samples: torch.Tensor, n: int) -> torch.Tensor:
    """Histogram over the 2^n state space from (..., m, n) ±1 samples
    (n <= 20), per row."""
    codes = _codes(samples, n)
    return _histogram(codes, torch.ones_like(codes, dtype=torch.float32), n) / samples.shape[-2]


def time_weighted_distribution(run: CTMCRun, n: int) -> torch.Tensor:
    """Holding-time-weighted state distribution — the unbiased CTMC
    estimator, per chain for batched runs.

    Event-sampled states form the embedded chain, whose stationary law is
    rate-biased; weighting each visited state by its holding time recovers
    the Boltzmann distribution. The state recorded at times[k] holds until
    times[k+1]; the LAST recorded state holds until the end of the run,
    `run.t - times[-1]` (with sample_every=1 the run ends at the last
    event, and that final dwell is censored at zero). If every dwell of a
    chain is zero (a single event under sample_every=1), that chain falls
    back to the embedded-chain visit counts instead of 0/0."""
    codes = _codes(run.samples, n)
    times = run.times
    t_end = torch.as_tensor(run.t, dtype=times.dtype, device=times.device)
    dts = torch.diff(times, dim=-1, append=t_end.reshape(t_end.shape + (1,)))
    w = _histogram(codes, dts, n)
    counts = _histogram(codes, torch.ones_like(dts), n)
    total = torch.sum(w, dim=-1, keepdim=True)
    return torch.where(total > 0, w / total, counts / torch.sum(counts, dim=-1, keepdim=True))
