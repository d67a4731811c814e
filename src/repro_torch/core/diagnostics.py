"""Run diagnostics: in-loop counters and post-hoc mixing statistics.

The port of `repro.core.diagnostics`. Two halves:

**Streaming (in-loop) collection.** `sampler_api.run(..., diagnostics=True)`
carries a `DiagAcc` accumulator through the driver's step loop (inside the
captured CUDA graph on a CUDA device): per-chain flip counters (Hamming
distance between successive states), a Welford running mean/variance of
the per-step energy, and the step index of the first target hit. Every
field is a (n_chains,) tensor: the chains are the rows of one step, where
the JAX driver vmaps one chain per scan. The finalized `RunDiagnostics`
rides on `RunResult.diagnostics`; with `diagnostics=False` (the default)
the accumulator is never built and the loop runs nothing of it.

**Post-hoc mixing statistics.** Computed on the host with numpy from the
recorded energy trace (`RunResult.energies`, shape `(n_chains, n_samples)`
or `(n_samples,)`), copied from the JAX package: the integrated
autocorrelation time via Geyer's initial positive sequence
(`integrated_autocorr_time`), the effective sample size it implies
(`effective_sample_size`), and split-R-hat across chains (`split_rhat`).
`mixing_summary` bundles all three into one JSON-ready dict.

All post-hoc estimators measure lags in units of recorded samples, so
multiply `tau_int` by `sample_every` to convert back to kernel steps.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "DiagAcc",
    "RunDiagnostics",
    "acc_init",
    "acc_update",
    "acc_finalize",
    "integrated_autocorr_time",
    "effective_sample_size",
    "split_rhat",
    "mixing_summary",
]


# ---------------------------------------------------------------------------
# Streaming (in-loop) collection
# ---------------------------------------------------------------------------


class DiagAcc(NamedTuple):
    """Per-chain loop-carry accumulator; every field is (n_chains,).

    flips:          total sites flipped so far (int32).
    count:          Welford sample count (= steps taken so far), int32.
    mean, m2:       Welford running mean and sum of squared deviations of
                    the per-step energy.
    first_hit_step: 1-based step index of the first target hit; 0 = the
                    initial state already hit; -1 = never (or untracked).
    """

    flips: torch.Tensor
    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor
    first_hit_step: torch.Tensor


class RunDiagnostics(NamedTuple):
    """Finalized in-loop diagnostics on `RunResult.diagnostics`.

    With `n_chains > 1` every field has a leading chain dimension; with
    one chain every field is a scalar tensor, as in the JAX package.

    n_steps:        kernel steps the accumulator saw.
    flips:          total sites flipped across the run (int32).
    flip_rate:      flips / (n_steps * n_sites) — mean per-site flip
                    probability per step; the paper's activity factor.
    energy_mean:    Welford mean of the per-step energy trace.
    energy_var:     unbiased (ddof=1) Welford variance of the same trace.
    first_hit_step: see `DiagAcc`; pairs with `RunResult.t_hit`.
    """

    n_steps: torch.Tensor
    flips: torch.Tensor
    flip_rate: torch.Tensor
    energy_mean: torch.Tensor
    energy_var: torch.Tensor
    first_hit_step: torch.Tensor


def acc_init(e0: torch.Tensor, init_hit: Optional[torch.Tensor]) -> DiagAcc:
    """Fresh accumulator for the (n_chains,) initial energies `e0`, which
    fix the energy dtype (they are NOT counted: the trace starts at the
    first step's post-step energy); `init_hit` marks chains whose initial
    state already meets the target (step 0)."""
    zero = torch.zeros_like(e0)
    izero = torch.zeros(e0.shape, dtype=torch.int32, device=e0.device)
    if init_hit is None:
        first = izero - 1
    else:
        first = torch.where(init_hit, izero, izero - 1)
    return DiagAcc(flips=izero, count=izero, mean=zero, m2=zero, first_hit_step=first)


def acc_update(
    acc: DiagAcc,
    n_flipped: torch.Tensor,
    e: torch.Tensor,
    new_hit: Optional[torch.Tensor],
) -> DiagAcc:
    """Fold one step into the accumulator.

    `n_flipped` is each chain's Hamming distance between its pre- and
    post-step states; `e` the post-step energies; `new_hit` the driver's
    "first time at or below target" flags (None when first-hit tracking is
    off). Welford's update keeps the variance stable over long runs where
    E[e]^2 >> Var[e]."""
    count = acc.count + 1
    delta = e - acc.mean
    mean = acc.mean + delta / count.to(e.dtype)
    m2 = acc.m2 + delta * (e - mean)
    if new_hit is None:
        first = acc.first_hit_step
    else:
        first = torch.where(new_hit & (acc.first_hit_step < 0), count, acc.first_hit_step)
    return DiagAcc(
        flips=acc.flips + n_flipped.to(torch.int32),
        count=count,
        mean=mean,
        m2=m2,
        first_hit_step=first,
    )


def acc_finalize(acc: DiagAcc, n_sites: int) -> RunDiagnostics:
    """Close the accumulator into the user-facing `RunDiagnostics`."""
    steps = torch.clamp(acc.count, min=1)
    var = acc.m2 / torch.clamp(acc.count - 1, min=1).to(acc.m2.dtype)
    return RunDiagnostics(
        n_steps=acc.count,
        flips=acc.flips,
        flip_rate=acc.flips.to(torch.float32) / (steps.to(torch.float32) * float(n_sites)),
        energy_mean=acc.mean,
        energy_var=var,
        first_hit_step=acc.first_hit_step,
    )


# ---------------------------------------------------------------------------
# Post-hoc mixing statistics (host-side numpy, from recorded energies)
# ---------------------------------------------------------------------------


def _as_chains(x: np.ndarray) -> np.ndarray:
    """Normalize a trace to (n_chains, n_samples) float64."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError(
            f"trace must be (n_samples,) or (n_chains, n_samples); got shape {x.shape}"
        )
    return x


def integrated_autocorr_time(trace: np.ndarray) -> float:
    """Integrated autocorrelation time of a (possibly multi-chain) trace.

    tau_int = 1 + 2 * sum_t rho_t, with rho_t the chain-averaged
    normalized autocorrelation and the sum truncated by Geyer's initial
    positive sequence: pair sums Gamma_k = rho_{2k} + rho_{2k+1} are
    accumulated while positive, which is the standard bias/variance
    compromise for monotone chains (Geyer 1992). Lags are in units of
    RECORDED samples — multiply by the observation stride for kernel steps.

    Edge cases: a zero-variance (flat) trace has no decorrelation signal;
    we return n_samples (ESS of one sample per chain) rather than NaN so
    downstream summaries stay finite. The estimate is clipped to
    [1, n_samples].
    """
    x = _as_chains(trace)
    m, n = x.shape
    if n < 2:
        return float(max(n, 1))
    xc = x - x.mean(axis=1, keepdims=True)
    var = float(np.mean(xc * xc))
    if var == 0.0:
        return float(n)
    max_lag = n - 1
    rho = np.empty(max_lag + 1)
    for lag in range(max_lag + 1):
        rho[lag] = float(np.mean(xc[:, : n - lag] * xc[:, lag:])) / var
    tau = 1.0
    for k in range(1, (max_lag + 1) // 2 + 1):
        g = rho[2 * k - 1] + (rho[2 * k] if 2 * k <= max_lag else 0.0)
        if g <= 0.0:
            break
        tau += 2.0 * g
    return float(np.clip(tau, 1.0, n))


def effective_sample_size(trace: np.ndarray) -> float:
    """ESS = (n_chains * n_samples) / tau_int of the pooled trace."""
    x = _as_chains(trace)
    return float(x.size / integrated_autocorr_time(x))


def split_rhat(trace: np.ndarray) -> float:
    """Split-R̂ potential scale reduction across chains.

    Each chain is split in half (catching within-chain nonstationarity that
    whole-chain R̂ misses), then the classic between/within variance ratio
    is formed over the 2*n_chains half-chains:

        R̂ = sqrt( ((n-1)/n * W + B/n) / W )

    Values near 1 indicate the chains agree; > ~1.01 (Vehtari et al. 2021)
    means more sampling (or a better kernel) is needed. Edge cases: fewer
    than 4 samples per chain returns NaN (halves would be length < 2);
    zero within-chain variance returns 1.0 when the chains also agree
    (B == 0, e.g. all chains stuck in the same ground state) and inf when
    they disagree — frozen chains in different states never mix.
    """
    x = _as_chains(trace)
    m, n = x.shape
    if n < 4:
        return float("nan")
    half = n // 2
    halves = np.concatenate([x[:, :half], x[:, n - half:]], axis=0)  # (2m, half)
    within = halves.var(axis=1, ddof=1)
    w = float(within.mean())
    b = float(half * halves.mean(axis=1).var(ddof=1))
    if w == 0.0:
        return 1.0 if b == 0.0 else float("inf")
    var_plus = (half - 1) / half * w + b / half
    return float(np.sqrt(var_plus / w))


def mixing_summary(energies: Any, sample_every: int = 1) -> dict:
    """One JSON-ready mixing report from a recorded energy trace.

    `energies` is `RunResult.energies` (or any array shaped like it):
    (n_samples,) or (n_chains, n_samples). `sample_every` converts the
    sample-unit tau_int back to kernel steps. Non-finite values (inf
    energies from diverged runs) are rejected loudly — silently dropping
    them would bias every statistic.
    """
    if isinstance(energies, torch.Tensor):
        energies = energies.detach().cpu().numpy()
    x = _as_chains(np.asarray(energies))
    if x.size == 0:
        raise ValueError("mixing_summary needs a non-empty energy trace "
                         "(run with sample_every > 0)")
    if not np.all(np.isfinite(x)):
        raise ValueError("energy trace contains non-finite values")
    tau = integrated_autocorr_time(x)
    return {
        "n_chains": int(x.shape[0]),
        "n_samples": int(x.shape[1]),
        "tau_int_samples": tau,
        "tau_int_steps": tau * float(sample_every),
        "ess": float(x.size / tau),
        "split_rhat": split_rhat(x),
    }
