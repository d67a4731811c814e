"""Observables: autocorrelation / lambda0 extraction, TTS scaling fits.

The port of `repro.core.observables`, which is numpy only: copied as it is.

Reproduces the paper's measurement machinery:
  * Fig. S6 — fit ACF(dt) = exp(-lambda0 * dt) to binary neuron traces.
  * Table S1 / Fig. S7 — fit TTS(n) = A * exp(B * sqrt(n)) (and the
    A/n * exp(B sqrt n) variant) with bootstrap confidence intervals, and the
    hypothesis test that async and sync share the same exponent B.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


def autocorrelation(trace: np.ndarray, max_lag: int) -> np.ndarray:
    """Normalized ACF of a (possibly ±1) 1-D trace for lags 0..max_lag-1."""
    x = np.asarray(trace, np.float64)
    x = x - x.mean()
    var = np.mean(x * x)
    if var == 0:
        return np.ones(max_lag)
    acf = np.empty(max_lag)
    n = len(x)
    for lag in range(max_lag):
        acf[lag] = np.mean(x[: n - lag] * x[lag:]) / var
    return acf


def fit_lambda0(acf: np.ndarray, dt: float) -> float:
    """Exponential-decay fit ACF(k*dt) = exp(-lambda0*k*dt) -> lambda0.

    For continuous-time Glauber dynamics of a free-running neuron with flip
    rate r per unit time, ACF(t) = exp(-2 r t); we report the fitted decay
    constant (the paper's 'average flip rate' convention).

    Edge cases: a flat ACF (a frozen neuron — no decay signal) fits a zero
    slope and returns 0.0 exactly; fewer than 2 lags cannot support a
    slope and raises ValueError.
    """
    acf = np.asarray(acf, np.float64)
    if len(acf) < 2:
        raise ValueError(f"fit_lambda0 needs >= 2 ACF lags, got {len(acf)}")
    lags = np.arange(len(acf)) * dt
    pos = acf > 0.05
    if pos.sum() < 3:
        pos = np.arange(len(acf)) < min(3, len(acf))
    slope, _ = np.polyfit(lags[pos], np.log(np.clip(acf[pos], 1e-9, None)), 1)
    return float(-slope) + 0.0  # + 0.0 folds -0.0 from a flat fit into 0.0


class ScalingFit(NamedTuple):
    """A * exp(B * sqrt(n)) fit with bootstrap 95% CIs on both parameters."""

    A: float
    B: float
    A_ci: tuple[float, float]
    B_ci: tuple[float, float]


def _check_tts_inputs(ns, tts_trials, what: str) -> np.ndarray:
    """Validate a (sizes, per-size trials) pair for the scaling fits.

    Raises ValueError for the degenerate inputs that used to surface as
    numpy warnings and NaN fits: mismatched lengths, a single-size grid
    (the two-parameter fit is underdetermined), or a size whose trial set
    has no finite positive TTS at all (its median would be NaN and poison
    the least squares silently).
    """
    ns = np.asarray(ns, np.float64)
    if ns.ndim != 1 or len(ns) != len(tts_trials):
        raise ValueError(
            f"{what}: ns (len {len(ns)}) and tts_trials (len {len(tts_trials)}) "
            "must be 1-D and aligned"
        )
    if len(ns) < 2:
        raise ValueError(
            f"{what}: need >= 2 sizes to fit A*exp(B*sqrt(n)), got {len(ns)} "
            "(drop sizes without hits before calling, but keep at least two)"
        )
    for n, t in zip(ns, tts_trials):
        t = np.asarray(t)
        if not np.any(np.isfinite(t) & (t > 0)):
            raise ValueError(
                f"{what}: size n={n:g} has no finite positive TTS trials "
                "(every trial missed); drop it before fitting"
            )
    return ns


def _fit_one(ns: np.ndarray, tts: np.ndarray, over_n: bool) -> tuple[float, float]:
    """Least-squares fit of log(TTS) = log(A) [- log n] + B*sqrt(n)."""
    y = np.log(tts)
    if over_n:
        y = y + np.log(ns)
    X = np.stack([np.ones_like(ns, dtype=np.float64), np.sqrt(ns)], axis=1)
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    return float(np.exp(coef[0])), float(coef[1])


def fit_scaling(
    ns: np.ndarray,
    tts_trials: list[np.ndarray],
    over_n: bool = False,
    n_boot: int = 2000,
    seed: int = 0,
) -> ScalingFit:
    """Fit TTS(n) = A e^{B sqrt n} (or A/n e^{B sqrt n}) with bootstrap CIs.

    tts_trials[i] holds the per-trial TTS values at size ns[i] (inf = miss;
    we aggregate with the median over finite trials, as the paper's TTS).
    Degenerate inputs (single size, a size with no finite trials) raise
    ValueError — see `_check_tts_inputs`. A zero-variance trial set (every
    trial identical) is legal: every bootstrap resample reproduces the
    same median and the CI collapses onto the point estimate.
    """
    rng = np.random.default_rng(seed)
    ns = _check_tts_inputs(ns, tts_trials, "fit_scaling")
    med = np.array([np.median(t[np.isfinite(t) & (t > 0)]) for t in tts_trials])
    A, B = _fit_one(ns, med, over_n)
    As, Bs = [], []
    for _ in range(n_boot):
        boot_med = []
        for t in tts_trials:
            t = t[np.isfinite(t) & (t > 0)]
            boot_med.append(np.median(rng.choice(t, size=len(t), replace=True)))
        a, b = _fit_one(ns, np.asarray(boot_med), over_n)
        As.append(a)
        Bs.append(b)
    lo, hi = 2.5, 97.5
    return ScalingFit(
        A=A,
        B=B,
        A_ci=(float(np.percentile(As, lo)), float(np.percentile(As, hi))),
        B_ci=(float(np.percentile(Bs, lo)), float(np.percentile(Bs, hi))),
    )


def exponent_gap_pvalue(
    ns: np.ndarray,
    tts_a: list[np.ndarray],
    tts_b: list[np.ndarray],
    n_boot: int = 2000,
    seed: int = 0,
) -> float:
    """Bootstrap p-value for H0: async and sync share the exponent B.

    Two-sided: fraction of bootstrap resamples where B_a >= B_b (or <=),
    doubled — the paper reports p < 0.01 for 'same exponent' rejection.
    Degenerate grids raise ValueError (see `_check_tts_inputs`); both trial
    lists must align with `ns`.
    """
    rng = np.random.default_rng(seed)
    ns = _check_tts_inputs(ns, tts_a, "exponent_gap_pvalue(tts_a)")
    _check_tts_inputs(ns, tts_b, "exponent_gap_pvalue(tts_b)")

    def boot_B(trials):
        """One bootstrap resample's fitted exponent B."""
        med = []
        for t in trials:
            t = t[np.isfinite(t) & (t > 0)]
            med.append(np.median(rng.choice(t, size=len(t), replace=True)))
        return _fit_one(ns, np.asarray(med), False)[1]

    diffs = np.array([boot_B(tts_a) - boot_B(tts_b) for _ in range(n_boot)])
    frac = np.mean(diffs >= 0.0)
    return float(2 * min(frac, 1 - frac))
