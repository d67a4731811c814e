"""The port's run diagnostics and observables against the JAX package.

The in-loop accumulator, fed the same trajectory (flip counts, energies,
first-hit flags), equals `repro.core.diagnostics`' one bit for bit, one
chain per row; `run(..., diagnostics=True)` leaves every sampled value
unchanged for every kernel; the collector matches a host recomputation.
The numpy estimators and `observables` are the JAX package's copies:
equal results on the same arrays."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import diagnostics as jdiag
from repro.core import observables as jobs
from repro_torch.core import diagnostics, ising, observables, problems, sampler_api

torch.set_num_threads(1)

CPU = "cpu"


def _sk(n=8, seed=0):
    """The JAX test's SK instance (tests/test_diagnostics.py)."""
    rng = np.random.default_rng(seed)
    J = rng.normal(0, 1.0 / np.sqrt(n), (n, n))
    J = (J + J.T) / 2
    np.fill_diagonal(J, 0)
    return ising.DenseIsing.from_numpy(J, np.zeros(n), device=CPU)


@pytest.mark.parametrize("track_hit", [True, False])
def test_accumulator_equals_jax_on_the_same_trajectory(track_hit):
    rng = np.random.default_rng(4)
    B, T = 5, 60
    e = (rng.normal(-3.0, 1.5, (T, B)) * 16).round() / 16 + rng.normal(0, 1e-3, (T, B))
    e = e.astype(np.float32)
    flips = rng.integers(0, 9, (T, B)).astype(np.int32)
    e0 = rng.normal(-1.0, 0.5, B).astype(np.float32)
    target = np.float32(-4.0)
    init_hit = e0 <= target if track_hit else None
    acc = diagnostics.acc_init(torch.tensor(e0),
                               None if init_hit is None else torch.tensor(init_hit))
    hit = torch.tensor(e0 <= target) if track_hit else None
    for t in range(T):
        new_hit = None
        if track_hit:
            new_hit = (torch.tensor(e[t]) <= target) & ~hit
            hit = hit | new_hit
        acc = diagnostics.acc_update(acc, torch.tensor(flips[t]), torch.tensor(e[t]), new_hit)
    got = diagnostics.acc_finalize(acc, n_sites=16)
    for c in range(B):
        jacc = jdiag.acc_init(jnp.float32(e0[c]), None if init_hit is None
                              else jnp.asarray(init_hit[c]))
        jhit = jnp.asarray(e0[c] <= target)
        for t in range(T):
            jnew = None
            if track_hit:
                jnew = (jnp.float32(e[t, c]) <= target) & ~jhit
                jhit = jhit | jnew
            jacc = jdiag.acc_update(jacc, jnp.int32(flips[t, c]), jnp.float32(e[t, c]), jnew)
        want = jdiag.acc_finalize(jacc, n_sites=16)
        for f in diagnostics.RunDiagnostics._fields:
            a, b = getattr(got, f)[c].numpy(), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("kernel", ["random_scan_gibbs", "ctmc", "tau_leap"])
def test_diagnostics_off_vs_on_identical(kernel):
    """diagnostics=True changes only what is recorded (the JAX contract)."""
    prob = _sk()
    kw = dict(n_steps=60, n_chains=3, sample_every=10, first_hit=-100.0)
    off = sampler_api.run(prob, kernel, 7, **kw)
    on = sampler_api.run(prob, kernel, 7, diagnostics=True, **kw)
    assert off.diagnostics is None and on.diagnostics is not None
    for a, b in zip(off[:7], on[:7]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("name,kernel", [("cal", "chromatic_gibbs"),
                                         ("maxcut3r", "colored_gibbs"),
                                         ("maxcut3r", "ctmc")])
def test_diagnostics_off_vs_on_identical_lattice_and_sparse(name, kernel):
    z = problems.get_problem(name, 16 if name == "cal" else 24, device=CPU)
    kw = dict(n_steps=12, n_chains=2, sample_every=4, backend=None,
              schedule=sampler_api.geometric(0.3, 3.0))
    off = sampler_api.run(z.problem, kernel, 3, **kw)
    on = sampler_api.run(z.problem, kernel, 3, diagnostics=True, **kw)
    for a, b in zip(off[:5], on[:5]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    d = on.diagnostics
    assert d.flips.shape == (2,) and bool((d.flips > 0).all())
    assert bool((d.n_steps == 12).all())


def test_collector_matches_host_recomputation():
    """sample_every=1 records every post-step state (tests/test_diagnostics.py:53)."""
    prob = _sk(n=6, seed=1)
    s0 = sampler_api.random_init(torch.Generator().manual_seed(11), (6,), device=CPU)
    res = sampler_api.run(prob, "random_scan_gibbs", 3, n_steps=50, s0=s0, sample_every=1,
                          diagnostics=True)
    d = res.diagnostics
    states = np.concatenate([s0.numpy()[None], res.samples.numpy()])
    flips = int(np.sum(states[1:] != states[:-1]))
    assert d.n_steps.shape == () and int(d.n_steps) == 50
    assert int(d.flips) == flips
    assert float(d.flip_rate) == pytest.approx(flips / (50 * 6), rel=1e-6)
    e = res.energies.numpy().astype(np.float64)
    assert float(d.energy_mean) == pytest.approx(e.mean(), rel=1e-5)
    assert float(d.energy_var) == pytest.approx(e.var(ddof=1), rel=1e-4)


def test_ctmc_flips_once_per_event_and_chain_dimension():
    res = sampler_api.run(_sk(), "ctmc", 0, n_steps=40, diagnostics=True)
    assert int(res.diagnostics.flips) == 40
    res = sampler_api.run(_sk(), "ctmc", 2, n_steps=25, n_chains=4, diagnostics=True)
    d = res.diagnostics
    assert d.flips.shape == (4,) and d.energy_mean.shape == (4,)
    assert bool((d.n_steps == 25).all()) and bool((d.flips == 25).all())


def test_first_hit_step_semantics():
    prob = _sk()
    kw = dict(n_steps=30, diagnostics=True)
    res = sampler_api.run(prob, "random_scan_gibbs", 5, first_hit=-1e9, **kw)
    assert int(res.diagnostics.first_hit_step) == -1 and not bool(res.hit)
    res = sampler_api.run(prob, "random_scan_gibbs", 5, first_hit=1e9, **kw)
    assert int(res.diagnostics.first_hit_step) == 0 and float(res.t_hit) == 0.0
    res = sampler_api.run(prob, "random_scan_gibbs", 5, **kw)
    assert int(res.diagnostics.first_hit_step) == -1
    # a reachable target: the step index pairs with t_hit (1/lambda0 per step)
    warm = sampler_api.run(prob, "random_scan_gibbs", 1, n_steps=200, sample_every=1)
    target = float(np.quantile(warm.energies.numpy(), 0.2))
    res = sampler_api.run(prob, "random_scan_gibbs", 5, n_steps=200, n_chains=4,
                          first_hit=target, diagnostics=True)
    step = res.diagnostics.first_hit_step.numpy()
    hit = res.hit.numpy()
    assert hit.any()
    np.testing.assert_array_equal(res.t_hit.numpy()[hit], step[hit].astype(np.float32))


def test_estimators_equal_jax():
    rng = np.random.default_rng(0)
    traces = [rng.normal(size=(4, 400)), np.repeat(rng.normal(size=(2, 100)), 8, axis=1),
              rng.normal(size=300), np.ones((2, 50)), np.stack([np.ones(50), -np.ones(50)]),
              np.ones((2, 3)), rng.normal(size=(4, 200)) + np.array([0, 0, 10, 10])[:, None]]
    for x in traces:
        for f in ("integrated_autocorr_time", "effective_sample_size", "split_rhat"):
            a, b = getattr(diagnostics, f)(x), getattr(jdiag, f)(x)
            assert a == b or (np.isnan(a) and np.isnan(b)), (f, a, b)
    x = rng.normal(size=(3, 120))
    assert diagnostics.mixing_summary(x, 4) == jdiag.mixing_summary(x, 4)
    assert diagnostics.mixing_summary(torch.tensor(x), 4) == jdiag.mixing_summary(x, 4)
    for bad, match in ((np.empty((3, 0)), "non-empty"), (np.array([1.0, np.inf]), "non-finite")):
        with pytest.raises(ValueError, match=match):
            diagnostics.mixing_summary(bad)
    with pytest.raises(ValueError, match="shape"):
        diagnostics.integrated_autocorr_time(np.ones((2, 2, 2)))


def test_mixing_summary_from_a_port_run():
    res = sampler_api.run(_sk(), "random_scan_gibbs", 9, n_steps=400, n_chains=4,
                          sample_every=4)
    mix = diagnostics.mixing_summary(res.energies, sample_every=4)
    assert mix == jdiag.mixing_summary(res.energies.numpy(), sample_every=4)
    assert mix["n_chains"] == 4 and mix["n_samples"] == 100
    assert 1.0 <= mix["tau_int_samples"] <= 100.0
    json.dumps(mix)


def test_observables_equal_jax():
    rng = np.random.default_rng(3)
    trace = np.sign(rng.normal(size=500)).cumsum() % 3 - 1
    for lag in (1, 10, 40):
        np.testing.assert_array_equal(observables.autocorrelation(trace, lag),
                                      jobs.autocorrelation(trace, lag))
    for acf, dt in ((np.exp(-0.7 * np.arange(40) * 0.25), 0.25), (np.ones(16), 0.5),
                    (np.array([1.0, 0.01, 0.0001, 0.0, 0.0]), 1.0)):
        assert observables.fit_lambda0(acf, dt) == jobs.fit_lambda0(acf, dt)
    ns = np.array([16, 36, 64, 100])
    trials = [3.0 * np.exp(0.4 * np.sqrt(n)) * np.exp(rng.normal(0, 0.1, 6)) for n in ns]
    slower = [t * np.exp(0.2 * np.sqrt(n)) for t, n in zip(trials, ns)]
    for over_n in (False, True):
        assert (observables.fit_scaling(ns, trials, over_n=over_n, n_boot=200, seed=1)
                == jobs.fit_scaling(ns, trials, over_n=over_n, n_boot=200, seed=1))
    assert (observables.exponent_gap_pvalue(ns, trials, slower, n_boot=200, seed=2)
            == jobs.exponent_gap_pvalue(ns, trials, slower, n_boot=200, seed=2))
    for mod in (observables, jobs):
        with pytest.raises(ValueError, match="2 ACF lags"):
            mod.fit_lambda0(np.array([1.0]), dt=0.5)
