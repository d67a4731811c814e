"""The port's synchronous baseline (random-scan Gibbs) and exact CTMC
against the JAX package.

Exact steps: the port's pure `update` is fed the draws the JAX step takes
from its key (site and uniform for random scan; Exp(1) and the tree's
uniform or the scan's categorical site for the CTMC) and the JAX state
arrays, one chain per row; s, h and e must equal the JAX step's bit for
bit, t within 1 ulp (the Glauber sigmoids differ by up to 2 ulp, and the
scan's total rate is summed in another order).

Statistics: the JAX tests' bounds, with the port's chains batched as rows
in place of one long chain: TV < 0.03 to exact enumeration, the tree
draw's chi-square, the frozen cold chain, the incremental energy within
5e-3, the `auto` threshold, `unroll` parity, and the final-dwell cases of
`time_weighted_distribution`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import glauber as jglauber
from repro.core import ising as jising
from repro.core import problems as jproblems
from repro.core import sampler_api as jsa
from repro_torch.core import ctmc, event_tree, graph_loop, ising, problems, sampler_api
from repro_torch.core.sampler_api import CTMC, CTMCAux, KernelState, LocalFields, TauLeap, run
from repro_torch.core.sparse import SparseIsing

torch.set_num_threads(1)

CPU = "cpu"
TV_MAX = 0.03  # tests/test_core_samplers.py:69,77


def _dense_numpy(n, seed, scale=0.6):
    rng = np.random.default_rng(seed)
    A = rng.normal(0, scale, (n, n))
    J = np.triu(A, 1)
    return (J + J.T).astype(np.float32), rng.normal(0, scale / 2, n).astype(np.float32)


def _both_dense(n, seed, scale=0.6):
    J, b = _dense_numpy(n, seed, scale)
    return (jising.DenseIsing(J=jnp.asarray(J), b=jnp.asarray(b)),
            ising.DenseIsing.from_numpy(J, b, device=CPU))


def _both_3regular(n, seed):
    jp = jproblems.random_3regular_maxcut(n, seed)
    return jp, problems.random_3regular_maxcut(n, seed, device=CPU)


def _small5():
    """The 5-spin problem of tests/test_core_samplers.py."""
    rng = np.random.default_rng(0)
    n = 5
    A = rng.normal(0, 0.7, (n, n))
    J = np.triu(A, 1)
    J = J + J.T
    return ising.DenseIsing.from_numpy(J, rng.normal(0, 0.4, n), device=CPU)


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _jax_states(jprob, jkernel, n_chains, seed):
    """Per-chain JAX kernel states from random numpy states, at a model time
    t > 0 as mid-run, and one key per chain."""
    rng = np.random.default_rng(seed)
    states = []
    for _ in range(n_chains):
        s0 = jnp.asarray(rng.choice([-1.0, 1.0], jprob.n).astype(np.float32))
        t = jnp.float32(rng.uniform(1.0, 5.0))
        states.append(jkernel.init(jprob, None, s0)._replace(t=t))
    return states, jax.random.split(jax.random.key(seed), n_chains)


def _assert_step(got: KernelState, want):
    """Bit-equal s, h, e; t within 1 ulp of each JAX chain's."""
    np.testing.assert_array_equal(got.s.numpy(), np.stack([np.asarray(w.s) for w in want]))
    h = np.stack([np.asarray(w.aux if not isinstance(w.aux, tuple) else w.aux[0])
                  for w in want])
    np.testing.assert_array_equal(got.aux.h.numpy(), h)
    np.testing.assert_array_equal(got.e.numpy(), np.stack([np.asarray(w.e) for w in want]))
    np.testing.assert_array_max_ulp(got.t.numpy(), np.stack([np.asarray(w.t) for w in want]),
                                    maxulp=1)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_random_scan_step_equals_jax_step(kind):
    jprob, prob = _both_dense(12, 3) if kind == "dense" else _both_3regular(16, 2)
    B = 6
    jk = jsa.RandomScanGibbs()
    states, keys = _jax_states(jprob, jk, B, seed=1)
    betas = np.linspace(0.3, 2.5, B).astype(np.float32)
    nbr = prob.nbr_idx.long() if kind == "sparse" else None
    state = KernelState(
        s=_t([st.s for st in states]), t=_t([st.t for st in states]),
        e=_t([st.e for st in states]), aux=LocalFields(_t([st.aux for st in states]), nbr))
    want, sites, us = [], [], []
    for st, key, beta in zip(states, keys, betas):
        want.append(jk.step(jprob, st, key, jnp.float32(beta)))
        k_site, k_flip = jax.random.split(key)
        sites.append(int(jax.random.randint(k_site, (), 0, jprob.n)))
        us.append(float(jax.random.uniform(k_flip)))
    got = sampler_api.RandomScanGibbs().update(
        prob, state, torch.tensor(betas), torch.tensor(sites), torch.tensor(us, dtype=torch.float32))
    _assert_step(got, want)
    assert (got.s != state.s).sum() > 0  # some chain flipped


def _ctmc_port_state(states, kind, draw, prob, carried=False):
    """The port's state of the JAX chains; `carried` keeps the sparse JAX
    tree and its tree_beta as the port's carried tree."""
    s = _t([st.s for st in states])
    t = _t([st.t for st in states])
    e = _t([st.e for st in states])
    if draw == "scan":
        aux = CTMCAux(_t([st.aux for st in states]), None, None, None)
    elif kind == "dense" or not carried:
        aux = CTMCAux(_t([st.aux[0] for st in states]), _t([st.aux[1] for st in states]),
                      None, None if kind == "dense" else prob.nbr_idx.long())
    else:
        aux = CTMCAux(*(_t([st.aux[j] for st in states]) for j in range(3)),
                      prob.nbr_idx.long())
    if kind == "sparse" and draw == "scan":
        aux = aux._replace(nbr=prob.nbr_idx.long())
    return KernelState(s=s, t=t, e=e, aux=aux)


@pytest.mark.parametrize("kind,draw", [("dense", "scan"), ("dense", "tree"),
                                       ("sparse", "tree"), ("sparse", "scan")])
def test_ctmc_step_equals_jax_step(kind, draw):
    """One event from the JAX state, then one from the JAX state after it.
    The sparse tree path meets both of the port's paths: the first event
    draws from a fresh build (the JAX rows at beta = 1 reuse their tree
    built at beta = 1 at init, the others rebuild); in the second every
    JAX row draws from the tree its first event repaired, and the port
    takes that tree as its carried tree. The port's repaired tree is held
    to the JAX one within 1e-6: a repaired root is a running sum whose leaf
    deltas carry the sigmoids' ulps, and after cancellation (a root falling
    from ~2 to ~0.07) those are many ulps of the root, so each event starts
    from the JAX state, as "one JAX step" does."""
    jprob, prob = _both_dense(12, 4) if kind == "dense" else _both_3regular(16, 5)
    B = 6
    jk = jsa.CTMC(site_draw=draw)
    states, keys = _jax_states(jprob, jk, B, seed=2)
    betas = np.array([1.0, 0.5, 1.0, 2.0, 1.0, 3.0], np.float32)
    state = _ctmc_port_state(states, kind, draw, prob)
    kernel = CTMC(site_draw=draw)
    for event in range(2):
        want, sites, expos = [], [], []
        for c, (st, key, beta) in enumerate(zip(states, keys, betas)):
            key = jax.random.fold_in(key, event)
            want.append(jk.step(jprob, st, key, jnp.float32(beta)))
            # passlint: ignore[PASS001] the test replays the step's own draws from its key
            k_dt, k_site = jax.random.split(key)
            expos.append(float(jax.random.exponential(k_dt)))
            if draw == "tree":
                sites.append(float(jax.random.uniform(k_site)))
            else:
                h = st.aux
                rates = jk.lambda0 * jglauber.flip_prob(jnp.float32(beta) * h, st.s)
                sites.append(int(jax.random.categorical(k_site, jnp.log(rates))))
        site = torch.tensor(sites, dtype=torch.float32 if draw == "tree" else torch.int64)
        got = kernel.update(prob, state, torch.tensor(betas), site,
                            torch.tensor(expos, dtype=torch.float32))
        _assert_step(got, want)
        if draw == "tree" and (kind == "dense" or event == 1):
            # (a rebuilding sparse event keeps the tree it drew from, JAX the repaired one)
            tree = np.stack([np.asarray(w.aux[1]) for w in want])
            np.testing.assert_allclose(got.aux.tree.numpy(), tree, rtol=1e-6, atol=1e-6)
        if kind == "sparse" and draw == "tree":
            assert (got.aux.tree_beta is None) == (event == 0)
        states = want
        # the JAX trees now hold the current rates at every row's beta
        state = _ctmc_port_state(states, kind, draw, prob, carried=True)


@pytest.mark.parametrize("kernel", ["random_scan_gibbs", "ctmc", CTMC(site_draw="tree")],
                         ids=["random_scan", "ctmc_scan", "ctmc_tree"])
def test_samples_boltzmann(kernel):
    """TV < 0.03 to exact enumeration on the 5-spin problem of
    tests/test_core_samplers.py: random scan by its empirical law, the CTMC
    by its holding-time-weighted law (one distribution per chain, pooled)."""
    prob = _small5()
    _, p = ising.enumerate_boltzmann(prob)
    res = run(prob, kernel, 3, n_steps=1000, n_chains=64, sample_every=1)
    if kernel == "random_scan_gibbs":
        w = ctmc.empirical_distribution(res.samples[:, 20:].reshape(-1, prob.n), prob.n)
    else:
        w = ctmc.time_weighted_distribution(ctmc.CTMCRun.from_result(res), prob.n).mean(0)
    assert 0.5 * np.abs(w.double().numpy() - p).sum() < TV_MAX


def test_ctmc_tree_draw_chi_square_exact_boltzmann():
    """tests/test_sampler_api.py:303 on the port: scan and tree draws, TV and
    chi-square (against 10 x df) to the exact law, and to each other."""
    prob = _small5()
    _, p = ising.enumerate_boltzmann(prob)
    n_chains, n_events = 64, 1000
    dists = {}
    for draw in ("scan", "tree"):
        res = run(prob, CTMC(site_draw=draw), 7, n_steps=n_events, n_chains=n_chains,
                  sample_every=1)
        w = ctmc.time_weighted_distribution(ctmc.CTMCRun.from_result(res), prob.n)
        dists[draw] = w.double().mean(0).numpy()
    for draw, w in dists.items():
        assert 0.5 * np.abs(w - p).sum() < TV_MAX, draw
        chi2 = n_chains * n_events * float(((w - p) ** 2 / p).sum())
        assert chi2 < 10 * (2 ** prob.n - 1), (draw, chi2)
    assert 0.5 * np.abs(dists["tree"] - dists["scan"]).sum() < TV_MAX


def _sparse_ctmc_dists(seed, n_chains, n_events):
    """The exact law of random_3regular_maxcut(8, 1) and the time-weighted
    laws of the sparse tree CTMC (constant beta: the carried tree) and the
    dense scan CTMC on the densified graph, chains pooled."""
    sp = problems.random_3regular_maxcut(8, 1, device=CPU)
    dense = sp.to_dense()
    _, p = ising.enumerate_boltzmann(dense)
    dists = {}
    for name, prob, draw in (("sparse-tree", sp, "tree"), ("dense-scan", dense, "scan")):
        res = run(prob, CTMC(site_draw=draw), seed, n_steps=n_events, n_chains=n_chains,
                  sample_every=1)
        w = ctmc.time_weighted_distribution(ctmc.CTMCRun.from_result(res), sp.n)
        dists[name] = w.double().mean(0).numpy()
    return p, dists


def test_sparse_ctmc_chi_square_exact_boltzmann():
    """tests/test_sparse.py:255 on the port: the incremental sparse tree
    CTMC and the dense scan CTMC on the densified graph."""
    # twice the JAX test's 60k events: the antiferromagnetic graph mixes
    # slowly; the TVs of both packages at six seeds and both sizes are in
    # PERF.md (`python tests/test_torch_ctmc.py` prints them)
    n_chains, n_events = 64, 2000
    p, dists = _sparse_ctmc_dists(7, n_chains, n_events)
    sp_n = 8
    for name, w in dists.items():
        assert 0.5 * np.abs(w - p).sum() < TV_MAX, name
        chi2 = n_chains * n_events * float(((w - p) ** 2 / np.maximum(p, 1e-300)).sum())
        assert chi2 < 10 * (2 ** sp_n - 1), (name, chi2)
    assert 0.5 * np.abs(dists["sparse-tree"] - dists["dense-scan"]).sum() < TV_MAX


@pytest.mark.parametrize("site_draw", ["scan", "tree"])
@pytest.mark.parametrize("beta", [12.0, 500.0])
def test_ctmc_frozen_cold_chain_stays_finite(beta, site_draw):
    """tests/test_sampler_api.py:252: at large beta no site may flip and the
    dwell time stays finite (beta=12: subnormal total; 500: exactly 0)."""
    n = 8
    J = -0.5 * (np.ones((n, n)) - np.eye(n))
    prob = ising.DenseIsing.from_numpy(J, np.zeros(n), device=CPU)
    s0 = torch.ones(n)
    res = run(prob, CTMC(site_draw=site_draw), 0, n_steps=21, s0=s0, schedule=beta,
              sample_every=1)
    assert np.isfinite(float(res.t))
    assert torch.isfinite(res.energies).all() and torch.isfinite(res.times).all()
    np.testing.assert_array_equal(res.s.numpy(), s0.numpy())
    np.testing.assert_array_equal(res.samples.numpy(), np.ones((21, n), np.float32))
    np.testing.assert_array_equal(res.energies.numpy(), np.full(21, float(prob.energy(s0))))


def test_sparse_ctmc_frozen_cold_chain_stays_finite():
    """tests/test_sparse.py:309 on the port."""
    n = 8
    sp = SparseIsing.from_edges(n, [(i, (i + 1) % n, -0.5) for i in range(n)], device=CPU)
    s0 = torch.ones(n)
    res = run(sp, CTMC(site_draw="tree"), 0, n_steps=21, s0=s0, schedule=500.0,
              sample_every=1, n_chains=1)
    assert np.isfinite(float(res.t))
    np.testing.assert_array_equal(res.s.numpy(), s0.numpy())
    np.testing.assert_array_equal(res.energies.numpy(), np.full(21, float(sp.energy(s0))))


@pytest.mark.parametrize("case", ["dense_scan", "dense_tree", "sparse_tree_annealed",
                                  "random_scan_sparse"])
def test_incremental_energy_tracks_true_energy(case):
    """tests/test_sampler_api.py:276 and tests/test_sparse.py:286,344: the
    incrementally kept energy stays within 5e-3 of problem.energy, over
    the JAX tests' numbers of events."""
    if case.startswith("dense"):
        prob = ising.DenseIsing.from_numpy(*_dense_numpy(16, 5, 0.4), device=CPU)
        kernel, kw = CTMC(site_draw=case[6:]), dict(n_steps=10_000, sample_every=500)
    elif case == "sparse_tree_annealed":
        prob = problems.random_3regular_maxcut(12, 7, device=CPU)
        kernel = CTMC(site_draw="tree")
        kw = dict(n_steps=2000, sample_every=100, schedule=sampler_api.geometric(0.3, 3.0))
    else:
        prob = problems.random_3regular_maxcut(16, 4, device=CPU)
        kernel, kw = "random_scan_gibbs", dict(n_steps=5000, sample_every=250)
    res = run(prob, kernel, 1, **kw)
    np.testing.assert_allclose(res.energies.numpy(), prob.energy(res.samples).numpy(),
                               atol=5e-3)


def test_ctmc_site_draw_config_and_auto_threshold():
    """tests/test_sampler_api.py:286 on the port."""
    small = ising.DenseIsing.from_numpy(*_dense_numpy(8, 0), device=CPU)
    assert CTMC().resolved_site_draw(small) == "scan"
    n_big = sampler_api.TREE_SITE_DRAW_MIN_N
    assert n_big == jsa.TREE_SITE_DRAW_MIN_N and sampler_api.RATE_FLOOR == jsa.RATE_FLOOR
    big = ising.DenseIsing.from_numpy(np.zeros((n_big, n_big)), np.zeros(n_big), device=CPU)
    assert CTMC().resolved_site_draw(big) == "tree"
    assert CTMC(site_draw="scan").resolved_site_draw(big) == "scan"
    with pytest.raises(ValueError, match="site_draw"):
        run(small, CTMC(site_draw="alias"), 0, n_steps=4)
    r_auto = run(small, "ctmc", 1, n_steps=32, sample_every=4)
    r_scan = run(small, CTMC(site_draw="scan"), 1, n_steps=32, sample_every=4)
    np.testing.assert_array_equal(r_auto.samples.numpy(), r_scan.samples.numpy())
    # preferred_unroll: the JAX rule, for both packages' constants
    n_block = sampler_api.CTMC_TREE_BLOCK_MIN_N
    block = ising.DenseIsing.from_numpy(np.zeros((n_block, n_block)), np.zeros(n_block),
                                        device=CPU)
    assert CTMC().preferred_unroll(block) == sampler_api.CTMC_TREE_BLOCK_EVENTS == 2
    assert CTMC().preferred_unroll(big) == 1 and CTMC(site_draw="scan").preferred_unroll(block) == 1
    assert sampler_api._resolve_unroll("auto", CTMC(), block) == 2
    assert sampler_api._resolve_unroll("auto", TauLeap(), block) == 1


def test_unroll_event_blocks_bit_parity():
    """tests/test_sampler_api.py:350 on the port: run(unroll=K) changes no
    drawn number, across striding with a remainder tail, chains, both CTMC
    draws and tau-leap; sparse too (tests/test_sparse.py:325)."""
    prob = ising.DenseIsing.from_numpy(*_dense_numpy(12, 3), device=CPU)
    sp = problems.random_3regular_maxcut(12, 6, device=CPU)
    s0 = sampler_api.random_init(torch.Generator().manual_seed(0), (prob.n,), device=CPU)
    cases = [(prob, CTMC(site_draw="tree")), (prob, CTMC(site_draw="scan")),
             (prob, TauLeap(dt=0.25)), (sp, CTMC(site_draw="tree"))]
    for p, kern in cases:
        base = run(p, kern, 1, n_steps=23, s0=s0, sample_every=5)
        for k in (3, 8, 40):
            blocked = run(p, kern, 1, n_steps=23, s0=s0, sample_every=5, unroll=k)
            for a, b in zip(base[:5], blocked[:5]):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
    mc = run(prob, CTMC(site_draw="tree"), 2, n_steps=12, n_chains=3, sample_every=4)
    mc_u = run(prob, CTMC(site_draw="tree"), 2, n_steps=12, n_chains=3, sample_every=4,
               unroll=4)
    np.testing.assert_array_equal(mc.samples.numpy(), mc_u.samples.numpy())
    for bad in (0, "fast", True, 2.0):
        with pytest.raises(ValueError, match="unroll"):
            run(prob, CTMC(), 0, n_steps=4, unroll=bad)


def test_ctmc_tree_multi_chain_and_first_hit():
    """tests/test_sampler_api.py:318: the tree aux survives batching and
    first-hit tracking."""
    prob = problems.random_maxcut(16, 1, device=CPU)
    ref = run(prob, "random_scan_gibbs", 9, n_steps=2000, sample_every=50, n_chains=2)
    e_target = float(np.median(ref.energies.numpy()))
    res = run(prob, CTMC(site_draw="tree"), 5, n_steps=500, n_chains=4, first_hit=e_target)
    assert res.t_hit.shape == (4,) and res.hit.shape == (4,)
    assert res.hit.any()
    assert torch.isfinite(res.t_hit[res.hit]).all()


def test_time_weighted_final_dwell_regression():
    """tests/test_core_samplers.py:80: the last state dwells run.t -
    times[-1]; equal to the JAX estimator on the same run."""
    run_ = ctmc.CTMCRun(s=torch.tensor([-1.0, 1.0]), t=torch.tensor(7.0),
                        samples=torch.tensor([[1.0, 1.0], [-1.0, 1.0]]),
                        times=torch.tensor([1.0, 3.0]), energies=torch.zeros(2))
    w = ctmc.time_weighted_distribution(run_, 2).numpy()
    np.testing.assert_allclose(w[0b11], 2.0 / 6.0, rtol=1e-6)
    np.testing.assert_allclose(w[0b10], 4.0 / 6.0, rtol=1e-6)
    assert w.sum() == pytest.approx(1.0)
    from repro.core import ctmc as jctmc

    jrun = jctmc.CTMCRun(*(jnp.asarray(x.numpy()) for x in run_))
    np.testing.assert_array_equal(w, np.asarray(jctmc.time_weighted_distribution(jrun, 2)))


def test_time_weighted_single_observation_is_finite():
    """tests/test_core_samplers.py:96 on the port: one strided observation
    is weighted by the tail interval; one event under sample_every=1 (all
    dwells zero) falls back to the visit counts."""
    J = np.asarray([[0.0, -0.8], [-0.8, 0.0]])
    prob = ising.DenseIsing.from_numpy(J, [0.3, -0.1], device=CPU)
    s0 = torch.tensor([1.0, -1.0])
    run1 = ctmc.gillespie(prob, 1, s0, n_events=3, sample_every=2)
    assert run1.samples.shape == (1, 2) and float(run1.t) > float(run1.times[-1])
    w = ctmc.time_weighted_distribution(run1, 2).numpy()
    assert np.all(np.isfinite(w)) and w.sum() == pytest.approx(1.0)
    assert w.max() == pytest.approx(1.0)
    run2 = ctmc.gillespie(prob, 2, s0, n_events=1, sample_every=1)
    w1 = ctmc.time_weighted_distribution(run2, 2).numpy()
    assert np.all(np.isfinite(w1)) and w1.sum() == pytest.approx(1.0)
    assert w1.max() == pytest.approx(1.0)


def test_gillespie_wrappers_and_estimators_match_jax():
    """The wrappers run the CTMC kernel; the estimators equal the JAX ones
    on the same arrays, one chain or per row."""
    prob = _small5()
    s0 = torch.ones(5)
    r = ctmc.gillespie(prob, 4, s0, n_events=50, sample_every=5)
    assert r.samples.shape == (10, 5) and r.times.shape == (10,)
    t_hit, hit = ctmc.gillespie_first_hit(prob, 4, s0, e_target=1e9, n_events=5)
    assert bool(hit) and float(t_hit) == 0.0
    from repro.core import ctmc as jctmc

    rng = np.random.default_rng(0)
    samples = rng.choice([-1.0, 1.0], (3, 40, 5)).astype(np.float32)
    times = np.cumsum(rng.exponential(1.0, (3, 40)), 1).astype(np.float32)
    t_end = times[:, -1] + np.float32(0.5)
    batched = ctmc.CTMCRun(s=None, t=torch.tensor(t_end), samples=torch.tensor(samples),
                           times=torch.tensor(times), energies=None)
    got_w = ctmc.time_weighted_distribution(batched, 5).numpy()
    got_e = ctmc.empirical_distribution(torch.tensor(samples), 5).numpy()
    for c in range(3):
        jr = jctmc.CTMCRun(s=None, t=jnp.asarray(t_end[c]), samples=jnp.asarray(samples[c]),
                           times=jnp.asarray(times[c]), energies=None)
        np.testing.assert_allclose(got_w[c], np.asarray(jctmc.time_weighted_distribution(jr, 5)),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(
            got_e[c], np.asarray(jctmc.empirical_distribution(jnp.asarray(samples[c]), 5)))


def test_first_hit_and_shapes_through_run():
    """Both new kernels through run(): result shapes, recorded energies
    from the incremental e, model time, and a sparse random scan."""
    prob = ising.DenseIsing.from_numpy(*_dense_numpy(10, 1), device=CPU)
    for kernel in ("random_scan_gibbs", "ctmc"):
        res = run(prob, kernel, 0, n_steps=40, n_chains=3, sample_every=8, first_hit=-1e9)
        assert res.samples.shape == (3, 5, 10) and res.energies.shape == (3, 5)
        assert res.energies.dtype == res.times.dtype == torch.float32
        assert not res.hit.any() and torch.isinf(res.t_hit).all()
        np.testing.assert_allclose(res.energies.numpy(), prob.energy(res.samples).numpy(),
                                   atol=1e-5)
    rs = run(prob, "random_scan_gibbs", 0, n_steps=40, sample_every=8)
    np.testing.assert_allclose(rs.times.numpy(), 8.0 * np.arange(1, 6))
    sp = problems.random_3regular_maxcut(10, 2, device=CPU)
    assert run(sp, "random_scan_gibbs", 0, n_steps=8).s.shape == (10,)
    lat = problems.cal_problem(device=CPU)
    for kernel in ("random_scan_gibbs", "ctmc"):
        with pytest.raises(ValueError, match="supported problem kinds"):
            run(lat, kernel, 0, n_steps=2)


def test_sparse_ctmc_carried_tree_stays_the_build_of_the_rates():
    """After thousands of events at a constant beta (the incremental path)
    the carried tree equals a fresh build of the rates recomputed from the
    final s and h bit for bit: the path repair never drifts."""
    sp = problems.random_3regular_maxcut(256, 3, device=CPU)
    kernel = CTMC(site_draw="tree")
    gen = torch.Generator().manual_seed(2)
    beta = torch.full((4,), 3.0)
    state = kernel.init(sp, gen, None, 4, beta=beta)
    assert kernel.carries_tree(sp) and state.aux.tree_beta is not None
    for _ in range(2000):
        state = kernel.step(sp, state, gen, beta)
    np.testing.assert_array_equal(state.aux.h.numpy(), sp.local_fields(state.s).numpy())
    rates = kernel.rates(sp, state.s, state.aux.h, beta)
    np.testing.assert_array_equal(state.aux.tree.numpy(), event_tree.build(rates).numpy())
    np.testing.assert_array_equal(state.e.numpy(), sp.energy(state.s).numpy())


@pytest.mark.parametrize("betas", [[3.0] * 4, [0.5, 1.0, 2.0, 3.0]])
def test_sparse_ctmc_carried_and_rebuilt_trees_draw_the_same_events(betas):
    """The carried tree (init told the constant beta: repaired in place,
    never rebuilt) and the rebuilding path (a fresh build every event) run
    the same events bit for bit, one beta per row; the carried tree is
    repaired in place, the rebuilt one is new every event."""
    sp = problems.random_3regular_maxcut(64, 1, device=CPU)
    kernel = CTMC(site_draw="tree")
    beta = torch.tensor(betas)
    runs = []
    for carried in (True, False):
        gen = torch.Generator().manual_seed(4)
        state = kernel.init(sp, gen, None, 4, beta=beta if carried else None)
        tree = state.aux.tree
        for _ in range(300):
            state = kernel.step(sp, state, gen, beta)
        assert (state.aux.tree is tree) == carried
        runs.append(state)
    carried, rebuilt = runs
    for a, b in ((carried.s, rebuilt.s), (carried.t, rebuilt.t), (carried.e, rebuilt.e),
                 (carried.aux.h, rebuilt.aux.h)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert rebuilt.aux.tree_beta is None
    np.testing.assert_array_equal(carried.aux.tree_beta.numpy(), beta.numpy())


@pytest.mark.parametrize("schedule,carried", [(None, True), (2.0, True),
                                              (sampler_api.constant(1.5), True),
                                              ("per_chain", True), ("ramp", False),
                                              ("dense", False)])
def test_run_carries_the_sparse_tree_only_under_a_constant_schedule(schedule, carried):
    """run() tells the CTMC each chain's beta when its schedule never
    changes (one host decision before the loop); a ramp rebuilds every
    event, and dense problems always do. Either way the incremental state
    stays exact."""
    sp = problems.random_3regular_maxcut(32, 2, device=CPU)
    prob = sp.to_dense() if schedule == "dense" else sp
    if schedule == "per_chain":
        schedule = np.repeat([[0.5], [2.0], [3.0]], 40, axis=1)
    elif schedule in ("ramp", "dense"):
        schedule = sampler_api.linear(0.5, 2.0)
    make = sampler_api._make_run(prob, CTMC(site_draw="tree"), 3, n_steps=40, n_chains=3,
                                 schedule=schedule, sample_every=10)
    res = make()
    st = make.final_state
    assert (st.aux.tree_beta is not None) == carried
    np.testing.assert_allclose(res.energies.numpy(), prob.energy(res.samples).numpy(),
                               atol=1e-5)
    np.testing.assert_array_equal(st.aux.h.numpy(), prob.local_fields(st.s).numpy())


@pytest.mark.parametrize("n_steps,every,max_steps", [(23, 5, 32), (100, 0, 32), (97, 40, 32),
                                                     (64, 32, 32), (7, 1, 3), (5, 9, 4)])
def test_step_loop_blocks_cover_the_run(n_steps, every, max_steps):
    """graph_loop.plan_blocks: the blocks run every step once, none longer
    than max_steps, and record exactly after steps every, 2 every, ..."""
    blocks = graph_loop.plan_blocks(n_steps, every, max_steps)
    assert sum(steps for steps, _ in blocks) == n_steps
    assert all(0 < steps <= max_steps for steps, _ in blocks)
    assert len(set(blocks)) <= 4  # graphs a run captures at most
    recorded, start = [], 0
    for steps, records in blocks:
        assert all(0 <= r < steps for r in records)
        recorded += [start + r + 1 for r in records]
        start += steps
    want = list(range(every, n_steps + 1, every)) if every else []
    assert recorded == want


def test_a_finished_run_is_freed_without_a_cyclic_collection():
    """A `_Run` and its step loop form no reference cycle, so a run's graphs
    and buffers go with its last reference, never at a cyclic collection
    (which could fall inside another run's capture on the card)."""
    import gc
    import weakref

    prob = problems.random_3regular_maxcut(16, 0, device=CPU)
    collecting = gc.isenabled()
    gc.disable()
    try:
        make = sampler_api._make_run(prob, CTMC(site_draw="tree"), 0, n_steps=40, n_chains=2)
        make()
        gone = weakref.ref(make)
        del make
        assert gone() is None
    finally:
        if collecting:
            gc.enable()


@pytest.mark.cuda
def test_graphed_run_equals_the_eager_one_on_the_card():
    """On a CUDA problem run() replays CUDA graphs; the eager loop on the
    same seed gives the same numbers (chip_smoke.py's graph_vs_eager does
    this at full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an sm_90 card); chip_smoke.py checks it there")
    prob = problems.random_3regular_maxcut(64, 1, device="cuda")
    for kernel in (CTMC(site_draw="tree"), "random_scan_gibbs"):
        kw = dict(n_steps=100, n_chains=8, sample_every=7, first_hit=-40.0, diagnostics=True)
        graphed = sampler_api._make_run(prob, kernel, 3, **kw)()
        eager = sampler_api._make_run(prob, kernel, 3, eager=True, **kw)()
        for a, b in zip(graphed[:7], eager[:7]):
            assert torch.equal(a, b)


def _tv_survey():
    """TV to the exact law of the two CTMCs of
    test_sparse_ctmc_chi_square_exact_boltzmann at six seeds: the port at
    64 chains x 1000 and x 2000 events, and the JAX package's test itself
    (one chain) at the same numbers of chain-events."""
    from repro.core import ctmc as jctmc
    from repro.core import problems as jprob

    jsp = jprob.random_3regular_maxcut(8, seed=1)
    print("seed chain_events port_sparse_tree port_dense_scan jax_sparse_tree jax_dense_scan")
    for n_events in (1000, 2000):
        for seed in (0, 1, 2, 3, 4, 7):
            p, dists = _sparse_ctmc_dists(seed, 64, n_events)
            tvs = [0.5 * np.abs(dists[k] - p).sum() for k in ("sparse-tree", "dense-scan")]
            for prob, draw in ((jsp, "tree"), (jsp.to_dense(), "scan")):
                res = jsa.run(prob, jsa.CTMC(site_draw=draw), jax.random.key(seed),
                              n_steps=64 * n_events, sample_every=1)
                w = np.asarray(jctmc.time_weighted_distribution(
                    jctmc.CTMCRun.from_result(res), 8), np.float64)
                tvs.append(0.5 * np.abs(w - p).sum())
            print(seed, 64 * n_events, *(f"{tv:.4f}" for tv in tvs), flush=True)


if __name__ == "__main__":
    _tv_survey()
