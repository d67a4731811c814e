"""The port's applications against the JAX package: Boltzmann-machine CD
training, parallel tempering, neural decision making, the digit data, the
`boltzmann_ml` zoo problem and the deprecated sampler wrappers.

Deterministic pieces are held exactly: the digit templates, the
multiplier-free pair correlations, `boltzmann_ml` built from the JAX zoo's
own batch (w, b and the estimated reference energy), the numpy-to-torch
constructors. Sampled behaviour is held at the JAX tests' own bounds
(tests/test_ml_and_decision.py, tests/test_extensions.py,
tests/test_core_samplers.py): torch cannot replay JAX's random stream."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boltzmann as jboltzmann
from repro.core import problems as jproblems
from repro.core import tempering as jtempering
from repro.data import digits as jdigits
from repro_torch.core import (annealing, boltzmann, ctmc, decision, ising, problems,
                              sampler_api, samplers, tempering)
from repro_torch.data import digits

torch.set_num_threads(1)

CPU = "cpu"


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _tv(p, q):
    return 0.5 * float(np.abs(np.asarray(p) - np.asarray(q)).sum())


# ---------------------------------------------------------------------------
# Data, correlations and the zoo's Boltzmann machine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", range(11))
def test_digit_templates_equal_jax(d):
    np.testing.assert_array_equal(digits.digit_template(d), np.asarray(jdigits.digit_template(d)))


def test_digit_batches_flip_pixels_at_the_rate():
    b = digits.digit_batch(3, 400, _gen(0), flip_prob=0.1, device=CPU)
    t = torch.tensor(digits.digit_template(3))
    assert b.shape == (400, 16, 16) and bool(((b == 1) | (b == -1)).all())
    assert abs(float((b != t).float().mean()) - 0.1) < 0.01
    mixed = digits.mixed_batch([0, 1, 2], 5, _gen(1), flip_prob=0.0, device=CPU)
    for k, d in enumerate((0, 1, 2)):
        t = torch.tensor(digits.digit_template(d))
        assert torch.equal(mixed[5 * k:5 * k + 5], t.expand(5, 16, 16))


def test_pair_correlations_multiplier_free_and_equal_to_jax():
    """XOR/popcount form == naive product form, and == the JAX function bit
    for bit (the mean rounded as XLA rounds it)."""
    rng = np.random.default_rng(0)
    batch = (2.0 * rng.integers(0, 2, (48, 8, 8)) - 1.0).astype(np.float32)
    got = boltzmann.pair_correlations(torch.tensor(batch), 8, 8)
    want = np.asarray(jboltzmann.pair_correlations(jnp.asarray(batch), 8, 8))
    np.testing.assert_array_equal(got.numpy(), want)
    tb = torch.tensor(batch)
    for k, (dy, dx) in enumerate(ising.KING_OFFSETS):
        naive = torch.mean(tb * ising.shift2d(tb, dy, dx), dim=0)
        valid = ising.shift2d(torch.ones(8, 8), dy, dx) > 0.5
        np.testing.assert_allclose(got[k][valid].numpy(), naive[valid].numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("size,seed", [(16, 0), (12, 3)])
def test_boltzmann_ml_from_the_jax_batch_equals_the_jax_zoo(size, seed):
    want = jproblems.get_problem("boltzmann_ml", size, seed)
    batch = np.asarray(jdigits.mixed_batch([0, 1, 2], 16, jax.random.key(seed), 0.05))
    got = problems.boltzmann_ml_from_batch(torch.tensor(batch), size, seed)
    assert (got.instance, got.ref_kind, got.kind, got.meta, got.ref_energy) == (
        want.instance, want.ref_kind, want.kind, want.meta, want.ref_energy)
    for f in ("w", "b", "clamp_mask", "clamp_value", "dead_mask"):
        np.testing.assert_array_equal(getattr(got.problem, f).numpy(),
                                      np.asarray(getattr(want.problem, f)), err_msg=f)


def test_boltzmann_ml_seeded_draw():
    """The registered generator draws its own batch from the seed: a
    deterministic lattice of the requested size, its reference no worse
    than the templates' energies."""
    a = problems.get_problem("boltzmann_ml", 12, 1, device=CPU)
    b = problems.get_problem("boltzmann_ml", 12, 1, device=CPU)
    assert a.kind == "lattice" and a.problem.shape == (12, 12) and a.ref_kind == "estimated"
    assert torch.equal(a.problem.w, b.problem.w) and a.ref_energy == b.ref_energy
    for d in (0, 1, 2):
        t = torch.tensor(digits.digit_template(d)[:12, :12])
        assert a.ref_energy <= float(a.problem.energy(t)) + 1e-9
    with pytest.raises(ValueError, match="16x16"):
        problems.get_problem("boltzmann_ml", 17, device=CPU)


# ---------------------------------------------------------------------------
# Contrastive divergence and reconstruction (tests/test_ml_and_decision.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampler", ["pass", "chromatic"])
def test_cd_learns_digit_distribution(sampler):
    """CD on a synthetic digit: data energy drops, mean activation matches
    (the JAX test's bounds; 'chromatic' is the path the card runs through
    the lattice plan kernel)."""
    batch = digits.digit_batch(3, n=64, generator=_gen(1), flip_prob=0.05, device=CPU)
    cfg = boltzmann.CDConfig(lr=0.08, n_model_steps=24, n_chains=24, quantize_bits=8,
                             sampler=sampler)
    state = boltzmann.init_cd(_gen(2), 16, 16, cfg, device=CPU)
    e0 = float(boltzmann.free_energy_proxy(state.problem, batch))
    gen = _gen(0)
    for _ in range(30):
        state = boltzmann.cd_step(state, batch, gen, cfg)
    assert state.step == 30
    e1 = float(boltzmann.free_energy_proxy(state.problem, batch))
    assert e1 < e0 - 1.0, f"data energy should drop: {e0} -> {e1}"
    model_mean = state.chains.mean(0).numpy()
    data_mean = batch.mean(0).numpy()
    corr = np.corrcoef(model_mean.ravel(), data_mean.ravel())[0, 1]
    assert corr > 0.5, f"model/data activation correlation too low: {corr}"


def test_cd_update_equals_jax_on_the_same_model_samples(monkeypatch):
    """One CD update from a JAX CD state (CDState.from_numpy), with the
    model phase's samples handed to both: the new weights and biases equal
    the JAX update's bit for bit (the mean rounded as XLA rounds it)."""
    rng = np.random.default_rng(4)
    cfg = boltzmann.CDConfig(lr=0.08, n_chains=8, quantize_bits=8)
    jcfg = jboltzmann.CDConfig(lr=0.08, n_chains=8, quantize_bits=8)
    w = rng.normal(0, 0.3, (8, 16, 16)).astype(np.float32)
    b = rng.normal(0, 0.3, (16, 16)).astype(np.float32)
    chains = (2.0 * rng.integers(0, 2, (8, 16, 16)) - 1).astype(np.float32)
    model_s = (2.0 * rng.integers(0, 2, (8, 16, 16)) - 1).astype(np.float32)
    batch = np.asarray(jdigits.digit_batch(2, 16, jax.random.key(0)))
    jstate = jboltzmann.init_cd(jax.random.key(0), 16, 16, jcfg)
    jstate = dataclasses.replace(jstate, problem=dataclasses.replace(
        jstate.problem, w=jnp.asarray(w), b=jnp.asarray(b)), chains=jnp.asarray(chains))
    state = boltzmann.CDState.from_numpy(w, b, chains, device=CPU)
    monkeypatch.setattr(jboltzmann, "_model_samples", lambda *a: jnp.asarray(model_s))
    monkeypatch.setattr(boltzmann, "_model_samples", lambda *a: torch.tensor(model_s))
    want = jboltzmann.cd_step(jstate, jnp.asarray(batch), jax.random.key(1), jcfg)
    got = boltzmann.cd_step(state, torch.tensor(batch), _gen(1), cfg)
    np.testing.assert_array_equal(got.problem.w.numpy(), np.asarray(want.problem.w))
    np.testing.assert_array_equal(got.problem.b.numpy(), np.asarray(want.problem.b))
    assert got.step == want.step == 1
    assert float(boltzmann.free_energy_proxy(got.problem, torch.tensor(batch))) == pytest.approx(
        float(jboltzmann.free_energy_proxy(want.problem, jnp.asarray(batch))), rel=1e-6)


def test_reconstruction_clamps_known_half():
    batch = digits.digit_batch(0, n=64, generator=_gen(1), flip_prob=0.03, device=CPU)
    cfg = boltzmann.CDConfig(lr=0.08, n_model_steps=24, n_chains=24)
    state = boltzmann.init_cd(_gen(2), 16, 16, cfg, device=CPU)
    gen = _gen(0)
    for _ in range(25):
        state = boltzmann.cd_step(state, batch, gen, cfg)
    img = batch[0]
    known = torch.zeros((16, 16), dtype=torch.bool)
    known[:8] = True
    rec = boltzmann.reconstruct(state.problem, _gen(5), img, known)
    assert torch.equal(rec[:8], img[:8])
    template = torch.tensor(digits.digit_template(0))
    agree = float((rec[8:] == template[8:]).float().mean())
    assert agree > 0.6, f"reconstruction agreement {agree}"


# ---------------------------------------------------------------------------
# Neural decision making
# ---------------------------------------------------------------------------


def test_decision_couplings_equal_jax():
    targets = np.array([[-300.0, 1000.0], [300.0, 1000.0], [0.0, 800.0]], np.float32)
    pos = np.array([12.0, 40.0], np.float32)
    assign = np.arange(30) % 3
    for eta in (1.0, 4.0):
        J, ghat = decision.couplings(torch.tensor(pos), torch.tensor(targets),
                                     torch.tensor(assign), eta)
        from repro.core import decision as jdecision

        jJ, jghat = jdecision.couplings(jnp.asarray(pos), jnp.asarray(targets),
                                        jnp.asarray(assign), eta)
        np.testing.assert_allclose(ghat.numpy(), np.asarray(jghat), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(J.numpy(), np.asarray(jJ), rtol=1e-5, atol=1e-5)


def test_decision_bifurcates():
    """Two-target fly run commits to one target; eta moves the commit point
    (the JAX test, tests/test_ml_and_decision.py)."""
    targets = np.array([[-300.0, 1000.0], [300.0, 1000.0]], np.float32)
    cfg = decision.DecisionConfig(n_neurons=40, eta=1.0, max_steps=160)
    arrivals, commit_d = [], []
    for seed in range(6):
        traj = decision.simulate(seed, targets, cfg, device=CPU)
        assert traj.positions.shape == (161, 2) and traj.spins.shape == (160, 40)
        pos = traj.positions.numpy()
        arrivals.append(np.linalg.norm(targets - pos[-1][None], axis=-1).min() < 150.0)
        commit_d.append(float(decision.bifurcation_distance(traj.positions, targets)))
    assert np.mean(arrivals) >= 0.5, f"too few arrivals: {arrivals}"
    cfg2 = decision.DecisionConfig(n_neurons=40, eta=4.0, max_steps=160)
    commit_d2 = [float(decision.bifurcation_distance(
        decision.simulate(100 + seed, targets, cfg2, device=CPU).positions, targets))
        for seed in range(6)]
    assert np.median(commit_d2) > np.median(commit_d), (commit_d, commit_d2)


# ---------------------------------------------------------------------------
# Parallel tempering (tests/test_extensions.py)
# ---------------------------------------------------------------------------


def test_parallel_tempering_preserves_cold_distribution():
    """With all betas == 1 the swap rule is a no-op on the distribution:
    the cold replica samples the exact Boltzmann law (TV < 0.12)."""
    rng = np.random.default_rng(0)
    n = 5
    A = rng.normal(0, 0.6, (n, n))
    J = np.triu(A, 1)
    prob = ising.DenseIsing.from_numpy(J + J.T, np.zeros(n), device=CPU)
    _, p_exact = ising.enumerate_boltzmann(prob)
    st = tempering.init(prob, _gen(0), [1.0, 1.0, 1.0])
    gen = _gen(1)
    states = []
    for _ in range(400):
        st, _ = tempering.run(prob, gen, st, n_rounds=4, steps_per_round=8, dt=0.3)
        states.append(st.s[0].clone())
    emp = ctmc.empirical_distribution(torch.stack(states), n)
    assert _tv(emp, p_exact) < 0.12


def test_parallel_tempering_beats_single_replica_on_frustrated_instance():
    """Replica exchange reaches the SK ground state at least as well as a
    single cold chain of the same budget, within 0.35 of the exact ground
    energy, and replicas exchange."""
    prob = problems.sk_instance(18, 5, device=CPU)
    states, _ = ising.enumerate_boltzmann(prob)
    e_gs = float(prob.energy(torch.tensor(states, dtype=torch.float32)).min())
    st = tempering.init(prob, _gen(0), [0.3, 0.55, 1.0, 1.8])
    st, best_trace = tempering.run(prob, 1, st, n_rounds=120, steps_per_round=8)
    assert best_trace.shape == (120,)
    pt_best = float(best_trace.min())
    run1 = samplers.tau_leap_dense(prob, 2, samplers.random_init(_gen(3), (prob.n,), device=CPU),
                                   n_steps=120 * 8, dt=0.25, sample_every=4)
    assert pt_best <= float(run1.energies.min()) + 1e-6
    assert pt_best <= e_gs + 0.35, (pt_best, e_gs)
    assert int(st.n_swaps) > 0
    torch.testing.assert_close(st.energies, prob.energy(st.s))


def test_tempering_round_from_a_jax_state():
    """A PTState carried across from the JAX package (PTState.from_numpy)
    runs rounds in the port: the swap bookkeeping stays consistent (the
    betas fixed, the energies those of the states, the swap count only
    growing)."""
    jprob = jproblems.sk_instance(10, seed=2)
    jst = jtempering.init(jprob, jax.random.key(0), jnp.asarray([0.4, 0.8, 1.6]))
    jst, _ = jtempering.run(jprob, jax.random.key(1), jst, n_rounds=3, steps_per_round=4)
    st = tempering.PTState.from_numpy(*(np.asarray(x) for x in jst), device=CPU)
    prob = ising.DenseIsing.from_numpy(np.asarray(jprob.J), np.asarray(jprob.b), device=CPU)
    torch.testing.assert_close(st.energies, prob.energy(st.s))
    st2, trace = tempering.run(prob, 3, st, n_rounds=6, steps_per_round=4)
    assert torch.equal(st2.betas, st.betas) and int(st2.n_swaps) >= int(st.n_swaps)
    torch.testing.assert_close(st2.energies, prob.energy(st2.s))
    assert trace.shape == (6,) and bool(torch.isfinite(trace).all())


# ---------------------------------------------------------------------------
# The deprecated wrappers (tests/test_core_samplers.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_problem():
    rng = np.random.default_rng(0)
    n = 5
    A = rng.normal(0, 0.7, (n, n))
    J = np.triu(A, 1)
    prob = ising.DenseIsing.from_numpy(J + J.T, rng.normal(0, 0.4, n), device=CPU)
    _, p_exact = ising.enumerate_boltzmann(prob)
    return prob, p_exact


def test_wrappers_are_run(small_problem):
    """Each wrapper is one run() call: the same seed gives run()'s numbers."""
    prob, _ = small_problem
    s0 = samplers.random_init(_gen(1), (prob.n,), device=CPU)
    pairs = [
        (samplers.gibbs_random_scan(prob, 3, s0, 200, sample_every=2),
         sampler_api.run(prob, "random_scan_gibbs", 3, n_steps=200, s0=s0, sample_every=2)),
        (samplers.tau_leap_dense(prob, 4, s0, 100, dt=0.2, sample_every=5),
         sampler_api.run(prob, sampler_api.TauLeap(dt=0.2), 4, n_steps=100, s0=s0,
                         sample_every=5)),
    ]
    lat = problems.cal_problem(coupling=0.6, device=CPU)
    sl = samplers.random_init(_gen(2), (16, 16), device=CPU)
    pairs += [
        (samplers.chromatic_gibbs(lat, 5, sl, 20, sample_every=4),
         sampler_api.run(lat, "chromatic_gibbs", 5, n_steps=20, s0=sl, sample_every=4)),
        (samplers.tau_leap_lattice(lat, 6, sl, 20, dt=0.3, sample_every=4),
         sampler_api.run(lat, sampler_api.TauLeap(dt=0.3), 6, n_steps=20, s0=sl,
                         sample_every=4)),
    ]
    for legacy, res in pairs:
        assert isinstance(legacy, samplers.SampleRun)
        for f in ("s", "samples", "t", "energies"):
            assert torch.equal(getattr(legacy, f), getattr(res, f)), f
    t_hit, hit = samplers.gibbs_first_hit(prob, 7, s0, -1e9, 50)
    assert not bool(hit) and float(t_hit) == float("inf")
    betas = annealing.linear_schedule(0.3, 2.0, 60, device=CPU)
    np.testing.assert_array_equal(betas.numpy(),
                                  sampler_api.linear(0.3, 2.0).betas(60, CPU).numpy())
    assert annealing.geometric_schedule(0.3, 2.0, 60, device=CPU).shape == (60,)
    s, e = annealing.annealed_tau_leap_dense(prob, 8, s0, betas, 60)
    res = sampler_api.run(prob, sampler_api.TauLeap(dt=0.25), 8, n_steps=60, s0=s0,
                          schedule=betas)
    assert torch.equal(s, res.s) and torch.equal(e, prob.energy(res.s))
    s, e = annealing.annealed_tau_leap_lattice(lat, 9, sl, betas, 60)
    assert s.shape == (16, 16) and torch.equal(e, lat.energy(s))


def test_gibbs_random_scan_converges(small_problem):
    prob, p_exact = small_problem
    s0 = samplers.random_init(_gen(1), (prob.n,), device=CPU)
    run = samplers.gibbs_random_scan(prob, 3, s0, n_steps=40_000, sample_every=2)
    emp = ctmc.empirical_distribution(run.samples.reshape(-1, prob.n), prob.n)
    assert _tv(emp, p_exact) < 0.03


def test_clamped_conditional_through_the_wrapper():
    """Clamping = sampling the conditional distribution (Fig 4C)."""
    lat = problems.cal_problem(coupling=0.6, device=CPU)
    known = torch.zeros((16, 16), dtype=torch.bool)
    known[:8] = True
    template = torch.tensor(problems.cal_template())
    clamped = dataclasses.replace(lat, clamp_mask=known, clamp_value=template)
    s0 = samplers.random_init(_gen(0), (16, 16), device=CPU)
    s = samplers.chromatic_gibbs(clamped, 1, s0, n_sweeps=400).s
    assert torch.equal(s[:8], template[:8])
    assert float((s[8:] * template[8:]).mean()) > 0.9


def test_async_beats_sync_tts():
    """The paper's headline: async TTS << sync TTS at the same per-neuron
    rate (median first-hit model time over 16 chains, batched as rows)."""
    prob = problems.random_maxcut(24, 3, density=1.0, device=CPU)
    s0 = samplers.random_init(_gen(0), (prob.n,), device=CPU)
    long_run = samplers.gibbs_random_scan(prob, 9, s0, n_steps=40_000, sample_every=10)
    e_target = float(long_run.energies.min())
    s0s = samplers.random_init(_gen(1), (16, prob.n), device=CPU)
    kw = dict(n_steps=6000, s0=s0s, n_chains=16, first_hit=e_target)
    a = sampler_api.run(prob, "ctmc", 2, **kw)
    s = sampler_api.run(prob, "random_scan_gibbs", 3, **kw)
    med_a = float(a.t_hit[a.hit].median())
    med_s = float(s.t_hit[s.hit].median())
    assert med_a * 4 < med_s, f"async {med_a} vs sync {med_s}"
