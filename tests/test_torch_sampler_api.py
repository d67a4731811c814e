"""The port's run() driver against the JAX package's: schedules, result
shapes and dtypes, striding, model time, first-hit, multi-chain batching,
dispatch errors, and the sampled distribution.

torch cannot replay JAX's random stream, so sampled trajectories are held
statistically (TV against exact enumeration, mean energies against the JAX
run); everything deterministic (schedules, model time) is held exactly."""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from repro.core import problems as jproblems
from repro.core import sampler_api as jsa
from repro_torch import tracing
from repro_torch.core import ising, problems, sampler_api
from repro_torch.core.faults import FaultModel
from repro_torch.core.sampler_api import (
    TauLeap,
    constant,
    geometric,
    linear,
    resolve_schedule,
    run,
)

torch.set_num_threads(1)

CPU = "cpu"


def _dense_problem(n=12, seed=0, scale=0.6):
    rng = np.random.default_rng(seed)
    A = rng.normal(0, scale, (n, n))
    J = np.triu(A, 1)
    J = J + J.T
    return ising.DenseIsing.from_numpy(J, rng.normal(0, scale / 2, n), device=CPU)


def _grid_exact_problem(n=5, seed=0):
    """Dense problem whose J sits exactly on the int8 grid (codes/127), so
    the cuda backend's quantization is lossless."""
    rng = np.random.default_rng(seed)
    codes = np.triu(rng.integers(-126, 127, (n, n)), 1)
    codes = codes + codes.T
    codes[0, 1] = codes[1, 0] = 127  # pin max-abs: quantize round-trips exactly
    return ising.DenseIsing.from_numpy(codes / 127.0, rng.normal(0, 0.2, n), device=CPU)


def _tv_to_exact(prob, samples):
    _, p_exact = ising.enumerate_boltzmann(prob)
    bits = (samples.reshape(-1, prob.n).numpy() > 0).astype(np.int64)
    hist = np.bincount(bits @ (1 << np.arange(prob.n)), minlength=2**prob.n)
    return 0.5 * float(np.abs(hist / hist.sum() - p_exact).sum())


@pytest.mark.parametrize(
    "sched",
    [jsa.constant(0.7), jsa.linear(0.0, 1.0), jsa.linear(0.3, 2.0),
     jsa.geometric(0.1, 1.0), jsa.geometric(0.3, 3.0)],
    ids=lambda s: type(s).__name__,
)
@pytest.mark.parametrize("n_steps", [1, 2, 5, 300])
def test_schedules_match_jax(sched, n_steps):
    mine = {jsa.constant: constant, jsa.linear: linear, jsa.geometric: geometric}[type(sched)]
    got = mine(**dataclasses.asdict(sched)).betas(n_steps, CPU)
    want = np.asarray(sched.betas(n_steps))
    assert got.dtype == torch.float32 and got.shape == want.shape
    # linspace follows the JAX formula; XLA's CPU pow (geometric) and its
    # fused multiply-adds may round the last ulps differently: <= 8 ulp
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(got.numpy()[[0, -1]], want[[0, -1]])


def test_resolve_schedule_forms_and_errors():
    assert resolve_schedule(None, 5, device=CPU).shape == (5,)
    np.testing.assert_array_equal(resolve_schedule(2.0, 3, device=CPU).numpy(), [2.0] * 3)
    np.testing.assert_array_equal(
        resolve_schedule(np.float32(0.5), 2, device=CPU).numpy(), [0.5, 0.5])
    np.testing.assert_array_equal(
        resolve_schedule(constant(0.5), 2, device=CPU).numpy(),
        np.asarray(jsa.resolve_schedule(jsa.constant(0.5), 2)))
    two_d = np.ones((4, 8), np.float32)
    assert resolve_schedule(two_d, 8, 4, device=CPU).shape == (4, 8)
    with pytest.raises(ValueError, match="schedule length 7 != n_steps 5"):
        resolve_schedule(np.ones(7), 5, device=CPU)
    with pytest.raises(ValueError, match=r"5 rows.*n_chains=4"):
        resolve_schedule(np.ones((5, 8)), 8, 4, device=CPU)
    with pytest.raises(ValueError, match=r"requires n_chains > 1"):
        resolve_schedule(np.ones((2, 8)), 8, 1, device=CPU)
    with pytest.raises(ValueError, match="shape"):
        resolve_schedule(np.ones((2, 2, 4)), 4, device=CPU)


@pytest.mark.parametrize("n_chains", [1, 3])
def test_run_shapes_and_dtypes(n_chains):
    prob = _dense_problem()
    lead = () if n_chains == 1 else (n_chains,)
    for backend in ("ref", "cuda"):
        res = run(prob, "tau_leap", 0, n_steps=64, sample_every=8, n_chains=n_chains,
                  backend=backend)
        assert res.s.shape == lead + (prob.n,)
        assert res.t.shape == lead
        assert res.samples.shape == lead + (8, prob.n)
        assert res.times.shape == lead + (8,) and res.energies.shape == lead + (8,)
        assert res.s.dtype == res.samples.dtype == torch.float32
        assert res.times.dtype == res.energies.dtype == torch.float32
        assert set(np.unique(res.samples.numpy())) <= {-1.0, 1.0}
        assert res.t_hit is None and res.hit is None and res.timing is None
        t = res.times.numpy().reshape(-1, 8)
        assert np.all(np.diff(t, axis=-1) >= 0)
        np.testing.assert_allclose(
            res.energies.numpy(), prob.energy(res.samples).numpy(), rtol=1e-6)
        # sample_every=0: empty results in the sampling branches' dtypes
        empty = run(prob, "tau_leap", 0, n_steps=8, n_chains=n_chains, backend=backend)
        assert empty.samples.shape == lead + (0, prob.n)
        assert empty.times.shape == lead + (0,) and empty.energies.shape == lead + (0,)
        assert empty.energies.dtype == res.energies.dtype
        assert empty.times.dtype == res.times.dtype
        assert empty.samples.dtype == res.samples.dtype
        cat = torch.cat([empty.energies, res.energies], dim=-1)
        assert cat.dtype == res.energies.dtype


def test_remainder_steps_after_last_observation():
    """n_steps not divisible by sample_every: the tail still advances the
    chain, and striding draws no randomness of its own."""
    prob = _dense_problem(n=6, seed=2)
    full = run(prob, TauLeap(dt=0.3), 1, n_steps=17)
    strided = run(prob, TauLeap(dt=0.3), 1, n_steps=17, sample_every=5)
    assert strided.samples.shape == (3, prob.n)
    np.testing.assert_array_equal(full.s.numpy(), strided.s.numpy())
    assert float(strided.t) == float(full.t)
    assert float(strided.times[-1]) < float(strided.t)


@pytest.mark.parametrize("dt,lambda0,n_steps,every", [(0.1, 1.0, 97, 10), (0.3, 1.7, 40, 3)])
def test_model_time_equals_jax(dt, lambda0, n_steps, every):
    jprob = jproblems.sk_instance(8, 1)
    prob = ising.DenseIsing.from_numpy(np.asarray(jprob.J), np.asarray(jprob.b), device=CPU)
    want = jsa.run(jprob, jsa.TauLeap(dt=dt, lambda0=lambda0), jax.random.key(0),
                   n_steps=n_steps, sample_every=every)
    got = run(prob, TauLeap(dt=dt, lambda0=lambda0), 0, n_steps=n_steps, sample_every=every)
    assert got.t.item() == float(want.t)
    np.testing.assert_array_equal(got.times.numpy(), np.asarray(want.times))
    chains = run(prob, TauLeap(dt=dt, lambda0=lambda0), 0, n_steps=n_steps,
                 sample_every=every, n_chains=2, backend="cuda")
    np.testing.assert_array_equal(chains.times.numpy()[1], np.asarray(want.times))


def test_first_hit_semantics():
    prob = problems.random_maxcut(16, 1, device=CPU)
    warm = run(prob, TauLeap(dt=0.25), 9, n_steps=400, sample_every=20, n_chains=4)
    target = float(np.median(warm.energies.numpy()))
    res = run(prob, TauLeap(dt=0.25), 5, n_steps=300, n_chains=6, first_hit=target,
              sample_every=10)
    assert res.t_hit.shape == (6,) and res.hit.shape == (6,) and res.hit.dtype == torch.bool
    hit, t_hit = res.hit.numpy(), res.t_hit.numpy()
    assert hit.any()
    assert np.all(np.isfinite(t_hit[hit])) and np.all(np.isinf(t_hit[~hit]))
    assert np.all(t_hit[hit] <= res.t.numpy()[hit])
    # an already-met target hits at t=0; an unreachable one never does
    easy = run(prob, TauLeap(dt=0.25), 5, n_steps=5, n_chains=3, first_hit=1e9)
    assert easy.hit.all() and np.all(easy.t_hit.numpy() == 0.0)
    never = run(prob, TauLeap(dt=0.25), 5, n_steps=5, first_hit=-1e9)
    assert not bool(never.hit) and np.isinf(never.t_hit.item())
    # tracking the target changes nothing that was sampled
    plain = run(prob, TauLeap(dt=0.25), 5, n_steps=300, n_chains=6, sample_every=10)
    np.testing.assert_array_equal(plain.samples.numpy(), res.samples.numpy())


def test_multi_chain_annealing_and_independent_chains():
    prob = problems.random_maxcut(24, 3, device=CPU)
    res = run(prob, TauLeap(dt=0.25), 0, n_steps=400, n_chains=6,
              schedule=geometric(0.3, 2.5), sample_every=40, backend="cuda")
    assert res.s.shape == (6, prob.n) and res.samples.shape == (6, 10, prob.n)
    assert len(np.unique(res.s.numpy(), axis=0)) > 1  # chains are independent
    e = res.energies.numpy()
    assert e[:, -1].mean() < e[:, 0].mean()  # annealing lowers energy


def test_per_chain_schedules():
    """(n_chains, n_steps) schedules: each chain is a row with its own beta;
    the cold chain ends lower than the hot one."""
    prob = problems.sk_instance(16, 7, device=CPU)
    betas = np.stack([np.full(300, 0.1), np.full(300, 3.0)]).astype(np.float32)
    for backend in ("ref", "cuda"):
        res = run(prob, TauLeap(dt=0.2), 4, n_steps=300, n_chains=2, schedule=betas,
                  sample_every=30, backend=backend)
        e = res.energies.numpy()
        assert e[1, -5:].mean() < e[0, -5:].mean(), backend
    with pytest.raises(ValueError, match=r"2 rows.*n_chains=3"):
        run(prob, TauLeap(dt=0.2), 4, n_steps=300, n_chains=3, schedule=betas)
    with pytest.raises(ValueError, match="n_chains"):
        run(prob, TauLeap(dt=0.2), 4, n_steps=300, schedule=betas)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_tau_leap_samples_boltzmann(backend):
    """Small dt tau-leap on a grid-exact n=5 problem samples the Boltzmann
    distribution: TV < 0.06, the JAX bias test's bound at dt=0.05. The
    couplings reach |J| = 1, so chains relax slowly: over 4 seeds, 4000
    steps gave TV 0.016-0.070 and 16000 steps 0.007-0.019."""
    prob = _grid_exact_problem()
    res = run(prob, TauLeap(dt=0.05), 3, n_steps=16000, n_chains=64, sample_every=4,
              backend=backend)
    assert _tv_to_exact(prob, res.samples) < 0.06


def test_cuda_backend_tracks_ref_on_grid_exact_problem():
    """Same generator, same uniforms: on a grid-exact problem the int8
    field is exact, so the two backends' trajectories agree except where a
    uniform lands within float rounding of a flip threshold."""
    prob = _grid_exact_problem(n=48)
    kw = dict(n_steps=200, sample_every=10, n_chains=2)
    r_ref = run(prob, TauLeap(dt=0.25), 2, backend="ref", **kw)
    r_cuda = run(prob, TauLeap(dt=0.25), 2, backend="cuda", **kw)
    assert float((r_ref.samples == r_cuda.samples).float().mean()) > 0.99
    # on CPU tensors, "auto" is the ref backend
    r_auto = run(prob, TauLeap(dt=0.25), 2, backend="auto", **kw)
    np.testing.assert_array_equal(r_auto.samples.numpy(), r_ref.samples.numpy())


def test_mean_energy_agrees_with_jax_run():
    """The port and the JAX driver on the same sk_instance(16, 7): the mean
    final energies of 32 chains agree within 4 combined standard errors."""
    jprob = jproblems.sk_instance(16, 7)
    prob = ising.DenseIsing.from_numpy(np.asarray(jprob.J), np.asarray(jprob.b), device=CPU)
    kw = dict(n_steps=300, n_chains=32)
    want = jsa.run(jprob, jsa.TauLeap(dt=0.2), jax.random.key(0),
                   schedule=jsa.geometric(0.3, 2.0), **kw)
    e_j = np.asarray(jprob.energy(want.s), np.float64)
    for backend in ("ref", "cuda"):
        got = run(prob, TauLeap(dt=0.2), 0, schedule=geometric(0.3, 2.0),
                  backend=backend, **kw)
        e_t = prob.energy(got.s).numpy().astype(np.float64)
        se = np.sqrt(e_j.var(ddof=1) / e_j.size + e_t.var(ddof=1) / e_t.size)
        assert abs(e_t.mean() - e_j.mean()) < 4 * se, (backend, e_t.mean(), e_j.mean(), se)


def test_timeit_reports_throughput_and_identical_results():
    prob = _dense_problem(n=10, seed=1)
    kw = dict(n_steps=60, sample_every=10)
    plain = run(prob, TauLeap(dt=0.25), 1, **kw)
    timed = run(prob, TauLeap(dt=0.25), 1, timeit=True, **kw)
    t = timed.timing
    assert isinstance(t, sampler_api.RunTiming)
    assert t.wall_s > 0 and t.compile_s >= 0
    assert t.steps_per_s == pytest.approx(60 / t.wall_s)
    assert t.chain_steps_per_s == pytest.approx(t.steps_per_s)
    np.testing.assert_array_equal(plain.samples.numpy(), timed.samples.numpy())
    # a caller's generator: both passes replay its stream
    gen = torch.Generator().manual_seed(1)
    g_timed = run(prob, TauLeap(dt=0.25), gen, timeit=True, **kw)
    np.testing.assert_array_equal(g_timed.samples.numpy(), plain.samples.numpy())
    chains = run(prob, TauLeap(dt=0.25), 2, n_steps=40, n_chains=3, timeit=True)
    assert chains.timing.chain_steps_per_s == pytest.approx(3 * chains.timing.steps_per_s)


def test_s0_is_the_initial_state():
    prob = _dense_problem(n=8)
    s0 = torch.ones(8)
    res = run(prob, TauLeap(dt=1e-9), 0, n_steps=3, s0=s0, sample_every=1)
    np.testing.assert_array_equal(res.samples.numpy(), np.ones((3, 8), np.float32))
    s0c = torch.tensor([[1.0] * 8, [-1.0] * 8])
    res = run(prob, TauLeap(dt=1e-9), 0, n_steps=2, s0=s0c, n_chains=2)
    np.testing.assert_array_equal(res.s.numpy(), s0c.numpy())
    with pytest.raises(ValueError, match="s0 has shape"):
        run(prob, TauLeap(), 0, n_steps=2, s0=torch.ones(7))


def test_registry_and_error_paths():
    assert sampler_api.kernel_names() == sorted(jsa.KERNELS) == [
        "chromatic_gibbs", "colored_gibbs", "ctmc", "random_scan_gibbs", "tau_leap"]
    assert isinstance(sampler_api.get_kernel("tau_leap", dt=0.5), TauLeap)
    prob = _dense_problem(n=8)
    with pytest.raises(KeyError, match="unknown sampler kernel"):
        run(prob, "metropolis_lights_out", 0, n_steps=10)
    # every kernel of the JAX registry runs: the sync baseline and the CTMC
    for name in ("random_scan_gibbs", "ctmc"):
        res = run(prob, name, 0, n_steps=10)
        assert res.s.shape == (8,) and float(res.t) > 0
        # a fault model with every fault off runs the fault-free program
        noop = run(prob, name, 0, n_steps=4, faults=FaultModel())
        for a, b in zip(noop[:5], run(prob, name, 0, n_steps=4)[:5]):
            assert torch.equal(a, b)
    # the Gibbs sweeps are ported, for their own problem kinds
    for name, kind in (("chromatic_gibbs", "lattice"), ("colored_gibbs", "sparse")):
        with pytest.raises(ValueError, match=f"supported problem kinds: \\('{kind}',\\)"):
            run(prob, name, 0, n_steps=10)
    for bad in ("pallas", "gpu"):
        with pytest.raises(ValueError, match="backend must be"):
            run(prob, TauLeap(), 0, n_steps=10, backend=bad)
    trim = sampler_api.glauber.SigmoidTrim(a=torch.ones(()), b=torch.zeros(()))
    with pytest.raises(ValueError, match="does not support backend 'cuda'"):
        run(prob, TauLeap(trim=trim), 0, n_steps=4, backend="cuda")
    with pytest.raises(NotImplementedError, match="trims"):
        run(prob, TauLeap(trim=trim, backend="cuda"), 0, n_steps=4)
    assert run(prob, TauLeap(trim=trim), 0, n_steps=4, backend="auto").s.shape == (8,)
    # the port's lattice and sparse problems run; the JAX package's are
    # another type, converted through the port's from_numpy constructors
    assert run(problems.cal_problem(coupling=0.5, device=CPU), TauLeap(), 0,
               n_steps=4).s.shape == (16, 16)
    assert run(problems.random_3regular_maxcut(8, 0, device=CPU), TauLeap(), 0,
               n_steps=4).s.shape == (8,)
    for jax_problem in (jproblems.cal_problem(coupling=0.5),
                        jproblems.random_3regular_maxcut(8, seed=0)):
        with pytest.raises(TypeError, match="unknown problem type"):
            run(jax_problem, TauLeap(), 0, n_steps=4)
    with pytest.raises(TypeError, match="FaultModel"):
        run(prob, TauLeap(), 0, n_steps=4, faults=object())
    diag = run(prob, TauLeap(), 0, n_steps=4, diagnostics=True).diagnostics
    assert isinstance(diag, sampler_api.RunDiagnostics) and int(diag.n_steps) == 4
    faulted = run(prob, TauLeap(), 0, n_steps=4, diagnostics=True,
                  faults=FaultModel(dropout=1.0)).diagnostics
    assert int(faulted.flips.sum()) == 0  # every update dropped: nothing flips
    with pytest.raises(TypeError, match="seed"):
        run(prob, TauLeap(), jax.random.key(0), n_steps=4)
    with pytest.raises(ValueError, match="n_chains"):
        run(prob, TauLeap(), 0, n_steps=4, n_chains=0)
    J = np.zeros((4, 4))
    J[0, 1] = J[1, 0] = np.nan
    with pytest.raises(sampler_api.NonFiniteEnergyError, match="non-finite"):
        run(ising.DenseIsing.from_numpy(J, np.zeros(4), device=CPU), TauLeap(), 0, n_steps=2)
    assert sampler_api._resolve_backend("cuda") == "cuda"
    assert sampler_api._resolve_backend("auto", TauLeap(), prob) == "ref"


# ---------------------------------------------------------------------------
# Kept runs: a later call of the same key takes the run an earlier call kept
# ---------------------------------------------------------------------------

# (problem maker, kernel, the problem's coupling field): each sweep or step
# through its kernel's plain version (the cuda backend on CPU tensors), so
# the int8 codes and the lattice and colour plans are part of the kept run
KEPT = {
    "tau_leap": (lambda: _dense_problem(12), TauLeap(dt=0.2, backend="cuda"), "J"),
    "chromatic_gibbs": (lambda: problems.cal_problem(coupling=0.5, device=CPU),
                        sampler_api.ChromaticGibbs(backend="cuda"), "w"),
    "colored_gibbs": (lambda: problems.random_3regular_maxcut(16, 1, device=CPU),
                      sampler_api.ColoredGibbs(backend="cuda"), "nbr_w"),
}
KEPT_CHAINS, KEPT_STEPS = 3, 40


@pytest.fixture
def kept():
    """An empty store of kept runs, emptied again after the test."""
    sampler_api.drop_kept_runs()
    yield sampler_api._kept
    sampler_api.drop_kept_runs()


def _reuses(fn):
    """(fn(), the calls that took a kept run while it ran)."""
    before = tracing.counts()["sampler.reuses"]
    out = fn()
    return out, tracing.counts()["sampler.reuses"] - before


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):  # diagnostics
            _assert_same(x, y)
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def _calls(prob, variant, seed):
    """run()'s keywords of one call of `variant`: every call of a variant
    has the same key, and seeds that differ give other inputs."""
    g = torch.Generator().manual_seed(seed)
    shape = (KEPT_CHAINS,) + sampler_api.state_shape(prob)
    e_mid = float(prob.energy(torch.ones(sampler_api.state_shape(prob))))
    if variant == "samples_hit_diagnostics":
        return dict(n_steps=KEPT_STEPS, n_chains=KEPT_CHAINS, sample_every=4, diagnostics=True,
                    first_hit=-abs(e_mid) * (0.2 + 0.1 * seed),
                    schedule=0.2 + 2.0 * torch.rand((KEPT_CHAINS, KEPT_STEPS), generator=g))
    assert variant == "s0_no_hit"
    return dict(n_steps=KEPT_STEPS, n_chains=KEPT_CHAINS, sample_every=0,
                schedule=geometric(0.3, 1.0 + seed),
                s0=torch.where(torch.rand(shape, generator=g) < 0.5, 1.0, -1.0))


@pytest.mark.parametrize("variant", ["samples_hit_diagnostics", "s0_no_hit"])
@pytest.mark.parametrize("name", sorted(KEPT))
def test_a_repeated_call_takes_the_kept_run_and_equals_a_new_one(name, variant, kept):
    make, kernel, _ = KEPT[name]
    prob = make()
    first, n_first = _reuses(lambda: run(prob, kernel, 1, **_calls(prob, variant, 1)))
    assert n_first == 0 and len(kept) == 1
    _assert_same(first, sampler_api._make_run(prob, kernel, 1, **_calls(prob, variant, 1))())
    for seed in (2, 3):  # a new int seed, betas, target and s0 each call
        got, n = _reuses(lambda: run(prob, kernel, seed, **_calls(prob, variant, seed)))
        assert n == 1 and len(kept) == 1
        _assert_same(got, sampler_api._make_run(prob, kernel, seed, **_calls(prob, variant, seed))())
    # a caller's generator: a key of its own, its state copied in and back
    g = torch.Generator().manual_seed(9)
    _, n = _reuses(lambda: run(prob, kernel, g, **_calls(prob, variant, 4)))
    assert n == 0 and len(kept) == 2
    state = g.get_state()
    got, n = _reuses(lambda: run(prob, kernel, g, **_calls(prob, variant, 5)))
    assert n == 1
    twin = torch.Generator()
    twin.set_state(state)
    _assert_same(got, sampler_api._make_run(prob, kernel, twin, **_calls(prob, variant, 5))())
    assert torch.equal(g.get_state(), twin.get_state())  # the stream left where a new run leaves it
    # timeit on a kept run: both passes as the new run's second
    timed = run(prob, kernel, 6, timeit=True, **_calls(prob, variant, 6))
    _assert_same(timed._replace(timing=None),
                 sampler_api._make_run(prob, kernel, 6, **_calls(prob, variant, 6))())


# each changes one thing of the call a run was kept for
MISSES = ("n_chains", "n_steps", "sample_every", "first_hit", "kernel", "faults", "s0_dtype")


@pytest.mark.parametrize("change", MISSES)
@pytest.mark.parametrize("name", sorted(KEPT))
def test_a_call_of_another_key_misses_and_is_still_right(name, change, kept):
    make, kernel, _ = KEPT[name]
    prob = make()
    base = dict(n_steps=KEPT_STEPS, n_chains=KEPT_CHAINS, sample_every=5,
                schedule=geometric(0.3, 2.0))
    run(prob, kernel, 1, **base)
    kw = dict(base)
    if change == "n_chains":
        kw["n_chains"] = KEPT_CHAINS + 1
    elif change == "n_steps":
        kw["n_steps"] = KEPT_STEPS + 1
    elif change == "sample_every":
        kw["sample_every"] = 4
    elif change == "first_hit":
        kw["first_hit"] = -1.0
    elif change == "kernel":
        kernel = dataclasses.replace(kernel, lambda0=2.0)
    elif change == "faults":
        kw["faults"] = FaultModel(dropout=0.2)
    elif change == "s0_dtype":
        run(prob, kernel, 1, s0=torch.ones((KEPT_CHAINS,) + sampler_api.state_shape(prob)), **base)
        kw["s0"] = torch.ones((KEPT_CHAINS,) + sampler_api.state_shape(prob), dtype=torch.float64)
    got, n = _reuses(lambda: run(prob, kernel, 1, **kw))
    assert n == 0
    _assert_same(got, sampler_api._make_run(prob, kernel, 1, **kw)())
    if change == "faults":  # the fault model is bound anew every call: nothing kept
        assert _reuses(lambda: run(prob, kernel, 1, **kw))[1] == 0


# each changes the generator or the problem, not the key's shape
RENEWALS = ("generator", "problem", "other_values", "edited")


@pytest.mark.parametrize("change", RENEWALS)
@pytest.mark.parametrize("name", sorted(KEPT))
def test_a_call_of_the_same_shape_takes_the_kept_run_and_is_still_right(name, change, kept):
    """Another caller's generator takes the kept run of every kernel. So do
    another problem object of the same shapes, with equal or other values,
    and an edit in place, where the run's carry holds no host value
    (tau-leap's int8 codes), but not where it holds a plan (the cuda
    sweeps). Either way the result equals a new run's, the caller's
    generator ends where a new run leaves it, and no caller's tensor is
    written."""
    make, kernel, field = KEPT[name]
    first = make()
    kw = dict(n_steps=KEPT_STEPS, n_chains=KEPT_CHAINS, sample_every=5,
              schedule=geometric(0.3, 2.0))
    run(first, kernel, torch.Generator().manual_seed(4), **kw)
    prob = first
    if change in ("problem", "other_values"):
        prob = make()
    if change in ("other_values", "edited"):
        getattr(prob, field).mul_(0.5)
    values = [(x, x.clone()) for p in {id(first): first, id(prob): prob}.values()
              for _, x in sampler_api._tensors(p)]
    seed, twin = torch.Generator().manual_seed(5), torch.Generator()
    twin.set_state(seed.get_state())
    before = tracing.counts()
    got = run(prob, kernel, seed, **kw)
    after = tracing.counts()
    takes = change == "generator" or name == "tau_leap"
    assert after["sampler.reuses"] - before["sampler.reuses"] == takes
    assert after["sampler.renewals"] - before["sampler.renewals"] == (takes and change != "generator")
    _assert_same(got, sampler_api._make_run(prob, kernel, twin, **kw)())
    assert torch.equal(seed.get_state(), twin.get_state())
    assert all(torch.equal(x, v) for x, v in values)
    if change == "edited":  # an edit to a non-finite value is probed again
        getattr(prob, field).view(-1)[1] = float("nan")
        n_kept = len(kept)
        with pytest.raises(sampler_api.NonFiniteEnergyError):
            run(prob, kernel, torch.Generator().manual_seed(6), **kw)
        assert len(kept) == n_kept  # a refused problem leaves the kept run kept


def _cd_chain(batch, cfg, steps, keep):
    """`steps` CD steps from a fixed start, each with a new generator, as a
    training loop that seeds each step does (with `keep` False, every step
    from a new run): the states, each with copies of its problem's
    tensors as they were made, and the generators."""
    from repro_torch.core import boltzmann

    state = boltzmann.init_cd(torch.Generator().manual_seed(2), 16, 16, cfg, device=CPU)
    states, gens = [], []
    for step in range(steps + 1):
        states.append((state, [x.clone() for _, x in sampler_api._tensors(state.problem)]))
        if step == steps:
            return states, gens
        if not keep:
            sampler_api.drop_kept_runs()
        gens.append(torch.Generator().manual_seed(100 + step))
        state = boltzmann.cd_step(state, batch, gens[-1], cfg)


def test_cd_steps_renew_one_kept_run_and_equal_new_runs(kept):
    from repro_torch.core import boltzmann
    from repro_torch.data import digits

    cfg = boltzmann.CDConfig(lr=0.08, n_model_steps=24, n_chains=8, quantize_bits=8)
    batch = digits.digit_batch(3, n=16, generator=torch.Generator().manual_seed(1),
                               flip_prob=0.05, device=CPU)
    before = tracing.counts()
    states, gens = _cd_chain(batch, cfg, 5, keep=True)
    after = tracing.counts()
    assert after["sampler.reuses"] - before["sampler.reuses"] == 4
    assert after["sampler.renewals"] - before["sampler.renewals"] == 4
    new_states, new_gens = _cd_chain(batch, cfg, 5, keep=False)
    for (state, made), (new, _) in zip(states, new_states):
        assert torch.equal(state.chains, new.chains)
        for (_, x), y, (_, z) in zip(sampler_api._tensors(state.problem), made,
                                     sampler_api._tensors(new.problem)):
            assert torch.equal(x, y) and torch.equal(x, z)  # unchanged since made, as new runs'
    for g, h in zip(gens, new_gens):
        assert torch.equal(g.get_state(), h.get_state())


def test_the_store_keeps_the_most_recently_used_runs_up_to_its_bound(kept):
    _, kernel, _ = KEPT["tau_leap"]
    # one size each: runs of one shape would share one key
    probs = [_dense_problem(6 + i) for i in range(sampler_api.KEPT_RUNS + 3)]
    kw = dict(n_steps=8, n_chains=2)
    for i, prob in enumerate(probs):
        run(prob, kernel, i, **kw)
        assert len(kept) == min(i + 1, sampler_api.KEPT_RUNS)
        if i == sampler_api.KEPT_RUNS - 1:  # the first, used again when full, outlives the rest
            assert _reuses(lambda: run(probs[0], kernel, 0, **kw))[1] == 1
    sizes = {one_run.problem.n for one_run in kept.values()}
    assert sizes == {p.n for p in [probs[0]] + probs[-(sampler_api.KEPT_RUNS - 1):]}
    assert _reuses(lambda: run(probs[1], kernel, 0, **kw))[1] == 0  # evicted: a new run


def test_a_call_that_raises_leaves_no_run_behind(kept, monkeypatch):
    make, kernel, field = KEPT["tau_leap"]
    prob = make()
    kw = dict(n_steps=8, n_chains=2)
    run(prob, kernel, 0, **kw)
    assert len(kept) == 1

    def fail(*args, **kwargs):
        raise RuntimeError("a step failed")

    with monkeypatch.context() as m:
        m.setattr(TauLeap, "update", fail)
        with pytest.raises(RuntimeError, match="a step failed"):
            run(prob, kernel, 1, **kw)  # took the kept run, and does not put it back
    assert len(kept) == 0
    got, n = _reuses(lambda: run(prob, kernel, 1, **kw))
    assert n == 0 and len(kept) == 1
    _assert_same(got, sampler_api._make_run(prob, kernel, 1, **kw)())
    bad = make()
    getattr(bad, field)[0, 1] = float("inf")
    with pytest.raises(sampler_api.NonFiniteEnergyError):
        run(bad, kernel, 0, **kw)
    assert len(kept) == 1


def test_drop_kept_runs_empties_the_store(kept):
    make, kernel, _ = KEPT["tau_leap"]
    prob = make()
    for n_steps in (4, 8):
        run(prob, kernel, 0, n_steps=n_steps)
    assert len(kept) == 2
    sampler_api.drop_kept_runs()
    assert len(kept) == 0
    assert _reuses(lambda: run(prob, kernel, 0, n_steps=4))[1] == 0
