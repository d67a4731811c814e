"""The port's device-fault model (`repro_torch.core.faults`) and its
threading through `run(..., faults=...)`, against the JAX package.

Counterparts of tests/test_faults.py for the port's five kernels on both
backends (the cuda backend runs each kernel's plain version on CPU
tensors): faults=None equals a model whose faults have no effect, bit for
bit; stuck sites never flip; lattice stuck sites become clamps; dropout=1
freezes the state (the CTMC's model time still advances); noise changes the
dynamics; the quantize grid; validation and `describe`.

Against JAX, exactly: `quantize_couplings` and `bind` bit for bit; each
kernel's fault variant in its plain version, row by row, equal to the JAX
`ops` function (Pallas in interpret mode) called with that row's b + eta
and `colors & keep`, except where a uniform lies within P_BAND of its
probability (the frameworks' sigmoid and exp may round the last ulp
apart); and one faulted step of each kernel, fed the draws the JAX step
takes from its key, equal in s (h, e) to the JAX step, t within 1 ulp."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.core import glauber as jglauber
from repro.core import ising as jising
from repro.core import problems as jproblems
from repro.core import sampler_api as jsa
from repro.core.sparse import SparseIsing as JSparseIsing
from repro.kernels import ops as jops
from repro_torch.core import event_tree, sampler_api
from repro_torch.core.faults import FaultModel, make_stuck, natural_shape, quantize_couplings
from repro_torch.core.ising import DenseIsing, LatticeIsing
from repro_torch.core.sampler_api import (CTMC, CTMCAux, ChromaticGibbs, ColoredGibbs,
                                          KernelState, LocalFields, NonFiniteEnergyError,
                                          RandomScanGibbs, TauLeap, run)
from repro_torch.core.sparse import SparseIsing
from repro_torch.kernels import lattice_gibbs, ops, ref, sparse_gather, tau_leap

torch.set_num_threads(1)

CPU = "cpu"
P_BAND = 1e-6  # a uniform this close to its probability may decide either way
# the middle of benchmarks/robustness.py's grid, with a stronger noise
FULL = dict(field_noise_std=0.4, dropout=0.15)


# -- problems, both packages ------------------------------------------------


def _jdense(n=10, seed=0):
    rng = np.random.default_rng(seed)
    J = rng.normal(0, 1.0 / np.sqrt(n), (n, n))
    J = (J + J.T) / 2
    np.fill_diagonal(J, 0)
    b = rng.normal(0, 0.3, n)
    return jising.DenseIsing(J=jnp.asarray(J, jnp.float32), b=jnp.asarray(b, jnp.float32))


def _jgrid_dense(n=10, seed=0):
    """A dense problem on the int8 grid (codes / 127, max |code| 127): the
    cuda backend's quantization is lossless."""
    rng = np.random.default_rng(seed)
    codes = np.triu(rng.integers(-126, 127, (n, n)), 1)
    codes = codes + codes.T
    codes[0, 1] = codes[1, 0] = 127
    return jising.DenseIsing(J=jnp.asarray(codes / 127.0, jnp.float32),
                             b=jnp.asarray(rng.normal(0, 0.3, n), jnp.float32))


def _jsparse(n=12, seed=1):
    return jproblems.random_3regular_maxcut(n, seed=seed)


def _jlattice(size=6):
    return jproblems.get_problem("ferromagnet", size, 0).problem


JAX_PROBLEMS = {"dense": _jdense, "sparse": _jsparse, "lattice": _jlattice}


def _port(jprob):
    """The port's problem with the JAX problem's arrays, on the CPU."""
    a = lambda x: np.asarray(x)  # noqa: E731
    if isinstance(jprob, jising.LatticeIsing):
        return LatticeIsing.from_numpy(a(jprob.w), a(jprob.b), a(jprob.clamp_mask),
                                       a(jprob.clamp_value), a(jprob.dead_mask), device=CPU)
    if isinstance(jprob, JSparseIsing):
        return SparseIsing.from_numpy(a(jprob.nbr_idx), a(jprob.nbr_w), a(jprob.deg),
                                      a(jprob.b), a(jprob.color_masks), device=CPU)
    return DenseIsing.from_numpy(a(jprob.J), a(jprob.b), device=CPU)


def _problem(kind):
    return _port(JAX_PROBLEMS[kind]())


def _no_stuck(problem):
    """An all-False stuck pair: the faulted code path with zero effect."""
    shape = natural_shape(problem)
    return FaultModel(stuck_mask=torch.zeros(shape, dtype=torch.bool),
                      stuck_values=torch.ones(shape))


def _stuck(problem, fraction=0.3, seed=5):
    mask, values = make_stuck(torch.Generator().manual_seed(seed), problem, fraction)
    return FaultModel(stuck_mask=mask, stuck_values=values), mask, values


def _jax_faults(jprob, fraction=0.2, seed=5, **config):
    mask, values = jfaults.make_stuck(jax.random.key(seed), jprob, fraction)
    return jfaults.FaultModel(stuck_mask=mask, stuck_values=values, **config)


def _port_faults(jf):
    """The port's FaultModel of a JAX one (its numpy stuck arrays)."""
    config = dict(quantize_bits=jf.quantize_bits, field_noise_std=jf.field_noise_std,
                  dropout=jf.dropout)
    if jf.stuck_mask is None:
        return FaultModel(**config)
    return FaultModel.from_numpy(np.asarray(jf.stuck_mask), np.asarray(jf.stuck_values),
                                 device=CPU, **config)


# Every kernel/backend pairing the driver supports, with a tiny problem each.
KERNEL_CASES = [
    ("dense", "random_scan_gibbs", None),
    ("dense", "tau_leap", "ref"),
    ("dense", "tau_leap", "cuda"),
    ("dense", "ctmc_scan", None),
    ("dense", "ctmc_tree", None),
    ("sparse", "ctmc_tree", None),
    ("sparse", "colored_gibbs", "ref"),
    ("sparse", "colored_gibbs", "cuda"),
    ("lattice", "chromatic_gibbs", "ref"),
    ("lattice", "chromatic_gibbs", "cuda"),
    ("lattice", "tau_leap", "ref"),
]


def _case(problem_kind, kernel_name):
    problem = _problem(problem_kind)
    kernel = {
        "ctmc_scan": lambda: CTMC(site_draw="scan"),
        "ctmc_tree": lambda: CTMC(site_draw="tree"),
    }.get(kernel_name, lambda: kernel_name)()
    return problem, kernel


FIELDS = ("s", "t", "samples", "times", "energies", "t_hit", "hit")


def _assert_same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x, y), f


# ---------------------------------------------------------------------------
# The fault-free program when nothing has an effect
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("problem_kind,kernel_name,backend", KERNEL_CASES)
def test_faults_none_bit_identical_to_zero_fault_path(problem_kind, kernel_name, backend):
    """faults=None equals the faulted code path with an all-False stuck mask
    bit for bit (neither draws extra numbers), and FaultModel() (residual
    None after bind) runs the fault-free program itself."""
    problem, kernel = _case(problem_kind, kernel_name)
    kw = dict(n_steps=12, sample_every=3, backend=backend, first_hit=-1e9)
    off = run(problem, kernel, 7, **kw)
    _assert_same(off, run(problem, kernel, 7, faults=_no_stuck(problem), **kw))
    _assert_same(off, run(problem, kernel, 7, faults=FaultModel(), **kw))


@pytest.mark.parametrize("kernel", ["ctmc", TauLeap(backend="cuda"), "random_scan_gibbs"],
                         ids=["ctmc", "tau_leap_cuda", "random_scan"])
def test_faults_none_bit_identical_multi_chain(kernel):
    """The guarantee holds with the chains as rows of every step."""
    problem = _problem("dense")
    kw = dict(n_steps=10, n_chains=3, sample_every=2)
    off = run(problem, kernel, 3, **kw)
    on = run(problem, kernel, 3, faults=_no_stuck(problem), **kw)
    _assert_same(off, on)


def test_ctmc_unroll_bit_identity_survives_faults():
    """`unroll` changes nothing, with the full fault stack on."""
    problem = _problem("dense")
    f, _, _ = _stuck(problem, 0.2)
    faults = dataclasses.replace(f, quantize_bits=5, field_noise_std=0.3, dropout=0.1)
    kw = dict(n_steps=12, sample_every=3, faults=faults)
    r1 = run(problem, CTMC(site_draw="tree"), 2, unroll=1, **kw)
    r4 = run(problem, CTMC(site_draw="tree"), 2, unroll=4, **kw)
    _assert_same(r1, r4)


@pytest.mark.parametrize("problem_kind,kernel_name", [
    ("dense", "tau_leap"), ("lattice", "chromatic_gibbs"), ("sparse", "colored_gibbs"),
])
def test_backend_bit_parity_under_faults(problem_kind, kernel_name):
    """ref and cuda (its plain versions here) agree bit for bit with faults
    on: both draw the same numbers and take the same decisions (the u warp
    of the cuda tau-leap is exact, since a flip needs u < p <= 1). The
    dense problem sits on the int8 grid, so the cuda backend's
    quantization is lossless."""
    problem = _port(_jgrid_dense()) if problem_kind == "dense" else _problem(problem_kind)
    f, _, _ = _stuck(problem, 0.2)
    faults = dataclasses.replace(f, field_noise_std=0.4, dropout=0.15)
    kw = dict(n_steps=10, sample_every=2, faults=faults, n_chains=4)
    r_ref = run(problem, kernel_name, 9, backend="ref", **kw)
    r_cuda = run(problem, kernel_name, 9, backend="cuda", **kw)
    assert torch.equal(r_ref.s, r_cuda.s)
    assert torch.equal(r_ref.samples, r_cuda.samples)


# ---------------------------------------------------------------------------
# Stuck spins never flip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("problem_kind,kernel_name,backend", KERNEL_CASES)
def test_stuck_sites_never_flip(problem_kind, kernel_name, backend):
    problem, kernel = _case(problem_kind, kernel_name)
    faults, mask, values = _stuck(problem, 0.35, seed=1)
    faults = dataclasses.replace(faults, field_noise_std=0.3, dropout=0.1)
    res = run(problem, kernel, 1, n_steps=20, sample_every=4, backend=backend, faults=faults,
              n_chains=3)
    assert mask.any() and not mask.all()
    assert torch.equal(res.s[:, mask], values[mask].expand(3, -1))
    assert torch.equal(res.samples[:, :, mask], values[mask].expand(3, 5, -1))


def test_stuck_sites_never_flip_multi_chain():
    problem = _problem("sparse")
    faults, mask, values = _stuck(problem, 0.3)
    res = run(problem, CTMC(site_draw="tree"), 4, n_steps=15, n_chains=3, sample_every=5,
              faults=faults)
    for chain in res.samples.reshape(-1, problem.n):
        assert torch.equal(chain[mask], values[mask])


def test_lattice_bind_absorbs_stuck_into_clamps():
    """On LatticeIsing the stuck mask folds into the clamps: the residual is
    None, the bound problem equals the JAX package's bind bit for bit."""
    jlat = _jlattice()
    jf = _jax_faults(jlat, 0.25)
    jbound, jres = jf.bind(jlat)
    bound, residual = _port_faults(jf).bind(_port(jlat))
    assert residual is None and jres is None
    for f in ("w", "b", "clamp_mask", "clamp_value", "dead_mask"):
        np.testing.assert_array_equal(getattr(bound, f).numpy(), np.asarray(getattr(jbound, f)))
    mask = np.asarray(jf.stuck_mask)
    assert mask.any()
    np.testing.assert_array_equal(bound.clamp_value.numpy()[mask],
                                  np.asarray(jf.stuck_values)[mask])


# ---------------------------------------------------------------------------
# Dropout and field noise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel,backend", [
    ("random_scan_gibbs", None), ("tau_leap", "ref"), ("tau_leap", "cuda"),
    ("chromatic_gibbs", "ref"), ("chromatic_gibbs", "cuda"), ("colored_gibbs", "ref"),
    ("colored_gibbs", "cuda"),
])
def test_dropout_one_freezes_the_state(kernel, backend):
    kind = {"chromatic_gibbs": "lattice", "colored_gibbs": "sparse"}.get(kernel, "dense")
    problem = _problem(kind)
    s0 = sampler_api.random_init(torch.Generator().manual_seed(8),
                                 (2,) + sampler_api.state_shape(problem), device=CPU)
    res = run(problem, kernel, 0, n_steps=15, s0=s0, n_chains=2, backend=backend,
              faults=FaultModel(dropout=1.0))
    assert torch.equal(res.s, s0)


@pytest.mark.parametrize("kind,draw", [("dense", "scan"), ("dense", "tree"), ("sparse", "tree")])
def test_ctmc_dropout_advances_model_time_without_flips(kind, draw):
    """A dropped CTMC event is a lost pulse, not a paused clock."""
    problem = _problem(kind)
    s0 = sampler_api.random_init(torch.Generator().manual_seed(8), (problem.n,), device=CPU)
    res = run(problem, CTMC(site_draw=draw), 0, n_steps=20, s0=s0,
              faults=FaultModel(dropout=1.0))
    assert torch.equal(res.s, s0)
    assert float(res.t) > 0.0


@pytest.mark.parametrize("kernel_name,problem_kind", [
    ("random_scan_gibbs", "dense"), ("ctmc_tree", "sparse"),
    ("colored_gibbs", "sparse"), ("chromatic_gibbs", "lattice"), ("tau_leap", "dense"),
])
def test_field_noise_changes_the_dynamics(kernel_name, problem_kind):
    """Noise must reach the decisions (a silently ignored fault would pass
    every other test here)."""
    problem, kernel = _case(problem_kind, kernel_name)
    kw = dict(n_steps=20, sample_every=2)
    clean = run(problem, kernel, 6, **kw)
    noisy = run(problem, kernel, 6, faults=FaultModel(field_noise_std=3.0), **kw)
    assert not torch.equal(clean.samples, noisy.samples)
    assert bool(torch.isfinite(noisy.energies).all())


# ---------------------------------------------------------------------------
# Coupling quantization
# ---------------------------------------------------------------------------


def test_quantize_dense_grid_symmetry_and_zeros():
    problem = _port(_jdense(n=8, seed=3))
    q = quantize_couplings(problem, 4)
    J = q.J.numpy()
    np.testing.assert_array_equal(J, J.T)
    assert np.all(np.diag(J) == 0.0)
    scale = float(problem.J.abs().max())
    codes = J / (scale / 7)
    np.testing.assert_allclose(codes, np.round(codes), atol=1e-4)
    assert float(np.max(np.abs(J))) == pytest.approx(scale, rel=1e-6)
    assert torch.equal(q.b, problem.b)  # biases untouched


def test_quantize_sparse_keeps_edge_copies_identical():
    sp = _problem("sparse")
    q = quantize_couplings(sp, 3)
    Jq = q.to_dense().J.numpy()
    np.testing.assert_array_equal(Jq, Jq.T)
    pad = np.arange(sp.max_deg)[None, :] >= sp.deg.numpy()[:, None]
    assert np.all(q.nbr_w.numpy()[pad] == 0.0)


def test_quantize_lattice_and_high_bits_near_identity():
    lat = _problem("lattice")
    assert quantize_couplings(lat, 6).w.shape == lat.w.shape
    dense = _port(_jdense(n=8, seed=4))
    np.testing.assert_allclose(quantize_couplings(dense, 24).J.numpy(), dense.J.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["dense", "sparse", "lattice"])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_quantize_couplings_equals_jax_bit_for_bit(kind, bits):
    """round(x / scale * qmax) * (scale / qmax) in f32, rounded half to
    even: the JAX package's grid, bit for bit (random couplings, so the
    grid is not trivial)."""
    rng = np.random.default_rng(bits)
    jprob = JAX_PROBLEMS[kind]()
    if kind == "lattice":
        w = rng.normal(0, 0.7, np.asarray(jprob.w).shape).astype(np.float32)
        jprob = dataclasses.replace(jprob, w=jnp.asarray(w))
    elif kind == "sparse":
        live = np.arange(jprob.max_deg)[None, :] < np.asarray(jprob.deg)[:, None]
        w = np.where(live, rng.normal(0, 0.7, live.shape), 0).astype(np.float32)
        jprob = dataclasses.replace(jprob, nbr_w=jnp.asarray(w))
    field = {"dense": "J", "sparse": "nbr_w", "lattice": "w"}[kind]
    got = getattr(quantize_couplings(_port(jprob), bits), field).numpy()
    want = np.asarray(getattr(jfaults.quantize_couplings(jprob, bits), field))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_quantize_bits_validation():
    problem = _problem("dense")
    for bad in (1, 0, -3, True, "8", 4.0):
        with pytest.raises(ValueError, match="quantize_bits"):
            quantize_couplings(problem, bad)
    with pytest.raises(TypeError, match="quantize"):
        quantize_couplings(object(), 4)


def test_bind_quantize_only_leaves_no_residual():
    problem = _problem("dense")
    bound, residual = FaultModel(quantize_bits=4).bind(problem)
    assert residual is None
    assert not torch.equal(bound.J, problem.J)
    f, _, _ = _stuck(problem, 0.3)
    _, residual2 = dataclasses.replace(f, quantize_bits=4).bind(problem)
    assert residual2 is not None and residual2.quantize_bits is None
    assert residual2.stuck_mask is not None


# ---------------------------------------------------------------------------
# Validation, make_stuck, describe, the non-finite guards
# ---------------------------------------------------------------------------


def test_fault_model_validate_rejects_nonsense():
    problem = _port(_jdense(n=6))
    shape = (problem.n,)
    ok_mask = torch.zeros(shape, dtype=torch.bool)
    ok_mask[0] = True
    ok_vals = torch.ones(shape)
    cases = [
        dict(stuck_mask=ok_mask),
        dict(stuck_values=ok_vals),
        dict(stuck_mask=torch.zeros(3, dtype=torch.bool), stuck_values=torch.ones(3)),
        dict(stuck_mask=torch.zeros(shape), stuck_values=ok_vals),
        dict(stuck_mask=ok_mask, stuck_values=0.5 * ok_vals),
        dict(dropout=1.5),
        dict(dropout=-0.1),
        dict(field_noise_std=-1.0),
        dict(field_noise_std=float("nan")),
        dict(quantize_bits=1),
    ]
    for kw in cases:
        with pytest.raises(ValueError):
            FaultModel(**kw).validate(problem)
    with pytest.raises(ValueError, match="dropout"):
        run(problem, "ctmc", 0, n_steps=2, faults=FaultModel(dropout=2.0))


def test_make_stuck_fraction_limits_and_validation():
    problem = _port(_jdense(n=20))
    gen = torch.Generator().manual_seed(0)
    mask0, _ = make_stuck(gen, problem, 0.0)
    assert not mask0.any()
    mask1, vals1 = make_stuck(gen, problem, 1.0)
    assert mask1.all() and bool(((vals1 == 1.0) | (vals1 == -1.0)).all())
    with pytest.raises(ValueError, match="fraction"):
        make_stuck(gen, problem, 1.5)
    lat_mask, _ = make_stuck(gen, _problem("lattice"), 0.5)
    assert lat_mask.shape == (6, 6) and lat_mask.dtype == torch.bool


def test_describe_is_json_ready_and_equals_jax():
    problem = _port(_jdense(n=6))
    f, mask, _ = _stuck(problem, 0.5)
    d = dataclasses.replace(f, quantize_bits=4, field_noise_std=0.1, dropout=0.2).describe()
    assert d["stuck_sites"] == int(mask.sum())
    assert d["quantize_bits"] == 4
    json.dumps(d)
    assert FaultModel().describe() == {}
    jf = _jax_faults(_jdense(n=6), 0.5, quantize_bits=4, field_noise_std=0.1, dropout=0.2)
    assert _port_faults(jf).describe() == jf.describe()


def test_run_raises_non_finite_energy_error_after_bind():
    """The run() entry probe reads the bound problem: NaN couplings fail
    loudly with or without a fault model."""
    J = np.zeros((6, 6), np.float32)
    J[0, 1] = J[1, 0] = np.inf
    problem = DenseIsing.from_numpy(J, np.zeros(6), device=CPU)
    for faults in (None, FaultModel(dropout=0.1)):
        with pytest.raises(NonFiniteEnergyError, match="non-finite"):
            run(problem, "random_scan_gibbs", 0, n_steps=2, faults=faults)


# ---------------------------------------------------------------------------
# The fault variants' plain versions against the JAX ops, row by row
# ---------------------------------------------------------------------------


def _phase_band(fields, s, u, upd, beta):
    """Sites where some phase drew a uniform within P_BAND of its p_up;
    upd[c] is phase c's (B, ...) update mask."""
    band = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
    b = beta.reshape((-1,) + (1,) * (s.ndim - 1))
    for c in range(u.shape[0]):
        p = torch.sigmoid(-2.0 * (b * fields(s)))
        band |= upd[c] & ((u[c] - p).abs() <= P_BAND)
        s = torch.where(upd[c], torch.where(u[c] < p, 1.0, -1.0), s)
    return band


def _variant_inputs(rng, shape, C):
    B = shape[0]
    s = rng.choice([-1.0, 1.0], shape).astype(np.float32)
    u = rng.random((C,) + shape).astype(np.float32)
    eta = (0.4 * rng.normal(size=shape)).astype(np.float32)
    keep = rng.random(shape) >= 0.2
    beta = rng.uniform(0.3, 3.0, B).astype(np.float32)
    return s, u, eta, keep, beta


def test_tau_leap_variant_plain_version_equals_jax_kernel_per_row():
    """ops.tau_leap_step(bias_rows=b + eta) == the JAX kernel (interpret)
    called per row with b = beta_r (b + eta_r) and scale = beta_r scale."""
    B, N = 5, 96
    rng = np.random.default_rng(3)
    s, u, eta, _, beta = _variant_inputs(rng, (B, N), 1)
    u = u[0]
    J = rng.integers(-127, 128, (N, N)).astype(np.int8)
    b = rng.normal(0, 0.2, N).astype(np.float32)
    scale, dt = np.float32(0.0123), np.float32(0.4)
    ts, tJ, tb, tu, teta, tbeta = (torch.as_tensor(x) for x in (s, J, b, u, eta, beta))
    rows = tb + teta
    got = ops.tau_leap_step(ts, tJ, tb, torch.tensor(scale), tu, float(dt), beta=tbeta,
                            bias_rows=rows).numpy()
    p = ref.tau_leap_flip_prob_ref(ts, tJ, tbeta[:, None] * rows,
                                   (tbeta * torch.tensor(scale))[:, None],
                                   torch.tensor(dt)).numpy()
    for r in range(B):
        jb = jnp.asarray(beta[r]) * (jnp.asarray(b) + jnp.asarray(eta[r]))
        want = np.asarray(jops.tau_leap_step(
            jnp.asarray(s[r:r + 1]), jnp.asarray(J), jb, jnp.asarray(beta[r]) * jnp.asarray(scale),
            jnp.asarray(u[r:r + 1]), jnp.asarray(dt), mode="kernel", block_b=8, block_n=32,
            block_k=32))[0]
        assert not np.any((got[r] != want) & (np.abs(u[r] - p[r]) > P_BAND)), r
    # the (N,) bias is the base signature; a (B,N) bias of equal rows is the same
    same = ops.tau_leap_step(ts, tJ, tb, torch.tensor(scale), tu, float(dt), beta=tbeta,
                             bias_rows=tb.expand(B, N).contiguous())
    base = ops.tau_leap_step(ts, tJ, tb, torch.tensor(scale), tu, float(dt), beta=tbeta)
    assert torch.equal(same, base)


def test_lattice_variant_plain_version_equals_jax_kernel_per_row():
    """ops.lattice_gibbs_sweep(bias_rows=, keep=) == the JAX Pallas sweep
    (interpret) per row with b + eta_r and colors & keep_r; kept sites keep
    their spin."""
    B, H, W = 4, 8, 6
    rng = np.random.default_rng(5)
    s, u, eta, keep, beta = _variant_inputs(rng, (B, H, W), 4)
    w = rng.normal(0, 0.5, (8, H, W)).astype(np.float32)
    b = rng.normal(0, 0.3, (H, W)).astype(np.float32)
    frozen = rng.random((H, W)) < 0.2
    clampv = rng.choice([-1.0, 1.0], (H, W)).astype(np.float32)
    colors = np.asarray(jising.king_color_masks(H, W))
    ts, tu, teta, tkeep, tbeta, tw, tb = (torch.as_tensor(x) for x in (s, u, eta, keep, beta, w, b))
    tcol, tfz, tcl = (torch.tensor(x) for x in (colors, frozen, clampv))
    rows = tb + teta
    got = ops.lattice_gibbs_sweep(ts, tw, tb, tu, tcol.float(), tfz.float(), tcl, tbeta,
                                  bias_rows=rows, keep=tkeep)
    upd = tcol[:, None] & ~tfz & tkeep
    band = _phase_band(lambda x: ref.lattice_fields_ref(x, tw, rows), ts, tu, upd, tbeta).numpy()
    got = got.numpy()
    for r in range(B):
        want = np.asarray(jops.lattice_gibbs_sweep(
            jnp.asarray(s[r:r + 1]), jnp.asarray(w), jnp.asarray(b) + jnp.asarray(eta[r]),
            jnp.asarray(u[:, r:r + 1]), (jnp.asarray(colors) & jnp.asarray(keep[r])).astype(
                jnp.float32), jnp.asarray(frozen, jnp.float32), jnp.asarray(clampv),
            beta=jnp.float32(beta[r]), mode="kernel"))[0]
        assert not np.any((got[r] != want) & ~band[r]), r
    kept = ~keep & ~frozen
    np.testing.assert_array_equal(got[kept], s[kept])
    assert np.all(got[:, frozen] == clampv[frozen])


def test_colored_variant_plain_version_equals_jax_kernel_per_row():
    """ops.colored_gibbs_sweep(bias_rows=, keep=) == the JAX Pallas sweep
    (interpret) per row with b + eta_r and masks & keep_r (unit couplings:
    the slot sums are exact in both)."""
    jsp = jproblems.random_3regular_maxcut(40, seed=2)
    sp = _port(jsp)
    B, n = 4, sp.n
    rng = np.random.default_rng(6)
    C = sp.n_colors
    s, u, eta, keep, beta = _variant_inputs(rng, (B, n), C)
    b = rng.normal(0, 0.3, n).astype(np.float32)
    ts, tu, teta, tkeep, tbeta, tb = (torch.as_tensor(x) for x in (s, u, eta, keep, beta, b))
    masks = sp.color_masks
    rows = tb + teta
    got = ops.colored_gibbs_sweep(ts, sp.nbr_idx, sp.nbr_w, tb, tu, masks.float(), tbeta,
                                  bias_rows=rows, keep=tkeep).numpy()
    for r in range(B):
        want = np.asarray(jops.colored_gibbs_sweep(
            jnp.asarray(s[r:r + 1]), jsp.nbr_idx, jsp.nbr_w, jnp.asarray(b) + jnp.asarray(eta[r]),
            jnp.asarray(u[:, r:r + 1]),
            (jnp.asarray(jsp.color_masks) & jnp.asarray(keep[r])).astype(jnp.float32),
            beta=jnp.float32(beta[r]), mode="kernel"))[0]
        np.testing.assert_array_equal(got[r], want, err_msg=str(r))
    np.testing.assert_array_equal(got[~keep], s[~keep])


# ---------------------------------------------------------------------------
# The wrappers route a fault variant by its operands (no card: recorded)
# ---------------------------------------------------------------------------


def test_wrappers_route_the_fault_variants_and_count_them_apart(monkeypatch, launched):
    calls = []
    for mod in (tau_leap, lattice_gibbs, sparse_gather):
        monkeypatch.setattr(mod, "check_cuda", lambda t: t.device)
    monkeypatch.setattr(tau_leap, "_launch", lambda s, s8, j, b, *a: calls.append(("tau", b.ndim)))
    monkeypatch.setattr(lattice_gibbs, "_launch_plan",
                        lambda *a: calls.append(("plan", len(a) == 7)))
    monkeypatch.setattr(sparse_gather, "_launch_sweep",
                        lambda *a: calls.append(("colored", len(a) == 8)))
    B, N = 3, 8
    s = torch.ones(B, N)
    J = torch.zeros(N, N, dtype=torch.int8)
    args = (J, torch.zeros(N), torch.tensor(1.0), torch.rand(B, N), torch.tensor(0.1), torch.ones(B))
    tau_leap.tau_leap_step(s, *args)
    tau_leap.tau_leap_step(s, J, torch.zeros(B, N), *args[2:])
    with pytest.raises(ValueError, match="b must have shape"):
        tau_leap.tau_leap_step(s, J, torch.zeros(B + 1, N), *args[2:])
    assert (launched()["tau_leap_step"], launched()["tau_leap_step_faults"]) == (1, 1)

    H, W = 4, 4
    w, b = torch.zeros(8, H, W), torch.zeros(H, W)
    colors = sampler_api.king_color_masks(H, W, device=CPU).float()
    fz, cl = torch.zeros(H, W), torch.ones(H, W)
    u = torch.rand(4, B, H, W)
    sl = torch.ones(B, H, W)
    lattice_gibbs.lattice_gibbs_sweep(sl, w, b, u, colors, fz, cl, torch.ones(B))
    lattice_gibbs.lattice_gibbs_sweep(sl, w, b, u, colors, fz, cl, torch.ones(B),
                                      keep=torch.ones(B, H, W, dtype=torch.bool))
    lattice_gibbs.lattice_gibbs_sweep(sl, w, b, u, colors, fz, cl, torch.ones(B),
                                      bias_rows=torch.zeros(B, H, W))
    with pytest.raises(ValueError, match="keep must be bool or uint8"):
        lattice_gibbs.lattice_gibbs_sweep(sl, w, b, u, colors, fz, cl, torch.ones(B),
                                          keep=torch.ones(B, H, W))
    with pytest.raises(ValueError, match="float32"):
        bf = torch.bfloat16
        lattice_gibbs.lattice_gibbs_sweep(sl.to(bf), w.to(bf), b.to(bf), u.to(bf), colors.to(bf),
                                          fz.to(bf), cl.to(bf), torch.ones(B),
                                          bias_rows=torch.zeros(B, H, W))
    assert launched()["lattice_gibbs_sweep"] == 1
    assert launched()["lattice_gibbs_sweep_faults"] == 2

    sp = _problem("sparse")
    us = torch.rand(sp.n_colors, B, sp.n)
    ss = torch.ones(B, sp.n)
    masks = sp.color_masks.float()
    sparse_gather.colored_gibbs_sweep(ss, sp.nbr_idx, sp.nbr_w, sp.b, us, masks, torch.ones(B))
    sparse_gather.colored_gibbs_sweep(ss, sp.nbr_idx, sp.nbr_w, sp.b, us, masks, torch.ones(B),
                                      bias_rows=torch.zeros(B, sp.n),
                                      keep=torch.ones(B, sp.n, dtype=torch.uint8))
    with pytest.raises(ValueError, match="bias_rows must have shape"):
        sparse_gather.colored_gibbs_sweep(ss, sp.nbr_idx, sp.nbr_w, sp.b, us, masks,
                                          torch.ones(B), bias_rows=torch.zeros(sp.n))
    assert launched()["colored_gibbs_sweep"] == 1
    assert launched()["colored_gibbs_sweep_faults"] == 1
    assert calls == [("tau", 1), ("tau", 2), ("plan", False), ("plan", True), ("plan", True),
                     ("colored", False), ("colored", True)]


# ---------------------------------------------------------------------------
# One faulted step of each kernel, fed the JAX step's draws
# ---------------------------------------------------------------------------


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _rows(xs, dtype=None):
    return torch.tensor(np.stack([np.asarray(x) for x in xs]), dtype=dtype)


def _bound_pair(jprob, **config):
    """(JAX bound problem, its residual, port bound problem, its residual)
    under stuck sites and `config`; the two bound problems equal."""
    jf = _jax_faults(jprob, **config)
    jb, jres = jf.bind(jprob)
    pb, pres = _port_faults(jf).bind(_port(jprob))
    return jb, jres, pb, pres


def _jax_states(jk, jb, jres, B, seed):
    rng = np.random.default_rng(seed)
    states = []
    for _ in range(B):
        s0 = jnp.asarray(rng.choice([-1.0, 1.0], jsa.state_shape(jb)).astype(np.float32))
        st = jk.init(jb, None, s0, jres) if jres is not None else jk.init(jb, None, s0)
        states.append(st._replace(t=jnp.float32(rng.uniform(1.0, 5.0))))
    return states, jax.random.split(jax.random.key(seed), B)


def _fault_keys(key, jres):
    """The JAX sweep and tau-leap step's split: (key, eta, keep)."""
    if jres is None or not (jres.noisy or jres.drops):
        return key, None, None
    key, k_noise, k_drop = jax.random.split(key, 3)
    return key, k_noise, k_drop


def _assert_rows(got, want, fields=("s",)):
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), _rows([getattr(w, f) for w in want]))
    np.testing.assert_array_max_ulp(got.t.numpy(), _rows([w.t for w in want]).numpy(), maxulp=1)


BETAS = np.array([1.0, 0.5, 2.0, 3.0, 0.7], np.float32)


@pytest.mark.parametrize("kind,backend", [("dense", "ref"), ("dense", "cuda"), ("sparse", "ref"),
                                          ("lattice", "ref")])
def test_tau_leap_faulted_step_equals_jax_step(kind, backend):
    jb, jres, pb, pres = _bound_pair(JAX_PROBLEMS[kind](), quantize_bits=6, **FULL)
    jk = jsa.TauLeap(dt=0.3, backend="pallas" if backend == "cuda" else "ref")
    B = len(BETAS)
    states, keys = _jax_states(jk, jb, jres, B, seed=1)
    want, us, etas, keeps = [], [], [], []
    for st, key, beta in zip(states, keys, BETAS):
        want.append(jk.step(jb, st, key, jnp.float32(beta), jres))
        key, k_noise, k_drop = _fault_keys(key, jres)
        etas.append(jres.field_noise(k_noise, st.s.shape))
        keeps.append(jres.keep_mask(k_drop, st.s.shape))
        us.append(jax.random.uniform(key, st.s.shape))
    kernel = TauLeap(dt=0.3, backend=backend)
    s0 = _rows([st.s for st in states])
    state = kernel.init(pb, torch.Generator(), s0, B, faults=pres)._replace(
        t=_rows([st.t for st in states]))
    assert torch.equal(state.s, s0)  # the JAX states already hold the stuck values
    got = kernel.update(pb, state, torch.tensor(BETAS), _rows(us), _rows(etas),
                        _rows(keeps), stuck=pres.stuck_flat() if pres is not None else None)
    _assert_rows(got, want)
    assert not torch.equal(got.s, state.s)  # some chain flipped


@pytest.mark.parametrize("kernel_cls,kind,backend", [
    (ChromaticGibbs, "lattice", "ref"), (ChromaticGibbs, "lattice", "cuda"),
    (ColoredGibbs, "sparse", "ref"), (ColoredGibbs, "sparse", "cuda"),
])
def test_sweep_faulted_step_equals_jax_step(kernel_cls, kind, backend):
    """The lattice problem with random couplings (so the fields are not all
    integers), its stuck sites bound into the clamps; the sparse one with
    stuck sites out of the colour classes."""
    jprob = JAX_PROBLEMS[kind]()
    if kind == "lattice":
        rng = np.random.default_rng(0)
        jprob = dataclasses.replace(jprob, w=jnp.asarray(
            rng.normal(0, 0.6, np.asarray(jprob.w).shape), jnp.float32))
    jb, jres, pb, pres = _bound_pair(jprob, **FULL)
    jk = {"lattice": jsa.ChromaticGibbs, "sparse": jsa.ColoredGibbs}[kind](
        backend="pallas" if backend == "cuda" else "ref")
    C = 4 if kind == "lattice" else jb.color_masks.shape[0]
    B = len(BETAS)
    states, keys = _jax_states(jk, jb, jres, B, seed=2)
    want, us, etas, keeps = [], [], [], []
    for st, key, beta in zip(states, keys, BETAS):
        want.append(jk.step(jb, st, key, jnp.float32(beta), jres))
        key, k_noise, k_drop = _fault_keys(key, jres)
        etas.append(jres.field_noise(k_noise, st.s.shape))
        keeps.append(jres.keep_mask(k_drop, st.s.shape))
        cks = jax.random.split(key, C)
        us.append(jnp.stack([jax.random.uniform(cks[c], st.s.shape) for c in range(C)]))
    kernel = kernel_cls(backend=backend)
    state = kernel.init(pb, torch.Generator(), _rows([st.s for st in states]), B,
                        faults=pres)._replace(t=_rows([st.t for st in states]))
    u = _rows(us).transpose(0, 1).contiguous()  # (C, B, ...)
    got = kernel.update(pb, state, torch.tensor(BETAS), u, _rows(etas), _rows(keeps))
    _assert_rows(got, want)
    assert not torch.equal(got.s, state.s)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_random_scan_faulted_step_equals_jax_step(kind):
    jb, jres, pb, pres = _bound_pair(JAX_PROBLEMS[kind](), quantize_bits=5, **FULL)
    jk = jsa.RandomScanGibbs()
    B = len(BETAS)
    states, keys = _jax_states(jk, jb, jres, B, seed=3)
    want, sites, us, etas, keeps = [], [], [], [], []
    for st, key, beta in zip(states, keys, BETAS):
        want.append(jk.step(jb, st, key, jnp.float32(beta), jres))
        k_site, k_flip = jax.random.split(key)
        k_flip, k_noise, k_drop = jax.random.split(k_flip, 3)
        sites.append(int(jax.random.randint(k_site, (), 0, jb.n)))
        us.append(float(jax.random.uniform(k_flip)))
        etas.append(float(jres.field_noise(k_noise, ())))
        keeps.append(bool(jax.random.uniform(k_drop) >= jres.dropout))
    nbr = pb.nbr_idx.long() if kind == "sparse" else None
    state = KernelState(s=_rows([st.s for st in states]), t=_rows([st.t for st in states]),
                        e=_rows([st.e for st in states]),
                        aux=LocalFields(_rows([st.aux for st in states]), nbr))
    got = RandomScanGibbs().update(pb, state, torch.tensor(BETAS), torch.tensor(sites),
                                   torch.tensor(us, dtype=torch.float32),
                                   torch.tensor(etas, dtype=torch.float32), torch.tensor(keeps),
                                   stuck=pres.stuck_flat())
    _assert_rows(got, want, ("s", "e"))
    np.testing.assert_array_equal(got.aux.h.numpy(), _rows([w.aux for w in want]).numpy())


@pytest.mark.parametrize("kind,draw", [("dense", "scan"), ("dense", "tree"), ("sparse", "scan"),
                                       ("sparse", "tree"), ("sparse", "tree_carried")])
def test_ctmc_faulted_step_equals_jax_step(kind, draw):
    """One event from the JAX state under stuck sites, noise and dropout
    (the carried sparse tree without noise: a noisy run never carries it,
    and every beta 1, where the JAX step reuses the tree its init built)."""
    carried = draw == "tree_carried"
    config = dict(dropout=0.3) if carried else FULL
    jb, jres, pb, pres = _bound_pair(JAX_PROBLEMS[kind](), quantize_bits=5, **config)
    jk = jsa.CTMC(site_draw="tree" if carried else draw)
    B = len(BETAS)
    betas = np.ones(B, np.float32) if carried else BETAS
    states, keys = _jax_states(jk, jb, jres, B, seed=4)
    stuck = pres.stuck_flat()
    want, sites, expos, etas, keeps = [], [], [], [], []
    for st, key, beta in zip(states, keys, betas):
        want.append(jk.step(jb, st, key, jnp.float32(beta), jres))
        # passlint: ignore[PASS001] the test replays the step's own draws from its key
        rest, k_noise, k_drop = jax.random.split(key, 3)
        k_dt, k_site = jax.random.split(rest)
        h = st.aux if draw == "scan" else st.aux[0]
        eta = jres.field_noise(k_noise, h.shape) if jres.noisy else jnp.zeros_like(h)
        etas.append(eta)
        expos.append(float(jax.random.exponential(k_dt)))
        keeps.append(bool(jax.random.uniform(k_drop, ()) >= jres.dropout))
        if draw == "scan":
            rates = jk.lambda0 * jglauber.flip_prob(jnp.float32(beta) * (h + eta), st.s)
            rates = jnp.where(jnp.asarray(jres.stuck_mask), 0.0, rates)
            sites.append(int(jax.random.categorical(k_site, jnp.log(rates))))
        else:
            sites.append(float(jax.random.uniform(k_site)))
    s, t, e = (_rows([getattr(st, f) for st in states]) for f in ("s", "t", "e"))
    nbr = pb.nbr_idx.long() if kind == "sparse" else None
    if draw == "scan":
        aux = CTMCAux(_rows([st.aux for st in states]), None, None, nbr)
    elif carried:
        aux = CTMCAux(*(_rows([st.aux[j] for st in states]) for j in range(3)), nbr)
    else:
        aux = CTMCAux(_rows([st.aux[0] for st in states]), _rows([st.aux[1] for st in states]),
                      None, nbr)
    site = torch.tensor(sites, dtype=torch.int64 if draw == "scan" else torch.float32)
    got = CTMC(site_draw=jk.site_draw).update(
        pb, KernelState(s=s, t=t, e=e, aux=aux), torch.tensor(betas), site,
        torch.tensor(expos, dtype=torch.float32), None if carried else _rows(etas),
        torch.tensor(keeps), stuck=stuck)
    _assert_rows(got, want, ("s", "e"))
    h_want = _rows([w.aux if draw == "scan" else w.aux[0] for w in want])
    np.testing.assert_array_equal(got.aux.h.numpy(), h_want.numpy())
    assert not all(keeps) and any(keeps)  # both a dropped and a kept event
    if carried:  # the repaired tree: a fresh build of the masked rates
        _assert_tree_is_build_of(got.aux.tree, CTMC().rates(pb, got.s, got.aux.h,
                                                            torch.tensor(betas), stuck), stuck)


def _assert_tree_is_build_of(tree, rates, stuck):
    """The tree is `event_tree.build` of its own leaves bit for bit, its
    leaves are `rates` within 1 ulp and exactly 0 at stuck sites. (On the
    CPU torch's sigmoid rounds the last ulp by tensor size — a few gathered
    entries take its scalar path, a whole row its vector path — so a leaf
    repaired from a gather and the same rate computed over the row may
    differ by 1 ulp; on the card the elementwise kernels agree.)"""
    n = rates.shape[1]
    leaves = event_tree.leaves(tree, n)
    np.testing.assert_array_equal(tree.numpy(), event_tree.build(leaves).numpy())
    np.testing.assert_array_max_ulp(leaves.numpy(), rates.numpy(), maxulp=1)
    assert not bool(leaves[:, stuck].any()) and not bool(rates[:, stuck].any())


def test_sparse_ctmc_carried_tree_under_stuck_stays_the_build_of_the_masked_rates():
    """After many events at a constant beta with stuck sites and dropout,
    the carried tree is a fresh build of the masked rates of the final s
    and h (`_assert_tree_is_build_of`); stuck sites never flipped."""
    from repro_torch.core import problems

    sp = problems.random_3regular_maxcut(128, 3, device=CPU)
    faults, mask, values = _stuck(sp, 0.25, seed=7)
    faults = dataclasses.replace(faults, dropout=0.2)
    make = sampler_api._make_run(sp, CTMC(site_draw="tree"), 2, n_steps=1500, n_chains=3,
                                 schedule=2.5, faults=faults)
    res = make()
    st = make.final_state
    assert st.aux.tree_beta is not None  # carried: stuck and dropout keep the tree
    assert torch.equal(res.s[:, mask], values[mask].expand(3, -1))
    np.testing.assert_array_equal(st.aux.h.numpy(), sp.local_fields(st.s).numpy())
    beta = torch.full((3,), 2.5)
    _assert_tree_is_build_of(st.aux.tree, CTMC().rates(sp, st.s, st.aux.h, beta, mask), mask)
    # field noise redraws every rate: the run rebuilds every event instead
    noisy = sampler_api._make_run(sp, CTMC(site_draw="tree"), 2, n_steps=50, n_chains=3,
                                  schedule=2.5, faults=dataclasses.replace(faults,
                                                                           field_noise_std=0.2))
    noisy()
    assert noisy.final_state.aux.tree_beta is None


def test_port_fault_model_from_jax_arrays():
    """FaultModel.from_numpy of JAX's stuck arrays validates against the
    port's problem and holds the same sites."""
    jprob = _jdense()
    jf = _jax_faults(jprob, 0.4, field_noise_std=0.2)
    pf = _port_faults(jf)
    pf.validate(_port(jprob))
    assert pf.stuck_mask.dtype == torch.bool and pf.noisy and not pf.drops
    np.testing.assert_array_equal(pf.stuck_mask.numpy(), np.asarray(jf.stuck_mask))
    s = torch.ones(3, jprob.n)
    np.testing.assert_array_equal(pf.apply_stuck(s).numpy()[0],
                                  np.asarray(jf.apply_stuck(jnp.ones(jprob.n))))


@pytest.mark.cuda
def test_fault_variants_match_their_plain_versions_on_the_card():
    """The two sweeps' fault variants on the card against their plain
    versions: spins equal outside the band, kept sites as they were
    (chip_smoke.py's check_faults_kernels holds all three at full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an sm_90 card); chip_smoke.py checks it there")
    dev = "cuda"
    rng = np.random.default_rng(9)
    B, H, W = 64, 16, 16
    s, u, eta, keep, beta = _variant_inputs(rng, (B, H, W), 4)
    w = rng.normal(0, 0.5, (8, H, W)).astype(np.float32)
    b = rng.normal(0, 0.3, (H, W)).astype(np.float32)
    ts, tu, teta, tkeep, tbeta, tw, tb = (torch.tensor(x, device=dev)
                                          for x in (s, u, eta, keep, beta, w, b))
    colors = sampler_api.king_color_masks(H, W, device=dev)
    fz = torch.zeros((H, W), dtype=torch.bool, device=dev)
    cl = torch.ones((H, W), device=dev)
    args = (ts, tw, tb, tu, colors.float(), fz.float(), cl, tbeta)
    kw = dict(bias_rows=tb + teta, keep=tkeep)
    got = ops.lattice_gibbs_sweep(*args, **kw)
    plain = ops.lattice_gibbs_sweep(*args, mode="reference", **kw)
    band = _phase_band(lambda x: ref.lattice_fields_ref(x, tw, tb + teta), ts, tu,
                       colors[:, None] & tkeep, tbeta)
    assert not bool(((got != plain) & ~band).any())
    assert torch.equal(got[~tkeep], ts[~tkeep])
