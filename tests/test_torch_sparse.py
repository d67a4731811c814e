"""The port's sparse slice against the JAX package: SparseIsing, greedy
colouring and the sparse generators (identical arrays), the sparse fields
and colored sweep's plain versions (against the JAX oracles and the Pallas
kernels in interpret mode), ColoredGibbs and sparse TauLeap through run(),
and the sparse dispatch.

Inputs are made with numpy from a seed and go through both packages. The
port sums a site's neighbour slots in order (as its CUDA kernels do); JAX's
`jnp.sum` reduces them in its own order, so fields are held to
FIELD_EPS * (sum_k |w_ik| + |b_i|), about one float32 eps of the terms'
magnitude, and exactly for unit weights. Spins are held equal except where
a phase's uniform lies within beta_r/2 of that bound (|dp_up/dh| <= beta/2)
plus P_BAND (the two sigmoids' last ulps) of its p_up."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import ising as jising
from repro.core import problems as jproblems
from repro.core import sparse as jsparse
from repro.kernels import ref as jref
from repro.kernels import sparse_gather as jsg
from repro_torch.core import ising, problems, sampler_api, sparse
from repro_torch.core.sampler_api import ColoredGibbs, TauLeap, run
from repro_torch.core.sparse import SparseIsing
from repro_torch.kernels import ops, ref, sparse_gather
from test_torch_sparse_long import _lattice

torch.set_num_threads(1)

CPU = "cpu"
P_BAND = 1e-6
FIELD_EPS = 2.0**-22
TV_MAX = 0.03  # the JAX bound, tests/test_core_samplers.py
FIELDS = ("nbr_idx", "nbr_w", "deg", "b", "color_masks")


def _f32(a):
    return jnp.asarray(np.asarray(a, np.float32), jnp.float32)


def _dense_numpy(n, seed, density, scale=0.6):
    rng = np.random.default_rng(seed)
    A = rng.normal(0, scale, (n, n)) * (rng.random((n, n)) < density)
    J = np.triu(A, 1)
    return (J + J.T).astype(np.float32), rng.normal(0, scale / 2, n).astype(np.float32)


def _both_dense(n, seed, density):
    J, b = _dense_numpy(n, seed, density)
    return (jsparse.SparseIsing.from_dense(jising.DenseIsing(J=_f32(J), b=_f32(b))),
            SparseIsing.from_dense(ising.DenseIsing.from_numpy(J, b, device=CPU)))


def _assert_same_layout(tp, jp):
    for f in FIELDS:
        a, b = getattr(tp, f), getattr(jp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
            assert a.numpy().dtype == np.asarray(b).dtype, f


def _phase_band(fields, s, u, masks, beta, tol):
    """Sites where some phase of the port's plain sweep drew a uniform within
    `tol` of its p_up: the only sites where two implementations may differ."""
    band = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
    for c in range(masks.shape[0]):
        p = torch.sigmoid(-2.0 * (beta[:, None] * fields(s)))
        band |= masks[c] & ((u[c] - p).abs() <= tol)
        s = torch.where(masks[c], torch.where(u[c] < p, 1.0, -1.0), s)
    return band


def _tv(samples, p_exact, n):
    bits = (samples.reshape(-1, n).numpy() > 0).astype(np.int64)
    hist = np.bincount(bits @ (1 << np.arange(n)), minlength=2**n)
    return 0.5 * float(np.abs(hist / hist.sum() - p_exact).sum())


# ---------------------------------------------------------------------------
# Layout, colouring and generators: identical arrays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,seed,density", [(14, 3, 0.4), (30, 1, 0.2), (9, 0, 1.0)])
def test_from_dense_and_from_edges_match_jax(n, seed, density):
    jp, tp = _both_dense(n, seed, density)
    _assert_same_layout(tp, jp)
    tp.validate()
    np.testing.assert_array_equal(tp.to_dense().J.numpy(), np.asarray(jp.to_dense().J))
    assert tp.n == jp.n and tp.max_deg == jp.max_deg and tp.n_colors == jp.n_colors
    edges = [(0, 1, 0.5), (1, 2, -1.25), (3, 4, 2.0), (0, 4, 0.75)]
    kw = dict(b=np.arange(6, dtype=np.float32) / 7, max_deg=4)
    _assert_same_layout(SparseIsing.from_edges(6, edges, device=CPU, **kw),
                        jsparse.SparseIsing.from_edges(6, edges, **kw))
    _assert_same_layout(SparseIsing.from_edges(6, edges, color=False, device=CPU),
                        jsparse.SparseIsing.from_edges(6, edges, color=False))


@pytest.mark.parametrize("n,seed", [(4, 0), (20, 1), (64, 2), (1000, 3)])
def test_random_3regular_maxcut_matches_jax(n, seed):
    tp, jp = problems.random_3regular_maxcut(n, seed, device=CPU), jproblems.random_3regular_maxcut(
        n, seed)
    _assert_same_layout(tp, jp)
    assert tp.max_deg == 3 and tp.n_colors <= 4
    tp.validate()


def test_color_graph_and_masks_match_jax():
    ring = [(i, (i + 1) % 8, 1.0) for i in range(8)]
    sp = SparseIsing.from_edges(8, ring, device=CPU)
    assert sp.n_colors == 2
    jp = jproblems.random_3regular_maxcut(50, 4)
    idx, deg = np.asarray(jp.nbr_idx), np.asarray(jp.deg)
    np.testing.assert_array_equal(sparse.color_graph(idx, deg), jsparse.color_graph(idx, deg))
    colors = np.random.default_rng(0).integers(0, 5, 40)
    np.testing.assert_array_equal(sparse.colors_to_masks(colors), jsparse.colors_to_masks(colors))
    with pytest.raises(ValueError, match="color_masks"):
        SparseIsing.from_edges(4, [(0, 1, 1.0)], color=False, device=CPU).n_colors


@pytest.mark.parametrize("kw", [dict(density=0.1), dict(density=0.2, weights="uniform"),
                                dict(density=0.6, sparse=True)])
def test_sparse_random_maxcut_matches_jax(kw):
    tp = problems.random_maxcut(24, 5, device=CPU, **kw)
    jp = jproblems.random_maxcut(24, 5, **kw)
    assert isinstance(tp, SparseIsing) and isinstance(jp, jsparse.SparseIsing)
    _assert_same_layout(tp, jp)


def test_validate_raises_on_the_jax_failure_modes():
    good = SparseIsing.from_edges(6, [(0, 1, 1.0), (1, 2, -0.5), (3, 4, 2.0)], device=CPU)
    good.validate()

    def with_(**kw):
        return dataclasses.replace(good, **kw)

    def set_(t, ij, v):
        t = t.clone()
        t[ij] = v
        return t

    cases = [
        (with_(b=torch.zeros(3)), "shapes"),
        (with_(nbr_idx=set_(good.nbr_idx, (0, 0), 99)), "out of range"),
        (with_(nbr_w=set_(good.nbr_w, (5, 0), 1.0)), "padded"),
        (with_(nbr_idx=set_(good.nbr_idx, (0, 0), 0)), "self-coupling"),
        (with_(nbr_w=set_(good.nbr_w, (0, 0), 3.0)), "symmetric"),
        (with_(nbr_w=set_(good.nbr_w, (0, 0), float("nan"))), "finite"),
        (with_(color_masks=torch.ones((1, 6), dtype=torch.bool)), "proper"),
        (with_(color_masks=torch.zeros((2, 6), dtype=torch.bool)), "exactly one color"),
    ]
    for bad, match in cases:
        with pytest.raises(ValueError, match=match):
            bad.validate()
    with pytest.raises(ValueError, match="self-loop"):
        SparseIsing.from_edges(4, [(2, 2, 1.0)], device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        SparseIsing.from_edges(4, [(0, 7, 1.0)], device=CPU)
    with pytest.raises(ValueError, match="max_deg"):
        SparseIsing.from_edges(4, [(0, 1, 1.0), (0, 2, 1.0)], max_deg=1, device=CPU)


def test_energy_fields_and_delta_fields_match_jax():
    jp, tp = _both_dense(16, 7, 0.4)
    s = np.random.default_rng(2).choice([-1.0, 1.0], (5, 16)).astype(np.float32)
    ts, js = torch.as_tensor(s), _f32(s)
    np.testing.assert_allclose(tp.energy(ts).numpy(), np.asarray(jp.energy(js)),
                               rtol=1e-6, atol=1e-5)
    bound = FIELD_EPS * (tp.nbr_w.abs().sum(-1) + tp.b.abs()).numpy()
    assert np.all(np.abs(tp.local_fields(ts).numpy() - np.asarray(jp.local_fields(js))) <= bound)
    h = tp.local_fields(ts[0])
    for i in (0, 5, 15):
        idx, dh = tp.delta_fields(ts[0], i)
        jidx, jdh = jp.delta_fields(js[0], jnp.asarray(i))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(dh.numpy(), np.asarray(jdh))
        flipped = ts[0].clone()
        flipped[i] = -flipped[i]
        np.testing.assert_allclose(h.index_add(-1, idx, dh).numpy(),
                                   tp.local_fields(flipped).numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The kernels' plain versions against the JAX oracles and Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,n,density", [(8, 48, 0.3), (2, 100, 0.4), (3, 130, 0.05),
                                         (4, 64, "3regular")])
def test_sparse_fields_ref_matches_jax(B, n, density):
    if density == "3regular":
        jp = jproblems.random_3regular_maxcut(n, 1)
        tp = problems.random_3regular_maxcut(n, 1, device=CPU)
    else:
        jp, tp = _both_dense(n, n, density)
    s = np.random.default_rng(B).choice([-1.0, 1.0], (B, n)).astype(np.float32)
    got = ref.sparse_fields_ref(torch.as_tensor(s), tp.nbr_idx, tp.nbr_w, tp.b).numpy()
    want = np.asarray(jref.sparse_fields_ref(_f32(s), jp.nbr_idx, jp.nbr_w, jp.b))
    pallas = np.asarray(jsg.sparse_fields(_f32(s), jp.nbr_idx, jp.nbr_w, jp.b,
                                          block_batch=B, interpret=True))
    if density == "3regular":  # unit weights: integer sums, exact in any order
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, pallas)
    bound = FIELD_EPS * (tp.nbr_w.abs().sum(-1) + tp.b.abs()).numpy()
    for other in (want, pallas):
        assert np.all(np.abs(got - other) <= bound), np.max(np.abs(got - other) / bound)
    np.testing.assert_array_equal(
        ops.sparse_fields(torch.as_tensor(s), tp.nbr_idx, tp.nbr_w, tp.b).numpy(), got)


def _sweep_case(n, seed, B):
    jp, tp = _both_dense(n, seed, 0.4)
    rng = np.random.default_rng(seed + 1)
    s = rng.choice([-1.0, 1.0], (B, n)).astype(np.float32)
    u = rng.random((tp.n_colors, B, n)).astype(np.float32)
    return jp, tp, s, u


@pytest.mark.parametrize("beta", [0.3, 1.0, 3.0])
def test_colored_sweep_ref_matches_jax_oracle_and_pallas(beta):
    B = 4
    jp, tp, s, u = _sweep_case(40, 11, B)
    tbeta = torch.full((B,), beta)
    ts, tu = torch.as_tensor(s), torch.as_tensor(u)
    got = ref.colored_gibbs_sweep_ref(ts, tp.nbr_idx, tp.nbr_w, tp.b, tu, tp.color_masks, tbeta)
    tol = tbeta[:, None] / 2 * FIELD_EPS * (tp.nbr_w.abs().sum(-1) + tp.b.abs()) + P_BAND
    band = _phase_band(lambda x: ref.sparse_fields_ref(x, tp.nbr_idx, tp.nbr_w, tp.b), ts, tu,
                       tp.color_masks, tbeta, tol).numpy()
    masks = jp.color_masks
    want = jref.colored_gibbs_sweep_ref(_f32(s), jp.nbr_idx, jp.nbr_w, jp.b, _f32(u), masks,
                                        jnp.float32(beta))
    pallas = jsg.colored_gibbs_sweep(_f32(s), jp.nbr_idx, jp.nbr_w, jp.b, _f32(u),
                                     masks.astype(jnp.float32), jnp.float32(beta),
                                     block_batch=2, interpret=True)
    for other in (want, pallas):
        differ = got.numpy() != np.asarray(other)
        assert not np.any(differ & ~band), np.argwhere(differ & ~band)[:5]
    via_ops = ops.colored_gibbs_sweep(ts, tp.nbr_idx, tp.nbr_w, tp.b, tu,
                                      tp.color_masks.float(), beta)
    np.testing.assert_array_equal(via_ops.numpy(), got.numpy())


def test_colored_sweep_per_row_beta_equals_one_jax_call_per_row():
    B = 5
    jp, tp, s, u = _sweep_case(30, 17, B)
    beta = np.random.default_rng(3).uniform(0.3, 3.0, B).astype(np.float32)
    tbeta = torch.as_tensor(beta)
    ts, tu = torch.as_tensor(s), torch.as_tensor(u)
    got = ref.colored_gibbs_sweep_ref(ts, tp.nbr_idx, tp.nbr_w, tp.b, tu, tp.color_masks,
                                      tbeta).numpy()
    tol = tbeta[:, None] / 2 * FIELD_EPS * (tp.nbr_w.abs().sum(-1) + tp.b.abs()) + P_BAND
    band = _phase_band(lambda x: ref.sparse_fields_ref(x, tp.nbr_idx, tp.nbr_w, tp.b), ts, tu,
                       tp.color_masks, tbeta, tol).numpy()
    for r in range(B):
        want = np.asarray(jref.colored_gibbs_sweep_ref(
            _f32(s[r:r + 1]), jp.nbr_idx, jp.nbr_w, jp.b, _f32(u[:, r:r + 1]), jp.color_masks,
            jnp.float32(beta[r])))[0]
        assert not np.any((got[r] != want) & ~band[r]), r


def test_improper_masks_read_the_state_before_each_phase():
    """Every field of a phase comes from the state before the phase, also
    for masks that are not a colouring (as in JAX)."""
    jp, tp, s, _ = _sweep_case(12, 5, 3)
    rng = np.random.default_rng(8)
    masks = rng.random((3, 12)) < 0.6
    u = rng.random((3, 3, 12)).astype(np.float32)
    tm, ts, tu = torch.as_tensor(masks), torch.as_tensor(s), torch.as_tensor(u)
    got = ref.colored_gibbs_sweep_ref(ts, tp.nbr_idx, tp.nbr_w, tp.b, tu, tm, torch.ones(3))
    tol = 0.5 * FIELD_EPS * (tp.nbr_w.abs().sum(-1) + tp.b.abs()) + P_BAND
    band = _phase_band(lambda x: ref.sparse_fields_ref(x, tp.nbr_idx, tp.nbr_w, tp.b), ts, tu,
                       tm, torch.ones(3), tol).numpy()
    want = np.asarray(jsg.colored_gibbs_sweep(_f32(s), jp.nbr_idx, jp.nbr_w, jp.b, _f32(u),
                                              _f32(masks), interpret=True, block_batch=3))
    assert not np.any((got.numpy() != want) & ~band)


def test_ops_modes_on_cpu_and_the_kernel_wrapper_checks(launched):
    _, tp, s, u = _sweep_case(10, 2, 2)
    ts, tu, masks = torch.as_tensor(s), torch.as_tensor(u), tp.color_masks.float()
    tables = (tp.nbr_idx, tp.nbr_w, tp.b)
    np.testing.assert_array_equal(ops.sparse_fields(ts, *tables).numpy(),
                                  ops.sparse_fields(ts, *tables, mode="reference").numpy())
    ops.colored_gibbs_sweep(ts, *tables, tu, masks)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.sparse_fields(ts, *tables, mode="kernel")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.colored_gibbs_sweep(ts, *tables, tu, masks, mode="kernel")
    with pytest.raises(ValueError, match="CUDA tensors"):
        sparse_gather.colored_gibbs_sweep(ts, *tables, tu, masks, torch.ones(2))
    with pytest.raises(ValueError, match="mode"):
        ops.sparse_fields(ts, *tables, mode="pallas")
    assert not launched()


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """The CUDA kernels against their plain versions on a ragged graph:
    fields bit for bit (the same slot order), spins equal outside the band."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an sm_90 card); chip_smoke.py checks it there")
    J, b = _dense_numpy(130, 4, 0.05)
    tp = SparseIsing.from_dense(ising.DenseIsing.from_numpy(J, b, device="cuda"))
    rng = np.random.default_rng(6)
    s = torch.as_tensor(rng.choice([-1.0, 1.0], (3, 130)).astype(np.float32), device="cuda")
    u = torch.as_tensor(rng.random((tp.n_colors, 3, 130)).astype(np.float32), device="cuda")
    tables = (tp.nbr_idx, tp.nbr_w, tp.b)
    assert torch.equal(ops.sparse_fields(s, *tables), ops.sparse_fields(s, *tables, mode="reference"))
    beta = torch.tensor([0.3, 1.0, 3.0], device="cuda")
    masks = tp.color_masks.float()
    got = ops.colored_gibbs_sweep(s, *tables, u, masks, beta)
    plain = ops.colored_gibbs_sweep(s, *tables, u, masks, beta, mode="reference")
    band = _phase_band(lambda x: ref.sparse_fields_ref(x, *tables), s, u, tp.color_masks, beta,
                       P_BAND)
    assert not bool(((got != plain) & ~band).any())


# ---------------------------------------------------------------------------
# The energy kernel's order of summation against the JAX energy
# ---------------------------------------------------------------------------

ENERGY_ROUTES = ("sparse_energy", "sparse_energy_long")
U = 2.0**-24  # float32 unit roundoff


def _energy_case(name, gaussian):
    """(torch, JAX) problems: the 3-regular MaxCut graph at n = 4096, each
    side built by its own package, or the periodic 6^3 +-J lattice; with
    Gaussian couplings on the live slots and a Gaussian bias when asked."""
    if name == "maxcut4096":
        tp = problems.random_3regular_maxcut(4096, 0, device=CPU)
        jp = jproblems.random_3regular_maxcut(4096, 0)
        _assert_same_layout(tp, jp)
    else:
        tp = _lattice(6)
    if gaussian or name != "maxcut4096":
        if gaussian:
            g = torch.Generator().manual_seed(17)
            live = tp.nbr_idx != torch.arange(tp.n, dtype=torch.int32)[:, None]
            w = (torch.randn(tp.nbr_w.shape, generator=g) * live).contiguous()
            tp = SparseIsing(tp.nbr_idx, w, tp.deg, 0.3 * torch.randn((tp.n,), generator=g))
        jp = jsparse.SparseIsing(*(jnp.asarray(x.numpy())
                                   for x in (tp.nbr_idx, tp.nbr_w, tp.deg, tp.b)))
    return tp, jp


def _energy_orders_band(tp, s):
    """The widest gap between two f32 energies whose fields are summed over
    the D slots and whose terms over the n sites, each in any order. With
    gamma_m = m u / (1 - m u): a field is within gamma_D a_i of exact, a_i =
    sum_k |w_ik s_j|; its product with s_i within gamma_{D+1} |s_i| a_i; the
    sum of n such terms (and of the n bias terms) within gamma_{n+D} of
    A = 0.5 sum_i |s_i| a_i + sum_i |b_i s_i|; the halving is exact and the
    last add rounds once more, within u (|E| + gamma_{n+D} A). Each of the
    two is so far from the exact E, so the band is twice that."""
    s64, w64, b64 = s.double(), tp.nbr_w.double(), tp.b.double()
    h, a = torch.zeros_like(s64), torch.zeros_like(s64)
    for k in range(tp.max_deg):
        sj = s64.index_select(-1, tp.nbr_idx[:, k])
        h, a = h + w64[:, k] * sj, a + (w64[:, k] * sj).abs()
    m = tp.n + tp.max_deg
    gamma = m * U / (1 - m * U)
    A = 0.5 * (s64.abs() * a).sum(-1) + (b64 * s64).abs().sum(-1)
    exact = 0.5 * (s64 * h).sum(-1) + (b64 * s64).sum(-1)
    return 2 * (gamma * A + U * (exact.abs() + gamma * A))


@pytest.mark.parametrize("lead", [(5,), (3, 4)])
@pytest.mark.parametrize("name", ["maxcut4096", "ea6"])
def test_the_energy_kernels_order_and_ops_equal_the_jax_energy_on_pm1_states(name, lead):
    """The energy kernel's two orders of summation
    (`sparse_gather.energy_in_kernel_order`, which the card holds the kernel
    to bit for bit) and `ops.sparse_energy` on the CPU give the JAX
    `SparseIsing.energy` exactly on +-1 states with +-1 couplings: every
    partial sum is then an integer below 2^24."""
    tp, jp = _energy_case(name, gaussian=False)
    s = np.random.default_rng(len(name) + len(lead)).choice([-1.0, 1.0], lead + (tp.n,))
    ts, want = torch.as_tensor(s.astype(np.float32)), np.asarray(jp.energy(_f32(s)))
    assert want.shape == lead
    tables = (tp.nbr_idx, tp.nbr_w, tp.b)
    for route in ENERGY_ROUTES:
        got = sparse_gather.energy_in_kernel_order(ts, *tables, route)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=route)
    np.testing.assert_array_equal(ops.sparse_energy(ts, *tables).numpy(), want)


@pytest.mark.parametrize("states", ["pm1", "gaussian"])
@pytest.mark.parametrize("name", ["maxcut4096", "ea6"])
def test_the_energy_kernels_order_and_ops_stay_within_the_band_of_jax(name, states):
    """On Gaussian couplings the JAX energy sums each field's slots and the
    sites in its own order: the two orders, and ops on the CPU, stay within
    the band of any two such orders, and the gaps are real."""
    tp, jp = _energy_case(name, gaussian=True)
    rng = np.random.default_rng(29)
    shape = (2, 3, tp.n)
    s = (rng.choice([-1.0, 1.0], shape) if states == "pm1" else rng.normal(0, 1, shape))
    ts = torch.as_tensor(s.astype(np.float32))
    want = torch.as_tensor(np.array(jp.energy(_f32(s)))).double()
    band = _energy_orders_band(tp, ts)
    tables = (tp.nbr_idx, tp.nbr_w, tp.b)
    gaps = [(got.double() - want).abs() for got in (
        *(sparse_gather.energy_in_kernel_order(ts, *tables, r) for r in ENERGY_ROUTES),
        ops.sparse_energy(ts, *tables))]
    for gap in gaps:
        assert bool((gap <= band).all()), (gap, band)
    assert any(bool((gap > 0).any()) for gap in gaps)


# ---------------------------------------------------------------------------
# The driver: ColoredGibbs and sparse TauLeap
# ---------------------------------------------------------------------------


def _small_graph():
    J, b = _dense_numpy(8, 0, 0.5)
    tp = SparseIsing.from_dense(ising.DenseIsing.from_numpy(J, b, device=CPU))
    _, p = ising.enumerate_boltzmann(tp.to_dense())
    return tp, p


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_colored_gibbs_samples_the_boltzmann_law(backend):
    tp, p_exact = _small_graph()
    res = run(tp, ColoredGibbs(), 0, n_steps=300, n_chains=512, sample_every=1,
              backend=backend)
    assert res.samples.shape == (512, 300, 8) and res.energies.shape == (512, 300)
    assert _tv(res.samples[:, 5:], p_exact, 8) < TV_MAX


def test_sparse_tau_leap_samples_the_boltzmann_law():
    tp, p_exact = _small_graph()
    # many short chains, one sample per unit of model time: TV 0.018-0.020
    # over seeds 1-3 (dt bias plus sampling noise)
    res = run(tp, TauLeap(dt=0.05), 1, n_steps=800, n_chains=4096, sample_every=20)
    assert _tv(res.samples[:, 5:], p_exact, 8) < TV_MAX


def test_cuda_backend_on_cpu_tensors_follows_the_ref_trajectory():
    mc = problems.random_3regular_maxcut(40, 3, device=CPU)
    kw = dict(n_steps=25, n_chains=5, schedule=sampler_api.linear(0.3, 2.0), sample_every=5,
              first_hit=-40.0)
    a = run(mc, ColoredGibbs(), 7, backend="ref", **kw)
    b = run(mc, ColoredGibbs(), 7, backend="cuda", **kw)
    for x, y in zip(a[:7], b[:7]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_sparse_dispatch_and_errors():
    tp, _ = _small_graph()
    assert sampler_api.problem_kind_of(tp) == "sparse" and sampler_api.state_shape(tp) == (8,)
    nomask = SparseIsing.from_edges(6, [(0, 1, 1.0), (2, 3, 1.0)], color=False, device=CPU)
    with pytest.raises(ValueError, match="color_masks"):
        run(nomask, ColoredGibbs(), 0, n_steps=2)
    with pytest.raises(ValueError, match="colored_gibbs"):
        run(problems.sk_instance(8, 0, device=CPU), "colored_gibbs", 0, n_steps=2)
    with pytest.raises(ValueError, match="does not support backend 'cuda'"):
        run(tp, TauLeap(), 0, n_steps=2, backend="cuda")
    with pytest.raises(NotImplementedError, match="dense problems only"):
        run(tp, TauLeap(backend="cuda"), 0, n_steps=2)
    assert sampler_api._resolve_backend("auto", ColoredGibbs(), tp) == "ref"
    with pytest.raises(TypeError, match="unknown problem type"):
        run(jproblems.random_3regular_maxcut(8, seed=0), ColoredGibbs(), 0, n_steps=2)
    res = run(tp, ColoredGibbs(), 0, n_steps=3, s0=torch.ones(8), sample_every=1)
    assert res.samples.shape == (3, 8) and float(res.t) == 3.0
