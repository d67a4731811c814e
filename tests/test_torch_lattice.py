"""The port's lattice slice against the JAX package: LatticeIsing and its
helpers, the CAL problem, the lattice sweep's plain version (against the
JAX oracle and the Pallas kernel in interpret mode), ChromaticGibbs and
lattice TauLeap through run(), and the lattice dispatch.

Inputs are made with numpy from a seed and go through both packages.
Fields are held bit for bit (the stencil adds the planes in the JAX
order). Spins are held equal except where a phase's uniform lies within
P_BAND of its p_up: torch's and XLA's sigmoids differ by up to 2 ulp."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import ising as jising
from repro.core import problems as jproblems
from repro.kernels import lattice_gibbs as jlg
from repro.kernels import ref as jref
from repro_torch.core import glauber, ising, problems, sampler_api
from repro_torch.core.sampler_api import ChromaticGibbs, TauLeap, run
from repro_torch.kernels import lattice_gibbs, ops, ref

torch.set_num_threads(1)

CPU = "cpu"
P_BAND = 1e-6
TV_MAX = 0.03  # the JAX bound, tests/test_core_samplers.py


def _f32(a):
    return jnp.asarray(np.asarray(a, np.float32), jnp.float32)


def _bf16(a):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


def _random_lattice(H, W, seed):
    """Numpy arrays of a lattice with random asymmetric weight planes (pure
    arithmetic for the kernels), random clamps and dead sites."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(0, 0.5, (8, H, W))).astype(np.float32)
    b = (rng.normal(0, 0.3, (H, W))).astype(np.float32)
    cm = rng.random((H, W)) < 0.2
    cv = rng.choice([-1.0, 1.0], (H, W)).astype(np.float32)
    dm = rng.random((H, W)) < 0.1
    return w, b, cm, cv, dm


def _both(w, b, cm, cv, dm):
    jp = jising.LatticeIsing(w=_f32(w), b=_f32(b), clamp_mask=jnp.asarray(cm),
                             clamp_value=_f32(cv), dead_mask=jnp.asarray(dm))
    return jp, ising.LatticeIsing.from_numpy(w, b, cm, cv, dm, device=CPU)


def _phase_band(fields, s, u, masks, frozen, beta, tol):
    """Sites where some phase of the port's plain sweep drew a uniform within
    `tol` of its p_up: the only sites where two implementations may differ."""
    band = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
    bb = beta.reshape((-1,) + (1,) * (s.ndim - 1))
    for c in range(masks.shape[0]):
        p = torch.sigmoid(-2.0 * (bb * fields(s)))
        upd = masks[c] & ~frozen
        band |= upd & ((u[c] - p).abs() <= tol)
        s = torch.where(upd, torch.where(u[c] < p, 1.0, -1.0).to(s.dtype), s)
    return band


def _tv(samples, p_exact, n):
    bits = (samples.reshape(-1, n).numpy() > 0).astype(np.int64)
    hist = np.bincount(bits @ (1 << np.arange(n)), minlength=2**n)
    return 0.5 * float(np.abs(hist / hist.sum() - p_exact).sum())


def _small_lattice(clamp=True, seed=3):
    """A 2x3 lattice with random symmetric couplings and, optionally, site
    (0, 0) clamped to +1, with its exact law (conditioned on the clamp)."""
    rng = np.random.default_rng(seed)
    pairs = {((y, x), (y + dy, x + dx)): float(rng.normal(0, 0.6))
             for y in range(2) for x in range(3) for dy, dx in ising.KING_OFFSETS[4:]
             if y + dy < 2 and 0 <= x + dx < 3}
    cm = np.zeros((2, 3), bool)
    cm[0, 0] = clamp
    lat = ising.lattice_from_pairs(2, 3, pairs, biases=rng.normal(0, 0.3, (2, 3)),
                                   clamp_mask=cm, clamp_value=np.ones((2, 3)), device=CPU)
    states, p = ising.enumerate_boltzmann(lat.to_dense())
    if clamp:
        p = np.where(states[:, 0] > 0, p, 0.0)
        p /= p.sum()
    return lat, p


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("H,W", [(1, 1), (5, 7), (16, 16)])
def test_fields_and_energy_match_jax(H, W):
    jp, tp = _both(*_random_lattice(H, W, seed=H * W))
    s = np.random.default_rng(1).choice([-1.0, 1.0], (6, H, W)).astype(np.float32)
    ts, js = torch.as_tensor(s), _f32(s)
    np.testing.assert_array_equal(tp.local_fields(ts).numpy(), np.asarray(jp.local_fields(js)))
    np.testing.assert_array_equal(tp.neighbor_sum(ts).numpy(), np.asarray(jp.neighbor_sum(js)))
    np.testing.assert_allclose(tp.energy(ts).numpy(), np.asarray(jp.energy(js)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        ref.lattice_fields_ref(ts, tp.w, tp.b).numpy(),
        np.asarray(jref.lattice_fields_ref(js, jp.w, jp.b)))
    np.testing.assert_array_equal(tp.frozen_mask.numpy(), np.asarray(jp.frozen_mask))
    np.testing.assert_array_equal(tp.frozen_values.numpy(), np.asarray(jp.frozen_values))
    np.testing.assert_array_equal(tp.apply_clamps(ts).numpy(), np.asarray(jp.apply_clamps(js)))
    for dy, dx in ising.KING_OFFSETS:
        np.testing.assert_array_equal(ising.shift2d(ts, dy, dx).numpy(),
                                      np.asarray(jising.shift2d(js, dy, dx)))
    assert tp.shape == (H, W) and tp.n == H * W and tp.device == torch.device(CPU)


@pytest.mark.parametrize("H,W", [(1, 1), (3, 5), (16, 16)])
def test_king_color_masks_match_jax(H, W):
    masks = ising.king_color_masks(H, W, device=CPU)
    assert masks.dtype == torch.bool and masks.shape == (ising.N_KING_COLORS, H, W)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jising.king_color_masks(H, W)))
    assert ising.KING_OFFSETS == jising.KING_OFFSETS
    assert ising.N_KING_COLORS == jising.N_KING_COLORS


def test_lattice_from_pairs_to_dense_and_quantize_match_jax():
    rng = np.random.default_rng(5)
    H, W = 4, 5
    pairs = {((y, x), (y + dy, x + dx)): float(rng.normal(0, 1))
             for y in range(H) for x in range(W) for dy, dx in ising.KING_OFFSETS[4:]
             if y + dy < H and 0 <= x + dx < W}
    kw = dict(biases=rng.normal(0, 0.5, (H, W)), clamp_mask=rng.random((H, W)) < 0.3,
              clamp_value=rng.choice([-1.0, 1.0], (H, W)), dead_mask=rng.random((H, W)) < 0.2)
    tp = ising.lattice_from_pairs(H, W, pairs, device=CPU, **kw)
    jp = jising.lattice_from_pairs(H, W, pairs, **kw)
    for f in ("w", "b", "clamp_mask", "clamp_value", "dead_mask"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)))
    np.testing.assert_array_equal(tp.to_dense().J.numpy(), np.asarray(jp.to_dense().J))
    np.testing.assert_array_equal(tp.to_dense().b.numpy(), np.asarray(jp.to_dense().b))
    # ties: entries half-way between grid points round half to even
    w = tp.w.clone()
    scale = float(torch.max(torch.abs(w)))
    w[0, 0, :4] = torch.tensor([0.5, 1.5, 2.5, -2.5]) * scale / 127
    tp = dataclasses.replace(tp, w=w)
    jp = dataclasses.replace(jp, w=_f32(w.numpy()))
    for bits in (8, 4):
        tq, jq = ising.quantize_lattice(tp, bits), jising.quantize_lattice(jp, bits)
        np.testing.assert_array_equal(tq.w.numpy(), np.asarray(jq.w))
        np.testing.assert_array_equal(tq.b.numpy(), np.asarray(jq.b))
    with pytest.raises(ValueError, match="king's move"):
        ising.lattice_from_pairs(3, 3, {((0, 0), (0, 2)): 1.0}, device=CPU)


@pytest.mark.parametrize("coupling", [1.0, 0.6])
def test_cal_template_and_problem_match_jax(coupling):
    np.testing.assert_array_equal(problems.cal_template(), jproblems.cal_template())
    tp, jp = problems.cal_problem(coupling, device=CPU), jproblems.cal_problem(coupling)
    for f in ("w", "b", "clamp_mask", "clamp_value", "dead_mask"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)))
    t = problems.cal_template()
    # the two frameworks sum the 256 sites' pair terms (about 2000 of size
    # 0.6, inexact in float32) in different orders
    assert float(tp.energy(torch.as_tensor(t))) == pytest.approx(float(jp.energy(_f32(t))),
                                                                 rel=1e-5)
    dense = tp.to_dense()
    np.testing.assert_array_equal(dense.J.numpy(), np.asarray(jp.to_dense().J))
    assert float(dense.energy(torch.as_tensor(t.reshape(-1)))) == pytest.approx(
        float(tp.energy(torch.as_tensor(t))), rel=1e-6)


# ---------------------------------------------------------------------------
# The sweep's plain version against the JAX oracle and the Pallas kernel
# ---------------------------------------------------------------------------


def _sweep_inputs(B, H, W, seed):
    rng = np.random.default_rng(seed)
    s = rng.choice([-1.0, 1.0], (B, H, W)).astype(np.float32)
    w = rng.normal(0, 0.5, (8, H, W)).astype(np.float32)  # asymmetric: pure arithmetic
    b = rng.normal(0, 0.3, (H, W)).astype(np.float32)
    u = rng.random((4, B, H, W)).astype(np.float32)
    frozen = rng.random((H, W)) < 0.2
    clampv = rng.choice([-1.0, 1.0], (H, W)).astype(np.float32)
    colors = np.array(jising.king_color_masks(H, W))
    return s, w, b, u, colors, frozen, clampv


@pytest.mark.parametrize("beta", [0.3, 1.0, 3.0])
@pytest.mark.parametrize("B,H,W", [(4, 16, 16), (8, 8, 8), (2, 32, 24), (16, 16, 16)])
def test_sweep_ref_matches_jax_oracle_and_pallas(B, H, W, beta):
    s, w, b, u, colors, frozen, clampv = _sweep_inputs(B, H, W, seed=B * H + W)
    t = [torch.as_tensor(x) for x in (s, w, b, u, colors, frozen, clampv)]
    ts, tw, tb, tu, tcolors, tfrozen, tclamp = t
    tbeta = torch.full((B,), beta, dtype=torch.float32)
    got = ref.lattice_gibbs_sweep_ref(ts, tw, tb, tu, tcolors, tfrozen, tclamp, tbeta)
    band = _phase_band(lambda x: ref.lattice_fields_ref(x, tw, tb), ts, tu, tcolors, tfrozen,
                       tbeta, P_BAND)
    jargs = [_f32(x) for x in (s, w, b, u)]
    want = jref.lattice_gibbs_sweep_ref(*jargs, jnp.asarray(colors), jnp.asarray(frozen),
                                        _f32(clampv), jnp.float32(beta))
    pallas = jlg.lattice_gibbs_sweep(*jargs, _f32(colors), _f32(frozen), _f32(clampv),
                                     jnp.float32(beta), interpret=True, block_batch=2)
    for other in (want, pallas):
        differ = got.numpy() != np.asarray(other)
        assert not np.any(differ & ~band.numpy()), np.argwhere(differ & ~band.numpy())[:5]
    assert np.all(got.numpy()[:, frozen] == clampv[frozen])
    # ops dispatches CPU tensors to the plain version, with f32 masks as JAX takes them
    via_ops = ops.lattice_gibbs_sweep(ts, tw, tb, tu, tcolors.float(), tfrozen.float(), tclamp,
                                      beta)
    np.testing.assert_array_equal(via_ops.numpy(), got.numpy())


def test_per_row_beta_equals_one_jax_call_per_row():
    B, H, W = 5, 8, 7
    s, w, b, u, colors, frozen, clampv = _sweep_inputs(B, H, W, seed=21)
    beta = np.random.default_rng(22).uniform(0.3, 3.0, B).astype(np.float32)
    t = [torch.as_tensor(x) for x in (s, w, b, u, colors, frozen, clampv, beta)]
    got = ref.lattice_gibbs_sweep_ref(*t).numpy()
    band = _phase_band(lambda x: ref.lattice_fields_ref(x, t[1], t[2]), t[0], t[3], t[4], t[5],
                       t[7], P_BAND).numpy()
    for r in range(B):
        want = np.asarray(jref.lattice_gibbs_sweep_ref(
            _f32(s[r:r + 1]), _f32(w), _f32(b), _f32(u[:, r:r + 1]), jnp.asarray(colors),
            jnp.asarray(frozen), _f32(clampv), jnp.float32(beta[r])))[0]
        assert not np.any((got[r] != want) & ~band[r]), r
    # beta=None and a scalar beta are beta = 1 and that value on every row
    ones = ref.lattice_gibbs_sweep_ref(*t[:7], torch.ones(B))
    np.testing.assert_array_equal(ref.lattice_gibbs_sweep_ref(*t[:7]).numpy(), ones.numpy())
    via_ops = ops.lattice_gibbs_sweep(*t[:4], t[4].float(), t[5].float(), t[6], 1.0)
    np.testing.assert_array_equal(via_ops.numpy(), ones.numpy())


# bf16: every add of the stencil rounds to bf16, as the JAX oracle's eager
# ops do, so fields are equal bit for bit and spins exactly (atol=0).


@pytest.mark.parametrize("beta", [0.3, 1.0, 3.0])
@pytest.mark.parametrize("B,H,W", [(4, 16, 16), (8, 8, 8), (2, 32, 24), (16, 16, 16)])
def test_bf16_sweep_and_fields_match_jax_oracle(B, H, W, beta):
    s, w, b, u, colors, frozen, clampv = _sweep_inputs(B, H, W, seed=B * H + W)
    ts, tw, tb, tu, tclamp = [torch.as_tensor(x).to(torch.bfloat16) for x in (s, w, b, u, clampv)]
    js, jw, jb, ju, jclamp = [_bf16(x) for x in (s, w, b, u, clampv)]
    h = ref.lattice_fields_ref(ts, tw, tb)
    assert h.dtype == torch.bfloat16
    np.testing.assert_array_equal(h.float().numpy(),
                                  np.asarray(jref.lattice_fields_ref(js, jw, jb), np.float32))
    got = ref.lattice_gibbs_sweep_ref(ts, tw, tb, tu, torch.as_tensor(colors),
                                      torch.as_tensor(frozen), tclamp, torch.full((B,), beta))
    assert got.dtype == torch.bfloat16
    want = jref.lattice_gibbs_sweep_ref(js, jw, jb, ju, jnp.asarray(colors), jnp.asarray(frozen),
                                        jclamp, jnp.float32(beta))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=0)
    via_ops = ops.lattice_gibbs_sweep(ts, tw, tb, tu, torch.as_tensor(colors).to(torch.bfloat16),
                                      torch.as_tensor(frozen).to(torch.bfloat16), tclamp, beta)
    np.testing.assert_array_equal(via_ops.float().numpy(), got.float().numpy())


@pytest.mark.parametrize("beta", [None, 0.3, 1.0, 3.0])
def test_bf16_sweep_matches_pallas_at_the_jax_grid(beta):
    """The inputs of the JAX package's dtype sweep (tests/test_kernels.py,
    bf16 at (4, 16, 16), key 5), at several beta: the plain version equals
    the Pallas kernel in interpret mode (atol=0). Under jit XLA keeps
    excess precision in bf16 by default, so at other inputs the Pallas
    kernel can differ from its own eager oracle; the port follows the
    oracle (test above)."""
    B, H, W = 4, 16, 16
    k = jax.random.split(jax.random.key(5), 5)
    s = (2 * jax.random.bernoulli(k[0], 0.5, (B, H, W)) - 1).astype(jnp.bfloat16)
    w = (jax.random.normal(k[1], (8, H, W)) * 0.5).astype(jnp.bfloat16)
    b = (jax.random.normal(k[2], (H, W)) * 0.3).astype(jnp.bfloat16)
    u = jax.random.uniform(k[3], (4, B, H, W)).astype(jnp.bfloat16)
    colors = jising.king_color_masks(H, W).astype(jnp.bfloat16)
    frozen = jnp.zeros((H, W), jnp.bfloat16)
    clampv = -jnp.ones((H, W), jnp.bfloat16)
    jbeta = None if beta is None else jnp.float32(beta)
    pallas = jlg.lattice_gibbs_sweep(s, w, b, u, colors, frozen, clampv, jbeta, interpret=True,
                                     block_batch=4)
    t = [torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16)
         for x in (s, w, b, u, colors, frozen, clampv)]
    tbeta = None if beta is None else torch.full((B,), beta)
    got = ref.lattice_gibbs_sweep_ref(*t[:4], t[4] > 0.5, t[5] > 0.5, t[6], tbeta)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(pallas, np.float32), atol=0)
    via_ops = ops.lattice_gibbs_sweep(*t, 1.0 if beta is None else beta)
    np.testing.assert_array_equal(via_ops.float().numpy(), got.float().numpy())


def test_bf16_per_row_beta_equals_one_jax_call_per_row():
    B, H, W = 5, 8, 7
    s, w, b, u, colors, frozen, clampv = _sweep_inputs(B, H, W, seed=23)
    beta = np.random.default_rng(24).uniform(0.3, 3.0, B).astype(np.float32)
    ts, tw, tb, tu, tclamp = [torch.as_tensor(x).to(torch.bfloat16) for x in (s, w, b, u, clampv)]
    got = ref.lattice_gibbs_sweep_ref(ts, tw, tb, tu, torch.as_tensor(colors),
                                      torch.as_tensor(frozen), tclamp, torch.as_tensor(beta))
    for r in range(B):
        want = jref.lattice_gibbs_sweep_ref(
            _bf16(s[r:r + 1]), _bf16(w), _bf16(b), _bf16(u[:, r:r + 1]), jnp.asarray(colors),
            jnp.asarray(frozen), _bf16(clampv), jnp.float32(beta[r]))
        np.testing.assert_array_equal(got[r].float().numpy(), np.asarray(want, np.float32)[0])


def test_kernel_wrapper_names_mixed_dtypes(launched):
    B, H, W = 2, 4, 4
    t = [torch.as_tensor(x) for x in _sweep_inputs(B, H, W, seed=8)]
    t[4], t[5] = t[4].float(), t[5].float()
    mixed = list(t)
    mixed[1] = t[1].to(torch.bfloat16)
    with pytest.raises(ValueError, match="w torch.bfloat16"):
        lattice_gibbs.lattice_gibbs_sweep(*mixed, torch.ones(B))
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        lattice_gibbs.lattice_gibbs_sweep(*[x.half() for x in t], torch.ones(B))
    with pytest.raises(ValueError, match="CUDA tensors"):  # bf16 throughout is taken
        lattice_gibbs.lattice_gibbs_sweep(*[x.to(torch.bfloat16) for x in t], torch.ones(B))
    assert not launched()


def test_ops_modes_on_cpu_and_the_kernel_wrapper_checks(launched):
    B, H, W = 2, 4, 4
    s, w, b, u, colors, frozen, clampv = _sweep_inputs(B, H, W, seed=7)
    t = [torch.as_tensor(x) for x in (s, w, b, u)]
    masks = [torch.as_tensor(colors).float(), torch.as_tensor(frozen).float(),
             torch.as_tensor(clampv)]
    auto = ops.lattice_gibbs_sweep(*t, *masks)
    np.testing.assert_array_equal(
        auto.numpy(), ops.lattice_gibbs_sweep(*t, *masks, mode="reference").numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.lattice_gibbs_sweep(*t, *masks, mode="kernel")
    with pytest.raises(ValueError, match="CUDA tensors"):
        lattice_gibbs.lattice_gibbs_sweep(*t, *masks, torch.ones(B))
    with pytest.raises(ValueError, match="mode"):
        ops.lattice_gibbs_sweep(*t, *masks, mode="pallas")
    assert not launched()


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    """The CUDA kernel against its plain version at one of chip_smoke.py's
    shapes: spins equal outside the band, frozen sites at their clamp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an sm_90 card); chip_smoke.py checks it there")
    B, H, W = 3, 17, 23
    s, w, b, u, colors, frozen, clampv = _sweep_inputs(B, H, W, seed=9)
    t = [torch.as_tensor(x, device="cuda") for x in (s, w, b, u)]
    masks = [torch.as_tensor(colors, device="cuda").float(),
             torch.as_tensor(frozen, device="cuda").float(), torch.as_tensor(clampv, device="cuda")]
    beta = torch.linspace(0.3, 3.0, B, device="cuda")
    got = ops.lattice_gibbs_sweep(*t, *masks, beta)
    plain = ops.lattice_gibbs_sweep(*t, *masks, beta, mode="reference")
    band = _phase_band(lambda x: ref.lattice_fields_ref(x, t[1], t[2]), t[0], t[3],
                       masks[0] > 0.5, masks[1] > 0.5, beta, P_BAND)
    assert not bool(((got != plain) & ~band).any())


@pytest.mark.cuda
def test_bf16_kernel_matches_plain_version_on_the_card():
    """The bf16 kernel against its plain version: spins equal outside the
    band, frozen sites at their clamp, the result in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an sm_90 card); chip_smoke.py checks it there")
    B, H, W = 3, 17, 23
    s, w, b, u, colors, frozen, clampv = _sweep_inputs(B, H, W, seed=10)
    t = [torch.as_tensor(x, device="cuda").to(torch.bfloat16)
         for x in (s, w, b, u, colors, frozen, clampv)]
    beta = torch.linspace(0.3, 3.0, B, device="cuda")
    got = ops.lattice_gibbs_sweep(*t, beta)
    assert got.dtype == torch.bfloat16
    plain = ops.lattice_gibbs_sweep(*t, beta, mode="reference")
    band = _phase_band(lambda x: ref.lattice_fields_ref(x, t[1], t[2]), t[0], t[3],
                       t[4] > 0.5, t[5] > 0.5, beta, P_BAND)
    assert not bool(((got != plain) & ~band).any())
    assert bool((got[:, t[5] > 0.5] == t[6][t[5] > 0.5]).all())


# ---------------------------------------------------------------------------
# The driver: ChromaticGibbs and lattice TauLeap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_chromatic_gibbs_samples_the_clamped_boltzmann_law(backend):
    lat, p_exact = _small_lattice(clamp=True)
    res = run(lat, ChromaticGibbs(), 0, n_steps=400, n_chains=256, sample_every=1,
              backend=backend)
    assert res.samples.shape == (256, 400, 2, 3) and res.energies.shape == (256, 400)
    assert bool((res.samples[..., 0, 0] == 1.0).all())  # the clamped site
    assert _tv(res.samples[:, 5:], p_exact, 6) < TV_MAX


def test_cuda_backend_on_cpu_tensors_follows_the_ref_trajectory():
    """Both backends draw the sweep's uniforms in one call and round alike,
    so on one device they give the same chains."""
    cal = problems.cal_problem(device=CPU)
    kw = dict(n_steps=30, n_chains=6, schedule=sampler_api.geometric(0.3, 3.0), sample_every=10,
              first_hit=-900.0)
    a = run(cal, ChromaticGibbs(), 4, backend="ref", **kw)
    b = run(cal, ChromaticGibbs(), 4, backend="cuda", **kw)
    for x, y in zip(a[:7], b[:7]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_allclose(a.t.numpy(), 30.0)


def test_cal_ground_state():
    lat = problems.cal_problem(device=CPU)
    t = torch.as_tensor(problems.cal_template())
    e_template = float(lat.energy(t))
    assert float(lat.to_dense().energy(t.reshape(-1))) == pytest.approx(e_template, rel=1e-5)
    rand = torch.as_tensor(2.0 * np.random.default_rng(0).integers(0, 2, (200, 16, 16)) - 1.0,
                           dtype=torch.float32)
    assert e_template < float(lat.energy(rand).min())
    # the sampler finds it; at beta = 1 a chain may also sit in a domain state
    res = run(lat, ChromaticGibbs(), 5, n_steps=300, n_chains=8, first_hit=e_template)
    overlap = (res.s * t).mean(dim=(-2, -1)).abs()
    assert float(res.hit.float().mean()) >= 0.5 and bool((overlap[res.hit] == 1.0).all()), overlap


def test_clamped_conditional():
    """Clamping = sampling the conditional Boltzmann distribution (Fig 4C)."""
    lat = problems.cal_problem(coupling=0.6, device=CPU)
    H, W = lat.shape
    template = torch.as_tensor(problems.cal_template())
    known = torch.zeros((H, W), dtype=torch.bool)
    known[: H // 2] = True
    clamped = dataclasses.replace(lat, clamp_mask=known, clamp_value=template)
    res = run(clamped, ChromaticGibbs(), 1, n_steps=400, n_chains=2, backend="cuda")
    assert bool((res.s[:, : H // 2] == template[: H // 2]).all())
    agree = float((res.s[:, H // 2:] * template[H // 2:]).mean())
    assert agree > 0.9, agree


def test_tau_leap_on_a_lattice_bias_shrinks_with_dt():
    lat, p_exact = _small_lattice(clamp=False, seed=4)
    tvs = []
    for dt, steps in [(0.8, 1500), (0.05, 6000)]:
        res = run(lat, TauLeap(dt=dt), 2, n_steps=steps, n_chains=64, sample_every=4)
        tvs.append(_tv(res.samples[:, 10:], p_exact, 6))
    assert tvs[1] < tvs[0], tvs
    assert tvs[1] < 0.06, tvs
    # frozen sites never flip under tau-leap either
    clamped, _ = _small_lattice(clamp=True, seed=4)
    res = run(clamped, TauLeap(dt=0.8), 2, n_steps=50, n_chains=8, sample_every=1)
    assert bool((res.samples[..., 0, 0] == 1.0).all())


def test_lattice_dispatch_and_errors():
    lat, _ = _small_lattice()
    trim = glauber.SigmoidTrim(a=torch.ones(()), b=torch.zeros(()))
    assert sampler_api.kernel_names() == [
        "chromatic_gibbs", "colored_gibbs", "ctmc", "random_scan_gibbs", "tau_leap"]
    assert sampler_api.problem_kind_of(lat) == "lattice"
    assert sampler_api.state_shape(lat) == (2, 3)
    with pytest.raises(ValueError, match="does not support backend 'cuda'"):
        run(lat, ChromaticGibbs(trim=trim), 0, n_steps=2, backend="cuda")
    with pytest.raises(NotImplementedError, match="trims"):
        run(lat, ChromaticGibbs(trim=trim, backend="cuda"), 0, n_steps=2)
    assert run(lat, ChromaticGibbs(trim=trim), 0, n_steps=2, backend="auto").s.shape == (2, 3)
    with pytest.raises(ValueError, match="does not support backend 'cuda'"):
        run(lat, TauLeap(), 0, n_steps=2, backend="cuda")
    with pytest.raises(NotImplementedError, match="dense problems only"):
        run(lat, TauLeap(backend="cuda"), 0, n_steps=2)
    assert sampler_api._resolve_backend("auto", ChromaticGibbs(), lat) == "ref"
    with pytest.raises(ValueError, match="does not support 'dense'"):
        run(problems.sk_instance(6, 0, device=CPU), "chromatic_gibbs", 0, n_steps=2)
    with pytest.raises(TypeError, match="unknown problem type"):
        run(jproblems.cal_problem(coupling=0.5), ChromaticGibbs(), 0, n_steps=2)
    # s0: (H, W) for one chain, (n_chains, H, W) for several; clamps are applied
    s0 = -torch.ones((2, 3))
    res = run(lat, ChromaticGibbs(), 0, n_steps=1, s0=s0, sample_every=1)
    assert res.samples.shape == (1, 2, 3) and float(res.samples[0, 0, 0]) == 1.0
    with pytest.raises(ValueError, match="s0 has shape"):
        run(lat, ChromaticGibbs(), 0, n_steps=1, s0=torch.ones(6))
