"""The lattice plan of the port's lattice sweep kernels, held against JAX.

`lattice_gibbs.lattice_plan` turns a lattice's colour and frozen masks into
the lists the CUDA plan kernel walks: per colour the ascending updated
sites, each with its edge bits and its weight row, the frozen sites with
their clamp values, and whether every list is an independent set of the
king graph (then the kernel updates in place; otherwise the wrapper takes
the two-buffer kernel). The kernels run only on the card, so here the plan
kernel's phase loop is emulated in plain torch, one entry at a time in
place, and held bit for bit against the plain version, and within the
phase band of tests/test_torch_lattice.py against the JAX oracle and the
Pallas kernel in interpret mode. The wrapper's choices (route, the plan
kernel's threads, the plan and the operands it was built from) are checked
with the launches replaced.

Inputs are made with numpy from a seed and go through both packages."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import ising as jising
from repro.kernels import lattice_gibbs as jlg
from repro.kernels import ref as jref
from repro_torch import tracing
from repro_torch.core import ising, problems, sampler_api
from repro_torch.core.ising import KING_OFFSETS
from repro_torch.core.sampler_api import ChromaticGibbs, run
from repro_torch.kernels import lattice_gibbs, ops, ref
from repro_torch.kernels._checks import MAX_SMEM_BYTES

torch.set_num_threads(1)

CPU = "cpu"
P_BAND = 1e-6
# the (H, W) of chip_smoke.py's LATTICE_SHAPES
LATTICE_HW = [(1, 1), (8, 8), (16, 16), (32, 24), (17, 23), (128, 128), (200, 200)]


def _f32(a):
    return jnp.asarray(np.asarray(a, np.float32), jnp.float32)


def _bf16(a):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


def _lattice(H, W, seed, masks="king", frozen=True):
    """Numpy (w, b, colors, frozen, clamp) of a random lattice: asymmetric
    weight planes, king colour masks (or random ones, or one mask holding
    every site, or the king masks of the top-left 64x64 corner only), a
    random frozen plane and ±1 clamp values."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.5, (8, H, W)).astype(np.float32)
    b = rng.normal(0, 0.3, (H, W)).astype(np.float32)
    colors = {"king": lambda: np.array(jising.king_color_masks(H, W)),
              "random": lambda: rng.random((4, H, W)) < 0.5,
              "all_sites": lambda: np.ones((1, H, W), bool),
              "corner": lambda: np.array(jising.king_color_masks(H, W))
              & (np.arange(H)[:, None] < 64) & (np.arange(W) < 64)}[masks]()
    fz = (rng.random((H, W)) < 0.2) if frozen else np.zeros((H, W), bool)
    clampv = rng.choice([-1.0, 1.0], (H, W)).astype(np.float32)
    return w, b, colors, fz, clampv


def _plan_operands(w, b, colors, fz, clampv, dtype=torch.float32):
    """The wrapper's operands: w, b, f32/bf16 {0,1} masks and clamp values."""
    return tuple(torch.as_tensor(np.asarray(x, np.float32)).to(dtype)
                 for x in (w, b, colors, fz, clampv))


def _emulate_plan_sweep(s, plan, u, beta, order=1):
    """The plan kernel's phase loop in plain torch, in place in one buffer:
    per colour, one entry at a time (in list order, or reversed with
    order=-1), the field from the current state (valid neighbours in
    KING_OFFSETS order, every op in s's dtype), the new spin written at
    once; then the frozen sites' clamp values."""
    B, H, W = s.shape
    dt = s.dtype
    cur = s.reshape(B, -1).clone()
    uu = u.reshape(u.shape[0], B, -1)
    offs = [dy * W + dx for dy, dx in KING_OFFSETS]
    for c in range(len(plan.counts)):
        a, z = int(plan.offsets[c]), int(plan.offsets[c + 1])
        for j in range(a, z)[::order]:
            site, edges = int(plan.sites[j]), int(plan.edges[j])
            acc = torch.zeros((B,), dtype=dt)
            for k in range(8):
                if edges >> k & 1:
                    acc = acc + plan.w[j, k].to(dt) * cur[:, site + offs[k]]
            h = acc + plan.w[j, 8].to(dt)
            p = torch.sigmoid(-2.0 * (beta * h))
            cur[:, site] = torch.where(uu[c, :, site] < p, 1.0, -1.0).to(dt)
    cur[:, plan.frozen.long()] = plan.clamp.to(dt)
    return cur.reshape(B, H, W)


def _phase_band(fields, s, u, masks, frozen, beta, tol):
    """Sites where some phase of the plain sweep drew a uniform within `tol`
    of its p_up (tests/test_torch_lattice.py's band)."""
    band = torch.zeros(s.shape, dtype=torch.bool)
    bb = beta.reshape(-1, 1, 1)
    for c in range(masks.shape[0]):
        p = torch.sigmoid(-2.0 * (bb * fields(s)))
        upd = masks[c] & ~frozen
        band |= upd & ((u[c] - p).abs() <= tol)
        s = torch.where(upd, torch.where(u[c] < p, 1.0, -1.0).to(s.dtype), s)
    return band


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


PLAN_CASES = [(16, 16, "king", True), (17, 23, "king", False), (8, 8, "random", True),
              (5, 7, "all_sites", True)]


@pytest.mark.parametrize("H,W,masks,frozen", PLAN_CASES)
def test_lattice_plan_round_trips_the_masks(H, W, masks, frozen):
    w, b, colors, fz, clampv = _lattice(H, W, seed=H * W, masks=masks, frozen=frozen)
    ops_ = _plan_operands(w, b, colors, fz, clampv)
    plan = lattice_gibbs.lattice_plan(*ops_)
    C = colors.shape[0]
    upd = colors & ~fz
    assert plan.shape == (H, W) and plan.counts == tuple(int(x) for x in upd.sum((1, 2)))
    np.testing.assert_array_equal(plan.offsets.numpy(), np.concatenate([[0], np.cumsum(plan.counts)]))
    assert plan.offsets.dtype == plan.entry.dtype == plan.frozen.dtype == torch.int32
    back = np.zeros_like(upd)
    for c in range(C):
        a, z = plan.offsets[c], plan.offsets[c + 1]
        sites = plan.sites[a:z].numpy()
        assert np.all(np.diff(sites) > 0)  # ascending, each once
        back[c].reshape(-1)[sites] = True
    np.testing.assert_array_equal(back, upd)
    sites = plan.sites.numpy()
    y, x = sites // W, sites % W
    for k, (dy, dx) in enumerate(KING_OFFSETS):  # edge bits: the neighbour lies on the lattice
        on = (y + dy >= 0) & (y + dy < H) & (x + dx >= 0) & (x + dx < W)
        np.testing.assert_array_equal((plan.edges.numpy() >> k) & 1, on.astype(np.int32))
    # each entry's row: its site's weights (0 beyond the edge) and b, then zero pads
    on = (plan.edges.numpy()[:, None] >> np.arange(8)) & 1 == 1
    np.testing.assert_array_equal(plan.w[:, :8].numpy(), np.where(on, w.reshape(8, -1)[:, sites].T, 0))
    np.testing.assert_array_equal(plan.w[:, 8].numpy(), b.reshape(-1)[sites])
    assert plan.w.shape == (len(sites), 12) and not bool(plan.w[:, 9:].any())
    np.testing.assert_array_equal(plan.frozen.numpy(), np.flatnonzero(fz))
    np.testing.assert_array_equal(plan.clamp.numpy(), clampv.reshape(-1)[fz.reshape(-1)])
    # bool masks, as ChromaticGibbs keeps them on the ref backend, give the same plan
    plan_b = lattice_gibbs.lattice_plan(ops_[0], ops_[1], torch.as_tensor(colors),
                                        torch.as_tensor(fz), ops_[4])
    for p, q in zip(plan[:-1], plan_b[:-1]):
        assert p == q if isinstance(p, (int, tuple)) else torch.equal(p, q)


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("H,W", LATTICE_HW)
def test_king_colour_masks_give_an_independent_plan(H, W, frozen):
    plan = lattice_gibbs.lattice_plan(*_plan_operands(*_lattice(H, W, 1, frozen=frozen)))
    assert plan.independent and plan.found_independent
    # the route a chip_smoke.py shape takes: the plan kernel, one entry a
    # colour a thread, while every list fits one block's threads; else the
    # two-buffer kernel
    longest = max(plan.counts)
    assert plan.threads == (max(32, -(-longest // 32) * 32) if longest <= 1024 else 0)
    smem = H * W + 2 * lattice_gibbs.halo_bytes(W) if plan.threads else 2 * H * W
    assert smem <= MAX_SMEM_BYTES


@pytest.mark.parametrize("masks", ["random", "all_sites"])
def test_masks_that_are_not_independent_sets_are_marked(masks):
    H = W = 8
    plan = lattice_gibbs.lattice_plan(*_plan_operands(*_lattice(H, W, 2, masks=masks)))
    assert not plan.independent
    # one adjacent pair in one colour is enough
    colors = ising.king_color_masks(H, W, device=CPU).clone()
    colors[0, 0, 1] = True
    plan = lattice_gibbs.lattice_plan(torch.zeros(8, H, W), torch.zeros(H, W), colors,
                                      torch.zeros(H, W), torch.ones(H, W))
    assert not plan.independent
    # unless one of the pair is frozen
    fz = torch.zeros(H, W)
    fz[0, 1] = 1.0
    assert lattice_gibbs.lattice_plan(torch.zeros(8, H, W), torch.zeros(H, W), colors, fz,
                                      torch.ones(H, W)).independent


@pytest.mark.parametrize("B,H,W,launch", [
    (4096, 16, 16, (64, "lattice_gibbs_sweep")),  # the CAL main path: 64 threads a block
    (4096, 1, 1, (32, "lattice_gibbs_sweep")),
    (3, 17, 23, (128, "lattice_gibbs_sweep")),  # lists of up to 108
    (16, 128, 128, (0, "lattice_gibbs_generic")),  # lists of 4096: the two-buffer kernel
    (1, 200, 200, (0, "lattice_gibbs_generic")),
])
def test_plan_launch_shape(no_card, launched, B, H, W, launch):
    """The plan kernel's threads a block, computed once in the plan, and
    the route of chip_smoke.py's lattice shapes."""
    plan = lattice_gibbs.lattice_plan(*_plan_operands(*_lattice(H, W, 3, frozen=False)))
    threads, route = launch
    assert plan.threads == lattice_gibbs.plan_threads(plan.counts) == threads
    args = _sweep_args(H, W, "king", B=B, seed=3, frozen=False)
    lattice_gibbs.lattice_gibbs_sweep(*args)
    assert launched() == {route: 1}
    assert no_card == ([("plan", threads)] if threads else [("generic",)])


# ---------------------------------------------------------------------------
# The plan kernel's phase loop, emulated
# ---------------------------------------------------------------------------


def _sweep_case(B, H, W, seed, dtype, masks="king"):
    w, b, colors, fz, clampv = _lattice(H, W, seed, masks=masks)
    rng = np.random.default_rng(seed + 1)
    s = rng.choice([-1.0, 1.0], (B, H, W)).astype(np.float32)
    u = rng.random((colors.shape[0], B, H, W)).astype(np.float32)
    beta = rng.uniform(0.3, 3.0, B).astype(np.float32)
    t = _plan_operands(w, b, colors, fz, clampv, dtype)
    ts, tu = (torch.as_tensor(x).to(dtype) for x in (s, u))
    return (w, b, colors, fz, clampv, s, u, beta), t, ts, tu, torch.as_tensor(beta)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W", [(4, 16, 16), (3, 17, 23), (2, 32, 24)])
def test_in_place_plan_sweep_equals_the_plain_version(B, H, W, dtype):
    """One entry at a time, in place, in either order: for independent
    lists every field reads only sites of other phases, so the sweep is
    the plain version's bit for bit."""
    _, (w, b, colors, fz, clampv), ts, tu, tbeta = _sweep_case(B, H, W, B * H + W, dtype)
    plan = lattice_gibbs.lattice_plan(w, b, colors, fz, clampv)
    assert plan.independent
    want = ref.lattice_gibbs_sweep_ref(ts, w, b, tu, colors > 0.5, fz > 0.5, clampv, tbeta)
    for order in (1, -1):
        got = _emulate_plan_sweep(ts, plan, tu, tbeta, order)
        assert got.dtype == dtype and torch.equal(got, want)
    # through ops on CPU tensors with a plan: the plain version, the plan unread
    via_ops = ops.lattice_gibbs_sweep(ts, w, b, tu, colors, fz, clampv, tbeta, plan=plan)
    assert torch.equal(via_ops, want)


def test_in_place_sweep_differs_for_masks_that_are_not_independent():
    """Why the flag chooses the route: at chip_smoke.py's random (8, 8, 8)
    masks an in-place sweep reads sites its own phase already changed."""
    _, (w, b, colors, fz, clampv), ts, tu, tbeta = _sweep_case(8, 8, 8, 5, torch.float32,
                                                               masks="random")
    plan = lattice_gibbs.lattice_plan(w, b, colors, fz, clampv)
    assert not plan.independent
    want = ref.lattice_gibbs_sweep_ref(ts, w, b, tu, colors > 0.5, fz > 0.5, clampv, tbeta)
    assert not torch.equal(_emulate_plan_sweep(ts, plan, tu, tbeta), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W", [(3, 16, 16), (2, 17, 23)])
def test_plan_sweep_matches_jax_oracle_and_pallas_per_row(B, H, W, dtype):
    """Each row with its own beta against one JAX call per row (scalar
    beta): the oracle and the Pallas kernel in interpret mode, equal
    outside the phase band."""
    (w, b, colors, fz, clampv, s, u, beta), t, ts, tu, tbeta = _sweep_case(B, H, W, 7 * B + H,
                                                                           dtype)
    plan = lattice_gibbs.lattice_plan(*t)
    got = _emulate_plan_sweep(ts, plan, tu, tbeta)
    band = _phase_band(lambda x: ref.lattice_fields_ref(x, t[0], t[1]), ts, tu,
                       torch.as_tensor(colors), torch.as_tensor(fz), tbeta, P_BAND).numpy()
    cast = _f32 if dtype == torch.float32 else _bf16
    for r in range(B):
        jargs = [cast(x) for x in (s[r:r + 1], w, b, u[:, r:r + 1])]
        want = jref.lattice_gibbs_sweep_ref(*jargs, jnp.asarray(colors), jnp.asarray(fz),
                                            cast(clampv), jnp.float32(beta[r]))
        pallas = jlg.lattice_gibbs_sweep(*jargs, cast(colors), cast(fz), cast(clampv),
                                         jnp.float32(beta[r]), interpret=True, block_batch=1)
        for other in (want, pallas):
            differ = got[r].float().numpy() != np.asarray(other, np.float32)[0]
            assert not np.any(differ & ~band[r]), (r, np.argwhere(differ & ~band[r])[:5])


# ---------------------------------------------------------------------------
# ChromaticGibbs keeps the plan
# ---------------------------------------------------------------------------


def _assert_same_plan(a, b):
    """The two plans list the same entries (their sources aside)."""
    for x, y in zip(a[:-1], b[:-1]):
        assert x == y if isinstance(x, (int, tuple)) else torch.equal(x, y)


def test_chromatic_gibbs_cuda_backend_builds_the_plan_once_in_init(monkeypatch):
    cal = problems.cal_problem(device=CPU)
    H, W = cal.shape
    known = torch.zeros((H, W), dtype=torch.bool)
    known[: H // 2] = True
    lat = dataclasses.replace(cal, clamp_mask=known,
                              clamp_value=torch.as_tensor(problems.cal_template()))
    state = ChromaticGibbs(backend="cuda").init(lat, torch.Generator().manual_seed(0), n_chains=3)
    colors, frozen, clamp, plan = state.aux
    assert torch.equal(colors, ising.king_color_masks(H, W, device=CPU).float())
    assert torch.equal(frozen, lat.frozen_mask.float()) and plan.independent
    _assert_same_plan(plan, lattice_gibbs.lattice_plan(lat.w, lat.b, colors, frozen, clamp))
    assert plan.frozen.numel() == int(known.sum())
    # built from the very tensors step() passes the kernel, so check_plan takes it
    assert all(x is y for (x, _), y in zip(plan.source, (lat.w, lat.b, colors, frozen, clamp)))
    lattice_gibbs.check_plan(plan, lat.w, lat.b, colors, frozen, clamp)
    assert len(ChromaticGibbs().init(lat, torch.Generator().manual_seed(0)).aux) == 2
    built, seen = [], []
    real_plan, real_sweep = lattice_gibbs.lattice_plan, ops.lattice_gibbs_sweep
    monkeypatch.setattr(sampler_api, "lattice_plan", lambda *a: built.append(1) or real_plan(*a))
    monkeypatch.setattr(sampler_api.ops, "lattice_gibbs_sweep",
                        lambda *a, plan=None, **k: seen.append(plan) or real_sweep(*a, **k))
    kw = dict(n_steps=6, n_chains=4, schedule=sampler_api.linear(0.3, 2.0), sample_every=2,
              first_hit=-900.0)
    a = run(lat, ChromaticGibbs(), 5, backend="ref", **kw)
    b = run(lat, ChromaticGibbs(), 5, backend="cuda", **kw)
    assert len(built) == 1 and len(seen) == 6
    assert all(isinstance(p, lattice_gibbs.LatticePlan) and p is seen[0] for p in seen)
    for x, y in zip(a[:7], b[:7]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


# ---------------------------------------------------------------------------
# The wrapper's choices, with the launches replaced (no card here)
# ---------------------------------------------------------------------------


@pytest.fixture
def no_card(monkeypatch):
    """The wrapper on CPU tensors: the device check passes and the launches
    are recorded instead of run."""
    calls = []
    monkeypatch.setattr(lattice_gibbs, "check_cuda", lambda t: t.device)
    monkeypatch.setattr(lattice_gibbs, "_launch_plan",
                        lambda s, plan, u, beta, out, dev: calls.append(("plan", plan.threads)))
    monkeypatch.setattr(lattice_gibbs, "_launch_generic",
                        lambda *a: calls.append(("generic",)))
    return calls


def _sweep_args(H, W, masks, B=3, seed=4, frozen=True):
    w, b, colors, fz, clampv = _plan_operands(*_lattice(H, W, seed, masks=masks, frozen=frozen))
    C = colors.shape[0]
    return [torch.ones((B, H, W)), w, b, torch.rand((C, B, H, W)), colors, fz, clampv,
            torch.ones(B)]


@pytest.mark.parametrize("H,W,masks,route", [
    (16, 16, "king", "lattice_gibbs_sweep"), (64, 64, "king", "lattice_gibbs_sweep"),
    (8, 8, "random", "lattice_gibbs_generic"), (16, 16, "all_sites", "lattice_gibbs_generic"),
    (200, 200, "king", "lattice_gibbs_generic"),  # lists longer than a block's threads
])
def test_the_plan_chooses_the_route_and_each_route_is_counted(no_card, launched, H, W, masks,
                                                              route):
    args = _sweep_args(H, W, masks)
    out = lattice_gibbs.lattice_gibbs_sweep(*args)  # builds its own plan
    plan = lattice_gibbs.lattice_plan(*args[1:3], *args[4:7])
    lattice_gibbs.lattice_gibbs_sweep(*args, plan=plan)
    assert out.shape == args[0].shape and out.dtype == args[0].dtype
    assert launched() == {route: 2}
    if route == "lattice_gibbs_generic":
        assert no_card == [("generic",)] * 2
        return
    assert no_card == [("plan", plan.threads)] * 2
    assert plan.threads == -(-max(plan.counts) // 32) * 32


def _other_operands(name, args):
    """The sweep's arguments with one of w, b, colors, frozen, clamp_value
    replaced or changed after the plan was built (None: none), and the error."""
    args = list(args)
    if name == "same":
        return args, None
    if name == "another_lattice":  # same shape and colouring, other weights
        other = _sweep_args(16, 16, "king", seed=9)
        return args[:1] + other[1:3] + args[3:], "another w"
    if name == "other_masks":  # same shape, sites moved between colours
        args[4] = args[4].roll(1, 0).contiguous()
        return args, "another colors"
    if name == "equal_copy":  # equal values, another tensor: still refused
        args[5] = args[5].clone()
        return args, "another frozen"
    if name == "weights_changed":  # changed in place after the plan was built
        args[1].mul_(-1.0)
        return args, "w changed in place"
    if name == "clamp_changed":
        args[6][0, 0] = -args[6][0, 0]
        return args, "clamp_value changed in place"
    if name == "frozen_changed":
        args[5][0, 0] = 1.0 - args[5][0, 0]
        return args, "frozen changed in place"
    raise ValueError(name)


@pytest.mark.parametrize("name", ["same", "another_lattice", "other_masks", "equal_copy",
                                  "weights_changed", "clamp_changed", "frozen_changed"])
def test_sweep_takes_a_plan_only_with_its_own_operands(no_card, launched, name):
    """The plan kernel reads the plan's weights, lists and clamp values, not
    the operands: a plan of another lattice of the same size, or of tensors
    changed since, would sweep another problem, so the wrapper refuses it."""
    args = _sweep_args(16, 16, "king")
    plan = lattice_gibbs.lattice_plan(*args[1:3], *args[4:7])
    args, error = _other_operands(name, args)
    if error is None:
        lattice_gibbs.check_plan(plan, *args[1:3], *args[4:7])
        lattice_gibbs.lattice_gibbs_sweep(*args, plan=plan)
        assert no_card == [("plan", plan.threads)]
        return
    with pytest.raises(ValueError, match=error):
        lattice_gibbs.check_plan(plan, *args[1:3], *args[4:7])
    with pytest.raises(ValueError, match=error):
        lattice_gibbs.lattice_gibbs_sweep(*args, plan=plan)
    assert no_card == [] and not launched()


def test_wrapper_refuses_malformed_plans_and_lattices_too_large(no_card, launched):
    args = _sweep_args(16, 16, "king")
    plan = lattice_gibbs.lattice_plan(*args[1:3], *args[4:7])
    with pytest.raises(TypeError, match="LatticePlan"):
        lattice_gibbs.lattice_gibbs_sweep(*args, plan=tuple(plan))
    with pytest.raises(ValueError, match="plan.w"):
        lattice_gibbs.lattice_gibbs_sweep(*args, plan=plan._replace(w=plan.w[:, :9].contiguous()))
    with pytest.raises(ValueError, match="plan.w"):  # a row per entry
        lattice_gibbs.lattice_gibbs_sweep(*args, plan=plan._replace(w=plan.w[:-1].contiguous()))
    with pytest.raises(ValueError, match="the plan is of"):
        lattice_gibbs.lattice_gibbs_sweep(*args, plan=plan._replace(counts=plan.counts[:3]))
    with pytest.raises(ValueError, match="threads"):
        lattice_gibbs.lattice_gibbs_sweep(*args, plan=plan._replace(threads=1024))
    # one int8 copy of a chain fits a block: the plan kernel takes a lattice
    # whose lists it can walk (the king masks of one 64x64 corner) ...
    H = W = 342  # 116964 sites: one copy fits in 232448 bytes, two do not
    corner = _sweep_args(H, W, "corner", B=1, frozen=False)  # lists of 1024
    lattice_gibbs.lattice_gibbs_sweep(*corner)
    assert no_card == [("plan", 1024)]
    # ... but masks that are not independent, or lists too long for the plan
    # kernel, need two copies, and a lattice past the limit fits neither kernel
    with pytest.raises(ValueError, match="two int8 copies"):
        lattice_gibbs.lattice_gibbs_sweep(*_sweep_args(H, W, "all_sites", B=1))
    with pytest.raises(ValueError, match="two int8 copies"):
        lattice_gibbs.lattice_gibbs_sweep(*_sweep_args(H, W, "king", B=1))
    with pytest.raises(ValueError, match="an int8 copy of a chain between two halos"):
        lattice_gibbs.lattice_gibbs_sweep(*_sweep_args(483, 483, "corner", B=1))
    assert launched() == {"lattice_gibbs_sweep": 1}


@pytest.mark.parametrize("masks", ["random", "all_sites"])
def test_a_plan_may_be_marked_not_independent_but_never_independent(no_card, launched, masks):
    """Lowering `independent` only sends the sweep to the two-buffer kernel,
    which is exact for any masks; raising it would update in place where a
    phase reads its own sites, so check_plan refuses it."""
    args = _sweep_args(8, 8, masks)
    plan = lattice_gibbs.lattice_plan(*args[1:3], *args[4:7])
    assert not plan.independent and not plan.found_independent
    with pytest.raises(ValueError, match="marked independent"):
        lattice_gibbs.lattice_gibbs_sweep(*args, plan=plan._replace(independent=True))
    king = _sweep_args(8, 8, "king")
    plan_k = lattice_gibbs.lattice_plan(*king[1:3], *king[4:7])
    lattice_gibbs.lattice_gibbs_sweep(*king, plan=plan_k._replace(independent=False))
    assert no_card == [("generic",)]
    assert launched() == {"lattice_gibbs_generic": 1}


@pytest.mark.cuda
def test_both_routes_match_the_plain_version_on_the_card():
    """On the card: the plan kernel (king masks) and the generic kernel
    (random masks) equal the plain version outside the band, and the sweep
    over the plan ChromaticGibbs.init keeps equals the sweep over its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an sm_90 card); chip_smoke.py checks it there")
    for masks, route in (("king", "lattice_gibbs_sweep"), ("random", "lattice_gibbs_generic")):
        _, t, ts, tu, tbeta = _sweep_case(5, 17, 23, 11, torch.float32, masks=masks)
        t, ts, tu, tbeta = [x.cuda() for x in t], ts.cuda(), tu.cuda(), tbeta.cuda()
        before = tracing.counts()
        got = ops.lattice_gibbs_sweep(ts, t[0], t[1], tu, *t[2:], tbeta)
        assert tracing.counts()[f"launch.{route}"] == before[f"launch.{route}"] + 1
        plain = ops.lattice_gibbs_sweep(ts, t[0], t[1], tu, *t[2:], tbeta, mode="reference")
        band = _phase_band(lambda x: ref.lattice_fields_ref(x, t[0], t[1]), ts.cpu(), tu.cpu(),
                           t[2].cpu() > 0.5, t[3].cpu() > 0.5, tbeta.cpu(), P_BAND)
        assert not bool(((got.cpu() != plain.cpu()) & ~band).any())
    cal = problems.cal_problem(device="cuda")
    s = torch.where(torch.rand((8, 16, 16), device="cuda") < 0.5, 1.0, -1.0)
    u = torch.rand((4, 8, 16, 16), device="cuda")
    beta = torch.linspace(0.3, 3.0, 8, device="cuda")
    colors, frozen, clamp, plan = ChromaticGibbs(backend="cuda").init(
        cal, torch.Generator(device="cuda"), s0=s).aux
    args = (s, cal.w, cal.b, u, colors, frozen, clamp, beta)
    assert torch.equal(ops.lattice_gibbs_sweep(*args, plan=plan), ops.lattice_gibbs_sweep(*args))
