"""The colour plan of the port's coloured sweep kernel, held against JAX.

`sparse_gather.colour_plan` turns a problem's colour masks into the lists
the CUDA sweep walks: per colour the ascending sites of its mask, and the
neighbour tables gathered into that order. The kernel runs only on the
card, so here its phase loop is emulated in plain torch over the plan (new
spins scattered to a second buffer at the colour's sites, then copied back)
and held bit for bit against the plain version, and within the band of
tests/test_torch_sparse.py against the JAX oracle and the Pallas kernel in
interpret mode; so is the long-row kernel's in-place phase loop, emulated
in tests/test_torch_sparse_long.py. The wrappers' choices (the fields
kernel by n, the rows and threads of a block, the plan and the operands it
was built from) are checked with the launch replaced.

Inputs are made with numpy from a seed and go through both packages."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import ising as jising
from repro.core import problems as jproblems
from repro.core import sparse as jsparse
from repro.kernels import ref as jref
from repro.kernels import sparse_gather as jsg
from repro_torch import tracing
from repro_torch.core import ising, problems, sampler_api
from repro_torch.core.sampler_api import ColoredGibbs, run
from repro_torch.core.sparse import SparseIsing
from repro_torch.kernels import ops, ref, sparse_gather
from repro_torch.kernels._checks import MAX_SMEM_BYTES
from test_torch_sparse_long import _emulate_long_sweep, _lattice

torch.set_num_threads(1)

CPU = "cpu"
P_BAND = 1e-6
FIELD_EPS = 2.0**-22
H100_SMS = 132


def _f32(a):
    return jnp.asarray(np.asarray(a, np.float32), jnp.float32)


def _dense_pair(n, seed, density):
    """The same random weighted graph as a JAX and a port SparseIsing."""
    rng = np.random.default_rng(seed)
    A = rng.normal(0, 0.6, (n, n)) * (rng.random((n, n)) < density)
    J = np.triu(A, 1)
    J = (J + J.T).astype(np.float32)
    b = rng.normal(0, 0.3, n).astype(np.float32)
    return (jsparse.SparseIsing.from_dense(jising.DenseIsing(J=_f32(J), b=_f32(b))),
            SparseIsing.from_dense(ising.DenseIsing.from_numpy(J, b, device=CPU)))


def _case(name):
    """(JAX problem, port problem, (C, n) bool masks as numpy) of a named case."""
    if name == "maxcut4096":  # the greedy colouring of the JAX generator
        jp = jproblems.random_3regular_maxcut(4096, 0)
        return jp, problems.random_3regular_maxcut(4096, 0, device=CPU), np.array(jp.color_masks)
    if name == "improper5":  # chip_smoke.py's n = 5 case: random masks, no colouring
        jp, tp = _dense_pair(5, 0, 1.0)
        return jp, tp, np.random.default_rng(1).random((3, 5)) < 0.5
    if name == "overlap_and_empty":  # a site in two masks, an empty colour
        jp, tp = _dense_pair(12, 3, 0.4)
        masks = np.array(jp.color_masks)
        masks[0, 5] = masks[1, 5] = True
        return jp, tp, np.concatenate([masks, np.zeros((1, 12), bool)])
    if name == "dense40":  # D > 3: entries of 8 or more columns
        jp, tp = _dense_pair(40, 7, 0.4)
        return jp, tp, np.array(jp.color_masks)
    raise ValueError(name)


CASES = ["maxcut4096", "improper5", "overlap_and_empty", "dense40"]


def _assert_same_plan(a, b):
    """The two plans list the same entries (their sources aside)."""
    for x, y in zip(a[:-1], b[:-1]):
        assert x == y if isinstance(x, (int, tuple)) else torch.equal(x, y)


def _emulate_plan_sweep(s, plan, u, beta):
    """The CUDA sweep's phase loop in plain torch: per colour, the fields of
    the plan's entries from `cur` (slots in order, an index outside [0, n)
    adding nothing), new spins scattered to `nxt` at the entries' sites,
    then copied back to `cur` at the same sites."""
    cur = s.clone()
    nxt = s.clone()
    D = plan.D
    bcol = beta[:, None]
    for c in range(len(plan.counts)):
        a, z = int(plan.offsets[c]), int(plan.offsets[c + 1])
        idx, w, sites = plan.idx[a:z], plan.w[a:z], plan.sites[a:z].long()
        acc = torch.zeros((s.shape[0], z - a), dtype=torch.float32)
        for k in range(D):
            j = idx[:, k].long()
            ok = (j >= 0) & (j < plan.n)
            acc = acc + torch.where(ok, w[:, k], 0.0) * cur[:, torch.where(ok, j, 0)]
        p = torch.sigmoid(-2.0 * (bcol * (acc + w[:, -1])))
        nxt[:, sites] = torch.where(u[c][:, sites] < p, 1.0, -1.0)
        cur[:, sites] = nxt[:, sites]
    return cur


def _band(tp, s, u, masks, beta):
    """Sites where some phase's uniform lies within the field bound of its
    p_up (tests/test_torch_sparse.py's band)."""
    tol = beta[:, None] / 2 * FIELD_EPS * (tp.nbr_w.abs().sum(-1) + tp.b.abs()) + P_BAND
    band = torch.zeros(s.shape, dtype=torch.bool)
    for c in range(masks.shape[0]):
        p = torch.sigmoid(-2.0 * (beta[:, None] * ref.sparse_fields_ref(s, tp.nbr_idx,
                                                                        tp.nbr_w, tp.b)))
        band |= masks[c] & ((u[c] - p).abs() <= tol)
        s = torch.where(masks[c], torch.where(u[c] < p, 1.0, -1.0), s)
    return band


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_colour_plan_round_trips_the_masks(name):
    jp, tp, masks = _case(name)
    plan = sparse_gather.colour_plan(tp.nbr_idx, tp.nbr_w, tp.b, torch.as_tensor(masks))
    C, n = masks.shape
    D = tp.max_deg
    P = plan.idx.shape[1]
    assert P % 4 == 0 and D < P <= D + 4 and plan.w.shape == plan.idx.shape
    assert (plan.n, plan.D) == (n, D) and plan.offsets.dtype == torch.int32
    assert plan.counts == tuple(int(x) for x in masks.sum(1))
    np.testing.assert_array_equal(plan.offsets.numpy(), np.concatenate([[0], np.cumsum(plan.counts)]))
    back = np.zeros_like(masks)
    for c in range(C):
        a, z = plan.offsets[c], plan.offsets[c + 1]
        sites = plan.sites[a:z].numpy()
        assert np.all(np.diff(sites) > 0)  # ascending, each once
        back[c, sites] = True
    np.testing.assert_array_equal(back, masks)
    order = plan.sites.long()
    # the gathered tables, against the JAX problem's own arrays
    np.testing.assert_array_equal(plan.idx[:, :D].numpy(), np.asarray(jp.nbr_idx)[order.numpy()])
    np.testing.assert_array_equal(plan.w[:, :D].numpy(), np.asarray(jp.nbr_w)[order.numpy()])
    np.testing.assert_array_equal(plan.w[:, -1].numpy(), np.asarray(jp.b)[order.numpy()])
    np.testing.assert_array_equal(plan.idx[:, :D].numpy(), tp.nbr_idx[order].numpy())
    assert bool((plan.idx[:, D:] == plan.sites[:, None]).all())  # pads name the site
    assert not bool(plan.w[:, D:-1].any())  # zero-weight pads
    # f32 {0,1} masks, as the kernels take them, give the same plan
    plan_f = sparse_gather.colour_plan(tp.nbr_idx, tp.nbr_w, tp.b,
                                       torch.as_tensor(masks, dtype=torch.float32))
    _assert_same_plan(plan, plan_f)


# ---------------------------------------------------------------------------
# The kernel's phase loop over the plan, emulated
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_plan_sweep_emulation_equals_the_plain_version(name):
    """Scatter to a second buffer at the colour's sites, then copy back:
    every phase sees the state before it, for any masks, bit for bit."""
    _, tp, masks = _case(name)
    B = 4 if name == "maxcut4096" else 6
    rng = np.random.default_rng(len(name))
    s = torch.as_tensor(rng.choice([-1.0, 1.0], (B, tp.n)).astype(np.float32))
    u = torch.as_tensor(rng.random((masks.shape[0], B, tp.n)).astype(np.float32))
    beta = torch.as_tensor(rng.uniform(0.3, 3.0, B).astype(np.float32))
    tm = torch.as_tensor(masks)
    plan = sparse_gather.colour_plan(tp.nbr_idx, tp.nbr_w, tp.b, tm)
    got = _emulate_plan_sweep(s, plan, u, beta)
    want = ref.colored_gibbs_sweep_ref(s, tp.nbr_idx, tp.nbr_w, tp.b, u, tm, beta)
    assert torch.equal(got, want)
    # through ops on CPU tensors with a plan: the plain version, the plan unread
    via_ops = ops.colored_gibbs_sweep(s, tp.nbr_idx, tp.nbr_w, tp.b, u, tm.float(), beta,
                                      plan=plan)
    assert torch.equal(via_ops, want)


@pytest.mark.parametrize("name", CASES)
def test_plan_sweep_emulation_matches_jax_oracle_and_pallas(name):
    jp, tp, masks = _case(name)
    B = 2 if name == "maxcut4096" else 4
    rng = np.random.default_rng(11 + len(name))
    s = rng.choice([-1.0, 1.0], (B, tp.n)).astype(np.float32)
    u = rng.random((masks.shape[0], B, tp.n)).astype(np.float32)
    beta = 1.3
    tm = torch.as_tensor(masks)
    ts, tu, tbeta = torch.as_tensor(s), torch.as_tensor(u), torch.full((B,), beta)
    plan = sparse_gather.colour_plan(tp.nbr_idx, tp.nbr_w, tp.b, tm)
    got = _emulate_plan_sweep(ts, plan, tu, tbeta).numpy()
    band = _band(tp, ts, tu, tm, tbeta).numpy()
    want = jref.colored_gibbs_sweep_ref(_f32(s), jp.nbr_idx, jp.nbr_w, jp.b, _f32(u),
                                        jnp.asarray(masks), jnp.float32(beta))
    pallas = jsg.colored_gibbs_sweep(_f32(s), jp.nbr_idx, jp.nbr_w, jp.b, _f32(u),
                                     _f32(masks), jnp.float32(beta), block_batch=B,
                                     interpret=True)
    for other in (want, pallas):
        differ = got != np.asarray(other)
        assert not np.any(differ & ~band), np.argwhere(differ & ~band)[:5]


@pytest.mark.parametrize("name", ["ea6", "maxcut4096", "dense40"])
def test_long_sweep_emulation_matches_jax_oracle_and_pallas(name):
    """The long-row kernel's in-place phases, emulated over the plan
    (tests/test_torch_sparse_long.py), against the JAX oracle and the Pallas
    sweep, on classes that are independent sets: the periodic 6^3 +-J
    lattice under its parity classes, and two greedy colourings."""
    if name == "ea6":
        tp = _lattice(6)
        jp = jsparse.SparseIsing(*(jnp.asarray(x.numpy()) for x in (
            tp.nbr_idx, tp.nbr_w, tp.deg, tp.b, tp.color_masks)))
        masks = tp.color_masks.numpy()
    else:
        jp, tp, masks = _case(name)
    B = 2 if name == "maxcut4096" else 4
    rng = np.random.default_rng(23 + len(name))
    s = rng.choice([-1.0, 1.0], (B, tp.n)).astype(np.float32)
    u = rng.random((masks.shape[0], B, tp.n)).astype(np.float32)
    beta = 1.3
    tm = torch.as_tensor(masks)
    ts, tu, tbeta = torch.as_tensor(s), torch.as_tensor(u), torch.full((B,), beta)
    plan = sparse_gather.colour_plan(tp.nbr_idx, tp.nbr_w, tp.b, tm)
    assert plan.independent
    got = _emulate_long_sweep(ts, plan, tu, tbeta).numpy()
    band = _band(tp, ts, tu, tm, tbeta).numpy()
    want = jref.colored_gibbs_sweep_ref(_f32(s), jp.nbr_idx, jp.nbr_w, jp.b, _f32(u),
                                        jnp.asarray(masks), jnp.float32(beta))
    pallas = jsg.colored_gibbs_sweep(_f32(s), jp.nbr_idx, jp.nbr_w, jp.b, _f32(u),
                                     _f32(masks), jnp.float32(beta), block_batch=B,
                                     interpret=True)
    for other in (want, pallas):
        differ = got != np.asarray(other)
        assert not np.any(differ & ~band), np.argwhere(differ & ~band)[:5]


# ---------------------------------------------------------------------------
# ColoredGibbs keeps the plan
# ---------------------------------------------------------------------------


def test_colored_gibbs_cuda_backend_builds_the_plan_once_in_init(monkeypatch):
    mc = problems.random_3regular_maxcut(40, 3, device=CPU)
    state = ColoredGibbs(backend="cuda").init(mc, torch.Generator().manual_seed(0), n_chains=3)
    masks, plan = state.aux
    assert torch.equal(masks, mc.color_masks.float())
    _assert_same_plan(plan, sparse_gather.colour_plan(mc.nbr_idx, mc.nbr_w, mc.b,
                                                      mc.color_masks))
    # built from the very masks step() passes the kernel, so check_plan takes it
    assert all(x is y for (x, _), y in zip(plan.source, (mc.nbr_idx, mc.nbr_w, mc.b, masks)))
    sparse_gather.check_plan(plan, mc.nbr_idx, mc.nbr_w, mc.b, masks)
    assert ColoredGibbs().init(mc, torch.Generator().manual_seed(0)).aux is mc.color_masks
    built, seen = [], []
    real_plan, real_sweep = sparse_gather.colour_plan, ops.colored_gibbs_sweep
    monkeypatch.setattr(sampler_api, "colour_plan",
                        lambda *a: built.append(1) or real_plan(*a))
    monkeypatch.setattr(sampler_api.ops, "colored_gibbs_sweep",
                        lambda *a, plan=None, **k: seen.append(plan) or real_sweep(*a, **k))
    kw = dict(n_steps=6, n_chains=4, schedule=sampler_api.linear(0.3, 2.0), sample_every=2,
              first_hit=-40.0)
    a = run(mc, ColoredGibbs(), 5, backend="ref", **kw)
    b = run(mc, ColoredGibbs(), 5, backend="cuda", **kw)
    assert len(built) == 1 and len(seen) == 6
    assert all(isinstance(p, sparse_gather.ColourPlan) and p is seen[0] for p in seen)
    for x, y in zip(a[:7], b[:7]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


# ---------------------------------------------------------------------------
# The wrappers' choices, with the launch replaced (no card here)
# ---------------------------------------------------------------------------


@pytest.fixture
def no_card(monkeypatch):
    """The wrappers on CPU tensors: the device check passes, the launches are
    recorded instead of run, the card has the H100's 132 SMs."""
    calls = []
    monkeypatch.setattr(sparse_gather, "check_cuda", lambda t: t.device)
    monkeypatch.setattr(sparse_gather, "_sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(sparse_gather, "_launch_fields",
                        lambda s, i, w, b, out, rows, threads, dev: calls.append((rows, threads)))
    monkeypatch.setattr(sparse_gather, "_launch_sweep",
                        lambda s, plan, u, beta, out, threads, dev: calls.append((plan, threads)))
    return calls


def _ring(n, D=3):
    """Tables of a ring (two neighbours and a padded slot) of n sites."""
    i = np.arange(n)
    idx = np.stack([(i - 1) % n, (i + 1) % n, i] + [i] * (D - 3), 1).astype(np.int32)
    w = np.zeros((n, D), np.float32)
    w[:, :2] = 1.0
    return torch.as_tensor(idx), torch.as_tensor(w), torch.zeros(n)


@pytest.mark.parametrize("B,n,rows,kernel", [
    (256, 16384, 2, "sparse_fields"),  # the main path: two staged rows a block
    (1024, 16384, 3, "sparse_fields"),  # at most 3 rows
    (298, 16384, 3, "sparse_fields"),  # chip_smoke.py's case of 3 rows, the last block 1
    (1, 5, 1, "sparse_fields"),
    (2, MAX_SMEM_BYTES // 4, 1, "sparse_fields"),  # the longest row that fits: 58112 sites
    (2, MAX_SMEM_BYTES // 4 + 1, 0, "sparse_fields_global"),  # one site more: the global kernel
    (1, 65536, 0, "sparse_fields_global"),
])
def test_sparse_fields_chooses_its_kernel_by_n_and_counts_it(no_card, launched, B, n, rows,
                                                             kernel):
    assert sparse_gather.fields_rows(B, n, H100_SMS) == rows
    idx, w, b = _ring(n)
    out = sparse_gather.sparse_fields(torch.ones((B, n)), idx, w, b)
    assert out.shape == (B, n) and out.dtype == torch.float32
    assert no_card == [(rows, min(1024, -(-n // 32) * 32))]
    assert launched() == {kernel: 1}


def _other_operands(name, mc, masks):
    """The (nbr_idx, nbr_w, b, masks) of a call that the plan of mc's
    tables and `masks` was not built from (None: it was), and the error."""
    tables = [mc.nbr_idx, mc.nbr_w, mc.b, masks]
    if name == "same":
        return tables, None
    if name == "another_problem":  # same n, D and C, other edges
        other = problems.random_3regular_maxcut(mc.n, 2, device=CPU)
        assert other.n_colors == mc.n_colors and not torch.equal(other.nbr_idx, mc.nbr_idx)
        return [other.nbr_idx, other.nbr_w, other.b, other.color_masks.float()], "another nbr_idx"
    if name == "other_masks":  # same shape, sites moved between colours
        return tables[:3] + [masks.roll(1, 0).contiguous()], "another masks"
    if name == "equal_copy":  # equal values, another tensor: still refused
        return [tables[0].clone()] + tables[1:], "another nbr_idx"
    if name == "weights_changed":  # changed in place after the plan was built
        tables[1].mul_(-1.0)
        return tables, "nbr_w changed in place"
    if name == "masks_changed":
        tables[3][:, 0] = 1.0
        return tables, "masks changed in place"
    raise ValueError(name)


@pytest.mark.parametrize("name", ["same", "another_problem", "other_masks", "equal_copy",
                                  "weights_changed", "masks_changed"])
def test_colored_gibbs_sweep_takes_a_plan_only_with_its_own_operands(no_card, launched, name):
    """The kernel reads the plan's tables, not the operands: a plan of
    another problem of the same size, or of tables or masks changed since,
    would sweep another graph, so the wrapper refuses it."""
    mc = problems.random_3regular_maxcut(64, 1, device=CPU)
    masks = mc.color_masks.float()
    plan = sparse_gather.colour_plan(mc.nbr_idx, mc.nbr_w, mc.b, masks)
    operands, error = _other_operands(name, mc, masks)
    B = 3
    s, u, beta = torch.ones((B, 64)), torch.rand((mc.n_colors, B, 64)), torch.ones(B)
    if error is None:
        sparse_gather.check_plan(plan, *operands)
        sparse_gather.colored_gibbs_sweep(s, *operands[:3], u, operands[3], beta, plan=plan)
        assert no_card == [(plan, 64)]
        return
    with pytest.raises(ValueError, match=error):
        sparse_gather.check_plan(plan, *operands)
    with pytest.raises(ValueError, match=error):
        sparse_gather.colored_gibbs_sweep(s, *operands[:3], u, operands[3], beta, plan=plan)
    assert no_card == [] and launched()["colored_gibbs_sweep"] == 0


def test_colored_gibbs_sweep_wrapper_builds_or_checks_the_plan(no_card, launched):
    mc = problems.random_3regular_maxcut(64, 1, device=CPU)
    tables = (mc.nbr_idx, mc.nbr_w, mc.b)
    C, B = mc.n_colors, 5
    s, u, beta = torch.ones((B, 64)), torch.rand((C, B, 64)), torch.ones(B)
    masks = mc.color_masks.float()
    sparse_gather.colored_gibbs_sweep(s, *tables, u, masks, beta)  # builds its own plan
    plan = sparse_gather.colour_plan(*tables, masks)
    sparse_gather.colored_gibbs_sweep(s, *tables, u, masks, beta, plan=plan)
    (built, threads), (given, _) = no_card
    assert given is plan and threads == 64
    _assert_same_plan(built, plan)
    assert launched()["colored_gibbs_sweep"] == 2
    other = sparse_gather.colour_plan(*tables, masks[:2])
    with pytest.raises(ValueError, match="the plan is of"):
        sparse_gather.colored_gibbs_sweep(s, *tables, u, masks, beta, plan=other)
    with pytest.raises(TypeError, match="ColourPlan"):
        sparse_gather.colored_gibbs_sweep(s, *tables, u, masks, beta, plan=tuple(plan))
    bad = plan._replace(idx=plan.idx[:, :3].contiguous())
    with pytest.raises(ValueError, match="plan.idx"):
        sparse_gather.colored_gibbs_sweep(s, *tables, u, masks, beta, plan=bad)
    # two int8 copies of one chain no longer fit a block: the long-row kernel
    # takes the call, and it refuses one class holding every edge
    n = MAX_SMEM_BYTES // 2 + 2
    idx, w, b = _ring(n)
    with pytest.raises(ValueError, match="shared memory.*independent sets"):
        sparse_gather.colored_gibbs_sweep(torch.ones((1, n)), idx, w, b, torch.rand((1, 1, n)),
                                          torch.ones((1, n)), torch.ones(1))
    assert launched()["colored_gibbs_sweep"] == 2
    assert launched()["colored_gibbs_sweep_long"] == 0


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card_with_both_fields_kernels():
    """On the card: both sparse_fields kernels bit for bit, and the sweep over
    the plan ColoredGibbs.init keeps equal to the sweep over its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an sm_90 card); chip_smoke.py checks it there")
    rng = np.random.default_rng(2)
    for n, kernel in ((2048, "sparse_fields"), (60000, "sparse_fields_global")):
        mc = problems.random_3regular_maxcut(n, 4, device="cuda")
        s = torch.as_tensor(rng.normal(size=(3, n)).astype(np.float32), device="cuda")
        before = tracing.counts()
        got = ops.sparse_fields(s, mc.nbr_idx, mc.nbr_w, mc.b)
        assert tracing.counts()[f"launch.{kernel}"] == before[f"launch.{kernel}"] + 1
        assert torch.equal(got, ops.sparse_fields(s, mc.nbr_idx, mc.nbr_w, mc.b,
                                                  mode="reference"))
    mc = problems.random_3regular_maxcut(2048, 5, device="cuda")
    s = torch.where(torch.rand((8, 2048), device="cuda") < 0.5, 1.0, -1.0)
    u = torch.rand((mc.n_colors, 8, 2048), device="cuda")
    beta = torch.linspace(0.3, 3.0, 8, device="cuda")
    masks, plan = ColoredGibbs(backend="cuda").init(mc, torch.Generator(device="cuda"),
                                                    s0=s).aux
    tables = (mc.nbr_idx, mc.nbr_w, mc.b)
    assert torch.equal(ops.colored_gibbs_sweep(s, *tables, u, masks, beta, plan=plan),
                       ops.colored_gibbs_sweep(s, *tables, u, masks, beta))
