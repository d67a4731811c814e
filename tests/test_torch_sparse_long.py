"""The long-row colour sweep: rows of n > 116224 sites, whose two int8 copies
of a chain no block's shared memory holds, and the 3D +-J Edwards-Anderson
glass at Janus's L = 80 that needs it.

The kernel runs only on the card, so here: the choice of kernel by n, what
the wrapper refuses (fault operands, classes that are no independent sets),
the plan's record of independence, the kernel's in-place phases emulated in
plain torch over the plan (entries updated a chunk at a time, so a write
lands before later reads) and held bit for bit against the plain version
(and in tests/test_torch_sparse_plan.py against the JAX oracle and the
Pallas kernel in interpret mode), `ColoredGibbs`'s plain path at a long row
against the benchmark's EA reference, and `SparseIsing.validate` at L = 80
without densifying. On the card (marked `cuda`) the kernel itself, bit for
bit against the plain version. This file imports no JAX, so it runs there."""
import dataclasses
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import problems, sampler_api
from repro_torch.core.sampler_api import ColoredGibbs, run
from repro_torch.core.sparse import SparseIsing, _symmetric
from repro_torch.kernels import ops, ref, sparse_gather
from repro_torch.kernels._checks import MAX_SMEM_BYTES

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from bench import program  # noqa: E402
from bench.common import load_module  # noqa: E402

torch.set_num_threads(1)

CPU = "cpu"
LONGEST_SHORT = MAX_SMEM_BYTES // 2  # 116224 sites: the longest row the shared-memory kernel takes


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _lattice(L):
    """chip_smoke.py's periodic L^3 lattice with +-1 couplings (each edge's
    the same both ways), ascending neighbour slots and its parity classes."""
    return _chip_smoke().ea3d_problem(torch, L, L, torch.device(CPU))


def _ring(n, C=1):
    """A ring of n sites (two neighbours and a pad) with C masks: C = 1 puts
    every site in one class, C = 2 alternates (n even: independent)."""
    i = torch.arange(n)
    idx = torch.stack([(i - 1) % n, (i + 1) % n, i], 1).to(torch.int32)
    w = torch.tensor([1.0, 1.0, 0.0]).repeat(n, 1)
    masks = torch.ones((1, n)) if C == 1 else torch.stack([(i % 2 == 0).float(),
                                                           (i % 2 == 1).float()])
    return idx, w, torch.zeros(n), masks


@pytest.fixture
def no_card(monkeypatch):
    """The wrapper on CPU tensors: the device check passes and the launches
    are recorded instead of run."""
    calls = []
    monkeypatch.setattr(sparse_gather, "check_cuda", lambda t: t.device)
    monkeypatch.setattr(sparse_gather, "_launch_sweep",
                        lambda *a, **k: calls.append("colored_gibbs_sweep"))
    monkeypatch.setattr(sparse_gather, "_launch_sweep_long",
                        lambda s, plan, u, beta, out, dev: calls.append(("long", plan)))
    return calls


# ---------------------------------------------------------------------------
# The choice by n, and what the long-row wrapper refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, kernel", [
    (5, "colored_gibbs_sweep"), (16384, "colored_gibbs_sweep"),
    (LONGEST_SHORT, "colored_gibbs_sweep"),  # 116224: 2n bytes just fit a block
    (LONGEST_SHORT + 1, "colored_gibbs_sweep_long"),
    (125000, "colored_gibbs_sweep_long"), (512000, "colored_gibbs_sweep_long"),
])
def test_the_sweep_kernel_is_chosen_by_n(n, kernel):
    assert LONGEST_SHORT == 116224
    assert sparse_gather.sweep_kernel(n) == kernel


@pytest.mark.parametrize("n", [LONGEST_SHORT, LONGEST_SHORT + 2])
def test_the_wrapper_takes_the_kernel_of_n_and_counts_it(no_card, launched, n):
    idx, w, b, masks = _ring(n, C=2)
    B = 2
    out = sparse_gather.colored_gibbs_sweep(torch.ones((B, n)), idx, w, b,
                                            torch.rand((2, B, n)), masks, torch.ones(B))
    assert out.shape == (B, n) and out.dtype == torch.float32
    kernel = sparse_gather.sweep_kernel(n)
    assert launched() == {kernel: 1}
    if kernel == "colored_gibbs_sweep_long":
        (tag, plan), = no_card
        assert tag == "long" and plan.independent and plan.counts == (n // 2, n // 2)
    else:
        assert no_card == ["colored_gibbs_sweep"]


@pytest.mark.parametrize("faults", ["bias_rows", "keep", "both"])
def test_a_long_row_call_with_fault_operands_raises(no_card, launched, faults):
    n, B = LONGEST_SHORT + 2, 2
    idx, w, b, masks = _ring(n, C=2)
    kw = {"bias_rows": torch.zeros((B, n)), "keep": torch.ones((B, n), dtype=torch.bool)}
    kw = kw if faults == "both" else {faults: kw[faults]}
    with pytest.raises(NotImplementedError, match="no fault variant"):
        sparse_gather.colored_gibbs_sweep(torch.ones((B, n)), idx, w, b, torch.rand((2, B, n)),
                                          masks, torch.ones(B), **kw)
    assert no_card == [] and not launched()


def test_a_long_row_call_refuses_classes_that_are_no_independent_sets(no_card, launched):
    n, B = LONGEST_SHORT + 2, 1
    idx, w, b, masks = _ring(n, C=1)  # every site in one class: each edge inside it
    plan = sparse_gather.colour_plan(idx, w, b, masks)
    assert not plan.independent
    with pytest.raises(ValueError, match="independent sets"):
        sparse_gather.colored_gibbs_sweep(torch.ones((B, n)), idx, w, b, torch.rand((1, B, n)),
                                          masks, torch.ones(B), plan=plan)
    assert no_card == [] and not launched()


# ---------------------------------------------------------------------------
# The plan's record of independence
# ---------------------------------------------------------------------------


def test_independent_classes_finds_a_shared_site_or_an_edge_inside_a_class():
    ea = _lattice(4)

    def independent(idx, masks):
        return bool(sparse_gather.independent_classes(idx, masks.bool()))

    assert independent(ea.nbr_idx, ea.color_masks)
    mc = problems.random_3regular_maxcut(64, 1, device=CPU)  # greedy colouring
    assert independent(mc.nbr_idx, mc.color_masks)
    two = ea.color_masks.clone()  # a site in two classes
    two[1, 0] = True
    assert not independent(ea.nbr_idx, two)
    inside = ea.color_masks.clone()  # site 0 and its neighbour 1 both in class 0
    inside[:, 1] = torch.tensor([True, False])
    assert not independent(ea.nbr_idx, inside)
    # a site in no class, an empty class, pads naming the site: still independent
    some = torch.cat([ea.color_masks, torch.zeros((1, ea.n), dtype=torch.bool)])
    some[0, 0] = False
    assert independent(ea.nbr_idx, some)
    idx, _, _, masks = _ring(10, C=2)  # slot 2 is a pad naming the site itself
    assert independent(idx, masks)


@pytest.mark.parametrize("n, C, independent", [
    (64, 2, True), (64, 1, False), (LONGEST_SHORT, 2, True), (LONGEST_SHORT, 1, False),
    (LONGEST_SHORT + 2, 2, True), (LONGEST_SHORT + 2, 1, False),
])
def test_the_plan_records_independence_at_every_n(n, C, independent):
    idx, w, b, masks = _ring(n, C)
    plan = sparse_gather.colour_plan(idx, w, b, masks)
    assert plan.independent is independent and sum(plan.counts) == n


# ---------------------------------------------------------------------------
# The kernel's in-place phases, emulated
# ---------------------------------------------------------------------------


def _emulate_long_sweep(s, plan, u, beta, chunk=7):
    """The long-row kernel in plain torch: pack to int8, then per colour the
    plan's entries a chunk at a time, each chunk's fields from the int8
    state as the chunks before it left it (slots in order, an index
    outside [0, n) adding nothing) and its new spins written in place; then
    unpack."""
    st = torch.where(s > 0, 1, -1).to(torch.int8)
    bcol = beta[:, None]
    for c in range(len(plan.counts)):
        beg, end = int(plan.offsets[c]), int(plan.offsets[c + 1])
        for a in range(beg, end, chunk):
            z = min(end, a + chunk)
            idx, w, sites = plan.idx[a:z], plan.w[a:z], plan.sites[a:z].long()
            acc = torch.zeros((s.shape[0], z - a))
            for k in range(plan.D):
                j = idx[:, k].long()
                ok = (j >= 0) & (j < plan.n)
                acc = acc + torch.where(ok, w[:, k], 0.0) * st[:, torch.where(ok, j, 0)].float()
            p = torch.sigmoid(-2.0 * (bcol * (acc + w[:, -1])))
            st[:, sites] = torch.where(u[c][:, sites] < p, 1, -1).to(torch.int8)
    return st.float()


@pytest.mark.parametrize("name", ["ea6", "maxcut4096", "dense40"])
def test_the_in_place_phases_equal_the_plain_version(name):
    if name == "ea6":
        prob = _lattice(6)
    elif name == "maxcut4096":
        prob = problems.random_3regular_maxcut(4096, 0, device=CPU)
    else:  # D > 7: plan rows of 12 columns, read through the cache
        rng = np.random.default_rng(7)
        A = rng.normal(0, 0.6, (40, 40)) * (rng.random((40, 40)) < 0.4)
        J = np.triu(A, 1)
        from repro_torch.core.ising import DenseIsing

        prob = SparseIsing.from_dense(DenseIsing.from_numpy(J + J.T, rng.normal(0, 0.3, 40),
                                                            device=CPU))
    masks = prob.color_masks.float()
    plan = sparse_gather.colour_plan(prob.nbr_idx, prob.nbr_w, prob.b, masks)
    assert bool(sparse_gather.independent_classes(prob.nbr_idx, prob.color_masks))
    B = 5
    rng = np.random.default_rng(len(name))
    s = torch.as_tensor(rng.choice([-1.0, 1.0], (B, prob.n)).astype(np.float32))
    u = torch.as_tensor(rng.random((masks.shape[0], B, prob.n)).astype(np.float32))
    beta = torch.as_tensor(rng.uniform(0.3, 3.0, B).astype(np.float32))
    want = ref.colored_gibbs_sweep_ref(s, prob.nbr_idx, prob.nbr_w, prob.b, u,
                                       prob.color_masks, beta)
    assert torch.equal(_emulate_long_sweep(s, plan, u, beta), want)


def test_in_place_phases_need_independent_classes():
    """Why the wrapper refuses: on a ring in one class the in-place phases
    let a site see a neighbour's new spin, and the sweep differs."""
    idx, w, b, masks = _ring(64, C=1)
    plan = sparse_gather.colour_plan(idx, w, b, masks)
    g = torch.Generator().manual_seed(3)
    s = torch.where(torch.rand((4, 64), generator=g) < 0.5, 1.0, -1.0)
    u, beta = torch.rand((1, 4, 64), generator=g), torch.full((4,), 2.0)
    want = ref.colored_gibbs_sweep_ref(s, idx, w, b, u, masks.bool(), beta)
    assert not torch.equal(_emulate_long_sweep(s, plan, u, beta), want)


@pytest.mark.cuda
def test_the_long_row_kernel_equals_the_plain_version_on_the_card():
    """On the card: three chained sweeps of the long-row kernel at (4, 125000)
    on the L = 50 lattice, per-row beta, over the plan ColoredGibbs.init
    builds and over the wrapper's own, bit for bit against the plain
    version, each call counted as the long-row kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an sm_90 card); chip_smoke.py checks it there")
    dev = torch.device("cuda")
    prob = _chip_smoke().ea3d_problem(torch, 50, 50, dev)
    B, n = 4, prob.n
    assert sparse_gather.sweep_kernel(n) == "colored_gibbs_sweep_long"
    gen = torch.Generator(device=dev).manual_seed(50)
    s = torch.where(torch.rand((B, n), generator=gen, device=dev) < 0.5, 1.0, -1.0)
    beta = torch.tensor([0.3, 1.0, 1.4285714, 3.0], device=dev)
    masks, plan = ColoredGibbs(backend="cuda").init(prob, gen, s0=s).aux
    assert plan.independent and plan.counts == (n // 2, n // 2)
    tables = (prob.nbr_idx, prob.nbr_w, prob.b)
    got = own = want = s
    before = tracing.counts()
    for _ in range(3):
        u = torch.rand((2, B, n), generator=gen, device=dev)
        got = sparse_gather.colored_gibbs_sweep(got, *tables, u, masks, beta, plan=plan)
        own = sparse_gather.colored_gibbs_sweep(own, *tables, u, masks, beta)
        want = ops.colored_gibbs_sweep(want, *tables, u, masks, beta, mode="reference")
    assert torch.equal(got, want) and torch.equal(own, want)
    after = tracing.counts()
    assert {k: n - before[k] for k, n in after.items()
            if k.startswith("launch.") and n != before[k]} == {"launch.colored_gibbs_sweep_long": 6}


# ---------------------------------------------------------------------------
# run()'s plain path at a long row, against the benchmark's reference
# ---------------------------------------------------------------------------


def test_colored_gibbs_plain_path_on_a_long_row_equals_the_ea_reference():
    """L = 50: 125000 sites, past the shared-memory kernel's 116224. The
    port's `run()` on the plain backend and the EA reference's heat-bath
    sweeps from one seed give the same states, samples and energies."""
    ea3d = load_module("reference", "ea3d")
    inst = ea3d.instance({"L": 50}, None, 2**31 + 50, CPU)
    prob = program.problem(ea3d.KIND, inst)
    assert sparse_gather.sweep_kernel(prob.n) == "colored_gibbs_sweep_long"
    assert prob.n_colors == 2
    beta, chains, steps = 1.4285714, 2, 3
    res = run(prob, ColoredGibbs(), 12345, n_steps=steps, n_chains=chains, backend="ref",
              schedule=sampler_api.constant(beta), sample_every=1)
    model = ea3d.Model({"L": 50}, inst, {"name": "colored_gibbs"})
    gen = torch.Generator().manual_seed(12345)
    s = model.init(gen, chains)
    samples = []
    for _ in range(steps):
        s = model.step(s, torch.full((chains,), beta, dtype=torch.float32), gen)
        samples.append(s)
    assert torch.equal(res.s, s)
    assert torch.equal(res.samples, torch.stack(samples, 1))
    np.testing.assert_array_equal(res.energies.double().numpy(),
                                  model.energies(res.samples).numpy())


# ---------------------------------------------------------------------------
# SparseIsing.validate without densifying
# ---------------------------------------------------------------------------


def test_validate_takes_an_l80_lattice_in_seconds():
    prob = _lattice(80)
    assert prob.n == 512000
    t = time.perf_counter()
    prob.validate()
    assert time.perf_counter() - t < 20.0
    bad = prob.nbr_w.clone()
    bad[123, 4] *= -1.0  # one direction of one edge flipped
    with pytest.raises(ValueError, match="symmetric"):
        dataclasses.replace(prob, nbr_w=bad).validate()


def _dense_symmetric(idx, w):
    """The check validate made before: np.allclose(J, J.T, atol=1e-6) of the
    densified couplings."""
    n = idx.shape[0]
    J = np.zeros((n, n), np.float64)
    np.add.at(J, (np.repeat(np.arange(n), idx.shape[1]), idx.reshape(-1)),
              w.astype(np.float64).reshape(-1))
    return bool(np.allclose(J, J.T, atol=1e-6))


@pytest.mark.parametrize("seed", range(8))
def test_the_symmetry_check_agrees_with_the_dense_one(seed):
    """Random tables with repeated slots, pads, missing reverse slots and
    reverse weights nudged around the tolerance: the check without J gives
    the dense check's answer every time."""
    rng = np.random.default_rng(seed)
    verdicts = set()
    for _ in range(150):
        n, md = int(rng.integers(1, 9)), int(rng.integers(1, 5))
        idx = rng.integers(0, n, (n, md)).astype(np.int32)
        w = rng.choice([0.0, 1.0, -1.0, 0.5, 3e-6], (n, md)).astype(np.float32)
        if rng.random() < 0.7:  # make it symmetric, then maybe break it a little
            J = np.zeros((n, n), np.float32)
            iu = np.triu_indices(n, 1)
            J[iu] = rng.choice([0.0, 1.0, -2.0, 0.25], iu[0].size)
            J = J + J.T
            deg = (J != 0).sum(1)
            md = max(1, int(deg.max()) + int(rng.integers(0, 2)))
            idx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, md))
            w = np.zeros((n, md), np.float32)
            for i in range(n):
                js = np.nonzero(J[i])[0]
                idx[i, :js.size], w[i, :js.size] = js, J[i, js]
            if rng.random() < 0.6 and (w != 0).any():
                r, c = np.argwhere(w != 0)[rng.integers(0, int((w != 0).sum()))]
                w[r, c] += rng.choice([1e-7, 9e-7, 2e-6, 1e-5, -3e-6, 0.5])
        want = _dense_symmetric(idx, w)
        assert _symmetric(idx, w) == want, (idx, w)
        verdicts.add(want)
    assert verdicts == {True, False}
