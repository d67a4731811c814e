"""The sparse energy kernel (`csrc/sparse_energy.cu`): run()'s first-hit and
recorded energy under `ColoredGibbs(backend="cuda")`.

The kernel runs only on the card, so here: its order of summation emulated
in plain torch (`sparse_gather.energy_in_kernel_order`: each site's slots in
order, a thread's sites in turn, each warp's shuffle tree, the warps in
turn, and on long rows each row's tiles in turn) and held against
`SparseIsing.energy`, bit for bit on +-1 states with integer couplings,
within a stated band otherwise; the wrapper with its launcher replaced (its
checks, its route by n at the boundary, its chunks of rows past the int32
limit, its launch counters); `ops.sparse_energy` on the CPU; and which
energy `run()` takes. On the card (marked `cuda`) the kernel itself against
the emulation, bit for bit on any values, and against the plain version,
and a graphed `run()` against the plain backend. This file imports no JAX,
so it runs there; tests/test_torch_sparse.py holds the emulation against
the JAX energy."""
import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import problems, sampler_api
from repro_torch.core.sampler_api import ChromaticGibbs, ColoredGibbs, TauLeap, run
from repro_torch.core.sparse import SparseIsing, gather_sum
from repro_torch.kernels import ops, ref, sparse_gather
from repro_torch.kernels._checks import MAX_SMEM_BYTES

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
LONGEST_STAGED = MAX_SMEM_BYTES // 4  # 58112 sites: the longest row a block stages in f32
EPS = 2.0**-23  # float32 eps: twice the unit roundoff

torch.set_num_threads(1)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _lattice(L, dev=CPU):
    """chip_smoke.py's periodic L^3 lattice with +-1 couplings."""
    return _chip_smoke().ea3d_problem(torch, L, L, torch.device(dev))


# ---------------------------------------------------------------------------
# The kernel's order of summation, emulated
# ---------------------------------------------------------------------------


def _terms(s, prob):
    """(rows, n) pair terms s_i h_i and bias terms b_i s_i, h_i summed over
    the slots in order: the kernel's per-site arithmetic."""
    rows = s.reshape(-1, prob.n).to(torch.float32)
    return rows * gather_sum(rows, prob.nbr_idx, prob.nbr_w), prob.b * rows


def _emulate(s, prob, route):
    return sparse_gather.energy_in_kernel_order(s, prob.nbr_idx, prob.nbr_w, prob.b, route)


def _band(s, prob):
    """The widest gap two orders of summation allow. Every term is
    bit-equal in both, so only the sums over the sites differ: any order of
    n - 1 rounded adds of terms x_i is within (n - 1) u sum|x_i| of the exact
    sum (u = 2^-24), so two orders within 2 (n - 1) u sum|x_i| < n EPS
    sum|x_i| of each other; the halving is exact and the last add rounds
    once more in each, within EPS |E|."""
    pair, field = (t.double().reshape(s.shape[:-1] + (prob.n,)) for t in _terms(s, prob))
    e = (0.5 * pair.sum(-1) + field.sum(-1)).abs()
    return EPS * (prob.n * (0.5 * pair.abs().sum(-1) + field.abs().sum(-1)) + e)


def _pm1(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.where(torch.rand(shape, generator=g) < 0.5, 1.0, -1.0)


def _integer_weights(prob, seed):
    """The graph of `prob` with symmetric integer couplings in [-3, 3] and
    an integer bias: every partial sum stays an integer."""
    rng = np.random.default_rng(seed)
    n = prob.n
    idx = prob.nbr_idx.numpy()
    J = {}
    w = np.zeros(idx.shape, np.float32)
    for i in range(n):
        for k, j in enumerate(idx[i]):
            if j != i:
                key = (min(i, j), max(i, j))
                w[i, k] = J.setdefault(key, float(rng.integers(-3, 4)))
    b = rng.integers(-2, 3, n).astype(np.float32)
    return SparseIsing.from_numpy(idx, w, prob.deg.numpy(), b, device=CPU)


CASES = {
    "maxcut4096": lambda: problems.random_3regular_maxcut(4096, 0, device=CPU),
    "ea6": lambda: _lattice(6),
    "ea10": lambda: _lattice(10),
    "ea10_integer": lambda: _integer_weights(_lattice(10), 1),
    "maxcut4096_integer": lambda: _integer_weights(
        problems.random_3regular_maxcut(4096, 0, device=CPU), 2),
}


@pytest.mark.parametrize("route", ["sparse_energy", "sparse_energy_long"])
@pytest.mark.parametrize("lead", [(5,), (3, 4)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_the_kernels_order_equals_the_energy_on_pm1_states(name, lead, route):
    prob = CASES[name]()
    s = _pm1(lead + (prob.n,), len(name))
    want = prob.energy(s)
    got = _emulate(s, prob, route)
    assert got.shape == want.shape == lead
    assert torch.equal(got, want)


def _gaussian(prob, seed):
    """The graph of `prob` with Gaussian couplings on its live slots and a
    Gaussian bias (not symmetric: the energy does not ask it)."""
    g = torch.Generator().manual_seed(seed)
    live = prob.nbr_idx != torch.arange(prob.n, dtype=torch.int32)[:, None]
    w = torch.randn(prob.nbr_w.shape, generator=g) * live
    return SparseIsing(prob.nbr_idx, w.contiguous(), prob.deg,
                       0.3 * torch.randn((prob.n,), generator=g))


@pytest.mark.parametrize("route", ["sparse_energy", "sparse_energy_long"])
@pytest.mark.parametrize("states", ["pm1", "gaussian"])
@pytest.mark.parametrize("name", ["maxcut4096", "ea10"])
def test_the_kernels_order_stays_within_the_band_otherwise(name, states, route):
    base = CASES[name]()
    prob = _gaussian(base, 7) if states == "pm1" else base
    g = torch.Generator().manual_seed(11)
    s = _pm1((6, prob.n), 3) if states == "pm1" else torch.randn((6, prob.n), generator=g)
    want = prob.energy(s)
    got = _emulate(s, prob, route)
    gap = (got.double() - want.double()).abs()
    assert bool((gap <= _band(s, prob)).all()), (gap, _band(s, prob))


def test_the_emulation_reads_the_kernels_own_constants():
    """The block of a long-row tile, its sites and the rows' sum are the
    source's: an emulation with other numbers would sum in another order."""
    src = (REPO / "src/repro_torch/kernels/csrc/sparse_energy.cu").read_text()

    def const(name):
        (value,) = re.findall(rf"constexpr int {name} = (\d+);", src)
        return int(value)

    assert const("kTile") == sparse_gather.ENERGY_TILE
    assert const("kTileThreads") == sparse_gather.ENERGY_TILE_THREADS
    assert const("kSumThreads") % 32 == 0  # a warp a row, whatever the block
    assert const("kMaxWarps") * 32 == sparse_gather.BLOCK_THREADS
    with pytest.raises(ValueError, match="no energy kernel"):
        sparse_gather.energy_in_kernel_order(_pm1((1, 8), 0), *_ring(8), kernel="atomic")


def test_the_band_is_not_idle():
    """On Gaussian states the two orders do differ, and by much less than
    the band: it is a bound, not a tolerance tuned to the gap."""
    prob = CASES["maxcut4096"]()
    s = torch.randn((16, prob.n), generator=torch.Generator().manual_seed(5))
    gap = (_emulate(s, prob, "sparse_energy").double() - prob.energy(s).double()).abs()
    assert bool((gap > 0).any())
    assert bool((gap < 0.1 * _band(s, prob)).all())


# ---------------------------------------------------------------------------
# The wrapper, its launcher replaced
# ---------------------------------------------------------------------------


@pytest.fixture
def no_card(monkeypatch):
    """The wrapper on CPU tensors: the device check passes, the card has
    132 SMs, and each launch is recorded and computed by its emulation."""
    calls = []

    def launch(s, nbr_idx, nbr_w, b, part, out, rows, threads, dev):
        prob = SparseIsing(nbr_idx, nbr_w, torch.zeros(nbr_idx.shape[0], dtype=torch.int32), b)
        route = "sparse_energy_long" if rows == 0 else "sparse_energy"
        out.copy_(_emulate(s, prob, route))
        calls.append({"route": route, "rows": rows, "threads": threads, "shape": tuple(s.shape),
                      "part": None if part is None else tuple(part.shape)})

    monkeypatch.setattr(sparse_gather, "check_cuda", lambda t: t.device)
    monkeypatch.setattr(sparse_gather, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(sparse_gather, "_launch_energy", launch)
    return calls


def _ring(n):
    i = torch.arange(n)
    idx = torch.stack([(i - 1) % n, (i + 1) % n, i], 1).to(torch.int32)
    w = torch.tensor([1.0, 1.0, 0.0]).repeat(n, 1)
    return idx, w, torch.zeros(n)


@pytest.mark.parametrize("n, kernel", [
    (5, "sparse_energy"), (16384, "sparse_energy"),
    (LONGEST_STAGED, "sparse_energy"),  # 58112: 4n bytes just fit a block
    (LONGEST_STAGED + 1, "sparse_energy_long"),
    (125000, "sparse_energy_long"), (512000, "sparse_energy_long"),
])
def test_the_energy_kernel_is_chosen_by_n(n, kernel):
    assert LONGEST_STAGED == 58112
    assert sparse_gather.energy_kernel(n) == kernel


@pytest.mark.parametrize("n", [LONGEST_STAGED, LONGEST_STAGED + 1])
def test_the_wrapper_takes_the_route_of_n_and_counts_it(no_card, launched, n):
    idx, w, b = _ring(n)
    s = _pm1((4, n), 1)
    out = sparse_gather.sparse_energy(s, idx, w, b)
    kernel = sparse_gather.energy_kernel(n)
    assert launched() == {kernel: 1}
    (call,) = no_card
    if kernel == "sparse_energy":
        assert call["rows"] == 1 and call["threads"] == 1024 and call["part"] is None
    else:
        assert call["rows"] == 0 and call["part"] == (4, 57, 2)  # ceil(58113 / 1024) tiles
    assert torch.equal(out, ref.sparse_energy_ref(s, idx, w, b))


@pytest.mark.parametrize("n, chunk, lead", [(64, 15, (5, 8)), (64, 15, (15,)),
                                             (LONGEST_STAGED + 1, 4, (10,)),
                                             (LONGEST_STAGED + 1, 4, (3, 3))])
def test_rows_past_the_index_limit_go_in_chunks(no_card, launched, monkeypatch, n, chunk, lead):
    """A block of rows whose elements reach INDEX_LIMIT (2^31 on the card: a
    run's samples at L = 80 from 4195 rows) is launched in chunks of
    (INDEX_LIMIT - 1) // n rows into slices of one output, each launch
    counted; here the limit is lowered so that a few rows reach it."""
    monkeypatch.setattr(sparse_gather, "INDEX_LIMIT", chunk * n + 1)
    idx, w, b = _ring(n)
    s = _pm1(lead + (n,), 12)
    out = sparse_gather.sparse_energy(s, idx, w, b)
    B, kernel = math.prod(lead), sparse_gather.energy_kernel(n)
    sizes = [min(chunk, B - r0) for r0 in range(0, B, chunk)]
    assert [c["shape"] for c in no_card] == [(m, n) for m in sizes]
    assert {c["route"] for c in no_card} == {kernel}
    if kernel == "sparse_energy_long":
        assert [c["part"] for c in no_card] == [(m, -(-n // 1024), 2) for m in sizes]
    assert launched()[kernel] == len(sizes)
    assert out.shape == lead
    assert torch.equal(out, ref.sparse_energy_ref(s, idx, w, b))
    with pytest.raises(ValueError, match="int32"):  # one row past the limit
        sparse_gather.sparse_energy(_pm1((2, chunk * n + 1), 13), *_ring(chunk * n + 1))


@pytest.mark.parametrize("B, rows", [(1, 1), (132, 1), (133, 2), (256, 2), (298, 3), (1000, 3)])
def test_the_staged_route_holds_enough_rows_a_block_for_the_card(no_card, B, rows):
    idx, w, b = _ring(4096)
    sparse_gather.sparse_energy(_pm1((B, 4096), 2), idx, w, b)
    assert [c["rows"] for c in no_card] == [rows]


@pytest.mark.parametrize("lead", [(), (7,), (4, 3), (2, 2, 2)])
def test_the_wrapper_takes_any_leading_dimensions(no_card, lead):
    prob = problems.random_3regular_maxcut(64, 0, device=CPU)
    s = _pm1(lead + (64,), 3)
    out = sparse_gather.sparse_energy(s, prob.nbr_idx, prob.nbr_w, prob.b)
    assert out.shape == lead and out.dtype == torch.float32
    assert no_card[0]["shape"] == (math.prod(lead), 64)
    assert torch.equal(out, prob.energy(s))


def test_the_wrapper_launches_nothing_for_no_rows(no_card, launched):
    idx, w, b = _ring(16)
    out = sparse_gather.sparse_energy(torch.ones((0, 16)), idx, w, b)
    assert out.shape == (0,) and no_card == [] and not launched()


@pytest.mark.parametrize("bad", ["f64", "idx64", "w_shape", "b_shape", "strided", "scalar",
                                 "idx_strided"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(no_card, launched, bad):
    idx, w, b = _ring(64)
    s = _pm1((4, 64), 4)
    if bad == "f64":
        s = s.double()
    elif bad == "idx64":
        idx = idx.long()
    elif bad == "w_shape":
        w = w[:, :2].contiguous()
    elif bad == "b_shape":
        b = b[:32]
    elif bad == "strided":
        s = _pm1((64, 4), 4).t()
    elif bad == "scalar":
        s = torch.tensor(1.0)
    else:
        idx = idx.t().contiguous().t()
    with pytest.raises(ValueError):
        sparse_gather.sparse_energy(s, idx, w, b)
    assert no_card == [] and not launched()


def test_the_wrapper_refuses_cpu_tensors_without_a_card():
    idx, w, b = _ring(64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sparse_gather.sparse_energy(_pm1((2, 64), 5), idx, w, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.sparse_energy(_pm1((2, 64), 5), idx, w, b, mode="kernel")


def test_both_counters_reach_the_launch_counts_and_tracing(no_card):
    """Each launch of either route is one count of its own name in
    `tracing.counts()`, and nothing else is counted."""
    before = tracing.counts()
    for n in (64, LONGEST_STAGED + 1, LONGEST_STAGED + 1):
        idx, w, b = _ring(n)
        sparse_gather.sparse_energy(_pm1((2, n), 6), idx, w, b)
    after = tracing.counts()
    assert {k: n - before[k] for k, n in after.items() if n != before[k]} == {
        "launch.sparse_energy": 1, "launch.sparse_energy_long": 2}


@pytest.mark.parametrize("lead", [(3,), (2, 5)])
def test_ops_takes_the_plain_version_on_the_cpu(monkeypatch, lead):
    def refuse(*args):
        raise AssertionError("the kernel's wrapper was called on CPU tensors")

    monkeypatch.setattr(sparse_gather, "sparse_energy", refuse)
    prob = problems.random_3regular_maxcut(256, 1, device=CPU)
    s = _pm1(lead + (256,), 7)
    tabs = (prob.nbr_idx, prob.nbr_w, prob.b)
    for mode in ("auto", "reference"):
        assert torch.equal(ops.sparse_energy(s, *tabs, mode=mode), prob.energy(s))
    s = torch.randn(lead + (256,), generator=torch.Generator().manual_seed(8))
    assert torch.equal(ref.sparse_energy_ref(s, *tabs), prob.energy(s))


# ---------------------------------------------------------------------------
# The energy run() takes
# ---------------------------------------------------------------------------


@pytest.fixture
def energy_calls(monkeypatch):
    """Every call of ops.sparse_energy, by the shape of its states."""
    calls = []
    plain = ops.sparse_energy

    def spy(s, *args, **kw):
        calls.append(tuple(s.shape))
        return plain(s, *args, **kw)

    monkeypatch.setattr(ops, "sparse_energy", spy)
    return calls


@pytest.mark.parametrize("diagnostics", [False, True])
def test_a_cuda_colour_run_takes_its_energies_from_ops(energy_calls, diagnostics):
    prob = problems.random_3regular_maxcut(128, 2, device=CPU)
    kw = dict(n_steps=12, n_chains=4, first_hit=-100.0, sample_every=4,
              schedule=sampler_api.geometric(0.3, 3.0), diagnostics=diagnostics)
    got = run(prob, ColoredGibbs(), 21, backend="cuda", **kw)
    # the first state, every step (first hit), the three recorded samples
    assert energy_calls == [(4, 128)] * 13 + [(4, 3, 128)]
    energy_calls.clear()
    want = run(prob, ColoredGibbs(), 21, backend="ref", **kw)
    assert energy_calls == []
    for field in ("s", "samples", "times", "energies", "t_hit", "hit"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    if diagnostics:
        for a, b in zip(got.diagnostics, want.diagnostics):
            assert torch.equal(a, b)


def test_without_first_hit_a_run_takes_two_energies(energy_calls):
    prob = problems.random_3regular_maxcut(128, 3, device=CPU)
    run(prob, ColoredGibbs(), 4, backend="cuda", n_steps=10, n_chains=3, sample_every=5)
    assert energy_calls == [(3, 128), (3, 2, 128)]


def test_the_energy_is_chosen_once_per_run():
    prob = problems.random_3regular_maxcut(64, 4, device=CPU)
    cuda = sampler_api._make_run(prob, ColoredGibbs(), 0, n_steps=3, backend="cuda")
    plain = sampler_api._make_run(prob, ColoredGibbs(), 0, n_steps=3, backend="ref")
    assert cuda.energy is not prob.energy
    assert plain.energy == prob.energy
    s = _pm1((2, 64), 9)
    assert torch.equal(cuda.energy(s), prob.energy(s))


def test_other_problems_and_kernels_keep_their_own_energy(energy_calls):
    sk = problems.sk_instance(24, seed=0, device=CPU)
    run(sk, TauLeap(dt=0.1), 1, backend="cuda", n_steps=5, n_chains=2, first_hit=-10.0,
        sample_every=1)
    cal = problems.cal_problem(device=CPU)
    run(cal, ChromaticGibbs(), 1, backend="cuda", n_steps=5, n_chains=2, first_hit=-900.0,
        sample_every=1)
    sparse = problems.random_3regular_maxcut(64, 5, device=CPU)
    run(sparse, "random_scan_gibbs", 1, n_steps=5, n_chains=2, first_hit=-50.0, sample_every=1)
    run(sparse, TauLeap(dt=0.1), 1, n_steps=5, n_chains=2, first_hit=-50.0, sample_every=1)
    assert energy_calls == []


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an sm_90 card); chip_smoke.py checks it there")
    return torch.device("cuda")


def _on_card(s, tabs):
    """The kernel's energies and the launches it counted."""
    before = tracing.counts()
    got = sparse_gather.sparse_energy(s, *tabs)
    torch.cuda.synchronize()
    return got, {k.removeprefix("launch."): n - before[k] for k, n in tracing.counts().items()
                 if k.startswith("launch.") and n != before[k]}


@pytest.mark.cuda
def test_the_staged_kernel_equals_the_plain_version_on_the_card():
    dev = _card()
    prob = problems.random_3regular_maxcut(16384, 0, device=dev)
    tabs = (prob.nbr_idx, prob.nbr_w, prob.b)
    gen = torch.Generator(device=dev).manual_seed(16384)
    for shape in ((256, 16384), (4, 3, 16384), (298, 16384)):
        s = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.5, 1.0, -1.0)
        got, launched = _on_card(s, tabs)
        assert launched == {"sparse_energy": 1}
        assert torch.equal(got, ref.sparse_energy_ref(s, *tabs))
        assert torch.equal(got, sparse_gather.energy_in_kernel_order(s, *tabs))


@pytest.mark.cuda
def test_the_long_row_kernels_equal_the_plain_version_on_the_card():
    dev = _card()
    prob = _lattice(50, "cuda")
    tabs = (prob.nbr_idx, prob.nbr_w, prob.b)
    gen = torch.Generator(device=dev).manual_seed(50)
    s = torch.where(torch.rand((64, 5, prob.n), generator=gen, device=dev) < 0.5, 1.0, -1.0)
    got, launched = _on_card(s, tabs)
    assert launched == {"sparse_energy_long": 1}
    assert torch.equal(got, ref.sparse_energy_ref(s, *tabs))
    assert torch.equal(got, sparse_gather.energy_in_kernel_order(s, *tabs))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["maxcut16384", "ea50"])
def test_chunks_of_rows_equal_one_launch_on_the_card(monkeypatch, name):
    """With the int32 limit lowered to 7 rows, the kernel's chunks into
    slices of one output (and, on long rows, of one scratch) give what one
    launch gives."""
    dev = _card()
    prob = (problems.random_3regular_maxcut(16384, 0, device=dev) if name == "maxcut16384"
            else _lattice(50, "cuda"))
    tabs = (prob.nbr_idx, prob.nbr_w, prob.b)
    s = torch.randn((4, 5, prob.n), generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    whole, _ = _on_card(s, tabs)
    monkeypatch.setattr(sparse_gather, "INDEX_LIMIT", 7 * prob.n + 1)
    got, launched = _on_card(s, tabs)
    assert launched == {sparse_gather.energy_kernel(prob.n): 3}  # 7 + 7 + 6 rows
    assert torch.equal(got, whole)
    assert torch.equal(got, sparse_gather.energy_in_kernel_order(s, *tabs))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["maxcut16384", "ea50"])
def test_gaussian_couplings_and_states_stay_within_the_band_on_the_card(name):
    """On any values the kernel returns its emulated order bit for bit; the
    plain version, which sums the sites in its own order, stays within the
    band."""
    dev = _card()
    base = (problems.random_3regular_maxcut(16384, 0, device=dev) if name == "maxcut16384"
            else _lattice(50, "cuda"))
    gen = torch.Generator(device=dev).manual_seed(7)
    live = base.nbr_idx != torch.arange(base.n, dtype=torch.int32, device=dev)[:, None]
    w = (torch.randn(base.nbr_w.shape, generator=gen, device=dev) * live).contiguous()
    prob = SparseIsing(base.nbr_idx, w, base.deg,
                       0.3 * torch.randn((base.n,), generator=gen, device=dev))
    s = torch.randn((8, prob.n), generator=gen, device=dev)
    got, _ = _on_card(s, (prob.nbr_idx, prob.nbr_w, prob.b))
    want = sparse_gather.energy_in_kernel_order(s, prob.nbr_idx, prob.nbr_w, prob.b)
    assert torch.equal(got, want), (got - want).abs().max()
    gap = (got.double() - prob.energy(s).double()).abs().cpu()
    on_cpu = SparseIsing(prob.nbr_idx.cpu(), prob.nbr_w.cpu(), prob.deg.cpu(), prob.b.cpu())
    assert bool((gap <= _band(s.cpu(), on_cpu)).all())


@pytest.mark.cuda
def test_a_graphed_first_hit_run_equals_the_plain_backend_on_the_card():
    dev = _card()
    prob = problems.random_3regular_maxcut(16384, 0, device=dev)
    target = float(prob.deg.sum()) / 2 * (1.0 - 2.0 * 0.85)
    kw = dict(n_steps=200, n_chains=64, first_hit=target, sample_every=50,
              schedule=sampler_api.geometric(0.3, 3.0))
    before = tracing.counts()
    got = run(prob, ColoredGibbs(), 2147483931, backend="cuda", **kw)
    torch.cuda.synchronize()
    assert tracing.counts()["launch.sparse_energy"] - before["launch.sparse_energy"] == 1 + 200 + 1
    want = run(prob, ColoredGibbs(), 2147483931, backend="ref", **kw)
    for field in ("s", "samples", "energies", "t_hit", "hit"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
