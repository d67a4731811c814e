"""The lattice energy kernel (`csrc/lattice_energy.cu`): run()'s first-hit,
start and recorded energy under `ChromaticGibbs(backend="cuda")`.

The kernel runs only on the card, so here: its order of summation emulated
in plain torch (`lattice_gibbs.energy_in_kernel_order`: each site's eight
neighbours in KING_OFFSETS order, a lane's or thread's sites in turn, the
shuffle tree, on the block route the warps in turn) and held against
`LatticeIsing.energy`, bit for bit on +-1 states with integer couplings,
within a stated band otherwise; the plain version `ref.lattice_energy_ref`
and `ops.lattice_energy` on the CPU; the wrapper with its launcher replaced
(its checks, its launch counter); and which energy `run()`
takes. On the card (marked `cuda`) the kernel itself against the emulation,
bit for bit on finite values, and against the plain version, and a graphed
`run()` against the plain backend. This file imports no JAX, so it runs
there."""
import math
import re
from pathlib import Path

import pytest
import torch

from repro_torch import tracing
from repro_torch.core import problems, sampler_api
from repro_torch.core.ising import LatticeIsing
from repro_torch.core.sampler_api import ChromaticGibbs, ColoredGibbs, TauLeap, run
from repro_torch.kernels import lattice_gibbs, ops, ref, sparse_gather
from repro_torch.kernels._checks import MAX_SMEM_BYTES

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
EPS = 2.0**-23  # float32 eps: twice the unit roundoff

torch.set_num_threads(1)


def _lattice(w, b):
    H, W = b.shape
    return LatticeIsing(w=w, b=b, clamp_mask=torch.zeros((H, W), dtype=torch.bool),
                        clamp_value=torch.ones((H, W)),
                        dead_mask=torch.zeros((H, W), dtype=torch.bool))


def _pm1(shape, seed, dev=CPU):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.where(torch.rand(shape, generator=g, device=dev) < 0.5, 1.0, -1.0)


def _integer(H, W, seed, weights="pm1", dev=CPU):
    """A lattice with +-1 or integer weights in [-3, 3] on every plane, the
    edges' too (their neighbour is 0), and a zero or integer bias: every
    partial sum of the energy stays an integer."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if weights == "pm1":
        w = _pm1((8, H, W), seed + 1, dev)
        b = torch.zeros((H, W), device=dev)
    else:
        w = torch.randint(-3, 4, (8, H, W), generator=g, device=dev).float()
        b = torch.randint(-2, 3, (H, W), generator=g, device=dev).float()
    return w, b


def _gaussian(H, W, seed, dev=CPU):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((8, H, W), generator=g, device=dev),
            0.3 * torch.randn((H, W), generator=g, device=dev))


def _band(s, w, b):
    """The widest gap two orders of summation allow. Every term is
    bit-equal in both, so only the sums over the n sites differ: any order
    of n - 1 rounded adds of terms x_p is within (n - 1) u sum|x_p| of the
    exact sum (u = 2^-24), so two orders within 2 (n - 1) u sum|x_p| <
    n EPS sum|x_p| of each other; the halving is exact and the last add
    rounds once more in each, within EPS |E|."""
    s64 = s.double()
    pair = s64 * ref.king_sum(s64, w.double())
    field = b.double() * s64
    n = s.shape[-2] * s.shape[-1]
    e = (0.5 * pair.sum((-2, -1)) + field.sum((-2, -1))).abs()
    return EPS * (n * (0.5 * pair.abs().sum((-2, -1)) + field.abs().sum((-2, -1))) + e)


# ---------------------------------------------------------------------------
# The plain version and the kernel's order, emulated
# ---------------------------------------------------------------------------

SHAPES = [(16, 16), (5, 7), (1, 1), (3, 13)]
LEADS = [(), (3,), (2, 3)]


@pytest.mark.parametrize("weights", ["pm1", "integer"])
@pytest.mark.parametrize("lead", LEADS)
@pytest.mark.parametrize("shape", SHAPES)
def test_the_plain_version_and_the_kernels_order_equal_the_energy(shape, lead, weights):
    w, b = _integer(*shape, sum(shape), weights)
    prob = _lattice(w, b)
    s = _pm1(lead + shape, len(lead) + 7)
    want = prob.energy(s)
    assert want.shape == lead
    for got in (ref.lattice_energy_ref(s, w, b), ops.lattice_energy(s, w, b),
                ops.lattice_energy(s, w, b, mode="reference"),
                lattice_gibbs.energy_in_kernel_order(s, w, b)):
        assert got.shape == lead and got.dtype == torch.float32
        assert torch.equal(got, want)


@pytest.mark.parametrize("route", ["quads", "block"])
@pytest.mark.parametrize("shape", [(16, 16), (4, 8), (2, 128), (8, 32), (3, 4), (20, 30)])
def test_on_cal_every_route_gives_the_energy(shape, route):
    """CAL itself (16x16), and both routes' orders on +-1 lattices around
    it (the quad route's at widths it takes), on +-1 states: bit for bit."""
    if route == "quads" and (shape[1] not in lattice_gibbs.ENERGY_QUAD_WIDTHS
                             or math.prod(shape) > lattice_gibbs.ENERGY_QUAD_SITES):
        return
    prob = (problems.cal_problem(device=CPU) if shape == (16, 16)
            else _lattice(*_integer(*shape, 5)))
    s = _pm1((64,) + shape, 1)
    got = lattice_gibbs.energy_in_kernel_order(s, prob.w, prob.b, route)
    assert torch.equal(got, prob.energy(s))


@pytest.mark.parametrize("shape, route", [
    ((16, 16), "quads"), ((8, 8), "quads"), ((2, 128), "quads"), ((1, 4), "quads"),
    ((64, 4), "quads"), ((8, 32), "quads"),
    ((17, 16), "block"),  # 272 sites: more than two quads a lane
    ((16, 12), "block"), ((5, 7), "block"), ((3, 13), "block"), ((1, 1), "block"),
    ((1, 256), "block"), ((200, 200), "block"),
])
def test_the_route_is_chosen_by_the_lattice(shape, route):
    assert lattice_gibbs.ENERGY_QUAD_SITES == 256
    s = torch.zeros((3,) + shape)
    assert lattice_gibbs.energy_route(s, *shape) == route


def test_states_off_16_bytes_take_the_block_route():
    """A view that starts 4 bytes into its storage cannot load a quad as
    one 16-byte word."""
    s = torch.zeros(3 * 256 + 1)[1:].view(3, 16, 16)
    assert s.data_ptr() % 16 != 0
    assert lattice_gibbs.energy_route(s, 16, 16) == "block"
    with pytest.raises(ValueError, match="no energy route"):
        lattice_gibbs.energy_in_kernel_order(s, *_integer(16, 16, 0), route="atomic")


@pytest.mark.parametrize("states", ["pm1", "gaussian"])
@pytest.mark.parametrize("shape", [(16, 16), (5, 7), (3, 13), (40, 40)])
def test_on_gaussian_weights_the_kernels_order_stays_within_the_band(shape, states):
    w, b = _gaussian(*shape, 3)
    s = (_pm1((6,) + shape, 4) if states == "pm1"
         else torch.randn((6,) + shape, generator=torch.Generator().manual_seed(4)))
    want = _lattice(w, b).energy(s)
    assert torch.equal(ref.lattice_energy_ref(s, w, b), want)
    assert torch.equal(ops.lattice_energy(s, w, b), want)
    gap = (lattice_gibbs.energy_in_kernel_order(s, w, b).double() - want.double()).abs()
    assert bool((gap <= _band(s, w, b)).all()), (gap, _band(s, w, b))


@pytest.mark.parametrize("shape", [(16, 16), (40, 40)])
def test_the_band_is_not_idle(shape):
    """On Gaussian weights the two orders do differ, and by much less than
    the band: it is a bound, not a tolerance tuned to the gap."""
    w, b = _gaussian(*shape, 5)
    s = _pm1((64,) + shape, 6)
    gap = (lattice_gibbs.energy_in_kernel_order(s, w, b).double()
           - _lattice(w, b).energy(s).double()).abs()
    assert bool((gap > 0).any())
    assert bool((gap < 0.1 * _band(s, w, b)).all())


def test_the_emulation_reads_the_kernels_own_constants():
    """The quad route's quads a lane and the block's threads are the
    source's: an emulation with other numbers would sum in another order."""
    src = (REPO / "src/repro_torch/kernels/csrc/lattice_energy.cu").read_text()

    def const(name):
        (value,) = re.findall(rf"constexpr int {name} = (\d+);", src)
        return int(value)

    assert 128 * const("kQuadGroups") == lattice_gibbs.ENERGY_QUAD_SITES
    assert 32 * const("kMaxWarps") == sparse_gather.BLOCK_THREADS  # `_block_threads`' cap
    assert "W >= 4 && W <= 128 && (W & (W - 1)) == 0" in src  # ENERGY_QUAD_WIDTHS


# ---------------------------------------------------------------------------
# The wrapper, its launcher replaced
# ---------------------------------------------------------------------------


@pytest.fixture
def no_card(monkeypatch):
    """The wrapper on CPU tensors: the device check passes, and each launch
    is recorded and computed by its emulation."""
    calls = []

    def launch(s, w, b, out, route, dev):
        out.copy_(lattice_gibbs.energy_in_kernel_order(s, w, b, route).reshape(-1))
        calls.append({"shape": tuple(s.shape), "rows": out.shape[0], "route": route})

    monkeypatch.setattr(lattice_gibbs, "check_cuda", lambda t: t.device)
    monkeypatch.setattr(lattice_gibbs, "_launch_energy", launch)
    return calls


@pytest.mark.parametrize("lead", LEADS + [(2, 2, 2)])
@pytest.mark.parametrize("shape", SHAPES)
def test_the_wrapper_takes_any_leading_dimensions_and_counts_its_launch(no_card, launched, lead,
                                                                         shape):
    w, b = _integer(*shape, 2, "integer")
    s = _pm1(lead + shape, 3)
    out = lattice_gibbs.lattice_energy(s, w, b)
    assert out.shape == lead and out.dtype == torch.float32
    assert no_card == [{"shape": lead + shape, "rows": math.prod(lead),
                        "route": lattice_gibbs.energy_route(s, *shape)}]
    assert launched() == {"lattice_energy": 1}
    assert torch.equal(out, _lattice(w, b).energy(s))


def test_the_counter_reaches_tracing(no_card):
    before = tracing.counts()
    w, b = _integer(16, 16, 0)
    for rows in (4096, 1, 7):
        lattice_gibbs.lattice_energy(_pm1((rows, 16, 16), rows), w, b)
    after = tracing.counts()
    assert {k: n - before[k] for k, n in after.items() if n != before[k]} == {
        "launch.lattice_energy": 3}


def test_the_wrapper_launches_nothing_for_no_rows(no_card, launched):
    w, b = _integer(16, 16, 0)
    out = lattice_gibbs.lattice_energy(torch.ones((0, 16, 16)), w, b)
    assert out.shape == (0,) and no_card == [] and not launched()
    out = lattice_gibbs.lattice_energy(torch.ones((2, 0, 16, 16)), w, b)
    assert out.shape == (2, 0) and no_card == [] and not launched()


@pytest.mark.parametrize("bad", ["f64", "bf16", "w_bf16", "w_planes", "w_shape", "b_shape",
                                 "strided", "w_strided", "flat"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(no_card, launched, bad):
    w, b = _integer(16, 16, 1)
    s = _pm1((4, 16, 16), 4)
    if bad == "f64":
        s = s.double()
    elif bad == "bf16":
        s = s.bfloat16()
    elif bad == "w_bf16":
        w = w.bfloat16()
    elif bad == "w_planes":
        w = w[:7].contiguous()
    elif bad == "w_shape":
        w = w[:, :, :15].contiguous()
    elif bad == "b_shape":
        b = b[:15].contiguous()
    elif bad == "strided":
        s = _pm1((16, 16, 4), 4).permute(2, 0, 1)
    elif bad == "w_strided":
        w = w.transpose(1, 2)
    else:
        s = s.reshape(-1)
    with pytest.raises(ValueError):
        lattice_gibbs.lattice_energy(s, w, b)
    assert no_card == [] and not launched()


def test_the_wrapper_takes_a_lattice_beyond_the_sweeps_limit(no_card, launched):
    """The sweep's limit (an int8 chain and its halos in a block's shared
    memory) is not the energy's: the block route stages no chain, so the
    largest lattice the sweep takes and one row more are both launched."""
    for H, W, swept in ((481, 481, True), (482, 482, False)):
        assert (H * W + 2 * lattice_gibbs.halo_bytes(W) <= MAX_SMEM_BYTES) == swept
        w, b = _integer(H, W, 0)
        s = _pm1((1, H, W), 1)
        assert torch.equal(lattice_gibbs.lattice_energy(s, w, b), _lattice(w, b).energy(s))
    assert [c["route"] for c in no_card] == ["block", "block"]
    assert launched() == {"lattice_energy": 2}


def test_the_wrapper_refuses_cpu_tensors_without_a_card():
    w, b = _integer(16, 16, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lattice_gibbs.lattice_energy(_pm1((2, 16, 16), 5), w, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.lattice_energy(_pm1((2, 16, 16), 5), w, b, mode="kernel")


def test_ops_takes_the_plain_version_on_the_cpu(monkeypatch):
    def refuse(*args):
        raise AssertionError("the kernel's wrapper was called on CPU tensors")

    monkeypatch.setattr(lattice_gibbs, "lattice_energy", refuse)
    cal = problems.cal_problem(device=CPU)
    s = _pm1((5, 16, 16), 7)
    for mode in ("auto", "reference"):
        assert torch.equal(ops.lattice_energy(s, cal.w, cal.b, mode=mode), cal.energy(s))


# ---------------------------------------------------------------------------
# The energy run() takes
# ---------------------------------------------------------------------------


@pytest.fixture
def energy_calls(monkeypatch):
    """Every call of ops.lattice_energy, by the shape of its states."""
    calls = []
    plain = ops.lattice_energy

    def spy(s, *args, **kw):
        calls.append(tuple(s.shape))
        return plain(s, *args, **kw)

    monkeypatch.setattr(ops, "lattice_energy", spy)
    return calls


@pytest.mark.parametrize("first_hit, diagnostics", [(True, False), (False, True), (True, True)])
def test_a_cuda_chromatic_run_takes_its_energies_from_ops(energy_calls, first_hit, diagnostics):
    cal = problems.cal_problem(device=CPU)
    kw = dict(n_steps=12, n_chains=4, first_hit=-900.0 if first_hit else None, sample_every=4,
              schedule=sampler_api.geometric(0.3, 3.0), diagnostics=diagnostics)
    got = run(cal, ChromaticGibbs(), 21, backend="cuda", **kw)
    # the first state, every step, the three recorded samples
    assert energy_calls == [(4, 16, 16)] * 13 + [(4, 3, 16, 16)]
    energy_calls.clear()
    want = run(cal, ChromaticGibbs(), 21, backend="ref", **kw)
    assert energy_calls == []
    for field in ("s", "samples", "times", "energies", "t_hit", "hit"):
        if getattr(want, field) is not None:
            assert torch.equal(getattr(got, field), getattr(want, field)), field
    if diagnostics:
        for a, b in zip(got.diagnostics, want.diagnostics):
            assert torch.equal(a, b)


@pytest.mark.parametrize("sample_every, calls", [(5, [(3, 16, 16), (3, 2, 16, 16)]),
                                                 (0, [(3, 16, 16)])])
def test_without_first_hit_a_run_takes_the_start_and_the_samples(energy_calls, sample_every,
                                                                 calls):
    cal = problems.cal_problem(device=CPU)
    run(cal, ChromaticGibbs(), 4, backend="cuda", n_steps=10, n_chains=3,
        sample_every=sample_every)
    assert energy_calls == calls


def test_the_energy_is_chosen_once_per_run():
    cal = problems.cal_problem(device=CPU)
    cuda = sampler_api._make_run(cal, ChromaticGibbs(), 0, n_steps=3, backend="cuda")
    plain = sampler_api._make_run(cal, ChromaticGibbs(), 0, n_steps=3, backend="ref")
    assert cuda.energy is not cal.energy
    assert plain.energy == cal.energy
    s = _pm1((2, 16, 16), 9)
    assert torch.equal(cuda.energy(s), cal.energy(s))


def test_a_bf16_lattice_keeps_its_own_energy():
    cal = problems.cal_problem(device=CPU)
    half = LatticeIsing(cal.w.bfloat16(), cal.b.bfloat16(), cal.clamp_mask,
                        cal.clamp_value.bfloat16(), cal.dead_mask)
    assert ChromaticGibbs(backend="cuda").energy_fn(half) is None
    assert ChromaticGibbs(backend="cuda").energy_fn(cal) is not None
    assert ChromaticGibbs(backend="ref").energy_fn(cal) is None


def test_other_kernels_keep_their_own_energy(energy_calls):
    cal = problems.cal_problem(device=CPU)
    run(cal, ChromaticGibbs(), 1, backend="ref", n_steps=5, n_chains=2, first_hit=-900.0,
        sample_every=1)
    run(cal, TauLeap(dt=0.1), 1, n_steps=5, n_chains=2, first_hit=-900.0, sample_every=1)
    sparse = problems.random_3regular_maxcut(64, 5, device=CPU)
    run(sparse, ColoredGibbs(), 1, backend="cuda", n_steps=5, n_chains=2, first_hit=-50.0,
        sample_every=1)
    assert energy_calls == []


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an sm_90 card); chip_smoke.py checks it there")
    return torch.device("cuda")


def _on_card(s, w, b):
    """The kernel's energies and the launches it counted."""
    before = tracing.counts()
    got = lattice_gibbs.lattice_energy(s, w, b)
    torch.cuda.synchronize()
    return got, {k.removeprefix("launch."): n - before[k] for k, n in tracing.counts().items()
                 if k.startswith("launch.") and n != before[k]}


CARD_SHAPES = [(4096, 16, 16), (40960, 16, 16), (3, 7, 13), (1, 200, 200), (65, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_the_kernel_equals_the_plain_version_on_pm1_lattices_on_the_card(shape):
    dev = _card()
    cal = problems.cal_problem(device=dev)
    w, b = (cal.w, cal.b) if shape[1:] == (16, 16) else _integer(*shape[1:], 3, dev=dev)
    s = _pm1(shape, sum(shape), dev)
    got, launched = _on_card(s, w, b)
    assert launched == {"lattice_energy": 1}
    assert torch.equal(got, ref.lattice_energy_ref(s, w, b))
    assert torch.equal(got, lattice_gibbs.energy_in_kernel_order(s, w, b))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_gaussian_weights_stay_within_the_band_on_the_card(shape):
    """On finite values the kernel returns its emulated order bit for bit; the
    plain version, which sums the sites in its own order, stays within the
    band."""
    dev = _card()
    w, b = _gaussian(*shape[1:], 7, dev)
    s = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(8), device=dev)
    got, _ = _on_card(s, w, b)
    want = lattice_gibbs.energy_in_kernel_order(s, w, b)
    assert torch.equal(got, want), (got - want).abs().max()
    gap = (got.double() - ref.lattice_energy_ref(s, w, b).double()).abs()
    assert bool((gap <= _band(s, w, b)).all())


@pytest.mark.cuda
def test_a_graphed_first_hit_cal_run_equals_the_plain_backend_on_the_card():
    dev = _card()
    cal = problems.cal_problem(device=dev)
    target = float(cal.energy(torch.as_tensor(problems.cal_template(), device=dev)))
    kw = dict(n_steps=200, n_chains=512, first_hit=target, sample_every=50,
              schedule=sampler_api.geometric(0.3, 3.0))
    before = tracing.counts()
    got = run(cal, ChromaticGibbs(), 2147483931, backend="cuda", **kw)
    torch.cuda.synchronize()
    assert tracing.counts()["launch.lattice_energy"] - before["launch.lattice_energy"] == 1 + 200 + 1
    want = run(cal, ChromaticGibbs(), 2147483931, backend="ref", **kw)
    for field in ("s", "samples", "energies", "t_hit", "hit"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
