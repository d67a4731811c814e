"""Many disorder samples in one call: a `SparseIsing` whose couplings are
(S, n, D), S samples over one neighbour table and colouring, the B chains
sample-major (row r on sample r // (B / S)).

Here on the CPU, at L = 4 with S = 3 samples of 2 replicas: `run()` under
`ColoredGibbs` on both backends' CPU paths against the benchmark's plain
reference (`bench/reference/ea3d_samples.py`) bit for bit; S identical
samples against the one-table problem bit for bit; what raises (an
n_chains that S does not divide, any other kernel, a fault model, the
long-row route, the fault operands, the fields kernel); the per-sample plan
and what `check_plan` refuses; the wrappers' routes and launch counts,
the energy's chunks included; the per-sample kernel's walk over the plan
emulated in plain torch against the plain version; `SparseIsing`'s
per-sample fields, energy and validation. On the card (marked `cuda`) the
two kernels against their plain versions and `run()` against the plain
backend. This file imports no JAX, so it runs there."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import sampler_api
from repro_torch.core.faults import FaultModel
from repro_torch.core.sampler_api import ColoredGibbs, NonFiniteEnergyError, run
from repro_torch.core.sparse import SparseIsing
from repro_torch.kernels import ops, ref, sparse_gather
from repro_torch.kernels._checks import MAX_SMEM_BYTES

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from bench import program  # noqa: E402
from bench.common import load_module  # noqa: E402

torch.set_num_threads(1)

ea3d_samples = load_module("reference", "ea3d_samples")
CONFIG = {"L": 4, "samples": 3}
S, REPLICAS = 3, 2
B = S * REPLICAS
BETA = 1.4285714


def _instance(seed=2**31 + 34):
    return ea3d_samples.instance(CONFIG, None, seed, "cpu")


def _problem(seed=2**31 + 34):
    return program.problem(ea3d_samples.KIND, _instance(seed))


def _one_table(prob, k=0):
    return dataclasses.replace(prob, nbr_w=prob.nbr_w[k].contiguous())


def _ring(n, S, C=2):
    """A ring of n sites (two neighbours and a pad), S samples of +-1
    couplings (each edge's the same both ways) and C = 2 alternating masks."""
    i = torch.arange(n)
    g = torch.Generator().manual_seed(n)
    j = torch.where(torch.rand((S, n), generator=g) < 0.5, 1.0, -1.0)  # edge (i, i + 1)
    idx = torch.stack([(i - 1) % n, (i + 1) % n, i], 1).to(torch.int32)
    w = torch.stack([j[:, (i - 1) % n], j, torch.zeros((S, n))], 2).contiguous()
    masks = torch.stack([(i % 2 == 0), (i % 2 == 1)]) if C == 2 else torch.ones((1, n), dtype=bool)
    return SparseIsing(nbr_idx=idx, nbr_w=w, deg=torch.full((n,), 2, dtype=torch.int32),
                       b=torch.zeros(n), color_masks=masks)


def _replay(inst, seed, steps, every, first_hit=None):
    """The reference's chains from `seed`: final states, samples, their
    float64 energies, and each step's energy where first_hit is given."""
    model = ea3d_samples.Model(CONFIG, inst, {"name": "colored_gibbs"})
    gen = torch.Generator().manual_seed(seed)
    s = model.init(gen, B)
    samples, e_steps = [], [model.energies(s)]
    for k in range(steps):
        s = model.step(s, torch.full((B,), BETA), gen)
        e_steps.append(model.energies(s))
        if (k + 1) % every == 0:
            samples.append(s)
    samples = torch.stack(samples, 1)
    return s, samples, model.energies(samples), torch.stack(e_steps)


@pytest.fixture
def no_card(monkeypatch):
    """The wrappers on CPU tensors: the device check passes and the launches
    are recorded (with the rows a sample and the first row) instead of run."""
    calls = []
    monkeypatch.setattr(sparse_gather, "check_cuda", lambda t: t.device)
    monkeypatch.setattr(sparse_gather, "_launch_sweep",
                        lambda *a, **k: calls.append(("sweep",)))
    monkeypatch.setattr(sparse_gather, "_launch_sweep_samples",
                        lambda s, plan, u, beta, out, threads, dev:
                        calls.append(("sweep_samples", s.shape[0] // plan.n_samples)))
    monkeypatch.setattr(sparse_gather, "_launch_energy",
                        lambda *a, **k: calls.append(("energy",)))
    monkeypatch.setattr(sparse_gather, "_launch_energy_samples",
                        lambda s, idx, w, b, out, rps, first, dev:
                        calls.append(("energy_samples", s.shape[0], rps, first)))
    monkeypatch.setattr(sparse_gather, "_launch_fields", lambda *a, **k: calls.append(("fields",)))
    return calls


# ---------------------------------------------------------------------------
# run() against the plain reference, and against one-table runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("first_hit", [None, -40.0])
def test_run_equals_the_reference(backend, first_hit):
    """Both backends' CPU paths (cuda: the ops wrappers' plain versions) give
    the reference's states, samples and energies, and first-hit flags where
    the reference's per-step energies reach the target."""
    inst = _instance()
    prob = program.problem(ea3d_samples.KIND, inst)
    steps, every = 8, 2
    res = run(prob, ColoredGibbs(), 12345, n_steps=steps, n_chains=B, backend=backend,
              schedule=sampler_api.constant(BETA), sample_every=every, first_hit=first_hit)
    s, samples, energies, e_steps = _replay(inst, 12345, steps, every)
    assert torch.equal(res.s, s)
    assert torch.equal(res.samples, samples)
    np.testing.assert_array_equal(res.energies.double().numpy(), energies.numpy())
    if first_hit is not None:
        assert torch.equal(res.hit, (e_steps <= first_hit).any(0))


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_identical_samples_equal_the_one_table_run(backend):
    """S copies of one sample's couplings run as the one-table problem does,
    bit for bit: the per-sample path changes nothing but whose couplings a
    row reads."""
    one = _one_table(_problem())
    same = dataclasses.replace(one, nbr_w=one.nbr_w.expand(S, *one.nbr_w.shape).contiguous())
    kw = dict(n_steps=6, n_chains=B, backend=backend, schedule=sampler_api.geometric(0.3, 3.0),
              sample_every=3, first_hit=-30.0)
    a, b = run(one, ColoredGibbs(), 7, **kw), run(same, ColoredGibbs(), 7, **kw)
    for field in ("s", "samples", "energies", "hit", "t_hit"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


def test_samples_differ_and_each_row_runs_on_its_own_sample():
    """Rows of different samples see different couplings: chain r of the
    batch equals chain r of the one-table run of its own sample and differs,
    for some r, from the run of another sample."""
    prob = _problem()
    assert not torch.equal(prob.nbr_w[0], prob.nbr_w[1])
    kw = dict(n_steps=5, n_chains=B, backend="ref", schedule=sampler_api.constant(BETA))
    batch = run(prob, ColoredGibbs(), 99, **kw)
    for k in range(S):
        alone = run(_one_table(prob, k), ColoredGibbs(), 99, **kw)
        rows = slice(k * REPLICAS, (k + 1) * REPLICAS)
        assert torch.equal(batch.s[rows], alone.s[rows])
    other = run(_one_table(prob, 0), ColoredGibbs(), 99, **kw)
    assert not torch.equal(batch.s[REPLICAS:], other.s[REPLICAS:])


# ---------------------------------------------------------------------------
# What raises
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_chains", [1, 4, 5])
def test_n_chains_that_the_samples_do_not_divide_raises(n_chains):
    with pytest.raises(ValueError, match="no multiple of the problem's 3 disorder samples"):
        run(_problem(), ColoredGibbs(), 1, n_steps=2, n_chains=n_chains)


@pytest.mark.parametrize("kernel", ["tau_leap", "ctmc", "random_scan_gibbs"])
def test_other_kernels_raise_on_per_sample_couplings(kernel):
    with pytest.raises(NotImplementedError, match="run under 'colored_gibbs' only"):
        run(_problem(), kernel, 1, n_steps=2, n_chains=B)


@pytest.mark.parametrize("faults", [FaultModel(field_noise_std=0.1), FaultModel(dropout=0.1),
                                    FaultModel()])
def test_a_fault_model_raises_on_per_sample_couplings(faults):
    with pytest.raises(NotImplementedError, match="fault model"):
        run(_problem(), ColoredGibbs(), 1, n_steps=2, n_chains=B, faults=faults)


def test_the_long_row_route_raises_on_per_sample_couplings():
    """n = 116226 sites take the long-row sweep, which reads one table:
    `init` raises on the cuda backend before any sweep; the plain backend
    runs."""
    n = MAX_SMEM_BYTES // 2 + 2
    prob = _ring(n, 2)
    with pytest.raises(NotImplementedError, match="long-row sweep"):
        run(prob, ColoredGibbs(), 1, n_steps=1, n_chains=2, backend="cuda")
    res = run(prob, ColoredGibbs(), 1, n_steps=1, n_chains=2, backend="ref")
    assert res.s.shape == (2, n)


def test_the_wrappers_refuse_the_long_row_faults_and_fields(no_card, launched):
    n = MAX_SMEM_BYTES // 2 + 2
    prob = _ring(n, 2)
    s, masks, beta = torch.ones((2, n)), prob.color_masks.float(), torch.ones(2)
    tables = (prob.nbr_idx, prob.nbr_w, prob.b)
    with pytest.raises(NotImplementedError, match="long-row sweep"):
        sparse_gather.colored_gibbs_sweep(s, *tables, torch.rand((2, 2, n)), masks, beta)
    short = _problem()
    s, masks = torch.ones((B, short.n)), short.color_masks.float()
    tables = (short.nbr_idx, short.nbr_w, short.b)
    u, beta = torch.rand((2, B, short.n)), torch.ones(B)
    for kw in ({"bias_rows": torch.zeros((B, short.n))}, {"keep": torch.ones((B, short.n),
                                                                              dtype=torch.bool)}):
        with pytest.raises(NotImplementedError, match="fault variant"):
            sparse_gather.colored_gibbs_sweep(s, *tables, u, masks, beta, **kw)
    with pytest.raises(NotImplementedError, match="no per-sample route"):
        sparse_gather.sparse_fields(s, *tables)
    with pytest.raises(ValueError, match="multiple of 3"):
        sparse_gather.colored_gibbs_sweep(s[:4], *tables, u[:, :4].contiguous(), masks, beta[:4])
    with pytest.raises(ValueError, match="multiple of 3"):
        sparse_gather.sparse_energy(s[:4], *tables)
    assert no_card == [] and not launched()


def test_one_table_operations_raise_on_per_sample_couplings():
    prob = _problem()
    with pytest.raises(NotImplementedError, match="one table of couplings"):
        prob.to_dense()
    with pytest.raises(NotImplementedError, match="one table of couplings"):
        prob.delta_fields(torch.ones(prob.n), 0)
    with pytest.raises(ValueError, match="multiple of 3"):
        prob.energy(torch.ones(prob.n))  # a state without its rows


def test_a_non_finite_coupling_of_one_sample_raises():
    prob = _problem()
    w = prob.nbr_w.clone()
    w[2, 5, 1] = float("nan")
    with pytest.raises(NonFiniteEnergyError, match="non-finite"):
        run(dataclasses.replace(prob, nbr_w=w), ColoredGibbs(), 1, n_steps=1, n_chains=B)


# ---------------------------------------------------------------------------
# The per-sample plan, and the wrappers' routes and counts
# ---------------------------------------------------------------------------


def test_the_per_sample_plan_holds_each_samples_weights():
    prob = _problem()
    masks = prob.color_masks.float()
    plan = sparse_gather.colour_plan(prob.nbr_idx, prob.nbr_w, prob.b, masks)
    L, P = prob.n, 8
    assert plan.per_sample and plan.n_samples == S
    assert plan.w.shape == (S, L, P) and plan.idx.shape == (L, P)
    for k in range(S):
        one = _one_table(prob, k)
        alone = sparse_gather.colour_plan(one.nbr_idx, one.nbr_w, one.b, masks)
        assert not alone.per_sample and alone.n_samples == 1
        assert torch.equal(plan.w[k], alone.w) and torch.equal(plan.idx, alone.idx)
        assert plan.counts == alone.counts and plan.independent
    sparse_gather.check_plan(plan, prob.nbr_idx, prob.nbr_w, prob.b, masks)
    one = _one_table(prob)
    alone = sparse_gather.colour_plan(one.nbr_idx, one.nbr_w, one.b, masks)
    with pytest.raises(ValueError, match="another nbr_w"):
        sparse_gather.check_plan(alone, prob.nbr_idx, prob.nbr_w, prob.b, masks)
    with pytest.raises(ValueError, match="plan.w must have shape"):
        sparse_gather.check_plan(plan._replace(w=plan.w[:2]), prob.nbr_idx, prob.nbr_w, prob.b,
                                 masks)


def test_colored_gibbs_init_builds_the_per_sample_plan_in_its_span():
    from repro_torch import tracing

    prob = _problem()
    before = tracing.counts()["sampler.colour_plans"]
    state = ColoredGibbs(backend="cuda").init(prob, torch.Generator().manual_seed(0), n_chains=B)
    masks, plan = state.aux
    assert plan.n_samples == S and plan.w.shape[0] == S
    assert tracing.counts()["sampler.colour_plans"] == before + 1


def test_the_sweep_wrapper_takes_one_per_sample_launch(no_card, launched):
    prob = _problem()
    masks = prob.color_masks.float()
    tables = (prob.nbr_idx, prob.nbr_w, prob.b)
    out = sparse_gather.colored_gibbs_sweep(torch.ones((B, prob.n)), *tables,
                                            torch.rand((2, B, prob.n)), masks, torch.ones(B))
    assert out.shape == (B, prob.n)
    assert no_card == [("sweep_samples", REPLICAS)]
    assert launched() == {"colored_gibbs_sweep_samples": 1}
    one = _one_table(prob)
    sparse_gather.colored_gibbs_sweep(torch.ones((B, prob.n)), one.nbr_idx, one.nbr_w, one.b,
                                      torch.rand((2, B, prob.n)), masks, torch.ones(B))
    assert no_card[-1] == ("sweep",)
    assert launched() == {"colored_gibbs_sweep_samples": 1, "colored_gibbs_sweep": 1}


@pytest.mark.parametrize("shape", [(B,), (B, 4)])
def test_the_energy_wrapper_takes_one_per_sample_launch(no_card, launched, shape):
    prob = _problem()
    rows = int(np.prod(shape))
    sparse_gather.sparse_energy(torch.ones(shape + (prob.n,)), prob.nbr_idx, prob.nbr_w, prob.b)
    assert no_card == [("energy_samples", rows, rows // S, 0)]
    assert launched() == {"sparse_energy_samples": 1}


def test_the_energy_wrapper_refuses_a_leading_axis_that_s_does_not_divide(no_card, launched):
    """(2, 2, n) states at S = 4: the flattened rows are 4, but the rows of
    the leading axis are not whole samples, so the wrapper refuses them as
    the plain version does."""
    prob = _ring(8, 4)
    s = torch.ones((2, 2, prob.n))
    for energy in (sparse_gather.sparse_energy, lambda *a: ops.sparse_energy(
            *a, mode="reference")):
        with pytest.raises(ValueError, match="multiple of 4"):
            energy(s, prob.nbr_idx, prob.nbr_w, prob.b)
    assert no_card == [] and not launched()


def test_the_energy_wrapper_launches_chunks_with_their_first_row(no_card, launched, monkeypatch):
    """Rows past INDEX_LIMIT elements go in chunks: each launch is told its
    first row, so a chunk that starts inside a sample reads the right
    couplings."""
    prob = _problem()
    monkeypatch.setattr(sparse_gather, "INDEX_LIMIT", 7 * prob.n + 1)  # 7 rows a chunk
    sparse_gather.sparse_energy(torch.ones((B, 4, prob.n)), prob.nbr_idx, prob.nbr_w, prob.b)
    assert no_card == [("energy_samples", 7, 8, r0) for r0 in range(0, 21, 7)] + [
        ("energy_samples", 3, 8, 21)]
    assert launched() == {"sparse_energy_samples": 4}


def test_the_energy_route_is_chosen_by_the_couplings():
    assert sparse_gather.energy_kernel(32768, True) == "sparse_energy_samples"
    assert sparse_gather.energy_kernel(512000, True) == "sparse_energy_samples"
    assert sparse_gather.energy_kernel(32768) == "sparse_energy"
    assert sparse_gather.energy_kernel(512000) == "sparse_energy_long"


# ---------------------------------------------------------------------------
# The kernels' arithmetic, emulated in plain torch
# ---------------------------------------------------------------------------


def _emulate_samples_sweep(s, plan, u, beta):
    """The per-sample kernel in plain torch: each row in int8, each colour's
    plan entries with the row's sample's weights (slots in order, an index
    outside [0, n) adding nothing), the phase's new spins written once all
    its fields are formed (the kernel's second buffer)."""
    rps = s.shape[0] // plan.n_samples
    out = torch.empty_like(s)
    for r in range(s.shape[0]):
        w_all = plan.w[r // rps]
        cur = torch.where(s[r] > 0, 1, -1).to(torch.int8)
        for c in range(len(plan.counts)):
            beg, end = int(plan.offsets[c]), int(plan.offsets[c + 1])
            idx, w, sites = plan.idx[beg:end], w_all[beg:end], plan.sites[beg:end].long()
            acc = torch.zeros(end - beg)
            for k in range(plan.D):
                j = idx[:, k].long()
                ok = (j >= 0) & (j < plan.n)
                acc = acc + torch.where(ok, w[:, k], 0.0) * cur[torch.where(ok, j, 0)].float()
            p = torch.sigmoid(-2.0 * (beta[r] * (acc + w[:, -1])))
            cur[sites] = torch.where(u[c, r, sites] < p, 1, -1).to(torch.int8)  # after the phase's fields
        out[r] = cur.float()
    return out


@pytest.mark.parametrize("graph", ["ea3d", "gaussian_ring"])
def test_the_per_sample_walk_equals_the_plain_version(graph):
    if graph == "ea3d":
        prob = _problem()
    else:  # non-integer couplings, a pad slot, packed plan rows (P = 4)
        ring = _ring(30, S)
        g = torch.Generator().manual_seed(5)
        scale = 0.3 + torch.rand((S, 30), generator=g)  # edge (i, i + 1)'s factor
        i = torch.arange(30)
        factor = torch.stack([scale[:, (i - 1) % 30], scale, torch.ones((S, 30))], 2)
        prob = dataclasses.replace(ring, nbr_w=(ring.nbr_w * factor).contiguous())
        prob.validate()
    masks = prob.color_masks.float()
    plan = sparse_gather.colour_plan(prob.nbr_idx, prob.nbr_w, prob.b, masks)
    g = torch.Generator().manual_seed(11)
    s = torch.where(torch.rand((B, prob.n), generator=g) < 0.5, 1.0, -1.0)
    u = torch.rand((masks.shape[0], B, prob.n), generator=g)
    beta = 0.3 + 2.7 * torch.rand(B, generator=g)
    want = ref.colored_gibbs_sweep_ref(s, prob.nbr_idx, prob.nbr_w, prob.b, u,
                                       prob.color_masks, beta)
    assert torch.equal(_emulate_samples_sweep(s, plan, u, beta), want)


def test_the_energy_in_kernel_order_is_per_row():
    """The per-sample kernel's order of summation, emulated, on +-1 states
    with +-1 couplings equals the plain energy of each row under its own
    sample's couplings; the order is the staged kernel's at one row a
    block."""
    prob = _problem()
    g = torch.Generator().manual_seed(3)
    s = torch.where(torch.rand((B, 2, prob.n), generator=g) < 0.5, 1.0, -1.0)
    got = sparse_gather.energy_in_kernel_order(s, prob.nbr_idx, prob.nbr_w, prob.b)
    assert got.shape == (B, 2)
    for r in range(B):
        one = _one_table(prob, r // REPLICAS)
        assert torch.equal(got[r], one.energy(s[r]))
        assert torch.equal(got[r], sparse_gather.energy_in_kernel_order(
            s[r], one.nbr_idx, one.nbr_w, one.b, kernel="sparse_energy"))
    assert torch.equal(got, ops.sparse_energy(s, prob.nbr_idx, prob.nbr_w, prob.b))


# ---------------------------------------------------------------------------
# SparseIsing with per-sample couplings
# ---------------------------------------------------------------------------


def test_per_sample_fields_and_energy_are_each_rows_own():
    prob = _problem()
    assert prob.per_sample and prob.n_samples == S and prob.n == 64 and prob.max_deg == 6
    one = _one_table(prob)
    assert not one.per_sample and one.n_samples == 1
    g = torch.Generator().manual_seed(4)
    s = torch.where(torch.rand((B, 3, prob.n), generator=g) < 0.5, 1.0, -1.0)
    h, e = prob.local_fields(s), prob.energy(s)
    assert h.shape == s.shape and e.shape == (B, 3)
    for r in range(B):
        alone = _one_table(prob, r // REPLICAS)
        assert torch.equal(h[r], alone.local_fields(s[r]))
        assert torch.equal(e[r], alone.energy(s[r]))


def test_validate_checks_every_sample():
    prob = _problem()
    prob.validate()
    bad = prob.nbr_w.clone()
    bad[2, 7, 3] *= -1.0  # one direction of one edge of sample 2
    with pytest.raises(ValueError, match=r"symmetric.*disorder sample 2"):
        dataclasses.replace(prob, nbr_w=bad).validate()
    with pytest.raises(ValueError, match="inconsistent shapes"):
        dataclasses.replace(prob, nbr_w=prob.nbr_w[:, :-1]).validate()


def test_the_reference_draws_each_samples_couplings_from_one_draw():
    """Sample k's couplings are row k of one (S, 3 n) uniform draw from the
    seed, on ea3d.edges' edge order; each sample symmetric; the colouring
    the parity classes."""
    ea3d = load_module("reference", "ea3d")
    seed = 2**31 + 34
    inst = _instance(seed)
    n = 64
    i, j = ea3d.edges(4, "cpu")
    J = torch.where(torch.rand((S, 3 * n), generator=torch.Generator().manual_seed(seed)) < 0.5,
                    1.0, -1.0)
    for k in range(S):
        dense = torch.zeros((n, n))
        dense[i, j] = J[k]
        dense[j, i] = J[k]
        rows = torch.arange(n)[:, None].expand(n, 6)
        got = torch.zeros((n, n))
        got[rows.flatten(), inst["nbr_idx"].long().flatten()] = inst["nbr_w"][k].flatten()
        assert torch.equal(got, dense)
    z, y, x = torch.meshgrid(*(torch.arange(4),) * 3, indexing="ij")
    parity = ((x + y + z) % 2).flatten()
    assert torch.equal(inst["color_masks"][0], parity == 0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_the_per_sample_kernels_equal_the_plain_versions_on_the_card():
    """On the card: three chained per-sample sweeps at L = 8, 4 samples x 3
    replicas, per-row beta, over the plan ColoredGibbs.init builds, bit for
    bit against the plain version, each call counted as the per-sample
    route; the energy of the states and of (B, 2, n) samples exactly; and
    run() against the plain backend."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an sm_90 card); chip_smoke.py checks it there")
    from repro_torch import tracing

    dev = torch.device("cuda")
    inst = ea3d_samples.instance({"L": 8, "samples": 4}, None, 2**31 + 8, dev)
    prob = program.problem(ea3d_samples.KIND, inst)
    rows, n = 12, prob.n
    gen = torch.Generator(device=dev).manual_seed(8)
    s = torch.where(torch.rand((rows, n), generator=gen, device=dev) < 0.5, 1.0, -1.0)
    beta = 0.3 + 2.7 * torch.rand((rows,), generator=gen, device=dev)
    masks, plan = ColoredGibbs(backend="cuda").init(prob, gen, s0=s, n_chains=rows).aux
    tables = (prob.nbr_idx, prob.nbr_w, prob.b)
    got = want = s
    before = tracing.counts()
    for _ in range(3):
        u = torch.rand((2, rows, n), generator=gen, device=dev)
        got = sparse_gather.colored_gibbs_sweep(got, *tables, u, masks, beta, plan=plan)
        want = ops.colored_gibbs_sweep(want, *tables, u, masks, beta, mode="reference")
    assert torch.equal(got, want)
    both = torch.stack([got, -want], 1)
    assert torch.equal(sparse_gather.sparse_energy(both, *tables),
                       ops.sparse_energy(both, *tables, mode="reference"))
    after = tracing.counts()
    assert {k: v - before[k] for k, v in after.items() if k.startswith("launch.")
            and v != before[k]} == {"launch.colored_gibbs_sweep_samples": 3,
                                    "launch.sparse_energy_samples": 1}
    kw = dict(n_steps=10, n_chains=rows, sample_every=5, schedule=sampler_api.constant(BETA))
    a = run(prob, ColoredGibbs(), 88, backend="cuda", **kw)
    b = run(prob, ColoredGibbs(), 88, backend="ref", **kw)
    for field in ("s", "samples", "energies"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field
