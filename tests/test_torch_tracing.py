"""`repro_torch.tracing`: spans and counters at the driver's layer boundaries,
on only while a torch profiler records, and never changing a result."""
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core import boltzmann, ising, problems, sampler_api
from repro_torch.core.graph_loop import GRAPH_STEPS, plan_blocks
from repro_torch.data import digits
from repro_torch.kernels import _build, dense_field, flash_attention, lattice_gibbs, sparse_gather
from repro_torch.kernels import ctmc_event, tau_leap

CPU = "cpu"


def _dense():
    rng = np.random.default_rng(0)
    J = np.triu(rng.normal(0, 0.6, (12, 12)), 1)
    return ising.DenseIsing.from_numpy(J + J.T, rng.normal(0, 0.3, 12), device=CPU)


# (problem, kernel, run keywords): a dense tau-leap run that records samples,
# and a lattice chromatic Gibbs run that tracks first hit
RUNS = {
    "dense": (_dense, sampler_api.TauLeap(dt=0.1),
              dict(n_steps=70, n_chains=4, sample_every=20, schedule=sampler_api.geometric(0.3, 3.0))),
    "lattice": (lambda: problems.cal_problem(coupling=0.5, device=CPU), sampler_api.ChromaticGibbs(),
                dict(n_steps=40, n_chains=3, sample_every=0, first_hit=-100.0)),
}


def _run(name, seed=3):
    make, kernel, kw = RUNS[name]
    return sampler_api.run(make(), kernel, seed, **kw)


def _profiled(fn):
    """fn() under a CPU torch profiler: (its result, the call records it
    added, the names of the trace's user annotations in order)."""
    last = max((r["id"] for r in tracing.calls()), default=-1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    records = [r for r in tracing.calls() if r["id"] > last]
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.activity_type() == "user_annotation"), key=lambda e: e.start_ns())
    return out, records, [e.name() for e in events]


def _cd_setup():
    cfg = boltzmann.CDConfig(lr=0.08, n_model_steps=24, n_chains=8, quantize_bits=8)
    gen = torch.Generator().manual_seed(2)
    state = boltzmann.init_cd(gen, 16, 16, cfg, device=CPU)
    batch = digits.digit_batch(3, n=16, generator=torch.Generator().manual_seed(1),
                               flip_prob=0.05, device=CPU)
    return state, batch, cfg


def _cd_step():
    state, batch, cfg = _cd_setup()
    return boltzmann.cd_step(state, batch, torch.Generator().manual_seed(0), cfg)


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not tracing.recording()
    a, b = tracing.span("sampler.run"), tracing.span("boltzmann.model")
    assert a is b
    before = tracing.calls()
    with a:
        _run("dense")
    assert tracing.calls() == before


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_spans_are_user_annotations_nested_as_documented(name):
    _, (record,), annotations = _profiled(lambda: _run(name))
    assert record["name"] == "sampler.run"
    spans = record["spans"]
    assert all(s["parent"] == record["id"] and s["root"] == record["id"] for s in spans)
    assert [s["start_ns"] for s in spans] == sorted(s["start_ns"] for s in spans)
    assert all(record["start_ns"] <= s["start_ns"] <= s["end_ns"] <= record["end_ns"] for s in spans)
    blocks = len(plan_blocks(RUNS[name][2]["n_steps"], RUNS[name][2]["sample_every"], GRAPH_STEPS))
    order = [s["name"] for s in spans]
    assert order == ["sampler.validate", "sampler.init"] + ["sampler.eager"] * blocks + [
        "sampler.results", "sampler.release"]
    # on a torch whose kineto events say their activity the spans are in the
    # profiler's trace too
    assert annotations == (["sampler.run"] + order if tracing.MIRRORED else [])


def test_one_call_record_per_outermost_call_counts_its_blocks():
    _, records, _ = _profiled(lambda: [_run("dense", seed) for seed in (1, 2)])
    kw = RUNS["dense"][2]
    blocks = len(plan_blocks(kw["n_steps"], kw["sample_every"], GRAPH_STEPS))
    assert [r["name"] for r in records] == ["sampler.run", "sampler.run"]
    for r in records:
        c = r["counts"]
        assert c["sampler.calls"] == 1 and c["sampler.eager_blocks"] == blocks == 4
        assert c.get("sampler.captures", 0) == 0 and c.get("sampler.replays", 0) == 0
        assert not any(k.startswith("cuda.") for k in c)  # no allocator counters on the CPU
    # timeit's two passes are one call: twice the blocks, one validation, one release
    _, (r,), _ = _profiled(lambda: sampler_api.run(_dense(), RUNS["dense"][1], 1, timeit=True,
                                                   **kw))
    names = [s["name"] for s in r["spans"]]
    assert r["counts"]["sampler.eager_blocks"] == 2 * blocks and names.count("sampler.init") == 2
    assert names.count("sampler.validate") == 1 and names[-1] == "sampler.release"


@pytest.mark.parametrize("name", sorted(RUNS))
def test_a_repeated_call_takes_the_kept_run_without_the_probe(name, monkeypatch):
    """A call of a kept run's key: `sampler.validate` without the
    finite-energy probe, no capture, one `sampler.reuses`."""
    make, kernel, kw = RUNS[name]
    prob = make()
    probes = []
    probe = sampler_api._check_finite
    monkeypatch.setattr(sampler_api, "_check_finite", lambda p: probes.append(p) or probe(p))
    sampler_api.drop_kept_runs()
    try:
        _, records, _ = _profiled(lambda: [sampler_api.run(prob, kernel, seed, **kw)
                                           for seed in (1, 2)])
    finally:
        sampler_api.drop_kept_runs()
    assert probes == [prob]  # the first call's
    blocks = len(plan_blocks(kw["n_steps"], kw["sample_every"], GRAPH_STEPS))
    for record, reuses in zip(records, (0, 1)):
        assert record["counts"]["sampler.reuses"] == reuses
        assert record["counts"]["sampler.captures"] == 0  # the CPU runs every block eagerly
        assert [s["name"] for s in record["spans"]] == [
            "sampler.validate", "sampler.init"] + ["sampler.eager"] * blocks + [
            "sampler.results", "sampler.release"]


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_the_colour_plan_is_a_span_inside_init_and_counted(backend):
    """`ColoredGibbs` on the cuda backend builds its colour plan in
    `sampler.init`, inside a `sampler.colour_plan` span, once a call (a kept
    run builds it again); the plain backend builds none."""
    prob = problems.random_3regular_maxcut(40, 3, device=CPU)
    kw = dict(n_steps=30, n_chains=3, sample_every=10, backend=backend)
    sampler_api.drop_kept_runs()
    try:
        _, records, _ = _profiled(lambda: [sampler_api.run(prob, sampler_api.ColoredGibbs(), seed,
                                                           **kw) for seed in (1, 2)])
    finally:
        sampler_api.drop_kept_runs()
    blocks = len(plan_blocks(kw["n_steps"], kw["sample_every"], GRAPH_STEPS))
    plan = ["sampler.colour_plan"] if backend == "cuda" else []
    for record in records:
        spans = record["spans"]
        assert [s["name"] for s in spans] == ["sampler.validate", "sampler.init", *plan] + [
            "sampler.eager"] * blocks + ["sampler.results", "sampler.release"]
        assert record["counts"]["sampler.colour_plans"] == len(plan)
        if plan:
            init, inner = spans[1], spans[2]
            assert inner["parent"] == init["id"] and inner["root"] == record["id"]
            assert init["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= init["end_ns"]


@pytest.mark.cuda
def test_a_repeated_call_on_the_card_replays_every_block():
    """On the card the second call of a key (SK at n = 2000, the CAL
    letters) captures nothing and runs no eager block, and equals the eager
    loop of a new run bit for bit; either call counts its step kernel's
    launches, one a step, the second from replays alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an sm_90 card); chip_smoke.py checks the driver there")
    cases = [
        (problems.sk_instance(2000, 3, device="cuda"), sampler_api.TauLeap(dt=0.1, backend="cuda"),
         dict(n_steps=200, n_chains=256, sample_every=50, schedule=sampler_api.geometric(0.3, 3.0)),
         "launch.tau_leap_step"),
        (problems.cal_problem(device="cuda"), sampler_api.ChromaticGibbs(backend="cuda"),
         dict(n_steps=100, n_chains=512, sample_every=50, first_hit=-930.0,
              schedule=sampler_api.geometric(0.3, 3.0)),
         "launch.lattice_gibbs_sweep"),
    ]
    for prob, kernel, kw, step_launch in cases:
        sampler_api.drop_kept_runs()
        try:
            first = tracing.counts()
            sampler_api.run(prob, kernel, 1, **kw)
            before = tracing.counts()
            got = sampler_api.run(prob, kernel, 2, **kw)
            after = tracing.counts()
        finally:
            sampler_api.drop_kept_runs()
        assert before["sampler.captures"] > first["sampler.captures"]
        assert after["sampler.captures"] == before["sampler.captures"]
        assert after["sampler.eager_blocks"] == before["sampler.eager_blocks"]
        assert after["sampler.reuses"] == before["sampler.reuses"] + 1
        # the new run's eager blocks and replays, its captures taken back
        assert before[step_launch] - first[step_launch] == kw["n_steps"]
        assert after[step_launch] - before[step_launch] == kw["n_steps"]
        want = sampler_api._make_run(prob, kernel, 2, eager=True, **kw)()
        for a, b in zip(got[:7], want[:7]):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
def test_cd_steps_on_the_card_replay_one_kept_run(monkeypatch):
    """On the card 8 CD steps on the 16x16 king's lattice, each on a new
    problem with a new generator, capture at most twice and replay the
    rest, and equal 8 steps of eager runs bit for bit (chains, weights,
    biases, the generators' final states)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an sm_90 card); chip_smoke.py checks CD there")
    cfg = boltzmann.CDConfig(lr=0.06, n_model_steps=32, n_chains=32, quantize_bits=8)
    batch = digits.digit_batch(3, n=128, generator=torch.Generator("cuda").manual_seed(1),
                               flip_prob=0.06, device="cuda")

    def chain():
        state = boltzmann.init_cd(torch.Generator("cuda").manual_seed(2), 16, 16, cfg,
                                  device="cuda")
        states, gens = [state], []
        for step in range(8):
            gens.append(torch.Generator("cuda").manual_seed(100 + step))
            states.append(boltzmann.cd_step(states[-1], batch, gens[-1], cfg))
        return states, gens

    sampler_api.drop_kept_runs()
    try:
        before = tracing.counts()
        states, gens = chain()
        after = tracing.counts()
    finally:
        sampler_api.drop_kept_runs()
    assert after["sampler.captures"] - before["sampler.captures"] <= 2
    assert after["sampler.replays"] - before["sampler.replays"] >= 6
    assert after["sampler.renewals"] - before["sampler.renewals"] == 7
    with monkeypatch.context() as m:
        m.setattr(sampler_api, "run", lambda problem, kernel, seed, **kw:
                  sampler_api._make_run(problem, kernel, seed, eager=True, **kw)())
        eager_states, eager_gens = chain()
    for state, eager in zip(states, eager_states):
        assert torch.equal(state.chains, eager.chains)
        assert torch.equal(state.problem.w, eager.problem.w)
        assert torch.equal(state.problem.b, eager.problem.b)
    for g, h in zip(gens, eager_gens):
        assert torch.equal(g.get_state(), h.get_state())


def test_cd_step_nests_the_sampler_run_in_its_model_phase():
    _, (record,), annotations = _profiled(_cd_step)
    assert record["name"] == "boltzmann.cd_step"
    by_name = {s["name"]: s for s in record["spans"]}
    model, run = by_name["boltzmann.model"], by_name["sampler.run"]
    assert model["parent"] == record["id"] and run["parent"] == model["id"]
    assert by_name["sampler.eager"]["parent"] == run["id"]
    assert all(s["root"] == record["id"] for s in record["spans"])
    top = [s["name"] for s in record["spans"] if s["parent"] == record["id"]]
    assert top == ["boltzmann.model", "boltzmann.correlations", "boltzmann.update",
                   "boltzmann.quantize"]
    assert record["counts"]["sampler.calls"] == 1
    assert annotations[:3] == (["boltzmann.cd_step", "boltzmann.model", "sampler.run"]
                               if tracing.MIRRORED else [])


def test_where_spans_stay_out_of_the_profiler_the_records_are_kept(monkeypatch):
    """The route of a torch whose kineto events do not say their activity."""
    monkeypatch.setattr(tracing, "MIRRORED", False)
    _, (record,), annotations = _profiled(lambda: _run("lattice"))
    assert annotations == []
    assert [s["name"] for s in record["spans"]] == [
        "sampler.validate", "sampler.init", "sampler.eager", "sampler.eager", "sampler.results",
        "sampler.release"]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_is_bit_identical_with_the_profiler_on_and_off(name):
    off = _run(name)
    on, _, _ = _profiled(lambda: _run(name))
    for a, b in zip(off, on):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a is None and b is None


def test_cd_step_is_bit_identical_with_the_profiler_on_and_off():
    off = _cd_step()
    on, _, _ = _profiled(_cd_step)
    assert torch.equal(off.chains, on.chains) and off.step == on.step
    assert torch.equal(off.problem.w, on.problem.w) and torch.equal(off.problem.b, on.problem.b)


def _ring(n):
    """Tables of a ring of n sites (two neighbours and a padded slot) and
    its two colour classes, n even."""
    i = torch.arange(n)
    idx = torch.stack([(i - 1) % n, (i + 1) % n, i], 1).to(torch.int32)
    w = torch.tensor([1.0, 1.0, 0.0]).repeat(n, 1)
    return idx, w, torch.zeros(n), torch.stack([(i % 2 == 0).float(), (i % 2 == 1).float()])


def _launch_every_route():
    """One call of each kernel route through its wrapper; two flash attention
    calls, one f32 and banded, one bf16 and bounded to kv_len < Sk."""
    B, N = 3, 8
    s = torch.ones(B, N)
    J = torch.zeros(N, N, dtype=torch.int8)
    tail = (torch.tensor(1.0), torch.rand(B, N), torch.tensor(0.1), torch.ones(B))
    tau_leap.tau_leap_step(s, J, torch.zeros(N), *tail)
    tau_leap.tau_leap_step(s, J, torch.zeros(B, N), *tail)
    dense_field.dense_field(s.to(torch.int8), J, torch.zeros(N), torch.tensor(1.0))

    H = W = 4
    w, b = torch.zeros(8, H, W), torch.zeros(H, W)
    colors = ising.king_color_masks(H, W, device=CPU).float()
    fz, cl = torch.zeros(H, W), torch.ones(H, W)
    lat = (torch.ones(B, H, W), w, b, torch.rand(4, B, H, W), colors, fz, cl, torch.ones(B))
    generic = lattice_gibbs.lattice_plan(w, b, colors, fz, cl)._replace(independent=False)
    for plan in (None, generic):
        lattice_gibbs.lattice_gibbs_sweep(*lat, plan=plan)
        lattice_gibbs.lattice_gibbs_sweep(*lat, plan=plan, bias_rows=torch.zeros(B, H, W))
    lattice_gibbs.lattice_energy(torch.ones(B, H, W), w, b)

    for n in (8, sparse_gather.MAX_SMEM_BYTES // 4 + 2):  # staged, then past a block's rows
        idx, w, b, _ = _ring(n)
        sparse_gather.sparse_fields(torch.ones(1, n), idx, w, b)
        sparse_gather.sparse_energy(torch.ones(1, n), idx, w, b)
    for n in (8, sparse_gather.MAX_SMEM_BYTES // 2 + 2):  # one chain a block, then long rows
        idx, w, b, masks = _ring(n)
        sparse_gather.colored_gibbs_sweep(torch.ones(1, n), idx, w, b, torch.rand(2, 1, n), masks,
                                          torch.ones(1))
    idx, w, b, masks = _ring(8)
    sparse_gather.colored_gibbs_sweep(torch.ones(1, 8), idx, w, b, torch.rand(2, 1, 8), masks,
                                      torch.ones(1), keep=torch.ones(1, 8, dtype=torch.uint8))
    w2 = w.expand(2, *w.shape).contiguous()  # two disorder samples' couplings
    sparse_gather.colored_gibbs_sweep(torch.ones(2, 8), idx, w2, b, torch.rand(2, 2, 8), masks,
                                      torch.ones(2))
    sparse_gather.sparse_energy(torch.ones(2, 8), idx, w2, b)
    ctmc_event.ctmc_event(s, s, *(torch.zeros(B),) * 2, torch.zeros(N, N), *(torch.ones(B),) * 3)

    q = torch.zeros(2, 128, 64)
    flash_attention.flash_attention(q, q, q, True, window=64)
    q = q.bfloat16()
    flash_attention.flash_attention(q, q, q, False, kv_len=100)


def test_counts_hold_the_launch_counters_and_the_driver_counters(monkeypatch):
    """Each launch is one count of `launch.<kernel>`, the kernel that ran,
    in `tracing.counts()`; no card: the device checks pass and the CUDA
    launchers are replaced by ones that do nothing."""
    launchers = []
    for mod in (tau_leap, dense_field, lattice_gibbs, sparse_gather, flash_attention, ctmc_event):
        monkeypatch.setattr(mod, "check_cuda", lambda t: t.device)
    monkeypatch.setattr(sparse_gather, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(_build, "launcher", lambda name: launchers.append(name) or (lambda *a: 0))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    before = tracing.counts()
    _launch_every_route()
    c = tracing.counts()
    assert {k: n - before[k] for k, n in c.items() if n != before[k]} == {f"launch.{k}": 1 for k in (
        "tau_leap_step", "tau_leap_step_faults", "dense_field",
        "lattice_gibbs_sweep", "lattice_gibbs_generic",
        "lattice_gibbs_sweep_faults", "lattice_gibbs_generic_faults", "lattice_energy",
        "sparse_fields", "sparse_fields_global", "colored_gibbs_sweep", "colored_gibbs_sweep_long",
        "colored_gibbs_sweep_faults", "sparse_energy", "sparse_energy_long",
        "colored_gibbs_sweep_samples", "sparse_energy_samples", "flash_attention_window", "flash_attention_kv_len", "flash_attention_bf16",
        "flash_attention_f32", "ctmc_event")} | {"launch.flash_attention": 2}
    assert set(launchers) == set(_build.LAUNCHERS)  # every entry point was reached
    assert tracing.counts()["launch.never_launched"] == 0
    calls, blocks = c["sampler.calls"], c["sampler.eager_blocks"]
    _run("lattice")  # counters are on with no profiler
    after = tracing.counts()
    assert after["sampler.calls"] == calls + 1 and after["sampler.eager_blocks"] == blocks + 2
