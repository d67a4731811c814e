"""The cell `sk2000.ctmc`: the exact CTMC on the K2000 SK glass. At `tiny`
it runs and is correct, and the control (the reference's rates and tree in
bfloat16) is not; a program that alters one event's site, one chain's time,
or leaves half the chains unstepped is not correct; its entry counts an
event as one site update a chain and takes its reference from the traffic;
its roofline's bytes at the cell's shape are the figure its docstring
gives; and its two per-layer metrics read None where the program has no
such kernel or counter."""
import json
import time
import types

import pytest
import torch

from bench import calibrate, harness, peaks
from bench.common import load_module
from bench_tiny import REPO, tiny_root
from repro_torch import tracing
from repro_torch.core import sampler_api
from repro_torch.kernels import ops

CELL = "sk2000.ctmc"


def _run(tmp_path, seed=2**31 + 36):
    root = tiny_root(tmp_path)
    line, checks, run = harness.run_cell(root, CELL, seed, 0.3, False,
                                         t0=time.perf_counter(), device="cpu", card=False)
    return line, {k: v for k, v, _ in checks}, run


def test_the_cell_runs_at_tiny_and_is_correct(tmp_path):
    line, checks, run = _run(tmp_path)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert checks["chains_differ"] == 0.0 and checks["failed_jobs"] == 0.0
    assert 0.0 < checks["energy_gap"] <= 1e-4  # the incremental energy's f32 rounding
    assert run.cell.updates_per_job == 8 * 200 and run.cell.steps_per_job == 200
    assert run.cell.shape == {"chains": 8, "sites": 64}


def test_the_control_differs(tmp_path):
    root = tiny_root(tmp_path)
    control = calibrate.readings(CELL, 2**31 + 37, True, "cpu", root)
    assert control["chains_differ"] > 0.0 and control["energy_gap"] > 1e-4


def _on_call(monkeypatch, k, change):
    """`ops.ctmc_event` with `change(old, new)` applied to the new (s, h, e,
    t) of its k-th call of each job (a job's events count from 0)."""
    real, calls = ops.ctmc_event, {"n": 0}

    def patched(s, h, e, t, *a, **kw):
        new = list(real(s, h, e, t, *a, **kw))
        if calls["n"] % 200 == k:  # the tiny job's 200 events
            change((s, h, e, t), new)
        calls["n"] += 1
        return tuple(new)

    monkeypatch.setattr(ops, "ctmc_event", patched)


def _other_site(old, new):
    """Chain 0 flips the site after the one it drew."""
    s = new[0].clone()
    i = int((s[0] != old[0][0]).nonzero()[0]) if bool((s[0] != old[0][0]).any()) else 0
    s[0] = old[0][0]
    s[0, (i + 1) % s.shape[1]] *= -1
    new[0] = s


def _later_time(old, new):
    t = new[3].clone()
    t[1] = t[1] * (1 + 2.0**-10)
    new[3] = t


def _half_unstepped(old, new):
    keep = old[0].shape[0] // 2
    for j in range(4):
        new[j] = torch.cat([new[j][:keep], old[j][keep:]])


@pytest.mark.parametrize("fault", [_other_site, _later_time])
def test_one_altered_event_makes_the_run_not_correct(tmp_path, monkeypatch, fault):
    _on_call(monkeypatch, 57, fault)
    line, checks, _ = _run(tmp_path)
    assert line["correct"] is False and checks["chains_differ"] > 0.0


def test_half_the_chains_unstepped_make_the_run_not_correct(tmp_path, monkeypatch):
    real = ops.ctmc_event

    def half(s, h, e, t, *a, **kw):
        new = list(real(s, h, e, t, *a, **kw))
        _half_unstepped((s, h, e, t), new)
        return tuple(new)

    monkeypatch.setattr(ops, "ctmc_event", half)
    line, checks, _ = _run(tmp_path)
    assert line["correct"] is False and checks["chains_differ"] >= 0.5


def test_the_roofline_bytes_at_the_cells_shape():
    """16 B n + 28 B bytes at (B, n) = (256, 2000): 8.2 MB, 2.45 us at
    3.35 TB/s, bound by bytes."""
    roofline = load_module("roofline", "ctmc_event")
    nbytes, ops_, rate = roofline.work({"chains": 256, "sites": 2000})
    assert nbytes == 16 * 256 * 2000 + 7 * 4 * 256 == 8_199_168
    assert ops_ == 256 * (8 * 2000 + 2047 + 2 * 2000)
    assert peaks.bound_s(nbytes, ops_, rate) * 1e6 == pytest.approx(2.4475, abs=5e-5)
    assert nbytes / peaks.HBM_BYTES_PER_S > ops_ / rate
    assert roofline.TRACE_NAMES == ("ctmc_event_kernel",)


def _record(launches):
    counts = {"sampler.calls": 1}
    if launches is not None:
        counts["launch.ctmc_event"] = launches
    return {"name": "sampler.run", "start_ns": 0, "end_ns": 1, "spans": [], "counts": counts}


def _trace_run(monkeypatch, records, step_kernel="ctmc_event", kernels=()):
    monkeypatch.setattr(tracing, "calls", lambda: list(records))
    trace = types.SimpleNamespace(kernel_seconds=lambda match=None: (
        sum(b - a for name, a, b in kernels if any(m in name for m in match)),
        sum(any(m in name for m in match) for name, _, _ in kernels)))
    spec = types.SimpleNamespace(traffic={"step_kernel": step_kernel})
    return types.SimpleNamespace(
        trace=trace, traced_jobs=2, root=REPO, spec=spec,
        cell=types.SimpleNamespace(steps_per_job=20000, shape={"chains": 256, "sites": 2000}),
        roofline=lambda name: load_module("roofline", name, REPO / "bench"))


def _read(name, run):
    return load_module("metrics", name, REPO / "bench").read(run)


def test_the_metrics_read_the_counter_and_the_kernel(monkeypatch):
    run = _trace_run(monkeypatch, [_record(0), _record(20000), _record(20000)],
                     kernels=[("ctmc_event_kernel", 0.0, 5e-6), ("ctmc_event_kernel", 1.0, 1 + 5e-6),
                              ("distribution_elementwise", 2.0, 3.0)])
    assert _read("ctmc_events_per_step", run) == 1.0
    assert _read("ctmc_event_roofline", run) == pytest.approx(100 * 2.4475e-6 / 5e-6, rel=1e-4)


def test_a_program_without_the_counter_or_the_kernel_reads_none(monkeypatch):
    run = _trace_run(monkeypatch, [_record(None)] * 3,
                     kernels=[("distribution_elementwise", 0.0, 1.0)])
    assert _read("ctmc_events_per_step", run) is None
    assert _read("ctmc_event_roofline", run) is None
    run = _trace_run(monkeypatch, [_record(4)] * 3, step_kernel="tau_leap_step",
                     kernels=[("ctmc_event_kernel", 0.0, 1.0)])
    assert _read("ctmc_event_roofline", run) is None  # another cell's step kernel
    program = load_module("metrics", "_program", REPO / "bench")
    monkeypatch.setattr(program, "_tracing", lambda: None)
    assert _read("ctmc_events_per_step", run) is None


def test_the_configuration_and_traffic_state_the_cell():
    traffic = json.loads((REPO / "bench" / "traffic" / "ctmc.json").read_text())
    config = json.loads((REPO / "bench" / "configs" / "sk2000_glauber.json").read_text())
    assert traffic["entry"] == "sampler_ctmc" and traffic["reference"] == "dense_ctmc"
    assert traffic["kernel"] == {"name": "ctmc"} and traffic["backend"] == "cuda"
    assert (traffic["n_chains"], traffic["n_steps"], traffic["sample_every"]) == (256, 20000, 1000)
    assert "first_hit_per_site" not in traffic and config["n"] == 2000
    assert sampler_api.get_kernel("ctmc").resolved_site_draw(types.SimpleNamespace(n=2000)) == "tree"
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("sk2000_glauber", "ctmc", 1)
    assert config["reference"] == "dense_ctmc" and config["couplings"] == "sk"
    entry = {c["name"]: c for c in bench["configs"]}["sk2000_glauber"]
    assert entry["reduced"] == [] and entry["file"] == "bench/configs/sk2000_glauber.json"
    layers = {m["name"]: m for m in bench["per_layer"]}
    for name in ("ctmc_event_roofline", "ctmc_events_per_step"):
        assert layers[name]["workloads"] == [CELL] and layers[name]["layer"] == "step kernel"


def test_the_entry_takes_its_reference_from_the_traffic_and_refuses_a_first_hit(tmp_path):
    root = tiny_root(tmp_path)
    s = harness.spec(root, CELL)
    entry = load_module("entries", s.traffic["entry"], root / "bench")
    assert s.config["reference"] == "dense_ctmc"
    cell = entry.Cell(dict(s.config, reference="dense"), s.traffic, 1, "cpu", root / "bench")
    assert cell.ref is load_module("reference", "dense_ctmc", root / "bench")  # the traffic's
    with pytest.raises(ValueError, match="no first hit"):
        entry.Cell(s.config, dict(s.traffic, first_hit_per_site=-0.7), 1, "cpu", root / "bench")
    ref = load_module("reference", "dense_ctmc", root / "bench")
    with pytest.raises(ValueError, match="draws from the tree"):
        ref.Model(s.config, cell.ref.instance(s.config, None, 1, "cpu"), {"name": "tau_leap"})


def test_the_reference_tree_and_descent_from_the_definition():
    ref = load_module("reference", "dense_ctmc")
    rates = torch.tensor([[1.0, 2.0, 3.0], [0.0, 0.0, 5.0]])
    tree = ref.levels(rates)
    assert [x.shape[1] for x in tree] == [4, 2, 1]
    assert tree[-1][:, 0].tolist() == [6.0, 5.0] and tree[1].tolist() == [[3.0, 3.0], [0.0, 5.0]]
    # target u * total: [0, 1) on site 0, [1, 3) on site 1, [3, 6) on site 2
    for u, want in ((0.0, 0), (0.16, 0), (0.17, 1), (0.49, 1), (0.5, 2), (0.99, 2)):
        assert int(ref.descend(tree, torch.tensor([u, u]))[0]) == want
    assert ref.descend(tree, torch.tensor([0.3, 0.3]))[1] == 2  # zero-rate sites never drawn
