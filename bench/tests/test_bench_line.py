"""The result line: its keys in order, the checks last, each metric with its
unit, and the checks also on standard error."""
import json
import time
import types

from bench import harness
from bench_tiny import REPO, tiny_root

B = json.loads((REPO / "BENCHMARK.json").read_text())
UNITS = {m["name"]: m["unit"] for m in B["end_to_end"] + B["per_layer"]}


def test_line_shape(tmp_path):
    root = tiny_root(tmp_path)
    line, checks, run = harness.run_cell(root, "sk2000.anneal", 2**31 + 7, 0.3, False,
                                         t0=time.perf_counter(), device="cpu", card=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] == run.jobs
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    # on the CPU the power reading is missing; the host-clock metrics are there
    assert {"updates_per_s", "job_p90_ms", "setup_s"} <= set(line["metrics"])
    for name, m in line["metrics"].items():
        assert m["unit"] == UNITS[name] and m["value"] > 0
    assert list(line["checks"]) == [k for k, _, _ in checks]
    assert line["checks"]["failed_jobs"] == {"value": 0.0, "limit": 0.0}
    json.dumps(line)  # a JSON object


def test_main_prints_checks_last_on_stderr_and_the_line_last(tmp_path, capsys, monkeypatch):
    root = tiny_root(tmp_path)
    monkeypatch.setattr(harness, "BENCH", root / "bench")
    real = harness.run_cell
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: real(*a, **k, device="cpu", card=False))
    args = types.SimpleNamespace(workload="king16.cd", seed=5, seconds=0.3, trace=0)
    assert harness.main(args, time.perf_counter()) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [x.split()[1] for x in tail] == list(line["checks"])
    assert all(x.startswith("check ") and x.endswith(" ok") for x in tail)


def test_main_refuses_when_the_jax_package_is_loaded(tmp_path, capsys, monkeypatch):
    root = tiny_root(tmp_path)
    monkeypatch.setattr(harness, "BENCH", root / "bench")
    real = harness.run_cell
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: real(*a, **k, device="cpu", card=False))
    monkeypatch.setitem(__import__("sys").modules, "repro.core", types.ModuleType("repro.core"))
    args = types.SimpleNamespace(workload="king16.cd", seed=5, seconds=0.2, trace=0)
    assert harness.main(args, time.perf_counter()) == 3
    out, err = capsys.readouterr()
    assert out.strip() == "" and "repro.core" in err


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "jaxtyping_like", types.ModuleType("x"))
    assert "jaxtyping_like" not in harness.forbidden_modules()
    assert not [m for m in harness.forbidden_modules() if m.startswith("repro_torch")]
