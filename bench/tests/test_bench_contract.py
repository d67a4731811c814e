"""BENCHMARK.json keeps to the benchmark's contract: its keys, names, units,
bounds and files, and the per-cell and per-metric rules that are checked
before any run."""
import json
import re

import pytest

from bench_tiny import REPO

B = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys_and_size():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
        assert (REPO / p).is_dir()
    assert 1 <= len(B["command"]) <= 32
    for word in B["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:  # a file of the repo the command names lies under paths
            assert any(word.startswith(p + "/") for p in B["paths"])


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = B["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in B[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_configs():
    assert 1 <= len(B["configs"]) <= 24
    used = {w["config"] for w in B["workloads"]}
    files = [c["file"] for c in B["configs"]]
    assert len(files) == len(set(files))
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and LINE.match(c["source"]) and LINE.match(c["why"])
        assert any(c["file"].startswith(p + "/") for p in B["paths"])
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_workloads():
    assert 1 <= len(B["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, len(B["workloads"]) // 4)
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert NAME.match(w["traffic"])
        assert (REPO / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (REPO / "bench" / "limits" / f"{w['name']}.json").is_file()


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(group):
    cells = {w["name"] for w in B["workloads"]}
    for m in B[group]:
        keys = {"name", "unit", "better", "source"} | (
            {"bound"} if group == "end_to_end" else {"layer", "moves"})
        assert set(m) - {"workloads"} == keys, m["name"]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in (("host_clock", "device_trace") if group == "end_to_end" else SOURCES)
        assert set(m.get("workloads", cells)) <= cells
        assert (REPO / "bench" / "metrics" / f"{m['name']}.py").is_file()
        if group == "end_to_end":
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert LINE.match(m["layer"])
            assert m["moves"] in {e["name"] for e in B["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in B["workloads"]:
        mine = [m for m in B["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layers = [m for m in B["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layers
        for m in layers:  # each per-layer metric moves a metric its cells report
            assert m["moves"] in {x["name"] for x in mine}



def test_every_cell_brings_its_cpu_test_sizes():
    """A cell's configuration and traffic files each hold a `tiny` object of
    the top-level keys they override on the CPU (bench/tests/bench_tiny.py
    reads nothing else)."""
    configs = {c["name"]: c["file"] for c in B["configs"]}
    for w in B["workloads"]:
        for path in (REPO / configs[w["config"]], REPO / "bench" / "traffic" / f"{w['traffic']}.json"):
            data = json.loads(path.read_text())
            assert isinstance(data.get("tiny"), dict), f"{path} has no tiny sizes"
            assert set(data["tiny"]) <= set(data) - {"tiny"}, path
