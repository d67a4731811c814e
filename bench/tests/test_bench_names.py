"""Configurations, traffic mixes, limits, entries, references, rooflines and
metric readers are found by the names BENCHMARK.json gives; a cell brought
as new files and entries runs with no file that was there edited."""
import json
import time

import pytest

from bench import harness
from bench.common import BENCH, derive_seed, load_module
from bench_tiny import REPO, tiny_root

B = json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_name_in_the_benchmark_has_its_file():
    for w in B["workloads"]:
        s = harness.spec(REPO, w["name"])
        assert load_module("entries", s.traffic["entry"]).Cell
        assert load_module("reference", s.config["reference"]).Model
        for key in ("step_kernel", "step_work"):
            if s.traffic.get(key):
                assert load_module("roofline", s.traffic[key]).work
    for m in B["end_to_end"] + B["per_layer"]:
        assert callable(load_module("metrics", m["name"]).read)


def test_a_missing_name_says_which_file():
    with pytest.raises(FileNotFoundError, match="no_such_mix"):
        load_module("traffic", "no_such_mix")
    with pytest.raises(KeyError, match="nope"):
        harness.spec(REPO, "nope")


def test_a_new_mix_is_found_without_an_edit(tmp_path):
    root = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*") if p.is_file()}
    mix = json.loads((root / "bench" / "traffic" / "anneal.json").read_text())
    mix.update(kernel={"name": "tau_leap", "dt": 0.2}, n_steps=30, sample_every=10)
    (root / "bench" / "traffic" / "anneal_dt2.json").write_text(json.dumps(mix))
    (root / "bench" / "limits" / "sk2000.anneal_dt2.json").write_text(
        (root / "bench" / "limits" / "sk2000.anneal.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "sk2000.anneal_dt2", "config": "sk2000",
                               "traffic": "anneal_dt2", "chips": 1, "why": "a new mix"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line, checks, run = harness.run_cell(root, "sk2000.anneal_dt2", 99, 0.3, False,
                                         t0=time.perf_counter(), device="cpu", card=False)
    assert line["correct"] and run.jobs >= 1 and run.cell.steps_per_job == 30
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_derived_seeds_differ_and_repeat():
    big = 2**31 + 12345
    assert derive_seed(big, "job", 0) == derive_seed(big, "job", 0)
    seeds = {derive_seed(big, "job", j) for j in range(100)} | {derive_seed(big, "instance")}
    assert len(seeds) == 101 and all(0 <= s < 2**63 for s in seeds)


def test_the_bench_folder_is_where_the_files_are():
    assert BENCH == REPO / "bench"
