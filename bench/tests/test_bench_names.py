"""Configurations, traffic mixes, limits, entries, references, rooflines and
metric readers are found by the names BENCHMARK.json gives; a cell brought
as new files and entries runs with no file that was there edited."""
import json
import shutil
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


# a reference of its own for a new configuration: a periodic L x L square
# lattice with +-J couplings, its graph as the sparse reference's tables and
# its dynamics the sparse reference's
SQUARE_REFERENCE = """
import torch

from bench.common import load_module

sparse = load_module("reference", "sparse")
KIND = sparse.KIND
Model = sparse.Model


def instance(config, spec, seed, device):
    L = config["L"]
    site = torch.arange(L * L, device=device).reshape(L, L)
    i = torch.cat([site.flatten(), site.flatten()])
    j = torch.cat([site.roll(-1, 1).flatten(), site.roll(-1, 0).flatten()])
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.where(torch.rand(i.shape, generator=gen, device=device) < 0.5, 1.0, -1.0)
    return sparse.tables(L * L, i, j, w)
"""


def test_a_new_configuration_with_its_own_reference_is_found_without_an_edit(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    shutil.copytree(REPO / "bench", src / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", src / "BENCHMARK.json")
    before = {p.relative_to(src): p.read_bytes() for p in (src / "bench").rglob("*") if p.is_file()}
    (src / "bench" / "reference" / "square_pm_j.py").write_text(SQUARE_REFERENCE)
    (src / "bench" / "configs" / "square32.json").write_text(json.dumps(
        {"name": "square32", "reference": "square_pm_j", "L": 32, "tiny": {"L": 6}}))
    (src / "bench" / "limits" / "square32.solve.json").write_text(json.dumps({"chains_differ": 0.0}))
    bench = json.loads((src / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "square32", "source": "a test", "file": "bench/configs/square32.json",
                             "reduced": [], "why": "a new configuration"})
    bench["workloads"].append({"name": "square32.solve", "config": "square32",
                               "traffic": "colored_solve", "chips": 1, "why": "a new sparse cell"})
    (src / "BENCHMARK.json").write_text(json.dumps(bench))
    root = tiny_root(tmp_path, source=src)
    line, checks, run = harness.run_cell(root, "square32.solve", 2**31 + 99, 0.3, False,
                                         t0=time.perf_counter(), device="cpu", card=False)
    assert line["correct"] and run.jobs >= 1, checks
    assert run.cell.shape == {"chains": 8, "sites": 36, "degree": 4, "colours": 2}
    # no file that was there changed: BENCHMARK.json took two entries, the rest is new files
    assert {p: (src / p).read_bytes() for p in before} == before
    assert before == {p: (REPO / p).read_bytes() for p in before}


def test_derived_seeds_differ_and_repeat():
    big = 2**31 + 12345
    assert derive_seed(big, "job", 0) == derive_seed(big, "job", 0)
    seeds = {derive_seed(big, "job", j) for j in range(100)} | {derive_seed(big, "instance")}
    assert len(seeds) == 101 and all(0 <= s < 2**63 for s in seeds)


def test_the_bench_folder_is_where_the_files_are():
    assert BENCH == REPO / "bench"


def test_an_unknown_problem_kind_raises():
    from bench.program import problem

    with pytest.raises(ValueError, match="'lattice'"):
        problem("lattice", {"w": None, "b": None})
    for name in ("dense", "king", "sparse"):
        assert load_module("reference", name).KIND in ("dense", "king", "sparse")


def test_a_kernel_of_the_traffic_is_the_programs_registered_one():
    from repro_torch.core import sampler_api

    entry = load_module("entries", "sampler_run")
    assert entry._kernel({"name": "tau_leap", "dt": 0.1}) == sampler_api.TauLeap(dt=0.1)
    assert entry._kernel({"name": "chromatic_gibbs"}) == sampler_api.ChromaticGibbs()
    assert entry._kernel({"name": "colored_gibbs"}) == sampler_api.ColoredGibbs()
    with pytest.raises(KeyError, match="no_such_kernel"):
        entry._kernel({"name": "no_such_kernel"})
