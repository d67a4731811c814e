"""The cell `ea3d32.samples`: many disorder samples of the 3D +-J EA glass in
one call. At `tiny` it runs and is correct; a program that gives every row
sample 0's couplings (in its sweep, or in its energies) is not; its entry
refuses chains that are not samples x replicas; and its roofline's bytes at
the cell's shape are the figure its docstring gives."""
import json
import time

import pytest
import torch

from bench import harness, peaks
from bench.common import load_module
from bench_tiny import REPO, tiny_root
from repro_torch.kernels import ops

CELL = "ea3d32.samples"


def _run(tmp_path):
    root = tiny_root(tmp_path)
    line, checks, _ = harness.run_cell(root, CELL, 2**31 + 34, 0.3, False,
                                       t0=time.perf_counter(), device="cpu", card=False)
    return line, {k: v for k, v, _ in checks}


def test_the_cell_runs_at_tiny_and_is_correct(tmp_path):
    line, checks = _run(tmp_path)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert checks == {"chains_differ": 0.0, "energy_gap": 0.0, "failed_jobs": 0.0}


def _sample_zero(monkeypatch, name):
    """`ops.<name>` given sample 0's couplings for every row."""
    real = getattr(ops, name)

    def first_sample(s, nbr_idx, nbr_w, *a, **k):
        if nbr_w.ndim == 3:
            nbr_w = nbr_w[0].contiguous()
        return real(s, nbr_idx, nbr_w, *a, **k)

    monkeypatch.setattr(ops, name, first_sample)


@pytest.mark.parametrize("where", ["colored_gibbs_sweep", "sparse_energy"])
def test_every_row_on_sample_zero_is_not_correct(tmp_path, monkeypatch, where):
    """The fault the per-sample mapping must catch: the sweep (the states
    differ from the replay) or the energies (the recorded energies are not
    those of the rows' own samples) on sample 0's couplings alone."""
    _sample_zero(monkeypatch, where)
    line, checks = _run(tmp_path)
    assert line["correct"] is False
    key = "chains_differ" if where == "colored_gibbs_sweep" else "energy_gap"
    assert checks[key] > 0.0


def test_the_entry_refuses_chains_that_are_not_samples_times_replicas(tmp_path):
    root = tiny_root(tmp_path)
    s = harness.spec(root, CELL)
    entry = load_module("entries", s.traffic["entry"], root / "bench")
    with pytest.raises(ValueError, match="samples x replicas"):
        entry.Cell(s.config, dict(s.traffic, n_chains=6), 1, "cpu", root / "bench")
    cell = entry.Cell(s.config, s.traffic, 1, "cpu", root / "bench")
    assert cell.shape == {"chains": 8, "sites": 64, "degree": 6, "colours": 2, "samples": 2}


def test_the_roofline_bytes_at_the_cells_shape():
    """4 (3 B n + n D + S n D + n + C n + B) bytes at (B, n, S, D, C) =
    (512, 32768, 128, 6, 2): 303.2 MB, 90.5 us at 3.35 TB/s, bound by
    bytes."""
    roofline = load_module("roofline", "colored_gibbs_sweep_samples")
    shape = {"chains": 512, "sites": 32768, "samples": 128, "degree": 6, "colours": 2}
    nbytes, ops_, rate = roofline.work(shape)
    assert nbytes == 4 * (3 * 512 * 32768 + 32768 * 6 + 128 * 32768 * 6 + 32768 + 2 * 32768 + 512)
    assert round(nbytes / 1e6, 1) == 303.2
    assert peaks.bound_s(nbytes, ops_, rate) * 1e6 == pytest.approx(90.5, abs=0.05)
    assert nbytes / peaks.HBM_BYTES_PER_S > ops_ / rate
    assert roofline.TRACE_NAMES == ("colored_gibbs_samples_kernel",)


def test_the_configuration_and_traffic_state_the_cell():
    config = json.loads((REPO / "bench" / "configs" / "ea3d32.json").read_text())
    traffic = json.loads((REPO / "bench" / "traffic" / "samples.json").read_text())
    assert config["reference"] == "ea3d_samples" and config["L"] == 32
    assert (config["samples"], config["replicas"]) == (128, 4)
    assert traffic["n_chains"] == config["samples"] * config["replicas"] == 512
    tiny = {**config, **config["tiny"]}
    assert {**traffic, **traffic["tiny"]}["n_chains"] == tiny["samples"] * tiny["replicas"]
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}["ea3d32"]
    assert entry["reduced"] == ["samples"]
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert cell["chips"] == 1 and cell["traffic"] == "samples"


def test_the_reference_mapping_is_sample_major():
    ref = load_module("reference", "ea3d_samples")
    w = torch.arange(3.0)[:, None, None].expand(3, 2, 1)
    assert ref.row_couplings(w, 6)[:, 0, 0].tolist() == [0, 0, 1, 1, 2, 2]
    with pytest.raises(ValueError, match="whole number of replicas"):
        ref.row_couplings(w, 4)
