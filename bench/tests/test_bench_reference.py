"""The plain reference against the program at tiny sizes on the CPU, and the
reference's definitions against what they stand for."""
import json
import time

import numpy as np
import pytest
import torch

from bench import harness
from bench.common import load_module
from bench_tiny import REPO, tiny_root

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_of_every_cell_equals_its_reference(tmp_path, cell):
    root = tiny_root(tmp_path)
    line, checks, run = harness.run_cell(root, cell, 2**31 + 11, 0.3, False,
                                         t0=time.perf_counter(), device="cpu", card=False)
    assert line["correct"], checks
    numbers = {k: v for k, v, _ in checks}
    assert numbers["chains_differ"] == 0.0 and numbers["failed_jobs"] == 0.0


def test_the_template_lattice_is_ground_at_its_template():
    king = load_module("reference", "king")
    mix = json.loads((REPO / "bench" / "traffic" / "cal_solve.json").read_text())
    w, b = king.template_lattice(mix["instance"]["template_rows"], 1.0, "cpu")
    t = torch.tensor([[1.0 if c == "1" else -1.0 for c in r] for r in mix["instance"]["template_rows"]])
    e = king.energy64(torch.stack([t, -t]), w, b)
    edges = 2 * 15 * 16 + 2 * 15 * 15  # the king's-move pairs of a 16 x 16 lattice
    assert e.tolist() == [-edges, -edges] and mix["first_hit_per_site"] * 256 == -edges
    # any single flip raises the energy
    flipped = t.repeat(256, 1, 1).reshape(256, 16, 16).clone()
    flipped.view(256, -1)[torch.arange(256), torch.arange(256)] *= -1
    assert bool((king.energy64(flipped, w, b) > -edges).all())


def test_the_king_colours_are_independent_sets():
    king = load_module("reference", "king")
    masks = king.colour_masks(16, 16, "cpu").float()
    assert torch.equal(masks.sum(0), torch.ones(16, 16))
    for m in masks:
        for dy, dx in king.OFFSETS:
            assert float((m * king.shift(m, dy, dx)).sum()) == 0.0


def test_the_dense_reference_energy_and_codes():
    dense = load_module("reference", "dense")
    inst = dense.instance({"couplings": "sk", "n": 40}, None, 3, "cpu")
    J = inst["J"]
    assert torch.equal(J, J.T) and float(J.diagonal().abs().max()) == 0.0
    s = torch.where(torch.rand(5, 40, generator=torch.Generator().manual_seed(1)) < 0.5, 1.0, -1.0)
    want = [sum(float(J[i, j]) * float(x[i]) * float(x[j]) for i in range(40) for j in range(i + 1, 40))
            for x in s]
    np.testing.assert_allclose(dense.energy64(s, J, inst["b"]).numpy(), want, rtol=1e-12, atol=1e-9)
    q, scale = dense.codes(J, 8)
    assert float(q.abs().max()) == 127.0 and float((J / scale - q).abs().max()) <= 0.5 + 1e-6
    q4, _ = dense.codes(J, 4)
    assert float(q4.abs().max()) == 7.0


def test_the_reference_schedule_is_the_programs():
    from repro_torch.core import sampler_api

    schedules = load_module("reference", "schedules")
    for spec in ({"kind": "geometric", "beta0": 0.3, "beta1": 3.0},
                 {"kind": "linear", "beta0": 0.1, "beta1": 2.0}, {"kind": "constant", "beta": 1.5}):
        params = {k: v for k, v in spec.items() if k != "kind"}
        prog = getattr(sampler_api, spec["kind"])(**params).betas(2000, "cpu")
        assert torch.equal(schedules.betas(spec, 2000, "cpu"), prog)


def test_the_digit_batch_follows_its_segments():
    king = load_module("reference", "king")
    spec = json.loads((REPO / "bench" / "traffic" / "cd.json").read_text())["data"]
    clean = king.digit_batch({**spec, "flip": 0.0, "count": 2}, 1, "cpu")
    assert torch.equal(clean[0], clean[1])
    ink = set(spec["digits"]["3"])
    assert float((clean[0] > 0).sum()) == float(
        torch.stack([torch.zeros(16, 16).index_put_(
            (torch.arange(r0, r1)[:, None], torch.arange(c0, c1)[None]), torch.tensor(1.0))
            for name, (r0, r1, c0, c1) in spec["segments"].items() if name in ink]).amax(0).sum())
    noisy = king.digit_batch(spec, 1, "cpu")
    share = float((noisy != clean[0]).float().mean())
    assert 0.03 < share < 0.09  # flip 0.06
