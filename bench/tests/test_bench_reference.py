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


@pytest.mark.parametrize("n", [4, 64, 1000])
def test_the_3regular_graph_is_simple_and_3_regular(n):
    sparse = load_module("reference", "sparse")
    inst = sparse.instance({"graph": "random_3regular_maxcut", "n": n}, None, 2**31 + n, "cpu")
    idx, w = inst["nbr_idx"].tolist(), inst["nbr_w"]
    assert inst["deg"].tolist() == [3] * n and torch.equal(w, torch.ones(n, 3))
    assert float(inst["b"].abs().max()) == 0.0
    for i, row in enumerate(idx):
        assert row == sorted(set(row)) and len(row) == 3 and i not in row
        assert all(i in idx[j] for j in row)  # every edge in both rows


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_the_sparse_colouring_is_proper_and_the_programs(seed):
    from repro_torch.core import sparse as program_sparse

    sparse = load_module("reference", "sparse")
    inst = sparse.instance({"graph": "random_3regular_maxcut", "n": 512}, None, seed, "cpu")
    masks = inst["color_masks"]
    assert torch.equal(masks.sum(0), torch.ones(512, dtype=torch.long))
    colour = masks.to(torch.int64).argmax(0)
    assert not bool((colour[inst["nbr_idx"].long()] == colour[:, None]).any())
    want = program_sparse.colors_to_masks(program_sparse.color_graph(
        inst["nbr_idx"].numpy(), inst["deg"].numpy()))
    assert np.array_equal(masks.numpy(), want)


def test_the_sparse_energy_is_the_sum_over_edges():
    sparse = load_module("reference", "sparse")
    gen = torch.Generator().manual_seed(4)
    i, j = sparse.random_3regular(40, gen)
    w = torch.randn(i.shape, generator=gen)
    inst = sparse.tables(40, i, j, w)
    inst["b"] = torch.randn(40, generator=gen)
    s = torch.where(torch.rand(5, 40, generator=gen) < 0.5, 1.0, -1.0)
    want = [sum(float(w[e]) * float(x[i[e]]) * float(x[j[e]]) for e in range(60))
            + float(inst["b"].double() @ x.double()) for x in s]
    np.testing.assert_allclose(sparse.energy64(s, inst).numpy(), want, rtol=1e-12, atol=1e-9)


def test_the_maxcut_target_is_a_cut_of_085_of_the_edges():
    mix = json.loads((REPO / "bench" / "traffic" / "colored_solve.json").read_text())
    n = json.loads((REPO / "bench" / "configs" / "maxcut3r16k.json").read_text())["n"]
    edges = 3 * n // 2
    # E = edges - 2 cut with J = +1 on every edge: a cut of 0.85 edges is E = -0.7 edges
    assert mix["first_hit_per_site"] * n == pytest.approx(edges - 2 * 0.85 * edges, rel=1e-12)
    assert mix["first_hit_per_site"] * n == pytest.approx(-0.7 * edges, rel=1e-12)
