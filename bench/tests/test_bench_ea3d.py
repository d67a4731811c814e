"""The 3D +-J Edwards-Anderson reference (`bench/reference/ea3d.py`) holds the
law its configuration states: a periodic cubic lattice of degree 6, each
edge once, couplings +-1 with both signs drawn, b = 0, and a greedy
colouring that is the two parity classes at even L."""
import json

import pytest
import torch

from bench.common import load_module
from bench_tiny import REPO

ea3d = load_module("reference", "ea3d")


@pytest.mark.parametrize("L", [4, 16])
def test_the_lattice_couplings_and_colouring(L):
    n = L**3
    inst = ea3d.instance({"L": L}, None, 2**31 + L, "cpu")
    idx, w, deg = inst["nbr_idx"].long(), inst["nbr_w"], inst["deg"]
    assert idx.shape == w.shape == (n, 6) and bool((deg == 6).all())
    assert not bool(inst["b"].any())
    # each site's slots are its six lattice neighbours, ascending
    z, y, x = torch.meshgrid(*(torch.arange(L),) * 3, indexing="ij")
    site = lambda x, y, z: (x % L + L * ((y % L) + L * (z % L))).flatten()  # noqa: E731
    want = torch.stack([site(x + dx, y + dy, z + dz) for dx, dy, dz in
                        ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))], 1)
    assert torch.equal(idx, want.sort(1).values)
    # each undirected edge once: 3 n of them, with the same coupling both ways
    rows = torch.arange(n)[:, None].expand(n, 6)
    assert bool((idx != rows).all())
    J = torch.zeros((n, n))
    J[rows.flatten(), idx.flatten()] = w.flatten()
    assert torch.equal(J, J.T) and int((J != 0).sum()) == 2 * 3 * n
    assert set(w.unique().tolist()) == {-1.0, 1.0}
    assert abs(float((w == 1).float().mean()) - 0.5) < 0.1
    # the greedy colouring is the checkerboard
    masks = inst["color_masks"]
    parity = ((x + y + z) % 2).flatten()
    assert masks.shape == (2, n) and torch.equal(masks[0], parity == 0)
    assert torch.equal(masks[1], parity == 1)


def test_the_couplings_come_from_the_seed():
    a = ea3d.instance({"L": 4}, None, 7, "cpu")
    b = ea3d.instance({"L": 4}, None, 7, "cpu")
    c = ea3d.instance({"L": 4}, None, 8, "cpu")
    assert torch.equal(a["nbr_w"], b["nbr_w"]) and not torch.equal(a["nbr_w"], c["nbr_w"])


def test_the_configuration_states_what_the_reference_builds():
    config = json.loads((REPO / "bench" / "configs" / "ea3d80.json").read_text())
    assert config["reference"] == "ea3d" and config["L"] == 80 and config["tiny"] == {"L": 4}
    assert ea3d.KIND == "sparse" and ea3d.Model.__name__ == "Model"
    with pytest.raises(ValueError, match="L >= 3"):
        ea3d.edges(2, "cpu")
