"""`partition.reshape` and `partition.einsum` on a fake 4x4 world (meta
DTensors, a process of its own): a view of a sharded activation keeps its
layout where every DTensor release can view it so, and gathers exactly the
dimensions it could not keep otherwise; an einsum runs on each rank's
shards and places its result by the operands' labels. The cases are the
model's: q split into heads and into (KV heads, group) under GQA and MQA,
the heads merged back (head-TP, a decode step's head_dim-sharded heads),
the MoE's token flatten, the batch on two mesh axes."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import json
import torch, torch.distributed as dist
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
from repro_torch.sharding import partition

meshes = {"4x4": partition.make_mesh_compat((4, 4), ("data", "model"), "cpu"),
          "2x2x4": partition.make_mesh_compat((2, 2, 4), ("pod", "data", "model"), "cpu")}
calls = []
orig = partition._redistribute
partition._redistribute = lambda x, pl: calls.append(1) or orig(x, pl)
P = {"R": Replicate(), "P": Partial()}


def place(spec):
    return [P[s] if s in P else Shard(int(s[2:-1])) for s in spec]


def dt(shape, spec, mesh):
    t = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    return partition.distribute(t, meshes[mesh], place(spec))


def show(t):
    return [str(p).replace("Shard(dim=", "S(").replace("Replicate()", "R").replace(
        "Partial(sum)", "P").replace("P(sum)", "P") for p in t.placements]


out = {}
for name, mesh, shape, spec, to in json.loads(VIEWS):
    del calls[:]
    y = partition.reshape(dt(shape, spec, mesh), to)
    out[name] = {"placements": show(y), "shape": list(y.shape), "gathers": len(calls)}
for name, eq, operands in json.loads(EINSUMS):
    del calls[:]
    try:
        y = partition.einsum(eq, *(dt(s, p, "4x4") for s, p in operands))
        out[name] = {"placements": show(y), "shape": list(y.shape), "gathers": len(calls)}
    except ValueError as e:
        out[name] = {"error": str(e)}
dist.destroy_process_group()
print(json.dumps(out))
"""

# (name, mesh, shape, placements, view): B 8, S 16, 8 query heads of 4
VIEWS = [
    ("gqa_split_heads", "4x4", (8, 16, 32), ("S(0)", "S(2)"), (8, 16, 8, 4)),
    ("gqa_groups_divide", "4x4", (8, 16, 8, 4), ("S(0)", "S(2)"), (8, 16, 4, 2, 4)),
    ("gqa_groups_do_not_divide", "4x4", (8, 16, 8, 4), ("S(0)", "S(2)"), (8, 16, 2, 4, 4)),
    ("mqa_split_kv", "4x4", (8, 16, 4), ("S(0)", "S(2)"), (8, 16, 1, 4)),
    ("mqa_groups", "4x4", (8, 16, 8, 4), ("S(0)", "S(2)"), (8, 16, 1, 8, 4)),
    ("split_heads_do_not_divide", "4x4", (8, 16, 24), ("S(0)", "S(2)"), (8, 16, 6, 4)),
    ("merge_sharded_heads", "4x4", (8, 16, 8, 4), ("S(0)", "S(2)"), (8, 16, 32)),
    ("merge_sharded_head_dim", "4x4", (8, 1, 8, 4), ("S(0)", "S(3)"), (8, 1, 32)),
    ("moe_flatten_groups", "4x4", (8, 16, 32), ("S(0)", "R"), (128, 32)),
    ("moe_flatten_inner", "4x4", (8, 16, 32), ("R", "S(1)"), (128, 32)),
    ("merge_uneven_leading", "4x4", (6, 16, 32), ("S(0)", "R"), (96, 32)),
    ("batch_on_two_axes", "2x2x4", (8, 16, 32), ("S(0)", "S(0)", "S(2)"), (8, 16, 8, 4)),
    ("batch_on_two_axes_merged", "2x2x4", (8, 16, 32), ("S(0)", "S(0)", "S(2)"), (128, 32)),
]
WANT = {
    "gqa_split_heads": (["S(0)", "S(2)"], 0),
    "gqa_groups_divide": (["S(0)", "S(2)"], 0),
    "gqa_groups_do_not_divide": (["S(0)", "R"], 1),
    "mqa_split_kv": (["S(0)", "S(3)"], 0),
    "mqa_groups": (["S(0)", "S(3)"], 0),
    "split_heads_do_not_divide": (["S(0)", "R"], 1),
    "merge_sharded_heads": (["S(0)", "S(2)"], 0),
    "merge_sharded_head_dim": (["S(0)", "R"], 1),
    "moe_flatten_groups": (["S(0)", "R"], 0),
    "moe_flatten_inner": (["R", "R"], 1),
    "merge_uneven_leading": (["R", "R"], 1),
    "batch_on_two_axes": (["S(0)", "S(0)", "S(2)"], 0),
    "batch_on_two_axes_merged": (["S(0)", "S(0)", "S(1)"], 0),
}

# (name, equation, [(shape, placements)]): attention's score einsum under
# head-TP, context parallelism and a head_dim-sharded decode cache
EINSUMS = [
    ("scores_head_tp", "bqkgd,bskd->bkgqs",
     [((8, 16, 4, 2, 4), ("S(0)", "S(2)")), ((8, 16, 4, 4), ("S(0)", "S(2)"))]),
    ("scores_context_parallel", "bqkgd,bskd->bkgqs",
     [((8, 16, 1, 8, 4), ("S(0)", "S(1)")), ((8, 16, 1, 4), ("S(0)", "R"))]),
    ("scores_decode_head_dim", "bqkgd,bskd->bkgqs",
     [((8, 1, 1, 8, 4), ("S(0)", "S(4)")), ((8, 32, 1, 4), ("S(0)", "S(3)"))]),
    ("combine_chunks_a_replicated_operand", "bkgqs,bskd->bqkgd",
     [((8, 4, 2, 16, 16), ("S(0)", "R")), ((8, 16, 4, 4), ("S(0)", "S(2)"))]),
    ("two_labels_on_one_axis", "bqkgd,bskd->bkgqs",
     [((8, 16, 4, 2, 4), ("S(0)", "S(2)")), ((8, 16, 4, 4), ("S(0)", "S(3)"))]),
]


@pytest.fixture(scope="module")
def probed():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    code = f"VIEWS = {json.dumps(json.dumps(VIEWS))}\nEINSUMS = {json.dumps(json.dumps(EINSUMS))}\n"
    proc = subprocess.run([sys.executable, "-W", "ignore", "-c", code + _PROBE],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", [v[0] for v in VIEWS])
def test_reshape_gathers_only_what_the_view_cannot_keep(probed, name):
    """Legal views keep the layout with no redistribution; a sharded inner
    dimension of a merge, a split whose first part the axis does not
    divide and an uneven merge gather exactly their own mesh axes."""
    got = probed[name]
    to = next(v[4] for v in VIEWS if v[0] == name)
    placements, gathers = WANT[name]
    assert got["shape"] == list(to)
    assert got["placements"] == placements and got["gathers"] == gathers, got


def test_einsum_places_its_result_by_label(probed):
    """Head-TP scores stay sharded on the batch and the KV heads with no
    redistribution; context-parallel scores on the queries (k, which lacks
    that label, is read whole); a head_dim-sharded decode contraction is a
    partial sum; an operand replicated where another shards one of its
    labels is chunked locally; two labels on one mesh axis raise."""
    assert probed["scores_head_tp"] == {"placements": ["S(0)", "S(1)"],
                                        "shape": [8, 4, 2, 16, 16], "gathers": 0}
    assert probed["scores_context_parallel"] == {"placements": ["S(0)", "S(3)"],
                                                 "shape": [8, 1, 8, 16, 16], "gathers": 0}
    assert probed["scores_decode_head_dim"] == {"placements": ["S(0)", "P"],
                                                "shape": [8, 1, 8, 1, 32], "gathers": 0}
    assert probed["combine_chunks_a_replicated_operand"] == {
        "placements": ["S(0)", "S(2)"], "shape": [8, 16, 4, 2, 4], "gathers": 1}
    assert "shards labels ['d', 'k']" in probed["two_labels_on_one_axis"]["error"]
