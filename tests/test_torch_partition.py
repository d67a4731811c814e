"""The port's logical-axis layer (`repro_torch.sharding.partition`) against
the JAX package's: the six cases of tests/test_partition.py, and `_dedup`,
`checked_spec` and `logical_to_spec` under `axis_rules` equal to JAX's on
the same inputs (hypothesis). Meshes are faked by their shape, as
tests/test_partition.py fakes one; the DTensor side (`constrain`) runs in a
subprocess with a fake process-group world of 4 ranks."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.distributed.tensor import Replicate, Shard

from repro.sharding import partition as jpartition
from repro_torch.sharding import partition

REPO = pathlib.Path(__file__).resolve().parent.parent
AXES = ("pod", "data", "model")
LOGICAL = tuple(partition.DEFAULT_RULES) + ("layers",)


class FakeMesh:
    """A mesh's shape and axis names (both packages read no more here)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.devices = np.empty(tuple(shape.values()))


SINGLE = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})
ONE = FakeMesh({"data": 1, "model": 1})


def test_dedup_first_come_first_served():
    parts = partition._dedup(["model", "model", None, "data"])
    assert parts == ["model", None, None, "data"]
    parts2 = partition._dedup([("pod", "data"), "data", "model"])
    assert parts2 == [("pod", "data"), None, "model"]


def test_checked_spec_drops_nondividing():
    rules = {"heads": "model", "mlp": "model", "batch": "data"}
    spec = partition.checked_spec(SINGLE, rules, ("batch", "heads"), (32, 40))
    assert spec == ("data", None)  # 40 % 16 != 0 -> heads dropped
    spec2 = partition.checked_spec(SINGLE, rules, ("batch", "mlp"), (32, 64))
    assert spec2 == ("data", "model")


def test_axis_rules_filters_missing_axes():
    with partition.axis_rules(ONE, {"batch": ("pod", "data")}):
        # "pod" doesn't exist on the 2-axis mesh -> filtered to ("data",)
        assert partition.logical_to_spec(("batch", None)) == ("data", None)
    assert partition.active_mesh() is None


def test_constrain_noop_without_mesh():
    x = torch.ones((4, 4))
    assert partition.constrain(x, ("batch", "model")) is x


def test_struct_shardings_tree():
    shapes = {"a": (8, 6), "b": ()}
    axes = {"a": ("batch", "mlp"), "b": ()}
    specs = partition.struct_specs(shapes, axes, ONE)
    assert specs["a"] in ((None, None), ("data", "model")) and specs["b"] == ()
    # a mesh axis of size 1 places nothing: every placement replicated
    sh = partition.struct_shardings(shapes, axes, ONE)
    assert sh == {"a": (Replicate(), Replicate()), "b": (Replicate(), Replicate())}
    sh16 = partition.struct_shardings({"a": (32, 64)}, {"a": ("batch", "mlp")}, SINGLE)
    assert sh16["a"] == (Shard(0), Shard(1))


_CONSTRAIN = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
from torch.distributed.tensor import Replicate, Shard
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.sharding import partition
mesh = make_test_mesh((2, 2), ("data", "model"), "cpu")
x = partition.distribute(torch.ones(4, 6), mesh, (Replicate(), Replicate()))
out = {}
with partition.axis_rules(mesh, None):
    y = partition.constrain(x * 2, ("batch", "mlp"))
    out["placements"] = [str(p) for p in y.placements]
    out["local"] = list(y.to_local().shape)
    out["uneven"] = list(partition.constrain(
        partition.distribute(torch.ones(3, 6), mesh, (Replicate(), Replicate())),
        ("batch", None)).to_local().shape)
    try:
        partition.constrain(torch.ones(4, 6), ("batch", None))
    except TypeError as e:
        out["plain"] = str(e)
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_constrain_applies_on_a_mesh():
    """Under axis_rules a DTensor is redistributed to the mapped placements
    (uneven shards allowed); a plain tensor under an active mesh raises."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _CONSTRAIN], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["placements"] == ["S(0)", "S(1)"] and out["local"] == [2, 3]
    assert out["uneven"] == [2, 6]  # 3 rows over 2 ranks: 2 and 1
    assert "plain Tensor under an active mesh" in out["plain"]


@pytest.mark.parametrize("spec,placements", [
    ((("pod", "data"), None), (Shard(0), Shard(0), Replicate())),
    ((None, ("data", "model")), (Replicate(), Shard(1), Shard(1))),
    (("model", "pod"), (Shard(1), Replicate(), Shard(0))),
])
def test_spec_to_placements_in_mesh_order(spec, placements):
    assert partition.spec_to_placements(spec, MULTI) == placements


def test_tree_shardings_and_named_sharding():
    """Placements of logical axes on the mesh the rules name; None without one."""
    assert partition.named_sharding(("batch", "mlp")) is None
    got = partition.tree_shardings({"x": ("batch", None, "mlp"), "w": ("fsdp", "mlp")}, MULTI)
    assert got == {"x": (Shard(0), Shard(0), Shard(2)), "w": (Replicate(), Shard(0), Shard(1))}
    assert partition.active_mesh() is None


@pytest.mark.parametrize("spec", [(("data", "pod"), None), ("data", "data"), ("rows", None)])
def test_spec_to_placements_refuses(spec):
    with pytest.raises(ValueError):
        partition.spec_to_placements(spec, MULTI)


# ---------------------------------------------------------------------------
# the same answers as the JAX package
# ---------------------------------------------------------------------------

_part = st.one_of(st.none(), st.sampled_from(AXES),
                  st.lists(st.sampled_from(AXES), min_size=1, max_size=3).map(tuple))
_rules = st.dictionaries(st.sampled_from(LOGICAL[:-1]), _part, max_size=6)
_logical = st.lists(st.one_of(st.none(), st.sampled_from(LOGICAL)), min_size=1, max_size=4)


def _dims(n):
    return st.lists(st.sampled_from([1, 2, 3, 8, 16, 24, 32, 40, 256]), min_size=n, max_size=n)


@settings(max_examples=200, deadline=None)
@given(st.lists(_part, max_size=5))
def test_dedup_equals_jax(parts):
    assert partition._dedup(parts) == jpartition._dedup(parts)


@settings(max_examples=200, deadline=None)
@given(_rules, _logical, st.sampled_from([SINGLE, MULTI, ONE]), st.data())
def test_checked_spec_and_logical_to_spec_equal_jax(rules, logical, mesh, data):
    shape = data.draw(_dims(len(logical)))
    merged = partition._merged_rules(mesh, rules)
    with jpartition.axis_rules(mesh, rules):
        jrules = jpartition._current()[-1][1]
        want_logical = tuple(jpartition.logical_to_spec(logical))
        want_size = [jpartition.active_axis_size(a) for a in LOGICAL]
    assert merged == jrules
    with partition.axis_rules(mesh, rules):
        assert partition.logical_to_spec(logical) == want_logical
        assert [partition.active_axis_size(a) for a in LOGICAL] == want_size
    got = partition.checked_spec(mesh, merged, logical, shape)
    assert got == tuple(jpartition.checked_spec(mesh, jrules, logical, shape))
