"""The dry run's stand-ins and rules (`repro_torch.launch.specs`) against the
JAX package's, for all 11 archs x the 4 SHAPES x both production meshes
(faked by their shape, as tests/test_partition.py fakes one):
`rules_for` equal; `batch_specs` of equal shapes and dtypes; the parameter
count at full width equal; every port parameter's logical axes equal to its
JAX leaf's through `convert.jax_leaf` (the stacked "layers" axis dropped,
reversed for an nn.Linear weight), and every parameter's `checked_spec`
equal to its leaf's in the same way; the per-layer cache axes equal."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import specs as jspecs
from repro.models import model as jmodel
from repro.sharding import partition as jpartition
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import specs
from repro_torch.models import convert, layers, model
from repro_torch.models.transformer import layer_kinds, unit_plan
from repro_torch.sharding import partition

ARCHS = list_archs()


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.devices = np.empty(tuple(shape.values()))


MESHES = {"single": FakeMesh({"data": 16, "model": 16}),
          "multi": FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _port_view(jax_tuple, index, transposed):
    """A JAX leaf's per-dimension tuple (axes, spec or shape) as the port
    parameter sees it: the stacked entry dropped, reversed if transposed."""
    t = tuple(jax_tuple)[1:] if index is not None else tuple(jax_tuple)
    return t[::-1] if transposed else t


@pytest.fixture(scope="module", params=ARCHS)
def arch_pair(request):
    """(arch, the JAX param structs and axes, the port's meta model)."""
    arch = request.param
    structs, jaxes = jspecs.param_specs_and_axes(jget_config(arch))
    return arch, structs, jaxes, model.init_params(get_config(arch), 0, "meta")


def test_param_counts_and_axes_equal_jax(arch_pair):
    arch, structs, jaxes, m = arch_pair
    cfg = get_config(arch)
    n_jax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(structs))
    assert sum(p.numel() for p in m.parameters()) == n_jax
    axes = m.param_axes()
    assert axes.keys() == dict(m.named_parameters()).keys()
    for name, p in m.named_parameters():
        path, transposed, index = convert.jax_leaf(cfg, name)
        jleaf, jax_axes = _leaf(structs, path), _leaf(jaxes, path)
        assert tuple(p.shape) == _port_view(jleaf.shape, index, transposed), name
        if index is not None:
            assert jax_axes[0] == "layers", (name, jax_axes)
        assert axes[name] == _port_view(jax_axes, index, transposed), name


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("shape_name", sorted(SHAPES))
def test_rules_batches_and_param_specs_equal_jax(arch_pair, shape_name, mesh_name):
    arch, structs, jaxes, m = arch_pair
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape, jshape, mesh = SHAPES[shape_name], JSHAPES[shape_name], MESHES[mesh_name]
    rules = specs.rules_for(cfg, shape, mesh)
    assert rules == jspecs.rules_for(jcfg, jshape, mesh)
    assert specs.serve_overrides(cfg, shape).kv_cache_dtype == \
        jspecs.serve_overrides(jcfg, jshape).kv_cache_dtype

    batch, jbatch = specs.batch_specs(cfg, shape), jspecs.batch_specs(jcfg, jshape)
    assert batch.keys() == jbatch.keys()
    for k, v in batch.items():
        assert tuple(v.shape) == tuple(jbatch[k].shape) and v.device.type == "meta"
        assert str(v.dtype).removeprefix("torch.") == str(jbatch[k].dtype), k
    assert specs.batch_axes(cfg, shape) == jspecs.batch_axes(jcfg, jshape)

    with jpartition.axis_rules(mesh, rules):
        merged = jpartition._current()[-1][1]
    named = dict(m.named_parameters())
    got = partition.struct_specs({k: p.shape for k, p in named.items()},
                                 m.param_axes(), mesh, rules,
                                 transposed=layers.linear_weights(m))
    for name in named:
        path, transposed, index = convert.jax_leaf(cfg, name)
        want = jpartition.checked_spec(mesh, merged, _leaf(jaxes, path),
                                       _leaf(structs, path).shape)
        assert got[name] == _port_view(want, index, transposed), (name, got[name], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_equal_jax(arch):
    """Each layer's decode-state axes are its JAX leaf's (the stacked axis
    dropped), in the port's layer order; whisper's cross K/V after them."""
    cfg = get_config(arch)
    jax_axes = jmodel.cache_axes(jget_config(arch))
    plan, kinds = unit_plan(cfg), layer_kinds(cfg)
    got = model.cache_axes(cfg)
    n_scan = plan.n_scan * len(plan.unit)
    for i, state in enumerate(got[:len(kinds)]):
        if i < n_scan:
            want = [a[1:] for a in jax_axes["dec"]["scan"][i % len(plan.unit)]]
        else:
            want = list(jax_axes["dec"]["tail"][i - n_scan])
        assert list(state) == want, (i, state, want)
    cross = got[len(kinds):]
    if cfg.is_encdec:
        assert len(cross) == cfg.n_layers
        assert all(list(c) == [a[1:] for a in jax_axes["cross_kv"]] for c in cross)
    else:
        assert cross == []


def test_meta_specs_hold_no_memory():
    """The stand-ins are meta tensors: the whole train state of the 32B
    config, its caches and a batch, at no cost."""
    cfg = get_config("qwen1p5-32b")
    state, axes = specs.train_state_and_axes(cfg, specs.ts.TrainConfig())
    assert all(p.device.type == "meta" for p in state.params.parameters())
    assert axes.opt.mu is axes.params and axes.step == ()
    caches = specs.cache_specs(cfg, SHAPES["decode_32k"])
    assert all(t.device.type == "meta" for c in caches for t in c)
    assert torch.empty(0).device.type == "cpu"  # the default device is left alone
