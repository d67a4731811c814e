"""The weights carried both ways: `params_to_jax` gives the JAX
`init_params` tree (the same paths, shapes and dtypes as JAX's own) and
`params_from_jax(params_to_jax(m))` is m's state dict bit for bit, for
every arch's reduced config in float32 and bfloat16; the optimizer's
moments (named like the parameters) cross the same way."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import list_archs
from repro.train import checkpoint as jcheckpoint
from repro_torch.models import convert, model
from repro_torch.train import checkpoint
from test_torch_train_common import configs, jax_params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list_archs())
def test_params_round_trip_bit_for_bit(arch, dtype):
    jcfg, cfg = configs(arch, dtype=dtype)
    m = model.init_params(cfg, 3, "cpu")
    want = m.state_dict()
    tree = convert.params_to_jax(cfg, want)
    got = convert.params_from_jax(cfg, tree)
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    # the same tree as JAX's own init_params: paths, shapes, dtypes
    mine = checkpoint._flatten(tree)
    theirs = {k: np.asarray(v) for k, v in jcheckpoint._flatten(jax_params(jcfg)).items()}
    assert mine.keys() == theirs.keys()
    for name, t in mine.items():
        assert list(t.shape) == list(theirs[name].shape), name
        assert str(t.dtype).removeprefix("torch.") == str(theirs[name].dtype), name


def test_moments_cross_like_the_params():
    jcfg, cfg = configs("recurrentgemma-9b")
    named = dict(model.init_params(cfg, 0, "cpu").named_parameters())
    moments = {n: torch.randn(p.shape, generator=torch.Generator().manual_seed(i))
               for i, (n, p) in enumerate(named.items())}
    back = convert.params_from_jax(cfg, jax.tree.map(lambda t: t.numpy(),
                                                     convert.params_to_jax(cfg, moments)))
    assert all(torch.equal(back[n], t) for n, t in moments.items())


def test_a_tree_of_another_arch_is_refused():
    _, cfg = configs("xlstm-125m")
    _, other = configs("gemma-2b")
    tree = convert.params_to_jax(other, model.init_params(other, 0, "cpu").state_dict())
    with pytest.raises(KeyError, match="xlstm-125m"):
        convert.params_from_jax(cfg, tree)
