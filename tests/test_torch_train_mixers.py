"""The recurrent mixers' training forward under autograd against the JAX
package, past the lengths the whole-model tests reach: the RG-LRU over 300
positions (9 rounds of the Hillis–Steele doubling scan against JAX's
associative_scan), the mLSTM block over 300 (past 4 chunks of 64: the
chunkwise form, a loop over chunks) and the sLSTM block over 40 (a loop
over time). The output and the gradients of x and of every weight, in
float32, within 2e-5 relative (tests/test_torch_train_common.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jrglru
from repro.models import xlstm as jxlstm
from repro_torch.models import rglru, xlstm
from test_torch_train_common import REL, configs, jax_params, port_model, rel

CASES = {"rglru": ("recurrentgemma-9b", 0, 300, jrglru.rglru_train, rglru.rglru_train),
         "mlstm": ("xlstm-125m", 0, 300, jxlstm.mlstm_block_train, xlstm.mlstm_block_train),
         "slstm": ("xlstm-125m", 1, 40, jxlstm.slstm_block_train, xlstm.slstm_block_train)}


@pytest.mark.parametrize("kind", list(CASES))
def test_mixer_train_grads_match_jax(kind):
    arch, position, S, jfn, fn = CASES[kind]
    jcfg, cfg = configs(arch)
    params = jax_params(jcfg)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["scan"][position][kind])
    mod = getattr(port_model(cfg, params).layers[position], kind)
    rng = np.random.default_rng(S)
    x = rng.normal(0, 1, (2, S, cfg.d_model)).astype(np.float32)
    w = rng.normal(0, 1, (2, S, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        out = jfn(p, x, jcfg)
        return jnp.sum(out * w), out

    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = fn(mod, xt, cfg)
    named = dict(mod.named_parameters())
    grads = torch.autograd.grad((out * torch.as_tensor(w)).sum(), [xt, *named.values()])
    assert rel(out, jout) < REL
    assert rel(grads[0], jgx) < REL
    for (name, p), g in zip(named.items(), grads[1:]):
        leaf = jgp
        for part in name.removesuffix(".weight").removesuffix(".scale").split("."):
            leaf = leaf[part]
        if isinstance(leaf, dict):
            leaf = leaf["scale"]
        want = np.asarray(leaf)
        want = want.T if name.endswith(".weight") else want
        assert rel(g, want) < REL, name
