"""The training attention against the JAX package's `attn_train`: the
output and the gradients of x and of the attention's weights, in float32,
within 2e-5 relative (tests/test_torch_train_common.py). At S = 4100, past
BLOCKWISE_THRESHOLD = 4096, both packages take the blockwise path (queries
in blocks of 1024) on each of its three branches: causal, banded (a window
of 600 reaching across query blocks) and bidirectional without RoPE (an
encoder's); at S = 40 the dense path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattention
from repro_torch.models import attention
from test_torch_train_common import REL, configs, jax_params, port_model, rel

BRANCHES = {"causal": dict(window=0, causal=True, rope=True),
            "banded": dict(window=600, causal=True, rope=True),
            "bidirectional": dict(window=0, causal=False, rope=False)}


@pytest.mark.parametrize("S", [40, 4100])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_attn_train_matches_jax(branch, S):
    kw = BRANCHES[branch]
    if S < 1000 and kw["window"]:
        kw = dict(kw, window=9)
    assert (S > attention.BLOCKWISE_THRESHOLD) == (S > jattention.BLOCKWISE_THRESHOLD)
    assert attention.Q_BLOCK == jattention.Q_BLOCK
    jcfg, cfg = configs("gemma-2b")  # 4 query heads over 1 KV head, hd = 16
    params = jax_params(jcfg)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["scan"][0]["attn"])
    block = port_model(cfg, params).layers[0].attn
    rng = np.random.default_rng(S)
    x = rng.normal(0, 1, (1, S, cfg.d_model)).astype(np.float32)
    w = rng.normal(0, 1, (1, S, cfg.d_model)).astype(np.float32)
    positions = np.arange(S, dtype=np.int32)[None]

    def jloss(p, x):
        out = jattention.attn_train(p, x, jcfg, jnp.asarray(positions), **kw)
        return jnp.sum(out * w), out

    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = attention.attn_train(block, xt, cfg, torch.as_tensor(positions), **kw)
    params_t = dict(block.named_parameters())
    grads = torch.autograd.grad((out * torch.as_tensor(w)).sum(), [xt, *params_t.values()])
    assert rel(out, jout) < REL
    assert rel(grads[0], jgx) < REL
    for (name, _), g in zip(params_t.items(), grads[1:]):
        assert rel(g, np.asarray(jgp[name.split(".")[0]]).T) < REL, name
