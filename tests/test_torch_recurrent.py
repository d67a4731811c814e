"""The port's recurrent and sliding-window blocks against the JAX package.

RG-LRU (`models/rglru.py`), mLSTM and sLSTM (`models/xlstm.py`) and the
attn_local ring cache, at the reduced recurrentgemma-9b and xlstm-125m
configs in float32, with the JAX weights carried across by
`params_from_jax` and the same numpy-seeded activations in both packages.

Tolerances, absolute and relative:
  * 2e-5, the float32 bound of tests/test_torch_models.py, where both
    packages run the same ops in another summation order (matmuls,
    einsums).
  * The RG-LRU prompt scan: the port's Hillis-Steele doubling and JAX's
    `associative_scan` multiply the decays in another order. With a < 1 the
    products only shrink, so each h differs by a few f32 roundings of its
    own size: 2e-5 holds there as well (about 1e-6 seen).
  * mLSTM: torch's `cumsum` and `cummax` may round otherwise than XLA's; the
    parallel, chunkwise and recurrent forms compute the same math in other
    orders, and the JAX docstring promises they agree. 2e-5 for each form
    against JAX and against each other (about 1e-8 seen, at outputs of
    about 0.05).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.models import rglru as jrglru
from repro.models import transformer as jtransformer
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_config
from repro_torch.models import convert, model, rglru, transformer, xlstm

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _x(shape, seed, scale=1.0):
    return np.random.default_rng(seed).normal(0.0, scale, shape).astype(np.float32)


def _pair(arch, **changes):
    """(JAX config, port config, JAX params, the port's model holding them)."""
    jcfg = dataclasses.replace(jget_config(arch, reduced=True), **changes)
    cfg = dataclasses.replace(get_config(arch, reduced=True), **changes)
    params, _ = jmodel.init_params(jcfg, jax.random.key(0))
    m = model.init_params(cfg, 0, device="cpu")
    m.load_state_dict(convert.params_from_jax(cfg, jax.tree.map(np.asarray, params)))
    return jcfg, cfg, params, m


def _layer(params, cfg, i):
    """Layer i's JAX parameter tree (unstacked), as the port numbers layers."""
    plan = transformer.unit_plan(cfg)
    n = plan.n_scan * len(plan.unit)
    if i < n:
        u, p = divmod(i, len(plan.unit))
        return jax.tree.map(lambda a: a[u], params["layers"]["scan"][p])
    return params["layers"]["tail"][i - n]


def _close(got, want, what="", **tol):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **(tol or TOL))


def _states_close(got, want, what=""):
    for name, g, w in zip(got._fields, got, want):
        _close(g, w, f"{what} {name}")


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 2, 5, 64, 100])
def test_linear_scan_matches_jax_associative_scan(S):
    """Decays in (0, 1) and inputs of either sign, as the gates give them."""
    a = np.random.default_rng(S).uniform(0.5, 1.0, (2, S, 8)).astype(np.float32)
    b = _x((2, S, 8), S + 1)
    _, want = jax.lax.associative_scan(lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]),
                                       (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = rglru.linear_scan(torch.as_tensor(a), torch.as_tensor(b))
    _close(got, want)
    h, seq = np.zeros((2, 8), np.float64), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    _close(got, np.stack(seq, 1))


@pytest.mark.parametrize("S", [1, 2, 3, 17, 64])
def test_rglru_train_and_prefill_state_match_jax(S):
    """The block's output, and the (h, conv window) state after a prompt,
    the conv window zero-padded where the prompt is shorter than it."""
    jcfg, cfg, params, m = _pair("recurrentgemma-9b")
    jp, block = _layer(params, cfg, 0), m.layers[0]
    x = _x((2, S, cfg.d_model), S)
    _close(rglru.rglru_train(block.rglru, torch.as_tensor(x), cfg),
           jrglru.rglru_train(jp["rglru"], jnp.asarray(x), jcfg))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    want, jstate = jtransformer.block_prefill(jp, "rglru", jnp.asarray(x), jcfg,
                                              jnp.asarray(pos), jrglru.rglru_init_state(
                                                  jcfg, 2, jnp.float32))
    state = transformer.block_cache_init("rglru", cfg, 2, 16, "cpu")
    got, state = transformer.block_prefill(block, "rglru", torch.as_tensor(x), cfg,
                                           torch.as_tensor(pos), state)
    _close(got, want)
    _states_close(state, jstate, f"S {S}")


def test_rglru_decode_matches_jax():
    jcfg, cfg, params, m = _pair("recurrentgemma-9b")
    jp, block = _layer(params, cfg, 3)["rglru"], m.layers[3].rglru  # the tail layer
    jstate = jrglru.rglru_init_state(jcfg, 2, jnp.float32)
    state = rglru.rglru_init_state(cfg, 2, torch.float32, "cpu")
    for t in range(6):
        x = _x((2, 1, cfg.d_model), 30 + t)
        want, jstate = jrglru.rglru_decode(jp, jnp.asarray(x), jcfg, jstate)
        got, state = rglru.rglru_decode(block, torch.as_tensor(x), cfg, state)
        _close(got, want, f"step {t}")
        _states_close(state, jstate, f"step {t}")


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm(chunk=64):
    jcfg, cfg, params, m = _pair("xlstm-125m", mlstm_chunk=chunk)
    return jcfg, cfg, _layer(params, cfg, 0)["mlstm"], m.layers[0].mlstm


@pytest.mark.parametrize("S", [1, 9, 40])
def test_mlstm_parallel_matches_jax(S):
    jcfg, cfg, jp, mod = _mlstm()
    a = _x((2, S, 2 * cfg.d_model), S)
    _close(xlstm.mlstm_parallel(mod, torch.as_tensor(a), cfg.n_heads),
           jxlstm.mlstm_parallel(jp, jnp.asarray(a), cfg.n_heads))


@pytest.mark.parametrize("S,chunk", [(300, 64), (256, 64), (37, 8), (5, 8)])
def test_mlstm_chunkwise_matches_jax_and_the_other_forms(S, chunk):
    """S > 4 chunks (the block's switch), a multiple of the chunk and not
    one (a padded last chunk); against JAX, then the parallel form and the
    recurrent step, as JAX's docstring promises, output and final state."""
    jcfg, cfg, jp, mod = _mlstm(chunk)
    a = _x((2, S, 2 * cfg.d_model), S + chunk)
    got, state = xlstm.mlstm_chunkwise(mod, torch.as_tensor(a), cfg.n_heads, chunk)
    want, jstate = jxlstm.mlstm_chunkwise(jp, jnp.asarray(a), cfg.n_heads, chunk)
    _close(got, want)
    _states_close(state, jstate)
    _close(got, xlstm.mlstm_parallel(mod, torch.as_tensor(a), cfg.n_heads))
    step = xlstm.mlstm_init_state(cfg, 2, "cpu")
    for t in range(S):
        h, step = xlstm.mlstm_step(mod, torch.as_tensor(a[:, t]), cfg.n_heads, step)
        _close(h, got[:, t], f"step {t}")
    _states_close(step, state)


def test_mlstm_step_matches_jax():
    jcfg, cfg, jp, mod = _mlstm()
    jstate = jxlstm.mlstm_init_state(jcfg, 2)
    state = xlstm.mlstm_init_state(cfg, 2, "cpu")
    # -1e30, not -inf: log_f + m - m_new stays finite
    assert torch.equal(state.m, torch.full_like(state.m, -1e30))
    for t in range(5):
        a = _x((2, 2 * cfg.d_model), 50 + t)
        want, jstate = jxlstm.mlstm_step(jp, jnp.asarray(a), cfg.n_heads, jstate)
        got, state = xlstm.mlstm_step(mod, torch.as_tensor(a), cfg.n_heads, state)
        _close(got, want, f"step {t}")
        _states_close(state, jstate, f"step {t}")


@pytest.mark.parametrize("S", [7, 300])
def test_mlstm_block_train_matches_jax(S):
    """The parallel form up to 4 chunks, the chunkwise one above."""
    jcfg, cfg, params, m = _pair("xlstm-125m")
    x = _x((2, S, cfg.d_model), S)
    _close(xlstm.mlstm_block_train(m.layers[0].mlstm, torch.as_tensor(x), cfg),
           jxlstm.mlstm_block_train(_layer(params, cfg, 0)["mlstm"], jnp.asarray(x), jcfg))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 12])
def test_slstm_scan_and_blocks_match_jax(S):
    jcfg, cfg, params, m = _pair("xlstm-125m")
    jp, mod = _layer(params, cfg, 1)["slstm"], m.layers[1].slstm
    x = _x((2, S, cfg.d_model), S)
    hs, state = xlstm.slstm_scan(mod, torch.as_tensor(x), cfg,
                                 xlstm.slstm_init_state(cfg, 2, "cpu"))
    jhs, jstate = jxlstm.slstm_scan(jp, jnp.asarray(x), jcfg, jxlstm.slstm_init_state(jcfg, 2))
    _close(hs, jhs)
    _states_close(state, jstate)
    _close(xlstm.slstm_block_train(mod, torch.as_tensor(x), cfg),
           jxlstm.slstm_block_train(jp, jnp.asarray(x), jcfg))
    step, jstep = xlstm.slstm_init_state(cfg, 2, "cpu"), jxlstm.slstm_init_state(jcfg, 2)
    for t in range(S):
        got, step = xlstm.slstm_block_decode(mod, torch.as_tensor(x[:, t:t + 1]), cfg, step)
        want, jstep = jxlstm.slstm_block_decode(jp, jnp.asarray(x[:, t:t + 1]), jcfg, jstep)
        _close(got, want, f"step {t}")
    _states_close(step, state)


# ---------------------------------------------------------------------------
# attn_local: the sliding window and its ring cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,max_len", [(5, 48), (45, 64), (40, 40), (20, 24)])
def test_attn_local_ring_prefill_and_decode_across_a_wrap_match_jax(S, max_len):
    """recurrentgemma's attn_local layer (window 32, MQA): prompts shorter
    than the window and longer (block_prefill's ring branch: the band on the
    kernel's plain version, the last 32 keys at pos % 32), then decode steps
    that carry the ring's write index across its end; a max_len under the
    window keeps a cache of max_len slots."""
    jcfg, cfg, params, m = _pair("recurrentgemma-9b")
    jp, block = _layer(params, cfg, 2), m.layers[2]
    T = min(max_len, cfg.window)
    x = _x((2, S, cfg.d_model), S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    jcache = jtransformer.block_cache_init("attn_local", jcfg, 2, max_len)
    cache = transformer.block_cache_init("attn_local", cfg, 2, max_len, "cpu")
    assert cache.k.shape[1] == jcache.k.shape[1] == T
    want, jcache = jtransformer.block_prefill(jp, "attn_local", jnp.asarray(x), jcfg,
                                              jnp.asarray(pos), jcache)
    got, cache = transformer.block_prefill(block, "attn_local", torch.as_tensor(x), cfg,
                                           torch.as_tensor(pos), cache)
    _close(got, want)
    _states_close(cache, jcache, "prefill")
    steps = range(S, S + T + 3) if S + T + 3 <= max_len + T else range(S, S + 4)
    for p in steps:
        x1 = _x((2, 1, cfg.d_model), 100 + p)
        want, jcache = jtransformer.block_decode(jp, "attn_local", jnp.asarray(x1), jcfg,
                                                 jnp.asarray(p, jnp.int32), jcache)
        got, cache = transformer.block_decode(block, "attn_local", torch.as_tensor(x1), cfg, p,
                                              cache)
        _close(got, want, f"pos {p}")
        _states_close(cache, jcache, f"pos {p}")


def test_the_ring_holds_the_last_window_of_keys():
    """After a prompt of 45 tokens and 40 decode steps, slot s of the
    32-slot ring holds position p with p % 32 == s among the last 32."""
    _, cfg, _, m = _pair("recurrentgemma-9b")
    block, S = m.layers[2], 45
    cache = transformer.block_cache_init("attn_local", cfg, 1, 128, "cpu")
    x = torch.as_tensor(_x((1, S, cfg.d_model), 3))
    pos = torch.arange(S, dtype=torch.int32)[None]
    transformer.block_prefill(block, "attn_local", x, cfg, pos, cache)
    written = {}
    for p in range(S, S + 40):
        transformer.block_decode(block, "attn_local", torch.as_tensor(_x((1, 1, cfg.d_model), p)),
                                 cfg, p, cache)
        written[p % 32] = cache.k[0, p % 32].clone()
    for s, k in written.items():
        assert torch.equal(cache.k[0, s], k)
    assert len(written) == 32


def test_block_kinds_and_layer_order_follow_the_unit_plan():
    """recurrentgemma-9b: 12 units of (rglru, rglru, attn_local) and a tail
    of two rglru layers; the reduced config one unit and one tail layer."""
    full = get_config("recurrentgemma-9b")
    kinds = transformer.layer_kinds(full)
    assert len(kinds) == 38 and kinds[-2:] == ["rglru", "rglru"]
    assert kinds[:36] == ["rglru", "rglru", "attn_local"] * 12
    assert transformer.layer_kinds(get_config("xlstm-125m")) == ["mlstm", "slstm"] * 6
    with pytest.raises(ValueError, match="unknown block kind"):
        transformer.block_init(torch.Generator().manual_seed(0), "attn_cross",
                               get_config("xlstm-125m", reduced=True), torch.float32)
