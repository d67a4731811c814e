"""The port's serving models against the JAX package, at the reduced configs
of the dense, MoE, vlm, hybrid, ssm and audio (encoder-decoder) families.

The JAX `init_params` tree is carried across by `params_from_jax`, and the
same numpy-seeded tokens and activations go through both packages. The
prefill attention is the flash kernel's plain version here (the tensors lie
on the CPU); the JAX package runs dense attention. Tolerances:
  * float32: 2e-5 absolute and relative, the f32 flash-attention bound of
    tests/test_kernels.py; sums run in another order in each package.
  * bfloat16 (one case): the JAX package run eagerly (jax.disable_jit, so
    no excess precision inside its scan). The prefill attention's scores
    are f32 in the kernel's plain version and bf16-rounded in JAX's, and the
    difference flows on through the layers. Logits of size ~0.5 are held to
    0.03 absolute (one bf16 ulp at 0.5 is 2^-8, so about eight ulps; 1.4 ulps
    seen); each layer's caches to four bf16 ulps of the layer's largest
    value (1.5 seen, in the second layer; the first differs by one ulp).
    whisper-medium's bf16 case holds its self and cross caches the same way.
The reduced whisper-medium has 32 frames: its encoder and cross-attention
pad them to 128 keys and mask the padding by the kernel's key-length bound
on this path too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import attention, convert, layers, model, moe, transformer

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
DENSE = ["gemma-2b", "phi3-medium-14b", "phi4-mini-3p8b", "qwen1p5-32b"]
MOE = ["olmoe-1b-7b", "qwen2-moe-a2p7b"]
# vlm (with image patches), hybrid (rglru, rglru, attn_local; a tail rglru),
# ssm (mlstm, slstm)
RECURRENT = ["internvl2-2b", "recurrentgemma-9b", "xlstm-125m"]
ENCDEC = ["whisper-medium"]  # audio: encoder, cross-attention, static cross cache


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _configs(arch, **changes):
    jcfg = dataclasses.replace(jget_config(arch, reduced=True), **changes)
    cfg = dataclasses.replace(get_config(arch, reduced=True), **changes)
    return jcfg, cfg


def _models(jcfg, cfg, seed=0, biases=False):
    """JAX params (with random qkv biases if `biases`) and the port's model
    holding the same weights."""
    params, _ = jmodel.init_params(jcfg, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, params)
    if biases:
        rng = np.random.default_rng(seed)
        attn = tree["layers"]["scan"][0]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = rng.normal(0.0, 0.5, attn[name].shape).astype(attn[name].dtype)
        params = jax.tree.map(jnp.asarray, tree)
    m = model.init_params(cfg, seed, device="cpu")
    m.load_state_dict(convert.params_from_jax(cfg, tree), strict=True)
    return params, m


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _caches_close(jcaches, tcaches, cfg, **tol):
    got = convert.caches_from_jax(cfg, jax.tree.map(np.asarray, jcaches))
    assert [type(s) for s in tcaches] == [type(s) for s in got]
    for layer, (mine, theirs) in enumerate(zip(tcaches, got)):
        for name, t, j in zip(mine._fields, mine, theirs):
            np.testing.assert_allclose(_np(t), _np(j), err_msg=f"layer {layer} {name}", **tol)


def _patches(cfg, B, seed=1):
    """A vlm's stub image embeddings, N(0, 0.02) as the smoke run draws them."""
    return np.random.default_rng(seed).normal(0.0, 0.02, (B, cfg.n_patches, cfg.d_model)).astype(
        np.float32)


def _frames(cfg, B, seed=1):
    """An encoder-decoder's stub frontend embeddings, N(0, 0.02)."""
    return np.random.default_rng(seed).normal(0.0, 0.02, (B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)


def _prefill_and_decode(jcfg, cfg, params, m, n_decode=4, B=2, S=7, T=16, jit=True):
    """Prefill (after image patches for a vlm, from frames for an
    encoder-decoder) then n_decode steps in both packages, fed the same
    tokens (the JAX argmax); yields (what, JAX logits, port logits, JAX
    caches, port caches)."""
    toks = _tokens(cfg, (B, S), seed=S)
    batch, extras = {"tokens": jnp.asarray(toks)}, {}
    if cfg.family == "vlm":
        pe = _patches(cfg, B)
        batch["patch_embeds"], extras["patch_embeds"] = jnp.asarray(pe), torch.as_tensor(pe)
    if cfg.family == "audio":
        fr = _frames(cfg, B)
        batch["frames"], extras["frames"] = jnp.asarray(fr), torch.as_tensor(fr)
    jprefill = lambda p, b, c: jmodel.prefill(jcfg, p, b, c)  # noqa: E731
    jdecode = lambda p, t, pos, c: jmodel.decode_step(jcfg, p, t, pos, c)  # noqa: E731
    if jit:
        jprefill, jdecode = jax.jit(jprefill), jax.jit(jdecode)
    jl, jc = jprefill(params, batch, jmodel.init_caches(jcfg, B, T))
    tl, tc = m.prefill(torch.as_tensor(toks, dtype=torch.int64),
                       model.init_caches(cfg, B, T, device="cpu"), **extras)
    yield "prefill", jl, tl, jc, tc
    for pos in range(S, S + n_decode):
        nxt = np.argmax(np.asarray(jl, np.float32), -1).astype(np.int32)
        jl, jc = jdecode(params, jnp.asarray(nxt), jnp.asarray(pos, jnp.int32), jc)
        tl, tc = m.decode_step(torch.as_tensor(nxt, dtype=torch.int64), pos, tc)
        yield f"decode at {pos}", jl, tl, jc, tc


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT + ENCDEC)
def test_prefill_and_decode_match_jax(arch):
    jcfg, cfg = _configs(arch)
    params, m = _models(jcfg, cfg)
    steps = 0
    for what, jl, tl, jc, tc in _prefill_and_decode(jcfg, cfg, params, m):
        assert tl.shape == (2, cfg.vocab_size) and tl.dtype == torch.float32, what
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=what, **TOL)
        _caches_close(jc, tc, cfg, **TOL)
        steps += 1
    assert steps == 5


@pytest.mark.parametrize("arch,S,T", [
    ("recurrentgemma-9b", 45, 60),   # past the window of 32: the ring branch, the band
    ("recurrentgemma-9b", 100, 140),  # the band over a prompt padded to 128 rows
    ("xlstm-125m", 300, 320),         # past 4 mLSTM chunks: the chunkwise form
    ("internvl2-2b", 130, 150),       # 8 patches + 130 tokens: 138 rows, padded to 256
    ("whisper-medium", 130, 150),     # 130 queries padded to 256 over 32 frames (kv_len)
])
def test_long_prompts_match_jax(arch, S, T):
    jcfg, cfg = _configs(arch)
    params, m = _models(jcfg, cfg)
    for what, jl, tl, jc, tc in _prefill_and_decode(jcfg, cfg, params, m, n_decode=2, S=S, T=T):
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=what, **TOL)
        _caches_close(jc, tc, cfg, **TOL)


def test_windowed_dense_config_matches_jax():
    """A dense config with sliding-window layers between its global ones
    (window 4, so the 7-token prompt takes the ring branch and decode wraps
    the 4-slot ring)."""
    jcfg, cfg = _configs("phi4-mini-3p8b", block_pattern=("attn_global", "attn_local"), window=4)
    params, m = _models(jcfg, cfg)
    assert transformer.layer_kinds(cfg) == ["attn_global", "attn_local"]
    for what, jl, tl, jc, tc in _prefill_and_decode(jcfg, cfg, params, m):
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=what, **TOL)
        _caches_close(jc, tc, cfg, **TOL)
    assert tc[1].k.shape[1] == 4 and tc[0].k.shape[1] == 16


def test_vlm_positions_and_text_mask_match_jax():
    """Patches go before the text and positions run over both; JAX's text
    mask is False exactly over the patches (positions < n_patches), which
    the port leaves to the positions; without patches the text starts at 0."""
    jcfg, cfg = _configs("internvl2-2b")
    params, m = _models(jcfg, cfg)
    toks = _tokens(cfg, (2, 5), seed=4)
    pe = _patches(cfg, 2)
    jx, jpos, jmask = jmodel._embed_inputs(jcfg, params, {"tokens": jnp.asarray(toks),
                                                          "patch_embeds": jnp.asarray(pe)})
    x, pos = m._embed_inputs(torch.as_tensor(toks, dtype=torch.int64), torch.as_tensor(pe))
    np.testing.assert_allclose(_np(x), _np(jx), **TOL)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal((pos >= cfg.n_patches).numpy(), np.asarray(jmask))
    assert pos.shape == (2, cfg.n_patches + 5)
    x, pos = m._embed_inputs(torch.as_tensor(toks, dtype=torch.int64))
    assert x.shape[:2] == pos.shape == (2, 5)


def test_bf16_prefill_and_decode_match_eager_jax():
    _hold_bf16_to_eager_jax("phi4-mini-3p8b")


def test_whisper_bf16_prefill_and_decode_match_eager_jax():
    """The encoder, the self and the cross caches in bf16; hd = 16 here, so
    sqrt(hd) = 4 is exact in bf16 as whisper-medium's 8 is."""
    _hold_bf16_to_eager_jax("whisper-medium")


def _hold_bf16_to_eager_jax(arch):
    jcfg, cfg = _configs(arch, dtype="bfloat16", kv_cache_dtype="bfloat16")
    params, m = _models(jcfg, cfg)
    assert m.embed.dtype == torch.bfloat16
    with jax.disable_jit():
        for what, jl, tl, jc, tc in _prefill_and_decode(jcfg, cfg, params, m, jit=False):
            assert tl.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(tl), _np(jl), atol=0.03, rtol=0, err_msg=what)
            got = convert.caches_from_jax(cfg, jax.tree.map(np.asarray, jc))
            for layer_t, layer_j in zip(tc, got):
                for t, j in zip(layer_t, layer_j):
                    ulp = 2.0 ** (np.floor(np.log2(np.abs(_np(j)).max())) - 7)
                    np.testing.assert_allclose(_np(t), _np(j), atol=4 * ulp, rtol=0,
                                               err_msg=what)


# ---------------------------------------------------------------------------
# the layer functions one by one
# ---------------------------------------------------------------------------


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(0.0, scale, shape)).astype(np.float32)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(kind):
    x, scale = _x((2, 5, 48), 1, 3.0), _x((48,), 2) + 1.0
    want = jlayers.apply_norm(kind, {"scale": jnp.asarray(scale)}, jnp.asarray(x))
    norm = layers.Norm(48, torch.float32, "cpu")
    norm.scale.data = torch.as_tensor(scale)
    got = layers.apply_norm(kind, norm, torch.as_tensor(x))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_rope_and_sinusoidal_positions_match_jax():
    x = _x((2, 9, 3, 16), 3)
    pos = np.random.default_rng(4).integers(0, 500, (2, 9)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 10_000.0)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(layers.rope_freqs(16, 10_000.0)),
                               _np(jlayers.rope_freqs(16, 10_000.0)), **TOL)
    np.testing.assert_allclose(_np(layers.sinusoidal_positions(37, 24, torch.float32)),
                               _np(jlayers.sinusoidal_positions(37, 24, jnp.float32)), **TOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(act):
    jp, _ = jlayers.mlp_init(jax.random.key(5), 32, 64, act, jnp.float32)
    mlp = layers.mlp_init(torch.Generator().manual_seed(0), 32, 64, act, torch.float32)
    for name, w in jp.items():
        getattr(mlp, name).weight.data = torch.as_tensor(np.asarray(w).T.copy())
    x = _x((2, 5, 32), 6)
    want = jlayers.mlp_apply(jp, jnp.asarray(x), act)
    got = layers.mlp_apply(mlp, torch.as_tensor(x), act)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("softcap", [0.0, 3.0])
@pytest.mark.parametrize("scale_by_dim", [False, True])
def test_embed_and_unembed_match_jax(scale_by_dim, softcap):
    w = _x((50, 24), 7)
    toks = np.random.default_rng(8).integers(0, 50, (2, 6)).astype(np.int32)
    want = jlayers.embed_lookup(jnp.asarray(w), jnp.asarray(toks), scale_by_dim)
    got = layers.embed_lookup(torch.as_tensor(w), torch.as_tensor(toks, dtype=torch.int64),
                              scale_by_dim)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(
        _np(layers.unembed(got, torch.as_tensor(w), softcap)),
        _np(jlayers.unembed(want, jnp.asarray(w).T, softcap)), **TOL)


def test_bf16_embed_scale_is_rounded_in_bf16():
    w = torch.ones((3, 2048), dtype=torch.bfloat16)
    got = layers.embed_lookup(w, torch.tensor([[1]]), True)
    want = jlayers.embed_lookup(jnp.ones((3, 2048), jnp.bfloat16), jnp.asarray([[1]]), True)
    assert float(got[0, 0, 0]) == float(np.asarray(want, np.float32)[0, 0, 0]) == 45.25


# ---------------------------------------------------------------------------
# attention: prefill at lengths around the kernel's 128-row tiles, decode
# ---------------------------------------------------------------------------

# GQA (4 query heads over 2 KV heads), MQA (4 over 1), MHA with qkv biases
ATTN_ARCHS = ["phi4-mini-3p8b", "gemma-2b", "qwen1p5-32b"]


def _attn_pair(arch):
    jcfg, cfg = _configs(arch)
    params, m = _models(jcfg, cfg, biases=cfg.qkv_bias)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["scan"][0]["attn"])
    return jcfg, cfg, jp, m.layers[0].attn


@pytest.mark.parametrize("S", [5, 127, 128, 129, 300])
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_attn_prefill_matches_jax(arch, S):
    jcfg, cfg, jp, attn = _attn_pair(arch)
    B, T = 2, 320
    x = _x((B, S, cfg.d_model), S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jcache = jattention.init_cache(jcfg, B, T, jnp.float32)
    want, jcache = jattention.attn_prefill(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), jcache)
    cache = attention.init_cache(cfg, B, T, torch.float32, "cpu")
    got, cache = attention.attn_prefill(attn, torch.as_tensor(x), cfg, torch.as_tensor(pos), cache)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(cache.k), _np(jcache.k), **TOL)
    np.testing.assert_allclose(_np(cache.v), _np(jcache.v), **TOL)
    assert not cache.k[:, S:].any(), "only the S real keys are written"


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_attn_decode_matches_jax(arch):
    """Decode after a prefill, at the next position, past a gap of zero
    rows (the shared position clock), and at pos >= T (the write clamps)."""
    jcfg, cfg, jp, attn = _attn_pair(arch)
    B, S, T = 2, 6, 12
    x = _x((B, S, cfg.d_model), 9)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    _, jcache = jattention.attn_prefill(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                        jattention.init_cache(jcfg, B, T, jnp.float32))
    _, cache = attention.attn_prefill(attn, torch.as_tensor(x), cfg, torch.as_tensor(pos),
                                      attention.init_cache(cfg, B, T, torch.float32, "cpu"))
    for p in (S, 9, T + 2):
        x1 = _x((B, 1, cfg.d_model), p)
        want, jcache = jattention.attn_decode(jp, jnp.asarray(x1), jcfg, jnp.asarray(p, jnp.int32),
                                              jcache)
        got, cache = attention.attn_decode(attn, torch.as_tensor(x1), cfg, p, cache)
        np.testing.assert_allclose(_np(got), _np(want), err_msg=f"pos {p}", **TOL)
        np.testing.assert_allclose(_np(cache.k), _np(jcache.k), **TOL)
        np.testing.assert_allclose(_np(cache.v), _np(jcache.v), **TOL)


def test_causal_mask_matches_jax():
    for args in ((5, 7, 0, 0), (4, 9, 3, 2), (1, 6, 0, 5)):
        np.testing.assert_array_equal(attention.causal_mask(*args).numpy(),
                                      np.asarray(jattention.causal_mask(*args)))


# ---------------------------------------------------------------------------
# MoE: dropped tokens, the Boltzmann router fed JAX's Gumbel draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("router", ["topk", "boltzmann"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_drops_tokens_and_matches_jax(arch, router):
    base = jget_config(arch, reduced=True).moe
    moe_cfg = dataclasses.replace(base, capacity_factor=0.5, router_mode=router, router_temp=0.7)
    jcfg, cfg = _configs(arch, moe=moe_cfg)
    params, m = _models(jcfg, cfg)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["scan"][0]["moe"])
    block = m.layers[0].moe
    B, S = 2, 40  # 80 tokens: groups of 64, the second padded
    x = _x((B, S, cfg.d_model), 11)
    key = jax.random.key(12) if router == "boltzmann" else None
    want, want_aux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, key)
    G, gs = 2, min(moe_cfg.group_size, B * S)
    gumbel = None
    if key is not None:
        # passlint: ignore[PASS001] the test replays the router's own draws from its key
        gumbel = torch.tensor(np.asarray(jax.random.gumbel(key, (G, gs, moe_cfg.n_experts))))
    got, aux = moe.moe_apply(block, torch.as_tensor(x), cfg, gumbel, with_aux=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), **TOL)
    # capacity binds: with room for every token the output differs
    roomy = dataclasses.replace(cfg, moe=dataclasses.replace(moe_cfg, capacity_factor=8.0))
    undropped = moe.moe_apply(block, torch.as_tensor(x), roomy, gumbel)
    assert moe._capacity(gs, moe_cfg) < gs * moe_cfg.top_k / moe_cfg.n_experts
    assert not torch.allclose(got, undropped, **TOL)


def test_boltzmann_router_needs_its_draws():
    base = get_config("olmoe-1b-7b", reduced=True)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, router_mode="boltzmann"))
    m = model.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="Gumbel"):
        moe.moe_apply(m.layers[0].moe, torch.zeros((1, 3, cfg.d_model)), cfg)


def test_capacity_matches_jax():
    for n_experts, top_k, cf in ((8, 2, 4.0), (64, 8, 1.25), (60, 4, 1.25), (8, 2, 0.5)):
        m = jget_config("olmoe-1b-7b").moe
        m = dataclasses.replace(m, n_experts=n_experts, top_k=top_k, capacity_factor=cf)
        for gs in (1, 4, 15, 64, 256):
            assert moe._capacity(gs, m) == jmoe._capacity(gs, m)


def test_caches_from_jax_reads_tuples_and_named_caches():
    jcfg, cfg = _configs("recurrentgemma-9b")
    jc = jax.tree.map(np.asarray, jmodel.init_caches(jcfg, 2, 8))
    as_tuples = {"dec": jax.tree.map(tuple, jc["dec"],
                                     is_leaf=lambda x: hasattr(x, "_fields"))}
    for tree in (jc, as_tuples):
        got = convert.caches_from_jax(cfg, tree)
        assert [type(s).__name__ for s in got] == ["RGLRUState", "RGLRUState", "KVCache",
                                                   "RGLRUState"]
        assert got[2].k.shape == (2, 8, cfg.n_kv_heads, cfg.resolved_head_dim)  # min(8, window)
        assert got[3].h.shape == (2, cfg.lru_width) and got[3].h.dtype == torch.float32


# ---------------------------------------------------------------------------
# the audio encoder-decoder: encoder, cross-attention, the reference's quirks
# ---------------------------------------------------------------------------


def _whisper():
    jcfg, cfg = _configs("whisper-medium")
    params, m = _models(jcfg, cfg)
    return jcfg, cfg, params, m


@pytest.mark.parametrize("S", [5, 127, 128, 129, 300])
def test_attn_encoder_matches_jax(S):
    """Non-causal attention without RoPE (the JAX encoder's attn_train call)
    at lengths around the kernel's 128-key tiles: the padded keys are masked
    by kv_len = S."""
    jcfg, cfg, params, m = _whisper()
    jp = jax.tree.map(lambda a: a[0], params["enc_layers"]["attn"])
    x = _x((2, S, cfg.d_model), S)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (2, S))
    want = jattention.attn_train(jp, jnp.asarray(x), jcfg, pos, causal=False, rope=False)
    got = attention.attn_encoder(m.enc_layers[0].attn, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("S,T", [(7, 32), (1, 32), (130, 300)])
def test_cross_kv_and_attn_cross_match_jax(S, T):
    """cross_kv, and cross-attention over T encoder positions at prefill
    (through the kernel's plain version: queries and keys padded, kv_len =
    T) and in plain torch (the decode path), against the JAX attn_cross."""
    jcfg, cfg, params, m = _whisper()
    jp = jax.tree.map(lambda a: a[0], params["cross"]["attn"])
    attn = m.cross[0].attn
    enc, x = _x((2, T, cfg.d_model), T), _x((2, S, cfg.d_model), S + 1)
    jkv = jattention.cross_kv(jp, jnp.asarray(enc), jcfg)
    kv = attention.cross_kv(attn, torch.as_tensor(enc), cfg)
    for mine, theirs in zip(kv, jkv):
        np.testing.assert_allclose(_np(mine), _np(theirs), **TOL)
    want = jattention.attn_cross(jp, jnp.asarray(x), jkv, jcfg)
    np.testing.assert_allclose(
        _np(attention.attn_cross_prefill(attn, torch.as_tensor(x), kv, cfg)), _np(want), **TOL)
    np.testing.assert_allclose(_np(attention.attn_cross(attn, torch.as_tensor(x), kv, cfg)),
                               _np(want), **TOL)


def test_encode_matches_jax():
    jcfg, cfg, params, m = _whisper()
    fr = _frames(cfg, 2)
    want = jmodel.encode(jcfg, params, jnp.asarray(fr))
    got = m.encode(torch.as_tensor(fr))
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_whisper_quirk_a_serving_self_attention_applies_rope():
    """The JAX prefill's decoder self-attention takes attn_prefill's default
    rope=True; its training path passes rope=False. The port's prefill
    follows the serving path: it equals the JAX prefill, and the logits of
    the training path's decoder (rope=False) differ from both."""
    jcfg, cfg, params, m = _whisper()
    toks, fr = _tokens(cfg, (2, 9), seed=3), _frames(cfg, 2)
    want, _ = jmodel.prefill(jcfg, params, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)},
                             jmodel.init_caches(jcfg, 2, 16))
    got, _ = m.prefill(torch.as_tensor(toks, dtype=torch.int64),
                       model.init_caches(cfg, 2, 16, device="cpu"), frames=torch.as_tensor(fr))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    enc = jmodel.encode(jcfg, params, jnp.asarray(fr))
    x = jlayers.embed_lookup(params["embed"], jnp.asarray(toks), jcfg.embed_scale)
    x = x + jlayers.sinusoidal_positions(9, jcfg.d_model, x.dtype)[None]
    positions = jnp.broadcast_to(jnp.arange(9, dtype=jnp.int32), (2, 9))
    x = jmodel._decoder_encdec(jcfg, params, x, positions, enc, None)
    no_rope = jmodel._final_logits(jcfg, params, x[:, -1:])[:, 0]
    assert np.abs(_np(no_rope) - _np(want)).max() > 100 * TOL["atol"]


def test_whisper_quirk_c_decode_clamps_the_position_table():
    """Decode adds row pos of a 4096-row sinusoid table; past row 4095 the
    JAX gather clamps the row, and the port does the same: at pos 4100 and
    5000 (the self-attention write clamps to the cache's last slot too)
    both packages agree. The self caches' keys are held to 1e-4 absolute:
    their RoPE angles reach 5000 rad, where the two packages' float32 sin
    and cos differ by about 1e-5 (2.3e-5 seen on keys of ~1)."""
    jcfg, cfg, params, m = _whisper()
    toks, fr = _tokens(cfg, (2, 5), seed=5), _frames(cfg, 2)
    jl, jc = jmodel.prefill(jcfg, params, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)},
                            jmodel.init_caches(jcfg, 2, 8))
    tl, tc = m.prefill(torch.as_tensor(toks, dtype=torch.int64),
                       model.init_caches(cfg, 2, 8, device="cpu"), frames=torch.as_tensor(fr))
    for pos in (4095, 4100, 5000):
        nxt = np.argmax(np.asarray(jl, np.float32), -1).astype(np.int32)
        jl, jc = jmodel.decode_step(jcfg, params, jnp.asarray(nxt), jnp.asarray(pos, jnp.int32), jc)
        tl, tc = m.decode_step(torch.as_tensor(nxt, dtype=torch.int64), pos, tc)
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=f"pos {pos}", **TOL)
        _caches_close(jc, tc, cfg, atol=1e-4, rtol=2e-5)
    assert model.DECODE_POSITIONS == 4096


def test_whisper_prefill_needs_frames_of_the_encoder_length():
    """No frames is a KeyError, as the JAX prefill's batch["frames"]; frames
    that are not (B, T, d_model) a ValueError. The encoder length T is the
    frames' own: the JAX prefill builds its cross caches from the frames it
    is given (test_whisper_prefill_at_another_frame_count_matches_jax)."""
    jcfg, cfg, params, m = _whisper()
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(KeyError, match="frames"):
        m.prefill(toks, model.init_caches(cfg, 1, 8, device="cpu"))
    with pytest.raises(KeyError):
        jmodel.prefill(jcfg, params, {"tokens": jnp.zeros((1, 4), jnp.int32)},
                       jmodel.init_caches(jcfg, 1, 8))
    for shape in ((1, cfg.encoder_seq, cfg.d_model + 1), (cfg.encoder_seq, cfg.d_model)):
        with pytest.raises(ValueError, match="d_model"):
            m.prefill(toks, model.init_caches(cfg, 1, 8, device="cpu"),
                      frames=torch.zeros(shape))


@pytest.mark.parametrize("T", [20, 45])
def test_whisper_prefill_at_another_frame_count_matches_jax(T):
    """Frames of T != encoder_seq: the prefill's logits and its T-row cross
    caches (one per decoder layer, in place of the encoder_seq-row ones it
    was given) equal the JAX prefill's, and a decode step over them the JAX
    step's, in f32 within 2e-5."""
    jcfg, cfg, params, m = _whisper()
    assert T != cfg.encoder_seq
    toks = _tokens(cfg, (2, 6), seed=T)
    fr = np.random.default_rng(T).normal(0.0, 0.02, (2, T, cfg.d_model)).astype(np.float32)
    jl, jc = jmodel.prefill(jcfg, params, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)},
                            jmodel.init_caches(jcfg, 2, 16))
    tl, tc = m.prefill(torch.as_tensor(toks, dtype=torch.int64),
                       model.init_caches(cfg, 2, 16, device="cpu"), frames=torch.as_tensor(fr))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    L = cfg.n_layers
    jk, jv = (np.asarray(a) for a in jc["cross_kv"])
    for i, kv in enumerate(tc[L:]):
        assert kv.k.shape == (2, T, cfg.n_kv_heads, cfg.resolved_head_dim)
        np.testing.assert_allclose(_np(kv.k), jk[i], err_msg=f"layer {i} k", **TOL)
        np.testing.assert_allclose(_np(kv.v), jv[i], err_msg=f"layer {i} v", **TOL)
    nxt = np.argmax(np.asarray(jl, np.float32), -1).astype(np.int32)
    jl, _ = jmodel.decode_step(jcfg, params, jnp.asarray(nxt), jnp.asarray(6, jnp.int32), jc)
    tl, _ = m.decode_step(torch.as_tensor(nxt, dtype=torch.int64), 6, tc)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


def test_whisper_caches_are_decoder_then_cross_states():
    cfg = get_config("whisper-medium", reduced=True)
    caches = model.init_caches(cfg, 3, 8, device="cpu")
    L = cfg.n_layers
    assert [type(c).__name__ for c in caches] == ["KVCache"] * L + ["CrossKV"] * L
    assert caches[L].k.shape == (3, cfg.encoder_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    m = model.init_params(cfg, 0, device="cpu")
    assert isinstance(m, model.EncoderDecoderLM) and len(m.enc_layers) == cfg.n_encoder_layers
    assert len(m.cross) == L
