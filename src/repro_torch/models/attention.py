"""Attention: MHA / GQA / MQA, causal, sliding-window and non-causal prefill
on the flash kernel, KV-cache decode, cross-attention over an encoder, and
the training forward in plain differentiable torch ops.

The port of `repro/models/attention.py`. Training:
  * `attn_train` — the whole sequence, causal (banded with `window` > 0)
    or bidirectional (an encoder's), with or without RoPE: dense attention
    (`_attn_dense`) up to BLOCKWISE_THRESHOLD tokens and blockwise above it
    (`_attn_blockwise`, queries in blocks of Q_BLOCK), as in the JAX
    package, with its rounding (see below). It never reaches the flash
    kernel, which has no backward in either package.
Serving:
  * `attn_prefill` — causal attention over the prompt through
    `ops.flash_attention` (on a CUDA tensor the hand-written bf16 wgmma + TMA
    kernel, on a CPU tensor its plain version) at every length, where the
    JAX package runs dense attention up to 4096 tokens and blockwise above;
    a sliding-window layer (`window` > 0) passes its band to the kernel
    once the prompt is longer than the window. It writes the prompt's K/V
    into the cache, or its last T keys at pos % T into a ring of T slots.
  * `attn_decode` — one query token against the whole cache under a
    validity mask, in plain torch ops as in the JAX package: the flash
    kernel takes query lengths that are multiples of 128 only, with the
    causal mask aligned at the top left. A sliding-window layer's cache is
    a ring of min(max_len, window) slots written at pos % T.
  * `attn_encoder` — non-causal attention without RoPE over an encoder's
    frames (the JAX package's `attn_train(..., causal=False, rope=False)`),
    through `ops.flash_attention(..., causal=False, kv_len=S)`: the keys are
    padded to a multiple of 128 and the padding masked by the kernel's
    key-length bound.
  * `cross_kv`, `attn_cross_prefill` and `attn_cross` — cross-attention of
    decoder queries over an encoder's K/V: at prefill through the kernel
    (non-causal, the encoder's length as kv_len), at decode (one query) in
    plain torch ops with the JAX package's rounding, as `attn_decode` does.
    As in the JAX package, the cross projections take no qkv biases.

RoPE is applied to every query and key of the self-attention, as the JAX
package's `attn_prefill` and `attn_decode` do by default (serving never
turns it off there); the encoder and the cross-attention take none.

Layout: activations (B, S, D); heads split as (B, S, H, hd); KV cache
(B, T, K, hd) in `kv_cache_dtype`, written in place. Query head h reads KV
head h // G (G = H / K), the JAX package's grouping.

Softmax scale: the kernel and its plain version scale the scores by
1/sqrt(hd) in float32; the JAX package divides scores in the activation
dtype by sqrt(hd) rounded to that dtype (11.3125 for 11.3137 in bf16 at
hd = 128). In float32 the two agree; in bf16 the difference is deliberate.
Decode and training keep the JAX package's rounding. At hd = 64 (whisper-medium)
sqrt(hd) = 8 is exact in every dtype, so the kernel's f32 scale and the JAX
package's bf16 division agree and the difference does not arise.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import SEQ_MULTIPLE
from repro_torch.models import layers
from repro_torch.sharding import partition
from repro_torch.sharding.partition import active_axis_size, constrain

class KVCache(NamedTuple):
    k: torch.Tensor  # (B, T, K, hd)
    v: torch.Tensor
    # the running position lives in the serving state, not here


class CrossKV(NamedTuple):
    """A decoder layer's static cross-attention K/V over the encoder's
    output, written at prefill and read at every decode step."""
    k: torch.Tensor  # (B, T_enc, K, hd)
    v: torch.Tensor


class Attention(nn.Module):
    """wq, wk, wv (with the bq, bk, bv biases under `qkv_bias`) and wo."""

    AXES = {"wq.weight": ("heads", "fsdp"), "wk.weight": ("kv_heads", "fsdp"),
            "wv.weight": ("kv_heads", "fsdp"), "wo.weight": ("fsdp", "heads"),
            "wq.bias": ("heads",), "wk.bias": ("kv_heads",), "wv.bias": ("kv_heads",)}

    def __init__(self, gen, cfg, dtype):
        super().__init__()
        hd = cfg.resolved_head_dim
        bias = cfg.qkv_bias
        self.wq = layers.dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype, bias=bias)
        self.wk = layers.dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype, bias=bias)
        self.wv = layers.dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype, bias=bias)
        self.wo = layers.dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype)


def attn_init(gen, cfg, dtype) -> Attention:
    return Attention(gen, cfg, dtype)


def _heads_tp(cfg) -> bool:
    """Whether q is laid out head-parallel on the mesh's tensor axis: where
    it divides both head counts. The JAX package asks the query heads
    alone; DTensor splits a sharded dimension only into a multiple of its
    mesh axis (GSPMD pads instead), and GQA splits the heads into (KV heads,
    group), so whole groups must lie on a rank. True without a mesh."""
    m = max(active_axis_size("heads"), 1)
    return cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0


def _padded_tp(cfg, S: int) -> bool:
    """Whether a prompt of S tokens takes the JAX package's padded-head TP:
    longer than BLOCKWISE_THRESHOLD under `blockwise_context_parallel=False`
    where the heads are not head-parallel (`_heads_tp`)."""
    return S > BLOCKWISE_THRESHOLD and not cfg.blockwise_context_parallel and not _heads_tp(cfg)


def _project_qkv(attn: Attention, x, cfg, positions, rope: bool = True):
    """x (B, S, D) -> q (B, S, H, hd), k and v (B, S, K, hd), RoPE applied
    with `rope`, then laid out for the active mesh (no-ops without one), as
    the JAX package decides through `active_axis_size`:
      * head counts divisible by the tensor axis -> head-TP (scores sharded
        over heads, no attention collectives; see `_heads_tp`);
      * a prompt past BLOCKWISE_THRESHOLD under
        `blockwise_context_parallel=False` -> padded-head TP: q's KV groups
        padded with zero heads to a multiple of the tensor axis and sharded
        over it (`_pad_groups`; GSPMD pads an uneven sharding, DTensor does
        not), k and v laid out as JAX lays them and padded like q where
        the attention reads them (`_padded_like_q`);
      * otherwise context-parallel q (scores sharded over the query
        sequence, k/v gathered once per layer);
      * a decode step against a head_dim-sharded cache aligns q on head_dim,
        so the score contraction is a local partial sum.
    The projections are split into heads by `partition.reshape`: their
    features are sharded over the tensor axis, a legal split where the
    axis divides the head count, else gathered over it first."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    kv_div = cfg.n_kv_heads % max(active_axis_size("kv_heads"), 1) == 0
    hd_sharded = active_axis_size("kv_hd") > 1
    q = partition.reshape(attn.wq(x), (B, S, cfg.n_heads, hd))
    k = partition.reshape(attn.wk(x), (B, S, cfg.n_kv_heads, hd))
    v = partition.reshape(attn.wv(x), (B, S, cfg.n_kv_heads, hd))
    if rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    kv_axes = ("batch", None, "kv_heads" if kv_div else None, "kv_hd" if hd_sharded else None)
    if S == 1 and hd_sharded:
        q = constrain(q, ("kv_batch", None, None, "kv_hd"))
    elif _heads_tp(cfg):
        q = constrain(q, ("batch", None, "heads", None))
    elif S > 1 and _padded_tp(cfg, S):
        q = constrain(_pad_groups(constrain(q, ("batch", None, None, None)), cfg.n_kv_heads),
                      ("batch", None, "heads", None))
        kv_axes = ("batch", None, "kv_heads", None)  # padded like q where read
    elif S > 1:
        q = constrain(q, ("batch", "seq", None, None))  # context parallel
    return q, constrain(k, kv_axes), constrain(v, kv_axes)


def _pad_groups(t, K: int):
    """t (B, S, K * G, hd), its heads whole on each rank -> (B, S, K' * G,
    hd): the K groups padded with zero groups to K', the next multiple of
    the tensor axis, so that each rank holds whole groups. A local pad of
    each rank's shard (`partition.on_shards`)."""
    B, S, H, hd = t.shape
    pad = (-K) % max(active_axis_size("heads"), 1)

    def local(t):
        g = t.reshape(t.shape[0], t.shape[1], K, H // K, hd)
        return F.pad(g, (0, 0, 0, 0, 0, pad)).reshape(t.shape[0], t.shape[1], -1, hd)

    return partition.on_shards(local, t)


def _padded_like_q(q, k, v, cfg):
    """k and v as the attention reads them: under padded-head TP (q has
    more heads than the model) padded with zero heads to q's groups and
    sharded over the tensor axis as q is; as they are otherwise."""
    if q.shape[2] == cfg.n_heads:
        return k, v
    return tuple(constrain(_pad_groups(constrain(t, ("batch", None, None, None)), t.shape[2]),
                           ("batch", None, "heads", None)) for t in (k, v))


def _merge_out(attn: Attention, out, cfg):
    """The output projection of the heads out (B, S, H, hd). Unless q is
    head-parallel, the heads are gathered over the tensor axis before they
    merge (a decode step's are sharded on head_dim, which the merge cannot
    keep), the padded heads of padded-head TP dropped, and the merged
    (B, S, H * hd) is held so: the constraint's backward gathers wo's input
    gradient before autograd splits it into heads (and groups) again."""
    B, S = out.shape[:2]
    if _heads_tp(cfg):
        # the sharded heads lead the merged (heads, head_dim) run, evenly:
        # a legal view
        return attn.wo(partition.reshape(out, (B, S, -1)))
    o = constrain(out, ("batch", None, None, None))
    if o.shape[2] != cfg.n_heads:  # padded-head TP: the zero heads go
        o = o[:, :, :cfg.n_heads]
    o = partition.reshape(o, (B, S, -1))
    return attn.wo(constrain(o, ("batch", None, None)))


@functools.lru_cache(maxsize=None)
def _score_divisor(hd: int, dtype: torch.dtype) -> float:
    """sqrt(hd) in float32 rounded to `dtype`, computed on the host: a
    device scalar made from a host value would wait for the device."""
    return float(torch.tensor(hd, dtype=torch.float32).sqrt().to(dtype))


def _grouped_scores(q, k, cfg):
    """(B,Sq,H,hd) x (B,Sk,K,hd) -> (B,K,G,Sq,Sk), GQA without a repeat; the
    scores divided by sqrt(hd) rounded to q's dtype, as in the JAX package.
    K is k's head count (padded under padded-head TP). Under a mesh q's
    heads are sharded only where the tensor axis divides K (whole groups on
    a rank), so their split into (K, G) is a legal view; the einsum runs on
    each rank's shards (`partition.einsum`): torch's bmm would flatten the
    sharded batch and heads into one dimension."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = partition.reshape(q, (B, Sq, K, H // K, hd))
    return partition.einsum("bqkgd,bskd->bkgqs", qg, k) / _score_divisor(hd, q.dtype)


def _apply_mask_softmax(scores, mask):
    """Masked scores are -1e30 in a float32 softmax."""
    scores = torch.where(mask, scores.to(torch.float32), -1e30)
    return torch.softmax(scores, dim=-1)


def _combine(probs, v, out_dtype):
    B, K, G, Sq, Sk = probs.shape
    out = partition.einsum("bkgqs,bskd->bqkgd", probs.to(out_dtype), v)
    # the (K, G) merge: K leads the run, the only one sharded (head-TP)
    return partition.reshape(out, (B, Sq, K * G, -1))


def causal_mask(Sq: int, Sk: int, window: int = 0, offset: int = 0, device=None) -> torch.Tensor:
    """(Sq, Sk) bool; query i attends key j iff j <= i+offset (and within
    window if window>0). offset shifts query positions (decode/prefill)."""
    qpos = torch.arange(Sq, device=device)[:, None] + offset
    kpos = torch.arange(Sk, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > (qpos - window)
    return m


# Sequences longer than this take the blockwise path (O(S * Q_BLOCK) score
# memory for causal, O(Q_BLOCK * window) for banded) instead of S x S.
BLOCKWISE_THRESHOLD = 4096
Q_BLOCK = 1024


def _attn_dense(q, k, v, cfg, mask, out_dtype):
    return _combine(_apply_mask_softmax(_grouped_scores(q, k, cfg), mask), v, out_dtype)


def _attn_blockwise(q, k, v, cfg, *, causal: bool, window: int, out_dtype):
    """Exact attention with the queries in blocks of Q_BLOCK: causal block i
    sees keys [0, (i+1) Q); banded (causal, `window` > 0) the band
    [i Q - window + 1, (i+1) Q); bidirectional every key."""
    S = q.shape[1]
    outs = []
    for qs in range(0, S, Q_BLOCK):
        qe = min(S, qs + Q_BLOCK)
        if causal and window > 0:
            ks = max(0, qs - window + 1)
            mask = causal_mask(qe - qs, qe - ks, window, offset=qs - ks, device=q.device)
            kk, vv = k[:, ks:qe], v[:, ks:qe]
        elif causal:
            mask = causal_mask(qe - qs, qe, 0, offset=qs, device=q.device)
            kk, vv = k[:, :qe], v[:, :qe]
        else:
            mask = torch.ones((qe - qs, k.shape[1]), dtype=torch.bool, device=q.device)
            kk, vv = k, v
        outs.append(_attn_dense(q[:, qs:qe], kk, vv, cfg, mask, out_dtype))
    return torch.cat(outs, dim=1)


def attn_train(attn: Attention, x, cfg, positions, *, window: int = 0, causal: bool = True,
               rope: bool = True):
    """The training forward over the whole sequence x (B, S, D) -> delta
    (B, S, D), in plain differentiable torch ops: causal (with `window` > 0
    banded) or, without `causal`, bidirectional; RoPE on q and k with
    `rope`. Dense up to BLOCKWISE_THRESHOLD tokens, blockwise above."""
    q, k, v = _project_qkv(attn, x, cfg, positions, rope)
    k, v = _padded_like_q(q, k, v, cfg)
    B, S, _ = x.shape
    if S > BLOCKWISE_THRESHOLD:
        out = _attn_blockwise(q, k, v, cfg, causal=causal, window=window, out_dtype=x.dtype)
    else:
        mask = (causal_mask(S, S, window, device=x.device) if causal
                else torch.ones((S, S), dtype=torch.bool, device=x.device))
        out = _attn_dense(q, k, v, cfg, mask, x.dtype)
    return _merge_out(attn, out, cfg)


def init_cache(cfg, batch: int, max_len: int, dtype, device) -> KVCache:
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.n_kv_heads, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _flash_heads(t: torch.Tensor, S_pad: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B*H, S_pad, hd), contiguous, zero rows after S."""
    B, S, H, hd = t.shape
    out = t.new_zeros((B, H, S_pad, hd))
    out[:, :, :S] = t.transpose(1, 2)
    return out.reshape(B * H, S_pad, hd)


def _padded(S: int) -> int:
    return -(-S // SEQ_MULTIPLE) * SEQ_MULTIPLE


def flash_prefill(q, k, v, mode: str = "auto", window: int = 0,
                  causal: bool = True) -> torch.Tensor:
    """Attention of q (B,Sq,H,hd) over k, v (B,Sk,K,hd) through
    `ops.flash_attention` -> (B, Sq, H, hd): causal (Sq = Sk), with
    `window` > 0 query i seeing only keys i - window < j <= i; or, without
    `causal`, every query seeing all Sk keys.

    The kernel takes aligned heads and lengths that are multiples of 128:
    each KV head is repeated for its G query heads (h reads h // G), and the
    queries and keys are padded at their ends with zeros. The causal mask
    keeps the padded keys invisible to every real query; without it the call
    passes kv_len = Sk, which masks them. The padded query rows are dropped.
    A window of S or more is the causal mask itself, so the call then takes
    none."""
    B, S, H, hd = q.shape
    Sk = k.shape[1]
    window = window if window < S else 0
    G = H // k.shape[2]
    if G > 1:
        k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    S_pad, Sk_pad = _padded(S), _padded(Sk)
    o = ops.flash_attention(_flash_heads(q, S_pad), _flash_heads(k, Sk_pad),
                            _flash_heads(v, Sk_pad), causal=causal, mode=mode, window=window,
                            kv_len=None if causal else Sk)
    return o.reshape(B, H, S_pad, hd)[:, :, :S].transpose(1, 2)


def _flash(q, k, v, mode: str = "auto", window: int = 0, causal: bool = True):
    """`flash_prefill` under the active mesh: on each rank's shards
    (`partition.on_shards`), since each (batch, head) pair's attention is
    independent of the others. q, k and v are laid out by batch and, where
    the tensor axis divides k's heads (head-TP, padded-head TP: whole
    groups on a rank), by heads; a context-parallel q is gathered over its
    sequence first, as the causal mask needs each query's position."""
    if partition.active_mesh() is None:
        return flash_prefill(q, k, v, mode, window, causal)
    heads = "heads" if k.shape[2] % max(active_axis_size("heads"), 1) == 0 else None
    q, k, v = (constrain(t, ("batch", None, heads, None)) for t in (q, k, v))
    return partition.on_shards(
        lambda q, k, v: flash_prefill(q, k, v, mode, window, causal), q, k, v)


def attn_prefill(attn: Attention, x, cfg, positions, cache: KVCache, *, window: int = 0,
                 mode: str = "auto"):
    """Causal (with `window` > 0 banded) attention over the prompt; writes
    K/V into cache[:, 0:S] in place, or, for a sliding-window layer's ring
    of T < S slots, the last T keys at their pos % T. Returns
    (delta (B, S, D), cache)."""
    q, k, v = _project_qkv(attn, x, cfg, positions)
    B, S, _ = x.shape
    out = _flash(q, *_padded_like_q(q, k, v, cfg), mode, window)
    T = cache.k.shape[1]
    if window > 0 and T < S:  # the ring: position p in slot p % T
        r = S % T  # the last T positions S - T .. S - 1 start at slot r
        for c, t in ((cache.k, k), (cache.v, v)):
            last = t[:, -T:].to(c.dtype)
            c[:, r:] = last[:, :T - r]  # two slice writes (DTensor has no
            c[:, :r] = last[:, T - r:]  # sharded index_put on older releases)
    else:
        cache.k[:, :S] = k.to(cache.k.dtype)
        cache.v[:, :S] = v.to(cache.v.dtype)
    return _merge_out(attn, out, cfg), cache


def attn_decode(attn: Attention, x, cfg, pos: int, cache: KVCache, *, window: int = 0):
    """One-token decode. x: (B, 1, D); pos: the current position (an int).

    Writes the new K/V at pos in place (at T-1 once pos >= T, where the JAX
    package's dynamic_update_slice clamps the start) and attends over the
    whole cache with every slot at or before pos counted valid — the
    standard fixed-shape serving layout; with `window` > 0 only the slots
    in the band pos - window < j <= pos. A window layer whose cache has at
    most `window` slots keeps a ring: the write goes to pos % T, and every
    slot is valid once pos >= T (slot s then holds position
    pos - ((pos - s) mod T)). Returns (delta (B, 1, D), cache)."""
    B = x.shape[0]
    T = cache.k.shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(attn, x, cfg, positions)
    ring = 0 < window and T <= window
    write_pos = pos % T if ring else min(pos, T - 1)
    cache.k[:, write_pos] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, write_pos] = v_new[:, 0].to(cache.v.dtype)
    kpos = torch.arange(T, device=x.device)
    if ring:
        valid = torch.ones_like(kpos, dtype=torch.bool) if pos >= T else kpos <= pos
    else:
        valid = kpos <= pos
        if window > 0:
            valid &= kpos > pos - window
    scores = _grouped_scores(q, cache.k.to(x.dtype), cfg)  # (B,K,G,1,T)
    if active_axis_size("kv_hd") > 1:
        # a head_dim-sharded cache gives each rank a partial sum of the
        # scores: reduced here, before the mask and softmax need them whole
        scores = constrain(scores, ("kv_batch", None, None, None, None))
    probs = _apply_mask_softmax(scores, valid)
    out = _combine(probs, cache.v.to(x.dtype), x.dtype)
    return _merge_out(attn, out, cfg), cache


def attn_encoder(attn: Attention, x, cfg, mode: str = "auto"):
    """Non-causal attention over all S positions of x (B, S, D), without
    RoPE (an encoder layer's): the JAX package's `attn_train(...,
    causal=False, rope=False)`, through the kernel with kv_len = S. Returns
    the delta (B, S, D)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(attn, x, cfg, None, rope=False)
    out = _flash(q, k, v, mode, causal=False)
    return _merge_out(attn, out, cfg)


def cross_kv(attn: Attention, enc_out, cfg) -> CrossKV:
    """The cross-attention K/V of enc_out (B, T, D): (B, T, K, hd) each,
    projected without biases, as in the JAX package. The projections'
    features split into heads as in `_project_qkv` (`partition.reshape`)."""
    B, T, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    shape = (B, T, cfg.n_kv_heads, hd)
    return CrossKV(k=partition.reshape(F.linear(enc_out, attn.wk.weight), shape),
                   v=partition.reshape(F.linear(enc_out, attn.wv.weight), shape))


def _cross_q(attn: Attention, x, cfg):
    """The cross-attention's q (B, S, H, hd), split as `cross_kv`'s K/V."""
    B, S, _ = x.shape
    return partition.reshape(F.linear(x, attn.wq.weight), (B, S, cfg.n_heads, cfg.resolved_head_dim))


def attn_cross_prefill(attn: Attention, x, enc_kv: CrossKV, cfg, mode: str = "auto"):
    """Cross-attention of the prompt x (B, S, D) over all T encoder
    positions through the kernel: the queries padded to a multiple of 128,
    the T keys padded too and masked by kv_len = T. Returns the delta."""
    B, S, _ = x.shape
    out = _flash(_cross_q(attn, x, cfg), enc_kv.k, enc_kv.v, mode, causal=False)
    return _merge_out(attn, out, cfg)


def attn_cross(attn: Attention, x, enc_kv: CrossKV, cfg):
    """Cross-attention of x (B, S, D) over the encoder's K/V in plain torch
    ops with the JAX package's rounding (scores in x's dtype divided by
    sqrt(hd), a float32 softmax), the decode step's and training's.
    Returns the delta."""
    B, S, _ = x.shape
    scores = _grouped_scores(_cross_q(attn, x, cfg), enc_kv.k, cfg)  # (B,K,G,S,T)
    probs = torch.softmax(scores.to(torch.float32), dim=-1)
    out = _combine(probs, enc_kv.v, x.dtype)
    return _merge_out(attn, out, cfg)
