"""Decoder blocks and the decoder stack of the serving path.

The port of `repro/models/transformer.py` for decoder-only LMs built of
`attn_global` blocks with a dense MLP or an MoE channel. Every block returns
its residual delta and the stack adds it. The JAX package stacks each unit
position's parameters on a leading layer axis and scans over them; here the
layers are an `nn.ModuleList` walked in Python, and the KV cache is one
(L, B, T, K, hd) tensor each for k and v — the layout of the JAX package's
stacked cache — whose layer slices the blocks write in place.

The `attn_local`, `rglru`, `mlstm` and `slstm` kinds (the hybrid and ssm
families) are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models import attention, layers, moe
from repro_torch.models.attention import KVCache

PORTED_KINDS = ("attn_global",)


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet; it comes with the hybrid and ssm "
            "families (ROADMAP queue 1)")


def _has_channel(kind: str, cfg) -> bool:
    return kind in ("attn_global", "attn_local", "rglru") and bool(cfg.d_ff > 0 or cfg.moe)


class Block(nn.Module):
    """norm1 and the attention; norm2 and the MLP or the MoE channel."""

    def __init__(self, gen, kind: str, cfg, dtype):
        super().__init__()
        _check_kind(kind)
        self.kind = kind
        self.norm1 = layers.Norm(cfg.d_model, dtype, gen.device)
        self.attn = attention.attn_init(gen, cfg, dtype)
        if _has_channel(kind, cfg):
            self.norm2 = layers.Norm(cfg.d_model, dtype, gen.device)
            if cfg.moe:
                self.moe = moe.moe_init(gen, cfg, dtype)
            else:
                self.mlp = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype)


def block_init(gen, kind: str, cfg, dtype) -> Block:
    return Block(gen, kind, cfg, dtype)


def _channel(block: Block, kind: str, x, cfg):
    if not _has_channel(kind, cfg):
        return x
    h2 = layers.apply_norm(cfg.norm, block.norm2, x)
    if cfg.moe:
        out = moe.moe_apply(block.moe, h2, cfg)  # serving routes by top-k
    else:
        out = layers.mlp_apply(block.mlp, h2, cfg.act)
    return x + out


def block_prefill(block: Block, kind: str, x, cfg, positions, cache: KVCache,
                  mode: str = "auto"):
    """Prompt pass that also fills the cache. Returns (x', cache)."""
    h = layers.apply_norm(cfg.norm, block.norm1, x)
    delta, cache = attention.attn_prefill(block.attn, h, cfg, positions, cache, mode=mode)
    return _channel(block, kind, x + delta, cfg), cache


def block_decode(block: Block, kind: str, x, cfg, pos: int, cache: KVCache):
    h = layers.apply_norm(cfg.norm, block.norm1, x)
    delta, cache = attention.attn_decode(block.attn, h, cfg, pos, cache)
    return _channel(block, kind, x + delta, cfg), cache


# ---------------------------------------------------------------------------
# the layer plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UnitPlan:
    unit: tuple[str, ...]   # kinds within the repeating unit
    n_scan: int             # repetitions of the unit
    tail: tuple[str, ...]   # remainder kinds


def unit_plan(cfg) -> UnitPlan:
    if cfg.block_pattern is None:
        return UnitPlan(unit=("attn_global",), n_scan=cfg.n_layers, tail=())
    unit = tuple(cfg.block_pattern)
    n_scan, rem = divmod(cfg.n_layers, len(unit))
    return UnitPlan(unit=unit, n_scan=n_scan, tail=unit[:rem])


def _kinds(cfg) -> list[str]:
    """Every layer's kind, in order; raise on a kind not ported."""
    plan = unit_plan(cfg)
    kinds = list(plan.unit) * plan.n_scan + list(plan.tail)
    for kind in set(kinds):
        _check_kind(kind)
    return kinds


def init_decoder_layers(gen, cfg, dtype) -> nn.ModuleList:
    return nn.ModuleList(block_init(gen, kind, cfg, dtype) for kind in _kinds(cfg))


def decoder_caches(cfg, batch: int, max_len: int, device) -> KVCache:
    """Zeroed (L, B, T, K, hd) k and v in `kv_cache_dtype`, one layer of the
    stack for each block (all attn_global)."""
    shape = (len(_kinds(cfg)), batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    dtype = getattr(torch, cfg.kv_cache_dtype)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def decoder_prefill(blocks: nn.ModuleList, x, cfg, positions, caches: KVCache,
                    mode: str = "auto"):
    for i, block in enumerate(blocks):
        x, _ = block_prefill(block, block.kind, x, cfg, positions,
                             KVCache(caches.k[i], caches.v[i]), mode)
    return x, caches


def decoder_decode(blocks: nn.ModuleList, x, cfg, pos: int, caches: KVCache):
    for i, block in enumerate(blocks):
        x, _ = block_decode(block, block.kind, x, cfg, pos, KVCache(caches.k[i], caches.v[i]))
    return x, caches
