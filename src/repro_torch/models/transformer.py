"""Decoder blocks and the decoder stack, for training and for serving.

The port of `repro/models/transformer.py` for decoder-only LMs. A block's
temporal mixer is one of the five kinds attn_global | attn_local | rglru |
mlstm | slstm; its channel mixer a dense MLP, an MoE channel, or none
(mlstm and slstm embed their own FFN). Every block returns its residual
delta and the stack adds it.

The JAX package stacks each unit position's parameters on a leading layer
axis and scans over the units, then runs the tail layers (depth % unit)
unscanned; here the layers are one `nn.ModuleList` in the same order
(layer u * len(unit) + p, then the tail) walked in Python. The caches are
one list with a state per layer — a `KVCache` (a ring of min(max_len,
window) slots for attn_local), an `RGLRUState`, an `MLSTMState` or an
`SLSTMState`, each with its batch on axis 0 — which the blocks write in
place, where the JAX package stacks the states of a unit position.

Training (`block_train`, `decoder_train`) writes nothing in place. Each
unit of the block pattern runs under `remat(cfg)`, as the JAX package
wraps its scan body: "none" keeps every activation, "full" keeps only the
unit's input and recomputes the rest in the backward pass, and "dots"
keeps the outputs of the matrix products without a batch dimension (the
projections: aten mm and addmm; the attention's and the experts' batched
products are recomputed), JAX's dots_with_no_batch_dims_saveable. The tail
layers run without it, as in the JAX package. The Boltzmann router's Gumbel
draws come in per layer (`gumbels`), drawn before any checkpointed region.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention, layers, moe, rglru, xlstm
from repro_torch.sharding.partition import constrain

KINDS = ("attn_global", "attn_local", "rglru", "mlstm", "slstm")
ATTENTION_KINDS = ("attn_global", "attn_local")


def _has_channel(kind: str, cfg) -> bool:
    return kind in ("attn_global", "attn_local", "rglru") and bool(cfg.d_ff > 0 or cfg.moe)


class Block(nn.Module):
    """norm1 and the temporal mixer (attn, rglru, mlstm or slstm, as named
    in the JAX package's tree); norm2 and the MLP or the MoE channel where
    the kind has one."""

    def __init__(self, gen, kind: str, cfg, dtype):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"unknown block kind {kind!r}; have {KINDS}")
        self.kind = kind
        self.norm1 = layers.Norm(cfg.d_model, dtype, layers.device_of(gen))
        if kind in ATTENTION_KINDS:
            self.attn = attention.attn_init(gen, cfg, dtype)
        elif kind == "rglru":
            self.rglru = rglru.rglru_init(gen, cfg, dtype)
        elif kind == "mlstm":
            self.mlstm = xlstm.mlstm_init(gen, cfg, dtype)
        else:
            self.slstm = xlstm.slstm_init(gen, cfg, dtype)
        if _has_channel(kind, cfg):
            self.norm2 = layers.Norm(cfg.d_model, dtype, layers.device_of(gen))
            if cfg.moe:
                self.moe = moe.moe_init(gen, cfg, dtype)
            else:
                self.mlp = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype)


def block_init(gen, kind: str, cfg, dtype) -> Block:
    return Block(gen, kind, cfg, dtype)


def _window(kind: str, cfg) -> int:
    return cfg.window if kind == "attn_local" else 0


def _channel(block: Block, kind: str, x, cfg):
    if not _has_channel(kind, cfg):
        return x
    h2 = layers.apply_norm(cfg.norm, block.norm2, x)
    if cfg.moe:
        out = moe.moe_apply(block.moe, h2, cfg)  # serving routes by top-k
    else:
        out = layers.mlp_apply(block.mlp, h2, cfg.act)
    return layers.residual(x, out)


def block_train(block: Block, kind: str, x, cfg, positions, gumbel=None):
    """The training forward of one block: x -> (x', aux), aux the MoE
    channel's load-balance loss (a float32 zero without one). `gumbel`
    (G, gs, E): the Boltzmann router's draws for this layer. Under a mesh
    the block's parameters are gathered over their fsdp axis within
    (`layers.fsdp_gathered`)."""
    with layers.fsdp_gathered(block):
        h = layers.apply_norm(cfg.norm, block.norm1, x)
        if kind in ATTENTION_KINDS:
            delta = attention.attn_train(block.attn, h, cfg, positions, window=_window(kind, cfg))
        elif kind == "rglru":
            delta = rglru.rglru_train(block.rglru, h, cfg)
        elif kind == "mlstm":
            delta = xlstm.mlstm_block_train(block.mlstm, h, cfg)
        else:
            delta = xlstm.slstm_block_train(block.slstm, h, cfg)
        x = layers.residual(x, delta)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if _has_channel(kind, cfg):
            h2 = layers.apply_norm(cfg.norm, block.norm2, x)
            if cfg.moe:
                out, aux = moe.moe_apply(block.moe, h2, cfg, gumbel, with_aux=True)
            else:
                out = layers.mlp_apply(block.mlp, h2, cfg.act)
            x = layers.residual(x, out)
    return constrain(x, ("batch", "seq", "embed")), aux


REMATS = ("none", "dots", "full")
# the products "dots" keeps: those without a batch dimension (nn.Linear's)
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def remat(cfg):
    """fn -> fn under cfg.remat: itself ("none"), or a non-reentrant
    activation checkpoint of it ("full"; "dots" saving the products of
    _DOTS)."""
    if cfg.remat not in REMATS:
        raise ValueError(f"{cfg.name}: remat {cfg.remat!r}; have {REMATS}")
    if cfg.remat == "none":
        return lambda fn: fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts, _DOTS)

    def wrap(fn):
        return lambda *args: ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrap


def decoder_train(blocks: nn.ModuleList, x, cfg, positions, gumbels=None):
    """Every layer's training forward. Returns (x, total aux float32).
    `gumbels`: one draw (or None) per layer, in layer order."""
    plan = unit_plan(cfg)
    n = len(plan.unit)
    gumbels = [None] * len(blocks) if gumbels is None else gumbels

    def unit_fn(start, x, *draws):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, g in enumerate(draws):
            block = blocks[start + j]
            x, a = block_train(block, block.kind, x, cfg, positions, g)
            aux = aux + a
        return x, aux

    wrap = remat(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for u in range(plan.n_scan):
        start = u * n
        x, a = wrap(functools.partial(unit_fn, start))(x, *gumbels[start:start + n])
        aux = aux + a
    for i in range(plan.n_scan * n, len(blocks)):
        x, a = block_train(blocks[i], blocks[i].kind, x, cfg, positions, gumbels[i])
        aux = aux + a
    return x, aux


def block_cache_init(kind: str, cfg, batch: int, max_len: int, device):
    """A layer's zeroed decode state: attn_local keeps a ring of
    min(max_len, window) slots."""
    if kind in ATTENTION_KINDS:
        T = min(max_len, cfg.window) if kind == "attn_local" else max_len
        return attention.init_cache(cfg, batch, T, getattr(torch, cfg.kv_cache_dtype), device)
    if kind == "rglru":
        return rglru.rglru_init_state(cfg, batch, getattr(torch, cfg.dtype), device)
    if kind == "mlstm":
        return xlstm.mlstm_init_state(cfg, batch, device)
    return xlstm.slstm_init_state(cfg, batch, device)


def block_cache_axes(kind: str):
    """The logical axes of a layer's decode state (`block_cache_init`)."""
    if kind in ATTENTION_KINDS:
        a = ("kv_batch", "kv_seq", "kv_heads", "kv_hd")
        return attention.KVCache(a, a)
    if kind == "rglru":
        return rglru.RGLRUState(h=("kv_batch", "mlp"), conv=("kv_batch", None, "mlp"))
    if kind == "mlstm":
        return xlstm.MLSTMState(C=("kv_batch", "heads", None, None), n=("kv_batch", "heads", None),
                                m=("kv_batch", "heads"))
    a = ("kv_batch", "mlp")
    return xlstm.SLSTMState(c=a, n=a, h=a, m=a)


def _write(state, new) -> None:
    """Copy each tensor of the state `new` into `state`'s, in place."""
    for dst, src in zip(state, new):
        dst.copy_(src)


def _rglru_state_from_prefill(u1, h, cfg, state: rglru.RGLRUState) -> None:
    """The decode state after a prompt pass: the last h, and the last W - 1
    conv inputs (zeros before the prompt's start when it is shorter)."""
    W = cfg.conv_width
    tail = u1[:, -(W - 1):].to(state.conv.dtype)
    state.h.copy_(h[:, -1])
    state.conv.zero_()
    state.conv[:, W - 1 - tail.shape[1]:] = tail


def _mlstm_state_from_prefill(mod: xlstm.MLSTM, a, cfg, state: xlstm.MLSTMState) -> None:
    """(C, n, m) after the prompt, through the chunkwise form."""
    _, st = xlstm.mlstm_chunkwise(mod, a, cfg.n_heads, cfg.mlstm_chunk)
    _write(state, st)


def block_prefill(block: Block, kind: str, x, cfg, positions, cache, mode: str = "auto"):
    """Prompt pass that also fills the layer's state in place. Returns (x', cache)."""
    h = layers.apply_norm(cfg.norm, block.norm1, x)
    if kind in ATTENTION_KINDS:
        # a ring shorter than the prompt takes its last T keys (attn_prefill)
        delta, cache = attention.attn_prefill(block.attn, h, cfg, positions, cache,
                                              window=_window(kind, cfg), mode=mode)
    elif kind == "rglru":
        u1, u2, hs = rglru._rglru_scan(block.rglru, h)
        delta = rglru._out(block.rglru, hs, u2, h.dtype)
        _rglru_state_from_prefill(u1, hs, cfg, cache)
    elif kind == "mlstm":
        mod = block.mlstm
        a, b = mod.w_up_a(h), mod.w_up_b(h)
        if h.shape[1] > 4 * cfg.mlstm_chunk:  # one chunkwise pass gives both
            hm, st = xlstm.mlstm_chunkwise(mod, a, cfg.n_heads, cfg.mlstm_chunk)
            _write(cache, st)
        else:
            hm = xlstm.mlstm_parallel(mod, a, cfg.n_heads)
            _mlstm_state_from_prefill(mod, a, cfg, cache)
        delta = xlstm._mlstm_out(mod, hm, b)
    else:
        hseq, st = xlstm.slstm_scan(block.slstm, h, cfg)
        _write(cache, st)
        delta = xlstm.slstm_block_from_scan(block.slstm, h, hseq)
    return _channel(block, kind, x + delta, cfg), cache


def block_decode(block: Block, kind: str, x, cfg, pos: int, cache):
    h = layers.apply_norm(cfg.norm, block.norm1, x)
    if kind in ATTENTION_KINDS:
        delta, cache = attention.attn_decode(block.attn, h, cfg, pos, cache,
                                             window=_window(kind, cfg))
    elif kind == "rglru":
        delta, cache = rglru.rglru_decode(block.rglru, h, cfg, cache)
    elif kind == "mlstm":
        delta, cache = xlstm.mlstm_block_decode(block.mlstm, h, cfg, cache)
    else:
        delta, cache = xlstm.slstm_block_decode(block.slstm, h, cfg, cache)
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


def layer_kinds(cfg) -> list[str]:
    """Every layer's kind, in the JAX package's order: unit u's position p is
    layer u * len(unit) + p, then the tail."""
    plan = unit_plan(cfg)
    if plan.n_scan < 1:
        raise ValueError(f"{cfg.name}: the unit {plan.unit} is larger than {cfg.n_layers} layers")
    return list(plan.unit) * plan.n_scan + list(plan.tail)


def init_decoder_layers(gen, cfg, dtype) -> nn.ModuleList:
    return nn.ModuleList(block_init(gen, kind, cfg, dtype) for kind in layer_kinds(cfg))


def decoder_caches(cfg, batch: int, max_len: int, device) -> list:
    """One zeroed state per layer, in layer order."""
    return [block_cache_init(kind, cfg, batch, max_len, device) for kind in layer_kinds(cfg)]


def decoder_prefill(blocks: nn.ModuleList, x, cfg, positions, caches: list, mode: str = "auto"):
    for block, cache in zip(blocks, caches):
        x, _ = block_prefill(block, block.kind, x, cfg, positions, cache, mode)
    return x, caches


def decoder_decode(blocks: nn.ModuleList, x, cfg, pos: int, caches: list):
    for block, cache in zip(blocks, caches):
        x, _ = block_decode(block, block.kind, x, cfg, pos, cache)
    return x, caches
