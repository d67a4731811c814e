"""Weights and caches carried across from the JAX package's trees.

`params_from_jax(cfg, tree)` takes the JAX `init_params` tree as numpy
arrays (nested dicts and tuples) and returns a state dict that
`DecoderLM.load_state_dict` takes. The JAX decoder holds its layers as
`{"scan": (one tree per unit position, stacked over the units), "tail":
(one tree per tail layer)}`; the port's layer u * len(unit) + p is entry u
of scan tree p, and the tail follows. Every 2-D weight is transposed from
the JAX (d_in, d_out) layout to `nn.Linear`'s (d_out, d_in), but the RG-LRU's
depthwise `conv_w` (W, R), which is no linear map; the bq/bk/bv biases
become the projections' `bias`; 1-D and 3-D leaves (norm scales, gate biases,
the block-diagonal mLSTM and sLSTM weights, the experts' stacks) keep their
shape; under tied embeddings there is no head (the head is the embedding).
`caches_from_jax(cfg, caches)` turns a cache tree into the port's list of
per-layer states, in the same order; a state is read duck-typed, by its
field names or as a tuple in the NamedTuple's order.

The audio family's encoder layers (`enc_layers`, stacked over the encoder's
depth like a scan) become `enc_layers.<i>`, `enc_norm` stays, and the
stacked per-decoder-layer cross-attention (`cross`: norm and attn) becomes
`cross.<i>`; its cache tree's `cross_kv` (k, v), each (L, B, T, K, hd),
becomes one `CrossKV` per decoder layer after the decoder's states.

Neither imports JAX: the tests convert the JAX arrays to numpy first
(bfloat16 arrives as ml_dtypes' bfloat16 and is carried through float32,
which holds it exactly).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import CrossKV, KVCache
from repro_torch.models.model import _check_family
from repro_torch.models.rglru import RGLRUState
from repro_torch.models.transformer import layer_kinds, unit_plan
from repro_torch.models.xlstm import MLSTMState, SLSTMState

_BIAS = {"bq": "wq", "bk": "wk", "bv": "wv"}
_NOT_LINEAR = {"conv_w"}
_STATES = {"attn_global": KVCache, "attn_local": KVCache, "rglru": RGLRUState,
           "mlstm": MLSTMState, "slstm": SLSTMState}


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _leaves(tree: dict, prefix: str = ""):
    """(dotted path, leaf name, array) of every leaf of a nested dict."""
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", name, np.asarray(value)


def _entry(path: str, name: str, a: np.ndarray):
    """The port's state-dict name and array of one unstacked JAX leaf."""
    if name in _BIAS:
        return path[: -len(name)] + _BIAS[name] + ".bias", a
    if a.ndim == 2 and name not in _NOT_LINEAR:  # a dense weight: nn.Linear's layout
        return path + ".weight", a.T
    return path, a


def _layers(cfg, tree):
    """(layer index, its tree, take) for every layer of a JAX {"scan",
    "tail"} decoder tree: take(leaf) is the layer's own array of a leaf of
    that tree (its entry of a scan-stacked leaf, a tail leaf itself)."""
    _check_family(cfg)
    plan = unit_plan(cfg)
    n_unit = len(plan.unit)
    for i, _ in enumerate(layer_kinds(cfg)):
        if i < plan.n_scan * n_unit:
            u, p = divmod(i, n_unit)
            yield i, tree["scan"][p], (lambda a, u=u: np.asarray(a)[u])
        else:
            yield i, tree["tail"][i - plan.n_scan * n_unit], np.asarray


def _stacked(state: dict, prefix: str, tree: dict, depth: int) -> None:
    """Entry i of every leaf of a tree stacked over `depth` layers, as
    `<prefix>.<i>.<path>`."""
    for i in range(depth):
        for path, name, a in _leaves(tree):
            key, a = _entry(f"{prefix}.{i}.{path}", name, a[i])
            state[key] = _tensor(a)


def params_from_jax(cfg, tree) -> dict[str, torch.Tensor]:
    state = {"embed": _tensor(tree["embed"]),
             "final_norm.scale": _tensor(tree["final_norm"]["scale"])}
    for i, sub, take in _layers(cfg, tree["layers"]):
        for path, name, a in _leaves(sub):
            key, a = _entry(f"layers.{i}.{path}", name, take(a))
            state[key] = _tensor(a)
    if cfg.is_encdec:
        _stacked(state, "enc_layers", tree["enc_layers"], cfg.n_encoder_layers)
        state["enc_norm.scale"] = _tensor(tree["enc_norm"]["scale"])
        _stacked(state, "cross", tree["cross"], cfg.n_layers)
    if not cfg.tie_embeddings:
        state["lm_head.weight"] = _tensor(np.asarray(tree["lm_head"]).T)
    return state


def caches_from_jax(cfg, caches) -> list:
    """The per-layer states of a JAX `init_caches` / `prefill` / `decode_step`
    cache tree ({"dec": {"scan": ..., "tail": ...}}, and "cross_kv" for the
    audio family)."""
    kinds = layer_kinds(cfg)
    out = []
    for i, sub, take in _layers(cfg, caches["dec"]):
        cls = _STATES[kinds[i]]
        fields = [getattr(sub, f) for f in cls._fields] if hasattr(sub, "_fields") else list(sub)
        out.append(cls(*(_tensor(take(a)) for a in fields)))
    if cfg.is_encdec:
        k, v = (np.asarray(a) for a in caches["cross_kv"])
        out += [CrossKV(_tensor(k[i]), _tensor(v[i])) for i in range(cfg.n_layers)]
    return out
