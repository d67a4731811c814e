"""Weights and caches carried across from the JAX package's trees.

`params_from_jax(cfg, tree)` takes the JAX `init_params` tree as numpy
arrays (nested dicts and tuples) and returns a state dict that
`DecoderLM.load_state_dict` takes: the leading layer axis of the stacked
block parameters (`params["layers"]["scan"][0]`) unstacked into one entry a
layer, every 2-D weight transposed from the JAX (d_in, d_out) layout to
`nn.Linear`'s (d_out, d_in), the bq/bk/bv biases as the projections'
`bias`, and no head under tied embeddings (the head is the embedding).
`caches_from_jax(cfg, caches)` does the same for a cache tree; a cache is
read duck-typed, as `.k` and `.v` or a `(k, v)` tuple.

Neither imports JAX: the tests convert the JAX arrays to numpy first
(bfloat16 arrives as ml_dtypes' bfloat16 and is carried through float32,
which holds it exactly).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import KVCache
from repro_torch.models.model import _check_family

_BIAS = {"bq": "wq", "bk": "wk", "bv": "wv"}


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
    if a.ndim == 2:  # a dense weight: nn.Linear's layout
        return path + ".weight", a.T
    return path, a  # norm scales, the experts' (E, d_in, d_out) stacks


def _stack(cfg, tree):
    """The one stacked block tree of an all-attn_global decoder."""
    _check_family(cfg)
    if len(tree["scan"]) != 1 or len(tree["tail"]):
        raise NotImplementedError(f"{cfg.name}: only a decoder of one repeated block is ported")
    return tree["scan"][0]


def params_from_jax(cfg, tree) -> dict[str, torch.Tensor]:
    state = {"embed": _tensor(tree["embed"]),
             "final_norm.scale": _tensor(tree["final_norm"]["scale"])}
    for path, name, stacked in _leaves(_stack(cfg, tree["layers"])):
        for i in range(stacked.shape[0]):
            key, a = _entry(f"layers.{i}.{path}", name, stacked[i])
            state[key] = _tensor(a)
    if not cfg.tie_embeddings:
        state["lm_head.weight"] = _tensor(np.asarray(tree["lm_head"]).T)
    return state


def caches_from_jax(cfg, caches) -> KVCache:
    """The (L, B, T, K, hd) k and v of a JAX `init_caches`/`prefill` cache
    tree ({"dec": {"scan": (cache,), "tail": ()}}) or of one stacked cache."""
    c = _stack(cfg, caches["dec"]) if isinstance(caches, dict) else caches
    k, v = (c.k, c.v) if hasattr(c, "k") else c
    return KVCache(k=_tensor(k), v=_tensor(v))
