"""Weights, caches and train states carried across from and to the JAX
package's trees.

`params_from_jax(cfg, tree)` takes the JAX `init_params` tree as numpy
arrays or tensors (nested dicts and tuples) and returns a state dict that
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

`params_to_jax(cfg, named)` is the inverse (`jax_leaf` maps each name to
its JAX leaf), for any tensors named like the model's parameters (the
parameters, AdamW's moments, the error-feedback residuals): the JAX tree of
CPU tensors in their dtype.
`train_state_to_jax` and `load_train_state` carry a whole train state
(params, opt.mu, opt.nu, opt.count, ef.residual, step) across as the JAX
`TrainState` tree, the one `train.checkpoint` writes and reads.
`decay_mask` says which parameters AdamW decays: those whose JAX leaf,
stacked over the scanned layers, has ndim >= 2.

None imports JAX: the tests convert the JAX arrays to numpy first
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
_BIAS_OF = {w: b for b, w in _BIAS.items()}
_STACKED = ("layers", "enc_layers", "cross")  # per-layer modules, "<name>.<i>.<path>"
_NOT_LINEAR = {"conv_w"}
_STATES = {"attn_global": KVCache, "attn_local": KVCache, "rglru": RGLRUState,
           "mlstm": MLSTMState, "slstm": SLSTMState}


def _tensor(a) -> torch.Tensor:
    """A CPU tensor of a numpy array (bfloat16 through float32, which holds
    it exactly) or of a tensor (a DTensor's whole value, gathered: every
    rank of its mesh must call this)."""
    if isinstance(a, torch.Tensor):
        if hasattr(a, "full_tensor"):
            a = a.full_tensor()
        return a.detach().cpu()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _leaves(tree: dict, prefix: str = ""):
    """(dotted path, leaf name, leaf) of every leaf of a nested dict."""
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", name, value


def _entry(path: str, name: str, a: torch.Tensor):
    """The port's state-dict name and tensor of one unstacked JAX leaf."""
    if name in _BIAS:
        return path[: -len(name)] + _BIAS[name] + ".bias", a
    if a.ndim == 2 and name not in _NOT_LINEAR:  # a dense weight: nn.Linear's layout
        return path + ".weight", a.T.contiguous()
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
            yield i, tree["scan"][p], (lambda a, u=u: _tensor(a[u]))
        else:
            yield i, tree["tail"][i - plan.n_scan * n_unit], _tensor


def _stacked(state: dict, prefix: str, tree: dict, depth: int) -> None:
    """Entry i of every leaf of a tree stacked over `depth` layers, as
    `<prefix>.<i>.<path>`."""
    for path, name, a in _leaves(tree):
        for i in range(depth):
            key, t = _entry(f"{prefix}.{i}.{path}", name, _tensor(a[i]))
            state[key] = t


def params_from_jax(cfg, tree) -> dict[str, torch.Tensor]:
    """The port's state dict of a JAX params tree of `cfg` (module
    docstring). A tree of another config's layout raises a KeyError."""
    try:
        return _params_from_jax(cfg, tree)
    except (KeyError, IndexError) as e:
        raise KeyError(f"the tree does not hold {cfg.name}'s params (no {e})") from e


def _params_from_jax(cfg, tree) -> dict[str, torch.Tensor]:
    state = {"embed": _tensor(tree["embed"]),
             "final_norm.scale": _tensor(tree["final_norm"]["scale"])}
    for i, sub, take in _layers(cfg, tree["layers"]):
        for path, name, a in _leaves(sub):
            key, t = _entry(f"layers.{i}.{path}", name, take(a))
            state[key] = t
    if cfg.is_encdec:
        _stacked(state, "enc_layers", tree["enc_layers"], cfg.n_encoder_layers)
        state["enc_norm.scale"] = _tensor(tree["enc_norm"]["scale"])
        _stacked(state, "cross", tree["cross"], cfg.n_layers)
    if not cfg.tie_embeddings:
        state["lm_head.weight"] = _tensor(tree["lm_head"]).T.contiguous()
    return state


def _jax_path(parts: list[str]) -> tuple[list[str], bool]:
    """The JAX tree path of a port parameter path within a layer (or at the
    top), and whether its tensor is transposed there: the inverse of
    `_entry`."""
    if parts[-1] == "bias" and parts[-2] in _BIAS_OF:
        return parts[:-2] + [_BIAS_OF[parts[-2]]], False
    if parts[-1] == "weight":
        return parts[:-1], True
    return parts, False


def jax_leaf(cfg, name: str) -> tuple[tuple, bool, int | None]:
    """Where a port parameter lives in the JAX `init_params` tree: (its leaf's
    path, whether the port's tensor is that leaf transposed, and its index
    on the leaf's stacked layer axis, None for a leaf of one layer)."""
    parts = name.split(".")
    if parts[0] not in _STACKED:
        path, transposed = _jax_path(parts)
        return tuple(path), transposed, None
    i = int(parts[1])
    path, transposed = _jax_path(parts[2:])
    if parts[0] != "layers":
        return (parts[0], *path), transposed, i
    n_unit, n_scanned = len(unit_plan(cfg).unit), _scanned(cfg)
    if i < n_scanned:
        u, p = divmod(i, n_unit)
        return ("layers", "scan", p, *path), transposed, u
    return ("layers", "tail", i - n_scanned, *path), transposed, None


def _scanned(cfg) -> int:
    """The number of decoder layers the JAX package stacks into its scan."""
    plan = unit_plan(cfg)
    return plan.n_scan * len(plan.unit)


def params_to_jax(cfg, named: dict) -> dict:
    """The JAX `init_params` tree of the port's named tensors (a model's
    state dict, or the optimizer's moments under the same names), the
    inverse of `params_from_jax`: the decoder's layers stacked by unit
    position over the units into {"scan": (...), "tail": (...)}, the
    encoder's and the cross layers stacked over their depth, every
    nn.Linear weight transposed back to (d_in, d_out), the qkv biases back
    to bq, bk, bv. Leaves are CPU tensors in their own dtype."""
    _check_family(cfg)
    plan = unit_plan(cfg)
    n_unit = len(plan.unit)
    flat, stacks = {}, {}
    for name, t in named.items():
        path, transposed, index = jax_leaf(cfg, name)
        t = _tensor(t)
        t = t.T if transposed else t
        if index is None:
            flat[path] = t
        else:
            stacks.setdefault(path, {})[index] = t
    for key, by_index in stacks.items():
        flat[key] = torch.stack([by_index[i] for i in range(len(by_index))])
    tree = _nest(flat)
    layers = tree.setdefault("layers", {})
    layers["scan"] = tuple(layers.get("scan", {}).get(p, {}) for p in range(n_unit))
    layers["tail"] = tuple(layers.get("tail", {}).get(p, {}) for p in range(len(plan.tail)))
    return tree


def _nest(flat: dict) -> dict:
    tree = {}
    for path, t in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = t
    return tree


def decay_mask(cfg, named: dict) -> dict[str, bool]:
    """Whether AdamW decays each named parameter: the JAX package decays a
    leaf whose array has ndim >= 2 in its tree, where the scanned decoder
    layers, the encoder's and the cross layers are stacked (one more
    dimension) and the tail layers and the top-level leaves are not."""
    n_scanned = _scanned(cfg)

    def stacked(parts):
        return parts[0] in _STACKED and (parts[0] != "layers" or int(parts[1]) < n_scanned)

    return {name: t.ndim + stacked(name.split(".")) >= 2 for name, t in named.items()}


def train_state_to_jax(cfg, state) -> dict:
    """The JAX `TrainState` tree of a port train state (params, opt.mu,
    opt.nu, opt.count, ef.residual when ef is kept, step), as
    `train.checkpoint.save` writes it; the counts are int32 scalars."""
    tree = {"params": params_to_jax(cfg, dict(state.params.named_parameters())),
            "opt": {"mu": params_to_jax(cfg, state.opt.mu), "nu": params_to_jax(cfg, state.opt.nu),
                    "count": torch.tensor(state.opt.count, dtype=torch.int32)},
            "step": torch.tensor(state.step, dtype=torch.int32)}
    if state.ef is not None:
        tree["ef"] = {"residual": params_to_jax(cfg, state.ef.residual)}
    return tree


def load_train_state(cfg, state, tree):
    """Write a JAX `TrainState` tree (a checkpoint's) into the port train
    state: the tensors in place, cast to their dtypes, a DTensor's by its
    own placements (each rank keeps its shard of the whole tensor). Returns
    the state with the restored counts. A state that keeps ef needs the
    tree's."""
    with torch.no_grad():
        _copy_into(dict(state.params.named_parameters()), params_from_jax(cfg, tree["params"]))
        for name in ("mu", "nu"):
            _copy_into(getattr(state.opt, name), params_from_jax(cfg, tree["opt"][name]))
        if state.ef is not None:
            _copy_into(state.ef.residual, params_from_jax(cfg, tree["ef"]["residual"]))
    opt = state.opt._replace(count=int(tree["opt"]["count"]))
    return state._replace(opt=opt, step=int(tree["step"]))


def _copy_into(dst: dict, src: dict) -> None:
    if dst.keys() != src.keys():
        raise KeyError(f"the tree's names {sorted(src.keys() ^ dst.keys())} do not match")
    for name, t in dst.items():
        value = src[name].to(device=t.device, dtype=t.dtype)
        if hasattr(t, "device_mesh"):
            from torch.distributed.tensor import distribute_tensor

            value = distribute_tensor(value, t.device_mesh, t.placements, src_data_rank=None)
        t.copy_(value)


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
