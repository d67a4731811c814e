"""Fault-tolerant checkpointing in the JAX package's on-disk format:
sharded npz + manifest, atomic, elastic.

The port of `repro/train/checkpoint.py`. One directory per step:

    ckpt_dir/step_000000042/
        manifest.json      — {step, n_shards, keys: {name: {shape, dtype[, whole]}}}
        shard_00000.npz    — flat {name: array piece} for host-shard 0
        ...
        COMMIT             — empty file written LAST (atomic commit marker)

A tree is nested dicts and tuples (or lists) of tensors, numpy arrays or
scalars; a leaf's name joins its path with "::": dict keys as they are,
"#i" for entry i of a tuple, so `convert.train_state_to_jax`'s tree gets
the names JAX gives its `TrainState` (NamedTuple fields by name), e.g.
`params::layers::scan::#0::attn::wq`. Each array is split along axis 0
into n_shards pieces (np.array_split); a scalar or a leaf shorter than
n_shards goes whole into shard 0 ("whole" in the manifest). The pieces are
written into a temporary directory that `os.replace` renames into place
once COMMIT is in it, so a crash mid-write never leaves a step that
`latest_step` would pick.

bfloat16: numpy has no bf16 without ml_dtypes, and the JAX package's save
writes an ml_dtypes bf16 leaf through np.savez as raw 2-byte voids ("|V2")
with "dtype": "bfloat16" in the manifest. This writes a bf16 tensor's bytes
the same way, and restore reads "|V2" by the manifest's dtype (viewed as
int16, then as torch.bfloat16), bit for bit, without ml_dtypes.

`restore` rebuilds the tree from the names alone (no tree to fill, as the
JAX one takes): nested dicts, and tuples where a level's keys are "#i".
Leaves come back as CPU tensors in the manifest's dtype.

A sharded train state is saved whole, in the same format:
`convert.train_state_to_jax` gathers each DTensor (`full_tensor`; every
rank calls it) and rank 0 writes; `convert.load_train_state` restores the
tree into the state's own placements (`distribute_tensor`), the
counterpart of JAX's `restore(..., shardings=...)`.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch

SEP = "::"
_V2 = np.dtype("V2")


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (tuple, list)):
        items = ((f"#{i}", v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for key, value in items:
        out.update(_flatten(value, f"{prefix}{SEP}{key}" if prefix else key))
    return out


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(the array written, the manifest's dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_V2), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree, n_shards: int = 1) -> str:
    """Write a checkpoint; returns the committed directory path."""
    flat = _flatten(tree)
    os.makedirs(ckpt_dir or ".", exist_ok=True)
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=ckpt_dir or ".")
    manifest = {"step": int(step), "n_shards": int(n_shards), "keys": {}}
    shards: list[dict[str, np.ndarray]] = [dict() for _ in range(n_shards)]
    for name, leaf in flat.items():
        arr, dtype = _to_numpy(leaf)
        manifest["keys"][name] = {"shape": list(arr.shape), "dtype": dtype}
        if arr.ndim == 0 or arr.shape[0] < n_shards:
            shards[0][name] = arr  # small/scalar: shard 0 owns it
            manifest["keys"][name]["whole"] = True
        else:
            for i, piece in enumerate(np.array_split(arr, n_shards, axis=0)):
                shards[i][name] = piece
    for i, sh in enumerate(shards):
        np.savez(os.path.join(tmp, f"shard_{i:05d}.npz"), **sh)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w"):
        pass
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.replace(tmp, step_dir)
    return step_dir


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest committed step in ckpt_dir, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(os.path.join(ckpt_dir, d, "COMMIT")):
            best = max(best or -1, int(d[5:]))
    return best


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _unflatten(flat: dict):
    tree = {}
    for name, leaf in flat.items():
        node, parts = tree, name.split(SEP)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return _tuples(tree)


def _tuples(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.startswith("#") for k in node):
        return tuple(_tuples(node[f"#{i}"]) for i in range(len(node)))
    return {k: _tuples(v) for k, v in node.items()}


def restore(ckpt_dir: str, step: int):
    """The tree saved at `step` (module docstring), CPU tensors as leaves."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    values = {}
    with contextlib.ExitStack() as stack:
        shards = [stack.enter_context(np.load(os.path.join(step_dir, f"shard_{i:05d}.npz")))
                  for i in range(manifest["n_shards"])]
        for name, meta in manifest["keys"].items():
            if meta.get("whole"):
                arr = shards[0][name]
            else:
                arr = np.concatenate([sh[name] for sh in shards], axis=0)
            values[name] = _tensor(arr, meta["dtype"])
    return _unflatten(values)
