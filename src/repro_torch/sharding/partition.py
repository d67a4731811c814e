"""Logical-axis sharding on DTensor: model code names axes, a rules table
maps them to mesh axes, and a bridge turns the mapped spec into DTensor
placements.

The port of `repro/sharding/partition.py`. Model code calls
`constrain(x, ("batch", "seq", "embed"))`. When a mesh and rule-set are
active (see `axis_rules`), a DTensor `x` is redistributed to the mapped
placements (the counterpart of `jax.lax.with_sharding_constraint`); with no
mesh active the call returns `x` itself, so the same model runs unsharded.

A spec is a tuple with one entry per tensor dimension: None, a mesh-axis
name, or a tuple of names, the values JAX's PartitionSpec holds. DTensor
places per *mesh* dimension instead; `spec_to_placements` is the bridge: a
tensor dimension mapped to ("pod", "data") is `Shard(d)` on both of those
mesh dimensions (in mesh order, the order DTensor splits them), a mesh
dimension nothing maps to is `Replicate()`.

Logical axes used across the framework:
  batch       — global batch            -> ("pod", "data") | ("data",)
  seq         — sequence                -> None (or "model" for long-ctx SP)
  embed       — d_model features        -> None in activations
  heads       — attention heads         -> "model"
  kv_heads    — KV heads                -> "model" when divisible, else None
  mlp         — FFN hidden              -> "model"
  vocab       — vocabulary              -> "model"
  experts     — MoE experts             -> "model" (expert parallelism)
  fsdp        — param dim sharded FSDP  -> "data"
  kv_batch    — decode KV-cache batch   -> ("pod", "data") | ("data",)
  kv_seq      — decode KV-cache length  -> None | "model" (paged, MQA archs)
  stage       — reserved (pipeline)     -> None

A mesh is a `DeviceMesh` with named dimensions, or anything whose `shape`
is a {name: size} mapping (the tests fake production meshes so); only
`constrain`, `spec_to_placements` and the placements need a DeviceMesh.
"""
from __future__ import annotations

import contextlib
from collections.abc import Mapping
from typing import Optional, Sequence

import torch

Spec = tuple  # one entry per tensor dimension: None | axis name | tuple of names


def make_mesh_compat(shape, axes, device_type: str = "cuda"):
    """A DeviceMesh of `shape` with the dimension names `axes` over the
    default process group's ranks (`init_device_mesh`)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "fsdp": "data",
    "kv_batch": ("pod", "data"),
    "kv_seq": None,
    "kv_hd": None,
    "stage": None,
}


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} in mesh order, JAX's `mesh.shape`."""
    if isinstance(getattr(mesh, "shape", None), Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_size(mesh) -> int:
    n = 1
    for s in mesh_shape(mesh).values():
        n *= s
    return n


# the active (mesh, merged rules), innermost last; one stack for the
# process, so autograd's thread sees the forward's rules when it recomputes
# a checkpointed region
_STACK: list = []


def _merged_rules(mesh, rules: Optional[dict]) -> dict:
    """DEFAULT_RULES updated by `rules`, with mappings to axes the mesh does
    not have dropped (e.g. "pod" on the single-pod mesh)."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    names = set(mesh_shape(mesh))

    def _filter(v):
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in names else None
        t = tuple(a for a in v if a in names)
        return t if t else None

    return {k: _filter(v) for k, v in merged.items()}


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[dict] = None):
    """Activate (mesh, logical->mesh rules) for constrain() calls within."""
    _STACK.append((mesh, _merged_rules(mesh, rules)))
    try:
        yield
    finally:
        _STACK.pop()


def active_mesh():
    st = _STACK
    return st[-1][0] if st else None


def active_axis_size(logical_name: str) -> int:
    """Mesh-axis product a logical axis maps to under the active rules
    (1 when no mesh is active or the axis is unmapped). Model code uses
    this to pick between sharding layouts (e.g. head-TP vs context-parallel
    attention when head counts don't divide the tensor axis)."""
    st = _STACK
    if not st:
        return 1
    mesh, rules = st[-1]
    return _axis_size(mesh, rules.get(logical_name))


def logical_to_spec(logical: Sequence[Optional[str]]) -> Spec:
    """Map logical axis names to a spec under the active rules."""
    st = _STACK
    if not st:
        return (None,) * len(logical)
    _, rules = st[-1]
    # a one-axis tuple is that axis, as PartitionSpec holds it
    parts = (rules.get(a) if a is not None else None for a in logical)
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts)


def _dedup(parts):
    """Drop mesh axes already used earlier in the spec (each mesh axis may
    shard one tensor dimension only)."""
    used: set[str] = set()
    out = []
    for p in parts:
        if p is None:
            out.append(None)
            continue
        axes = (p,) if isinstance(p, str) else tuple(p)
        kept = tuple(a for a in axes if a not in used)
        used.update(kept)
        out.append(kept[0] if len(kept) == 1 else (kept or None))
    return out


def spec_to_placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements (one per mesh dimension) of a spec (one entry
    per tensor dimension): Shard(d) on every mesh dimension tensor
    dimension d maps to, Replicate() on the others and on a mesh dimension
    of size 1 (the same layout, and DTensor reshapes a replicated dimension
    freely). A mesh axis used twice, an unknown axis, or a tuple of axes out
    of mesh order raises."""
    from torch.distributed.tensor import Replicate, Shard

    shape = mesh_shape(mesh)
    names = list(shape)
    out: list = [Replicate()] * len(names)
    used: set[int] = set()
    for d, p in enumerate(spec):
        if p is None:
            continue
        axes = (p,) if isinstance(p, str) else tuple(p)
        idx = [names.index(a) if a in names else -1 for a in axes]
        if -1 in idx:
            raise ValueError(f"spec {tuple(spec)}: axis not in the mesh {names}")
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)}: axes {axes} out of the mesh's order {names}")
        for i in idx:
            if i in used:
                raise ValueError(f"spec {tuple(spec)}: mesh axis {names[i]!r} used twice")
            used.add(i)
            if shape[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]]) -> torch.Tensor:
    """Redistribute a DTensor to the placements its logical axes map to;
    `x` itself without an active mesh.

    Uneven shardings are allowed here (DTensor pads, as GSPMD does);
    duplicate mesh axes within one spec are resolved first-come-first-served.
    Under an active mesh `x` must be a DTensor: a plain tensor raises."""
    st = _STACK
    if not st:
        return x
    from torch.distributed.tensor import DTensor

    mesh, rules = st[-1]
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain{tuple(logical)}: a plain {type(x).__name__} under an "
                        "active mesh; the sharded step makes every tensor a DTensor")
    parts = [rules.get(a) if a is not None else None for a in logical]
    # redistributed even where the placements hold already: the backward
    # pass then brings the gradient to them too, as GSPMD constrains the
    # cotangent
    return x.redistribute(x.device_mesh, spec_to_placements(_dedup(parts), mesh))


def shards_divide(x: torch.Tensor, dim: int, n: int) -> bool:
    """Whether DTensor can split dimension `dim` of x into (n, ...): the mesh
    axes that shard it multiply to a divisor of n. True for a plain tensor."""
    if not hasattr(x, "placements"):
        return True
    dim %= x.ndim
    size = 1
    for p, s in zip(x.placements, x.device_mesh.shape):
        if p.is_shard(dim):
            size *= s
    return n % size == 0


def _axis_size(mesh, part) -> int:
    if part is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(part, str):
        return shape[part]
    n = 1
    for a in part:
        n *= shape[a]
    return n


def checked_spec(mesh, rules: dict, logical, shape) -> Spec:
    """Spec for a step input: divisibility-enforced and mesh-axis-deduped.
    Non-dividing mappings are dropped (replicated), as pjit requires."""
    parts = []
    for dim, name in zip(shape, logical):
        p = rules.get(name) if name is not None else None
        if p is not None and dim % _axis_size(mesh, p) != 0:
            p = None
        parts.append(p)
    return tuple(_dedup(parts))


def _struct_spec(shape, logical, mesh, merged, transposed: bool) -> Spec:
    if logical is None or len(shape) == 0:
        return ()
    if len(logical) != len(shape):
        raise ValueError(f"axes {logical} vs shape {tuple(shape)}")
    if transposed:  # de-duplicated in the JAX leaf's dimension order
        return checked_spec(mesh, merged, logical[::-1], shape[::-1])[::-1]
    return checked_spec(mesh, merged, logical, shape)


def struct_specs(shapes: dict, axes: dict, mesh, rules: Optional[dict] = None,
                 transposed=()) -> dict:
    """{name: spec} of {name: shape} given {name: logical axes} (None or ()
    for a scalar): divisibility- and duplicate-checked per leaf. The names
    in `transposed` (nn.Linear weights, the JAX leaves' transposes) resolve
    a mesh axis wanted twice as their JAX leaf does."""
    merged = _merged_rules(mesh, rules)
    return {k: _struct_spec(tuple(s), axes[k], mesh, merged, k in transposed)
            for k, s in shapes.items()}


def struct_shardings(shapes: dict, axes: dict, mesh, rules: Optional[dict] = None,
                     transposed=()) -> dict:
    """{name: DTensor placements} of {name: shape (or tensor)} given {name:
    logical axes}: `struct_specs` through `spec_to_placements`."""
    shapes = {k: tuple(getattr(s, "shape", s)) for k, s in shapes.items()}
    return {k: spec_to_placements(s, mesh)
            for k, s in struct_specs(shapes, axes, mesh, rules, transposed).items()}


def named_sharding(logical: Sequence[Optional[str]]):
    """The placements of logical axes on the active mesh (None without one)."""
    st = _STACK
    if not st:
        return None
    mesh, _ = st[-1]
    return spec_to_placements(_dedup(logical_to_spec(logical)), mesh)


def tree_shardings(logical_tree: dict, mesh, rules: Optional[dict] = None) -> dict:
    """{name: placements} of {name: logical axes} (for the step's inputs)."""
    with axis_rules(mesh, rules):
        return {k: named_sharding(lg) for k, lg in logical_tree.items()}


def distribute(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """A DTensor of the whole tensor `t` (the same on every rank) placed by
    `placements`: each rank keeps its shard (`distribute_tensor`)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, list(placements), src_data_rank=None)
