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

DTensor is not GSPMD: it pads no uneven sharding and inserts no
redistribution a view needs, and its releases differ in what they accept
(torch 2.11's refuses a merge whose inner dimension is sharded, which
2.13's makes a strided shard). So the models state their layouts in terms
every release accepts, through three helpers, no-ops on plain tensors:
`reshape` (a view, after gathering exactly the dimensions it cannot keep
sharded), `einsum` (computed on each rank's shards, the result placed by
the operands' labels) and `on_shards` (any computation that mixes no
sharded dimension, on the local shards). None branches on the torch
release: each decides from the placements and the shapes.
"""
from __future__ import annotations

import contextlib
from collections.abc import Mapping
from typing import Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

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

    Uneven shardings are allowed here (a dimension its mesh axes do not
    divide: DTensor's shards then differ in size). A dimension smaller than
    the product of its mesh axes is held replicated on them instead, as
    every rank computes its whole (a global batch of 1 on the data axis:
    GSPMD pads it to one row a rank, each rank computing one row either
    way). Duplicate mesh axes within one spec are resolved
    first-come-first-served. Under an active mesh `x` must be a DTensor: a
    plain tensor raises."""
    st = _STACK
    if not st:
        return x
    mesh, rules = st[-1]
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain{tuple(logical)}: a plain {type(x).__name__} under an "
                        "active mesh; the sharded step makes every tensor a DTensor")
    parts = [rules.get(a) if a is not None else None for a in logical]
    parts = [p if p is None or n >= _axis_size(mesh, p) else None
             for p, n in zip(_dedup(parts), x.shape)]
    # redistributed even where the placements hold already: the backward
    # pass then brings the gradient to them too, as GSPMD constrains the
    # cotangent
    return _redistribute(x, spec_to_placements(parts, mesh))


def _redistribute(x, placements):
    """x redistributed to `placements` on its mesh: every gather or chunk
    the port's layouts add goes through here."""
    return x.redistribute(x.device_mesh, tuple(placements))


def _view_groups(src: tuple, dst: tuple) -> list:
    """The (input dims, output dims) pairs of a view from shape `src` to
    `dst`: the shortest runs of dimensions whose sizes multiply alike."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        ins, outs, a, b = [], [], 1, 1
        if i < len(src):
            ins, a, i = [i], src[i], i + 1
        if j < len(dst):
            outs, b, j = [j], dst[j], j + 1
        while a != b:
            if a < b:
                ins.append(i)
                a, i = a * src[i], i + 1
            else:
                outs.append(j)
                b, j = b * dst[j], j + 1
        groups.append((ins, outs))
    return groups


def reshape(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`x.reshape(shape)` for a DTensor `x` too, redistributed first where
    the view cannot keep its layout: the view GSPMD would insert a
    redistribution for. DTensor views a sharded dimension only where
    every DTensor release accepts it: a dimension kept whole; the first
    dimension (of size > 1) of a run of dimensions merged into one, evenly
    sharded; a dimension split into several whose first (of size > 1) its
    mesh axes divide. Its newer releases also merge a sharded inner
    dimension (as a strided shard) and flatten uneven shards, which older
    ones refuse. Every other sharded dimension of x is gathered over its
    mesh axes (and only those), then the view is taken. The gradient's view
    back to x's shape is made legal the same way, whatever the gradient's
    layout. A plain tensor, or a DTensor whose layout the view keeps, is
    only viewed."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    return _Reshape.apply(x, _resolved(tuple(x.shape), shape))


def _resolved(src: tuple, shape) -> tuple:
    """`shape` with its -1 resolved against a tensor of shape src."""
    dst = list(shape)
    if -1 in dst:
        k = dst.index(-1)
        rest = total = 1
        for n in dst[:k] + dst[k + 1:]:
            rest *= n
        for n in src:
            total *= n
        dst[k] = total // rest
    return tuple(dst)


def _legal_for_view(x, dst: tuple):
    """x redistributed (`reshape`'s rule) so that every DTensor release can
    view it as `dst`; x itself where it can already."""
    src = tuple(x.shape)
    sizes = x.device_mesh.shape
    placements = list(x.placements)
    for ins, outs in _view_groups(src, dst):
        ins_big = [d for d in ins if src[d] > 1]
        outs_big = [dst[o] for o in outs if dst[o] > 1]
        for d in ins:
            mds = [md for md, p in enumerate(placements) if p.is_shard(d)]
            if not mds:
                continue
            n = 1
            for md in mds:
                n *= sizes[md]
            if len(ins_big) == 1 and len(outs_big) <= 1:  # kept whole
                legal = src[d] > 1
            elif len(outs_big) == 1:  # merged: the run's first, evenly
                legal = d == ins_big[0] and src[d] % n == 0
            elif len(ins_big) == 1:  # split: the first part divided
                legal = src[d] % n == 0 and outs_big[0] % n == 0
            else:
                legal = False
            if not legal:
                for md in mds:
                    placements[md] = Replicate()
    return x if placements == list(x.placements) else _redistribute(x, placements)


class _Reshape(torch.autograd.Function):
    """`reshape` of a DTensor: its forward, and a backward that views the
    gradient back to x's shape by the same rule (the gradient may arrive
    in another layout than the forward's result had)."""

    @staticmethod
    def forward(ctx, x, dst):
        ctx.src = tuple(x.shape)
        return _legal_for_view(x, dst).reshape(dst)

    @staticmethod
    def backward(ctx, grad):
        return _legal_for_view(grad, ctx.src).reshape(ctx.src), None


def _grad_placements(p: tuple, sharded: list) -> tuple:
    """The gradient placements of an input of a shard-local computation: a
    mesh dimension the computation splits (`sharded`) where the input is
    replicated sums the ranks' contributions (Partial)."""
    return tuple(Partial() if s and q.is_replicate() else q for q, s in zip(p, sharded))


class _DenseGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a
    shard-local computation's input gradient goes back into a DTensor,
    which infers its global strides from the local ones (an einsum's
    permuted gradient with a size-1 dimension can mislead it)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def on_shards(fn, *xs, placements=None, shape=None):
    """`fn(*xs)` computed on each rank's shards of the DTensors xs, for a
    computation that mixes no dimension a mesh axis shards (the caller lays
    xs out so): the result (a tensor, or a tuple or NamedTuple of them)
    becomes DTensors placed as xs[0] is (or `placements`), each of global
    `shape` (default: the local shape times the mesh axes that shard it,
    even shards). An input replicated on a mesh dimension another input is
    sharded on gets its gradient as a partial sum over that dimension.
    Without a DTensor among xs, `fn(*xs)` itself."""
    if not any(isinstance(t, DTensor) for t in xs):
        return fn(*xs)
    mesh = xs[0].device_mesh
    n = mesh.ndim
    sharded = [any(isinstance(t, DTensor) and t.placements[md].is_shard() for t in xs)
               for md in range(n)]
    local = [_DenseGrad.apply(t.to_local(grad_placements=_grad_placements(t.placements, sharded)))
             if isinstance(t, DTensor) else t for t in xs]
    out = fn(*local)
    placements = tuple(placements or xs[0].placements)

    def wrap(t):
        if shape is None:
            return DTensor.from_local(t, mesh, placements, run_check=False)
        order = _dense_order(t)
        if order is None:
            t, order = t.contiguous(), list(range(t.ndim))
        return DTensor.from_local(t, mesh, placements, run_check=False, shape=torch.Size(shape),
                                  stride=_stride_in_order(shape, order))

    if isinstance(out, torch.Tensor):
        return wrap(out)
    wrapped = [wrap(t) for t in out]
    return type(out)(*wrapped) if hasattr(out, "_fields") else tuple(wrapped)


def _dense_order(t: torch.Tensor):
    """The dimensions of t from outermost to innermost when t is a
    permutation of a dense tensor (an einsum's result), else None."""
    order = sorted(range(t.ndim), key=lambda d: (-t.stride(d), d))
    if [t.stride(d) for d in order] != list(_stride_in_order(
            [t.shape[d] for d in order], range(t.ndim))):
        return None
    return order


def _stride_in_order(shape, order) -> tuple:
    """The strides of a dense tensor of `shape` laid out with its dimensions
    in `order`, outermost first."""
    stride, acc = [0] * len(shape), 1
    for d in reversed(list(order)):
        stride[d] = acc
        acc *= shape[d]
    return tuple(stride)


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """`torch.einsum(eq, *ops)`; on DTensors computed on each rank's shards.

    torch reduces an einsum to a `bmm`, flattening each operand's batch,
    free and contracted dimensions into one apiece; DTensor then has to
    view two sharded dimensions as one (heads and batch under head-TP),
    which only its newer releases do, as a strided shard. Here each mesh
    dimension may shard one label: the operands that have it are brought
    to that sharding (a local chunk of a replicated operand: no
    collective), the others must be replicated on it, and the result is
    sharded on the label, or a partial sum where the label is contracted.
    Operands that shard two labels on one mesh dimension raise: the caller
    lays them out first. Plain tensors count as replicated (DTensor's
    implicit replication)."""
    if not any(isinstance(t, DTensor) for t in ops):
        return torch.einsum(eq, *ops)
    lhs, out_labels = eq.replace(" ", "").split("->")
    in_labels = lhs.split(",")
    mesh = next(t.device_mesh for t in ops if isinstance(t, DTensor))
    ops = [t if isinstance(t, DTensor)
           else DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
           for t in ops]
    size = {lab: n for labs, t in zip(in_labels, ops) for lab, n in zip(labs, t.shape)}
    targets = [list(t.placements) for t in ops]
    out_pl = []
    for md in range(mesh.ndim):
        labs = set()
        for labels, t in zip(in_labels, ops):
            p = t.placements[md]
            if p.is_partial():
                raise ValueError(f"einsum {eq}: a partial operand on mesh dimension {md}")
            if p.is_shard():
                labs.add(labels[p.dim])
        if len(labs) > 1:
            raise ValueError(f"einsum {eq}: mesh dimension {md} shards labels {sorted(labs)}; "
                             "lay the operands out first")
        if not labs:
            out_pl.append(Replicate())
            continue
        (lab,) = labs
        for labels, tgt in zip(in_labels, targets):
            if lab in labels:
                tgt[md] = Shard(labels.index(lab))
        out_pl.append(Shard(out_labels.index(lab)) if lab in out_labels else Partial())
    ops = [t if list(t.placements) == tgt else _redistribute(t, tgt)
           for t, tgt in zip(ops, targets)]
    return on_shards(lambda *local: torch.einsum(eq, *local), *ops, placements=tuple(out_pl),
                     shape=tuple(size[lab] for lab in out_labels))


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
    return distribute_tensor(t, mesh, list(placements), src_data_rank=None)
