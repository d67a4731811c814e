"""Per-rank counts of a step from the torch ops it dispatches: the port's
counterpart of `repro/launch/hlo_analysis.py`.

There is no HLO in eager PyTorch. `StepCounter` is a dispatch mode that
sees every op a step runs on one rank and counts, at the *local* shapes:

  * FLOPs        — the matmul-type ops, by `torch.utils.flop_counter`'s
                   registry (mm, addmm, bmm, baddbmm, convolutions,
                   attention); elementwise flops are ignored, as there.
  * HBM bytes    — operand + result bytes of every op that is not a view
                   (eager runs no fusion, so each op reads its operands and
                   writes its result); an in-place op counts its target
                   twice. A write into a slice (a decode step's cache row)
                   counts the slice, not the buffer. `hbm_bytes_upper` is
                   the same number (the HLO count's pessimistic variant has
                   no counterpart here).
  * collectives  — every `_c10d_functional` op's result bytes times the
                   ring factor of `roofline._FACTORS` (as the HLO count
                   weighs them), intra-node (`ici_bytes`) or inter-node
                   (`dcn_bytes`) by the ranks of its group: a group whose
                   ranks span more than one node of `node_size` devices
                   crosses nodes. A fake world's mesh is a CPU mesh, where
                   DTensor turns a shard-to-shard all-to-all into an
                   all-gather and a local chunk: counted as that all-gather.
  * n_while      — 0: a loop over layers runs, so it is counted by running.
  * a loop over time (`layers.scan`: the sLSTM's steps, the mLSTM's
    chunks) runs its body once, forward and backward, and the counts of
    its ops are multiplied by the trip count (`trips`), as hlo_analysis
    multiplies a while body by its known_trip_count (a subclass with
    `fold_scans = False` runs and counts every trip).

DTensor: a mode wrapped around a DTensor op sees the *global* op (a
`FlopCounterMode` around a 256-way sharded matmul counts the whole
product). This mode declines every op on a DTensor (it returns
NotImplemented, so DTensor's own dispatch runs) and counts the local ops
DTensor then issues, with the mode still active: the rank's shard of the
matmul and the collectives of its redistributions. The ops DTensor runs on
fake tensors to infer shapes are run and not counted.

    with StepCounter() as c:
        step(...)
    summary = c.summary()
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.roofline import _FACTORS, NODE_SIZE

# _c10d_functional op name -> roofline collective kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",  # DTensor's own, on a CUDA mesh
    "broadcast": "collective-permute",
}
_PLAIN = (torch.Tensor, torch.nn.Parameter)


def _no_bytes() -> frozenset:
    """Ops that move no data though their schema is no view's (those this
    torch build has)."""
    names = (("aten", "_unsafe_view"), ("_c10d_functional", "wait_tensor"),
             ("_c10d_functional", "_wrap_tensor_autograd"))
    namespaces = {ns: getattr(torch.ops, ns) for ns, _ in names}
    return frozenset(getattr(namespaces[ns], op).default for ns, op in names
                     if hasattr(namespaces[ns], op))


@dataclasses.dataclass
class StepSummary:
    """`HLOSummary`'s fields, per rank."""
    flops: float
    hbm_bytes: float
    hbm_bytes_upper: float
    ici_bytes: float        # factor-weighted collective bytes inside a node
    dcn_bytes: float        # factor-weighted collective bytes across nodes
    coll_by_kind: dict
    n_while: int

    def to_dict(self):
        return dataclasses.asdict(self)


def _bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


def crosses_nodes(ranks, node_size: int = NODE_SIZE) -> bool:
    """Whether a group of global ranks spans more than one node."""
    return len({r // node_size for r in ranks}) > 1


def _group_ranks(group_name: str) -> list[int]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    return dist.get_process_group_ranks(_resolve_process_group(group_name))


def _group_name(func, args, kwargs):
    """The group-name argument of a _c10d_functional op."""
    schema = func._schema
    for i, arg in enumerate(schema.arguments):
        if arg.name == "group_name":
            return kwargs["group_name"] if "group_name" in kwargs else args[i]
    raise ValueError(f"{func}: no group_name argument")


class StepCounter(TorchDispatchMode):
    """Counts FLOPs, HBM bytes and collective bytes of the ops run under it
    (module docstring)."""

    fold_scans = True  # `layers.scan` runs its body once, counted `trips` times

    def __init__(self, node_size: int = NODE_SIZE):
        super().__init__()
        self.node_size = node_size
        self._trips = 1
        self.flops = 0.0
        self.hbm = 0.0
        self.ici = 0.0
        self.dcn = 0.0
        self.by_kind: dict = defaultdict(lambda: {"count": 0, "bytes": 0.0})
        self._ranks: dict[str, list[int]] = {}
        self._no_bytes = _no_bytes()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # count the local ops DTensor issues
        out = func(*args, **kwargs)
        if all(t in _PLAIN for t in types):  # not DTensor's shape inference on fake tensors
            self._count(func, args, kwargs, out)
        return out

    @contextlib.contextmanager
    def trips(self, n: int):
        """Count the ops run inside as n times each (a folded loop's body)."""
        outer = self._trips
        self._trips = outer * n
        try:
            yield
        finally:
            self._trips = outer

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += self._trips * flop_registry[packet](*args, **kwargs, out_val=out)
        if func.namespace in ("_c10d_functional", "_dtensor") and packet.__name__ in _COLLECTIVES:
            self._collective(_COLLECTIVES[packet.__name__], func, args, kwargs, out)
        if func.is_view or func in self._no_bytes:
            return
        self.hbm += self._trips * (_bytes((args, kwargs)) + _bytes(out))  # in place: twice

    def _collective(self, kind, func, args, kwargs, out) -> None:
        name = _group_name(func, args, kwargs)
        if name not in self._ranks:
            self._ranks[name] = _group_ranks(name)
        nbytes = self._trips * _bytes(out)
        weighted = nbytes * _FACTORS[kind]
        d = self.by_kind[kind]
        d["count"] += self._trips
        d["bytes"] += nbytes
        if crosses_nodes(self._ranks[name], self.node_size):
            self.dcn += weighted
        else:
            self.ici += weighted

    def summary(self) -> StepSummary:
        return StepSummary(flops=self.flops, hbm_bytes=self.hbm, hbm_bytes_upper=self.hbm,
                           ici_bytes=self.ici, dcn_bytes=self.dcn,
                           coll_by_kind={k: dict(v) for k, v in self.by_kind.items()}, n_while=0)
