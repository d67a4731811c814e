"""The program's problem objects over tensors the benchmark made: what the
entries hand `repro_torch` (imported here, when called, and nowhere at a
module's import)."""
from __future__ import annotations

import torch


def problem(kind: str, inst: dict):
    """The program's problem of `kind` (a reference's `KIND`) over the
    instance's own tensors: a `DenseIsing` ("dense": J, b), an unclamped
    `LatticeIsing` ("king": w, b) or a `SparseIsing` ("sparse": nbr_idx,
    nbr_w, deg, b, color_masks). Any other kind raises."""
    from repro_torch.core.ising import DenseIsing, LatticeIsing
    from repro_torch.core.sparse import SparseIsing

    if kind == "dense":
        return DenseIsing(J=inst["J"], b=inst["b"])
    if kind == "king":
        b = inst["b"]
        none = torch.zeros(b.shape, dtype=torch.bool, device=b.device)
        return LatticeIsing(w=inst["w"], b=b, clamp_mask=none, clamp_value=-torch.ones_like(b),
                            dead_mask=none)
    if kind == "sparse":
        return SparseIsing(nbr_idx=inst["nbr_idx"], nbr_w=inst["nbr_w"], deg=inst["deg"],
                           b=inst["b"], color_masks=inst["color_masks"])
    raise ValueError(f"no program problem of kind {kind!r}; have 'dense', 'king', 'sparse'")
