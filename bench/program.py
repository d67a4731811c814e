"""The program's problem objects over tensors the benchmark made: what the
entries hand `repro_torch` (imported here, when called, and nowhere at a
module's import)."""
from __future__ import annotations

import torch


def problem(kind: str, inst: dict):
    """A `DenseIsing` (kind "dense": J, b) or an unclamped `LatticeIsing`
    (kind "king": w, b) over the instance's own tensors."""
    from repro_torch.core.ising import DenseIsing, LatticeIsing

    if kind == "dense":
        return DenseIsing(J=inst["J"], b=inst["b"])
    b = inst["b"]
    none = torch.zeros(b.shape, dtype=torch.bool, device=b.device)
    return LatticeIsing(w=inst["w"], b=b, clamp_mask=none, clamp_value=-torch.ones_like(b),
                        dead_mask=none)
