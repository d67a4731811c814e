"""Dense problem generators: SK spin glass and dense MaxCut.

The numpy generation is the JAX package's (`repro.core.problems`) line for
line, so (n, seed) gives couplings elementwise equal to the JAX ones.

Mapping conventions (for E(s) = sum_{i<j} J_ij s_i s_j + b.s, p ∝ e^{-E}):

  * MaxCut on graph G=(V,E,w): cut(s) = sum_{(i,j) in E} w_ij (1 - s_i s_j)/2.
    Maximizing the cut == minimizing sum w_ij s_i s_j == ground state of
    J = +w (antiferromagnetic), b = 0.
  * SK spin glass: J_ij ~ N(0, 1)/sqrt(n), b = 0.

The rest of the problem zoo, and the sparse MaxCut layout, follow in later
slices of the port (see ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ising import DenseIsing

# random_maxcut densities at or below this use the neighbor-list sparse
# layout by default (as in the JAX package), which the sparse slice ports.
SPARSE_DENSITY_MAX = 0.25


def random_maxcut(
    n: int,
    seed: int,
    density: float = 1.0,
    weights: str = "unit",
    sparse: "bool | None" = None,
    device=None,
) -> DenseIsing:
    """Random (weighted) MaxCut instance in the dense layout.

    weights: 'unit' -> w=1 edges; 'uniform' -> w ~ U(0,1].

    sparse: None picks the sparse layout when density <= SPARSE_DENSITY_MAX
    (the JAX package's default); the sparse layout is not ported yet, so
    that choice, and sparse=True, raise NotImplementedError.
    """
    if sparse is None:
        sparse = density <= SPARSE_DENSITY_MAX
    if sparse:
        raise NotImplementedError(
            "the sparse MaxCut layout (SparseIsing) arrives with the sparse "
            "slice of the port; pass sparse=False for the dense layout"
        )
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < density
    w = np.ones((n, n)) if weights == "unit" else rng.random((n, n))
    J = np.triu(mask * w, k=1)
    J = J + J.T
    return DenseIsing.from_numpy(J, np.zeros((n,)), device=device)


def sk_instance(n: int, seed: int, device=None) -> DenseIsing:
    """Sherrington-Kirkpatrick: J_ij ~ N(0, 1/n), symmetric, zero diag."""
    rng = np.random.default_rng(seed)
    A = rng.normal(0.0, 1.0, (n, n)) / np.sqrt(n)
    J = np.triu(A, k=1)
    J = J + J.T
    return DenseIsing.from_numpy(J, np.zeros((n,)), device=device)


def cut_value(problem: DenseIsing, s: torch.Tensor) -> torch.Tensor:
    """Cut size for a MaxCut-encoded problem (J = +w)."""
    total_w = torch.sum(torch.triu(problem.J, diagonal=1))
    return 0.5 * (total_w - problem.energy(s))
