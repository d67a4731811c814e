"""Problem generators: SK spin glass, MaxCut (dense and sparse layouts),
random 3-regular MaxCut and the CAL-letters lattice.

The numpy generation is the JAX package's (`repro.core.problems`) line for
line, so (n, seed) gives arrays elementwise equal to the JAX ones.

Mapping conventions (for E(s) = sum_{i<j} J_ij s_i s_j + b.s, p ∝ e^{-E}):

  * MaxCut on graph G=(V,E,w): cut(s) = sum_{(i,j) in E} w_ij (1 - s_i s_j)/2.
    Maximizing the cut == minimizing sum w_ij s_i s_j == ground state of
    J = +w (antiferromagnetic), b = 0.
  * SK spin glass: J_ij ~ N(0, 1)/sqrt(n), b = 0.

The problem zoo (`ZooProblem`, the reference energies) follows in a later
slice of the port (see ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ising import KING_OFFSETS, DenseIsing, LatticeIsing, lattice_from_pairs
from repro_torch.core.sparse import SparseIsing

# random_maxcut densities at or below this return the neighbor-list
# SparseIsing layout by default (as in the JAX package).
SPARSE_DENSITY_MAX = 0.25


def random_maxcut(
    n: int,
    seed: int,
    density: float = 1.0,
    weights: str = "unit",
    sparse: "bool | None" = None,
    device=None,
) -> "DenseIsing | SparseIsing":
    """Random (weighted) MaxCut instance.

    weights: 'unit' -> w=1 edges; 'uniform' -> w ~ U(0,1].

    sparse: layout control. None picks the neighbor-list `SparseIsing` form
    when density <= SPARSE_DENSITY_MAX and the dense matrix otherwise;
    True/False force a layout. The instance is identical either way.
    """
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < density
    w = np.ones((n, n)) if weights == "unit" else rng.random((n, n))
    J = np.triu(mask * w, k=1)
    J = J + J.T
    problem = DenseIsing.from_numpy(J, np.zeros((n,)), device=device)
    if sparse is None:
        sparse = density <= SPARSE_DENSITY_MAX
    return SparseIsing.from_dense(problem) if sparse else problem


def random_3regular_maxcut(n: int, seed: int, device=None) -> SparseIsing:
    """Unit-weight antiferromagnetic MaxCut on a random 3-regular graph.

    The graph is a random Hamiltonian cycle plus a random perfect matching
    on the cycle's chords (every vertex gains exactly one chord), so every
    vertex has degree exactly 3. Requires even n >= 4. Deterministic in
    `seed`; max_deg == 3, so the greedy coloring uses at most 4 colors.
    """
    if n < 4 or n % 2:
        raise ValueError(f"3-regular graph needs even n >= 4, got {n}")
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    cycle = {frozenset((int(order[k]), int(order[(k + 1) % n]))) for k in range(n)}
    for _ in range(1000):
        perm = rng.permutation(n)
        pairs = [(int(perm[2 * k]), int(perm[2 * k + 1])) for k in range(n // 2)]
        if all(frozenset(p) not in cycle for p in pairs):
            break
    else:  # probability of 1000 failures is negligible
        raise RuntimeError("failed to sample a matching disjoint from the cycle")
    edges = [(int(order[k]), int(order[(k + 1) % n]), 1.0) for k in range(n)]
    edges += [(i, j, 1.0) for i, j in pairs]
    return SparseIsing.from_edges(n, edges, device=device)


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


# CAL letters (Fig. 3F): ground state spells C, A, L on the 16x16 core.
# 1 = letter pixel, 0 = background; letters C A L in three 5-wide columns.
_CAL_ROWS = [
    "0000000000000000",
    "0011100111000100",
    "0100000100100100",
    "0100000100100100",
    "0100000111100100",
    "0100000100100100",
    "0011100100100111",
    "0000000000000000",
    "0000000000000000",
    "0011100111000100",
    "0100000100100100",
    "0100000100100100",
    "0100000111100100",
    "0100000100100100",
    "0011100100100111",
    "0000000000000000",
]


def cal_template() -> np.ndarray:
    """(16,16) ±1 float32 template spelling CAL (twice, to use the full core)."""
    t = np.array([[int(c) for c in row] for row in _CAL_ROWS], dtype=np.int8)
    return (2 * t - 1).astype(np.float32)


def cal_problem(coupling: float = 1.0, device=None) -> LatticeIsing:
    """King's-move lattice whose two ground states are ±cal_template().

    Neighbors with equal template value get ferromagnetic J=-coupling;
    neighbors with opposite value get antiferromagnetic J=+coupling. The
    problem is gauge-equivalent to a uniform ferromagnet, so the ground
    state is exactly ±template.
    """
    t = cal_template()
    H, W = t.shape
    pairs = {}
    for y in range(H):
        for x in range(W):
            for dy, dx in KING_OFFSETS[4:]:  # each undirected pair once
                yy, xx = y + dy, x + dx
                if 0 <= yy < H and 0 <= xx < W:
                    same = t[y, x] == t[yy, xx]
                    pairs[((y, x), (yy, xx))] = -coupling if same else coupling
    return lattice_from_pairs(H, W, pairs, device=device)
