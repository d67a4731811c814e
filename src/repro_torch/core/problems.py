"""Problem generators and the problem zoo.

The port of `repro.core.problems`: SK spin glass, MaxCut (dense and sparse
layouts), random 3-regular MaxCut, the CAL-letters lattice, and the zoo —
registered-by-name generators (`register_problem` / `get_problem`) that
return a `ZooProblem`, the instance plus a known or estimated ground-state
energy for time-to-solution accounting.

The numpy generation is the JAX package's line for line, so (name, size,
seed) gives arrays elementwise equal to the JAX ones and the same
reference energies. Every generator takes `device=None` (the CUDA device).

Mapping conventions (for E(s) = sum_{i<j} J_ij s_i s_j + b.s, p ∝ e^{-E}):

  * MaxCut on graph G=(V,E,w): cut(s) = sum_{(i,j) in E} w_ij (1 - s_i s_j)/2.
    Maximizing the cut == minimizing sum w_ij s_i s_j == ground state of
    J = +w (antiferromagnetic), b = 0.
  * SK spin glass: J_ij ~ N(0, 1)/sqrt(n), b = 0.
  * Factorization of an odd semiprime N = p*q: minimize (N - p(x) q(y))^2
    over odd binary factors, quadratized with Rosenberg product variables
    z_ij = x_i y_j; the planted factorization is the exact ground state.

Reference-energy kinds:

  "exact"     — provably the ground-state energy (ferromagnet, cal; maxcut/sk
                at n <= EXACT_ENUM_MAX via exhaustive enumeration).
  "planted"   — energy of a constructed solution known to be optimal.
  "estimated" — best of multi-restart greedy descent (deterministic in the
                instance seed).

"boltzmann_ml" draws its digit batch from a torch.Generator, so its
instance equals the JAX zoo's only when built from the JAX zoo's batch
(`boltzmann_ml_from_batch`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import numpy as np
import torch

from repro_torch.core.ising import (
    KING_OFFSETS,
    DenseIsing,
    LatticeIsing,
    king_color_masks,
    lattice_from_pairs,
    resolve_device,
)
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


# ---------------------------------------------------------------------------
# Reference-energy machinery (numpy, as in the JAX package)
# ---------------------------------------------------------------------------

# Largest n for which exact enumeration (2^n states) is used for references.
EXACT_ENUM_MAX = 16


def exact_ground_energy(problem: DenseIsing) -> float:
    """Exhaustive ground-state energy for small dense problems (n <= 20)."""
    n = problem.n
    assert n <= 20, "exhaustive ground energy limited to 20 spins"
    J = problem.J.cpu().numpy().astype(np.float64)
    b = problem.b.cpu().numpy().astype(np.float64)
    codes = np.arange(2**n, dtype=np.int64)
    bits = (codes[:, None] >> np.arange(n)[None, :]) & 1
    states = (2 * bits - 1).astype(np.float64)
    E = 0.5 * np.einsum("si,ij,sj->s", states, J, states) + states @ b
    return float(E.min())


def greedy_descent_dense(
    J: np.ndarray, b: np.ndarray, s0: np.ndarray, max_sweeps: int = 64
) -> tuple[np.ndarray, float]:
    """Sequential iterated-conditional-modes descent to a local minimum.

    Each site is set to s_i = -sign(h_i) in order; a sweep with no change is
    a 1-flip-stable local minimum. Deterministic. Returns (state, energy).
    """
    s = s0.astype(np.float64).copy()
    n = len(s)
    for _ in range(max_sweeps):
        changed = False
        for i in range(n):
            h_i = J[i] @ s + b[i]
            want = -1.0 if h_i > 0 else 1.0
            if want != s[i]:
                s[i] = want
                changed = True
        if not changed:
            break
    e = 0.5 * s @ (J @ s) + b @ s
    return s, float(e)


def estimate_reference(
    problem: Union[DenseIsing, LatticeIsing, SparseIsing],
    seed: int,
    n_restarts: int = 8,
    starts: Any = None,
) -> float:
    """Best energy over greedy descents from random (+ optional given) starts.

    Lattice and sparse problems descend through their dense form (clamp/dead
    masks are ignored — zoo lattice instances are unclamped). Deterministic
    in `seed`.
    """
    dense = problem if isinstance(problem, DenseIsing) else problem.to_dense()
    J = dense.J.cpu().numpy().astype(np.float64)
    b = dense.b.cpu().numpy().astype(np.float64)
    n = dense.n
    rng = np.random.default_rng(seed)
    s_starts = [2.0 * rng.integers(0, 2, n) - 1.0 for _ in range(n_restarts)]
    if starts is not None:
        s_starts += [np.asarray(s, np.float64).reshape(-1) for s in starts]
    best = np.inf
    for s0 in s_starts:
        _, e = greedy_descent_dense(J, b, s0)
        best = min(best, e)
    return float(best)


# ---------------------------------------------------------------------------
# Zoo registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ZooProblem:
    """A zoo instance: the problem plus its TTS reference energy.

    name:       registry name of the generator.
    instance:   unique id, e.g. "maxcut-n32-s0" (stable across runs).
    problem:    DenseIsing | LatticeIsing | SparseIsing.
    ref_energy: ground-state energy (see ref_kind).
    ref_kind:   "exact" | "planted" | "estimated".
    meta:       generator-specific extras (planted factors, edge counts...).
    """

    name: str
    instance: str
    problem: Union[DenseIsing, LatticeIsing, SparseIsing]
    ref_energy: float
    ref_kind: str
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        """Number of spins in the wrapped instance."""
        return self.problem.n

    @property
    def kind(self) -> str:
        """Problem kind of the wrapped instance (dense/lattice/sparse)."""
        if isinstance(self.problem, LatticeIsing):
            return "lattice"
        if isinstance(self.problem, SparseIsing):
            return "sparse"
        return "dense"

    def target_energy(self, rel_gap: float) -> float:
        """First-hit target: ref + rel_gap * |ref| (== ref when ref == 0)."""
        return self.ref_energy + rel_gap * abs(self.ref_energy)


PROBLEMS: dict[str, Callable[..., ZooProblem]] = {}
PROBLEM_KINDS: dict[str, str] = {}


def register_problem(name: str, kind: str):
    """Decorator: register a `(size, seed, **kw) -> ZooProblem` generator.

    `kind` ("dense" | "lattice" | "sparse") is registry metadata."""
    if kind not in ("dense", "lattice", "sparse"):
        raise ValueError(f"kind must be 'dense', 'lattice', or 'sparse', got {kind!r}")

    def deco(fn):
        """Register `fn` under `name` and return it unchanged."""
        PROBLEMS[name] = fn
        PROBLEM_KINDS[name] = kind
        fn.zoo_name = name
        return fn

    return deco


def get_problem(name: str, size: int, seed: int = 0, **kw) -> ZooProblem:
    """Instantiate a registered zoo problem by name (`device=` is passed on
    to the generator; None: the CUDA device)."""
    if name not in PROBLEMS:
        raise KeyError(f"unknown zoo problem {name!r}; have {sorted(PROBLEMS)}")
    return PROBLEMS[name](size, seed, **kw)


def problem_kind(name: str) -> str:
    """Registered kind ("dense" | "lattice" | "sparse") of a zoo problem."""
    if name not in PROBLEM_KINDS:
        raise KeyError(f"unknown zoo problem {name!r}; have {sorted(PROBLEM_KINDS)}")
    return PROBLEM_KINDS[name]


def problem_names() -> list[str]:
    """Sorted names of all registered zoo problems."""
    return sorted(PROBLEMS)


def _dense_reference(problem: DenseIsing, seed: int) -> tuple[float, str]:
    if problem.n <= EXACT_ENUM_MAX:
        return exact_ground_energy(problem), "exact"
    return estimate_reference(problem, seed), "estimated"


def _sparse_reference(problem: SparseIsing, seed: int) -> tuple[float, str]:
    if problem.n <= EXACT_ENUM_MAX:
        return exact_ground_energy(problem.to_dense()), "exact"
    return estimate_reference(problem, seed), "estimated"


@register_problem("maxcut", kind="dense")
def maxcut_zoo(size: int, seed: int = 0, density: float = 0.5, weights: str = "unit",
               device=None) -> ZooProblem:
    """Gset-style random MaxCut: edges drawn i.i.d. with prob `density`.

    Always the dense layout (the registered kind) — the sparse-graph MaxCut
    workload is "maxcut3r"."""
    problem = random_maxcut(size, seed, density=density, weights=weights, sparse=False,
                            device=device)
    problem.validate()
    ref, kind = _dense_reference(problem, seed)
    J = problem.J.cpu().numpy()
    n_edges = int(np.count_nonzero(np.triu(J, k=1)))
    return ZooProblem(
        name="maxcut",
        instance=f"maxcut-n{size}-s{seed}",
        problem=problem,
        ref_energy=ref,
        ref_kind=kind,
        meta={"density": density, "n_edges": n_edges,
              "best_cut": float(0.5 * (np.sum(np.triu(J, 1)) - ref))},
    )


@register_problem("sk", kind="dense")
def sk_zoo(size: int, seed: int = 0, device=None) -> ZooProblem:
    """Sherrington-Kirkpatrick spin glass, J ~ N(0, 1/n)."""
    problem = sk_instance(size, seed, device=device)
    problem.validate()
    ref, kind = _dense_reference(problem, seed)
    return ZooProblem(
        name="sk",
        instance=f"sk-n{size}-s{seed}",
        problem=problem,
        ref_energy=ref,
        ref_kind=kind,
        meta={"e_per_spin": ref / size},
    )


@register_problem("maxcut3r", kind="sparse")
def maxcut3r_zoo(size: int, seed: int = 0, dense: bool = False, device=None) -> ZooProblem:
    """Unit MaxCut on a random 3-regular graph — the sparse workload where
    neighbor-list layouts pay off (3n/2 edges vs n^2/2 dense slots).

    dense=True returns the SAME graph densified via `to_dense()` (instance
    id gains a "-dense" suffix) for layout head-to-head benchmarks.
    """
    sp = random_3regular_maxcut(size, seed, device=device)
    sp.validate()
    ref, kind = _sparse_reference(sp, seed)
    total_w = float(np.sum(sp.deg.cpu().numpy()))  # each unit edge counted twice
    meta = {
        "n_edges": int(total_w / 2),
        "max_deg": sp.max_deg,
        "n_colors": sp.n_colors,
        "best_cut": float(0.5 * (total_w / 2 - ref)),
    }
    problem: Union[DenseIsing, SparseIsing] = sp.to_dense() if dense else sp
    suffix = "-dense" if dense else ""
    return ZooProblem(
        name="maxcut3r",
        instance=f"maxcut3r-n{size}-s{seed}{suffix}",
        problem=problem,
        ref_energy=ref,
        ref_kind=kind,
        meta=meta,
    )


@register_problem("king", kind="sparse")
def king_zoo(size: int, seed: int = 0, device=None) -> ZooProblem:
    """±J spin glass on the (size x size) king's-move graph in neighbor-list
    form — the chip topology expressed as a SparseIsing, with the exact
    king 4-coloring instead of the greedy coloring.
    """
    rng = np.random.default_rng(seed)
    n = size * size
    edges = []
    for y in range(size):
        for x in range(size):
            for dy, dx in KING_OFFSETS[4:]:  # each undirected pair once
                yy, xx = y + dy, x + dx
                if 0 <= yy < size and 0 <= xx < size:
                    w = float(rng.choice((-1.0, 1.0)))
                    edges.append((y * size + x, yy * size + xx, w))
    masks = king_color_masks(size, size, device="cpu").numpy().reshape(4, n)
    sp = SparseIsing.from_edges(n, edges, color_masks=masks, device=device)
    sp.validate()
    ref, kind = _sparse_reference(sp, seed)
    return ZooProblem(
        name="king",
        instance=f"king-L{size}-s{seed}",
        problem=sp,
        ref_energy=ref,
        ref_kind=kind,
        meta={"n_edges": len(edges), "max_deg": sp.max_deg, "n_colors": sp.n_colors},
    )


# --- integer factorization as a planted Ising instance ----------------------


def _factor_odd_semiprime(N: int) -> tuple[int, int]:
    if N < 9 or N % 2 == 0:
        raise ValueError(f"need an odd composite N >= 9, got {N}")
    for p in range(3, int(N**0.5) + 1, 2):
        if N % p == 0:
            return p, N // p
    raise ValueError(f"{N} is prime — nothing to factor")


def factorization_ising(N: int, device=None) -> tuple[DenseIsing, np.ndarray, dict]:
    """Encode factoring the odd semiprime N as a DenseIsing ground state.

    Odd factors p = 1 + sum_{i>=1} 2^i x_i, q = 1 + sum_{j>=1} 2^j y_j with
    nb bits each; products z_ij = x_i y_j enter via Rosenberg penalties
    P*(3z + xy - 2zx - 2zy) >= 0 (zero iff z = xy), so

        H = (N - p q)^2 + penalties >= 0,

    with equality exactly at consistent factorizations — the planted (p, q)
    [and its (q, p) mirror] is a global ground state. The QUBO is converted
    to ±1 spins and rescaled to max|J|, max|b| <= 1.

    Returns (problem, planted ±1 state, meta with N/p/q/bit layout).
    """
    p, q = _factor_odd_semiprime(N)
    nb = max((p - 1).bit_length(), (q - 1).bit_length()) - 1
    n = 2 * nb + nb * nb  # x bits, y bits, z products

    def ix(i):
        return i  # x_i, i in [0, nb)

    def iy(j):
        return nb + j  # y_j, j in [0, nb)

    def iz(i, j):
        return 2 * nb + i * nb + j  # z_ij = x_i y_j

    # Linear coefficients of N - p q = A0 - sum_k a_k v_k over 0/1 vars v.
    a = np.zeros(n)
    for i in range(nb):
        a[ix(i)] = 2.0 ** (i + 1)
        a[iy(i)] = 2.0 ** (i + 1)
        for j in range(nb):
            a[iz(i, j)] = 2.0 ** (i + j + 2)
    A0 = float(N - 1)

    # QUBO: H = v^T Q v (upper tri) + c.v + const, using v^2 = v.
    Q = np.zeros((n, n))
    c = a * a - 2.0 * A0 * a
    for k in range(n):
        Q[k, k + 1:] += 2.0 * a[k] * a[k + 1:]
    P = float(N)  # any P > 0 keeps the planted state globally optimal
    for i in range(nb):
        for j in range(nb):
            t, u, w = iz(i, j), ix(i), iy(j)
            c[t] += 3.0 * P
            Q[min(u, w), max(u, w)] += P
            Q[min(t, u), max(t, u)] -= 2.0 * P
            Q[min(t, w), max(t, w)] -= 2.0 * P

    # 0/1 -> ±1: v = (1+s)/2. Pair Q_kl v_k v_l -> J_kl = Q_kl/4 plus linear
    # spill Q_kl/4 onto both b_k and b_l; linear c_k v_k -> b_k += c_k/2.
    J = (Q + Q.T) / 4.0
    b = c / 2.0 + J.sum(axis=1)
    np.fill_diagonal(J, 0.0)

    scale = max(np.abs(J).max(), np.abs(b).max(), 1e-12)
    problem = DenseIsing.from_numpy(J / scale, b / scale, device=device)

    v = np.zeros(n)
    for i in range(nb):
        v[ix(i)] = (p - 1) >> (i + 1) & 1
        v[iy(i)] = (q - 1) >> (i + 1) & 1
    for i in range(nb):
        for j in range(nb):
            v[iz(i, j)] = v[ix(i)] * v[iy(j)]
    s_planted = 2.0 * v - 1.0
    meta = {"N": N, "p": p, "q": q, "n_bits": nb, "penalty": P, "scale": scale}
    return problem, s_planted, meta


@register_problem("factorization", kind="dense")
def factorization_zoo(size: int, seed: int = 0, device=None) -> ZooProblem:
    """Factor the odd semiprime `size` (seed is ignored — the instance is
    determined by N; it stays in the signature for registry uniformity)."""
    problem, s_planted, meta = factorization_ising(size, device=device)
    problem.validate()
    ref = float(problem.energy(torch.as_tensor(s_planted, dtype=torch.float32,
                                               device=problem.device)))
    return ZooProblem(
        name="factorization",
        instance=f"factorization-N{size}",
        problem=problem,
        ref_energy=ref,
        ref_kind="planted",
        meta=meta,
    )


@register_problem("ferromagnet", kind="lattice")
def ferromagnet_zoo(size: int, seed: int = 0, coupling: float = 1.0,
                    device=None) -> ZooProblem:
    """Uniform king's-move lattice ferromagnet (size x size), J = -coupling.
    Exact ground states: all-up / all-down."""
    pairs = {}
    for y in range(size):
        for x in range(size):
            for dy, dx in KING_OFFSETS[4:]:
                yy, xx = y + dy, x + dx
                if 0 <= yy < size and 0 <= xx < size:
                    pairs[((y, x), (yy, xx))] = -coupling
    problem = lattice_from_pairs(size, size, pairs, device=device)
    ref = float(problem.energy(torch.ones((size, size), device=problem.device)))
    return ZooProblem(
        name="ferromagnet",
        instance=f"ferromagnet-L{size}-c{coupling:g}",
        problem=problem,
        ref_energy=ref,
        ref_kind="exact",
        meta={"coupling": coupling, "n_edges": len(pairs)},
    )


@register_problem("cal", kind="lattice")
def cal_zoo(size: int = 16, seed: int = 0, coupling: float = 1.0, device=None) -> ZooProblem:
    """The Fig. 3F CAL-letters lattice (gauge-transformed ferromagnet);
    exact ground states ±cal_template(). size must be 16."""
    if size != 16:
        raise ValueError("cal is fixed to the 16x16 core")
    problem = cal_problem(coupling=coupling, device=device)
    ref = float(problem.energy(torch.as_tensor(cal_template(), device=problem.device)))
    return ZooProblem(
        name="cal",
        instance=f"cal-16x16-c{coupling:g}",
        problem=problem,
        ref_energy=ref,
        ref_kind="exact",
        meta={"coupling": coupling},
    )


def boltzmann_ml_lattice(batch: torch.Tensor, size: int, scale: float = 1.0) -> LatticeIsing:
    """The Hebbian lattice Boltzmann machine of a (B, >= size, >= size) ±1
    batch, cropped to its top-left size x size: the one-shot multiplier-free
    CD limit J = -scale * E[s s'] (negative J favors the data
    correlations), b = -scale * E[s], on the batch's device. The same
    numbers as the JAX zoo's construction for the same batch."""
    from repro_torch.core.boltzmann import batch_mean, pair_correlations

    batch = batch[:, :size, :size]
    w = -scale * pair_correlations(batch, size, size)
    b = -scale * batch_mean(batch)
    dev = batch.device
    return LatticeIsing(
        w=w.to(torch.float32),
        b=b.to(torch.float32),
        clamp_mask=torch.zeros((size, size), dtype=torch.bool, device=dev),
        clamp_value=-torch.ones((size, size), dtype=torch.float32, device=dev),
        dead_mask=torch.zeros((size, size), dtype=torch.bool, device=dev),
    )


def boltzmann_ml_from_batch(
    batch: torch.Tensor,
    size: int = 16,
    seed: int = 0,
    digits: tuple = (0, 1, 2),
    n_each: int = 16,
    flip_prob: float = 0.05,
    scale: float = 1.0,
) -> ZooProblem:
    """The `boltzmann_ml` zoo instance of a given digit batch (the JAX zoo's
    instance when given the JAX zoo's batch): the lattice of
    `boltzmann_ml_lattice`, and its reference energy estimated from 8
    random restarts (from `seed`) and the digits' templates."""
    from repro_torch.data import digits as digit_data

    if size > 16:
        raise ValueError("digit templates are 16x16; size must be <= 16")
    problem = boltzmann_ml_lattice(batch, size, scale)
    starts = [digit_data.digit_template(d)[:size, :size] for d in digits]
    ref = estimate_reference(problem, seed, n_restarts=8, starts=starts)
    return ZooProblem(
        name="boltzmann_ml",
        instance=f"boltzmann_ml-L{size}-s{seed}",
        problem=problem,
        ref_energy=ref,
        ref_kind="estimated",
        meta={"digits": list(digits), "n_each": n_each, "flip_prob": flip_prob},
    )


@register_problem("boltzmann_ml", kind="lattice")
def boltzmann_ml_zoo(
    size: int = 16,
    seed: int = 0,
    digits: tuple = (0, 1, 2),
    n_each: int = 16,
    flip_prob: float = 0.05,
    scale: float = 1.0,
    device=None,
) -> ZooProblem:
    """Hebbian lattice Boltzmann machine — the paper's ML workload (Fig. 4).

    Couplings are the one-shot multiplier-free CD limit over a noisy digit
    batch (`boltzmann_ml_from_batch`), the batch drawn from a
    torch.Generator seeded with `seed` on `device` (None: the CUDA device).
    It is another draw than the JAX zoo's batch of the same seed, so the
    instance is the JAX one only when built from the JAX batch."""
    from repro_torch.data import digits as digit_data

    if size > 16:
        raise ValueError("digit templates are 16x16; size must be <= 16")
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    batch = digit_data.mixed_batch(list(digits), n_each, generator, flip_prob, device=dev)
    return boltzmann_ml_from_batch(batch, size, seed, digits, n_each, flip_prob, scale)
