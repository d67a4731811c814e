"""Sparse Ising problems: padded neighbor lists + greedy graph coloring.

The port of `repro.core.sparse`. `SparseIsing` stores the model of
`repro_torch.core.ising` (E = sum_{i<j} J_ij s_i s_j + b.s, p ∝ e^{-E}) as
a padded neighbor list:

    nbr_idx: (n, max_deg) int32   — neighbor site indices
    nbr_w:   (n, max_deg) float32 — coupling J_ij to each neighbor
    deg:     (n,) int32           — true degree of each site

Slots k >= deg[i] are PADDING: they point at the site itself (a valid index,
so gathers never go out of bounds) and carry weight 0 (so gathers AND
duplicate-target scatter-adds are both correct without masking). nbr_idx
stays int32, the layout the CUDA kernels take.

Each undirected edge (i, j, w) is stored twice — once in row i and once in
row j — so `local_fields` is one gather and `energy` halves the pair sum,
mirroring the dense symmetric-J convention.

Disorder samples: `nbr_w` may be (S, n, max_deg), S samples' couplings over
the one neighbour table and colouring, as a spin-glass study runs many
samples of one lattice. A batch of states then holds its rows sample-major:
the leading axis of s has B rows, B a multiple of S, and row r takes the
couplings of sample r // (B / S). The fields, the energy and the sweeps are
per row; each sample's couplings must be symmetric.

`color_masks` (optional, (n_colors, n) bool) partitions the sites into
independent sets via greedy graph coloring (`color_graph`): same-color
sites share no edge, so their conditionals are independent — exact
parallel (chromatic) Gibbs on arbitrary graphs.

The fields are summed over the slots in order, k = 0..max_deg-1, one
rounded multiply and one rounded add per slot: the order the CUDA kernels
use, so the plain and kernel paths agree bit for bit on the card. JAX's
`jnp.sum` reduces the slots in its own order, so fields agree with the JAX
package to about one float32 eps of sum_k |w_ik| + |b_i| (exactly for
integer weights).

Construction (edge lists, coloring, validation) is numpy on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.core.ising import DenseIsing, resolve_device


def gather_sum(s: torch.Tensor, nbr_idx: torch.Tensor, nbr_w: torch.Tensor) -> torch.Tensor:
    """sum_k nbr_w[i,k] * s[..., nbr_idx[i,k]], summed over k in slot order.

    s: (..., n); nbr_idx (n, D) int32; nbr_w (n, D), or (S, n, D) per
    sample, s then (B, ..., n) with row r of sample r // (B / S) (module
    docstring). Returns (..., n)."""
    if nbr_w.ndim == 3:
        S = check_sample_rows(s, nbr_w.shape[0])
        rows = s.reshape((S, s.shape[0] // S) + tuple(s.shape[1:]))
        w = nbr_w.reshape((S,) + (1,) * (s.ndim - 1) + tuple(nbr_w.shape[1:]))
        return _slot_sum(rows, nbr_idx, w).reshape(s.shape)
    return _slot_sum(s, nbr_idx, nbr_w)


def _slot_sum(s: torch.Tensor, nbr_idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_k w[..., i, k] * s[..., nbr_idx[i, k]] from a zero accumulator,
    slot by slot; w broadcasts against s's leading axes."""
    acc = torch.zeros(s.shape, dtype=w.dtype, device=s.device)
    for k in range(nbr_idx.shape[-1]):
        acc = acc + w[..., k] * s.index_select(-1, nbr_idx[:, k])
    return acc


def check_sample_rows(s: torch.Tensor, S: int) -> int:
    """S, after raising unless s is (B, ..., n) with B a multiple of S > 0:
    the rows of S disorder samples, sample-major."""
    if S < 1 or s.ndim < 2 or s.shape[0] % S:
        raise ValueError(
            f"per-sample couplings of {S} samples take states (B, ..., n) whose B rows are a "
            f"multiple of {S}, sample-major (row r of sample r // (B / {S})); got "
            f"{tuple(s.shape)}")
    return S


def padded_energy(s: torch.Tensor, nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """E(s) = 0.5 * sum_i s_i h_i + b.s of (..., n) states over the padded
    neighbour tables, h_i the in-order slot sum (`gather_sum`) without b:
    each undirected edge is stored twice, so the pair sum is halved."""
    s = s.to(nbr_w.dtype)
    pair = 0.5 * torch.sum(s * gather_sum(s, nbr_idx, nbr_w), dim=-1)
    return pair + torch.sum(b * s, dim=-1)


@dataclasses.dataclass(frozen=True)
class SparseIsing:
    """Ising problem over a sparse graph in padded neighbor-list layout.

    Attributes:
      nbr_idx: (n, max_deg) int32 neighbor indices; padded slots = own index.
      nbr_w:   (n, max_deg) float32 couplings, or (S, n, max_deg), S
               disorder samples' (module docstring); padded slots = 0.
      deg:     (n,) int32 true degrees.
      b:       (n,) float32 biases.
      color_masks: optional (n_colors, n) bool independent-set partition.
    """

    nbr_idx: torch.Tensor
    nbr_w: torch.Tensor
    deg: torch.Tensor
    b: torch.Tensor
    color_masks: Optional[torch.Tensor] = None

    @classmethod
    def from_numpy(
        cls, nbr_idx, nbr_w, deg, b, color_masks=None, device=None
    ) -> "SparseIsing":
        """Build from numpy arrays (e.g. a JAX problem's fields through
        `np.asarray`) on `device` (None: the CUDA device)."""
        dev = resolve_device(device)
        return cls(
            nbr_idx=torch.tensor(np.asarray(nbr_idx, np.int32), device=dev),
            nbr_w=torch.tensor(np.asarray(nbr_w, np.float32), device=dev),
            deg=torch.tensor(np.asarray(deg, np.int32), device=dev),
            b=torch.tensor(np.asarray(b, np.float32), device=dev),
            color_masks=None if color_masks is None
            else torch.tensor(np.asarray(color_masks, bool), device=dev),
        )

    @property
    def n(self) -> int:
        """Number of sites."""
        return self.nbr_idx.shape[-2]

    @property
    def max_deg(self) -> int:
        """Padded neighbor-list width."""
        return self.nbr_idx.shape[-1]

    @property
    def device(self) -> torch.device:
        """The device the neighbor tables live on (the driver runs there)."""
        return self.nbr_w.device

    @property
    def per_sample(self) -> bool:
        """Whether the couplings are per disorder sample, (S, n, max_deg)."""
        return self.nbr_w.ndim == 3

    @property
    def n_samples(self) -> int:
        """Disorder samples S: the leading axis of per-sample couplings, else 1."""
        return self.nbr_w.shape[0] if self.per_sample else 1

    @property
    def n_colors(self) -> int:
        """Number of color classes."""
        if self.color_masks is None:
            raise ValueError("problem has no color_masks (built with color=False)")
        return self.color_masks.shape[0]

    def neighbor_sum(self, s: torch.Tensor) -> torch.Tensor:
        """sum_j J_ij s_j via the padded gather. s: (..., n) ±1 -> (..., n);
        per sample, (B, ..., n) with row r of sample r // (B / S).

        Padded slots gather the site's own spin but multiply by weight 0."""
        return gather_sum(s.to(self.nbr_w.dtype), self.nbr_idx, self.nbr_w)

    def local_fields(self, s: torch.Tensor) -> torch.Tensor:
        """h_i = sum_j J_ij s_j + b_i (batched)."""
        return self.neighbor_sum(s) + self.b

    def energy(self, s: torch.Tensor) -> torch.Tensor:
        """E(s); each undirected edge is stored twice, so halve the pair sum."""
        return padded_energy(s, self.nbr_idx, self.nbr_w, self.b)

    def delta_fields(self, s: torch.Tensor, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Field updates caused by flipping site i: O(max_deg).

        Returns (idx, dh), both (max_deg,): after s_i -> -s_i, apply
        `h.index_add_(-1, idx, dh)`. Padded slots contribute dh = 0 at
        idx = i, so the scatter-add needs no degree mask. One table of
        couplings only."""
        self._one_table("delta_fields")
        return self.nbr_idx[i], self.nbr_w[i] * (-2.0 * s[i])

    def _one_table(self, what: str) -> None:
        if self.per_sample:
            raise NotImplementedError(
                f"{what} takes one table of couplings; this problem has {self.n_samples} "
                "disorder samples' (S, n, max_deg): take one with dataclasses.replace(problem, "
                "nbr_w=problem.nbr_w[k])")

    def to_dense(self) -> DenseIsing:
        """Materialize the (n, n) symmetric coupling matrix (host-side); one
        table of couplings only."""
        self._one_table("to_dense")
        n, md = self.n, self.max_deg
        J = np.zeros((n, n), np.float64)
        rows = np.repeat(np.arange(n), md)
        np.add.at(
            J,
            (rows, self.nbr_idx.cpu().numpy().reshape(-1)),
            self.nbr_w.cpu().numpy().astype(np.float64).reshape(-1),
        )  # padded slots add 0 on the diagonal — harmless
        return DenseIsing.from_numpy(J, self.b.cpu().numpy(), device=self.device)

    @classmethod
    def from_dense(
        cls,
        problem: DenseIsing,
        threshold: float = 0.0,
        max_deg: Optional[int] = None,
        color: bool = True,
    ) -> "SparseIsing":
        """Neighbor-list form of a DenseIsing, keeping |J_ij| > threshold, on
        the problem's device.

        max_deg defaults to the largest resulting row degree; passing a
        larger value pads further. Raises if any row degree exceeds a given
        max_deg."""
        J = problem.J.cpu().numpy()
        if J.ndim != 2 or J.shape[0] != J.shape[1]:
            raise ValueError(f"J must be square, got shape {J.shape}")
        keep = np.abs(J) > threshold
        np.fill_diagonal(keep, False)
        edges = [
            (int(i), int(j), float(J[i, j]))
            for i, j in zip(*np.nonzero(np.triu(keep, k=1)))
        ]
        return cls.from_edges(
            J.shape[0], edges, b=problem.b.cpu().numpy(), max_deg=max_deg, color=color,
            device=problem.device,
        )

    @classmethod
    def from_edges(
        cls,
        n: int,
        edges: Iterable[tuple[int, int, float]],
        b=None,
        max_deg: Optional[int] = None,
        color: bool = True,
        color_masks=None,
        device=None,
    ) -> "SparseIsing":
        """Build from an undirected edge list [(i, j, w), ...], each edge once,
        on `device` (None: the CUDA device).

        `color_masks` supplies a known coloring (e.g. the king 4-coloring);
        otherwise `color=True` runs greedy `color_graph` at construction."""
        adj: list[list[tuple[int, float]]] = [[] for _ in range(n)]
        for i, j, w in edges:
            i, j = int(i), int(j)
            if i == j:
                raise ValueError(f"self-loop on site {i} (zero-diagonal convention)")
            if not (0 <= i < n and 0 <= j < n):
                raise ValueError(f"edge ({i}, {j}) out of range for n={n}")
            adj[i].append((j, float(w)))
            adj[j].append((i, float(w)))
        deg = np.asarray([len(a) for a in adj], np.int32)
        md = max(1, int(deg.max()) if n else 1)
        if max_deg is not None:
            if max_deg < md:
                raise ValueError(f"max_deg={max_deg} < largest row degree {md}")
            md = max_deg
        # padding convention: own index, zero weight
        nbr_idx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, md))
        nbr_w = np.zeros((n, md), np.float32)
        for i, a in enumerate(adj):
            for k, (j, w) in enumerate(a):
                nbr_idx[i, k] = j
                nbr_w[i, k] = w
        if color_masks is None and color:
            color_masks = colors_to_masks(color_graph(nbr_idx, deg))
        b = np.zeros((n,), np.float32) if b is None else np.asarray(b, np.float32)
        return cls.from_numpy(nbr_idx, nbr_w, deg, b, color_masks, device=device)

    def validate(self) -> None:
        """Raise ValueError on a malformed instance (host-side, in memory of
        the order of the tables: the couplings are never densified). Per
        sample, every sample's couplings are checked."""
        idx = self.nbr_idx.cpu().numpy()
        w = self.nbr_w.cpu().numpy()
        deg = self.deg.cpu().numpy()
        b = self.b.cpu().numpy()
        n, md = idx.shape
        want = (max(1, w.shape[0]), n, md) if w.ndim == 3 else (n, md)
        if w.shape != want or deg.shape != (n,) or b.shape != (n,):
            raise ValueError(
                f"inconsistent shapes: nbr_idx {idx.shape}, nbr_w {w.shape}, "
                f"deg {deg.shape}, b {b.shape}"
            )
        if idx.min(initial=0) < 0 or idx.max(initial=0) >= n:
            raise ValueError(f"nbr_idx out of range [0, {n})")
        if not np.all(np.isfinite(w)) or not np.all(np.isfinite(b)):
            raise ValueError(
                "nbr_w/b must be finite: NaN/Inf couplings would silently "
                "poison every recorded energy and the downstream TTS fits"
            )
        slot = np.arange(md)[None, :]
        pad = slot >= deg[:, None]
        if np.any(w[..., pad] != 0.0):
            raise ValueError("padded neighbor slots must carry zero weight")
        if np.any(idx[~pad] == np.arange(n)[:, None].repeat(md, 1)[~pad]):
            raise ValueError("self-coupling in a live neighbor slot (zero-diagonal convention)")
        for k, wk in enumerate(w.reshape((-1, n, md))):
            if not _symmetric(idx, wk):
                raise ValueError(
                    "couplings are not symmetric: every edge (i, j, w) must be "
                    "stored in BOTH row i and row j"
                    + (f" (disorder sample {k})" if w.ndim == 3 else "")
                )
        if self.color_masks is not None:
            masks = self.color_masks.cpu().numpy()
            if masks.shape[-1] != n:
                raise ValueError(f"color_masks last dim {masks.shape[-1]} != n {n}")
            if not np.all(masks.sum(axis=0) == 1):
                raise ValueError("color_masks must assign each site exactly one color")
            colors = masks.argmax(axis=0)
            live = ~pad
            if np.any(colors[idx][live] == colors[:, None].repeat(md, 1)[live]):
                raise ValueError("color_masks is not a proper coloring (edge within a color)")


def _symmetric(idx: np.ndarray, w: np.ndarray, rtol: float = 1e-5, atol: float = 1e-6) -> bool:
    """Whether the (n, n) couplings the tables stand for, J[i, j] the sum of
    row i's slots that name j (pads add 0 on the diagonal), equal their
    transpose as `np.allclose(J, J.T, rtol, atol)` would find: checked at
    every (i, j) where J or J.T has a slot, in both orders, without forming
    J (elsewhere both are 0)."""
    n, md = idx.shape
    key = np.repeat(np.arange(n, dtype=np.int64), md) * n + idx.reshape(-1).astype(np.int64)
    keys, inv = np.unique(key, return_inverse=True)
    a = np.bincount(inv.reshape(-1), weights=w.reshape(-1).astype(np.float64),
                    minlength=keys.size)
    tkeys = (keys % n) * n + keys // n
    pos = np.minimum(np.searchsorted(keys, tkeys), max(keys.size - 1, 0))
    b = np.where(keys[pos] == tkeys, a[pos], 0.0) if keys.size else a  # J.T at each key
    gap = np.abs(a - b)
    return bool(np.all(gap <= atol + rtol * np.abs(b)) and np.all(gap <= atol + rtol * np.abs(a)))


def color_graph(nbr_idx: np.ndarray, deg: np.ndarray) -> np.ndarray:
    """Greedy graph coloring (first-fit in site order): (n,) int colors.

    Uses at most max_deg + 1 colors. Host-side — runs once at problem
    construction."""
    idx = np.asarray(nbr_idx)
    deg = np.asarray(deg)
    n = idx.shape[0]
    colors = np.full(n, -1, np.int64)
    for i in range(n):
        used = {int(colors[j]) for j in idx[i, : deg[i]] if colors[j] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors


def colors_to_masks(colors: np.ndarray) -> np.ndarray:
    """(n,) int colors -> (n_colors, n) bool independent-set masks."""
    colors = np.asarray(colors)
    n_colors = int(colors.max()) + 1 if colors.size else 1
    return np.stack([colors == c for c in range(n_colors)])
