"""Ising / Boltzmann-machine problem representations (dense layout).

The paper's energy convention (Eq. 2):

    E(s) = sum_{i<j} J_ij s_i s_j + sum_i b_i s_i,   s in {-1, +1}
    p(s) = exp(-E(s)) / Z

J is stored as a symmetric matrix with zero diagonal and each pair is
counted once in the energy. The local field of spin i is

    h_i = sum_j J_ij s_j + b_i        (using the full symmetric J row)

and the conditional Boltzmann distribution is

    P(s_i = +1 | s_{-i}) = sigma(-2 h_i)

(the minus sign because LOWER energy is MORE probable under p ∝ e^{-E}).

Two problem classes:
  * DenseIsing  — explicit (n, n) J matrix (SK, MaxCut instances).
  * LatticeIsing — the PASS chip topology: (H, W) king's-move lattice with 8
    neighbor-weight planes, clamp masks and dead-neuron masks, like the
    silicon's configuration chain (8x8-bit weights + 8-bit bias + 2 clamp
    bits per neuron).
The sparse neighbor-list class is `repro_torch.core.sparse.SparseIsing`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# King's move neighbor offsets, fixed order: (dy, dx).
# Order matters: weight plane k of neuron (y, x) couples to (y+dy_k, x+dx_k),
# and the stencil adds the planes in this order (the JAX rounding order).
KING_OFFSETS: tuple[tuple[int, int], ...] = (
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1),           (0, 1),
    (1, -1), (1, 0), (1, 1),
)

# 4-coloring of the king's-move graph: color = (y % 2) * 2 + (x % 2).
# Any two same-color sites differ by an even offset in both coords, which is
# never a king's move, so same-color conditionals are independent -> exact
# parallel (chromatic) Gibbs.
N_KING_COLORS = 4


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `None` means the CUDA device.

    With no CUDA device present, `None` (or a CUDA device named outright)
    raises instead of landing on the CPU; CPU callers (the tests) pass
    `device="cpu"` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class DenseIsing:
    """Fully-specified Ising problem with a dense coupling matrix.

    Attributes:
      J: (n, n) symmetric float32 tensor, zero diagonal. Energy counts each
         pair once: E = s^T (triu(J)) s + b.s  (== 0.5 s^T J s + b.s).
      b: (n,) float32 biases, on J's device.
    """

    J: torch.Tensor
    b: torch.Tensor

    @classmethod
    def from_numpy(cls, J, b, device=None) -> "DenseIsing":
        """Build from numpy arrays (e.g. a JAX problem's `np.asarray(J)`,
        `np.asarray(b)`), as float32 on `device` (None: the CUDA device)."""
        dev = resolve_device(device)
        return cls(
            J=torch.tensor(np.asarray(J, np.float32), device=dev),
            b=torch.tensor(np.asarray(b, np.float32), device=dev),
        )

    @property
    def n(self) -> int:
        """Number of spins."""
        return self.J.shape[-1]

    @property
    def device(self) -> torch.device:
        """The device the couplings live on (the driver runs there)."""
        return self.J.device

    def energy(self, s: torch.Tensor) -> torch.Tensor:
        """E(s) for s in {-1,+1}^n; batched over leading dims of s."""
        Js = torch.matmul(s.to(self.J.dtype), self.J.T)
        pair = 0.5 * torch.sum(s * Js, dim=-1)
        field = torch.sum(self.b * s, dim=-1)
        return pair + field

    def local_fields(self, s: torch.Tensor) -> torch.Tensor:
        """h_i = sum_j J_ij s_j + b_i (batched)."""
        return torch.matmul(s.to(self.J.dtype), self.J.T) + self.b

    def validate(self) -> None:
        """Raise ValueError on a malformed instance (non-square or
        asymmetric J, nonzero diagonal, mismatched b, NaN/Inf)."""
        J = self.J.detach().cpu().numpy()
        b = self.b.detach().cpu().numpy()
        if J.ndim != 2 or J.shape[0] != J.shape[1]:
            raise ValueError(f"J must be a square matrix, got shape {J.shape}")
        if b.shape != (J.shape[0],):
            raise ValueError(f"b shape {b.shape} does not match J shape {J.shape}")
        if not np.all(np.isfinite(J)) or not np.all(np.isfinite(b)):
            raise ValueError(
                "J/b must be finite: NaN/Inf couplings would silently poison "
                "every recorded energy and the downstream TTS fits"
            )
        if not np.allclose(J, J.T, atol=1e-6):
            raise ValueError("J must be symmetric (J == J.T)")
        if not np.allclose(np.diag(J), 0.0, atol=1e-6):
            raise ValueError("J must have a zero diagonal (no self-coupling)")


@dataclasses.dataclass(frozen=True)
class LatticeIsing:
    """PASS-chip lattice: (H, W) neurons, king's-move couplings.

    Attributes:
      w: (8, H, W) float32 neighbor weight planes, w[k, y, x] couples site
         (y,x) with site (y,x)+KING_OFFSETS[k]. Symmetry constraint: the
         plane for offset o at (y,x) equals the plane for -o at (y,x)+o.
         Built via `lattice_from_pairs`, which enforces it.
      b: (H, W) float32 biases.
      clamp_mask: (H, W) bool — True where the neuron output is clamped.
      clamp_value: (H, W) float32 in {-1,+1} — the clamped output value.
      dead_mask: (H, W) bool — True where the neuron is dead (never flips,
         reads as -1).
    """

    w: torch.Tensor
    b: torch.Tensor
    clamp_mask: torch.Tensor
    clamp_value: torch.Tensor
    dead_mask: torch.Tensor

    @classmethod
    def from_numpy(
        cls, w, b, clamp_mask, clamp_value, dead_mask, device=None
    ) -> "LatticeIsing":
        """Build from numpy arrays (e.g. a JAX problem's fields through
        `np.asarray`) on `device` (None: the CUDA device)."""
        dev = resolve_device(device)
        return cls(
            w=torch.tensor(np.asarray(w, np.float32), device=dev),
            b=torch.tensor(np.asarray(b, np.float32), device=dev),
            clamp_mask=torch.tensor(np.asarray(clamp_mask, bool), device=dev),
            clamp_value=torch.tensor(np.asarray(clamp_value, np.float32), device=dev),
            dead_mask=torch.tensor(np.asarray(dead_mask, bool), device=dev),
        )

    @property
    def shape(self) -> tuple[int, int]:
        """Lattice shape (H, W)."""
        return self.w.shape[-2], self.w.shape[-1]

    @property
    def n(self) -> int:
        """Number of lattice sites (H * W)."""
        h, w = self.shape
        return h * w

    @property
    def device(self) -> torch.device:
        """The device the weight planes live on (the driver runs there)."""
        return self.w.device

    def neighbor_sum(self, s: torch.Tensor) -> torch.Tensor:
        """sum_k w_k(y,x) * s((y,x)+o_k), zero beyond the boundary.

        s: (..., H, W) in {-1,+1}. Returns (..., H, W) float. The planes are
        added in KING_OFFSETS order starting from zero, as the JAX stencil
        does, so the fields equal the JAX ones bit for bit."""
        s = s.to(self.w.dtype)
        acc = torch.zeros_like(s)
        for k, (dy, dx) in enumerate(KING_OFFSETS):
            acc = acc + self.w[k] * shift2d(s, dy, dx)
        return acc

    def local_fields(self, s: torch.Tensor) -> torch.Tensor:
        """King's-move stencil local fields for spins `s`."""
        return self.neighbor_sum(s) + self.b

    def energy(self, s: torch.Tensor) -> torch.Tensor:
        """Each pair counted once: 0.5 * sum_i s_i * (neighbor_sum_i) + b.s."""
        s = s.to(self.w.dtype)
        pair = 0.5 * torch.sum(s * self.neighbor_sum(s), dim=(-2, -1))
        field = torch.sum(self.b * s, dim=(-2, -1))
        return pair + field

    def to_dense(self) -> DenseIsing:
        """Flatten to a DenseIsing (row-major site order) for oracles."""
        H, W = self.shape
        n = H * W
        J = np.zeros((n, n), dtype=np.float64)
        w = self.w.detach().cpu().numpy().astype(np.float64)
        for k, (dy, dx) in enumerate(KING_OFFSETS):
            for y in range(H):
                for x in range(W):
                    yy, xx = y + dy, x + dx
                    if 0 <= yy < H and 0 <= xx < W:
                        J[y * W + x, yy * W + xx] += 0.5 * w[k, y, x]
        J = J + J.T  # symmetrize: each directed edge contributed half
        b = self.b.detach().cpu().numpy().astype(np.float64).reshape(-1)
        return DenseIsing.from_numpy(J, b, device=self.device)

    def apply_clamps(self, s: torch.Tensor) -> torch.Tensor:
        """Re-impose clamped-site values on `s`."""
        return torch.where(self.frozen_mask, self.frozen_values.to(s.dtype), s)

    @property
    def frozen_mask(self) -> torch.Tensor:
        """Sites that never update (clamped or dead)."""
        return self.clamp_mask | self.dead_mask

    @property
    def frozen_values(self) -> torch.Tensor:
        """Value read at frozen sites: clamp_value where clamped, -1 where
        dead — dead wins where both (the chip reads dead neurons as -1)."""
        return torch.where(
            self.dead_mask, torch.full_like(self.clamp_value, -1), self.clamp_value
        )


def shift2d(s: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift the last two dims so out[y,x] = s[y+dy, x+dx], zero padded."""
    H, W = s.shape[-2], s.shape[-1]
    p = F.pad(s, (1, 1, 1, 1))
    return p[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]


def lattice_from_pairs(
    H: int,
    W: int,
    pair_weights: dict[tuple[tuple[int, int], tuple[int, int]], float],
    biases: Optional[np.ndarray] = None,
    clamp_mask: Optional[np.ndarray] = None,
    clamp_value: Optional[np.ndarray] = None,
    dead_mask: Optional[np.ndarray] = None,
    device=None,
) -> LatticeIsing:
    """Build a symmetric LatticeIsing from {((y1,x1),(y2,x2)): J} pairs."""
    w = np.zeros((8, H, W), dtype=np.float64)
    off_index = {o: k for k, o in enumerate(KING_OFFSETS)}
    for ((y1, x1), (y2, x2)), val in pair_weights.items():
        o = (y2 - y1, x2 - x1)
        if o not in off_index:
            raise ValueError(f"not a king's move: {o}")
        w[off_index[o], y1, x1] += val
        w[off_index[(-o[0], -o[1])], y2, x2] += val
    b = np.zeros((H, W)) if biases is None else np.asarray(biases, np.float64)
    cm = np.zeros((H, W), bool) if clamp_mask is None else clamp_mask
    cv = -np.ones((H, W)) if clamp_value is None else clamp_value
    dm = np.zeros((H, W), bool) if dead_mask is None else dead_mask
    return LatticeIsing.from_numpy(w, b, cm, cv, dm, device=device)


def quantize_lattice(prob: LatticeIsing, bits: int = 8) -> LatticeIsing:
    """Quantize weights/biases to the chip's signed fixed point grid.

    The chip stores 8-bit weights and biases (codes -127..127). Scale by the
    max-abs over (w, b), round half to even onto the integer grid (as
    `jnp.round`), and keep float values ON the grid (dequantized)."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.maximum(torch.max(torch.abs(prob.w)), torch.max(torch.abs(prob.b)))
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)

    def q(x):
        """Round `x` onto the grid and back to float."""
        return torch.round(x / scale * qmax) * (scale / qmax)

    return dataclasses.replace(prob, w=q(prob.w), b=q(prob.b))


def king_color_masks(H: int, W: int, device=None) -> torch.Tensor:
    """(4, H, W) bool masks partitioning the lattice into 4 king-independent
    color classes: color = (y%2)*2 + (x%2). `device` None: the CUDA device."""
    y = np.arange(H)[:, None]
    x = np.arange(W)[None, :]
    color = (y % 2) * 2 + (x % 2)
    masks = np.stack([color == c for c in range(N_KING_COLORS)])
    return torch.tensor(masks, device=resolve_device(device))


def conditional_prob_up(h: torch.Tensor) -> torch.Tensor:
    """P(s_i=+1 | rest) = sigma(-2 h_i) under p ∝ exp(-E)."""
    return torch.sigmoid(-2.0 * h)


def enumerate_boltzmann(problem: DenseIsing) -> tuple[np.ndarray, np.ndarray]:
    """Exact p(s) over all 2^n states (n <= 20). Returns (states, probs).

    states: (2^n, n) in {-1,+1}; probs: (2^n,) normalized (numpy float64).
    """
    n = problem.n
    if n > 20:
        raise ValueError(f"exact enumeration is limited to 20 spins, got {n}")
    codes = np.arange(2**n, dtype=np.int64)
    bits = (codes[:, None] >> np.arange(n)[None, :]) & 1
    states = (2 * bits - 1).astype(np.float64)
    s = torch.as_tensor(states, dtype=torch.float32, device=problem.device)
    E = problem.energy(s).cpu().numpy().astype(np.float64)
    E = E - E.min()
    p = np.exp(-E)
    p /= p.sum()
    return states, p
