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

This module holds the dense problem class; the lattice classes follow with
the lattice slice of the port (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `None` means the CUDA device.

    With no CUDA device present, `None` raises instead of landing on the
    CPU; CPU callers (the tests) pass `device="cpu"` explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


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
