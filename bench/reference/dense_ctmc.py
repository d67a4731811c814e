"""Plain PyTorch reference of a dense Ising problem under the exact CTMC.

Written from the model's definition, not from the program: Glauber's
continuous-time single-spin-flip dynamic (J. Math. Phys. 4:294, 1963), in
which spin i flips at rate lambda_i = lambda0 sigma(2 beta h_i s_i), with
h_i = sum_j J_ij s_j + b_i, simulated event by event as Gillespie's SSA
(J. Phys. Chem. 81:2340, 1977): the chain waits an Exp(1) draw over the
total rate, then flips site i with probability lambda_i / total. The site
comes from a float32 sum tree over the rates, padded with zeros to the next
power of two m: each level the pairwise sums of the one below, the root the
total, and an inverse-CDF descent from target = u * total that goes right
wherever the target reaches the left child's sum, less that sum. A chain
whose total is at most 1e-30 is frozen: it waits expo / 1e-30 and flips
nothing. The fields are kept incrementally, h += J[i] (s_i' - s_i), from
h = s J^T + b at the start, each step's floats rounded in the order these
equations give them.

Nothing here imports the program. The instance is `dense.py`'s SK law. The
random numbers come from a `torch.Generator` that the benchmark seeds as it
seeds the program's run, drawn in the order the model consumes them: the
initial spins (u < 0.5 is +1), then per event one Exp(1) a chain and one
uniform a chain. The control is the precision below the configuration's:
the rates, the tree and the descent in bfloat16, and the energies as
`dense.energy_low`.
"""
from __future__ import annotations

from pathlib import Path

import torch

from bench.common import load_module

_dense = load_module("reference", "dense", Path(__file__).resolve().parents[1])

KIND = "dense"  # the program's problem kind an instance of this reference makes
RATE_FLOOR = 1e-30  # a total rate at or below this freezes the chain
instance = _dense.instance


def levels(rates: torch.Tensor) -> list[torch.Tensor]:
    """The sum tree of (chains, n) rates, leaves first: the rates padded with
    zeros to a power of two, then each level's pairwise sums, up to the
    (chains, 1) root."""
    n = rates.shape[1]
    m = 1 << (n - 1).bit_length()
    out = [torch.cat([rates, rates.new_zeros((rates.shape[0], m - n))], 1)]
    while out[-1].shape[1] > 1:
        out.append(out[-1][:, 0::2] + out[-1][:, 1::2])
    return out


def descend(tree: list[torch.Tensor], u: torch.Tensor) -> torch.Tensor:
    """The leaf of each chain at target = u * total, walking down from the
    root: right where the target reaches the left child's sum, which it
    then loses."""
    target = u.to(tree[-1].dtype) * tree[-1][:, 0]
    idx = torch.zeros(u.shape, dtype=torch.int64, device=u.device)
    for level in reversed(tree[:-1]):
        left = level.gather(1, (2 * idx)[:, None])[:, 0]
        right = target >= left
        target = torch.where(right, target - left, target)
        idx = 2 * idx + right
    return idx


class Model:
    """The exact CTMC on one instance, the tree draw (the control: its rates,
    tree and descent in bfloat16, and its energies in bfloat16)."""

    def __init__(self, config: dict, inst: dict, kernel: dict, control: bool = False):
        if kernel["name"] != "ctmc" or kernel.get("site_draw", "auto") == "scan":
            raise ValueError(f"no dense CTMC reference of kernel {kernel}: it draws from the tree")
        self.J, self.b = inst["J"], inst["b"]
        self.lambda0 = float(kernel.get("lambda0", 1.0))
        self.tree_dtype = torch.bfloat16 if control else torch.float32
        self.energy = _dense.energy_low if control else _dense.energy64

    def init(self, gen: torch.Generator, chains: int) -> torch.Tensor:
        return _dense.init_spins(gen, chains, self.J.shape[0])

    def fields(self, s: torch.Tensor) -> torch.Tensor:
        """h = s J^T + b, (chains, n) float32."""
        return s @ self.J.T + self.b

    def draws(self, gen: torch.Generator, chains: int) -> tuple[torch.Tensor, torch.Tensor]:
        """An event's random numbers: one Exp(1) a chain, then one uniform a
        chain."""
        expo = torch.empty((chains,), device=gen.device).exponential_(generator=gen)
        return expo, torch.rand((chains,), generator=gen, device=gen.device)

    def event(self, s, h, beta, expo, u):
        """One event of every chain at its beta (chains,), given its draws: the
        new s and h and the dwell time."""
        chains, n = s.shape
        rates = self.lambda0 * torch.sigmoid((2.0 * (beta[:, None] * h)) * s)
        tree = levels(rates.to(self.tree_dtype))
        total = tree[-1][:, 0].float()
        i = descend(tree, u).clamp(max=n - 1)
        dt = expo / total.clamp(min=RATE_FLOOR)
        rows = torch.arange(chains, device=s.device)
        delta = torch.where(total > RATE_FLOOR, -2.0 * s[rows, i], 0.0)
        h = h + self.J[i] * delta[:, None]
        s = s.clone()
        s[rows, i] = s[rows, i] + delta
        return s, h, dt

    def energies(self, s: torch.Tensor) -> torch.Tensor:
        return self.energy(s, self.J, self.b)
