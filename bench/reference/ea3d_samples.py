"""Plain PyTorch reference of many disorder samples of the three-dimensional
+-J Edwards-Anderson spin glass (Edwards & Anderson, J. Phys. F 5:965, 1975)
in one batch, as the Janus collaboration equilibrated them at L = 32: many
independent samples of the couplings, a few real replicas of each
(Alvarez Banos et al., J. Stat. Mech. (2010) P06026, arXiv:1003.2569).

Written from the model's definition, not from the program. The lattice is
`ea3d.edges(L)`'s periodic cubic one, n = L^3 sites, its 3 n edges the +x,
then the +y, then the +z edge of every site. Sample k's couplings are row k
of one (S, 3 n) uniform draw from the seed, u < 0.5 giving J = +1 on that
edge and else -1; b = 0. The couplings go into the sparse reference's slot
layout (`sparse.tables`: each row's slots in ascending neighbour order), so
`nbr_w` is (S, n, 6) over one `nbr_idx` (n, 6), with the first-fit greedy
colouring (the two parity classes at even L).

A batch of B chains holds the samples sample-major: chain r runs on sample
r // (B / S). The dynamics are the sparse reference's heat bath, each
colour phase's fields from the state before it, h_i = sum_k w_r[i, k]
s[idx[i, k]] slot by slot from zero with w_r chain r's sample's couplings,
P(+1) = sigma(-2 (beta h)) against that colour's plane of one (C, B, n)
uniform draw a sweep; spins start from one (B, n) draw, u < 0.5 being +1.
The control (`control=True`) forms the fields, probabilities and energies in
bfloat16; the energies are otherwise float64. Nothing here imports the
program.
"""
from __future__ import annotations

import functools

import torch

from bench.common import load_module

sparse = load_module("reference", "sparse")
ea3d = load_module("reference", "ea3d")
KIND = "sparse"


def instance(config: dict, spec, seed: int, device) -> dict:
    """The lattice's tables and colouring with S = config["samples"] samples'
    +-1 couplings from `seed`, drawn on `device`: fresh copies of the run's
    one build (the host's greedy colouring, and a run asks for the instance
    once for the program and once a replayed job)."""
    return {k: v.clone() for k, v in _build(config["L"], config["samples"], seed,
                                            str(device)).items()}


@functools.lru_cache(maxsize=1)
def _build(L: int, S: int, seed: int, device: str) -> dict:
    i, j = ea3d.edges(L, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    J = torch.where(torch.rand((S, i.numel()), generator=gen, device=device) < 0.5, 1.0, -1.0)
    # the tables of edge numbers 1 .. 3n: each slot's edge, 0 on a pad
    inst = sparse.tables(L**3, i, j, torch.arange(1, i.numel() + 1, device=device))
    edge = inst["nbr_w"].long() - 1
    inst["nbr_w"] = torch.where(edge >= 0, J[:, edge.clamp(min=0)], 0.0).contiguous()
    return inst


def row_couplings(nbr_w: torch.Tensor, chains: int) -> torch.Tensor:
    """(chains, n, D): each chain's sample's couplings, chain r of sample
    r // (chains / S)."""
    S = nbr_w.shape[0]
    if chains % S:
        raise ValueError(f"{chains} chains are no whole number of replicas of {S} samples")
    return nbr_w.repeat_interleave(chains // S, 0)


def gather_rows(s: torch.Tensor, nbr_idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_k w[r, i, k] * s[r, ..., idx[i, k]], slot by slot from zero, for
    states (B, ..., n) and per-chain couplings w (B, n, D)."""
    idx = nbr_idx.to(torch.int64)
    w = w.reshape((w.shape[0],) + (1,) * (s.ndim - 2) + tuple(w.shape[1:]))
    s = s.to(w.dtype)
    acc = torch.zeros_like(s)
    for k in range(idx.shape[1]):
        acc = acc + w[..., k] * s.index_select(-1, idx[:, k])
    return acc


class Model:
    """Chromatic Gibbs of B chains over S samples' couplings (the control:
    in bfloat16, its energies too)."""

    def __init__(self, config: dict, inst: dict, kernel: dict, control: bool = False):
        if kernel["name"] != "colored_gibbs":
            raise ValueError(f"no disorder-sample reference of kernel {kernel['name']!r}")
        self.inst, self.low = inst, control
        self.t_step = 1.0  # model time a sweep at unit rate

    def init(self, gen: torch.Generator, chains: int) -> torch.Tensor:
        return sparse.init_spins(gen, chains, self.inst["b"].shape[0])

    def step(self, s: torch.Tensor, beta: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        inst = self.inst
        masks = inst["color_masks"]
        u = torch.rand((masks.shape[0],) + tuple(s.shape), generator=gen, device=s.device)
        ft = torch.bfloat16 if self.low else torch.float32
        w = row_couplings(inst["nbr_w"], s.shape[0]).to(ft)
        bl, bt = inst["b"].to(ft), beta.to(ft)[:, None]
        for c in range(masks.shape[0]):
            h = gather_rows(s.to(ft), inst["nbr_idx"], w) + bl
            p_up = torch.sigmoid(-2.0 * (bt * h))
            s = torch.where(masks[c], torch.where(u[c] < p_up.float(), 1.0, -1.0), s)
        return s

    def energies(self, s: torch.Tensor) -> torch.Tensor:
        """E of states (B, ..., n), chain r's under its sample's couplings:
        in float64, or in bfloat16 (the control)."""
        ft = torch.bfloat16 if self.low else torch.float64
        w = row_couplings(self.inst["nbr_w"], s.shape[0]).to(ft)
        st = s.to(ft)
        pair = 0.5 * torch.sum(st * gather_rows(st, self.inst["nbr_idx"], w), dim=-1)
        e = pair + torch.sum(st * self.inst["b"].to(ft), dim=-1)
        return e.float() if self.low else e
