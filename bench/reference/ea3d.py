"""Plain PyTorch reference of the three-dimensional +-J Edwards-Anderson spin
glass (Edwards & Anderson, J. Phys. F 5:965, 1975) under heat-bath dynamics
with a checkerboard update, as Janus ran it (Belletti et al., PRL
101:157201, 2008).

Written from the model's definition, not from the program. The lattice is
a periodic L x L x L simple cubic one of n = L^3 sites, site x + L (y + L z);
its 3 n edges join each site to its +x, +y and +z neighbour (modulo L), so
every site has 6 neighbours. Each edge carries J = +1 or -1 with equal odds,
u < 0.5 being +1 for one uniform an edge drawn from the seed in the order
+x edges, +y edges, +z edges, each by site; b = 0. The graph goes into the
sparse reference's tables (`sparse.tables`), whose first-fit greedy
colouring in site order gives, at even L, the two parity classes of
x + y + z: the checkerboard. The dynamics, the control and the energies are
the sparse reference's (`sparse.Model`): heat bath, P(+1) = sigma(-2 beta h)
a colour phase. Nothing here imports the program.
"""
from __future__ import annotations

import functools

import torch

from bench.common import load_module

sparse = load_module("reference", "sparse")
KIND = sparse.KIND
Model = sparse.Model


def edges(L: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(i, j) of the 3 L^3 edges of the periodic cubic lattice: the +x, then
    the +y, then the +z edge of every site, sites in index order."""
    if L < 3:
        raise ValueError(f"a periodic cubic lattice of distinct neighbours needs L >= 3, got {L}")
    site = torch.arange(L**3, device=device).reshape(L, L, L)  # [z, y, x]
    i = site.flatten().repeat(3)
    j = torch.cat([site.roll(-1, dim).flatten() for dim in (2, 1, 0)])
    return i, j


def instance(config: dict, spec, seed: int, device) -> dict:
    """The lattice's tables and colouring with +-1 couplings from `seed`,
    drawn on `device`: fresh copies of the run's one build (the greedy
    colouring of 512,000 sites takes seconds on the host, and a run asks for
    the instance once for the program and once a replayed job)."""
    return {k: v.clone() for k, v in _build(config["L"], seed, str(device)).items()}


@functools.lru_cache(maxsize=1)
def _build(L: int, seed: int, device: str) -> dict:
    i, j = edges(L, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.where(torch.rand(i.shape, generator=gen, device=device) < 0.5, 1.0, -1.0)
    return sparse.tables(L**3, i, j, w)
