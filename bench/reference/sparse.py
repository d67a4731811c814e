"""Plain PyTorch reference of an Ising problem on a sparse graph under
colour-parallel (chromatic) Gibbs.

Written from the model's definition, not from the program. The graph is a
table of neighbour slots: row i lists its neighbours in ascending order,
with their couplings; a row shorter than the widest is padded with the
site's own index and weight 0. h_i = sum_k w[i, k] * s[idx[i, k]], added
to a zero accumulator slot by slot from k = 0, then b_i.
E(s) = 0.5 * sum s * (h - b) + b.s counts each edge once.

The colouring is first-fit greedy in site order: site i takes the least
colour none of its lower-numbered neighbours has. Same-colour sites share
no edge, so a sweep resamples colour c = 0, 1, ... in turn, each phase's
fields taken from the state before it: P(+1) = sigma(-2 (beta h)) against
that colour's plane of one (C, chains, n) uniform draw a sweep. Spins
start from one (chains, n) draw, u < 0.5 being +1. The model time is 1 a
sweep.

Instances (`instance`, by the configuration's `graph`):
  random_3regular_maxcut  unit-weight MaxCut on a random 3-regular graph of
    n sites: a random Hamiltonian cycle (a random order of the sites, each
    joined to the next, the last to the first) plus a random perfect
    matching (a random order cut into pairs) drawn again until none of its
    pairs is a cycle edge; J = +1 on every edge, b = 0.

The control (`low=True`) forms the fields and probabilities, and the
energies, in bfloat16. Nothing here imports the program.
"""
from __future__ import annotations

import torch

KIND = "sparse"  # the program's problem kind an instance of this reference makes


def tables(n: int, i: torch.Tensor, j: torch.Tensor, w: torch.Tensor) -> dict:
    """`nbr_idx` (n, D) int32, `nbr_w` (n, D) f32, `deg` (n,) int32 and
    `b` (n,) zeros of the undirected edges (i[e], j[e], w[e]), each given
    once: every row's slots in ascending neighbour order, padded with the
    site's own index and weight 0, plus the greedy colouring's masks."""
    device = i.device
    src, dst, ww = torch.cat([i, j]), torch.cat([j, i]), torch.cat([w, w]).to(torch.float32)
    order = torch.argsort(src.to(torch.int64) * n + dst.to(torch.int64))
    src, dst, ww = src[order].to(torch.int64), dst[order].to(torch.int64), ww[order]
    deg = torch.bincount(src, minlength=n)
    start = torch.cumsum(deg, 0) - deg
    slot = torch.arange(src.numel(), device=device) - start[src]
    D = max(1, int(deg.max()))
    idx = torch.arange(n, device=device)[:, None].repeat(1, D)
    idx[src, slot] = dst
    nbr_w = torch.zeros((n, D), dtype=torch.float32, device=device)
    nbr_w[src, slot] = ww
    inst = {"nbr_idx": idx.to(torch.int32), "nbr_w": nbr_w, "deg": deg.to(torch.int32),
            "b": torch.zeros((n,), dtype=torch.float32, device=device)}
    inst["color_masks"] = colour_masks(inst["nbr_idx"], inst["deg"])
    return inst


def colour_masks(nbr_idx: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """(C, n) bool: the classes of the first-fit greedy colouring in site
    order (on the host, once an instance)."""
    rows, degs = nbr_idx.cpu().tolist(), deg.cpu().tolist()
    col = [-1] * len(rows)
    for i, (row, d) in enumerate(zip(rows, degs)):
        used = {col[j] for j in row[:d]}
        c = 0
        while c in used:
            c += 1
        col[i] = c
    col = torch.tensor(col, device=nbr_idx.device)
    return torch.stack([col == c for c in range(int(col.max()) + 1)])


def random_3regular(n: int, gen: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """(i, j) of the 1.5 n edges of a random Hamiltonian cycle plus a random
    perfect matching disjoint from it, drawn on the generator's device."""
    if n < 4 or n % 2:
        raise ValueError(f"a 3-regular graph of this law needs an even n >= 4, got {n}")
    device = gen.device
    order = torch.randperm(n, generator=gen, device=device)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(n, device=device)
    for _ in range(1000):
        perm = torch.randperm(n, generator=gen, device=device)
        a, b = perm[0::2], perm[1::2]
        gap = (pos[a] - pos[b]).remainder(n)
        if not bool(((gap == 1) | (gap == n - 1)).any()):
            break
    else:
        raise RuntimeError("no matching disjoint from the cycle in 1000 draws")
    return torch.cat([order, a]), torch.cat([order.roll(-1), b])


def instance(config: dict, spec, seed: int, device) -> dict:
    """The configuration's graph from `seed`, drawn on `device`."""
    if config["graph"] != "random_3regular_maxcut":
        raise ValueError(f"unknown sparse graph {config['graph']!r}")
    n = config["n"]
    gen = torch.Generator(device=device).manual_seed(seed)
    i, j = random_3regular(n, gen)
    return tables(n, i, j, torch.ones(i.shape, device=device))


def gather_sum(s: torch.Tensor, nbr_idx: torch.Tensor, nbr_w: torch.Tensor) -> torch.Tensor:
    """sum_k nbr_w[i, k] * s[..., nbr_idx[i, k]], added slot by slot from zero."""
    idx = nbr_idx.to(torch.int64)
    s = s.to(nbr_w.dtype)
    acc = torch.zeros_like(s)
    for k in range(idx.shape[1]):
        acc = acc + nbr_w[:, k] * s.index_select(-1, idx[:, k])
    return acc


def init_spins(gen: torch.Generator, chains: int, n: int) -> torch.Tensor:
    """Uniform random +-1 starting states, (chains, n) f32."""
    u = torch.rand((chains, n), generator=gen, device=gen.device)
    return torch.where(u < 0.5, 1.0, -1.0).to(torch.float32)


def colour_sweep(s, nbr_idx, nbr_w, b, u, beta, masks, low: bool = False) -> torch.Tensor:
    """One sweep of every chain at its own beta (B,), uniforms (C, B, n)."""
    ft = torch.bfloat16 if low else torch.float32
    wl, bl = nbr_w.to(ft), b.to(ft)
    bt = beta.to(ft)[:, None]
    for c in range(masks.shape[0]):
        h = gather_sum(s.to(ft), nbr_idx, wl) + bl
        p_up = torch.sigmoid(-2.0 * (bt * h))
        proposal = torch.where(u[c] < p_up.float(), 1.0, -1.0)
        s = torch.where(masks[c], proposal, s)
    return s


def energy64(s: torch.Tensor, inst: dict) -> torch.Tensor:
    """E(s) in float64 for states (..., n)."""
    s64 = s.to(torch.float64)
    pair = 0.5 * torch.sum(s64 * gather_sum(s64, inst["nbr_idx"], inst["nbr_w"].to(torch.float64)),
                           dim=-1)
    return pair + s64 @ inst["b"].to(torch.float64)


def energy_low(s: torch.Tensor, inst: dict) -> torch.Tensor:
    """E(s) formed in bfloat16 (the control's energies)."""
    sl = s.to(torch.bfloat16)
    pair = 0.5 * torch.sum(sl * gather_sum(sl, inst["nbr_idx"], inst["nbr_w"].to(torch.bfloat16)),
                           dim=-1)
    return (pair + torch.sum(sl * inst["b"].to(torch.bfloat16), dim=-1)).float()


class Model:
    """Chromatic Gibbs over the instance's colour classes (the control: in
    bfloat16, its energies too)."""

    def __init__(self, config: dict, inst: dict, kernel: dict, control: bool = False):
        if kernel["name"] != "colored_gibbs":
            raise ValueError(f"no sparse reference of kernel {kernel['name']!r}")
        self.inst, self.low = inst, control
        self.t_step = 1.0  # model time a sweep at unit rate
        self.energy = energy_low if control else energy64

    def init(self, gen: torch.Generator, chains: int) -> torch.Tensor:
        return init_spins(gen, chains, self.inst["b"].shape[0])

    def step(self, s: torch.Tensor, beta: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        inst = self.inst
        masks = inst["color_masks"]
        u = torch.rand((masks.shape[0],) + tuple(s.shape), generator=gen, device=s.device)
        return colour_sweep(s, inst["nbr_idx"], inst["nbr_w"], inst["b"], u, beta, masks, self.low)

    def energies(self, s: torch.Tensor) -> torch.Tensor:
        return self.energy(s, self.inst)
