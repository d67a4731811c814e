"""Plain PyTorch reference of PASS's king's-move lattice (the 16x16 core).

Written from the model's definition, not from the program. Each site (y, x)
couples to its eight king's-move neighbours through weight planes w[k],
offsets in the fixed order OFFSETS; h = sum_k w[k] * s(+offset_k) + b,
zero beyond the edge, the planes added to a zero accumulator in that order
and b last. E(s) = 0.5 * sum s * (h - b) + b.s counts each pair once.

Dynamics:
  chromatic Gibbs — the four king colours (y % 2) * 2 + (x % 2) are
    independent sets; a sweep resamples colour c = 0..3 in turn from
    P(+1) = sigma(-2 (beta h)) against that colour's uniforms, every
    colour's fields taken from the state before its phase; uniforms
    (4, chains, H, W) a sweep.
  tau-leap — every site flips with probability 1 - exp(-dt sigma(2 h s))
    against a (chains, H, W) uniform plane a step.
  contrastive divergence (Fig. 4) — the model chains advance by tau-leap;
    dw = -lr (E[s s']_data - E[s s']_model) per king offset (pairs beyond
    the edge 0), db = -lr (E[s]_data - E[s]_model), both clipped, then
    both put on the signed `bits`-bit grid of scale max(|w|, |b|).
    Batch means are sums times f32(1/B), as the chip's popcount and shift
    give them.

The control (`low=True`) forms the fields and probabilities in bfloat16.
Nothing here imports the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

KIND = "king"  # the program's problem kind an instance of this reference makes
OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def shift(s: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = s[..., y + dy, x + dx], zero beyond the edge."""
    H, W = s.shape[-2], s.shape[-1]
    p = F.pad(s, (1, 1, 1, 1))
    return p[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]


def neighbour_sum(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_k w[k] * s(+offset_k), added in offset order from zero."""
    s = s.to(w.dtype)
    acc = torch.zeros_like(s)
    for k, (dy, dx) in enumerate(OFFSETS):
        acc = acc + w[k] * shift(s, dy, dx)
    return acc


def colour_masks(H: int, W: int, device) -> torch.Tensor:
    """(4, H, W) bool: the king colouring (y % 2) * 2 + (x % 2)."""
    y = torch.arange(H, device=device)[:, None]
    x = torch.arange(W, device=device)[None, :]
    colour = (y % 2) * 2 + (x % 2)
    return torch.stack([colour == c for c in range(4)])


def template_lattice(rows, coupling: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(w, b) whose two ground states are +-template: neighbours of equal
    template value couple by -coupling, of opposite value by +coupling.
    `rows` are strings of '0' (-1) and '1' (+1)."""
    t = torch.tensor([[1.0 if c == "1" else -1.0 for c in r] for r in rows], device=device)
    H, W = t.shape
    w = torch.zeros((8, H, W), device=device)
    for k, (dy, dx) in enumerate(OFFSETS):
        other = shift(t, dy, dx)
        inside = shift(torch.ones_like(t), dy, dx) > 0.5
        w[k] = torch.where(inside, torch.where(other == t, -coupling, coupling), 0.0)
    return w, torch.zeros((H, W), device=device)


def init_spins(gen: torch.Generator, chains: int, H: int, W: int) -> torch.Tensor:
    """Uniform random +-1 starting states, (chains, H, W) f32."""
    u = torch.rand((chains, H, W), generator=gen, device=gen.device)
    return torch.where(u < 0.5, 1.0, -1.0).to(torch.float32)


def chromatic_sweep(s, w, b, u, beta, masks, low: bool = False) -> torch.Tensor:
    """One sweep of every chain at its own beta (B,), uniforms (4, B, H, W)."""
    ft = torch.bfloat16 if low else torch.float32
    wl, bl = w.to(ft), b.to(ft)
    bt = beta.to(ft)[:, None, None]
    for c in range(masks.shape[0]):
        h = neighbour_sum(s.to(ft), wl) + bl
        p_up = torch.sigmoid(-2.0 * (bt * h))
        proposal = torch.where(u[c] < p_up.float(), 1.0, -1.0)
        s = torch.where(masks[c], proposal, s)
    return s


def tau_leap_step(s, w, b, u, dt: float, low: bool = False) -> torch.Tensor:
    """One tau-leap step at beta 1 of every chain."""
    ft = torch.bfloat16 if low else torch.float32
    sl = s.to(ft)
    h = neighbour_sum(sl, w.to(ft)) + b.to(ft)
    rate = torch.sigmoid(2.0 * h * sl)
    p = 1.0 - torch.exp(-dt * rate)
    return torch.where(u < p.float(), -s, s)


def energy64(s: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """E(s) in float64 for states (..., H, W)."""
    s64 = s.to(torch.float64)
    pair = 0.5 * torch.sum(s64 * neighbour_sum(s64, w.to(torch.float64)), dim=(-2, -1))
    return pair + torch.sum(b.to(torch.float64) * s64, dim=(-2, -1))


def energy_low(s: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """E(s) formed in bfloat16 (the control's energies)."""
    sl = s.to(torch.bfloat16)
    pair = 0.5 * torch.sum(sl * neighbour_sum(sl, w.to(torch.bfloat16)), dim=(-2, -1))
    return (pair + torch.sum(b.to(torch.bfloat16) * sl, dim=(-2, -1))).float()


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the leading axis as a sum times f32(1/B)."""
    return torch.sum(x, dim=0) * (1.0 / x.shape[0])


def correlations(batch: torch.Tensor) -> torch.Tensor:
    """(8, H, W) E[s(y,x) s((y,x)+offset_k)] over the batch, 0 beyond the
    edge: 1 - 2 * mean(sign disagreement), exact for +-1 spins."""
    bits = batch > 0
    ones = torch.ones(batch.shape[-2:], device=batch.device)
    out = []
    for dy, dx in OFFSETS:
        differ = torch.logical_xor(bits, shift(batch, dy, dx) > 0)
        c = 1.0 - 2.0 * batch_mean(differ.to(torch.float32))
        out.append(torch.where(shift(ones, dy, dx) > 0.5, c, 0.0))
    return torch.stack(out)


def quantize(w: torch.Tensor, b: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """w and b on the signed `bits`-bit grid of scale max(|w|, |b|), kept as
    f32 values on the grid (round half to even)."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.maximum(torch.max(torch.abs(w)), torch.max(torch.abs(b)))
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return (torch.round(w / scale * qmax) * (scale / qmax),
            torch.round(b / scale * qmax) * (scale / qmax))


def cd_step(w, b, chains, data, gen, *, lr, steps, dt, clip, bits, low: bool = False):
    """One contrastive-divergence update: the model chains advance `steps`
    tau-leap steps (uniforms from `gen`), then the weights move. Returns
    (w, b, chains). The control (`low`) runs the chains in bfloat16 and
    puts the weights on a grid of bits - 4."""
    s = chains
    for _ in range(steps):
        u = torch.rand(s.shape, generator=gen, device=s.device)
        s = tau_leap_step(s, w, b, u, dt, low)
    new_w = w - lr * (correlations(data) - correlations(s))
    new_b = b - lr * (batch_mean(data) - batch_mean(s))
    new_w = torch.clamp(new_w, -clip, clip)
    new_b = torch.clamp(new_b, -clip, clip)
    new_w, new_b = quantize(new_w, new_b, bits - 4 if low else bits)
    return new_w, new_b, s


def instance(config: dict, spec: dict, seed: int, device) -> dict:
    """The couplings a traffic mix gives the lattice: a template's
    (`template_rows`, `coupling`), or none (all zero) without a spec."""
    H, W = config["H"], config["W"]
    if not spec:
        return {"w": torch.zeros((8, H, W), device=device), "b": torch.zeros((H, W), device=device)}
    rows = spec["template_rows"]
    if len(rows) != H or any(len(r) != W for r in rows):
        raise ValueError(f"template is not {H}x{W}")
    w, b = template_lattice(rows, spec["coupling"], device)
    return {"w": w, "b": b}


class Model:
    """The dynamics a traffic mix names on one lattice: chromatic Gibbs or
    tau-leap (the control: in bfloat16, its energies too)."""

    def __init__(self, config: dict, inst: dict, kernel: dict, control: bool = False):
        if kernel["name"] not in ("chromatic_gibbs", "tau_leap"):
            raise ValueError(f"no lattice reference of kernel {kernel['name']!r}")
        self.w, self.b = inst["w"], inst["b"]
        self.kernel, self.low = kernel, control
        self.masks = colour_masks(config["H"], config["W"], self.w.device)
        # model time a step at unit rate: dt, or one a sweep
        self.t_step = kernel["dt"] if kernel["name"] == "tau_leap" else 1.0
        self.energy = energy_low if control else energy64

    def init(self, gen: torch.Generator, chains: int) -> torch.Tensor:
        return init_spins(gen, chains, *self.b.shape)

    def step(self, s: torch.Tensor, beta: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        if self.kernel["name"] == "tau_leap":
            if not bool((beta == 1.0).all()):
                raise ValueError("the lattice tau-leap reference runs at beta 1")
            u = torch.rand(s.shape, generator=gen, device=s.device)
            return tau_leap_step(s, self.w, self.b, u, self.kernel["dt"], self.low)
        u = torch.rand((self.masks.shape[0],) + tuple(s.shape), generator=gen, device=s.device)
        return chromatic_sweep(s, self.w, self.b, u, beta, self.masks, self.low)

    def energies(self, s: torch.Tensor) -> torch.Tensor:
        return self.energy(s, self.w, self.b)


def digit_batch(spec: dict, seed: int, device) -> torch.Tensor:
    """(count, H, W) +-1 noisy copies of one digit drawn from seven
    segments (`segments`: name -> [row0, row1, col0, col1]), each pixel
    flipped with probability `flip`, drawn on `device` from `seed`."""
    H, W = spec["H"], spec["W"]
    t = -torch.ones((H, W), device=device)
    for name in spec["digits"][str(spec["digit"])]:
        r0, r1, c0, c1 = spec["segments"][name]
        t[r0:r1, c0:c1] = 1.0
    gen = torch.Generator(device=device).manual_seed(seed)
    flips = torch.rand((spec["count"], H, W), generator=gen, device=device) < spec["flip"]
    return torch.where(flips, -t, t)
