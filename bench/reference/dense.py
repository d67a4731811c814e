"""Plain PyTorch reference of a dense Ising problem under tau-leap dynamics.

Written from the model's definition, not from the program: E(s) = sum_{i<j}
J_ij s_i s_j + b.s, the local field h_i = sum_j J_ij s_j + b_i, and one
tau-leap step flips spin i with probability 1 - exp(-dt sigma(2 beta h_i
s_i)) against a uniform u_i. The couplings reach the field product as the
chip's DACs hold them: integer codes round(J / scale), scale = max|J| /
qmax, with qmax = 127 for the 8-bit weights a configuration states (7 in
the 4-bit control). The integer products are exact in float64; the
field and the flip probability are formed in float32 in the order the
model's equations give them: f32(acc) * f32(beta * scale) + f32(beta * b),
x = (2 h) s, sigma(x), 1 - exp(-dt * rate).

Nothing here imports the program. The uniforms come from a
`torch.Generator` that the benchmark seeds as it seeds the program's run,
drawn in the order the model consumes them: the initial spins (u < 0.5 is
+1), then one (chains, n) plane a step.
"""
from __future__ import annotations

import torch

KIND = "dense"  # the program's problem kind an instance of this reference makes


def codes(J: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(float64 integer codes, f32 scale) of J on a signed `bits`-bit grid,
    rounded half to even; an all-zero J gets scale 1."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.max(torch.abs(J)) / qmax
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(J / scale), -qmax, qmax)
    return q.to(torch.float64), scale.to(torch.float32)


def init_spins(gen: torch.Generator, chains: int, n: int) -> torch.Tensor:
    """Uniform random +-1 starting states, (chains, n) f32."""
    u = torch.rand((chains, n), generator=gen, device=gen.device)
    return torch.where(u < 0.5, 1.0, -1.0).to(torch.float32)


def tau_leap_step(s, q, scale, b, beta, u, dt) -> torch.Tensor:
    """One tau-leap step of every chain (row) at its own beta (B,), given
    the codes q and their scale, the uniforms u and a () f32 dt."""
    acc = (s.to(torch.float64) @ q.T).to(torch.float32)
    h = acc * (beta * scale)[:, None] + beta[:, None] * b
    rate = torch.sigmoid((2.0 * h) * s)
    p = 1.0 - torch.exp(-dt * rate)
    return torch.where(u < p, -s, s)


def energy64(s: torch.Tensor, J: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """E(s) in float64 for states (..., n), each pair counted once."""
    s64, J64 = s.to(torch.float64), J.to(torch.float64)
    return 0.5 * torch.sum(s64 * (s64 @ J64.T), dim=-1) + s64 @ b.to(torch.float64)


def energy_low(s: torch.Tensor, J: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """E(s) with the product in bfloat16 (the control's energies)."""
    sl, Jl = s.to(torch.bfloat16), J.to(torch.bfloat16)
    return (0.5 * torch.sum(sl * (sl @ Jl.T), dim=-1) + sl @ b.to(torch.bfloat16)).float()


def instance(config: dict, spec, seed: int, device) -> dict:
    """The configuration's couplings from `seed`, drawn on `device` in one
    call: SK, J_ij = J_ji ~ N(0, 1/n) for i < j, zero diagonal, b = 0."""
    if config["couplings"] != "sk":
        raise ValueError(f"unknown dense couplings {config['couplings']!r}")
    n = config["n"]
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((n, n), generator=gen, device=device) / n ** 0.5
    J = torch.triu(a, diagonal=1)
    return {"J": J + J.T, "b": torch.zeros((n,), device=device)}


class Model:
    """The dynamics a traffic mix names, on one instance: tau-leap on the
    codes of the configuration's `weight_bits` (the control: 4 bits, and
    its energies in bfloat16)."""

    def __init__(self, config: dict, inst: dict, kernel: dict, control: bool = False):
        if kernel["name"] != "tau_leap":
            raise ValueError(f"no dense reference of kernel {kernel['name']!r}")
        self.J, self.b = inst["J"], inst["b"]
        self.q, self.scale = codes(self.J, 4 if control else config["weight_bits"])
        self.dt = torch.tensor(kernel["dt"], dtype=torch.float32, device=self.J.device)
        self.t_step = kernel["dt"]  # model time a step at unit rate
        self.energy = energy_low if control else energy64

    def init(self, gen: torch.Generator, chains: int) -> torch.Tensor:
        return init_spins(gen, chains, self.J.shape[0])

    def step(self, s: torch.Tensor, beta: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        u = torch.rand(s.shape, generator=gen, device=s.device)
        return tau_leap_step(s, self.q, self.scale, self.b, beta, u, self.dt)

    def energies(self, s: torch.Tensor) -> torch.Tensor:
        return self.energy(s, self.J, self.b)
