"""Parallel tempering (replica exchange) over the PASS async dynamics, the
port of `repro.core.tempering`.

R replicas run the same asynchronous tau-leap dynamics at different
inverse temperatures; adjacent replicas propose state swaps with the
Metropolis rule

    P(swap i<->i+1) = min(1, exp((beta_i - beta_{i+1}) (E_i - E_{i+1})))

which preserves the joint Boltzmann distribution exactly while letting hot
replicas tunnel between basins for the cold ones. On chip this is R cores
with an off-chip swap controller.

Each round is one multi-chain `sampler_api.run()` (R chains, per-chain
constant-beta schedules) on the problem's device, then the swaps. Each
nominal tau-leap step of `dt` is integrated as ceil(dt/0.1) substeps of
dt' <= 0.1 covering the same model time (the JAX package's choice: at
dt = 0.25-0.3 the tau-leap distortion skewed the cold replica's law). The
dynamics run the JAX package's default (ref) tau-leap: float couplings,
plain torch on the device; the int8 cuda backend would sample another
(quantized) problem.

The JAX package scans the rounds inside one jitted program; here each
round is a `run()` call (its own CUDA graphs on a CUDA problem) and the
swap draws come from the same generator after the round's dynamics.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import sampler_api
from repro_torch.core.ising import DenseIsing, resolve_device

# tau-leap substep ceiling: integrate each nominal dt as substeps <= this
SUBSTEP_DT_MAX = 0.1


class PTState(NamedTuple):
    """Parallel-tempering carry: per-replica states and swap stats."""
    s: torch.Tensor         # (R, n) replica states
    betas: torch.Tensor     # (R,) inverse temperatures (sorted ascending)
    energies: torch.Tensor  # (R,)
    n_swaps: torch.Tensor   # () accepted swap counter

    @classmethod
    def from_numpy(cls, s, betas, energies, n_swaps, device=None) -> "PTState":
        """A state from numpy arrays (e.g. a JAX PTState's fields through
        `np.asarray`) on `device` (None: the CUDA device)."""
        dev = resolve_device(device)
        return cls(s=torch.tensor(np.asarray(s, np.float32), device=dev),
                   betas=torch.tensor(np.asarray(betas, np.float32), device=dev),
                   energies=torch.tensor(np.asarray(energies, np.float32), device=dev),
                   n_swaps=torch.tensor(np.asarray(n_swaps, np.int32), device=dev))


def init(problem: DenseIsing, generator: torch.Generator, betas) -> PTState:
    """Initial replica states at the ladder's betas, on the problem's device."""
    dev = problem.device
    betas = torch.as_tensor(betas, dtype=torch.float32).to(dev)
    s = sampler_api.random_init(generator, (betas.shape[0], problem.n), device=dev)
    return PTState(s=s, betas=betas, energies=problem.energy(s),
                   n_swaps=torch.zeros((), dtype=torch.int32, device=dev))


def run(
    problem: DenseIsing,
    seed,
    state: PTState,
    n_rounds: int,
    steps_per_round: int = 16,
    dt: float = 0.25,
) -> tuple[PTState, torch.Tensor]:
    """Alternate (multi-chain async driver round) and (adjacent swap
    proposals, even pairs in even rounds, odd pairs in odd ones). `seed` is
    an int or a torch.Generator on the problem's device. Returns (state,
    (n_rounds,) per-round best energy)."""
    generator = sampler_api._generator(seed, problem.device)
    R = state.betas.shape[0]
    n_sub = max(1, math.ceil(dt / SUBSTEP_DT_MAX))
    kernel = sampler_api.TauLeap(dt=dt / n_sub)
    n_steps = steps_per_round * n_sub
    dev = problem.device
    idx = torch.arange(R, device=dev)
    pair = torch.arange(R - 1, device=dev)
    best = []
    st = state
    for rnd in range(n_rounds):
        # R replicas advance through the one sampling driver: per-chain
        # constant-beta schedules.
        schedule = st.betas[:, None].expand(R, n_steps)
        res = sampler_api.run(problem, kernel, generator, n_steps=n_steps, s0=st.s,
                              n_chains=R, schedule=schedule)
        s = res.s
        e = problem.energy(s)
        active = (pair % 2) == rnd % 2
        d_beta = st.betas[:-1] - st.betas[1:]
        d_e = e[:-1] - e[1:]
        accept_p = torch.clamp(torch.exp(d_beta * d_e), max=1.0)
        u = torch.rand((R - 1,), generator=generator, device=dev)
        accept = active & (u < accept_p)
        # the permutation applying the accepted adjacent swaps (the parity
        # mask keeps the pairs disjoint)
        swap_down = torch.zeros((R,), dtype=torch.bool, device=dev)
        swap_down[:-1] = accept  # slot i <- i+1
        swap_up = torch.zeros((R,), dtype=torch.bool, device=dev)
        swap_up[1:] = accept  # slot i+1 <- i
        perm = torch.where(swap_down, idx + 1, torch.where(swap_up, idx - 1, idx))
        e = e[perm]
        st = PTState(s=s[perm], betas=st.betas, energies=e,
                     n_swaps=st.n_swaps + accept.sum().to(torch.int32))
        best.append(torch.min(e))
    return st, torch.stack(best) if best else torch.zeros((0,), device=dev)
