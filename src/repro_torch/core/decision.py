"""Neural decision making on the PASS sampler (paper Fig. 5, Eqs. 12-15), the
port of `repro.core.decision`.

An agent (fly) at position p navigates toward k targets. Each of N spins
carries a goal vector pointing at its assigned target. The Hamiltonian is

    H(s^t) = (-k/N) sum_{i!=j} J_ij s_i s_j + alpha_mem * sum_i s_i^{t-1} s_i^t
    J_ij   = cos(pi * (|theta_ij| / pi)^eta)

with theta_ij the angle between goal vectors i and j, and the second term the
paper's memory-bias modification (the previous state enters as a bias field
on the next run). After each sampling run the agent moves with velocity
V = v0/N * sum_i p_hat_i s_i.

DenseIsing holds the (-k/N) prefactor and the memory bias as (J, b):
J'_ij = 2*(-k/N)*J_ij (the paper's sum over i!=j counts each pair twice)
and b'_i = alpha_mem * s^{t-1}_i.

The JAX package scans one short `run()` per outer step inside one jitted
program. Here every outer step is its own `run()` on the problem's device:
on a CUDA problem each one builds and captures its CUDA graphs anew (the
couplings change every step), so a trajectory costs the host one capture
per step. The tau-leap is the JAX package's default (ref) backend.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import sampler_api
from repro_torch.core.ising import DenseIsing, resolve_device


@dataclasses.dataclass(frozen=True)
class DecisionConfig:
    """Neural decision-making task parameters (paper Fig. 4)."""
    n_neurons: int = 60
    eta: float = 1.0           # geometry-encoding exponent
    alpha_mem: float = -0.25   # memory bias (negative: E favors persistence)
    v0: float = 12.0           # speed per outer step
    n_sampler_steps: int = 48  # tau-leap steps per decision (~41us on chip)
    dt: float = 0.25
    max_steps: int = 220
    arrive_radius: float = 40.0


class Trajectory(NamedTuple):
    """Recorded decision trajectory."""
    positions: torch.Tensor  # (T+1, 2)
    spins: torch.Tensor      # (T, N)
    arrived: torch.Tensor    # ()


def couplings(pos: torch.Tensor, targets: torch.Tensor, assign: torch.Tensor, eta: float):
    """(J_ij cos-geometry, goal unit vectors) at agent position `pos`."""
    goal_vec = targets[assign] - pos[None, :]           # (N, 2)
    norm = torch.linalg.norm(goal_vec, dim=-1, keepdim=True)
    ghat = goal_vec / torch.clamp(norm, min=1e-9)
    cosang = torch.clamp(ghat @ ghat.T, -1.0, 1.0)
    theta = torch.arccos(cosang)                         # |theta_ij| in [0, pi]
    J = torch.cos(math.pi * (theta / math.pi) ** eta)
    return J, ghat


def _dense_problem(J_cos, prev_s, k: int, n: int, alpha_mem: float) -> DenseIsing:
    scale = 2.0 * (-k / n)  # paper's i!=j double count -> our i<j convention
    J = scale * J_cos
    J = J - torch.diag(torch.diag(J))
    return DenseIsing(J=J, b=alpha_mem * prev_s)


def simulate(seed, targets: np.ndarray, cfg: DecisionConfig, device=None) -> Trajectory:
    """Run one agent trajectory from the origin on `device` (None: the CUDA
    device); `seed` is an int or a torch.Generator there."""
    dev = resolve_device(device)
    generator = sampler_api._generator(seed, dev)
    targets = torch.as_tensor(np.asarray(targets, np.float32), device=dev)
    k = targets.shape[0]
    n = cfg.n_neurons
    assign = torch.arange(n, device=dev) % k  # neurons evenly assigned to targets
    pos0 = torch.zeros((2,), dtype=torch.float32, device=dev)
    pos, s_prev = pos0, torch.ones((n,), dtype=torch.float32, device=dev)  # toward consensus
    arrived = torch.zeros((), dtype=torch.bool, device=dev)
    kernel = sampler_api.TauLeap(dt=cfg.dt)
    positions, spins = [], []
    for _ in range(cfg.max_steps):
        J_cos, ghat = couplings(pos, targets, assign, cfg.eta)
        problem = _dense_problem(J_cos, s_prev, k, n, cfg.alpha_mem)
        s = sampler_api.run(problem, kernel, generator, n_steps=cfg.n_sampler_steps,
                            s0=s_prev).s
        # Velocity (Eq. 14) with the Boltzmann spin mapped to neural firing:
        # s=+1 -> the neuron votes for its goal vector, s=-1 -> it is silent.
        firing = 0.5 * (s + 1.0)
        V = cfg.v0 / n * torch.sum(ghat * firing[:, None], dim=0) * 2.0
        pos = pos + torch.where(arrived, 0.0, V)
        dist = torch.min(torch.linalg.norm(targets - pos[None, :], dim=-1))
        arrived = arrived | (dist < cfg.arrive_radius)
        s_prev = s
        positions.append(pos)
        spins.append(s)
    return Trajectory(positions=torch.stack([pos0] + positions),
                      spins=torch.stack(spins) if spins else torch.zeros((0, n), device=dev),
                      arrived=arrived)


def bifurcation_distance(traj_positions: torch.Tensor, targets, tol: float = 0.25) -> torch.Tensor:
    """Distance from origin at which the trajectory commits to one target.

    Commit point: the first step where the normalized direction to the
    nearest target dominates the second-nearest by `tol` — a simple,
    deterministic proxy for the paper's bifurcation point (step 0 when it
    never commits)."""
    targets = torch.as_tensor(np.asarray(targets, np.float32), device=traj_positions.device)
    d = torch.linalg.norm(targets[None, :, :] - traj_positions[:, None, :], dim=-1)
    sorted_d = torch.sort(d, dim=-1).values
    committed = (sorted_d[:, 1] - sorted_d[:, 0]) / (sorted_d[:, 1] + 1e-9) > tol
    idx = torch.argmax(committed.to(torch.int8))  # the first True (0 if none)
    return torch.linalg.norm(traj_positions[idx])
