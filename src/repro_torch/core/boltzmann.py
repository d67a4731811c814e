"""Multiplier-free generative Boltzmann-machine training (paper Fig. 4), the
port of `repro.core.boltzmann`.

The chip trains a fully-visible Boltzmann machine on its 16x16 king's-move
core: weights live only on lattice edges, data is a batch of ±1 images, and
the contrastive-divergence update (Eq. 3) is

    dw_ij = alpha * ( E[s_i s_j]_data - E[s_i s_j]_model )
    db_i  = alpha * ( E[s_i]_data    - E[s_i]_model )

All quantities are products of ±1 values and batch averages — on the chip:
AND gates + popcount + shift (no multipliers); here the same arithmetic is
written as sign-agreement counts.

Model expectations come from the persistent chains advanced by one
multi-chain `sampler_api.run()` per CD step: 'pass' (tau-leap, the chip's
async model; lattice tau-leap has no kernel, so it runs plain torch on the
problem's device) or 'chromatic' (exact chromatic Gibbs; on a CUDA problem
every sweep is one launch of the lattice plan kernel, over the plan `run()`
builds once). The CUDA backend is chosen only where it computes what the
JAX package's default backend computes.

NOTE the sign: with E = +sum J s s, LOWERING the energy of data states means
moving J OPPOSITE the data correlation, hence dJ = -alpha * (corr_data -
corr_model).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import sampler_api
from repro_torch.core.ising import (KING_OFFSETS, LatticeIsing, quantize_lattice, resolve_device,
                                    shift2d)
from repro_torch.core.sampler_api import random_init


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the leading (batch) axis as XLA computes `jnp.mean`:
    the sum times f32(1/B), not the sum divided by B (the two round apart,
    e.g. -46/48)."""
    return torch.sum(x, dim=0) * (1.0 / x.shape[0])


def pair_correlations(batch: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(8, H, W) E[s(y,x) * s((y,x)+o_k)] over the batch, multiplier-free.

    s_i * s_j for ±1 spins == 1 - 2*XOR(bit_i, bit_j); the mean over the
    batch is therefore 1 - 2*mean(xor) — AND/popcount arithmetic only. The
    sums are exact integers and the mean is `batch_mean`, so the result
    equals the JAX package's bit for bit."""
    bits = batch > 0
    ones = torch.ones((H, W), device=batch.device)
    corr = []
    for dy, dx in KING_OFFSETS:
        shifted_bits = shift2d(batch, dy, dx) > 0
        valid = shift2d(ones, dy, dx) > 0.5  # neighbor inside the lattice
        xor = torch.logical_xor(bits, shifted_bits)
        c = 1.0 - 2.0 * batch_mean(xor.to(torch.float32))
        corr.append(torch.where(valid, c, 0.0))
    return torch.stack(corr)


@dataclasses.dataclass
class CDConfig:
    """Contrastive-divergence training hyperparameters."""
    lr: float = 0.05
    n_model_steps: int = 64      # sampler steps per CD iteration
    dt: float = 0.25             # tau-leap dt (units of 1/lambda0)
    sampler: str = "pass"        # 'pass' (tau-leap async) | 'chromatic'
    quantize_bits: Optional[int] = 8   # chip programs int8 weights
    weight_clip: float = 2.0     # keep weights in the DAC's representable range
    n_chains: int = 32           # persistent chains for the model expectation


def _free_lattice(w: torch.Tensor, b: torch.Tensor) -> LatticeIsing:
    """An unclamped lattice with these weight planes and biases."""
    H, W = b.shape
    dev = b.device
    return LatticeIsing(
        w=w, b=b,
        clamp_mask=torch.zeros((H, W), dtype=torch.bool, device=dev),
        clamp_value=-torch.ones((H, W), dtype=torch.float32, device=dev),
        dead_mask=torch.zeros((H, W), dtype=torch.bool, device=dev),
    )


@dataclasses.dataclass
class CDState:
    """Carry for the CD training loop (params + persistent chains)."""
    problem: LatticeIsing
    chains: torch.Tensor  # (n_chains, H, W) persistent model chains
    step: int

    @classmethod
    def from_numpy(cls, w, b, chains, step: int = 0, device=None) -> "CDState":
        """A state from numpy arrays (e.g. a JAX CD state's `np.asarray`
        of problem.w, problem.b and chains) on `device` (None: CUDA)."""
        dev = resolve_device(device)
        problem = _free_lattice(torch.tensor(np.asarray(w, np.float32), device=dev),
                                torch.tensor(np.asarray(b, np.float32), device=dev))
        return cls(problem=problem,
                   chains=torch.tensor(np.asarray(chains, np.float32), device=dev), step=step)


def init_cd(generator: torch.Generator, H: int = 16, W: int = 16, cfg: CDConfig = CDConfig(),
            device=None) -> CDState:
    """The initial CD state: zero weights and biases, random chains drawn
    from `generator` on `device` (None: the CUDA device)."""
    dev = resolve_device(device)
    problem = _free_lattice(torch.zeros((8, H, W), dtype=torch.float32, device=dev),
                            torch.zeros((H, W), dtype=torch.float32, device=dev))
    chains = random_init(generator, (cfg.n_chains, H, W), device=dev)
    return CDState(problem=problem, chains=chains, step=0)


def _model_samples(problem: LatticeIsing, chains: torch.Tensor, generator, cfg: CDConfig):
    """Model expectations: the persistent chains advance through the one
    multi-chain sampling driver ('pass' = tau-leap async, the chip model;
    'chromatic' through the lattice plan kernel on a CUDA problem)."""
    if cfg.sampler == "pass":
        kernel = sampler_api.TauLeap(dt=cfg.dt)
    else:
        kernel = sampler_api.ChromaticGibbs()
    res = sampler_api.run(
        problem, kernel, generator, n_steps=cfg.n_model_steps, s0=chains,
        n_chains=chains.shape[0], backend="auto",
    )
    return res.s


def cd_step(state: CDState, batch: torch.Tensor, generator, cfg: CDConfig) -> CDState:
    """One contrastive-divergence update on a (B, H, W) ±1 batch; the model
    phase draws from `generator`, a torch.Generator on the problem's
    device. Its phases are spans (`repro_torch.tracing`): `boltzmann.cd_step`
    around `boltzmann.model`, `.correlations`, `.update` and `.quantize`."""
    with tracing.span("boltzmann.cd_step"):
        H, W = state.problem.shape
        with tracing.span("boltzmann.model"):
            model_s = _model_samples(state.problem, state.chains, generator, cfg)

        with tracing.span("boltzmann.correlations"):
            corr_data = pair_correlations(batch, H, W)
            corr_model = pair_correlations(model_s, H, W)
            mean_data = batch_mean(batch)
            mean_model = batch_mean(model_s)

        with tracing.span("boltzmann.update"):
            # E = +J s s convention => descend: J moves against the data correlation.
            new_w = state.problem.w - cfg.lr * (corr_data - corr_model)
            new_b = state.problem.b - cfg.lr * (mean_data - mean_model)
            new_w = torch.clamp(new_w, -cfg.weight_clip, cfg.weight_clip)
            new_b = torch.clamp(new_b, -cfg.weight_clip, cfg.weight_clip)
            problem = dataclasses.replace(state.problem, w=new_w, b=new_b)

        if cfg.quantize_bits:
            with tracing.span("boltzmann.quantize"):
                problem = quantize_lattice(problem, cfg.quantize_bits)
        return CDState(problem=problem, chains=model_s, step=state.step + 1)


def reconstruct(
    problem: LatticeIsing,
    generator: torch.Generator,
    partial_image: torch.Tensor,
    known_mask: torch.Tensor,
    n_steps: int = 256,
    dt: float = 0.25,
) -> torch.Tensor:
    """Clamp `known_mask` pixels to `partial_image`, sample the rest (Fig 4C).
    `generator` lives on the problem's device and draws the initial state
    and the run."""
    clamped = dataclasses.replace(
        problem,
        clamp_mask=known_mask.to(torch.bool),
        clamp_value=partial_image.to(problem.b.dtype),
    )
    s0 = random_init(generator, tuple(problem.b.shape), device=problem.device)
    res = sampler_api.run(clamped, sampler_api.TauLeap(dt=dt), generator, n_steps=n_steps, s0=s0)
    return res.s


def free_energy_proxy(problem: LatticeIsing, batch: torch.Tensor) -> torch.Tensor:
    """Mean energy of the data under the model — a training progress proxy."""
    return torch.mean(problem.energy(batch))
