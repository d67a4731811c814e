"""Composable device-fault models (PyTorch), the port of `repro.core.faults`.

PASS is a physical chip: its robustness claims rest on how the asynchronous
Glauber dynamic behaves under device non-idealities. `FaultModel` holds the
four effects (stuck p-bits, finite coupling precision, analog field noise,
dropped asynchronous updates) as one configuration threaded through
`sampler_api.run(..., faults=...)`. `faults=None` (and a model with every
fault off) runs the exact fault-free program: the same draws, the same
kernels, the same CUDA graphs.

The four faults and their per-kernel semantics (the JAX package's):

  stuck spins (`stuck_mask`, `stuck_values`)
      A stuck p-bit reads a constant value and never updates. On a
      `LatticeIsing` `bind()` folds the mask into the problem's clamps, so
      the lattice kernels handle it as frozen sites. On dense and sparse
      problems the kernels suppress updates at stuck sites: random scan
      keeps the old spin where its draw lands on one, the CTMC zeroes their
      rates wherever rates are computed (the carried tree's repair too),
      tau-leap freezes them (the CUDA path warps their uniform to 1.0), and
      the coloured sweep drops them from every colour class for the run.
      Initial states are forced to the stuck values.

  coupling quantization (`quantize_bits`)
      Couplings are rounded once, at `run()` entry, onto the signed b-bit
      grid scaled by max |J|; the sampler then runs the quantized problem
      exactly, its recorded energies included.

  field noise (`field_noise_std`)
      Zero-mean Gaussian noise on each site's local field, redrawn every
      step (every event of the CTMC, every sweep of the Gibbs kernels, one
      draw shared by the sweep's colour phases). It perturbs only the
      decisions: recorded and incremental energies stay those of the state.
      The sweep and tau-leap kernels take the per-row bias b + eta as an
      operand (their fault variants); the sparse CTMC under noise rebuilds
      its tree every event.

  update dropout (`dropout`)
      Each site's update is dropped independently with this probability at
      every step. A dropped Gibbs or tau-leap update keeps the old spin (the
      sweeps take a per-row keep mask); a dropped CTMC event still advances
      model time.

Every draw comes from the run's `torch.Generator`; `sampler_api` documents
their order within a step. The stuck tensors live on the problem's device
after `bind()`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.ising import DenseIsing, LatticeIsing, resolve_device
from repro_torch.core.sparse import SparseIsing


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """A composable hardware-fault configuration (see the module docstring).

    Attributes:
      stuck_mask: optional bool tensor in the problem's natural shape —
        True where the p-bit is stuck.
      stuck_values: ±1 tensor, same shape — the value each stuck site reads
        (required iff `stuck_mask` is given).
      quantize_bits: optional int >= 2 — couplings are rounded onto the
        signed b-bit fixed-point grid once at `run()` entry.
      field_noise_std: std-dev of the zero-mean Gaussian field noise
        redrawn each kernel step (0 = off).
      dropout: per-site per-step probability that an update is dropped
        (in [0, 1]; 0 = off).
    """

    stuck_mask: Optional[torch.Tensor] = None
    stuck_values: Optional[torch.Tensor] = None
    quantize_bits: Optional[int] = None
    field_noise_std: float = 0.0
    dropout: float = 0.0

    @classmethod
    def from_numpy(cls, stuck_mask=None, stuck_values=None, device=None, **config) -> "FaultModel":
        """Build from numpy arrays (e.g. a JAX model's `np.asarray(stuck_mask)`
        and `np.asarray(stuck_values)`) on `device` (None: the CUDA device);
        `config` holds the three severities."""
        if stuck_mask is None and stuck_values is None:
            return cls(**config)
        dev = resolve_device(device)
        return cls(stuck_mask=torch.tensor(np.asarray(stuck_mask), device=dev),
                   stuck_values=torch.tensor(np.asarray(stuck_values, np.float32), device=dev),
                   **config)

    @property
    def is_noop(self) -> bool:
        """True when every fault is off — `bind()` then returns residual None."""
        return (
            self.stuck_mask is None
            and self.quantize_bits is None
            and self.field_noise_std == 0.0
            and self.dropout == 0.0
        )

    @property
    def noisy(self) -> bool:
        """True when field noise is on."""
        return self.field_noise_std > 0.0

    @property
    def drops(self) -> bool:
        """True when update dropout is on."""
        return self.dropout > 0.0

    def describe(self) -> dict:
        """JSON-ready summary of the configuration (for benchmark records)."""
        out: dict = {}
        if self.stuck_mask is not None:
            out["stuck_sites"] = int(torch.as_tensor(self.stuck_mask).sum())
        if self.quantize_bits is not None:
            out["quantize_bits"] = int(self.quantize_bits)
        if self.field_noise_std:
            out["field_noise_std"] = float(self.field_noise_std)
        if self.dropout:
            out["dropout"] = float(self.dropout)
        return out

    def validate(self, problem) -> None:
        """Raise ValueError on a configuration that cannot mean anything.

        Host-side (`run()` calls it once, before the step loop): shape
        mismatch against the problem's natural spin shape, stuck values off
        the ±1 grid, a mask without values (or vice versa), out-of-range
        severities."""
        if self.quantize_bits is not None:
            if (not isinstance(self.quantize_bits, int) or isinstance(self.quantize_bits, bool)
                    or self.quantize_bits < 2):
                raise ValueError(
                    f"quantize_bits must be an int >= 2, got {self.quantize_bits!r}"
                )
        if not np.isfinite(self.field_noise_std) or self.field_noise_std < 0.0:
            raise ValueError(
                f"field_noise_std must be finite and >= 0, got {self.field_noise_std!r}"
            )
        if not 0.0 <= self.dropout <= 1.0:
            raise ValueError(f"dropout must be in [0, 1], got {self.dropout!r}")
        if (self.stuck_mask is None) != (self.stuck_values is None):
            raise ValueError(
                "stuck_mask and stuck_values must be given together "
                f"(got mask={'set' if self.stuck_mask is not None else 'None'}, "
                f"values={'set' if self.stuck_values is not None else 'None'})"
            )
        if self.stuck_mask is not None:
            shape = natural_shape(problem)
            mask, vals = torch.as_tensor(self.stuck_mask), torch.as_tensor(self.stuck_values)
            if tuple(mask.shape) != shape or tuple(vals.shape) != shape:
                raise ValueError(
                    f"stuck_mask/stuck_values shape {tuple(mask.shape)}/{tuple(vals.shape)} "
                    f"!= problem's natural shape {shape}"
                )
            if mask.dtype != torch.bool:
                raise ValueError(f"stuck_mask must be boolean, got dtype {mask.dtype}")
            at = vals.to(mask.device)[mask]
            if not bool(((at == 1.0) | (at == -1.0)).all()):
                raise ValueError("stuck_values must be ±1 at every stuck site")

    def bind(self, problem) -> tuple:
        """Apply the static faults to `problem`; return (problem, residual).

        Quantization rewrites the couplings once. On `LatticeIsing` the
        stuck mask is absorbed into the problem's clamps (`clamp_mask` /
        `clamp_value`), so the lattice kernels need no stuck handling. The
        residual `FaultModel` carries what the kernels must still apply per
        step, its stuck tensors on the problem's device; it is None when
        nothing dynamic remains (the driver then runs the exact fault-free
        program on the bound problem)."""
        prob = problem
        if self.quantize_bits is not None:
            prob = quantize_couplings(prob, self.quantize_bits)
        residual = dataclasses.replace(self, quantize_bits=None)
        if self.stuck_mask is not None:
            dev = prob.device
            mask = torch.as_tensor(self.stuck_mask, device=dev)
            vals = torch.as_tensor(self.stuck_values, device=dev)
            residual = dataclasses.replace(residual, stuck_mask=mask, stuck_values=vals)
            if isinstance(prob, LatticeIsing):
                prob = dataclasses.replace(
                    prob,
                    clamp_mask=prob.clamp_mask | mask,
                    clamp_value=torch.where(mask, vals.to(prob.clamp_value.dtype),
                                            prob.clamp_value),
                )
                residual = dataclasses.replace(residual, stuck_mask=None, stuck_values=None)
        return prob, (None if residual.is_noop else residual)

    # -- per-step helpers the kernels call ---------------------------------

    def apply_stuck(self, s: torch.Tensor) -> torch.Tensor:
        """Force stuck sites of every chain (row) of `s` to their values."""
        if self.stuck_mask is None:
            return s
        return torch.where(self.stuck_mask, self.stuck_values.to(s.dtype), s)

    def stuck_flat(self) -> Optional[torch.Tensor]:
        """The stuck mask flattened to (n,) — None when no sites are stuck."""
        if self.stuck_mask is None:
            return None
        return self.stuck_mask.reshape(-1)

    def field_noise(self, generator: torch.Generator, shape) -> torch.Tensor:
        """One fresh draw of the per-site Gaussian field perturbation."""
        return self.field_noise_std * torch.randn(shape, generator=generator,
                                                  device=generator.device)

    def keep_mask(self, generator: torch.Generator, shape) -> torch.Tensor:
        """Per-site bool mask of the updates that SURVIVE dropout this step."""
        return torch.rand(shape, generator=generator, device=generator.device) >= self.dropout


def natural_shape(problem) -> tuple:
    """The problem's natural spin-array shape ((H, W) for lattices, (n,))."""
    if isinstance(problem, LatticeIsing):
        return tuple(problem.shape)
    return (problem.n,)


def quantize_couplings(problem, bits: int):
    """Round a problem's couplings onto the signed `bits`-bit grid.

    One global scale (max |J|) maps couplings to integer codes in
    [-(2^(b-1)-1), 2^(b-1)-1]; values stay ON the grid as floats. In f32,
    round(x / scale * qmax) * (scale / qmax), in the JAX order, and
    `torch.round` rounds half to even as `jnp.round` does: the result equals
    the JAX package's bit for bit. Elementwise with a shared scale, so
    symmetric layouts stay symmetric and zeros (padding slots, the dense
    diagonal) stay exactly zero. Biases are untouched."""
    if not isinstance(bits, int) or isinstance(bits, bool) or bits < 2:
        raise ValueError(f"quantize_bits must be an int >= 2, got {bits!r}")
    qmax = float(2 ** (bits - 1) - 1)

    def grid(x):
        """Round `x` onto the shared-scale signed integer grid."""
        scale = torch.max(torch.abs(x))
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        return torch.round(x / scale * qmax) * (scale / qmax)

    if isinstance(problem, LatticeIsing):
        return dataclasses.replace(problem, w=grid(problem.w))
    if isinstance(problem, SparseIsing):
        return dataclasses.replace(problem, nbr_w=grid(problem.nbr_w))
    if isinstance(problem, DenseIsing):
        return dataclasses.replace(problem, J=grid(problem.J))
    raise TypeError(f"cannot quantize couplings of {type(problem).__name__}")


def make_stuck(
    generator: torch.Generator, problem, fraction: float, dtype=torch.float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw a (mask, values) stuck-spin pair for `problem` on the
    generator's device.

    Each site is stuck independently with probability `fraction`; stuck
    values are fair ±1 coin flips. `fraction=0` returns an all-False mask
    (still a faulted run: it exercises the stuck code path)."""
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(f"stuck fraction must be in [0, 1], got {fraction!r}")
    shape = natural_shape(problem)
    dev = generator.device
    mask = torch.rand(shape, generator=generator, device=dev) < fraction
    values = torch.where(torch.rand(shape, generator=generator, device=dev) < 0.5, 1.0, -1.0)
    return mask, values.to(dtype)
