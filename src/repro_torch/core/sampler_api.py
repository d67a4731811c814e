"""Unified sampler API (PyTorch): step-kernel / driver split.

The port of `repro.core.sampler_api`. A small `SamplerKernel` protocol says
how one step of a batch of chains advances, and ONE `run()` driver owns the
step loop, observation striding, energy recording, beta schedules,
first-hit time-to-solution tracking, multi-chain batching and backend
dispatch onto the CUDA kernels.

Kernel protocol (state is a `KernelState` of (n_chains, ...) tensors):

    kernel.init(problem, generator, s0=None, n_chains=1) -> KernelState
    kernel.step(problem, state, generator, beta) -> KernelState

`beta` is an (n_chains,) tensor: the JAX driver vmaps one chain per
kernel call, here every chain is a row of one batched step, so a
per-chain schedule is a per-row beta.

Kernels ported so far, registered by name:

    "chromatic_gibbs" — exact parallel Gibbs on the king's-move lattice via
        the 4-coloring; one step = one sweep = 4 color phases. Under
        `backend="cuda"` every sweep is ONE launch of the hand-written
        `lattice_gibbs_sweep` kernel; the ref path recomputes the stencil
        field per color phase.
    "colored_gibbs"   — chromatic Gibbs on arbitrary sparse graphs
        (`SparseIsing` + its `color_masks`); one step = one sweep over the
        color classes. Under `backend="cuda"` every sweep is ONE launch of
        the hand-written `colored_gibbs_sweep` kernel.
    "tau_leap"        — the PASS ASYNC model (dense, lattice or sparse):
        every neuron flips independently w.p. 1-exp(-dt*lambda_i) per step
        of model time dt. On dense problems `backend="cuda"` quantizes J to
        int8 once at init and runs every step through the hand-written
        `tau_leap_step` kernel; lattice and sparse problems are ref-only,
        as in JAX.

On CPU tensors a cuda backend runs each kernel's plain PyTorch version, as
the JAX package runs its Pallas kernels in interpret mode off-TPU. Both
backends of a kernel draw the same uniforms from the generator: the Gibbs
sweeps draw all (C, n_chains, ...) uniforms of a sweep in one call before
the first color phase.

The other kernels of the JAX registry ("random_scan_gibbs", "ctmc"),
`faults=` and `diagnostics=True` raise NotImplementedError naming the
slice of the port that brings them (see ROADMAP.md).

Driver:

    run(problem, kernel, seed_or_generator, n_steps=..., schedule=...,
        n_chains=..., sample_every=..., first_hit=..., backend=...) -> RunResult

`schedule` accepts None (beta=1), a float, a `(n_steps,)` array, a
`(n_chains, n_steps)` array (per-chain schedules), or a Schedule object
(`constant` / `linear` / `geometric`). `backend` is `"ref" | "cuda" |
"auto"`: "auto" picks "cuda" when the problem lives on a CUDA device and
the kernel has a CUDA path, "ref" otherwise; an explicit "cuda" request on
a kernel without a CUDA path raises ValueError.

The step loop is a Python loop that never waits on the device: the model
time, the first-hit time and the hit flags stay device tensors updated with
`torch.where`, the per-step betas are rows of one device tensor, and the
only host synchronisation is the finite-energy probe before the loop.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, NamedTuple, Optional, Protocol, Union, runtime_checkable

import torch

from repro_torch.core import glauber
from repro_torch.core.ising import DenseIsing, LatticeIsing, king_color_masks, resolve_device
from repro_torch.core.sparse import SparseIsing
from repro_torch.kernels import ops
from repro_torch.kernels.ref import broadcast_rows
from repro_torch.kernels.lattice_gibbs import lattice_plan
from repro_torch.kernels.sparse_gather import colour_plan


class NonFiniteEnergyError(ValueError):
    """A problem has non-finite energy.

    Raised by `run()` before any sampling happens: a NaN/Inf coupling or
    bias would otherwise silently poison every recorded energy."""


def random_init(
    generator: torch.Generator, shape, dtype=torch.float32, device=None
) -> torch.Tensor:
    """Uniform random ±1 initial state (the chip's post-reset state).

    `device` None means the CUDA device; `generator` must live on the
    same device."""
    u = torch.rand(shape, generator=generator, device=resolve_device(device))
    return torch.where(u < 0.5, 1.0, -1.0).to(dtype)


def state_shape(problem) -> tuple[int, ...]:
    """Natural spin-array shape for a problem: (H, W) on a lattice."""
    return problem.shape if isinstance(problem, LatticeIsing) else (problem.n,)


def problem_kind_of(problem) -> str:
    """The problem-kind dispatch axis: "dense" | "lattice" | "sparse".

    Anything else, such as a problem of the JAX package, raises TypeError:
    convert it with the port's `from_numpy` constructors."""
    if isinstance(problem, LatticeIsing):
        return "lattice"
    if isinstance(problem, SparseIsing):
        return "sparse"
    if isinstance(problem, DenseIsing):
        return "dense"
    raise TypeError(
        f"unknown problem type {type(problem).__module__}.{type(problem).__name__}; "
        "run() takes the port's DenseIsing, LatticeIsing or SparseIsing"
    )


def kernel_problem_kinds(kernel) -> tuple[str, ...]:
    """Problem kinds a kernel implements (all three when undeclared)."""
    return getattr(type(kernel), "problem_kinds", ("dense", "lattice", "sparse"))


def check_problem_kind(kernel, problem) -> None:
    """Raise ValueError when `kernel` does not implement `problem`'s kind."""
    kinds = kernel_problem_kinds(kernel)
    kind = problem_kind_of(problem)
    if kind not in kinds:
        name = getattr(kernel, "name", type(kernel).__name__)
        raise ValueError(
            f"kernel {name!r} does not support {kind!r} problems; "
            f"supported problem kinds: {kinds}"
        )


# ---------------------------------------------------------------------------
# Kernel state & protocol
# ---------------------------------------------------------------------------


class KernelState(NamedTuple):
    """State carried through the driver's step loop, batched over chains.

    s:   (n_chains, n) spin state (±1); (n_chains, H, W) on a lattice.
    t:   (n_chains,) model time (seconds of chip time at rate lambda0).
    e:   (n_chains,) running energy for kernels that maintain it
         incrementally; None otherwise — the driver recomputes on demand
         for first-hit tracking.
    aux: kernel-private data (quantized weights).
    """

    s: torch.Tensor
    t: torch.Tensor
    e: Any
    aux: Any


@runtime_checkable
class SamplerKernel(Protocol):
    """One MCMC step rule, applied to every chain (row) at once."""

    def init(
        self, problem, generator: torch.Generator, s0: Optional[torch.Tensor] = None,
        n_chains: int = 1,
    ) -> KernelState:
        """Build the initial kernel state (random init when s0 is None)."""
        ...

    def step(
        self, problem, state: KernelState, generator: torch.Generator, beta: torch.Tensor
    ) -> KernelState:
        """Advance every chain by one step at its inverse temperature beta[c]."""
        ...


# ---------------------------------------------------------------------------
# Kernel registry
# ---------------------------------------------------------------------------

KERNELS: dict[str, type] = {}

# Kernels of the JAX registry that later slices of the port bring.
LATER_KERNELS = {
    "random_scan_gibbs": "the sync-baseline and exact-CTMC slice",
    "ctmc": "the sync-baseline and exact-CTMC slice",
}


def register_kernel(name: str):
    """Class decorator: register a kernel under `name` for by-name lookup."""

    def deco(cls):
        """Register `cls` and attach its registry name."""
        KERNELS[name] = cls
        cls.name = name
        return cls

    return deco


def get_kernel(name: str, **config) -> "SamplerKernel":
    """Instantiate a registered kernel by name."""
    if name in LATER_KERNELS:
        raise NotImplementedError(
            f"sampler kernel {name!r} is not ported yet; it arrives with "
            f"{LATER_KERNELS[name]} (see ROADMAP.md)"
        )
    if name not in KERNELS:
        raise KeyError(f"unknown sampler kernel {name!r}; have {sorted(KERNELS)}")
    return KERNELS[name](**config)


def kernel_names() -> list[str]:
    """Sorted names of all registered kernels."""
    return sorted(KERNELS)


# ---------------------------------------------------------------------------
# Beta schedules
# ---------------------------------------------------------------------------


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """float32 linspace with the JAX formula, start*(1-step) + stop*step
    with step = iota/(num-1) and the exact endpoint appended, so schedules
    equal `jnp.linspace`'s element for element."""
    start_t = torch.tensor(start, dtype=torch.float32, device=device)
    stop_t = torch.tensor(stop, dtype=torch.float32, device=device)
    if num > 1:
        step = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
        out = start_t * (1 - step) + stop_t * step
        return torch.cat([out, stop_t[None]])
    if num == 1:
        return start_t[None]
    return torch.empty((0,), dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Base: a schedule maps n_steps -> (n_steps,) tensor of betas."""

    def betas(self, n_steps: int, device=None) -> torch.Tensor:
        """Materialize the (n_steps,) beta tensor (device None: CUDA)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class constant(Schedule):
    """Constant-beta schedule."""
    beta: float = 1.0

    def betas(self, n_steps: int, device=None) -> torch.Tensor:
        """Materialize the (n_steps,) beta tensor (device None: CUDA)."""
        return torch.full(
            (n_steps,), self.beta, dtype=torch.float32, device=resolve_device(device)
        )


@dataclasses.dataclass(frozen=True)
class linear(Schedule):
    """Linear beta ramp from beta0 to beta1."""
    beta0: float = 0.3
    beta1: float = 2.0

    def betas(self, n_steps: int, device=None) -> torch.Tensor:
        """Materialize the (n_steps,) beta tensor (device None: CUDA)."""
        return _linspace(self.beta0, self.beta1, n_steps, resolve_device(device))


@dataclasses.dataclass(frozen=True)
class geometric(Schedule):
    """Geometric beta ramp from beta0 to beta1."""
    beta0: float = 0.3
    beta1: float = 2.0

    def betas(self, n_steps: int, device=None) -> torch.Tensor:
        """Materialize the (n_steps,) beta tensor (device None: CUDA)."""
        ramp = _linspace(0.0, 1.0, n_steps, resolve_device(device))
        return self.beta0 * (self.beta1 / self.beta0) ** ramp


ScheduleLike = Union[None, float, torch.Tensor, Schedule]


def _tau_leap_flip(s, h, u, dt, trim, frozen=None):
    """One tau-leap update given (beta-scaled) fields h and uniforms u: each
    spin flips w.p. 1-exp(-dt*lambda_i/lambda0); frozen (clamped/dead)
    sites never do."""
    rate = glauber.flip_prob(h, s, trim)
    p_flip = 1.0 - torch.exp(-dt * rate)
    if frozen is not None:
        p_flip = torch.where(frozen, torch.zeros_like(p_flip), p_flip)
    return torch.where(u < p_flip, -s, s)


def resolve_schedule(
    schedule: ScheduleLike, n_steps: int, n_chains: Optional[int] = None, device=None
) -> torch.Tensor:
    """Normalize any accepted schedule form to a float32 beta tensor.

    Returns (n_steps,) — or (n_chains, n_steps) when given a 2D array of
    per-chain schedules. When `n_chains` is given (as `run()` does), a 2D
    schedule's row count is validated against it HERE, with an error naming
    both numbers. `device` None means the CUDA device."""
    dev = resolve_device(device)
    if schedule is None:
        return torch.ones((n_steps,), dtype=torch.float32, device=dev)
    if isinstance(schedule, Schedule):
        return schedule.betas(n_steps, dev)
    if isinstance(schedule, (int, float)):
        return torch.full((n_steps,), float(schedule), dtype=torch.float32, device=dev)
    betas = torch.as_tensor(schedule, dtype=torch.float32).to(dev)
    if betas.ndim == 0:  # numpy/torch scalar: constant schedule
        return betas.expand(n_steps).clone()
    if betas.ndim > 2:
        raise ValueError(
            f"schedule must be scalar, (n_steps,), or (n_chains, n_steps); "
            f"got shape {tuple(betas.shape)}"
        )
    if betas.shape[-1] != n_steps:
        raise ValueError(f"schedule length {betas.shape[-1]} != n_steps {n_steps}")
    if betas.ndim == 2 and n_chains is not None:
        if n_chains == 1:
            raise ValueError(
                f"per-chain schedule of shape {tuple(betas.shape)} requires "
                f"n_chains > 1 (got n_chains=1)"
            )
        if betas.shape[0] != n_chains:
            raise ValueError(
                f"per-chain schedule has {betas.shape[0]} rows but run() was "
                f"asked for n_chains={n_chains}"
            )
    return betas


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


@register_kernel("chromatic_gibbs")
@dataclasses.dataclass(frozen=True)
class ChromaticGibbs:
    """Exact parallel Gibbs on the king's-move lattice via the 4-coloring.
    One step = 4 color phases = one update per neuron, so the model time
    per step at per-neuron rate lambda0 is 1/lambda0.

    `backend="cuda"` runs the whole sweep of all chains as ONE launch of
    `ops.lattice_gibbs_sweep` (the CUDA kernel on CUDA tensors, its plain
    version on CPU tensors), each row with its own beta, over the lattice
    plan that `init` builds once (its one wait for the device is there, not
    in the step loop). The ref path
    recomputes the full stencil field once per color phase. Both draw the
    sweep's (4, n_chains, H, W) uniforms in one call, so on one device they
    follow the same stream. Trims are ref-only.

    Lattice-only: the arbitrary-graph generalization is `colored_gibbs`."""

    backends = ("ref", "cuda")
    problem_kinds = ("lattice",)

    lambda0: float = 1.0
    trim: Optional[glauber.SigmoidTrim] = None
    backend: str = "ref"  # "ref" | "cuda"

    def backends_for(self, problem=None) -> tuple[str, ...]:
        """Backends valid for this kernel config (trims are ref-only)."""
        return ("ref",) if self.trim is not None else self.backends

    def init(self, problem: LatticeIsing, generator, s0=None, n_chains=1) -> KernelState:
        """Initial state on the clamped lattice; the color, frozen and clamp
        planes the sweep takes, and on the cuda backend their lattice plan,
        are made once here."""
        if self.backend not in self.backends:
            raise ValueError(f"backend must be 'ref' | 'cuda', got {self.backend!r}")
        if self.backend == "cuda" and self.trim is not None:
            raise NotImplementedError("cuda chromatic gibbs does not support trims")
        dev = problem.device
        if s0 is None:
            s0 = random_init(generator, (n_chains,) + problem.shape, device=dev)
        s0 = problem.apply_clamps(s0)
        colors = king_color_masks(*problem.shape, device=dev)
        frozen = problem.frozen_mask
        if self.backend == "cuda":  # the plan of the very planes step() passes the kernel
            planes = (colors.float(), frozen.float(), problem.frozen_values.float())
            aux = planes + (lattice_plan(problem.w, problem.b, *planes),)
        else:
            aux = (colors, frozen)
        t0 = torch.zeros((s0.shape[0],), dtype=torch.float32, device=dev)
        return KernelState(s=s0, t=t0, e=None, aux=aux)

    def step(self, problem: LatticeIsing, state, generator, beta) -> KernelState:
        """One sweep: all 4 king-coloring phases for every chain."""
        s = state.s
        C = state.aux[0].shape[0]
        u = torch.rand((C,) + tuple(s.shape), generator=generator, device=s.device)
        if self.backend == "cuda":
            colors, frozen, clamp, plan = state.aux
            s = ops.lattice_gibbs_sweep(
                s, problem.w, problem.b, u, colors, frozen, clamp, beta=beta, plan=plan
            )
        else:
            colors, frozen = state.aux
            b = broadcast_rows(beta, s)
            for c in range(C):
                h = problem.local_fields(s)
                p_up = glauber.prob_up(b * h, self.trim)
                proposal = torch.where(u[c] < p_up, 1.0, -1.0).to(s.dtype)
                s = torch.where(colors[c] & ~frozen, proposal, s)
            s = problem.apply_clamps(s)
        return KernelState(s=s, t=state.t + 1.0 / self.lambda0, e=None, aux=state.aux)


@register_kernel("colored_gibbs")
@dataclasses.dataclass(frozen=True)
class ColoredGibbs:
    """Exact parallel Gibbs on an arbitrary sparse graph via its coloring —
    `chromatic_gibbs` generalized beyond the king's lattice. The problem's
    `color_masks` partition the sites into independent sets, so one step =
    one sweep over the color classes = one update per site (model time
    1/lambda0 per sweep).

    `backend="cuda"` runs the whole sweep of all chains as ONE launch of
    `ops.colored_gibbs_sweep`, each row with its own beta, over the colour
    plan that `init` builds once (its one wait for the device is there, not
    in the step loop). The ref path recomputes the gathered fields once per
    color phase. Both draw the sweep's (C, n_chains, n) uniforms in one call
    and sum the fields in the same slot order."""

    backends = ("ref", "cuda")
    problem_kinds = ("sparse",)

    lambda0: float = 1.0
    backend: str = "ref"  # "ref" | "cuda"

    def init(self, problem: SparseIsing, generator, s0=None, n_chains=1) -> KernelState:
        """Initial state; requires the problem's color_masks."""
        if self.backend not in self.backends:
            raise ValueError(f"backend must be 'ref' | 'cuda', got {self.backend!r}")
        if problem.color_masks is None:
            raise ValueError(
                "colored_gibbs needs problem.color_masks — build the problem "
                "with coloring enabled (SparseIsing.from_edges/from_dense "
                "color by default) or supply masks explicitly"
            )
        dev = problem.device
        if s0 is None:
            s0 = random_init(generator, (n_chains, problem.n), device=dev)
        masks = problem.color_masks
        aux = masks
        if self.backend == "cuda":  # the plan of the very masks step() passes the kernel
            fmasks = masks.float()
            aux = (fmasks, colour_plan(problem.nbr_idx, problem.nbr_w, problem.b, fmasks))
        t0 = torch.zeros((s0.shape[0],), dtype=torch.float32, device=dev)
        return KernelState(s=s0, t=t0, e=None, aux=aux)

    def step(self, problem: SparseIsing, state, generator, beta) -> KernelState:
        """One sweep over the graph's color classes for every chain."""
        s = state.s
        masks, plan = state.aux if self.backend == "cuda" else (state.aux, None)
        u = torch.rand((masks.shape[0],) + tuple(s.shape), generator=generator, device=s.device)
        if self.backend == "cuda":
            s = ops.colored_gibbs_sweep(
                s, problem.nbr_idx, problem.nbr_w, problem.b, u, masks, beta=beta, plan=plan
            )
        else:
            b = broadcast_rows(beta, s)
            for c in range(masks.shape[0]):
                h = problem.local_fields(s)
                p_up = glauber.prob_up(b * h)
                proposal = torch.where(u[c] < p_up, 1.0, -1.0).to(s.dtype)
                s = torch.where(masks[c], proposal, s)
        return KernelState(s=s, t=state.t + 1.0 / self.lambda0, e=None, aux=state.aux)


@register_kernel("tau_leap")
@dataclasses.dataclass(frozen=True)
class TauLeap:
    """The PASS asynchronous model: every neuron flips independently with
    prob 1-exp(-dt*lambda_i) per step of model time dt (in units of
    1/lambda0). Small dt*lambda0 -> exact CTMC; large dt -> 'stale neighbor'
    distortion, the analogue of the chip's circuit-delay skew (Fig S9).

    Works on DenseIsing, LatticeIsing (stencil fields, clamp/dead masks)
    and SparseIsing (gathered neighbor fields). On dense problems
    `backend="cuda"` quantizes J to int8 once at init and runs every step
    through `ops.tau_leap_step` (the CUDA kernel on CUDA tensors, its plain
    version on CPU tensors), all chains as the rows of one call, each row
    with its own beta; lattice and sparse problems are ref-only, as in JAX.
    Both backends draw the same (n_chains, ...) uniforms per step from the
    generator."""

    backends = ("ref", "cuda")
    problem_kinds = ("dense", "lattice", "sparse")

    dt: float = 0.1
    lambda0: float = 1.0
    backend: str = "ref"  # "ref" | "cuda"
    trim: Optional[glauber.SigmoidTrim] = None

    def backends_for(self, problem=None) -> tuple[str, ...]:
        """Backends valid for this kernel/problem pair: lattice and sparse
        tau-leap have no kernel; trims are ref-only."""
        if isinstance(problem, (LatticeIsing, SparseIsing)) or self.trim is not None:
            return ("ref",)
        return self.backends

    def init(self, problem, generator, s0=None, n_chains=1) -> KernelState:
        """Initial state (int8-quantized weights under cuda)."""
        if self.backend not in self.backends:
            raise ValueError(f"backend must be 'ref' | 'cuda', got {self.backend!r}")
        dev = problem.device
        if s0 is None:
            s0 = random_init(generator, (n_chains,) + state_shape(problem), device=dev)
        aux = ()
        if self.backend == "cuda" and not isinstance(problem, DenseIsing):
            raise NotImplementedError(
                "cuda tau-leap supports dense problems only; use chromatic_gibbs "
                "(lattice) or colored_gibbs (sparse) for the fused sweep kernels"
            )
        if isinstance(problem, LatticeIsing):
            s0 = problem.apply_clamps(s0)
        if self.backend == "cuda":
            if self.trim is not None:
                raise NotImplementedError("cuda tau-leap does not support trims")
            j_i8, scale = ops.quantize_dense(problem.J)  # once per run
            aux = (j_i8, scale, torch.tensor(self.dt, dtype=torch.float32, device=dev))
        t0 = torch.zeros((s0.shape[0],), dtype=torch.float32, device=dev)
        return KernelState(s=s0, t=t0, e=None, aux=aux)

    def step(self, problem, state, generator, beta) -> KernelState:
        """One tau-leap of model time dt for every chain: independent
        thinned flips at each row's beta."""
        s = state.s
        u = torch.rand(s.shape, generator=generator, device=s.device)
        if self.backend == "cuda":
            j_i8, scale, dt = state.aux
            # beta scales the field: h_beta = acc*(beta*scale) + beta*b
            s = ops.tau_leap_step(s, j_i8, problem.b, scale, u, dt, beta=beta)
        elif isinstance(problem, LatticeIsing):
            h = problem.local_fields(s)
            s = _tau_leap_flip(
                s, broadcast_rows(beta, s) * h, u, self.dt, self.trim, problem.frozen_mask
            )
            s = problem.apply_clamps(s)
        else:
            h = problem.local_fields(s)
            s = _tau_leap_flip(s, broadcast_rows(beta, s) * h, u, self.dt, self.trim)
        return KernelState(
            s=s, t=state.t + self.dt / self.lambda0, e=None, aux=state.aux
        )


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------


class RunTiming(NamedTuple):
    """Host-side wall-clock accounting for one `run(..., timeit=True)` call.

    Each pass is bracketed by `torch.cuda.synchronize()` on a CUDA problem.

    compile_s:         first-call overhead, estimated as first_call_wall -
                       steady_state_wall, floored at 0: the first-use nvcc
                       build of the kernels and the CUDA context setup.
    wall_s:            steady-state wall time of one full driver call.
    steps_per_s:       n_steps / wall_s (per chain).
    chain_steps_per_s: n_steps * n_chains / wall_s.
    """

    compile_s: float
    wall_s: float
    steps_per_s: float
    chain_steps_per_s: float


class RunResult(NamedTuple):
    """Result of a `run()` call. With n_chains > 1 every field gains a
    leading chain dimension.

    s:        final state.
    t:        final model time (seconds of chip time).
    samples:  (n_samples, ...) states recorded every `sample_every` steps
              (empty leading dim when sample_every == 0).
    times:    (n_samples,) model time at each recorded state.
    energies: (n_samples,) energy at each recorded state.
    t_hit:    first model time with energy <= first_hit (inf if never);
              None when first_hit was not requested.
    hit:      whether the target was reached; None when not requested.
    timing:   RunTiming when run(..., timeit=True); None otherwise.
    diagnostics: always None in this slice of the port.
    """

    s: torch.Tensor
    t: torch.Tensor
    samples: torch.Tensor
    times: torch.Tensor
    energies: torch.Tensor
    t_hit: Any = None
    hit: Any = None
    timing: Any = None
    diagnostics: Any = None


def kernel_backends(kernel, problem=None) -> tuple[str, ...]:
    """Backends a kernel can actually execute ("ref" always works)."""
    fn = getattr(kernel, "backends_for", None)
    if fn is not None:
        return fn(problem)
    return getattr(type(kernel), "backends", ("ref",))


def _resolve_backend(backend: Optional[str], kernel=None, problem=None) -> Optional[str]:
    """Resolve a requested backend against what `kernel` supports.

    An explicit "cuda" request on a kernel with no CUDA path raises
    ValueError. "auto" picks "cuda" when the problem lives on a CUDA device
    and the kernel has a CUDA path, "ref" otherwise."""
    if backend is None:
        return None
    if backend not in ("ref", "cuda", "auto"):
        raise ValueError(f"backend must be 'ref' | 'cuda' | 'auto', got {backend!r}")
    supported = ("ref", "cuda") if kernel is None else kernel_backends(kernel, problem)
    if backend == "auto":
        on_cuda = problem is not None and problem.device.type == "cuda"
        return "cuda" if on_cuda and "cuda" in supported else "ref"
    if backend not in supported:
        name = getattr(kernel, "name", type(kernel).__name__)
        raise ValueError(
            f"kernel {name!r} does not support backend {backend!r}; "
            f"supported backends: {supported}"
        )
    return backend


def _run_core(
    problem, kernel, generator, s0, betas, e_target, *,
    n_steps, sample_every, track_hit, n_chains,
):
    """All chains at once, as the rows of each step: the one loop every
    sampling entry point shares. `betas` is (n_steps, n_chains)."""
    state = kernel.init(problem, generator, s0, n_chains)
    e0 = state.e if state.e is not None else problem.energy(state.s)
    hit = (e0 <= e_target) & track_hit
    t_hit = torch.where(hit, 0.0, math.inf)

    def advance(state, t_hit, hit, lo, hi):
        """Steps lo..hi-1, with first-hit tracking kept on the device."""
        for i in range(lo, hi):
            state = kernel.step(problem, state, generator, betas[i])
            if track_hit:
                e = state.e if state.e is not None else problem.energy(state.s)
                new_hit = (e <= e_target) & ~hit
                t_hit = torch.where(new_hit, state.t, t_hit)
                hit = hit | new_hit
        return state, t_hit, hit

    s = state.s
    if sample_every > 0:
        n_samples = n_steps // sample_every
        samples = torch.empty((n_chains, n_samples) + s.shape[1:], dtype=s.dtype, device=s.device)
        times = torch.empty((n_chains, n_samples), dtype=torch.float32, device=s.device)
        for k in range(n_samples):
            state, t_hit, hit = advance(
                state, t_hit, hit, k * sample_every, (k + 1) * sample_every
            )
            samples[:, k] = state.s
            times[:, k] = state.t
        m = n_samples * sample_every
        if m < n_steps:  # remainder steps after the last observation
            state, t_hit, hit = advance(state, t_hit, hit, m, n_steps)
        energies = problem.energy(samples)
    else:
        state, t_hit, hit = advance(state, t_hit, hit, 0, n_steps)
        samples = torch.zeros((n_chains, 0) + s.shape[1:], dtype=s.dtype, device=s.device)
        times = torch.zeros((n_chains, 0), dtype=torch.float32, device=s.device)
        # e0 has the energy dtype both recording branches produce, not the
        # state dtype, so empty and sampled results concatenate cleanly
        energies = torch.zeros((n_chains, 0), dtype=e0.dtype, device=s.device)

    return RunResult(
        s=state.s,
        t=state.t,
        samples=samples,
        times=times,
        energies=energies,
        t_hit=t_hit if track_hit else None,
        hit=hit if track_hit else None,
    )


def _generator(seed_or_generator, device: torch.device) -> torch.Generator:
    """A torch.Generator on `device`: a fresh one seeded from an int, or the
    caller's own, which must live on the problem's device."""
    if isinstance(seed_or_generator, torch.Generator):
        if seed_or_generator.device.type != device.type:
            raise ValueError(
                f"generator is on {seed_or_generator.device}, the problem on {device}"
            )
        return seed_or_generator
    if isinstance(seed_or_generator, int) and not isinstance(seed_or_generator, bool):
        return torch.Generator(device=device).manual_seed(seed_or_generator)
    raise TypeError(
        f"seed must be an int or a torch.Generator, got {type(seed_or_generator).__name__}"
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(
    problem,
    kernel: Union[SamplerKernel, str],
    seed: Union[int, torch.Generator],
    *,
    n_steps: int,
    s0: Optional[torch.Tensor] = None,
    schedule: ScheduleLike = None,
    n_chains: int = 1,
    sample_every: int = 0,
    first_hit: Optional[float] = None,
    backend: Optional[str] = None,
    timeit: bool = False,
    diagnostics: bool = False,
    faults: Any = None,
) -> RunResult:
    """Run `n_steps` of `kernel` on `problem` — the single sampling driver.

    Runs on the device the problem's tensors live on.

    Args:
      problem: DenseIsing, LatticeIsing or SparseIsing (the port's; any
        other type raises TypeError).
      kernel: a SamplerKernel instance, or a registered kernel name.
      seed: an int (seeds a fresh torch.Generator on the problem's device)
        or a torch.Generator on that device; it draws the initial states
        and the per-step uniforms.
      n_steps: kernel steps.
      s0: optional initial state — (n_chains,) + state_shape(problem) when
        n_chains > 1, state_shape(problem) otherwise ((H, W) on a lattice);
        random ±1 init per chain when omitted.
      schedule: beta schedule — None (beta=1), float, Schedule object,
        (n_steps,) array, or (n_chains, n_steps) per-chain array.
      n_chains: independent chains, batched as the rows of every step.
      sample_every: observation stride (the chip's FPGA-side observer
        clock); 0 records nothing.
      first_hit: energy target — tracks (t_hit, hit) per chain.
      backend: "ref" | "cuda" | "auto" — overrides the kernel's backend
        field. "cuda" on a kernel without a CUDA path raises ValueError.
      timeit: run twice (first-use pass, then a steady-state pass with the
        same random stream, identical results) and attach a RunTiming.
      diagnostics, faults: not ported yet; diagnostics=True or a fault
        model raise NotImplementedError.
    """
    if isinstance(kernel, str):
        kernel = get_kernel(kernel)
    check_problem_kind(kernel, problem)
    if faults is not None:
        raise NotImplementedError(
            "run(faults=...) is not ported yet; the device-fault model arrives "
            "with the faults slice of the port (see ROADMAP.md)"
        )
    if diagnostics:
        raise NotImplementedError(
            "run(diagnostics=True) is not ported yet; the in-loop diagnostics "
            "arrive with the diagnostics slice of the port (see ROADMAP.md)"
        )
    if n_chains < 1:
        raise ValueError(f"n_chains must be >= 1, got {n_chains}")
    resolved = _resolve_backend(backend, kernel, problem)
    if resolved is not None and hasattr(kernel, "backend") and kernel.backend != resolved:
        kernel = dataclasses.replace(kernel, backend=resolved)

    dev = problem.device
    # The one host synchronisation: fail loudly on couplings/biases that
    # cannot produce finite energies before any sampling happens.
    e_probe = problem.energy(torch.ones(state_shape(problem), device=dev))
    if not bool(torch.isfinite(e_probe)):
        raise NonFiniteEnergyError(
            f"problem energy is non-finite (probe energy {float(e_probe)}); "
            "check the couplings/biases for NaN/Inf"
        )

    betas = resolve_schedule(schedule, n_steps, n_chains, device=dev)
    betas = betas.expand(n_chains, n_steps).T.contiguous()  # row i: step i's per-chain betas
    track_hit = first_hit is not None
    e_target = torch.tensor(
        first_hit if track_hit else math.inf, dtype=torch.float32, device=dev
    )
    if s0 is not None:
        s0 = s0.to(dev)
        if n_chains == 1 and s0.ndim == len(state_shape(problem)):
            s0 = s0[None]
        if tuple(s0.shape) != (n_chains,) + state_shape(problem):
            raise ValueError(
                f"s0 has shape {tuple(s0.shape)}; expected "
                f"{(n_chains,) + state_shape(problem)} for n_chains={n_chains}"
            )

    gen = _generator(seed, dev)
    gen_start = gen.get_state()

    def call() -> RunResult:
        """One full driver pass from the generator's starting state."""
        gen.set_state(gen_start)
        res = _run_core(
            problem, kernel, gen, s0, betas, e_target, n_steps=n_steps,
            sample_every=sample_every, track_hit=track_hit, n_chains=n_chains,
        )
        if n_chains == 1:
            res = RunResult(*(x[0] if isinstance(x, torch.Tensor) else x for x in res))
        return res

    if not timeit:
        return call()

    _sync(dev)
    t0 = time.perf_counter()
    call()
    _sync(dev)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = call()
    _sync(dev)
    wall_s = max(time.perf_counter() - t0, 1e-9)
    timing = RunTiming(
        compile_s=max(0.0, first_s - wall_s),
        wall_s=wall_s,
        steps_per_s=n_steps / wall_s,
        chain_steps_per_s=n_steps * n_chains / wall_s,
    )
    return res._replace(timing=timing)
