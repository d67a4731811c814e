"""Unified sampler API (PyTorch): step-kernel / driver split.

The port of `repro.core.sampler_api`. A small `SamplerKernel` protocol says
how one step of a batch of chains advances, and ONE `run()` driver owns the
step loop, observation striding, energy recording, beta schedules,
first-hit time-to-solution tracking, multi-chain batching and backend
dispatch onto the CUDA kernels.

Kernel protocol (state is a `KernelState` of (n_chains, ...) tensors):

    kernel.init(problem, generator, s0=None, n_chains=1, faults=None) -> KernelState
    kernel.step(problem, state, generator, beta, faults=None) -> KernelState

`beta` is an (n_chains,) tensor: the JAX driver vmaps one chain per
kernel call, here every chain is a row of one batched step, so a
per-chain schedule is a per-row beta. The driver passes `faults` only when
`run(..., faults=...)` leaves a residual `repro_torch.core.faults.
FaultModel` after `bind()`, so a kernel that never heard of faults, and
the fault-free program, are untouched.

Kernels, registered by name (every kernel of the JAX registry):

    "random_scan_gibbs" — the paper's SYNCHRONOUS baseline (dense or sparse
        problems): one uniformly random site resampled per chain per step,
        incremental fields and energy, model time 1/lambda0 per step.
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
    "ctmc"            — the exact event-driven CTMC (Gillespie) on dense or
        sparse problems; one step = one flip event per chain, stochastic
        model-time advance. `site_draw` selects the event selection: the
        O(n) Gumbel-max ("scan") or the sum-tree descent ("tree": ONE
        uniform + O(log n), see `repro_torch.core.event_tree`); "auto"
        picks by size. On `SparseIsing` under a constant schedule the tree
        is carried and repaired at the <= max_deg affected leaves per event.
        On a float32 `DenseIsing` under the tree draw, `backend="cuda"` runs
        every event of all chains as ONE launch of the hand-written
        `ctmc_event` kernel.

Random-scan Gibbs, and the CTMC off that one route, are plain torch on
every device (the JAX package has no Pallas kernel for either). Every
kernel splits a step into a `draw` from the generator and an `update`
given the draws (pure, except the CTMC's carried tree, repaired in
place), so a CPU test can feed the update the draws the JAX step takes
from its key.

On CPU tensors a cuda backend runs each kernel's plain PyTorch version, as
the JAX package runs its Pallas kernels in interpret mode off-TPU. Both
backends of a kernel draw the same uniforms from the generator: the Gibbs
sweeps draw all (C, n_chains, ...) uniforms of a sweep in one call before
the first color phase.

Device faults (`run(..., faults=FaultModel(...))`, semantics in
`repro_torch.core.faults`): `run()` validates the model and binds it to
the problem once (quantized couplings; lattice stuck sites become clamps);
a residual with nothing dynamic left runs the exact fault-free program.
Otherwise each step draws, after its own draws and in this order, the
field noise eta ((n_chains,) + state shape; (n_chains,) for random scan)
when `field_noise_std > 0`, then the dropout keep mask (one uniform per
site, or per chain for random scan and the CTMC, kept where >= dropout)
when `dropout > 0`. Under the cuda backend the three kernels take them as
operands of their fault variants: the per-row bias b + eta (tau-leap:
beta_r (b + eta_r), formed in the kernel) and, for the two sweeps, the
keep mask; tau-leap warps the uniform of a stuck or dropped site to 1.0
instead.

Driver:

    run(problem, kernel, seed_or_generator, n_steps=..., schedule=...,
        n_chains=..., sample_every=..., first_hit=..., backend=...,
        unroll=..., diagnostics=..., faults=...) -> RunResult

`schedule` accepts None (beta=1), a float, a `(n_steps,)` array, a
`(n_chains, n_steps)` array (per-chain schedules), or a Schedule object
(`constant` / `linear` / `geometric`). `backend` is `"ref" | "cuda" |
"auto"`: "auto" picks "cuda" when the problem lives on a CUDA device and
the kernel has a CUDA path, "ref" otherwise; an explicit "cuda" request on
a kernel without a CUDA path raises ValueError.

The step loop never waits on the device: the model time, the first-hit
time, the hit flags, the diagnostics and the step and sample counters stay
device tensors. The host synchronises only before the loop: the
finite-energy probe of a new run and, for a kernel that can carry state
across steps of one beta (the sparse tree CTMC), whether each chain's
schedule is constant. On a CUDA problem the loop runs as replays of
captured CUDA graphs of blocks of steps (`repro_torch.core.graph_loop`),
the port's counterpart of the JAX driver's compiled `lax.scan`; on CPU
tensors it runs eagerly. `run()` keeps the run of a call, graphs and all,
for a later call of the same shape (`run`'s docstring), as `jax.jit` keeps
a compiled program for its next call.
`unroll` is validated as in the JAX package and changes nothing here: the
graph's blocks do not depend on it, nor do the results.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
import weakref
from typing import Any, NamedTuple, Optional, Protocol, Union, runtime_checkable

import torch

from repro_torch import tracing
from repro_torch.core import diagnostics as diag
from repro_torch.core import event_tree, glauber
from repro_torch.core.diagnostics import RunDiagnostics  # noqa: F401  (re-export)
from repro_torch.core.faults import FaultModel
from repro_torch.core.graph_loop import GRAPH_STEPS, StepLoop, plan_blocks
from repro_torch.core.ising import DenseIsing, LatticeIsing, king_color_masks, resolve_device
from repro_torch.core.sparse import SparseIsing
from repro_torch.kernels import ctmc_event, ops
from repro_torch.kernels.ref import broadcast_rows
from repro_torch.kernels.lattice_gibbs import lattice_plan
from repro_torch.kernels.sparse_gather import check_samples_route, colour_plan


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


def _tau_leap_flip(s, h, u, dt, trim, frozen=None, keep=None):
    """One tau-leap update given (beta-scaled) fields h and uniforms u: each
    spin flips w.p. 1-exp(-dt*lambda_i/lambda0); frozen (clamped, dead or
    stuck) sites never do, and sites outside `keep` (update dropout) lose
    their flip after the uniform is compared."""
    rate = glauber.flip_prob(h, s, trim)
    p_flip = 1.0 - torch.exp(-dt * rate)
    if frozen is not None:
        p_flip = torch.where(frozen, torch.zeros_like(p_flip), p_flip)
    flips = u < p_flip
    if keep is not None:
        flips = flips & keep
    return torch.where(flips, -s, s)


def _fault_draws(faults, generator: torch.Generator, shape, keep_shape=None) -> tuple:
    """(eta, keep) of one step, drawn after the step's own numbers: the
    `shape` field noise, then the dropout keep mask (of `keep_shape`,
    default `shape`), each only when its fault is on (None otherwise)."""
    if faults is None:
        return None, None
    eta = faults.field_noise(generator, shape) if faults.noisy else None
    keep = faults.keep_mask(generator, keep_shape or shape) if faults.drops else None
    return eta, keep


def _stuck(faults) -> Optional[torch.Tensor]:
    """The (n,) stuck mask a step's update takes (None without one)."""
    return None if faults is None else faults.stuck_flat()


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

    Faults: stuck sites arrive as clamps (`FaultModel.bind`), so the plan
    is built from the bound problem. Field noise is one (n_chains, H, W)
    draw a sweep, shared by its 4 phases, added to b; dropped sites keep
    their spin for the sweep. On the cuda backend both are operands of the
    kernel's fault variant (`ops.lattice_gibbs_sweep(bias_rows=, keep=)`).

    Lattice-only: the arbitrary-graph generalization is `colored_gibbs`."""

    backends = ("ref", "cuda")
    problem_kinds = ("lattice",)

    lambda0: float = 1.0
    trim: Optional[glauber.SigmoidTrim] = None
    backend: str = "ref"  # "ref" | "cuda"

    def backends_for(self, problem=None) -> tuple[str, ...]:
        """Backends valid for this kernel config (trims are ref-only)."""
        return ("ref",) if self.trim is not None else self.backends

    def init(self, problem: LatticeIsing, generator, s0=None, n_chains=1,
             faults=None) -> KernelState:
        """Initial state on the clamped lattice (stuck sites arrive already
        absorbed into the clamps by `FaultModel.bind`); the color, frozen
        and clamp planes the sweep takes, and on the cuda backend their
        lattice plan, are made once here."""
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

    def draw(self, problem, state, generator, beta=None, faults=None) -> tuple:
        """(u, eta, keep): the sweep's (C, n_chains, H, W) uniforms, then
        the fault draws (`_fault_draws`; beta unused)."""
        s = state.s
        C = state.aux[0].shape[0]
        u = torch.rand((C,) + tuple(s.shape), generator=generator, device=s.device)
        return (u, *_fault_draws(faults, generator, s.shape))

    def update(self, problem: LatticeIsing, state, beta, u, eta=None, keep=None) -> KernelState:
        """One sweep of every chain given its uniforms, field noise eta
        (added to b) and keep mask (None: no such fault)."""
        s = state.s
        if self.backend == "cuda":
            colors, frozen, clamp, plan = state.aux
            s = ops.lattice_gibbs_sweep(
                s, problem.w, problem.b, u, colors, frozen, clamp, beta=beta, plan=plan,
                bias_rows=None if eta is None else problem.b + eta, keep=keep,
            )
        else:
            colors, frozen = state.aux
            b = broadcast_rows(beta, s)
            bias = problem.b if eta is None else problem.b + eta
            for c in range(colors.shape[0]):
                h = problem.neighbor_sum(s) + bias
                p_up = glauber.prob_up(b * h, self.trim)
                proposal = torch.where(u[c] < p_up, 1.0, -1.0).to(s.dtype)
                upd = colors[c] & ~frozen
                if keep is not None:
                    upd = upd & keep
                s = torch.where(upd, proposal, s)
            s = problem.apply_clamps(s)
        return KernelState(s=s, t=state.t + 1.0 / self.lambda0, e=None, aux=state.aux)

    def step(self, problem: LatticeIsing, state, generator, beta, faults=None) -> KernelState:
        """One sweep: all 4 king-coloring phases for every chain."""
        return self.update(problem, state, beta, *self.draw(problem, state, generator, beta, faults))

    def energy_fn(self, problem: LatticeIsing):
        """The energy `run()` takes of the states and samples: on the cuda
        backend, for an f32 lattice, one call of `ops.lattice_energy` over
        the problem's planes (the hand-written kernel on a CUDA problem),
        else None (`run()` takes `problem.energy`). Both give
        `LatticeIsing.energy`'s terms; the kernel sums them over the sites
        in its own fixed order."""
        if self.backend != "cuda" or problem.w.dtype != torch.float32:
            return None  # the kernel takes f32 alone; a bf16 lattice keeps its own rounding
        w, b = problem.w, problem.b
        return lambda s: ops.lattice_energy(s, w, b)


@register_kernel("colored_gibbs")
@dataclasses.dataclass(frozen=True)
class ColoredGibbs:
    """Exact parallel Gibbs on an arbitrary sparse graph via its coloring —
    `chromatic_gibbs` generalized beyond the king's lattice. The problem's
    `color_masks` partition the sites into independent sets, so one step =
    one sweep over the color classes = one update per site (model time
    1/lambda0 per sweep).

    `backend="cuda"` runs the whole sweep of all chains as ONE call of
    `ops.colored_gibbs_sweep`, each row with its own beta, over the colour
    plan that `init` builds once (its one wait for the device is there, not
    in the step loop; span `sampler.colour_plan`, counter
    `sampler.colour_plans`). Rows of more than 116224 sites take the
    long-row kernel (`sparse_gather.sweep_kernel`), which needs the classes
    to be independent sets and takes no field noise or dropout. The ref
    path recomputes the gathered fields once per color phase. Both draw the
    sweep's (C, n_chains, n) uniforms in one call and sum the fields in the
    same slot order.

    Faults: stuck sites leave every colour class for the run (`init`
    builds the masks, and the plan, from masks & ~stuck); field noise is
    one (n_chains, n) draw a sweep added to b, and dropped sites keep
    their spin for the sweep, both operands of the cuda kernel's fault
    variant (`ops.colored_gibbs_sweep(bias_rows=, keep=)`).

    Disorder samples: on a problem with per-sample couplings
    (`SparseIsing.n_samples` S > 1 tables) the chains are sample-major, row
    r of sample r // (n_chains / S), and `init` builds the per-sample plan;
    under cuda every sweep is ONE launch of the per-sample kernel for all
    rows, every energy one launch of the per-sample energy kernel. Rows of
    more than 116224 sites and faults have no per-sample route."""

    backends = ("ref", "cuda")
    problem_kinds = ("sparse",)

    lambda0: float = 1.0
    backend: str = "ref"  # "ref" | "cuda"

    def init(self, problem: SparseIsing, generator, s0=None, n_chains=1,
             faults=None) -> KernelState:
        """Initial state (stuck sites at their values); requires the
        problem's color_masks."""
        if self.backend not in self.backends:
            raise ValueError(f"backend must be 'ref' | 'cuda', got {self.backend!r}")
        if problem.color_masks is None:
            raise ValueError(
                "colored_gibbs needs problem.color_masks — build the problem "
                "with coloring enabled (SparseIsing.from_edges/from_dense "
                "color by default) or supply masks explicitly"
            )
        dev = problem.device
        if self.backend == "cuda" and problem.per_sample:
            check_samples_route(problem.n, problem.n_samples)
        if s0 is None:
            s0 = random_init(generator, (n_chains, problem.n), device=dev)
        masks = problem.color_masks
        if faults is not None:
            s0 = faults.apply_stuck(s0)
            if faults.stuck_mask is not None:
                masks = masks & ~faults.stuck_flat()
        aux = masks
        if self.backend == "cuda":  # the plan of the very masks step() passes the kernel
            fmasks = masks.float()
            with tracing.span("sampler.colour_plan"):
                aux = (fmasks, colour_plan(problem.nbr_idx, problem.nbr_w, problem.b, fmasks))
            tracing.count("sampler.colour_plans")
        t0 = torch.zeros((s0.shape[0],), dtype=torch.float32, device=dev)
        return KernelState(s=s0, t=t0, e=None, aux=aux)

    def draw(self, problem, state, generator, beta=None, faults=None) -> tuple:
        """(u, eta, keep): the sweep's (C, n_chains, n) uniforms, then the
        fault draws (`_fault_draws`; beta unused)."""
        s = state.s
        masks = state.aux[0] if self.backend == "cuda" else state.aux
        u = torch.rand((masks.shape[0],) + tuple(s.shape), generator=generator, device=s.device)
        return (u, *_fault_draws(faults, generator, s.shape))

    def update(self, problem: SparseIsing, state, beta, u, eta=None, keep=None) -> KernelState:
        """One sweep of every chain given its uniforms, field noise eta
        (added to b) and keep mask (None: no such fault)."""
        s = state.s
        masks, plan = state.aux if self.backend == "cuda" else (state.aux, None)
        if self.backend == "cuda":
            s = ops.colored_gibbs_sweep(
                s, problem.nbr_idx, problem.nbr_w, problem.b, u, masks, beta=beta, plan=plan,
                bias_rows=None if eta is None else problem.b + eta, keep=keep,
            )
        else:
            b = broadcast_rows(beta, s)
            bias = problem.b if eta is None else problem.b + eta
            for c in range(masks.shape[0]):
                h = problem.neighbor_sum(s) + bias
                p_up = glauber.prob_up(b * h)
                proposal = torch.where(u[c] < p_up, 1.0, -1.0).to(s.dtype)
                upd = masks[c] if keep is None else masks[c] & keep
                s = torch.where(upd, proposal, s)
        return KernelState(s=s, t=state.t + 1.0 / self.lambda0, e=None, aux=state.aux)

    def step(self, problem: SparseIsing, state, generator, beta, faults=None) -> KernelState:
        """One sweep over the graph's color classes for every chain."""
        return self.update(problem, state, beta, *self.draw(problem, state, generator, beta, faults))

    def energy_fn(self, problem: SparseIsing):
        """The energy `run()` takes of the states and samples: on the cuda
        backend one call of `ops.sparse_energy` over the problem's tables
        (the hand-written kernel on a CUDA problem), else None (`run()`
        takes `problem.energy`). Both give `SparseIsing.energy`'s terms; the
        kernel sums them over the sites in its own fixed order."""
        if self.backend != "cuda":
            return None
        nbr_idx, nbr_w, b = problem.nbr_idx, problem.nbr_w, problem.b
        return lambda s: ops.sparse_energy(s, nbr_idx, nbr_w, b)


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
    generator.

    Faults: field noise perturbs the pre-beta field (h + eta on the ref
    paths; the per-row bias b + eta of the kernel's fault variant on the
    cuda path). Stuck and dropped sites keep their spin: the ref paths
    freeze them and drop their flips, the cuda path warps their uniform to
    1.0 (a flip needs u < p <= 1). Lattice stuck sites arrive as clamps."""

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

    def init(self, problem, generator, s0=None, n_chains=1, faults=None) -> KernelState:
        """Initial state (stuck sites at their values; int8-quantized
        weights under cuda)."""
        if self.backend not in self.backends:
            raise ValueError(f"backend must be 'ref' | 'cuda', got {self.backend!r}")
        dev = problem.device
        if s0 is None:
            s0 = random_init(generator, (n_chains,) + state_shape(problem), device=dev)
        if faults is not None:
            s0 = faults.apply_stuck(s0)
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

    def draw(self, problem, state, generator, beta=None, faults=None) -> tuple:
        """(u, eta, keep): the step's (n_chains, ...) uniforms, then the
        fault draws (`_fault_draws`; beta unused)."""
        s = state.s
        u = torch.rand(s.shape, generator=generator, device=s.device)
        return (u, *_fault_draws(faults, generator, s.shape))

    def update(self, problem, state, beta, u, eta=None, keep=None, stuck=None) -> KernelState:
        """One tau-leap of every chain given its uniforms, field noise eta,
        keep mask and the (n,) stuck mask (None: no such fault)."""
        s = state.s
        if self.backend == "cuda":
            j_i8, scale, dt = state.aux
            block = stuck if keep is None else (~keep if stuck is None else stuck | ~keep)
            if block is not None:
                u = torch.where(block, 1.0, u)
            # beta scales the field: h_beta = acc*(beta*scale) + beta*b
            s = ops.tau_leap_step(s, j_i8, problem.b, scale, u, dt, beta=beta,
                                  bias_rows=None if eta is None else problem.b + eta)
        else:
            h = problem.local_fields(s)
            if eta is not None:
                h = h + eta
            lattice = isinstance(problem, LatticeIsing)
            s = _tau_leap_flip(s, broadcast_rows(beta, s) * h, u, self.dt, self.trim,
                               problem.frozen_mask if lattice else stuck, keep)
            if lattice:
                s = problem.apply_clamps(s)
        return KernelState(
            s=s, t=state.t + self.dt / self.lambda0, e=None, aux=state.aux
        )

    def step(self, problem, state, generator, beta, faults=None) -> KernelState:
        """One tau-leap of model time dt for every chain: independent
        thinned flips at each row's beta."""
        return self.update(problem, state, beta, *self.draw(problem, state, generator, beta, faults),
                           stuck=_stuck(faults))


def _apply_field_delta(problem, h, i, delta, nbr=None):
    """Incremental local-field update after s_i changes by `delta`, one site
    i[c] and one delta[c] per chain (row) c.

    Dense: add the row J[i_c] (J is symmetric, and its rows are contiguous)
    times delta_c: O(n). Sparse: scatter-add nbr_w[i_c] * delta_c into
    nbr_idx[i_c] (`nbr` is nbr_idx as int64): O(max_deg). Padded slots point
    at i_c itself with zero weight, so the scatter needs no degree mask, and
    a row's nonzero adds meet at no address. h_i itself is untouched (zero
    diagonal)."""
    if isinstance(problem, SparseIsing):
        return h.scatter_add(1, nbr[i], problem.nbr_w[i] * delta[:, None])
    return h + problem.J[i] * delta[:, None]


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[c, i[c]] for every row c of a (B, n) tensor."""
    return x.gather(1, i[:, None])[:, 0]


class LocalFields(NamedTuple):
    """Random-scan Gibbs' kernel-private state: the incremental local fields
    and, on a sparse problem, nbr_idx as int64 (None on a dense one)."""

    h: torch.Tensor
    nbr: Optional[torch.Tensor]


@register_kernel("random_scan_gibbs")
@dataclasses.dataclass(frozen=True)
class RandomScanGibbs:
    """Serial random-scan Gibbs — the paper's synchronous baseline. One
    uniformly random site per chain per step, dt = 1/lambda0 per step (the
    chip comparison runs the serial system at the single-neuron rate).
    Keeps the local fields and the energy incrementally: O(n) per step on
    a dense problem, O(max_deg) on a sparse one.

    A step is a `draw` (one site and one uniform per chain, from the
    generator) and a pure `update` given them, so the update can be held
    against the JAX step fed the draws JAX takes from its key. Plain torch
    on every device: the JAX package has no Pallas kernel for it.

    Faults: field noise perturbs the drawn site's field for the decision
    only; a stuck site or a dropped update keeps the old spin (delta 0),
    so the incremental fields and energy stay exact."""

    problem_kinds = ("dense", "sparse")

    lambda0: float = 1.0

    def init(self, problem, generator, s0=None, n_chains=1, faults=None) -> KernelState:
        """Initial state (stuck sites at their values) with incremental
        fields and energy."""
        dev = problem.device
        if s0 is None:
            s0 = random_init(generator, (n_chains, problem.n), device=dev)
        if faults is not None:
            s0 = faults.apply_stuck(s0)
        nbr = problem.nbr_idx.long() if isinstance(problem, SparseIsing) else None
        return KernelState(
            s=s0, t=torch.zeros((s0.shape[0],), dtype=torch.float32, device=dev),
            e=problem.energy(s0), aux=LocalFields(problem.local_fields(s0), nbr),
        )

    def draw(self, problem, state, generator, beta=None, faults=None) -> tuple:
        """(site, uniform, eta, keep) per chain: the step's random numbers,
        the fault draws last (`_fault_draws`; beta unused)."""
        B, dev = state.s.shape[0], state.s.device
        i = torch.randint(0, problem.n, (B,), generator=generator, device=dev)
        u = torch.rand((B,), generator=generator, device=dev)
        return (i, u, *_fault_draws(faults, generator, (B,)))

    def update(self, problem, state, beta, i, u, eta=None, keep=None, stuck=None) -> KernelState:
        """Resample site i[c] of chain c from its conditional at beta[c],
        given the uniform u[c], the field noise eta[c], the keep flag
        keep[c] and the (n,) stuck mask (None: no such fault)."""
        s, h = state.s, state.aux.h
        hi = _at(h, i)
        p_up = glauber.prob_up(beta * (hi if eta is None else hi + eta))
        new_si = torch.where(u < p_up, 1.0, -1.0)
        suppress = None if keep is None else ~keep
        if stuck is not None:
            suppress = stuck[i] if suppress is None else suppress | stuck[i]
        if suppress is not None:
            new_si = torch.where(suppress, _at(s, i), new_si)
        delta = new_si - _at(s, i)
        # dE for changing s_i by delta: delta * h_i (h is the raw, beta-free
        # field including b and the full J row)
        e = state.e + delta * hi
        h = _apply_field_delta(problem, h, i, delta, state.aux.nbr)
        s = s.scatter(1, i[:, None], new_si[:, None])
        return KernelState(s=s, t=state.t + 1.0 / self.lambda0, e=e,
                           aux=LocalFields(h, state.aux.nbr))

    def step(self, problem, state, generator, beta, faults=None) -> KernelState:
        """One random-scan update of every chain."""
        return self.update(problem, state, beta, *self.draw(problem, state, generator, beta, faults),
                           stuck=_stuck(faults))


# Total-rate floor for the CTMC (`event_tree.RATE_FLOOR`, which the event
# kernel's plain version reads too).
RATE_FLOOR = event_tree.RATE_FLOOR

# site_draw="auto" switches to the sum-tree draw at this problem size (as
# in the JAX package, which keeps the scan draw's random stream below it).
TREE_SITE_DRAW_MIN_N = 64

# Event-block size "auto" unrolling picks for the tree path on big problems
# (see CTMC.preferred_unroll).
CTMC_TREE_BLOCK_EVENTS = 2
CTMC_TREE_BLOCK_MIN_N = 512


class CTMCAux(NamedTuple):
    """The CTMC's kernel-private state, (n_chains, ...) tensors.

    h:         incremental local fields.
    tree:      the rate tree (tree draw; None on the scan draw and under
               `backend="cuda"`, whose kernel builds each chain's tree in
               shared memory and keeps none, as nothing reads it later): the
               tree the last event was drawn from, or, when carried, the
               current state's rates at tree_beta.
    tree_beta: the beta of each row's carried tree (sparse tree draw, when
               `init` was given the run's constant beta); None where every
               event draws from a fresh build.
    nbr:       nbr_idx as int64 (sparse problems; else None).
    """

    h: torch.Tensor
    tree: Optional[torch.Tensor]
    tree_beta: Optional[torch.Tensor]
    nbr: Optional[torch.Tensor]


@register_kernel("ctmc")
@dataclasses.dataclass(frozen=True)
class CTMC:
    """Exact event-driven continuous-time Glauber dynamics (Gillespie/SSA).
    One step = one flip event per chain: an Exp(sum_i lambda_i) waiting
    time, a site drawn proportionally to lambda_i = lambda0 * sigma(2 beta
    h_i s_i). The embedded chain is statistically exact — the fidelity
    reference for tau-leap and the hardware. Incremental fields: O(n) per
    event on a dense problem.

    site_draw selects the event selection (statistically identical laws,
    different random streams):

      "scan" — Gumbel-max over log(rates): one Gumbel per site per event
          (`jax.random.categorical`'s draw). log(rates) has no additive
          floor, so the draw stays exactly proportional however small the
          rates get; all-zero rates degenerate to site 0, which the
          aliveness test discards.
      "tree" — the `event_tree` sum tree: ONE uniform and an O(log n)
          descent. The tree is built at the step's beta before every draw.
      "auto" — "tree" for n >= TREE_SITE_DRAW_MIN_N, else "scan".

    On a SparseIsing the tree path can be incremental: after a flip at
    site i only i and its <= max_deg neighbours change rate. When `init` is
    given the beta every step will take (`run()` does so when each chain's
    schedule is constant), the tree is built once at that beta and carried:
    each event draws from it and then repairs it in place at those leaves
    and their root paths — O(max_deg log n) per event, no O(n) pass. The
    repair recomputes each path node from its children (`event_tree.
    repair_`), so the carried tree equals a fresh build of the current
    rates bit for bit, and the carried and the rebuilding path draw the
    same events. The JAX package decides per event instead (`lax.cond(beta
    == tree_beta)`, under its vmap over chains a select that evaluates both
    branches) and adds leaf deltas along the paths (`event_tree.
    update_many`), whose root drifts from the rates' sum over a long run.

    Below RATE_FLOOR total rate a chain is frozen: the dwell denominator is
    clamped AND the flip suppressed, on both draw paths.

    A step is a `draw` (the site draw and one Exp(1) per chain) and an
    `update` given them: on the tree path the draw is a uniform per chain,
    on the scan path the site index itself. The update is pure except on a
    carried tree, which it repairs in place (the state it returns holds the
    same tensor). The JAX package has no Pallas kernel for it.

    `backend="cuda"` runs each event of all chains as ONE call of
    `ops.ctmc_event` (the hand-written kernel on CUDA tensors, its plain
    version on CPU tensors), bit for bit the rebuilding tree path above,
    from the same two draws. It takes a float32 `DenseIsing` under the tree
    draw whose tree fits a block's shared memory (`ctmc_event.MAX_LEAVES`
    leaves) and no fault model; `backends_for` offers it there alone,
    `backend="auto"` leaves it out under a fault model (`fault_backends`),
    and `cuda_refusal` says why not elsewhere.

    Faults perturb the rate table the event is drawn from: stuck rates are
    zero wherever rates are computed (the init build, every build, the
    carried tree's repair), so the tree stays a build of the masked rates;
    field noise enters the rates' fields (a noisy run never carries the
    tree: `run()` decides so on the host); a dropped event flips nothing
    but still advances model time. The carried h and e track the true
    fields of the state."""

    backends = ("ref", "cuda")
    fault_backends = ("ref",)  # the backends that take a fault model
    problem_kinds = ("dense", "sparse")

    lambda0: float = 1.0
    site_draw: str = "auto"  # "scan" | "tree" | "auto"
    backend: str = "ref"  # "ref" | "cuda"

    def cuda_refusal(self, problem) -> Optional[str]:
        """Why the event kernel cannot run this problem (None: it can)."""
        if isinstance(problem, SparseIsing):
            return ("the event kernel ctmc_event takes dense couplings; the sparse CTMC "
                    "carries and repairs its tree between events, which has no CUDA route")
        if problem.J.dtype != torch.float32:
            return f"the event kernel ctmc_event takes float32 couplings, not {problem.J.dtype}"
        if self.resolved_site_draw(problem) != "tree":
            return ("the event kernel ctmc_event draws the site from a sum tree; "
                    "site_draw='scan' (a Gumbel-max over n uniforms) has no CUDA route")
        return ctmc_event.leaves_refusal(problem.n)

    def backends_for(self, problem=None) -> tuple[str, ...]:
        """Backends valid for this kernel/problem pair: "cuda" where the
        event kernel takes the problem (`cuda_refusal`)."""
        if problem is None or self.cuda_refusal(problem) is None:
            return self.backends
        return ("ref",)

    def resolved_site_draw(self, problem) -> str:
        """The concrete draw mechanism for this problem size."""
        if self.site_draw not in ("scan", "tree", "auto"):
            raise ValueError(
                f"site_draw must be 'scan' | 'tree' | 'auto', got {self.site_draw!r}"
            )
        if self.site_draw == "auto":
            return "tree" if problem.n >= TREE_SITE_DRAW_MIN_N else "scan"
        return self.site_draw

    def preferred_unroll(self, problem) -> int:
        """Event-block size for run(unroll="auto"): CTMC_TREE_BLOCK_EVENTS
        on big tree-draw problems, 1 elsewhere (the JAX rule)."""
        if (
            self.resolved_site_draw(problem) == "tree"
            and problem.n >= CTMC_TREE_BLOCK_MIN_N
        ):
            return CTMC_TREE_BLOCK_EVENTS
        return 1

    def carries_tree(self, problem) -> bool:
        """Whether `init(..., beta=)` makes this problem's tree incremental:
        the tree draw on a SparseIsing."""
        return isinstance(problem, SparseIsing) and self.resolved_site_draw(problem) == "tree"

    def _scaled(self, p: torch.Tensor) -> torch.Tensor:
        """lambda0 * p (x * 1.0 is x: the default rate skips the pass)."""
        return p if self.lambda0 == 1.0 else self.lambda0 * p

    def rates(self, problem, s, h, beta, stuck=None) -> torch.Tensor:
        """(B, n) flip rates lambda0 * sigma(2 beta_c h_ci s_ci), 0 where
        `stuck` ((n,) bool, optional)."""
        r = self._scaled(glauber.flip_prob(beta[:, None] * h, s))
        return r if stuck is None else torch.where(stuck, 0.0, r)

    def init(self, problem, generator, s0=None, n_chains=1,
             beta: Optional[torch.Tensor] = None, faults=None) -> KernelState:
        """Initial state (stuck sites at their values, their rates 0) with
        fields and, on the tree path, a rate tree.

        `beta` ((n_chains,), optional) promises that every step will be
        given it; where `carries_tree(problem)`, the tree is then built at
        it and carried (class docstring). Otherwise the tree is built at
        beta = 1 as in the JAX package, and each step builds its own; under
        `backend="cuda"` no tree is built (CTMCAux), and a problem the
        kernel cannot take or a fault model raises."""
        if self.backend not in self.backends:
            raise ValueError(f"backend must be 'ref' | 'cuda', got {self.backend!r}")
        if self.backend == "cuda":
            reason = self.cuda_refusal(problem)
            if reason is not None:
                raise ValueError(f"kernel 'ctmc' cannot run backend 'cuda' here: {reason}")
            if faults is not None:
                raise NotImplementedError(
                    "the event kernel ctmc_event takes no fault operands (stuck rates, field "
                    "noise, dropped events): run a fault model under backend='ref'")
        dev = problem.device
        if s0 is None:
            s0 = random_init(generator, (n_chains, problem.n), device=dev)
        if faults is not None:
            s0 = faults.apply_stuck(s0)
        h = problem.local_fields(s0)
        sparse = isinstance(problem, SparseIsing)
        tree = tree_beta = None
        if self.resolved_site_draw(problem) == "tree" and self.backend != "cuda":
            if beta is not None and self.carries_tree(problem):
                tree_beta = beta.to(device=dev, dtype=torch.float32).expand(s0.shape[0]).clone()
            at = tree_beta if tree_beta is not None else torch.ones(
                (s0.shape[0],), dtype=torch.float32, device=dev)
            tree = event_tree.build(self.rates(problem, s0, h, at, _stuck(faults)))
        return KernelState(
            s=s0, t=torch.zeros((s0.shape[0],), dtype=torch.float32, device=dev),
            e=problem.energy(s0),
            aux=CTMCAux(h, tree, tree_beta, problem.nbr_idx.long() if sparse else None),
        )

    def draw(self, problem, state, generator, beta, faults=None) -> tuple:
        """(site draw, Exp(1), eta, keep) per chain: Exp(1), then a uniform
        on the tree path or, on the scan path, one uniform per site, then
        the fault draws (`_fault_draws`: eta per site, keep per chain); the
        scan path's site is the Gumbel-max over the log-rates of the noisy
        fields, 0 at stuck sites."""
        B, dev = state.s.shape[0], state.s.device
        expo = torch.empty((B,), dtype=torch.float32, device=dev).exponential_(
            generator=generator)
        if self.resolved_site_draw(problem) == "tree":
            site = torch.rand((B,), generator=generator, device=dev)
            return (site, expo, *_fault_draws(faults, generator, state.s.shape, (B,)))
        u = torch.rand((B, problem.n), generator=generator, device=dev)
        eta, keep = _fault_draws(faults, generator, state.s.shape, (B,))
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        h = state.aux.h if eta is None else state.aux.h + eta
        rates = self.rates(problem, state.s, h, beta, _stuck(faults))
        return torch.argmax(torch.log(rates) + gumbel, dim=1), expo, eta, keep

    def update(self, problem, state, beta, site, expo, eta=None, keep=None,
               stuck=None) -> KernelState:
        """One Gillespie event per chain given its site draw, Exp(1), field
        noise eta, keep flag and the (n,) stuck mask (None: no such
        fault). On a carried tree `beta` must be its tree_beta (`init`),
        and eta None. Under `backend="cuda"` one `ops.ctmc_event` call, with
        no fault operand."""
        s, aux = state.s, state.aux
        if self.backend == "cuda":
            if eta is not None or keep is not None or stuck is not None:
                raise NotImplementedError("the event kernel ctmc_event takes no fault operands")
            s, h, e, t = ops.ctmc_event(s, aux.h, state.e, state.t, problem.J, beta, expo, site,
                                        self.lambda0)
            return KernelState(s=s, t=t, e=e, aux=aux._replace(h=h))
        h = aux.h
        h_draw = h if eta is None else h + eta  # the fields the event is drawn from
        if self.resolved_site_draw(problem) == "scan":
            i = site
            total = torch.sum(self.rates(problem, s, h_draw, beta, stuck), dim=1)
        elif aux.tree_beta is not None:
            return self._carried_tree_update(problem, state, beta, site, expo, keep, stuck)
        else:
            # a scheduled beta rescales every leaf, and on dense couplings
            # every field changes per event: build before every draw
            tree = event_tree.build(self.rates(problem, s, h_draw, beta, stuck))
            total = event_tree.total(tree)
            i = torch.clamp(event_tree.descend(tree, site), max=problem.n - 1)
            aux = aux._replace(tree=tree)
        alive = total > RATE_FLOOR
        if keep is not None:
            alive = alive & keep
        dt = expo / torch.clamp(total, min=RATE_FLOOR)
        delta = torch.where(alive, -2.0 * _at(s, i), 0.0)
        e = state.e + delta * _at(h, i)
        h = _apply_field_delta(problem, h, i, delta, aux.nbr)
        s = s.scatter_add(1, i[:, None], delta[:, None])
        return KernelState(s=s, t=state.t + dt, e=e, aux=aux._replace(h=h))

    def _carried_tree_update(self, problem: SparseIsing, state, beta, u, expo, keep=None,
                             stuck=None) -> KernelState:
        """One event drawn from the carried tree, which is then repaired in
        place: O(max_deg log n), no O(n) pass.

        After the flip only site i and its neighbours changed rate: their
        leaves are set to the new rates and their root paths recomputed
        from the children (`event_tree.repair_`), so the tree stays `build`
        of the current rates bit for bit. Padded neighbour slots alias site
        i and carry its own new rate, so no degree mask is needed. The
        reference adds leaf deltas along the paths (`update_many`, with a
        degree mask) and its root drifts from the rates' sum as the total
        falls; the draws and the model time read that root. Stuck leaves are
        repaired to 0; a dropped event (keep False) repairs nothing that
        changed."""
        s, aux = state.s, state.aux
        h, nbr, tree = aux.h, aux.nbr, aux.tree
        total = event_tree.total(tree)  # a view: read before the repair
        i = torch.clamp(event_tree.descend(tree, u), max=problem.n - 1)
        alive = total > RATE_FLOOR
        if keep is not None:
            alive = alive & keep
        dt = expo / torch.clamp(total, min=RATE_FLOOR)
        delta = torch.where(alive, -2.0 * _at(s, i), 0.0)
        e = state.e + delta * _at(h, i)
        h = _apply_field_delta(problem, h, i, delta, nbr)
        s = s.scatter_add(1, i[:, None], delta[:, None])
        affected = torch.cat([i[:, None], nbr[i]], dim=1)  # (B, 1 + max_deg)
        new_rates = self._scaled(glauber.flip_prob(
            beta[:, None] * h.gather(1, affected), s.gather(1, affected)))
        if stuck is not None:
            new_rates = torch.where(stuck[affected], 0.0, new_rates)
        event_tree.repair_(tree, affected, new_rates)
        return KernelState(s=s, t=state.t + dt, e=e, aux=aux._replace(h=h))

    def step(self, problem, state, generator, beta, faults=None) -> KernelState:
        """One Gillespie event of every chain."""
        return self.update(problem, state, beta, *self.draw(problem, state, generator, beta, faults),
                           stuck=_stuck(faults))


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
    diagnostics: RunDiagnostics when run(..., diagnostics=True) — per-chain
              flip counters, Welford energy mean/variance and first-hit
              step index collected inside the step loop (see
              `repro_torch.core.diagnostics`); None otherwise.
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


def _resolve_backend(backend: Optional[str], kernel=None, problem=None,
                     faults=None) -> Optional[str]:
    """Resolve a requested backend against what `kernel` supports.

    An explicit "cuda" request on a kernel with no CUDA path raises
    ValueError. "auto" picks "cuda" when the problem lives on a CUDA device
    and the kernel has a CUDA path that takes `faults` (the residual fault
    model, if any: a kernel's `fault_backends`, every backend by default),
    "ref" otherwise."""
    if backend is None:
        return None
    if backend not in ("ref", "cuda", "auto"):
        raise ValueError(f"backend must be 'ref' | 'cuda' | 'auto', got {backend!r}")
    supported = ("ref", "cuda") if kernel is None else kernel_backends(kernel, problem)
    if backend == "auto":
        on_cuda = problem is not None and problem.device.type == "cuda"
        if faults is not None:
            supported = getattr(kernel, "fault_backends", supported)
        return "cuda" if on_cuda and "cuda" in supported else "ref"
    if backend not in supported:
        name = getattr(kernel, "name", type(kernel).__name__)
        refusal = getattr(kernel, "cuda_refusal", None) if backend == "cuda" else None
        reason = None if refusal is None or problem is None else refusal(problem)
        raise ValueError(
            f"kernel {name!r} does not support backend {backend!r}"
            + ("" if reason is None else f" here: {reason}")
            + f"; supported backends: {supported}"
        )
    return backend


def _resolve_unroll(unroll, kernel, problem) -> int:
    """Resolve the event-block size as the JAX driver does: "auto" asks the
    kernel (CTMC blocks events on big problems), an int is validated and
    used as-is. The port's graph blocks do not depend on it."""
    if unroll == "auto":
        fn = getattr(kernel, "preferred_unroll", None)
        return fn(problem) if fn is not None else 1
    if not isinstance(unroll, int) or isinstance(unroll, bool) or unroll < 1:
        raise ValueError(f"unroll must be 'auto' or an int >= 1, got {unroll!r}")
    return unroll


class _Carry(NamedTuple):
    """What the step loop carries from block to block (rows = chains)."""

    state: KernelState
    t_hit: torch.Tensor
    hit: torch.Tensor
    acc: Optional[diag.DiagAcc]
    pos: torch.Tensor  # () int64: the index of the next step (row of betas)
    k: torch.Tensor  # (1,) int64: the index of the next recorded sample


class _Run:
    """One `run()` call: all chains as the rows of every step.

    The steps run in blocks (`graph_loop.plan_blocks`, at most GRAPH_STEPS
    steps each); a block gathers its betas by the device step counter,
    records samples at its fixed offsets, and tracks first-hit and
    diagnostics on the device, so no step waits on the host. On a CUDA
    problem the blocks are replays of captured CUDA graphs
    (`graph_loop.StepLoop`); on CPU tensors they run eagerly. Both run the
    same operations in the same order. `timeit`'s two passes share the
    loop: the second replays the graphs the first captured; so does a later
    `run()` call that takes this run from the store of kept runs, after
    `renew` has taken its inputs. The energy of the first-hit check, the
    diagnostics and the recorded samples is what the kernel's `energy_fn`
    offers (`ColoredGibbs`'s cuda backend: the sparse energy kernel), else
    `problem.energy`, chosen wherever the run takes a problem. `init_beta`,
    when given, is passed to the kernel's `init` (each chain's constant
    beta). `faults`, a residual FaultModel or None, is passed to the
    kernel's `init` and `step` only when it is not None. `eager=True` runs a
    CUDA problem's blocks eagerly too (no graph): for comparing the two.

    The run draws from a generator of its own, the one its graphs register:
    an int seed seeds it; a caller's torch.Generator has its state copied
    in when the run takes the seed, and each pass's final state copied back
    to it, so the caller's stream advances as if the pass drew from it.

    The blocks read the caller's problem (`source`) until a renewal brings
    another problem object: the run then clones that one into tensors of
    its own (`problem`), and copies every later call's values into them."""

    def __init__(self, call: "_Call", seed, eager: bool = False):
        dev = call.problem.device
        self.kernel, self.s0 = call.kernel, call.s0
        self._adopt(call.problem)
        self.source, self.versions = call.problem, _versions(call.problem)
        self.generator = torch.Generator(device=dev)
        self.take_seed(seed)
        self.betas, self.e_target = call.betas, call.e_target
        self.n_steps, self.sample_every, self.n_chains = call.n_steps, call.sample_every, call.n_chains
        self.track_hit, self.diagnostics = call.track_hit, call.diagnostics
        self.init_kw = {} if call.init_beta is None else {"beta": call.init_beta}
        self.step_kw = {} if call.faults is None else {"faults": call.faults}
        self.init_kw.update(self.step_kw)
        self.blocks = plan_blocks(self.n_steps, self.sample_every, GRAPH_STEPS)
        self.n_samples = self.n_steps // self.sample_every if self.sample_every > 0 else 0
        self.offsets = torch.arange(GRAPH_STEPS, device=dev)
        # the loop holds the run weakly: a finished run, its graphs and their
        # memory go when the run does, not at a cyclic collection (which
        # could fall inside another run's capture)
        this = weakref.ref(self)
        self.loop = StepLoop(lambda *args: this().block(*args), self.generator, dev,
                             dev.type == "cuda" and not eager)
        self.reload = False  # the next pass loads the loop's constants (`StepLoop.start`)
        self.samples = self.times = self.energies = None  # made at the first pass
        self.final_state: Optional[KernelState] = None  # the last pass's, for checks

    def _adopt(self, problem) -> None:
        """Read `problem` from now on, and its energy (class docstring)."""
        self.problem = problem
        energy_fn = getattr(self.kernel, "energy_fn", None)
        offered = None if energy_fn is None else energy_fn(problem)
        self.energy = problem.energy if offered is None else offered

    def take_seed(self, seed) -> None:
        """Draw from `seed` from the next pass on (class docstring); a seed
        `_check_seed` refuses changes nothing."""
        _check_seed(seed, self.generator.device)
        if isinstance(seed, torch.Generator):
            self.caller = seed
            self.generator.set_state(seed.get_state())
        else:
            self.caller = None
            self.generator.manual_seed(seed)
        self.gen_start = self.generator.get_state()

    def renew(self, call: "_Call", seed) -> bool:
        """Take the inputs of a later call of this run's key (`_kept_key`):
        its seed, its s0, and its betas and first-hit target, copied into
        the tensors the captured blocks index; and, where the call brings
        another problem object or edited the one before, that problem's
        values (class docstring) after the finite-energy probe, with the
        constants the next pass loads. Returns whether it did the latter.
        A seed or problem it refuses raises before anything changes."""
        problem, versions = call.problem, _versions(call.problem)
        renewed = problem is not self.source or versions != self.versions
        if renewed:
            _check_finite(problem)
        self.take_seed(seed)
        if renewed:
            if self.problem is not self.source:
                for name, x in _tensors(problem):
                    getattr(self.problem, name).copy_(x)
            elif problem is not self.source:
                self._adopt(dataclasses.replace(
                    problem, **{name: x.clone() for name, x in _tensors(problem)}))
                self.loop.forget()
            self.source, self.versions, self.reload = problem, versions, True
        self.s0 = call.s0
        self.betas.copy_(call.betas)
        self.e_target.copy_(call.e_target)
        if call.init_beta is not None:
            self.init_kw["beta"] = call.init_beta
        return renewed

    def block(self, carry: _Carry, steps: int, records: tuple) -> _Carry:
        """`steps` steps of every chain, recording the state after the
        steps at `records`: the body the loop runs eagerly or captures."""
        problem, kernel = self.problem, self.kernel
        state, t_hit, hit, acc, pos, k = carry
        betas = self.betas.index_select(0, pos + self.offsets[:steps])
        for j in range(steps):
            new = kernel.step(problem, state, self.generator, betas[j], **self.step_kw)
            e = new_hit = None
            if self.track_hit or self.diagnostics:
                e = new.e if new.e is not None else self.energy(new.s)
            if self.track_hit:
                new_hit = (e <= self.e_target) & ~hit
                t_hit = torch.where(new_hit, new.t, t_hit)
                hit = hit | new_hit
            if self.diagnostics:
                n_flipped = (new.s != state.s).flatten(1).sum(1)
                acc = diag.acc_update(acc, n_flipped, e, new_hit)
            if j in records:
                self.samples.index_copy_(1, k, new.s.unsqueeze(1))
                self.times.index_copy_(1, k, new.t.unsqueeze(1))
                if self.energies is not None:
                    self.energies.index_copy_(1, k, new.e.unsqueeze(1))
                k = k + 1
            state = new
        # new counters even where nothing was recorded (graph_loop docstring)
        return _Carry(state, t_hit, hit, acc, pos + steps, k + 0)

    def __call__(self) -> RunResult:
        """One full pass from the generator's starting state (every pass
        draws the same numbers): spans `sampler.init`, the loop's blocks,
        `sampler.results`."""
        problem, kernel = self.problem, self.kernel
        with tracing.span("sampler.init"):
            self.generator.set_state(self.gen_start)
            state = kernel.init(problem, self.generator, self.s0, self.n_chains, **self.init_kw)
            e0 = state.e if state.e is not None else self.energy(state.s)
            hit = (e0 <= self.e_target) & self.track_hit
            t_hit = torch.where(hit, 0.0, math.inf)
            acc = None
            if self.diagnostics:
                acc = diag.acc_init(e0, hit if self.track_hit else None)
            s, dev = state.s, state.s.device
            if self.samples is None:
                B, shape = self.n_chains, tuple(s.shape[1:])
                self.samples = torch.empty((B, self.n_samples) + shape, dtype=s.dtype, device=dev)
                self.times = torch.empty((B, self.n_samples), dtype=torch.float32, device=dev)
                if state.e is not None:  # kernels that keep e record it, as in JAX
                    self.energies = torch.empty((B, self.n_samples), dtype=e0.dtype, device=dev)
            pos = torch.zeros((), dtype=torch.int64, device=dev)
            k = torch.zeros((1,), dtype=torch.int64, device=dev)
            self.loop.start(_Carry(state, t_hit, hit, acc, pos, k), renew=self.reload)
            self.reload = False
        for steps, records in self.blocks:
            self.loop.run(steps, records)
        with tracing.span("sampler.results"):
            state, t_hit, hit, acc, _, _ = self.loop.result()
            self.final_state = state
            if self.caller is not None:
                self.caller.set_state(self.generator.get_state())
            # the buffers serve every pass (and the graphs): hand out copies
            samples, times = self.samples.clone(), self.times.clone()
            if self.energies is not None:
                energies = self.energies.clone()
            elif self.n_samples:
                energies = self.energy(samples)
            else:
                # e0 has the energy dtype both recording branches produce, not
                # the state dtype, so empty and sampled results concatenate
                energies = torch.zeros((self.n_chains, 0), dtype=e0.dtype, device=dev)
            return RunResult(
                s=state.s,
                t=state.t,
                samples=samples,
                times=times,
                energies=energies,
                t_hit=t_hit if self.track_hit else None,
                hit=hit if self.track_hit else None,
                diagnostics=None if acc is None else diag.acc_finalize(acc, math.prod(s.shape[1:])),
            )


def _check_seed(seed_or_generator, device: torch.device) -> None:
    """Refuse a seed that is neither an int nor a torch.Generator on the
    problem's device."""
    if isinstance(seed_or_generator, torch.Generator):
        if seed_or_generator.device.type != device.type:
            raise ValueError(
                f"generator is on {seed_or_generator.device}, the problem on {device}"
            )
    elif not isinstance(seed_or_generator, int) or isinstance(seed_or_generator, bool):
        raise TypeError(
            f"seed must be an int or a torch.Generator, got {type(seed_or_generator).__name__}"
        )


def _generator(seed_or_generator, device: torch.device) -> torch.Generator:
    """A torch.Generator on `device`: a fresh one seeded from an int, or the
    caller's own, which must live on the problem's device."""
    _check_seed(seed_or_generator, device)
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    return torch.Generator(device=device).manual_seed(seed_or_generator)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _first_chain(res: RunResult) -> RunResult:
    """A one-chain result without its chain dimension."""
    fields = [x[0] if isinstance(x, torch.Tensor) else x for x in res]
    if res.diagnostics is not None:
        fields[-1] = diag.RunDiagnostics(*(x[0] for x in res.diagnostics))
    return RunResult(*fields)


class _Call(NamedTuple):
    """`run()`'s arguments, validated: the problem (bound to the fault
    model), the kernel (its backend resolved), the residual faults, the
    inputs of one pass and the call's shape."""

    problem: Any
    kernel: Any
    faults: Optional[FaultModel]
    s0: Optional[torch.Tensor]
    betas: torch.Tensor  # (n_steps, n_chains): row i holds step i's betas
    e_target: torch.Tensor
    init_beta: Optional[torch.Tensor]
    n_steps: int
    n_chains: int
    sample_every: int
    track_hit: bool
    diagnostics: bool


def _check_samples(problem, kernel, n_chains: int, faults) -> None:
    """Raise unless a problem with per-sample couplings can run: under
    colored_gibbs, without a fault model, with n_chains a multiple of its
    samples (the rows sample-major)."""
    S = problem.n_samples
    if not isinstance(kernel, ColoredGibbs):
        name = getattr(kernel, "name", type(kernel).__name__)
        raise NotImplementedError(
            f"kernel {name!r} reads one (n, D) table of couplings; per-sample couplings of {S} "
            "disorder samples run under 'colored_gibbs' only")
    if faults is not None:
        raise NotImplementedError(
            "a fault model binds to one table of couplings; per-sample couplings of "
            f"{S} disorder samples run without one")
    if S < 1 or n_chains % S:
        raise ValueError(
            f"n_chains = {n_chains} is no multiple of the problem's {S} disorder samples: "
            f"the chains are sample-major, row r of sample r // (n_chains / {S})")


def _prepare(
    problem, kernel, *, n_steps, s0=None, schedule=None, n_chains=1, sample_every=0,
    first_hit=None, backend=None, unroll="auto", diagnostics=False, faults=None,
) -> _Call:
    """Validate `run()`'s arguments and make one pass's inputs; the
    finite-energy probe is `_check_finite`'s."""
    if isinstance(kernel, str):
        kernel = get_kernel(kernel)
    check_problem_kind(kernel, problem)
    if n_chains < 1:
        raise ValueError(f"n_chains must be >= 1, got {n_chains}")
    if isinstance(problem, SparseIsing) and problem.per_sample:
        _check_samples(problem, kernel, n_chains, faults)
    if hasattr(kernel, "resolved_site_draw"):
        kernel.resolved_site_draw(problem)  # validates site_draw
    _resolve_unroll(unroll, kernel, problem)  # validated as in JAX; the graph ignores it

    if faults is not None:
        if not isinstance(faults, FaultModel):
            raise TypeError(f"faults must be a repro_torch FaultModel, got {type(faults).__name__}")
        faults.validate(problem)
        problem, faults = faults.bind(problem)
    # resolved on the bound problem, against the fault model that is left
    resolved = _resolve_backend(backend, kernel, problem, faults)
    if resolved is not None and hasattr(kernel, "backend") and kernel.backend != resolved:
        kernel = dataclasses.replace(kernel, backend=resolved)
    dev = problem.device
    betas = resolve_schedule(schedule, n_steps, n_chains, device=dev)
    betas = betas.expand(n_chains, n_steps).T.contiguous()  # row i: step i's per-chain betas
    # A kernel that can carry state across steps of one beta (the sparse
    # tree CTMC) is told each chain's beta when it never changes and no
    # field noise redraws every rate: a host decision, made once here, so
    # no step branches on the device.
    init_beta = None
    carries = getattr(kernel, "carries_tree", None)
    if (n_steps and carries is not None and carries(problem)
            and (faults is None or not faults.noisy) and bool((betas == betas[:1]).all())):
        init_beta = betas[0]
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
    return _Call(problem, kernel, faults, s0, betas, e_target, init_beta, n_steps, n_chains,
                 sample_every, track_hit, diagnostics)


def _check_finite(problem) -> None:
    """The one host synchronisation of a new run: fail loudly on
    couplings/biases (or a fault model) that cannot produce finite energies
    before any sampling (of every disorder sample's, where per sample)."""
    rows = (problem.n_samples,) if getattr(problem, "per_sample", False) else ()
    e_probe = problem.energy(torch.ones(rows + state_shape(problem), device=problem.device))
    if not bool(torch.isfinite(e_probe).all()):
        raise NonFiniteEnergyError(
            f"problem energy is non-finite (probe energy {e_probe.tolist()}); "
            "check the couplings/biases (and any FaultModel) for NaN/Inf"
        )


def _build(call: _Call, seed, eager: bool = False) -> _Run:
    """A new `_Run` of a validated call, after the finite-energy probe."""
    _check_finite(call.problem)
    return _Run(call, seed, eager)


def _tensors(problem) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of each of a problem's tensor fields."""
    return [(f.name, x) for f in dataclasses.fields(problem)
            if isinstance(x := getattr(problem, f.name), torch.Tensor)]


def _versions(problem) -> tuple:
    """Each tensor field's version: it changes when the tensor is written."""
    return tuple(x._version for _, x in _tensors(problem))


def _make_run(problem, kernel, seed, *, eager=False, **kw) -> _Run:
    """Validate `run()`'s arguments (`_prepare`'s keywords) and build a new
    `_Run`: each call of the result is one pass, batched over chains; its
    `final_state` is the last pass's final KernelState (for checks of a
    kernel's private state). `eager=True` turns the CUDA graph off
    (`_Run`): run() never does."""
    return _build(_prepare(problem, kernel, **kw), seed, eager)


# The most runs `run()` keeps for later calls of their key (`_kept_key`).
KEPT_RUNS = 4
_kept: collections.OrderedDict = collections.OrderedDict()  # key -> _Run, least recent first
_kept_lock = threading.Lock()


def drop_kept_runs() -> None:
    """Free every run `run()` keeps: their CUDA graphs, the graphs' memory
    pools, and their carries and sample buffers."""
    with _kept_lock:
        _kept.clear()


def _kept_key(call: _Call, seed, faults) -> Optional[tuple[tuple, tuple]]:
    """The two keys a kept run may serve a call under, (identity, shape):
    what the run must share with the call beyond what `_Run.renew` takes
    in, that is everything that decides the blocks, and the problem.

    Both hold the device, the resolved kernel, n_steps, n_chains,
    sample_every, first-hit and diagnostics on or off, s0's dtype (or
    none), whether the kernel is told a constant beta, and whether the seed
    is an int or a caller's generator (not which: the run copies its state
    in). The identity key adds the problem object and its tensors'
    versions: a run whose carry holds a host value (`StepLoop.renewable`)
    serves only the problem it was built on, unchanged since. The shape key
    adds the problem's type, each tensor field's shape and dtype and its
    other fields: a run of a renewable carry takes in any such problem's
    values. None where the call keeps no run: with a fault model (bound
    anew every call), a kernel that is not a frozen dataclass, a seed
    neither an int nor a torch.Generator (`_check_seed` refuses it), or a
    problem tensor made under inference mode (it has no version)."""
    kernel, problem = call.kernel, call.problem
    if faults is not None or not (dataclasses.is_dataclass(kernel)
                                  and type(kernel).__dataclass_params__.frozen):
        return None
    if not isinstance(seed, (int, torch.Generator)) or isinstance(seed, bool):
        return None
    fields = [(f.name, getattr(problem, f.name)) for f in dataclasses.fields(problem)]
    tensors = [x for _, x in fields if isinstance(x, torch.Tensor)]
    if any(x.is_inference() for x in tensors):
        return None
    rest = (problem.device, kernel, isinstance(seed, torch.Generator), call.n_steps,
            call.n_chains, call.sample_every, call.track_hit, call.diagnostics,
            None if call.s0 is None else call.s0.dtype, call.init_beta is not None)
    shapes = tuple((name, x.shape, x.dtype) if isinstance(x, torch.Tensor) else (name, x)
                   for name, x in fields)
    return ((id(problem), tuple(x._version for x in tensors)) + rest,
            (type(problem), shapes) + rest)


def _take_kept(keys) -> Optional[_Run]:
    """The kept run of the identity key, else of the shape key, out of the
    store for the call (None: neither)."""
    if keys is None:
        return None
    with _kept_lock:
        for key in keys:
            one_run = _kept.pop(key, None)
            if one_run is not None:
                return one_run
    return None


def _keep(keys, one_run: _Run) -> None:
    """Keep `one_run` as the most recently used, under the shape key where
    its carry is renewable and the identity key where not, and free the
    least recently used beyond KEPT_RUNS: outside any capture, so no graph
    is freed inside one."""
    key = keys[1] if one_run.loop.renewable else keys[0]
    with _kept_lock:
        _kept[key] = one_run
        _kept.move_to_end(key)
        while len(_kept) > KEPT_RUNS:
            _kept.popitem(last=False)


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
    unroll: Union[int, str] = "auto",
    timeit: bool = False,
    diagnostics: bool = False,
    faults: Optional[FaultModel] = None,
) -> RunResult:
    """Run `n_steps` of `kernel` on `problem` — the single sampling driver.

    Runs on the device the problem's tensors live on; on a CUDA device the
    step loop runs as replays of captured CUDA graphs (`_Run`). While a torch
    profiler records, the call is a `sampler.run` span with the driver's
    phases inside it (`repro_torch.tracing`).

    Kept runs: after the call its run (its static carry, sample buffers and
    captured graphs) is kept, the KEPT_RUNS most recently used of them. A
    later call that matches one in everything that decides its blocks
    (`_kept_key`: the same device, resolved kernel, n_steps, n_chains,
    sample_every, first-hit on or off, diagnostics, s0 given or not (and
    its dtype), and an int seed or a torch.Generator, any one) and in its
    problem takes that run: its seed, s0, betas and target are renewed,
    and it runs without eager warm-up blocks and without a capture, every
    block a replay. The same problem object, none of its tensors changed
    in place since, runs without the finite-energy probe. Another problem
    of the same type and tensor shapes, or an edited one, is probed and
    its values copied into the run's own copy (`sampler.renewals`; the
    first such call clones the problem and captures anew); a kernel whose
    per-run data holds host values, such as the colour and lattice plans
    of the cuda sweeps, takes no other problem. A caller's generator's
    state is copied in, and the pass's final state back. Results are
    bit-identical to a new run's. A call with `faults` keeps no run (the
    model is bound to the problem anew every call). Kept runs hold their
    device memory (the graphs' pools, the carry, the sample buffers, the
    problem or its copy) until evicted or `drop_kept_runs()`.

    Args:
      problem: DenseIsing, LatticeIsing or SparseIsing (the port's; any
        other type raises TypeError).
      kernel: a SamplerKernel instance, or a registered kernel name.
      seed: an int (seeds a fresh torch.Generator on the problem's device)
        or a torch.Generator on that device; it draws the initial states
        and the per-step random numbers.
      n_steps: kernel steps (sweeps for the Gibbs sweeps, events for ctmc).
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
      unroll: the event-block size ("auto" or an int >= 1), validated and
        resolved as in the JAX package ("auto" asks the kernel's
        `preferred_unroll(problem)`), where it sets the steps of one
        `lax.scan` iteration. It does not change the port's graph: a
        captured block holds up to `graph_loop.GRAPH_STEPS` steps whatever
        unroll is. Results are bit-identical for every unroll.
      timeit: run twice (first-use pass, then a steady-state pass with the
        same random stream, identical results) and attach a RunTiming. The
        second pass replays the graphs the first captured; on a kept run
        both passes replay, and `compile_s` reads about 0.
      diagnostics: collect in-loop run diagnostics (per-chain flip
        counters, Welford energy mean/variance, first-hit step index) into
        `RunResult.diagnostics` as a `RunDiagnostics` (see
        `repro_torch.core.diagnostics`). Sampled values are identical with
        or without it; kernels without an incremental energy pay one
        energy (`problem.energy`, or the kernel's `energy_fn`) per step
        while it is on.
      faults: optional `repro_torch.core.faults.FaultModel` — device
        non-idealities (stuck spins, b-bit coupling quantization, field
        noise, update dropout; per-kernel semantics in that module).
        Validated on the host, then bound once: quantization rewrites the
        couplings, lattice stuck sites become clamps, and only the residual
        dynamic faults reach the kernels (their draws in the order the
        module docstring gives; the cuda sweeps and tau-leap launch their
        fault variants). None, or a model with every fault off, runs the
        exact fault-free program.
    """
    with tracing.span("sampler.run"):
        tracing.count("sampler.calls")
        with tracing.span("sampler.validate"):
            call = _prepare(
                problem, kernel, n_steps=n_steps, s0=s0, schedule=schedule, n_chains=n_chains,
                sample_every=sample_every, first_hit=first_hit, backend=backend, unroll=unroll,
                diagnostics=diagnostics, faults=faults,
            )
            keys = _kept_key(call, seed, faults)
            one_run = _take_kept(keys)
            if one_run is None:
                one_run = _build(call, seed)
            else:
                try:
                    renewed = one_run.renew(call, seed)
                except (TypeError, ValueError):  # a seed or problem refused before any change
                    _keep(keys, one_run)
                    raise
                tracing.count("sampler.reuses")
                if renewed:
                    tracing.count("sampler.renewals")
        if timeit:
            dev = problem.device
            _sync(dev)
            t0 = time.perf_counter()
            one_run()
            _sync(dev)
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = one_run()
            _sync(dev)
            wall_s = max(time.perf_counter() - t0, 1e-9)
            res = res._replace(timing=RunTiming(
                compile_s=max(0.0, first_s - wall_s),
                wall_s=wall_s,
                steps_per_s=n_steps / wall_s,
                chain_steps_per_s=n_steps * n_chains / wall_s,
            ))
        else:
            res = one_run()
        # the run goes back to the store, or, not kept, its graphs and their
        # memory pools go here, not as the frame ends
        with tracing.span("sampler.release"):
            if keys is not None:
                _keep(keys, one_run)
            del one_run
    return _first_chain(res) if n_chains == 1 else res
