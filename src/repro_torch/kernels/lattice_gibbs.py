"""CUDA kernels: fused chromatic Gibbs sweep on the king's-move lattice.

One sweep over the colour classes of every chain, all chains as the B rows
of one launch: per colour, the 8-neighbour stencil fields at that colour's
sites, sigma(-2*(beta*h)), the proposal from the colour's uniforms, the
update where colour and not frozen; then the clamp. Source
`csrc/lattice_gibbs.cu`, two kernels chosen by the lattice plan (below) and
counted apart in `repro_torch.tracing`: `launch.lattice_gibbs_sweep` and
`launch.lattice_gibbs_generic`.

Replaces the TPU kernel `repro/kernels/lattice_gibbs.py::lattice_gibbs_sweep`
(`_sweep_kernel`, the `pl.pallas_call` at line 102). The TPU kernel grids
over batch blocks, keeps the lattice and its weight planes in VMEM and
computes the whole field plane in every colour phase, because its vector
unit shifts whole planes. The JAX driver vmaps a B = 1 call per chain with
a scalar beta; here each row carries its own beta.

The TPU kernel is generic in its dtype; these take f32 or bf16, and in
bf16 round every add and multiply of the stencil to bf16, as torch and
XLA do.

What bounds it on the H100: at (B, H, W) = (4096, 16, 16) in f32 it must read s
(4.2 MB) and, since each site of a proper colouring is updated once, one
uniform per free site (4.2 MB), and write the new s (4.2 MB): about
12.6 MB, 3.8 µs at 3.35 TB/s (half in bf16). Its arithmetic (8
multiply-adds and one exp per site) is negligible. It is memory-bound. A
colour of the king colouring takes every other site of every other row,
so its uniforms touch every 32-byte sector of half the rows of its
(B, H, W) plane: 8.4 MB of sectors for the four colours, about 16.8 MB and
5.0 µs in all, is the floor of any kernel that reads the uniforms in the
(C, B, H, W) layout `torch.rand` draws them in.

What the designs do about it (`chip_ablate.py lattice`, `PERF.md`):

  lattice_gibbs_sweep  — the plan kernel, for masks whose lists are
      independent sets of the king graph (`LatticePlan.independent`; the
      king colouring of every `ChromaticGibbs` run), at most 4 colours of
      at most 1024 entries (`LatticePlan.threads`; lattices up to 64x64).
      A block updates its one chain in place in one int8 buffer in shared
      memory and walks only the plan's lists: thread t owns entry t of
      every colour (at 16x16 64 threads a block) and loads its uniforms
      before the chain, so the phases' device-memory trips overlap into
      one; each phase reads its weights from L1 and its neighbours from
      shared memory and ends in one barrier.
  lattice_gibbs_generic — any other masks (improper colourings, a mask
      holding every site) and longer lists: the first port's kernel, two
      buffers a block, each phase writing every site of the other, so every
      field sees the state before its phase, as in JAX.

The plan is built once per problem (`lattice_plan`, one wait for the
device) and records the tensors it was built from; the kernels take it
only with those (`check_plan`).

The fault variants (f32), chosen by their operands and counted apart
(`launch.lattice_gibbs_sweep_faults`, `launch.lattice_gibbs_generic_faults`): a
(B, H, W) per-row bias, the whole b + eta of field noise, read in place of
b and added last as b is, and a (B, H, W) keep mask (update dropout): a
site whose keep byte is 0 keeps its spin in every phase. Row r is then the
JAX call with b + eta_r and `colors & keep_r`. The plan stays the one of
the static b (`check_plan` refuses any other); the plan kernel loads a
thread's bias and keep entries with its uniforms, before the chain, and
does not write a kept site; the generic kernel copies a kept site's old
spin to the other buffer. At (4096, 16, 16) they read 4.2 MB of bias and
1 MB of keep more: about 17.8 MB, bound 5.3 µs.

The energy (`lattice_energy`, source `csrc/lattice_energy.cu`, counted as
`launch.lattice_energy`): 0.5 s.ns + b.s of every chain, `LatticeIsing.energy`'s
terms, each site's ns summed over KING_OFFSETS in order and every product
and add rounded on its own, so on finite values every term is the plain one
bit for bit; the sum over the sites runs in a fixed order of the kernel's
own (`energy_in_kernel_order`), which on +-1 states with integer couplings
gives the plain number exactly. It replaces no TPU kernel (the JAX energy is
plain jnp): it is `run()`'s first-hit, start and recorded energy under
`ChromaticGibbs(backend="cuda")`. It reads s once, 4.2 MB at (4096, 16, 16),
1.25 µs at 3.35 TB/s. Two routes (`energy_route`): lattices of up to
ENERGY_QUAD_SITES sites whose rows hold 4 to 128 sites, a power of 2 (CAL's
16x16), take the quad route: a warp sums a chain at a time, each lane holding
quads of 4 sites of a row and their weights in registers for every chain,
and taking the sites left and right of its quads from its neighbour lanes;
any other lattice takes a block a chain.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import tracing
from repro_torch.core.ising import KING_OFFSETS, shift2d
from repro_torch.kernels import _build
from repro_torch.kernels._checks import (MAX_SMEM_BYTES, check_cuda, check_fault_operands,
                                         check_tensor, fault_ptr as _ptr)
from repro_torch.kernels._order import block_sum, block_threads, in_turn, threads_in_turn, warp_tree
from repro_torch.kernels.ref import king_sum

DTYPES = (torch.float32, torch.bfloat16)  # as the TPU kernel, generic in its dtype

# The plan kernel's limits: a thread holds one entry of each of at most
# MAX_COLOURS colours, a block of at most MAX_THREADS threads walks one chain.
MAX_COLOURS = 4
MAX_THREADS = 1024
W_COLUMNS = 12  # a plan entry's f32 row: 8 weights, b, three zero pads
# The energy's quad route takes lattices of at most this many sites, two
# quads of 4 a lane (kQuadGroups in csrc/lattice_energy.cu), and rows of
# ENERGY_QUAD_WIDTHS sites: a row's quads, W / 4, divide a warp's 32 lanes.
ENERGY_QUAD_SITES = 256
ENERGY_QUAD_WIDTHS = (4, 8, 16, 32, 64, 128)


class LatticePlan(NamedTuple):
    """A lattice's colour masks as the plan kernel walks them.

    offsets: (C+1,) int32 — colour c's entries are offsets[c]:offsets[c+1].
    entry:   (L,) int32   — per entry site << 8 | edges: the site y*W + x,
             and bit k of `edges` set where the neighbour KING_OFFSETS[k]
             lies on the lattice.
    w:       (L, 12) f32  — the site's 8 weights in KING_OFFSETS order, 0
             for a neighbour beyond the edge, b, three zero pads (bf16
             operands are exact in f32).
    frozen:  (F,) int32   — the frozen sites, ascending.
    clamp:   (F,) f32     — their clamp values.
    counts:  the C list lengths, on the host.
    independent: on the host — no two king-adjacent sites share a list, so
             a phase's fields never read a site of that phase and the
             sweep may update in place. A caller may set it False (the
             two-buffer kernel is exact for any masks), never True.
    shape:   (H, W).
    threads: the plan kernel's threads a block (`plan_threads`): the
             longest list rounded up to a warp; 0 where it cannot walk the
             lists (more than MAX_COLOURS colours or MAX_THREADS entries).
    found_independent: `independent` as `lattice_plan` found it.
    source:  (tensor, version) of each of w, b, colors, frozen and
             clamp_value as the plan read them: the kernels take the plan
             only with these very tensors, unchanged since (`check_plan`).

    A colour lists its updated sites (colour and not frozen) in ascending
    order; a site in two masks is in both lists, an empty colour has an
    empty list."""

    offsets: torch.Tensor
    entry: torch.Tensor
    w: torch.Tensor
    frozen: torch.Tensor
    clamp: torch.Tensor
    counts: tuple
    independent: bool
    shape: tuple
    threads: int
    found_independent: bool
    source: tuple

    @property
    def sites(self) -> torch.Tensor:
        """(L,) the site of every entry, colour by colour."""
        return self.entry >> 8

    @property
    def edges(self) -> torch.Tensor:
        """(L,) the edge bits of every entry."""
        return self.entry & 0xFF


def lattice_plan(w: torch.Tensor, b: torch.Tensor, colors: torch.Tensor, frozen: torch.Tensor,
                 clamp_value: torch.Tensor) -> LatticePlan:
    """The plan of (C, H, W) colour masks and an (H, W) frozen mask (bool,
    or f32/bf16 {0,1} read as > 0.5) over (8, H, W) weights, (H, W) b and
    clamp values, on their device. Reads the masks on the host once (one
    wait for the device): build it once per problem, not per sweep, and
    pass the kernel these same tensors."""
    H, W = b.shape
    dev = b.device
    sel = colors.to(torch.float32) > 0.5
    fz = frozen.to(torch.float32) > 0.5
    upd = (sel & ~fz).cpu()
    fz = fz.cpu()
    C = upd.shape[0]
    # the 4 forward offsets cover every adjacent pair once
    independent = not any(bool((upd & shift2d(upd.to(torch.int8), dy, dx).bool()).any())
                          for dy, dx in KING_OFFSETS[4:])
    counts = upd.reshape(C, -1).sum(1)
    _, sites = upd.reshape(C, -1).nonzero(as_tuple=True)  # row-major: colour by colour, ascending
    y, x = sites // W, sites % W
    edges = torch.zeros_like(sites)
    for k, (dy, dx) in enumerate(KING_OFFSETS):
        on = (y + dy >= 0) & (y + dy < H) & (x + dx >= 0) & (x + dx < W)
        edges |= on.long() << k
    offsets = torch.zeros(C + 1, dtype=torch.int32)
    offsets[1:] = counts.cumsum(0)
    frozen_sites = fz.reshape(-1).nonzero()[:, 0]
    at = sites.to(dev)
    pw = torch.zeros((sites.shape[0], W_COLUMNS), dtype=torch.float32, device=dev)
    on = (edges[:, None] >> torch.arange(8) & 1).bool().to(dev)
    pw[:, :8] = torch.where(on, w.reshape(8, -1)[:, at].t().float(), 0.0)
    pw[:, 8] = b.reshape(-1)[at].float()
    source = tuple((t, t._version) for t in (w, b, colors, frozen, clamp_value))
    counts = tuple(counts.tolist())
    return LatticePlan(
        offsets.to(dev), ((sites << 8) | edges).to(torch.int32).to(dev), pw,
        frozen_sites.to(torch.int32).to(dev),
        clamp_value.reshape(-1)[frozen_sites.to(dev)].float(), counts,
        independent, (H, W), plan_threads(counts), independent, source)


def plan_threads(counts) -> int:
    """Threads a block of the plan kernel for lists of these lengths: the
    longest rounded up to a warp (32 at least), one entry of each colour a
    thread; 0 for more than MAX_COLOURS lists or one longer than
    MAX_THREADS, which the plan kernel cannot walk."""
    longest = max(counts, default=0)
    if len(counts) > MAX_COLOURS or longest > MAX_THREADS:
        return 0
    return max(32, -(-longest // 32) * 32)


def check_plan(plan: LatticePlan, w, b, colors, frozen, clamp_value) -> None:
    """Raise unless `plan` is `lattice_plan` of these very tensors, none of
    them changed in place since, with well-formed tables on their device."""
    if not isinstance(plan, LatticePlan):
        raise TypeError(f"plan must be a LatticePlan (lattice_gibbs.lattice_plan), got {type(plan)}")
    (H, W), C, dev = b.shape, colors.shape[0], b.device
    if (plan.shape, len(plan.counts)) != ((H, W), C):
        raise ValueError(f"the plan is of (H, W) = {plan.shape} and {len(plan.counts)} colours, "
                         f"the operands of {(H, W)} and {C}")
    names = ("w", "b", "colors", "frozen", "clamp_value")
    for name, x, (src, version) in zip(names, (w, b, colors, frozen, clamp_value), plan.source):
        if x is not src:
            raise ValueError(f"the plan was built from another {name}: build it with "
                             "lattice_plan from the tensors passed here")
        if x._version != version:
            raise ValueError(f"{name} changed in place after the plan was built: build it again")
    if plan.independent and not plan.found_independent:
        raise ValueError("the plan is marked independent, but lattice_plan found lists that are "
                         "not independent sets: the in-place sweep would be wrong for them")
    if plan.threads != plan_threads(plan.counts):
        raise ValueError(f"the plan's threads {plan.threads} are not plan_threads of its counts")
    L, F = sum(plan.counts), plan.frozen.numel()
    check_tensor("plan.offsets", plan.offsets, torch.int32, (C + 1,), dev)
    check_tensor("plan.entry", plan.entry, torch.int32, (L,), dev)
    check_tensor("plan.w", plan.w, torch.float32, (L, W_COLUMNS), dev)
    check_tensor("plan.frozen", plan.frozen, torch.int32, (F,), dev)
    check_tensor("plan.clamp", plan.clamp, torch.float32, (F,), dev)


def halo_bytes(W: int) -> int:
    """Shared memory before and after a plan block's chains (csrc
    `halo_bytes`): a neighbour beyond the edge stays inside the block."""
    return (W + 1 + 15) // 16 * 16


def _launch_plan(s, plan: LatticePlan, uniforms, beta, out, device, faults=None) -> None:
    """The plan kernel; `faults` = (bias_rows, keep), either None, takes
    the fault variant."""
    B, H, W = s.shape
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (s.data_ptr(), plan.offsets.data_ptr(), plan.entry.data_ptr(), plan.w.data_ptr(),
            uniforms.data_ptr(), beta.data_ptr(), plan.frozen.data_ptr(), plan.clamp.data_ptr(),
            out.data_ptr())
    dims = (B, H, W, len(plan.counts), plan.frozen.shape[0], plan.threads)
    if faults is None:
        code = _build.launcher("lattice_gibbs")(
            *args, *dims, int(s.dtype == torch.bfloat16), stream)
    else:
        code = _build.launcher("lattice_gibbs_faults")(
            *args, *map(_ptr, faults), *dims, stream)
    _build.check("lattice_gibbs_sweep", code)


def _launch_generic(s, w, b, uniforms, colors, frozen, clamp_value, beta, out, device,
                    faults=None) -> None:
    """The two-buffer kernel; `faults` as in `_launch_plan`."""
    B, H, W = s.shape
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (s.data_ptr(), w.data_ptr(), b.data_ptr(), uniforms.data_ptr(), colors.data_ptr(),
            frozen.data_ptr(), clamp_value.data_ptr(), beta.data_ptr(), out.data_ptr())
    dims = (B, H, W, colors.shape[0])
    if faults is None:
        code = _build.launcher("lattice_gibbs_generic")(
            *args, *dims, int(s.dtype == torch.bfloat16), stream)
    else:
        code = _build.launcher("lattice_gibbs_generic_faults")(
            *args, *map(_ptr, faults), *dims, stream)
    _build.check("lattice_gibbs_generic", code)


def lattice_gibbs_sweep(
    s: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    uniforms: torch.Tensor,
    colors: torch.Tensor,
    frozen: torch.Tensor,
    clamp_value: torch.Tensor,
    beta: torch.Tensor,
    plan: LatticePlan | None = None,
    bias_rows: torch.Tensor | None = None,
    keep: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch a CUDA kernel: (B,H,W) ±1 spins, (8,H,W) weight planes,
    (H,W) bias, (C,B,H,W) uniforms, (C,H,W) {0,1} colour masks, (H,W) {0,1}
    frozen mask and ±1 clamp values, all f32 or all bf16, and (B,) f32
    per-row beta, all contiguous on one sm_90 device -> new (B,H,W) spins
    of the operands' dtype in a fresh tensor. In bf16 the fields round as
    the plain version's do (`ref.lattice_fields_ref`). `plan` is
    `lattice_plan` of these very w, b and masks (`check_plan`); without one
    the call builds it (and waits for the device once). Independent lists
    that the plan kernel can walk (`LatticePlan.threads`) take it, any
    others the generic one. `bias_rows` ((B,H,W) f32) and `keep` ((B,H,W)
    bool or uint8), either optional, take the route's fault variant (f32
    only; module docstring)."""
    operands = {"s": s, "w": w, "b": b, "uniforms": uniforms, "colors": colors,
                "frozen": frozen, "clamp_value": clamp_value}
    dtype = s.dtype
    if dtype not in DTYPES or any(t.dtype != dtype for t in operands.values()):
        raise ValueError(
            "the sweep takes its seven operands all float32 or all bfloat16, got "
            + ", ".join(f"{name} {t.dtype}" for name, t in operands.items())
        )
    dev = check_cuda(s)
    if s.ndim != 3:
        raise ValueError(f"s must be (B, H, W), got shape {tuple(s.shape)}")
    B, H, W = s.shape
    C = colors.shape[0] if colors.ndim == 3 else -1
    shapes = {"s": (B, H, W), "w": (8, H, W), "b": (H, W), "uniforms": (C, B, H, W),
              "colors": (C, H, W), "frozen": (H, W), "clamp_value": (H, W)}
    for name, t in operands.items():
        check_tensor(name, t, dtype, shapes[name], dev)
    check_tensor("beta", beta, torch.float32, (B,), dev)
    faults = check_fault_operands(s, bias_rows, keep, dev)
    if faults is not None and dtype != torch.float32:
        raise ValueError(f"the fault variants take float32 operands, got {dtype}")
    if plan is None:
        plan = lattice_plan(w, b, colors, frozen, clamp_value)
    check_plan(plan, w, b, colors, frozen, clamp_value)
    in_place = plan.independent and plan.threads > 0
    smem = H * W + 2 * halo_bytes(W) if in_place else 2 * H * W
    if smem > MAX_SMEM_BYTES:
        held = ("an int8 copy of a chain between two halos" if in_place else
                "two int8 copies of a chain: the two-buffer kernel, for masks that are not "
                "independent sets or lists the plan kernel cannot walk")
        raise ValueError(f"a {H}x{W} lattice needs {smem} bytes of shared memory per block "
                         f"({held}); the card allows {MAX_SMEM_BYTES}")
    out = torch.empty((B, H, W), dtype=dtype, device=dev)
    if B == 0 or H * W == 0:
        return out
    variant = () if faults is None else (faults,)  # the base kernels' launch calls unchanged
    if in_place:
        _launch_plan(s, plan, uniforms, beta, out, dev, *variant)
        name = "lattice_gibbs_sweep"
    else:
        _launch_generic(s, w, b, uniforms, colors, frozen, clamp_value, beta, out, dev, *variant)
        name = "lattice_gibbs_generic"
    tracing.count(f"launch.{name}_faults" if variant else f"launch.{name}")
    return out


def energy_route(s: torch.Tensor, H: int, W: int) -> str:
    """The energy kernel's route for (..., H, W) states `s`: "quads" where
    rows of W sites split into quads that a warp's lanes hold (W in
    ENERGY_QUAD_WIDTHS), the lattice has at most ENERGY_QUAD_SITES sites and
    s starts on 16 bytes (its quads load as one 16-byte word), else "block"."""
    quads = (W in ENERGY_QUAD_WIDTHS and H * W <= ENERGY_QUAD_SITES
             and s.data_ptr() % 16 == 0)
    return "quads" if quads else "block"


def energy_in_kernel_order(s, w, b, route: str | None = None) -> torch.Tensor:
    """What the energy kernel returns, bit for bit on finite values, in
    plain torch on any device: `LatticeIsing.energy`'s terms s_p ns_p and
    b_p s_p of (..., H, W) f32 states, summed over the sites in the order of
    `route` (default `energy_route`). "quads": lane l of a warp adds its
    quads' sites 4 l .. 4 l + 3, then 4 (l + 32) .. 4 (l + 32) + 3, in
    turn (+0 past n), then the warp's shuffle tree. "block": thread t of a block of
    `block_threads(n)` adds sites t, t + T, ... in turn, then each warp's
    tree and the warps in turn. Both halve the pair sum and add the bias
    sum last. The tests and chip_smoke.py hold the kernel against it."""
    H, W = b.shape
    n = H * W
    route = energy_route(s, H, W) if route is None else route
    rows = s.reshape(-1, H, W).to(torch.float32)
    terms = ((rows * king_sum(rows, w)).reshape(-1, n), (b * rows).reshape(-1, n))
    if route == "quads":
        sums = []
        for p in terms:  # (rows, lane's quad, lane, site of the quad) -> a lane's sites in turn
            p = torch.nn.functional.pad(p, (0, ENERGY_QUAD_SITES - n)).reshape(-1, 2, 32, 4)
            lanes = p.permute(0, 1, 3, 2).reshape(-1, 8, 32)
            sums.append(warp_tree(in_turn(lanes)))
    elif route == "block":
        sums = [block_sum(threads_in_turn(p, block_threads(n))) for p in terms]
    else:
        raise ValueError(f"no energy route {route!r}")
    return (0.5 * sums[0] + sums[1]).reshape(s.shape[:-2])


def _launch_energy(s, w, b, out, route: str, device) -> None:
    """The energy kernel over the (R, H, W) chains of s (R, H W >= 1)."""
    H, W = b.shape
    code = _build.launcher("lattice_energy")(
        s.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), out.shape[0], H, W,
        int(route == "quads"), torch.cuda.current_stream(device).cuda_stream)
    _build.check("lattice_energy", code)


def lattice_energy(s: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: (..., H, W) f32 states (contiguous; any
    finite values, not only +-1), (8, H, W) f32 weight planes and (H, W)
    f32 bias, contiguous on one sm_90 device -> (...) f32 energies
    0.5 * sum_p s_p ns_p + sum_p b_p s_p: `LatticeIsing.energy`'s terms,
    summed over the sites in a fixed order (`energy_in_kernel_order`), on a
    lattice of any size. One launch on the current stream, no host sync, so
    a CUDA graph captures it."""
    if s.ndim < 2:
        raise ValueError(f"s must be (..., H, W), got shape {tuple(s.shape)}")
    dev = check_cuda(s)
    H, W = s.shape[-2:]
    check_tensor("s", s, torch.float32, tuple(s.shape), dev)
    check_tensor("w", w, torch.float32, (8, H, W), dev)
    check_tensor("b", b, torch.float32, (H, W), dev)
    lead = tuple(s.shape[:-2])
    out = torch.empty((math.prod(lead),), dtype=torch.float32, device=dev)
    if out.shape[0] == 0 or H * W == 0:
        return out.zero_().view(lead)
    _launch_energy(s, w, b, out, energy_route(s, H, W), dev)
    tracing.count("launch.lattice_energy")
    return out.view(lead)
