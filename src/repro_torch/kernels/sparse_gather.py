"""CUDA kernels for sparse (neighbor-list) Ising problems.

Three kernels over the padded `SparseIsing` layout (`repro_torch.core.sparse`),
each route's launches counted apart in `repro_torch.tracing` under the
names below (`launch.<name>`):

  sparse_fields        — local fields h = gather(s, nbr_idx) . nbr_w + b.
                         Source `csrc/sparse_fields.cu`, two kernels chosen
                         by n (below): `sparse_fields`, `sparse_fields_global`.
  colored_gibbs_sweep  — one chromatic Gibbs sweep over all colour classes,
                         driven by a colour plan (below); two kernels chosen
                         by n (`sweep_kernel`): `colored_gibbs_sweep`,
                         one chain a block in shared memory while 2n bytes
                         fit one (n <= 116224, `csrc/colored_gibbs.cu`),
                         and `colored_gibbs_sweep_long`, the long-row sweep
                         beyond (`csrc/colored_gibbs_long.cu`).
  sparse_energy        — the energy 0.5 s.h + b.s of every row, h the
                         fields without b (`csrc/sparse_energy.cu`); two
                         routes chosen by n (`energy_kernel`):
                         `sparse_energy`, `sparse_energy_long`. It
                         replaces no TPU kernel (the JAX
                         `SparseIsing.energy` is plain jnp): it is
                         `run()`'s first-hit and recorded energy under
                         `ColoredGibbs(backend="cuda")`.

All sum a site's slots in order through `csrc/sparse_gather.cuh`, as
`ref.sparse_fields_ref` does, so the fields and sweeps equal their plain
versions bit for bit, and so does every term of the energy; the energy's
sum over the sites runs in a fixed order of its own (no atomics), which on
+-1 states with integer couplings gives the plain number exactly.

Replaces the TPU kernels `repro/kernels/sparse_gather.py::sparse_fields`
(`_fields_kernel`, the `pl.pallas_call` at line 90) and
`::colored_gibbs_sweep` (`_sweep_kernel`, the `pl.pallas_call` at line 126).
The TPU kernels grid over batch blocks and hold the whole neighbour tables
in VMEM; the JAX driver vmaps a B = 1 sweep per chain with a scalar beta,
here each row carries its own beta.

What bounds them on the H100, at (B, n) = (256, 16384), D = 3, C = 4 (the
greedy colouring of `random_3regular_maxcut(16384, 0)`: classes of 6147,
5997, 3807 and 433 sites):
  sparse_fields reads s (16.8 MB) and the tables (0.5 MB) and writes h
  (16.8 MB): about 34 MB, 10 µs at 3.35 TB/s.
  colored_gibbs_sweep reads s, one uniform per site (a proper colouring
  updates each site once: 16.8 MB of the (C, B, n) uniforms) and the
  tables (0.7 MB with the masks), and writes the new s: about 51 MB,
  15 µs. But a phase's sites are spread over the index space, so its
  uniforms touch 90%, 94%, 68% and 16% of the 32-byte sectors of the
  phase's plane: 45 MB of sectors, so about 79 MB and 24 µs is the floor
  of any kernel that reads the uniforms in the JAX layout.
Their arithmetic is negligible: both are memory-bound.

What the designs do about it:
  sparse_fields stages R whole rows of s in shared memory (R * 4n bytes)
  and walks their sites, loading each site's table entry once for the R
  rows: the tables are read B/R times, and the random gathers hit shared
  memory instead of a 32-byte sector each. Rows of n > 58112 sites do not
  fit one block (227 KB): they take the one-thread-per-output kernel that
  gathers through the cache, `sparse_fields_global`. The choice is by n
  (`fields_rows`), never a fallback.
  colored_gibbs_sweep keeps one chain a block in shared memory (int8, two
  buffers: 2n bytes, two blocks an SM) and walks, in each phase, only that
  colour's entries of a colour plan (`colour_plan`): contiguous table
  rows, one 16-byte load of indices and one of weights per site at D <= 3.
  It reads no masks and gathers from shared memory; the new spins go to
  the second buffer and are copied back after a barrier, so every phase
  sees the state before it for any masks. The plan records the tables and
  masks it was built from, and the kernel takes it only with those.

Rows of n > 116224 sites (2n bytes no longer fit a block) take the
long-row sweep, `colored_gibbs_sweep_long`; the choice is by n, never a
fallback. At (B, n) = (64, 512000), D = 6, C = 2 (the 3D EA glass at
L = 80, its two parity classes) the work its inputs need is
4 (3 B n + 2 n D + n + C n + B) = 423.9 MB, 126.5 µs at 3.35 TB/s (its
0.59 GFLOP take 8.8 µs); with parity classes every sector of a phase's
uniform plane is touched, so about 555 MB, 165.7 µs, is the floor in the
JAX layout. Neither the plan (32 MB) nor a chain (1 MB of int8, 131 MB of
f32 state) fits a block, so the chains live in an int8 scratch in device
memory, site major (row i: site i of every chain, 32.8 MB, within L2): a
pack launch (a transpose), one launch per colour that updates the scratch
in place (one thread per plan entry and 16 chains, so a plan row is read
once for many chains and a neighbour's 16 chains come in one 16-byte load),
and an unpack launch, all on the caller's stream, so a CUDA graph captures
the sweep with no host sync. In place is exact only where the classes are
independent sets (each site in at most one, no edge inside one): every
plan records whether its classes are (`ColourPlan.independent`), and at
these rows the wrapper refuses any other plan, and fault operands, with the
reason.

The energy reads s once and the tables once: at (256, 16384), D = 3,
17.2 MB, 5.1 µs at 3.35 TB/s; at (320, 512000), D = 6, 682 MB, 203.6 µs.
Rows of n <= 58112 sites take `sparse_energy`: a block stages R whole rows
in shared memory (`fields_rows`, as `sparse_fields` does), gathers from
there and sums its rows itself, one launch. Longer rows take
`sparse_energy_long`: a block stages a tile of ENERGY_TILE sites of 16
rows, gathers a neighbour from the tile or else through the cache, and
writes each row's sums over the tile to a (B, tiles, 2) scratch that a
second launch sums in tile order.

Disorder samples (`SparseIsing` with (S, n, D) couplings over one (n, D)
neighbour table, its B rows sample-major: row r of sample r // (B / S)) take
routes of their own, counted apart: the sweep `colored_gibbs_sweep_samples`
(`colored_gibbs.cu`: the shared-memory sweep, its block reading row r's
sample's weights from a per-sample plan whose `w` is (S, L, P), plan rows
of P = 8 as two 16-byte loads of each; one launch for all B rows) and the
energy `sparse_energy_samples` (`sparse_energy.cu`: a row a block, gathered
through the cache at any n, summed in the staged kernel's order at one row
a block; one launch). At (512, 32768), D = 6,
C = 2, S = 128 (the 3D EA glass at L = 32, 128 samples x 4 replicas) the
sweep's inputs are 4 (3 B n + n D + S n D + n + C n + B) = 303.2 MB, 90.5
us at 3.35 TB/s; the plan's per-sample weights are 134 MB, so a sample's 1
MB is read by its replicas' neighbouring blocks, through L2. Rows of
n > 116224 sites (the long-row sweep) and fault operands have no
per-sample route: both raise NotImplementedError.

The sweep's fault variant, chosen by its operands and counted apart as
`launch.colored_gibbs_sweep_faults`: a (B, n) per-row bias, the whole b + eta of
field noise, read with the uniforms in place of the plan's b_i, and a
(B, n) keep mask (update dropout): where 0 a phase writes the old spin, so
the site keeps it. Row r is the JAX call with b + eta_r and masks & keep_r;
the plan stays the one of the static b. At (256, 16384) it reads 16.8 MB
of bias and 4.2 MB of keep more: about 72 MB, bound 21.5 µs.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import math
from typing import NamedTuple

import torch

from repro_torch import tracing
from repro_torch.core.sparse import check_sample_rows, gather_sum
from repro_torch.kernels import _build
from repro_torch.kernels._checks import (MAX_SMEM_BYTES, check_cuda, check_fault_operands,
                                         check_tensor, fault_ptr as _ptr)
from repro_torch.kernels._order import (BLOCK_THREADS,  # noqa: F401 (chip_ablate.py reads it here)
                                        block_sum, block_threads, threads_in_turn, warp_tree)

# Rows a fields block stages, at most (chip_ablate.py times 1, 2 and 3 rows,
# and 256, 512 and BLOCK_THREADS threads a block).
FIELDS_MAX_ROWS = 3
# Sites of a tile of the long-row energy, and the threads of its block
# (kTile, kTileThreads in csrc/sparse_energy.cu).
ENERGY_TILE = 1024
ENERGY_TILE_THREADS = 256
# The kernels index s with int32 within a launch: the energy launches over
# chunks of fewer than INDEX_LIMIT elements, the other kernels refuse more.
INDEX_LIMIT = 2**31


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fields_rows(B: int, n: int, sms: int) -> int:
    """Rows a block of `sparse_fields` stages: enough blocks to cover the
    card's `sms` SMs, at most FIELDS_MAX_ROWS and what fits in one block's
    shared memory; 0 when not one row fits (n > 58112): the global kernel."""
    fit = MAX_SMEM_BYTES // (4 * n)
    return min(FIELDS_MAX_ROWS, fit, max(1, -(-B // sms)))


def sweep_kernel(n: int) -> str:
    """The sweep kernel that takes rows of n sites: the shared-memory
    "colored_gibbs_sweep" while two int8 copies of a chain fit one block
    (2n <= MAX_SMEM_BYTES: n <= 116224), else "colored_gibbs_sweep_long"."""
    return "colored_gibbs_sweep" if 2 * n <= MAX_SMEM_BYTES else "colored_gibbs_sweep_long"


def energy_kernel(n: int, samples: bool = False) -> str:
    """The energy kernel that takes rows of n sites: with per-sample
    couplings "sparse_energy_samples" at any n; else "sparse_energy" while
    a row of f32 fits one block's shared memory (4n <= MAX_SMEM_BYTES:
    n <= 58112), else "sparse_energy_long"."""
    if samples:
        return "sparse_energy_samples"
    return "sparse_energy" if 4 * n <= MAX_SMEM_BYTES else "sparse_energy_long"


def energy_in_kernel_order(s, nbr_idx, nbr_w, b, kernel: str | None = None) -> torch.Tensor:
    """What the energy kernel returns, bit for bit on any values, in plain
    torch on any device: `SparseIsing.energy`'s terms s_i h_i and b_i s_i,
    summed over the sites in the order of `kernel` (default
    `energy_kernel(n, per-sample nbr_w)`). "sparse_energy", and
    "sparse_energy_samples" on per-sample couplings: thread t of a block of
    `block_threads(n)` adds sites t, t + T, ... in turn, then the block
    (each warp's shuffle tree, the warps in turn). "sparse_energy_long": the
    same over each tile of ENERGY_TILE sites with ENERGY_TILE_THREADS
    threads, then lane l of a row's warp adds tiles l, l + 32, ... in turn,
    then its tree. Both halve the pair sum and add the bias sum last. The
    tests and chip_smoke.py hold the kernels against it."""
    n = s.shape[-1]
    kernel = energy_kernel(n, nbr_w.ndim == 3) if kernel is None else kernel
    rows = s.reshape(-1, n).to(torch.float32)
    terms = (rows * gather_sum(rows, nbr_idx, nbr_w), b * rows)
    if kernel in ("sparse_energy", "sparse_energy_samples"):
        sums = [block_sum(threads_in_turn(p, block_threads(n))) for p in terms]
    elif kernel == "sparse_energy_long":
        tiles = -(-n // ENERGY_TILE)
        sums = []
        for p in terms:
            p = torch.nn.functional.pad(p, (0, tiles * ENERGY_TILE - n))
            part = block_sum(threads_in_turn(p.reshape(-1, ENERGY_TILE), ENERGY_TILE_THREADS))
            sums.append(warp_tree(threads_in_turn(part.reshape(rows.shape[0], tiles), 32)))
    else:
        raise ValueError(f"no energy kernel {kernel!r}")
    return (0.5 * sums[0] + sums[1]).reshape(s.shape[:-1])


class ColourPlan(NamedTuple):
    """The colour classes of a sparse problem as the sweep kernel walks them.

    offsets: (C+1,) int32 — colour c's entries are offsets[c]:offsets[c+1].
    idx:     (L, P) int32 — per entry the D neighbour indices, pads, and
             the entry's site in the last column.
    w:       (L, P) f32   — the D couplings, zero pads, and b_site last;
             (S, L, P) of per-sample couplings (S, n, D), each sample's.
    counts:  the C list lengths, on the host.
    n, D:    the problem's sites and neighbour slots.
    independent: whether the classes are independent sets
             (`independent_classes`): the long-row kernel (`sweep_kernel`)
             updates a phase in place and takes only such a plan; the
             shared-memory kernel reads each phase's state from a second
             buffer and takes any.
    source:  (tensor, version) of each of nbr_idx, nbr_w, b and masks as
             the plan read them: the kernel takes the plan only with these
             very tensors, unchanged since (`check_plan`).

    P is the least multiple of 4 above D, so an entry is 16 bytes of each
    at D <= 3. A colour lists its sites in ascending order; a site in two
    masks is in both lists, an empty colour has an empty list."""

    offsets: torch.Tensor
    idx: torch.Tensor
    w: torch.Tensor
    counts: tuple
    n: int
    D: int
    independent: bool
    source: tuple

    @property
    def sites(self) -> torch.Tensor:
        """(L,) the site of every entry, colour by colour."""
        return self.idx[:, -1]

    @property
    def per_sample(self) -> bool:
        """Whether the weights are per disorder sample, (S, L, P)."""
        return self.w.ndim == 3

    @property
    def n_samples(self) -> int:
        """Disorder samples S: the leading axis of per-sample weights, else 1."""
        return self.w.shape[0] if self.per_sample else 1


def colour_plan(nbr_idx: torch.Tensor, nbr_w: torch.Tensor, b: torch.Tensor,
                masks: torch.Tensor) -> ColourPlan:
    """The colour plan of (C, n) masks (bool, or f32 with a site in colour c
    where masks[c] > 0.5) over the (n, D) tables, on the tables' device;
    over (S, n, D) per-sample couplings its `w` is each sample's, (S, L, P).
    Waits for the device once (the lists' lengths and whether the classes
    are independent sets): build it once per problem, not per sweep, and
    pass the kernel these same tensors."""
    n, D = nbr_idx.shape
    sel = masks.to(torch.float32) > 0.5
    counts = sel.sum(1)
    _, sites = sel.nonzero(as_tuple=True)  # row-major: colour by colour, sites ascending
    P = (D // 4 + 1) * 4
    offsets = torch.zeros(sel.shape[0] + 1, dtype=torch.int32, device=nbr_idx.device)
    offsets[1:] = counts.cumsum(0)
    idx = sites.to(torch.int32)[:, None].repeat(1, P)  # pads and the last column: the site
    idx[:, :D] = nbr_idx[sites]
    lead = tuple(nbr_w.shape[:-2])  # (S,) per sample
    w = torch.zeros(lead + (sites.shape[0], P), dtype=torch.float32, device=nbr_idx.device)
    w[..., :D] = nbr_w[..., sites, :]
    w[..., -1] = b[sites]
    source = tuple((x, x._version) for x in (nbr_idx, nbr_w, b, masks))
    independent = independent_classes(nbr_idx, sel)
    *counts, independent = torch.cat([counts, independent[None].to(counts.dtype)]).tolist()
    return ColourPlan(offsets, idx, w, tuple(counts), n, D, bool(independent), source)


def independent_classes(nbr_idx: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Whether the (C, n) bool classes `sel` over the (n, D) tables are
    independent sets, as a bool scalar on their device: each site in at
    most one class, and no slot in range names another site of the site's
    own class (a pad names the site itself)."""
    n = nbr_idx.shape[0]
    if sel.shape[0] == 0:
        return torch.ones((), dtype=torch.bool, device=nbr_idx.device)
    cls = torch.where(sel.any(0), sel.to(torch.int32).argmax(0), -1)  # -1: in no class
    j = nbr_idx.long()
    slot = (j != torch.arange(n, device=j.device)[:, None]) & (j >= 0) & (j < n)
    inside = slot & (cls[j.clamp(0, max(n - 1, 0))] == cls[:, None]) & (cls[:, None] >= 0)
    return ~((sel.sum(0) > 1).any() | inside.any())


def _check_tables(s, nbr_idx, nbr_w, b):
    """(dev, B, n, D, per_sample) of the shared operands, per_sample
    whether the couplings are (S, n, D), one table per disorder sample;
    raise unless they fit the kernels. The caller checks that its rows are
    whole samples."""
    dev = check_cuda(s)
    if s.ndim != 2 or nbr_idx.ndim != 2:
        raise ValueError(
            f"s must be (B, n) and nbr_idx (n, D), got {tuple(s.shape)} and "
            f"{tuple(nbr_idx.shape)}"
        )
    B, n = s.shape
    D = nbr_idx.shape[1]
    per_sample = nbr_w.ndim == 3
    check_tensor("s", s, torch.float32, (B, n), dev)
    check_tensor("nbr_idx", nbr_idx, torch.int32, (n, D), dev)
    check_tensor("nbr_w", nbr_w, torch.float32, ((nbr_w.shape[0],) if per_sample else ()) + (n, D), dev)
    check_tensor("b", b, torch.float32, (n,), dev)
    if B * n >= INDEX_LIMIT or n * D >= INDEX_LIMIT:
        raise ValueError(f"(B, n, D) = ({B}, {n}, {D}) overflows the kernels' int32 indexing")
    return dev, B, n, D, per_sample


def check_samples_route(n: int, S: int, faults: bool = False) -> None:
    """Raise NotImplementedError where per-sample couplings of S samples
    have no sweep: rows of n > 116224 sites (the long-row sweep) or fault
    operands."""
    if sweep_kernel(n) == "colored_gibbs_sweep_long":
        raise NotImplementedError(
            f"n = {n} sites take the long-row sweep (two int8 copies of a chain, {2 * n} bytes, "
            f"exceed a block's {MAX_SMEM_BYTES} of shared memory), which reads one (n, D) "
            f"table of couplings: no per-sample route for {S} disorder samples at this n")
    if faults:
        raise NotImplementedError(
            "the sweep's fault variant (field noise, update dropout) reads one (n, D) table of "
            f"couplings: no per-sample route for {S} disorder samples")


def check_plan(plan: ColourPlan, nbr_idx, nbr_w, b, masks) -> None:
    """Raise unless `plan` is `colour_plan` of these very tensors, none of
    them changed in place since, with well-formed tables on their device."""
    if not isinstance(plan, ColourPlan):
        raise TypeError(f"plan must be a ColourPlan (sparse_gather.colour_plan), got {type(plan)}")
    (n, D), C, dev = nbr_idx.shape, masks.shape[0], nbr_idx.device
    if (plan.n, plan.D, len(plan.counts)) != (n, D, C):
        raise ValueError(f"the plan is of (n, D, C) = ({plan.n}, {plan.D}, {len(plan.counts)}), "
                         f"the operands of ({n}, {D}, {C})")
    for name, x, (src, version) in zip(("nbr_idx", "nbr_w", "b", "masks"),
                                       (nbr_idx, nbr_w, b, masks), plan.source):
        if x is not src:
            raise ValueError(f"the plan was built from another {name}: build it with "
                             "colour_plan from the tensors passed here")
        if x._version != version:
            raise ValueError(f"{name} changed in place after the plan was built: build it again")
    L, P = sum(plan.counts), (D // 4 + 1) * 4
    check_tensor("plan.offsets", plan.offsets, torch.int32, (C + 1,), dev)
    check_tensor("plan.idx", plan.idx, torch.int32, (L, P), dev)
    check_tensor("plan.w", plan.w, torch.float32, tuple(nbr_w.shape[:-2]) + (L, P), dev)
    if L >= 2**31 or plan.w.numel() >= INDEX_LIMIT:
        raise ValueError(f"a plan of {L} entries of {P} overflows the kernel's int32 offsets")


def _launch_fields(s, nbr_idx, nbr_w, b, out, rows: int, threads: int, device) -> None:
    B, n = s.shape
    code = _build.launcher("sparse_fields")(
        s.data_ptr(), nbr_idx.data_ptr(), nbr_w.data_ptr(), b.data_ptr(), out.data_ptr(),
        B, n, nbr_idx.shape[1], rows, threads, torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check("sparse_fields", code)


def _launch_sweep(s, plan: ColourPlan, uniforms, beta, out, threads: int, device,
                  faults=None) -> None:
    """The sweep kernel; `faults` = (bias_rows, keep), either None, takes
    the fault variant."""
    B, n = s.shape
    args = (s.data_ptr(), plan.offsets.data_ptr(), plan.idx.data_ptr(), plan.w.data_ptr(),
            uniforms.data_ptr(), beta.data_ptr(), out.data_ptr())
    dims = (B, n, plan.D, plan.idx.shape[1], len(plan.counts), threads,
            torch.cuda.current_stream(device).cuda_stream)
    if faults is None:
        code = _build.launcher("colored_gibbs")(*args, *dims)
    else:
        code = _build.launcher("colored_gibbs_faults")(*args, *map(_ptr, faults), *dims)
    _build.check("colored_gibbs_sweep", code)


def _launch_sweep_samples(s, plan: ColourPlan, uniforms, beta, out, threads: int,
                          device) -> None:
    """The per-sample sweep: the shared-memory kernel with row r's weights
    those of sample r // (B / S) in the plan's (S, L, P) `w`."""
    B, n = s.shape
    code = _build.launcher("colored_gibbs_samples")(
        s.data_ptr(), plan.offsets.data_ptr(), plan.idx.data_ptr(), plan.w.data_ptr(),
        uniforms.data_ptr(), beta.data_ptr(), out.data_ptr(), B, n, plan.D, plan.idx.shape[1],
        len(plan.counts), threads, B // plan.n_samples, plan.w[0].numel(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check("colored_gibbs_sweep_samples", code)


def _launch_sweep_long(s, plan: ColourPlan, uniforms, beta, out, device) -> None:
    """The long-row sweep: pack, a launch per colour, unpack, over an int8
    scratch copy of the chains, site major with the chains padded to 16."""
    B, n = s.shape
    C = len(plan.counts)
    st = torch.empty((n, -(-B // 16) * 16), dtype=torch.int8, device=device)
    offsets = (ctypes.c_int * (C + 1))(*itertools.accumulate(plan.counts, initial=0))
    code = _build.launcher("colored_gibbs_long")(
        s.data_ptr(), st.data_ptr(), out.data_ptr(), plan.idx.data_ptr(), plan.w.data_ptr(),
        uniforms.data_ptr(), beta.data_ptr(), offsets, B, n, plan.D, plan.idx.shape[1], C,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check("colored_gibbs_sweep_long", code)


def _launch_energy(s, nbr_idx, nbr_w, b, part, out, rows: int, threads: int, device) -> None:
    """The energy kernels: `rows` > 0 the staged one, 0 the long-row pair
    over the (B, tiles, 2) scratch `part`."""
    B, n = s.shape
    code = _build.launcher("sparse_energy")(
        s.data_ptr(), nbr_idx.data_ptr(), nbr_w.data_ptr(), b.data_ptr(),
        None if part is None else part.data_ptr(), out.data_ptr(), B, n, nbr_idx.shape[1], rows,
        threads, 0 if part is None else part.shape[1],
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check("sparse_energy", code)


def _launch_energy_samples(s, nbr_idx, nbr_w, b, out, rows_per_sample: int, first: int,
                           device) -> None:
    """The per-sample energy: a row a block, row r (of the whole batch, the
    launch's first being `first`) with sample (first + r) // rows_per_sample's
    couplings."""
    B, n = s.shape
    code = _build.launcher("sparse_energy_samples")(
        s.data_ptr(), nbr_idx.data_ptr(), nbr_w.data_ptr(), b.data_ptr(), out.data_ptr(), B, n,
        nbr_idx.shape[1], block_threads(n), rows_per_sample, first,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check("sparse_energy_samples", code)


def sparse_energy(
    s: torch.Tensor, nbr_idx: torch.Tensor, nbr_w: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Launch the CUDA kernel: (..., n) f32 values (contiguous; any values,
    not only +-1) and the tables of `sparse_fields` -> (...) f32 energies
    0.5 * sum_i s_i h_i + sum_i b_i s_i, h_i the in-order slot sum without
    b: `SparseIsing.energy`'s terms, summed over the sites in a fixed order.
    Rows of n <= 58112 sites go to the staged kernel, longer ones to the
    long-row pair (`energy_kernel`); per-sample (S, n, D) couplings, the
    flattened rows sample-major (s's leading axis a multiple of S), to
    `sparse_energy_samples`. Each launch takes fewer than
    INDEX_LIMIT elements of s, so a larger block of rows (a whole run's
    samples) is launched in chunks of rows, each counted. Launched on the
    current stream with no host sync; its scratch comes from `torch.empty`,
    so a CUDA graph captures it."""
    if s.ndim < 1:
        raise ValueError("s must be (..., n), got a 0-d tensor")
    if not s.is_contiguous():
        raise ValueError("s must be contiguous")
    lead = tuple(s.shape[:-1])
    flat = s.view(math.prod(lead), s.shape[-1])
    if nbr_w.ndim == 3:
        check_sample_rows(s, nbr_w.shape[0])
    chunk = max(1, (INDEX_LIMIT - 1) // max(1, flat.shape[1]))
    dev, _, n, _, _ = _check_tables(flat[:chunk], nbr_idx, nbr_w, b)  # every chunk is as the first
    B = flat.shape[0]
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0 or n == 0:
        return out.zero_().view(lead)
    kernel = energy_kernel(n, nbr_w.ndim == 3)
    part = (None if kernel != "sparse_energy_long" else
            torch.empty((min(B, chunk), -(-n // ENERGY_TILE), 2), dtype=torch.float32, device=dev))
    for r0 in range(0, B, chunk):
        rows = flat[r0:r0 + chunk]
        if kernel == "sparse_energy_samples":
            _launch_energy_samples(rows, nbr_idx, nbr_w, b, out[r0:r0 + chunk],
                                   B // nbr_w.shape[0], r0, dev)
        elif kernel == "sparse_energy":
            _launch_energy(rows, nbr_idx, nbr_w, b, None, out[r0:r0 + chunk],
                           fields_rows(rows.shape[0], n, _sm_count(dev)), block_threads(n), dev)
        else:
            _launch_energy(rows, nbr_idx, nbr_w, b, part[:rows.shape[0]], out[r0:r0 + chunk], 0,
                           0, dev)
        tracing.count(f"launch.{kernel}")
    return out.view(lead)


def sparse_fields(
    s: torch.Tensor, nbr_idx: torch.Tensor, nbr_w: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Launch the CUDA kernel: (B,n) f32 values, (n,D) int32 neighbour
    indices in [0, n), (n,D) f32 couplings and (n,) f32 bias, all contiguous
    on one sm_90 device -> (B,n) f32 fields. Rows of n <= 58112 sites go to
    the staged kernel, longer ones to the global one (`fields_rows`)."""
    dev, B, n, D, per_sample = _check_tables(s, nbr_idx, nbr_w, b)
    if per_sample:
        raise NotImplementedError(
            "sparse_fields takes one (n, D) table of couplings: it has no per-sample route "
            f"for {nbr_w.shape[0]} disorder samples' (S, n, D)")
    out = torch.empty((B, n), dtype=torch.float32, device=dev)
    if B == 0 or n == 0:
        return out
    rows = fields_rows(B, n, _sm_count(dev))
    _launch_fields(s, nbr_idx, nbr_w, b, out, rows, block_threads(n), dev)
    tracing.count("launch.sparse_fields" if rows else "launch.sparse_fields_global")
    return out


def colored_gibbs_sweep(
    s: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_w: torch.Tensor,
    b: torch.Tensor,
    uniforms: torch.Tensor,
    masks: torch.Tensor,
    beta: torch.Tensor,
    plan: ColourPlan | None = None,
    bias_rows: torch.Tensor | None = None,
    keep: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel: the operands of `sparse_fields` plus (C,B,n)
    f32 uniforms, (C,n) f32 {0,1} colour masks and (B,) f32 per-row beta
    -> new (B,n) f32 spins in a fresh tensor. `plan` is `colour_plan` of
    these very tables and masks (`check_plan`); without one the call
    builds it (and waits for the device once). `bias_rows` ((B,n) f32)
    and `keep` ((B,n) bool or uint8), either optional, take the fault
    variant (module docstring). Rows of n > 116224 sites go to the
    long-row kernel (`sweep_kernel`), which takes no fault operands and
    only a plan of independent classes. Per-sample (S, n, D) couplings,
    B a multiple of S and the rows sample-major, take the per-sample
    kernel, at n <= 116224 and without fault operands."""
    dev, B, n, D, per_sample = _check_tables(s, nbr_idx, nbr_w, b)
    C = masks.shape[0] if masks.ndim == 2 else -1
    check_tensor("masks", masks, torch.float32, (C, n), dev)
    check_tensor("uniforms", uniforms, torch.float32, (C, B, n), dev)
    check_tensor("beta", beta, torch.float32, (B,), dev)
    faults = check_fault_operands(s, bias_rows, keep, dev)
    long_rows = sweep_kernel(n) == "colored_gibbs_sweep_long"
    if per_sample:
        check_sample_rows(s, nbr_w.shape[0])
        check_samples_route(n, nbr_w.shape[0], faults is not None)
    if long_rows and faults is not None:
        raise NotImplementedError(
            f"n = {n} sites take the long-row sweep (two int8 copies of a chain, {2 * n} "
            f"bytes, exceed a block's {MAX_SMEM_BYTES} of shared memory), which has no "
            "fault variant: no field noise (bias_rows) or update dropout (keep) at this n"
        )
    if plan is None:
        plan = colour_plan(nbr_idx, nbr_w, b, masks)
    check_plan(plan, nbr_idx, nbr_w, b, masks)
    if long_rows and not plan.independent:
        raise ValueError(
            f"n = {n} sites take the long-row sweep (two int8 copies of a chain, {2 * n} "
            f"bytes, exceed a block's {MAX_SMEM_BYTES} of shared memory), which updates "
            "each phase in place: its colour classes must be independent sets (each "
            "site in at most one, no edge inside one), and these masks are not"
        )
    out = torch.empty((B, n), dtype=torch.float32, device=dev)
    if B == 0 or n == 0:
        return out
    if per_sample:
        _launch_sweep_samples(s, plan, uniforms, beta, out, block_threads(n), dev)
        tracing.count("launch.colored_gibbs_sweep_samples")
        return out
    if long_rows:
        _launch_sweep_long(s, plan, uniforms, beta, out, dev)
        tracing.count("launch.colored_gibbs_sweep_long")
        return out
    variant = () if faults is None else (faults,)  # the base kernel's launch call unchanged
    _launch_sweep(s, plan, uniforms, beta, out, block_threads(n), dev, *variant)
    tracing.count("launch.colored_gibbs_sweep_faults" if variant else "launch.colored_gibbs_sweep")
    return out
