"""CUDA kernel: one exact Gillespie event of every chain of a dense problem.

The event of `sampler_api.CTMC`'s tree draw on a `DenseIsing`, all chains
at once, a block a chain: the flip rates lambda0 * sigma(2 beta h s) as
leaves of a sum tree in shared memory, its pair-sum levels, the
inverse-CDF descent from the chain's uniform, the dwell time from its
Exp(1), then the flip and the incremental fields and energy. Source
`csrc/ctmc_event.cu`; a call counts one `launch.ctmc_event` in
`repro_torch.tracing`.

It replaces no TPU kernel: the JAX package runs the CTMC in plain jnp, and
the port's plain version is `ref.ctmc_event_ref`, CTMC.update's tree path
operation for operation. The kernel rounds every step as that path does,
so on the card its s, h, e and t are bit-equal to the plain version's; the
draws (Exp(1), then a uniform, per chain) stay torch's, drawn by the
caller from the run's generator.

What bounds it on the H100: an event must read s and h, write h and read
one row of J a chain, 16 B n bytes (and a few scalars a chain): at
(B, n) = (256, 2000) 8.2 MB, 2.45 us at 3.35 TB/s. The tree's m - 1 adds
and a rate's exp and divide a site are far below the f32 peak: it is
memory-bound. A block's work is a chain of dependent phases (leaves, tree
levels, descent, update), so a launch is bound by their latency at least
as much as by its bytes.

What the design does about it: the leaves of a quad of sites and their two
levels above are formed in registers, the levels of more than 32 nodes take
a __syncthreads each (three at m = 2048), warp 0 sums the rest and lane 0
descends; s and h are read with 16-byte loads where n % 4 == 0 (9.12 us
an event at (256, 2000) on an H100, against 9.50 us with scalar loads),
and read again, from the cache, for the update. The tree of m = next power of two >= n
leaves must fit one block's shared memory: m <= MAX_LEAVES.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tracing
from repro_torch.core.event_tree import leaf_count
from repro_torch.kernels import _build
from repro_torch.kernels._checks import MAX_SMEM_BYTES, check_cuda, check_spins, check_tensor

TREE_BYTES_PER_LEAF = 8  # a chain's tree: 2m f32 nodes
# The most leaves a block's tree may hold: the largest power of two whose
# tree fits a block's shared memory (16384 on sm_90: 128 KB).
MAX_LEAVES = 1 << ((MAX_SMEM_BYTES // TREE_BYTES_PER_LEAF).bit_length() - 1)


def leaves_refusal(n: int) -> Optional[str]:
    """Why the kernel cannot take rows of n sites (None: it can)."""
    m = leaf_count(n)
    if m <= MAX_LEAVES:
        return None
    return (f"the event kernel ctmc_event holds a chain's sum tree of m = {m} leaves "
            f"(n = {n} sites) in one block's shared memory, {TREE_BYTES_PER_LEAF * m} bytes, "
            f"over the {MAX_SMEM_BYTES} a block may have: it takes at most {MAX_LEAVES} "
            f"leaves (n <= {MAX_LEAVES})")


def ctmc_event(s: torch.Tensor, h: torch.Tensor, e: torch.Tensor, t: torch.Tensor,
               J: torch.Tensor, beta: torch.Tensor, expo: torch.Tensor, u: torch.Tensor,
               lambda0: float = 1.0) -> tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel: (B, n) f32 spins and incremental fields, (B,)
    f32 energies, model times, per-row betas, Exp(1) draws and uniforms, and
    the (n, n) f32 couplings, all contiguous on one sm_90 device -> the new
    (s, h, e, t) in fresh tensors (the inputs stay as they were). One launch
    on the current stream, no host sync, so a CUDA graph captures it."""
    dev = check_cuda(s)
    B, n = check_spins("s", s)
    reason = leaves_refusal(n)
    if reason is not None:
        raise ValueError(reason)
    check_tensor("s", s, torch.float32, (B, n), dev)
    check_tensor("h", h, torch.float32, (B, n), dev)
    check_tensor("J", J, torch.float32, (n, n), dev)
    for name, x in (("e", e), ("t", t), ("beta", beta), ("expo", expo), ("u", u)):
        check_tensor(name, x, torch.float32, (B,), dev)
    out = (torch.empty_like(s), torch.empty_like(h), torch.empty_like(e), torch.empty_like(t))
    if B == 0:
        return out
    code = _build.launcher("ctmc_event")(
        s.data_ptr(), h.data_ptr(), e.data_ptr(), t.data_ptr(), J.data_ptr(), beta.data_ptr(),
        expo.data_ptr(), u.data_ptr(), *(x.data_ptr() for x in out), B, n, leaf_count(n),
        float(lambda0), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("ctmc_event", code)
    tracing.count("launch.ctmc_event")
    return out
