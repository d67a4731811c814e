"""The fixed orders in which the hand-written kernels sum, in plain torch.

A thread adds its terms in turn, a warp adds its lanes by a shuffle tree,
and a block adds its warps in turn. The energy kernels' emulations
(`sparse_gather.energy_in_kernel_order`, `lattice_gibbs.energy_in_kernel_order`)
are built from these, so the tests can hold a kernel's sums bit for bit.
"""
from __future__ import annotations

import torch

BLOCK_THREADS = 1024  # threads of a block that walks a row or a chain, at most


def block_threads(n: int) -> int:
    """Threads of a block that walks n sites: n rounded up to a warp, at most BLOCK_THREADS."""
    return max(32, min(BLOCK_THREADS, (n + 31) // 32 * 32))


def in_turn(x: torch.Tensor) -> torch.Tensor:
    """Sum (..., m, k) over m in turn, from 0: a thread's running sum."""
    acc = torch.zeros(x.shape[:-2] + x.shape[-1:], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-2]):
        acc = acc + x[..., j, :]
    return acc


def warp_tree(v: torch.Tensor) -> torch.Tensor:
    """Lane 0 of a warp's shuffle-down tree over (..., 32): lane l adds lane
    l + 16, then l + 8, 4, 2, 1 (a __shfl_xor tree gives every lane this sum)."""
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def block_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum (..., threads) as a block does: each warp's tree, then the warps in turn."""
    warps = warp_tree(x.reshape(x.shape[:-1] + (x.shape[-1] // 32, 32)))
    return in_turn(warps[..., None, :].transpose(-1, -2))[..., 0]


def threads_in_turn(p: torch.Tensor, threads: int) -> torch.Tensor:
    """(rows, n) -> (rows, threads): thread t adds sites t, t + threads, ... in turn."""
    m = -(-p.shape[-1] // threads)
    p = torch.nn.functional.pad(p, (0, m * threads - p.shape[-1]))
    return in_turn(p.reshape(p.shape[0], m, threads))
