"""CUDA kernels for sparse (neighbor-list) Ising problems.

Two kernels over the padded `SparseIsing` layout (`repro_torch.core.sparse`):

  sparse_fields        — local fields h = gather(s, nbr_idx) . nbr_w + b,
                         one thread per (row, site). Source
                         `csrc/sparse_fields.cu`.
  colored_gibbs_sweep  — one chromatic Gibbs sweep over all colour classes,
                         one block per chain. Source `csrc/colored_gibbs.cu`.

Both sum a site's slots in order through `csrc/sparse_gather.cuh`, as
`ref.sparse_fields_ref` does, so each equals its plain version bit for bit.

Replaces the TPU kernels `repro/kernels/sparse_gather.py::sparse_fields`
(`_fields_kernel`, the `pl.pallas_call` at line 90) and
`::colored_gibbs_sweep` (`_sweep_kernel`, the `pl.pallas_call` at line 126).
The TPU kernels grid over batch blocks and hold the whole neighbour tables
in VMEM; the JAX driver vmaps a B = 1 sweep per chain with a scalar beta,
here each row carries its own beta.

What bounds them on the H100, at (B, n) = (256, 16384), D = 3, C = 4 (the
greedy colouring of `random_3regular_maxcut(16384, 0)`):
  sparse_fields reads s (16.8 MB) and the tables (0.5 MB) and writes h
  (16.8 MB): about 34 MB, 10 µs at 3.35 TB/s.
  colored_gibbs_sweep reads s, one uniform per site (a proper colouring
  updates each site once: 16.8 MB of the (C, B, n) uniforms) and the
  tables (0.7 MB with the masks), and writes the new s: about 51 MB,
  15 µs. Their arithmetic is negligible: both are memory-bound.

What the design does about it: the sweep keeps a chain's spins in shared
memory (int8, two buffers: 32 KB at n = 16384), so its C phases gather from
shared memory and touch device memory only for the uniforms of the sites
they update; the tables come through the read-only cache and stay in L2 for
every block. sparse_fields reads each row's spins from L1/L2 as it
gathers them; its table reads are coalesced.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import MAX_SMEM_BYTES, check_cuda, check_tensor

launches = {"sparse_fields": 0, "colored_gibbs_sweep": 0}  # chip_smoke.py resets and reads these


def _check_tables(s, nbr_idx, nbr_w, b):
    """(dev, B, n, D) of the shared operands; raise unless they fit the kernels."""
    dev = check_cuda(s)
    if s.ndim != 2 or nbr_idx.ndim != 2:
        raise ValueError(
            f"s must be (B, n) and nbr_idx (n, D), got {tuple(s.shape)} and "
            f"{tuple(nbr_idx.shape)}"
        )
    B, n = s.shape
    D = nbr_idx.shape[1]
    check_tensor("s", s, torch.float32, (B, n), dev)
    check_tensor("nbr_idx", nbr_idx, torch.int32, (n, D), dev)
    check_tensor("nbr_w", nbr_w, torch.float32, (n, D), dev)
    check_tensor("b", b, torch.float32, (n,), dev)
    if B * n >= 2**31 or n * D >= 2**31:
        raise ValueError(f"(B, n, D) = ({B}, {n}, {D}) overflows the kernels' int32 indexing")
    return dev, B, n, D


def sparse_fields(
    s: torch.Tensor, nbr_idx: torch.Tensor, nbr_w: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Launch the CUDA kernel: (B,n) f32 spins, (n,D) int32 neighbour
    indices in [0, n), (n,D) f32 couplings and (n,) f32 bias, all contiguous
    on one sm_90 device -> (B,n) f32 fields."""
    dev, B, n, D = _check_tables(s, nbr_idx, nbr_w, b)
    out = torch.empty((B, n), dtype=torch.float32, device=dev)
    if B == 0 or n == 0:
        return out
    code = _build.launcher("sparse_fields")(
        s.data_ptr(), nbr_idx.data_ptr(), nbr_w.data_ptr(), b.data_ptr(), out.data_ptr(),
        B, n, D, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("sparse_fields", code)
    launches["sparse_fields"] += 1
    return out


def colored_gibbs_sweep(
    s: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_w: torch.Tensor,
    b: torch.Tensor,
    uniforms: torch.Tensor,
    masks: torch.Tensor,
    beta: torch.Tensor,
) -> torch.Tensor:
    """Launch the CUDA kernel: the operands of `sparse_fields` plus (C,B,n)
    f32 uniforms, (C,n) f32 {0,1} colour masks and (B,) f32 per-row beta
    -> new (B,n) f32 spins in a fresh tensor."""
    dev, B, n, D = _check_tables(s, nbr_idx, nbr_w, b)
    C = masks.shape[0] if masks.ndim == 2 else -1
    check_tensor("masks", masks, torch.float32, (C, n), dev)
    check_tensor("uniforms", uniforms, torch.float32, (C, B, n), dev)
    check_tensor("beta", beta, torch.float32, (B,), dev)
    if 2 * n > MAX_SMEM_BYTES:
        raise ValueError(
            f"n = {n} sites need {2 * n} bytes of shared memory per block (two "
            f"int8 copies of a chain); the card allows {MAX_SMEM_BYTES}"
        )
    out = torch.empty((B, n), dtype=torch.float32, device=dev)
    if B == 0 or n == 0:
        return out
    code = _build.launcher("colored_gibbs")(
        s.data_ptr(), nbr_idx.data_ptr(), nbr_w.data_ptr(), b.data_ptr(), uniforms.data_ptr(),
        masks.data_ptr(), beta.data_ptr(), out.data_ptr(), B, n, D, C,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("colored_gibbs_sweep", code)
    launches["colored_gibbs_sweep"] += 1
    return out
