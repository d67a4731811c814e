"""CUDA kernel: fused chromatic Gibbs sweep on the king's-move lattice.

One sweep over the colour classes of every chain, all chains as the B rows
of one launch: per colour, the 8-neighbour stencil fields at that colour's
sites, sigma(-2*(beta*h)), the proposal from the colour's uniforms, the
update where colour and not frozen; then the clamp. Source
`csrc/lattice_gibbs.cu`.

Replaces the TPU kernel `repro/kernels/lattice_gibbs.py::lattice_gibbs_sweep`
(`_sweep_kernel`, the `pl.pallas_call` at line 102). The TPU kernel grids
over batch blocks, keeps the lattice and its weight planes in VMEM and
computes the whole field plane in every colour phase, because its vector
unit shifts whole planes. The JAX driver vmaps a B = 1 call per chain with
a scalar beta; here each row carries its own beta.

The TPU kernel is generic in its dtype; this one takes f32 or bf16, and in
bf16 rounds every add and multiply of the stencil to bf16, as torch and
XLA do.

What bounds it on the H100: at (B, H, W) = (4096, 16, 16) in f32 it must read s
(4.2 MB) and, since each site of a proper colouring is updated once, one
uniform per free site (4.2 MB), and write the new s (4.2 MB): about
12.6 MB, 3.8 µs at 3.35 TB/s (half in bf16). Its arithmetic (8
multiply-adds and one exp per site) is negligible. It is memory-bound.

What the design does about it: a block keeps whole chains in shared
memory (int8, two buffers, 2 KB per 16x16 chain), so the four phases
touch device memory only for the uniforms of the sites they update; each
phase computes fields only at its colour's sites, a quarter of the work
the TPU kernel does; the weight planes and masks (10 KB at 16x16) come
through the read-only cache and stay in L2 for all blocks.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import MAX_SMEM_BYTES, check_cuda, check_tensor

launches = 0  # kernel launches in this process; chip_smoke.py resets and reads it

DTYPES = (torch.float32, torch.bfloat16)  # as the TPU kernel, generic in its dtype


def lattice_gibbs_sweep(
    s: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    uniforms: torch.Tensor,
    colors: torch.Tensor,
    frozen: torch.Tensor,
    clamp_value: torch.Tensor,
    beta: torch.Tensor,
) -> torch.Tensor:
    """Launch the CUDA kernel: (B,H,W) ±1 spins, (8,H,W) weight planes,
    (H,W) bias, (C,B,H,W) uniforms, (C,H,W) {0,1} colour masks, (H,W) {0,1}
    frozen mask and ±1 clamp values, all f32 or all bf16, and (B,) f32
    per-row beta, all contiguous on one sm_90 device -> new (B,H,W) spins
    of the operands' dtype in a fresh tensor. In bf16 the fields round as
    the plain version's do (`ref.lattice_fields_ref`)."""
    global launches
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
    if 2 * H * W > MAX_SMEM_BYTES:
        raise ValueError(
            f"a {H}x{W} lattice needs {2 * H * W} bytes of shared memory per "
            f"block (two int8 copies of a chain); the card allows {MAX_SMEM_BYTES}"
        )
    out = torch.empty((B, H, W), dtype=dtype, device=dev)
    if B == 0 or H * W == 0:
        return out
    code = _build.launcher("lattice_gibbs")(
        s.data_ptr(), w.data_ptr(), b.data_ptr(), uniforms.data_ptr(), colors.data_ptr(),
        frozen.data_ptr(), clamp_value.data_ptr(), beta.data_ptr(), out.data_ptr(),
        B, H, W, C, int(dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("lattice_gibbs_sweep", code)
    launches += 1
    return out
