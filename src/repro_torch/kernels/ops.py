"""Public entry points for the ported kernels, mirroring `repro/kernels/ops.py`.

`mode` selects the implementation from where the tensors live:

  'auto'      — CUDA tensor: the hand-written kernel; CPU tensor: the plain
                PyTorch version (`ref`).
  'kernel'    — the kernel; a CPU tensor raises.
  'reference' — the plain version, on any device.

A CUDA tensor never reaches the plain version under 'auto' or 'kernel': a
card the kernels were not built for (compute capability other than 9.0)
raises, and so does a failed build or launch.

Each kernel wrapper counts its launches in `repro_torch.tracing`, as
`launch.<kernel>` (the kernel's name; `tracing.counts()` reads them).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ctmc_event as _ce
from repro_torch.kernels import dense_field as _df
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lattice_gibbs as _lg
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sparse_gather as _sg
from repro_torch.kernels import tau_leap as _tl

MODES = ("auto", "kernel", "reference")

def _use_kernel(t: torch.Tensor, mode: str) -> bool:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "auto":
        return t.device.type == "cuda"
    return mode == "kernel"


def _row_beta(beta, s: torch.Tensor) -> torch.Tensor:
    """The (B,) f32 per-row beta the kernels take: None -> ones, a float or
    () tensor -> that value on every row, a (B,) tensor as it is."""
    if beta is None:
        beta = 1.0
    beta = torch.as_tensor(beta, dtype=torch.float32, device=s.device)
    return beta.expand(s.shape[0]).contiguous() if beta.ndim == 0 else beta


def lattice_gibbs_sweep(
    s, w, b, uniforms, colors, frozen, clamp_value, beta=None, mode: str = "auto", plan=None,
    bias_rows=None, keep=None,
) -> torch.Tensor:
    """One fused chromatic Gibbs sweep over the (B,H,W) chains of `s`.

    The JAX signature (colors, frozen as f32 {0,1}), with `beta` a float, a
    () tensor or a (B,) per-row inverse temperature: row r rounds as the JAX
    call with scalar beta[r]. `plan` is `lattice_gibbs.lattice_plan` of
    these w, b and masks, built once per problem; without one the kernel's
    wrapper builds it per call. The plain version reads the masks.

    The fault variant, chosen by its operands: `bias_rows` ((B,H,W) f32,
    the whole per-row bias b + eta) is read in place of b, and `keep`
    ((B,H,W) bool or uint8) keeps the old spin where 0. Row r is then the
    JAX call with b + eta_r and `colors & keep_r`; b stays the plan's."""
    beta = _row_beta(beta, s)
    if _use_kernel(s, mode):
        return _lg.lattice_gibbs_sweep(s, w, b, uniforms, colors, frozen, clamp_value, beta, plan,
                                       bias_rows=bias_rows, keep=keep)
    return _ref.lattice_gibbs_sweep_ref(
        s, w, b if bias_rows is None else bias_rows, uniforms, colors > 0.5, frozen > 0.5,
        clamp_value, beta, keep,
    )


def lattice_energy(s, w, b, mode: str = "auto") -> torch.Tensor:
    """(...) energies 0.5 s.ns + b.s of (..., H, W) states on the king's
    lattice (`LatticeIsing.energy`): one launch of the energy kernel, or the
    plain version."""
    if _use_kernel(s, mode):
        return _lg.lattice_energy(s, w, b)
    return _ref.lattice_energy_ref(s, w, b)


def sparse_fields(s, nbr_idx, nbr_w, b, mode: str = "auto") -> torch.Tensor:
    """Padded neighbour-list fields h = gather(s, nbr_idx) . nbr_w + b."""
    if _use_kernel(s, mode):
        return _sg.sparse_fields(s, nbr_idx, nbr_w, b)
    return _ref.sparse_fields_ref(s, nbr_idx, nbr_w, b)


def sparse_energy(s, nbr_idx, nbr_w, b, mode: str = "auto") -> torch.Tensor:
    """(...) energies 0.5 s.h + b.s of (..., n) states over the padded
    neighbour list (`SparseIsing.energy`): one launch of the energy kernel
    (two on rows of more than 58112 sites), or the plain version."""
    if _use_kernel(s, mode):
        return _sg.sparse_energy(s, nbr_idx, nbr_w, b)
    return _ref.sparse_energy_ref(s, nbr_idx, nbr_w, b)


def colored_gibbs_sweep(
    s, nbr_idx, nbr_w, b, uniforms, masks, beta=None, mode: str = "auto", plan=None,
    bias_rows=None, keep=None,
) -> torch.Tensor:
    """One fused chromatic Gibbs sweep over the (B,n) chains of a sparse
    graph: the JAX signature (masks as f32 {0,1}), with `beta` as in
    `lattice_gibbs_sweep`. `plan` is `sparse_gather.colour_plan` of these
    tables and masks, built once per problem; without one the kernel's
    wrapper builds it per call. The plain version reads the masks.

    The fault variant, chosen by its operands: `bias_rows` ((B,n) f32, the
    whole per-row bias b + eta) is read in place of b, and `keep` ((B,n)
    bool or uint8) keeps the old spin where 0: row r is the JAX call with
    b + eta_r and masks & keep_r; b stays the plan's."""
    beta = _row_beta(beta, s)
    if _use_kernel(s, mode):
        return _sg.colored_gibbs_sweep(s, nbr_idx, nbr_w, b, uniforms, masks, beta, plan,
                                       bias_rows=bias_rows, keep=keep)
    return _ref.colored_gibbs_sweep_ref(s, nbr_idx, nbr_w, b if bias_rows is None else bias_rows,
                                        uniforms, masks > 0.5, beta, keep)


def dense_field(s_i8, j_i8, b, scale, mode: str = "auto") -> torch.Tensor:
    """h = (s @ J^T) * scale + b from int8 spins and codes (int32 sums)."""
    if _use_kernel(s_i8, mode):
        return _df.dense_field(s_i8, j_i8, b, scale)
    return _ref.dense_field_ref(s_i8, j_i8, b, scale)


def tau_leap_step(
    s, j_i8, b, scale, uniforms, dt, beta: Optional[torch.Tensor] = None,
    mode: str = "auto", bias_rows=None,
) -> torch.Tensor:
    """One fused dense tau-leap step over the B rows (chains) of `s`.

    The JAX signature, plus `beta`: an optional (B,) per-row inverse
    temperature, folded in as f32(beta*scale) and f32(beta*b) — row r then
    rounds exactly as the JAX call with scale=beta[r]*scale and
    b=beta[r]*b. `dt` may be a float or a () tensor.

    The fault variant, chosen by its operand: `bias_rows` ((B,N) f32, the
    whole per-row bias b + eta) is read in place of b, as f32(beta_r *
    bias_rows[r]): row r is the JAX call with b = beta_r * (b + eta_r)."""
    dt = torch.as_tensor(dt, dtype=torch.float32, device=s.device)
    if bias_rows is not None:
        b = bias_rows
    if _use_kernel(s, mode):
        if beta is None:
            beta = torch.ones((s.shape[0],), dtype=torch.float32, device=s.device)
        return _tl.tau_leap_step(s, j_i8, b, scale, uniforms, dt, beta)
    if beta is not None:
        scale = (beta * scale)[:, None]
        b = beta[:, None] * b
    return _ref.tau_leap_step_ref(s, j_i8, b, scale, uniforms, dt)


def ctmc_event(s, h, e, t, J, beta, expo, u, lambda0: float = 1.0,
               mode: str = "auto") -> tuple[torch.Tensor, ...]:
    """One exact Gillespie event of every chain (row) of a dense problem,
    the tree draw of `sampler_api.CTMC`: (B, n) spins s and incremental
    fields h, (B,) energies e, model times t, per-row betas, Exp(1) draws
    `expo` and uniforms u, (n, n) couplings J -> the new (s, h, e, t). One
    launch of the event kernel, or the plain version, bit for bit the same."""
    if _use_kernel(s, mode):
        return _ce.ctmc_event(s, h, e, t, J, beta, expo, u, lambda0)
    return _ref.ctmc_event_ref(s, h, e, t, J, beta, expo, u, lambda0)


def quantize_dense(J: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a float coupling matrix to (int8 codes, f32 scale).

    Rounds half to even, as `jnp.round` does; an all-zero J gets scale 1."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.max(torch.abs(J)) / qmax
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(J / scale), -qmax, qmax).to(torch.int8)
    return codes, scale.to(torch.float32)


def flash_attention(q, k, v, causal: bool = True, mode: str = "auto",
                    window: int = 0, kv_len: int | None = None) -> torch.Tensor:
    """(BH, S, d) fused attention with scale 1/sqrt(d): the JAX signature,
    GQA-aligned operands (the caller repeats the KV heads). With `causal`,
    query i sees keys 0..i; with `window` > 0 as well, only keys j with
    i - window < j <= i (a sliding window; it needs `causal`). With `kv_len`
    (None: all Sk keys) only the keys j < kv_len: keys padded past a
    sequence's end, in a call without `causal`."""
    if _use_kernel(q, mode):
        return _fa.flash_attention(q, k, v, causal, window, kv_len)
    return _ref.flash_attention_ref(q, k, v, causal, window, kv_len)
