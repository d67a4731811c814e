"""Plain PyTorch versions of the ported kernels.

The CPU tests use them, `ops` dispatches CPU tensors to them, and
`chip_smoke.py` holds each CUDA kernel against them on the card. They
mirror `repro/kernels/ref.py` operation for operation, so each rounding
step is the JAX one.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import event_tree, glauber
from repro_torch.core.ising import KING_OFFSETS, shift2d
from repro_torch.core.sparse import gather_sum, padded_energy


def broadcast_rows(beta: Optional[torch.Tensor], s: torch.Tensor) -> torch.Tensor:
    """(B,) per-row beta broadcast against the (B, ...) state `s` (None: 1)."""
    if beta is None:
        beta = torch.ones((s.shape[0],), dtype=torch.float32, device=s.device)
    return beta.reshape((-1,) + (1,) * (s.ndim - 1))


def king_sum(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_k w[k] * s(+KING_OFFSETS[k]) of (..., H, W) values, zero beyond
    the edge: the eight shifted planes added to a zero accumulator in
    KING_OFFSETS order (`LatticeIsing.neighbor_sum`'s arithmetic)."""
    acc = torch.zeros_like(s)
    for k, (dy, dx) in enumerate(KING_OFFSETS):
        acc = acc + w[k] * shift2d(s, dy, dx)
    return acc


def lattice_fields_ref(s: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """King's-move local fields. s: (B,H,W) ±1; w: (8,H,W); b: (H,W).

    The eight shifted planes are added to a zero accumulator in
    KING_OFFSETS order, then b: the JAX order, bit for bit."""
    return king_sum(s, w) + b


def lattice_energy_ref(s: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(...) energies 0.5 * sum s * ns + b.s of (..., H, W) states over (8,H,W)
    weight planes and (H,W) bias, ns = `king_sum`: `LatticeIsing.energy`'s
    own arithmetic. No TPU kernel computes it; the CUDA kernel forms the same
    terms and sums them over the sites in its own fixed order
    (`lattice_gibbs.energy_in_kernel_order`)."""
    s = s.to(w.dtype)
    pair = 0.5 * torch.sum(s * king_sum(s, w), dim=(-2, -1))
    field = torch.sum(b * s, dim=(-2, -1))
    return pair + field


def lattice_gibbs_sweep_ref(
    s: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    uniforms: torch.Tensor,
    color_masks: torch.Tensor,
    frozen: torch.Tensor,
    clamp_value: torch.Tensor,
    beta: Optional[torch.Tensor] = None,
    keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One full chromatic Gibbs sweep on the king's lattice.

    s: (B,H,W) ±1; uniforms: (C,B,H,W); color_masks: (C,H,W) bool;
    frozen: (H,W) bool; clamp_value: (H,W) ±1 (applied where frozen);
    beta: (B,) per-row inverse temperature (None -> 1.0). Row r rounds as
    the JAX B = 1 call with scalar beta[r]: sigma(-2*(beta*h)). Every
    phase's fields come from the state before that phase.

    The fault variant: b may be a (B,H,W) per-row bias (b + eta), added
    last as b is; `keep` ((B,H,W) bool or {0,1}, optional) keeps the old
    spin where 0 — row r is then the JAX call with b + eta_r and
    `colors & keep_r`."""
    beta = broadcast_rows(beta, s)
    for c in range(color_masks.shape[0]):
        h = lattice_fields_ref(s, w, b)
        p_up = torch.sigmoid(-2.0 * (beta * h))
        proposal = torch.where(uniforms[c] < p_up, 1.0, -1.0).to(s.dtype)
        upd = color_masks[c] & ~frozen
        if keep is not None:
            upd = upd & keep.bool()
        s = torch.where(upd, proposal, s)
    return torch.where(frozen, clamp_value.to(s.dtype), s)


def sparse_fields_ref(
    s: torch.Tensor, nbr_idx: torch.Tensor, nbr_w: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Padded neighbor-list local fields. s: (B,n) ±1; nbr_idx (n,D) int32;
    nbr_w (n,D); b (n,). Padded slots index the site itself with weight 0.

    The slots are summed in order k = 0..D-1, as the CUDA kernels do; JAX's
    `jnp.sum` reduces them in its own order, so the two agree to about one
    float32 eps of sum_k |w_ik| + |b_i| (exactly for integer weights)."""
    return gather_sum(s, nbr_idx, nbr_w) + b


# E(s) = 0.5 * sum_i s_i h_i + b.s of (..., n) states over the padded
# neighbour list: `SparseIsing.energy`'s own arithmetic. No TPU kernel
# computes it; the CUDA kernel sums the same terms over the sites in its own
# fixed order (`sparse_gather.energy_in_kernel_order`).
sparse_energy_ref = padded_energy


def colored_gibbs_sweep_ref(
    s: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_w: torch.Tensor,
    b: torch.Tensor,
    uniforms: torch.Tensor,
    color_masks: torch.Tensor,
    beta: Optional[torch.Tensor] = None,
    keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One full chromatic Gibbs sweep on a sparse graph.

    s: (B,n) ±1; uniforms: (C,B,n); color_masks: (C,n) bool; beta: (B,)
    per-row inverse temperature (None -> 1.0), sigma(-2*(beta*h)) as in
    the JAX B = 1 call. Every phase's fields come from the state before
    that phase.

    The fault variant: b may be a (B,n) per-row bias (b + eta), added last
    as b is; `keep` ((B,n) bool or {0,1}, optional) keeps the old spin
    where 0 — row r is then the JAX call with b + eta_r and masks & keep_r."""
    beta = broadcast_rows(beta, s)
    for c in range(color_masks.shape[0]):
        h = sparse_fields_ref(s, nbr_idx, nbr_w, b)
        p_up = torch.sigmoid(-2.0 * (beta * h))
        proposal = torch.where(uniforms[c] < p_up, 1.0, -1.0).to(s.dtype)
        upd = color_masks[c] if keep is None else color_masks[c] & keep.bool()
        s = torch.where(upd, proposal, s)
    return s


def dense_acc_ref(s_i8: torch.Tensor, j_i8: torch.Tensor) -> torch.Tensor:
    """int32 accumulators acc = s @ J^T of the int8 binary dot product.

    The product is taken in float64, which is exact for int8 operands up to
    K = 2^53 / 127^2 terms, and runs on CPU and CUDA alike (torch has no
    int32 matmul on CUDA)."""
    acc = torch.matmul(s_i8.to(torch.float64), j_i8.to(torch.float64).T)
    return acc.to(torch.int32)


def dense_field_ref(
    s_i8: torch.Tensor, j_i8: torch.Tensor, b: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """int8 binary dot-product engine: h = (s @ J^T) * scale + b.

    s_i8: (B,N) int8 in {-1,+1}; j_i8: (N,N) int8 weight codes;
    scale: () f32 dequant scale (or (B,1) per row); b: (N,) f32 (or (B,N)).
    Returns (B,N) f32.
    """
    return dense_acc_ref(s_i8, j_i8).to(torch.float32) * scale + b


def pack_spins_ref(s: torch.Tensor, ld: int) -> torch.Tensor:
    """The int8 spins the tau-leap kernel's packing launch writes: s (B,N)
    as int8 (truncation toward zero, as JAX's astype(int8)) in a (B, ld)
    tensor, zero in the padding columns N .. ld-1."""
    out = torch.zeros((s.shape[0], ld), dtype=torch.int8, device=s.device)
    out[:, : s.shape[1]] = s.to(torch.int8)
    return out


def tau_leap_flip_prob_ref(
    s: torch.Tensor,
    j_i8: torch.Tensor,
    b: torch.Tensor,
    scale: torch.Tensor,
    dt: torch.Tensor,
) -> torch.Tensor:
    """Flip probability of the fused tau-leap step: 1-exp(-dt*sigma(2 h s))."""
    h = dense_field_ref(s.to(torch.int8), j_i8, b, scale)
    rate = torch.sigmoid(2.0 * h * s)
    return 1.0 - torch.exp(-dt * rate)


def tau_leap_step_ref(
    s: torch.Tensor,
    j_i8: torch.Tensor,
    b: torch.Tensor,
    scale: torch.Tensor,
    uniforms: torch.Tensor,
    dt: torch.Tensor,
) -> torch.Tensor:
    """Fused dense tau-leap PASS update.

    s: (B,N) f32 ±1. Flip each spin w.p. 1-exp(-dt*sigma(2 h s)).
    """
    p_flip = tau_leap_flip_prob_ref(s, j_i8, b, scale, dt)
    return torch.where(uniforms < p_flip, -s, s)


def ctmc_event_ref(
    s: torch.Tensor,
    h: torch.Tensor,
    e: torch.Tensor,
    t: torch.Tensor,
    J: torch.Tensor,
    beta: torch.Tensor,
    expo: torch.Tensor,
    u: torch.Tensor,
    lambda0: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Gillespie event of every chain of a dense problem: `CTMC.update`'s
    tree path (a fresh build at each row's beta, no faults), operation for
    operation. s, h: (B, n); e, t, beta, expo, u: (B,); J: (n, n). Returns
    the new (s, h, e, t). No TPU kernel computes it; the CUDA kernel
    (`csrc/ctmc_event.cu`) rounds every step as this does."""
    rates = glauber.flip_prob(beta[:, None] * h, s)
    if lambda0 != 1.0:
        rates = lambda0 * rates
    tree = event_tree.build(rates)
    total = event_tree.total(tree)
    i = torch.clamp(event_tree.descend(tree, u), max=s.shape[1] - 1)
    alive = total > event_tree.RATE_FLOOR
    dt = expo / torch.clamp(total, min=event_tree.RATE_FLOOR)
    delta = torch.where(alive, -2.0 * s.gather(1, i[:, None])[:, 0], 0.0)
    e = e + delta * h.gather(1, i[:, None])[:, 0]
    h = h + J[i] * delta[:, None]
    s = s.scatter_add(1, i[:, None], delta[:, None])
    return s, h, e, t + dt


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True, window: int = 0,
    kv_len: int | None = None,
) -> torch.Tensor:
    """Attention oracle of the flash-attention kernel. q: (BH,Sq,d); k, v:
    (BH,Sk,d); any S. Scores, softmax and p @ v in f32, the result in q's
    dtype. With `causal`, query i sees keys 0..i (aligned at the top left,
    also when Sq != Sk), and with `window` > 0 only the band of keys
    i - window < j <= i, the JAX package's `causal_mask(Sq, Sk, window)`;
    with `kv_len` (None: Sk; below Sk only without `causal`) only the keys
    j < kv_len; masked scores are -1e30."""
    check_window(causal, window)
    kv_len = check_kv_len(causal, kv_len, k.shape[-2])
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32), k.to(torch.float32))
    s = s / torch.sqrt(torch.tensor(d, dtype=torch.float32, device=q.device))
    if causal:
        Sq, Sk = s.shape[-2], s.shape[-1]
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        mask = kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        s = s.masked_fill(~mask, -1e30)
    if kv_len < s.shape[-1]:
        s[..., kv_len:] = -1e30
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)).to(q.dtype)


def check_window(causal: bool, window: int) -> None:
    """A band needs the causal mask: raise on a negative window or a window
    without `causal`."""
    if window < 0 or (window and not causal):
        raise ValueError(f"window = {window} needs causal=True and window >= 0 (0: no band)")


def check_kv_len(causal: bool, kv_len: int | None, Sk: int) -> int:
    """The key-length bound of an attention call over Sk keys (None: Sk).
    Raise unless 1 <= kv_len <= Sk, and on kv_len < Sk with `causal`: the
    causal mask already hides keys padded after the queries' own."""
    if kv_len is None:
        return Sk
    if not 1 <= kv_len <= Sk:
        raise ValueError(f"kv_len = {kv_len} must lie in [1, Sk = {Sk}]")
    if causal and kv_len < Sk:
        raise ValueError(f"kv_len = {kv_len} < Sk = {Sk} needs causal=False")
    return int(kv_len)
