"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The port of `repro/models/xlstm.py`.

mLSTM — exponential-gated matrix-memory cell:
    C_t = f_t C_{t-1} + i_t v_t k_t^T ;  n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))
with the log-domain stabiliser m_t. Three executions of the same math: the
parallel quadratic form (a prompt of up to 4 chunks), the chunkwise form
(a loop over chunks carrying (C, n, m); longer prompts, and the state a
prompt leaves), and the one-token recurrent step (decode).

sLSTM — scalar memory with recurrent gate mixing (the R h_{t-1} term),
sequential by nature: a Python loop over time, block-diagonal per-head R.

Block wrappers as in the JAX package: mLSTM = pre-up-projection block
(up by pf = 2, the cell in the wide space, a gated skip); sLSTM =
post-up-projection block (the cell at d_model, then a pf = 4/3 gated FFN).

Stabiliser: the states start at m = -1e30, never -inf, so log_f + m - m_new
stays finite; a padded chunk's steps take itilde = -1e30 and log_f = 0 and
leave the carried state as it was. The cumulative sums and maxima run in
torch's order, which may round otherwise than XLA's (the tests bound it).
Decode writes the states in place. The causal decay matrix masks before
its exp (`_masked_exp`), so its gradient stays finite where the JAX
package's turns NaN (a deliberate difference; the values are the same).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.sharding.partition import constrain, shards_divide


class MLSTMState(NamedTuple):
    C: torch.Tensor  # (B, H, d, d)
    n: torch.Tensor  # (B, H, d)
    m: torch.Tensor  # (B, H)


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, D)
    n: torch.Tensor  # (B, D)
    h: torch.Tensor  # (B, D)
    m: torch.Tensor  # (B, D)


_F32 = torch.float32

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    """w_up_a, w_up_b (D -> 2D), the block-diagonal w_q, w_k, w_v (H, d, d),
    w_if (2D -> 2H) with its bias b_if, w_down (2D -> D) and the norm gn."""

    AXES = {"w_up_a.weight": ("mlp", "fsdp"), "w_up_b.weight": ("mlp", "fsdp"),
            "w_q": ("heads", None, None), "w_k": ("heads", None, None),
            "w_v": ("heads", None, None), "w_if.weight": (None, "mlp"), "b_if": (None,),
            "w_down.weight": ("fsdp", "mlp")}

    def __init__(self, gen, cfg, dtype):
        super().__init__()
        D, H, dev = cfg.d_model, cfg.n_heads, layers.device_of(gen)
        Du = 2 * D
        d = Du // H
        self.w_up_a = layers.dense_init(gen, D, Du, dtype)
        self.w_up_b = layers.dense_init(gen, D, Du, dtype)
        self.w_q = nn.Parameter(layers.normal(gen, (H, d, d), 0.02, dtype))
        self.w_k = nn.Parameter(layers.normal(gen, (H, d, d), 0.02, dtype))
        self.w_v = nn.Parameter(layers.normal(gen, (H, d, d), 0.02, dtype))
        self.w_if = layers.dense_init(gen, Du, 2 * H, dtype, scale=0.02)
        self.b_if = nn.Parameter(torch.cat([torch.zeros((H,), device=dev),
                                            3.0 * torch.ones((H,), device=dev)]).to(dtype))
        self.w_down = layers.dense_init(gen, Du, D, dtype)
        self.gn = layers.Norm(Du, dtype, dev)


def mlstm_init(gen, cfg, dtype) -> MLSTM:
    return MLSTM(gen, cfg, dtype)


def _mlstm_qkv_gates(mod: MLSTM, a, H: int):
    """a (B, S, Du) -> q, k, v (B, S, H, d) in a's dtype; itilde, log_f
    (B, S, H) in float32."""
    B, S, Du = a.shape
    d = Du // H
    if not shards_divide(a, -1, H):  # under a mesh: DTensor splits only whole shards
        a = constrain(a, ("batch", None, None))
    ah = a.reshape(B, S, H, d)
    q = torch.einsum("bshd,hde->bshe", ah, mod.w_q)
    k = torch.einsum("bshd,hde->bshe", ah, mod.w_k) / float(
        torch.tensor(d, dtype=a.dtype).sqrt())
    v = torch.einsum("bshd,hde->bshe", ah, mod.w_v)
    gates = (mod.w_if(a) + mod.b_if).to(_F32)  # (B, S, 2H)
    itilde, ftilde = gates[..., :H], gates[..., H:]
    log_f = -F.softplus(-ftilde)  # log sigmoid(ftilde): a bounded forget
    return q, k, v, itilde, log_f


def _masked_exp(logD, tri):
    """exp(logD) where the (t, s) mask `tri` holds, else 0, with the mask
    applied before the exp: the JAX package's where(tri, exp(logD), 0)
    gives the same values, but once a masked logD overflows exp to inf its
    gradient is 0 * inf = NaN (a fault of the reference, ROADMAP)."""
    return torch.exp(torch.where(tri[None, :, :, None], logD, -torch.inf))


def mlstm_parallel(mod: MLSTM, a, H: int) -> torch.Tensor:
    """The parallel quadratic form. a: (B, S, Du) -> (B, S, Du)."""
    B, S, Du = a.shape
    q, k, v, itilde, log_f = _mlstm_qkv_gates(mod, a, H)
    Fc = torch.cumsum(log_f, dim=1)                     # (B, S, H)
    u = itilde - Fc
    mstar = torch.cummax(u, dim=1).values               # running max
    m = Fc + mstar                                      # stabiliser per target t
    # decay D_ts = exp(F_t - F_s + i_s - m_t) = exp(u_s - mstar_t), s <= t
    logD = u[:, None, :, :] - mstar[:, :, None, :]      # (B, t, s, H)
    tri = torch.ones((S, S), dtype=torch.bool, device=a.device).tril()
    Dmat = _masked_exp(logD, tri)
    scores = torch.einsum("bthd,bshd->btsh", q.to(_F32), k.to(_F32))
    w = scores * Dmat
    denom = torch.maximum(torch.abs(w.sum(dim=2)), torch.exp(-m))  # (B, t, H)
    h = torch.einsum("btsh,bshd->bthd", w, v.to(_F32)) / denom[..., None]
    return h.reshape(B, S, Du).to(a.dtype)


def mlstm_step(mod: MLSTM, a_t, H: int, state: MLSTMState):
    """One recurrent step, a_t: (B, Du): the same math as mlstm_parallel.
    Returns (h (B, Du), state) with the state written in place."""
    B, Du = a_t.shape
    q, k, v, itilde, log_f = _mlstm_qkv_gates(mod, a_t[:, None], H)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                 # (B, H, d)
    itilde, log_f = itilde[:, 0], log_f[:, 0]           # (B, H)
    m_new = torch.maximum(log_f + state.m, itilde)
    f_eff = torch.exp(log_f + state.m - m_new)
    i_eff = torch.exp(itilde - m_new)
    kf, vf, qf = k.to(_F32), v.to(_F32), q.to(_F32)
    C = (f_eff[..., None, None] * state.C
         + i_eff[..., None, None] * torch.einsum("bhd,bhe->bhde", vf, kf))
    n = f_eff[..., None] * state.n + i_eff[..., None] * kf
    num = torch.einsum("bhde,bhe->bhd", C, qf)
    denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, qf)), torch.exp(-m_new))
    h = (num / denom[..., None]).reshape(B, Du).to(a_t.dtype)
    state.C.copy_(C)
    state.n.copy_(n)
    state.m.copy_(m_new)
    return h, state


def mlstm_chunkwise(mod: MLSTM, a, H: int, chunk: int):
    """The chunkwise form: a loop over chunks carrying (C, n, m), quadratic
    only within a chunk; the same stabilised math as mlstm_parallel and
    mlstm_step. a: (B, S, Du) -> (h (B, S, Du), the state after S steps)."""
    B, S, Du = a.shape
    d = Du // H
    pad = (-S) % chunk
    if pad:
        a = F.pad(a, (0, 0, 0, pad))
    Sp = a.shape[1]
    q, k, v, itilde, log_f = _mlstm_qkv_gates(mod, a, H)
    if pad:
        # padded steps leave the carried state as it was: i = 0, f = 1
        valid = (torch.arange(Sp, device=a.device) < S)[None, :, None]
        itilde = torch.where(valid, itilde, -1e30)
        log_f = torch.where(valid, log_f, 0.0)
    C0 = torch.zeros((B, H, d, d), dtype=_F32, device=a.device)
    n0 = torch.zeros((B, H, d), dtype=_F32, device=a.device)
    m0 = torch.full((B, H), -1e30, dtype=_F32, device=a.device)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=a.device).tril()
    hs = []
    for c0 in range(0, Sp, chunk):
        sl = slice(c0, c0 + chunk)
        qf, kf, vf = q[:, sl].to(_F32), k[:, sl].to(_F32), v[:, sl].to(_F32)
        it, lf = itilde[:, sl], log_f[:, sl]            # (B, L, H)
        Fc = torch.cumsum(lf, dim=1)                    # intra-chunk cumulative forget
        u = it - Fc
        mstar = torch.cummax(u, dim=1).values
        m = Fc + torch.maximum(m0[:, None], mstar)      # (B, L, H)
        inter_w = torch.exp(Fc + m0[:, None] - m)       # weight of C0 / n0
        logD = u[:, None, :, :] + Fc[:, :, None, :] - m[:, :, None, :]
        Dm = _masked_exp(logD, tri)
        scores = torch.einsum("bthd,bshd->btsh", qf, kf) * Dm
        num = torch.einsum("btsh,bshd->bthd", scores, vf)
        num = num + inter_w[..., None] * torch.einsum("bhde,bthe->bthd", C0, qf)
        dots = scores.sum(dim=2) + inter_w * torch.einsum("bhd,bthd->bth", n0, qf)
        denom = torch.maximum(torch.abs(dots), torch.exp(-m))
        hs.append(num / denom[..., None])
        # the chunk-end state
        F_L = Fc[:, -1]                                 # (B, H)
        m_end = F_L + torch.maximum(m0, mstar[:, -1])
        wC = torch.exp(u + F_L[:, None] - m_end[:, None])  # per source s
        carry = torch.exp(F_L + m0 - m_end)
        C0 = carry[..., None, None] * C0 + torch.einsum("bsh,bshd,bshe->bhde", wC, vf, kf)
        n0 = carry[..., None] * n0 + torch.einsum("bsh,bshd->bhd", wC, kf)
        m0 = m_end
    h = torch.cat(hs, dim=1).reshape(B, Sp, Du)[:, :S]
    return h.to(a.dtype), MLSTMState(C=C0, n=n0, m=m0)


def _mlstm_out(mod: MLSTM, h, b):
    return mod.w_down(layers.rmsnorm(h, mod.gn.scale) * F.silu(b))


def mlstm_block_train(mod: MLSTM, x, cfg) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): the chunkwise form above 4 chunks, else the
    parallel one."""
    a, b = constrain(mod.w_up_a(x), ("batch", None, "mlp")), mod.w_up_b(x)
    if x.shape[1] > 4 * cfg.mlstm_chunk:
        h, _ = mlstm_chunkwise(mod, a, cfg.n_heads, cfg.mlstm_chunk)
    else:
        h = mlstm_parallel(mod, a, cfg.n_heads)
    return _mlstm_out(mod, h, b)


def mlstm_block_decode(mod: MLSTM, x, cfg, state: MLSTMState):
    a, b = mod.w_up_a(x[:, 0]), mod.w_up_b(x[:, 0])
    h, state = mlstm_step(mod, a, cfg.n_heads, state)
    return _mlstm_out(mod, h, b)[:, None], state


def mlstm_init_state(cfg, batch: int, device) -> MLSTMState:
    H = cfg.n_heads
    d = 2 * cfg.d_model // H
    return MLSTMState(C=torch.zeros((batch, H, d, d), dtype=_F32, device=device),
                      n=torch.zeros((batch, H, d), dtype=_F32, device=device),
                      m=torch.full((batch, H), -1e30, dtype=_F32, device=device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    """w_gates (D -> 4D), the block-diagonal recurrent r_gates (H, dh, 4 dh),
    b_gates (4D,), the norm gn, and the post-up FFN (geglu) with ffn_norm."""

    AXES = {"w_gates.weight": ("mlp", "fsdp"), "r_gates": ("heads", None, None),
            "b_gates": (None,)}

    def __init__(self, gen, cfg, dtype):
        super().__init__()
        D, H, dev = cfg.d_model, cfg.n_heads, layers.device_of(gen)
        dh = D // H
        self.w_gates = layers.dense_init(gen, D, 4 * D, dtype)
        self.r_gates = nn.Parameter(layers.normal(gen, (H, dh, 4 * dh), 0.02, dtype))
        self.b_gates = nn.Parameter(torch.cat([torch.zeros((D,), device=dev),
                                               2.0 * torch.ones((D,), device=dev),
                                               torch.zeros((2 * D,), device=dev)]).to(dtype))
        self.gn = layers.Norm(D, dtype, dev)
        d_ff = int(4 * D / 3 / 64) * 64 or 64
        self.ffn = layers.mlp_init(gen, D, d_ff, "geglu", dtype)
        self.ffn_norm = layers.Norm(D, dtype, dev)


def slstm_init(gen, cfg, dtype) -> SLSTM:
    return SLSTM(gen, cfg, dtype)


def _slstm_cell(mod: SLSTM, wx_t, state: SLSTMState, H: int) -> SLSTMState:
    """wx_t: (B, 4D), the input's contribution at step t -> the next state
    (new tensors; the caller decides where they go)."""
    B = wx_t.shape[0]
    D = wx_t.shape[1] // 4
    h = state.h if shards_divide(state.h, -1, H) else constrain(state.h, ("batch", None))
    hprev = h.reshape(B, H, D // H)
    rec = torch.einsum("bhd,hde->bhe", hprev, mod.r_gates.to(_F32))
    gates = wx_t.to(_F32) + rec.reshape(B, 4 * D) + mod.b_gates.to(_F32)
    itilde, ftilde, ztilde, otilde = torch.split(gates, D, dim=-1)
    log_f = -F.softplus(-ftilde)
    m_new = torch.maximum(log_f + state.m, itilde)
    f_eff = torch.exp(log_f + state.m - m_new)
    i_eff = torch.exp(itilde - m_new)
    c = f_eff * state.c + i_eff * torch.tanh(ztilde)
    n = f_eff * state.n + i_eff
    h = torch.sigmoid(otilde) * c / torch.clamp(n, min=1e-6)
    return SLSTMState(c=c, n=n, h=h, m=m_new)


def slstm_scan(mod: SLSTM, x, cfg, state: SLSTMState):
    """x: (B, S, D) -> (h (B, S, D) in x's dtype, the state after S steps);
    a loop over time."""
    wx = mod.w_gates(x)  # (B, S, 4D)
    hs = []
    for t in range(x.shape[1]):
        state = _slstm_cell(mod, wx[:, t], state, cfg.n_heads)
        hs.append(state.h)
    return torch.stack(hs, dim=1).to(x.dtype), state


def slstm_block_from_scan(mod: SLSTM, x, hseq):
    """The block's output from the cell's h sequence: the norm, the cell
    residual inside the block, the FFN."""
    h = layers.rmsnorm(hseq.to(x.dtype), mod.gn.scale)
    z = layers.rmsnorm(x + h, mod.ffn_norm.scale)
    return layers.mlp_apply(mod.ffn, z, "geglu") + h


def slstm_block_train(mod: SLSTM, x, cfg) -> torch.Tensor:
    h, _ = slstm_scan(mod, x, cfg, slstm_init_state(cfg, x.shape[0], x.device))
    return slstm_block_from_scan(mod, x, h)


def slstm_block_decode(mod: SLSTM, x, cfg, state: SLSTMState):
    """One step; the state written in place."""
    new = _slstm_cell(mod, mod.w_gates(x[:, 0]), state, cfg.n_heads)
    for dst, src in zip(state, new):
        dst.copy_(src)
    return slstm_block_from_scan(mod, x, state.h[:, None]), state


def slstm_init_state(cfg, batch: int, device) -> SLSTMState:
    D = cfg.d_model

    def zeros():
        return torch.zeros((batch, D), dtype=_F32, device=device)

    return SLSTMState(c=zeros(), n=zeros(), h=zeros(),
                      m=torch.full((batch, D), -1e30, dtype=_F32, device=device))
