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
from repro_torch.sharding import partition
from repro_torch.sharding.partition import constrain


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
    # a's features are sharded over the tensor axis: a legal split into
    # heads where the axis divides H, else gathered first
    ah = partition.reshape(a, (B, S, H, d))
    q = partition.einsum("bshd,hde->bshe", ah, mod.w_q)
    k = partition.einsum("bshd,hde->bshe", ah, mod.w_k) / float(
        torch.tensor(d, dtype=a.dtype).sqrt())
    v = partition.einsum("bshd,hde->bshe", ah, mod.w_v)
    # (B, S, 2H), laid out as the batch (w_if's partial sums reduced here): in
    # the backward pass the gates' gradient then reaches w_if's matmul with
    # its sequence whole, which it flattens with the batch
    gates = constrain(mod.w_if(a) + mod.b_if, ("batch", None, None)).to(_F32)
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
    """The parallel quadratic form. a: (B, S, Du) -> (B, S, Du). Under a
    mesh it runs on each rank's shards, laid out as `mlstm_chunkwise` lays
    them out."""
    B, S, Du = a.shape
    h = partition.on_shards(_mlstm_parallel_local, *_mlstm_local_inputs(mod, a, H))
    # (H, d) merge: the heads lead the run, whole on every rank
    return partition.reshape(h, (B, S, Du)).to(a.dtype)


def _mlstm_local_inputs(mod: MLSTM, a, H: int):
    """q, k, v (B, S, H, d) and the gates (B, S, H) of a, laid out for a
    computation on each rank's shards: the forms mix the sequence and each
    head's width, so all are gathered over every axis but the batch."""
    q, k, v, itilde, log_f = _mlstm_qkv_gates(mod, a, H)
    return (*(constrain(t, ("batch", None, None, None)) for t in (q, k, v)),
            *(constrain(t, ("batch", None, None)) for t in (itilde, log_f)))


def _mlstm_parallel_local(q, k, v, itilde, log_f):
    """The parallel form of q, k, v (B, S, H, d) and the gates (B, S, H) ->
    h (B, S, H, d) float32."""
    S = q.shape[1]
    Fc = torch.cumsum(log_f, dim=1)                     # (B, S, H)
    u = itilde - Fc
    mstar = torch.cummax(u, dim=1).values               # running max
    m = Fc + mstar                                      # stabiliser per target t
    # decay D_ts = exp(F_t - F_s + i_s - m_t) = exp(u_s - mstar_t), s <= t
    logD = u[:, None, :, :] - mstar[:, :, None, :]      # (B, t, s, H)
    tri = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    Dmat = _masked_exp(logD, tri)
    scores = torch.einsum("bthd,bshd->btsh", q.to(_F32), k.to(_F32))
    w = scores * Dmat
    denom = torch.maximum(torch.abs(w.sum(dim=2)), torch.exp(-m))  # (B, t, H)
    return torch.einsum("btsh,bshd->bthd", w, v.to(_F32)) / denom[..., None]


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
         + i_eff[..., None, None] * partition.einsum("bhd,bhe->bhde", vf, kf))
    n = f_eff[..., None] * state.n + i_eff[..., None] * kf
    num = partition.einsum("bhde,bhe->bhd", C, qf)
    denom = torch.maximum(torch.abs(partition.einsum("bhd,bhd->bh", n, qf)), torch.exp(-m_new))
    # (H, d) merge: the heads lead the run, sharded only where the axis divides them
    h = partition.reshape(num / denom[..., None], (B, Du)).to(a_t.dtype)
    state.C.copy_(C)
    state.n.copy_(n)
    state.m.copy_(m_new)
    return h, state


def mlstm_chunkwise(mod: MLSTM, a, H: int, chunk: int):
    """The chunkwise form: a loop over chunks carrying (C, n, m), quadratic
    only within a chunk; the same stabilised math as mlstm_parallel and
    mlstm_step. a: (B, S, Du) -> (h (B, S, Du), the state after S steps).
    Under a mesh the loop runs on each rank's shards (`partition.on_shards`,
    the inputs laid out by `_mlstm_local_inputs`)."""
    B, S, Du = a.shape
    h, C, n, m = partition.on_shards(lambda *t: _mlstm_chunk_loop(*t, chunk=chunk),
                                     *_mlstm_local_inputs(mod, a, H))
    return partition.reshape(h, (B, S, Du)).to(a.dtype), MLSTMState(C=C, n=n, m=m)


def _mlstm_chunk_loop(q, k, v, itilde, log_f, chunk: int):
    """The chunkwise loop of q, k, v (B, S, H, d) and the gates (B, S, H)
    -> (h (B, S, H, d) float32, C, n, m), a `layers.scan` over chunks. The
    sequence is padded to whole chunks; a padded step leaves the carried
    state as it was (i = 0, f = 1) and its q, k and v are zeros, those of a
    zero input."""
    B, S, H, d = q.shape
    pad = (-S) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        itilde = F.pad(itilde, (0, 0, 0, pad), value=-1e30)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    Sp = q.shape[1]
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()

    def step(state, *chunk_in):
        h, *state = _mlstm_chunk(*chunk_in[:5], *state, chunk_in[5])
        return state, h

    chunks = tuple(t.reshape(B, Sp // chunk, chunk, *t.shape[2:])
                   for t in (q, k, v, itilde, log_f))
    h, (C, n, m) = layers.scan(step, _mlstm_zero_state(B, H, d, q.device), chunks, (tri,))
    return h.reshape(B, Sp, H, d)[:, :S], C, n, m


def _mlstm_zero_state(B: int, H: int, d: int, device):
    return (torch.zeros((B, H, d, d), dtype=_F32, device=device),
            torch.zeros((B, H, d), dtype=_F32, device=device),
            torch.full((B, H), -1e30, dtype=_F32, device=device))


def _mlstm_chunk(q, k, v, it, lf, C0, n0, m0, tri):
    """One chunk of L steps: q, k, v (B, L, H, d), the gates (B, L, H), from
    the carried (C0, n0, m0) -> (h (B, L, H, d) float32, C, n, m)."""
    qf, kf, vf = q.to(_F32), k.to(_F32), v.to(_F32)
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
    # the chunk-end state
    F_L = Fc[:, -1]                                 # (B, H)
    m_end = F_L + torch.maximum(m0, mstar[:, -1])
    wC = torch.exp(u + F_L[:, None] - m_end[:, None])  # per source s
    carry = torch.exp(F_L + m0 - m_end)
    C = carry[..., None, None] * C0 + torch.einsum("bsh,bshd,bshe->bhde", wC, vf, kf)
    n = carry[..., None] * n0 + torch.einsum("bsh,bshd->bhd", wC, kf)
    return num / denom[..., None], C, n, m_end


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


def _slstm_cell(r_gates, b_gates, wx_t, state: SLSTMState, H: int) -> SLSTMState:
    """wx_t: (B, 4D), the input's contribution at step t -> the next state
    (new tensors; the caller decides where they go). r_gates (H, dh, 4 dh)
    and b_gates (4D,) are the block's."""
    B = wx_t.shape[0]
    D = wx_t.shape[1] // 4
    # h's width is sharded over the tensor axis in a decode state: a legal
    # split into heads where the axis divides H, else gathered first
    hprev = partition.reshape(state.h, (B, H, D // H))
    rec = partition.einsum("bhd,hde->bhe", hprev, r_gates.to(_F32))
    gates = wx_t.to(_F32) + partition.reshape(rec, (B, 4 * D)) + b_gates.to(_F32)
    itilde, ftilde, ztilde, otilde = torch.split(gates, D, dim=-1)
    log_f = -F.softplus(-ftilde)
    m_new = torch.maximum(log_f + state.m, itilde)
    f_eff = torch.exp(log_f + state.m - m_new)
    i_eff = torch.exp(itilde - m_new)
    c = f_eff * state.c + i_eff * torch.tanh(ztilde)
    n = f_eff * state.n + i_eff
    h = torch.sigmoid(otilde) * c / torch.clamp(n, min=1e-6)
    return SLSTMState(c=c, n=n, h=h, m=m_new)


def slstm_scan(mod: SLSTM, x, cfg, state: SLSTMState | None = None):
    """x: (B, S, D) -> (h (B, S, D) in x's dtype, the state after S steps);
    a loop over time (`layers.scan`) from `state` (None: `slstm_init_state`).

    Under a mesh the loop runs on each rank's shards as plain tensors
    (`partition.on_shards`), where DTensor would dispatch every op of every
    step: after `w_gates` the cell is elementwise per batch row, but its
    recurrent term mixes the whole width and the loop the whole sequence,
    so w_gates' output and the cell's weights are gathered over every axis
    but the batch first, and the result is placed as that output is."""
    wx = constrain(mod.w_gates(x), ("batch", None, None))  # (B, S, 4D)
    r_gates, b_gates = constrain(mod.r_gates, (None, None, None)), constrain(mod.b_gates, (None,))

    def step(st, wx_t, r_gates, b_gates):
        st = _slstm_cell(r_gates, b_gates, wx_t, SLSTMState(*st), cfg.n_heads)
        return st, st.h

    def loop(wx, r_gates, b_gates, *st):
        st = st or slstm_init_state(cfg, wx.shape[0], wx.device)
        # the weights in f32 once, not at every step
        h, st = layers.scan(step, tuple(st), (wx,), (r_gates.to(_F32), b_gates.to(_F32)))
        return (h.to(x.dtype), *st)

    h, *st = partition.on_shards(loop, wx, r_gates, b_gates, *(state or ()))
    return h, SLSTMState(*st)


def slstm_block_from_scan(mod: SLSTM, x, hseq):
    """The block's output from the cell's h sequence: the norm, the cell
    residual inside the block, the FFN."""
    h = layers.rmsnorm(hseq.to(x.dtype), mod.gn.scale)
    z = layers.rmsnorm(x + h, mod.ffn_norm.scale)
    return layers.mlp_apply(mod.ffn, z, "geglu") + h


def slstm_block_train(mod: SLSTM, x, cfg) -> torch.Tensor:
    h, _ = slstm_scan(mod, x, cfg)
    return slstm_block_from_scan(mod, x, h)


def slstm_block_decode(mod: SLSTM, x, cfg, state: SLSTMState):
    """One step; the state written in place."""
    new = _slstm_cell(mod.r_gates, mod.b_gates, mod.w_gates(x[:, 0]), state, cfg.n_heads)
    for dst, src in zip(state, new):
        dst.copy_(src)
    return slstm_block_from_scan(mod, x, state.h[:, None]), state


def slstm_init_state(cfg, batch: int, device) -> SLSTMState:
    D = cfg.d_model

    def zeros():
        return torch.zeros((batch, D), dtype=_F32, device=device)

    return SLSTMState(c=zeros(), n=zeros(), h=zeros(),
                      m=torch.full((batch, D), -1e30, dtype=_F32, device=device))
