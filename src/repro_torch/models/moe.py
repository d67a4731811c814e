"""Mixture-of-Experts FFN: capacity-factor one-hot dispatch, shared experts,
and the PASS-inspired Boltzmann sampled router.

The port of `repro/models/moe.py`. Tokens are reshaped into groups of
`group_size`; each group dispatches into per-expert capacity slots
C = ceil(group_size * top_k / n_experts * capacity_factor), rounded up to a
multiple of 4 and at least 4. A token's slot in an expert is the running
count of the group's earlier (token, choice) pairs routed there, counted
token-major and then choice-major; tokens past an expert's capacity are
dropped (they contribute zero; the residual stream carries them).
Dispatch and combine are one-hot einsums, as in the JAX package.

Router modes:
  * 'topk'      — deterministic softmax top-k (what serving uses)
  * 'boltzmann' — experts sampled without replacement from the router's
    Boltzmann distribution by Gumbel perturbation. The Gumbel draws are an
    operand (`gumbel`, the shape of the router logits), so a test can feed
    the JAX package's own.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.sharding import partition
from repro_torch.sharding.partition import active_axis_size, constrain


class MoE(nn.Module):
    """router (nn.Linear, d_model -> n_experts); w_gate (gated activations
    only) and w_up (E, d_model, d_expert) and w_down (E, d_expert, d_model),
    in the JAX package's layout; with shared experts, `shared` (an MLP of
    width n_shared * d_expert) and `shared_gate` (d_model -> 1)."""

    AXES = {"router.weight": (None, "fsdp"), "w_gate": ("experts", "fsdp", "mlp"),
            "w_up": ("experts", "fsdp", "mlp"), "w_down": ("experts", "mlp", "fsdp"),
            "shared_gate.weight": (None, "fsdp")}

    def __init__(self, gen, cfg, dtype):
        super().__init__()
        m = cfg.moe
        self.router = layers.dense_init(gen, cfg.d_model, m.n_experts, dtype, scale=0.02)
        shp_in = (m.n_experts, cfg.d_model, m.d_expert)
        shp_out = (m.n_experts, m.d_expert, cfg.d_model)

        def expert_w(shape):
            return nn.Parameter(layers.normal(gen, shape, 1.0 / math.sqrt(shape[1]), dtype))

        if cfg.act in ("swiglu", "geglu"):
            self.w_gate = expert_w(shp_in)
        self.w_up = expert_w(shp_in)
        self.w_down = expert_w(shp_out)
        if m.n_shared > 0:
            self.shared = layers.mlp_init(gen, cfg.d_model, m.n_shared * m.d_expert, cfg.act,
                                          dtype)
            self.shared_gate = layers.dense_init(gen, cfg.d_model, 1, dtype, scale=0.02)


def moe_init(gen, cfg, dtype) -> MoE:
    return MoE(gen, cfg, dtype)


def _capacity(group_size: int, m) -> int:
    c = math.ceil(group_size * m.top_k / m.n_experts * m.capacity_factor)
    return max(4, int(math.ceil(c / 4) * 4))


def router_shape(cfg, n_tokens: int) -> tuple[int, int, int]:
    """(G, gs, E): the router logits' shape for n_tokens tokens, the shape
    of the Boltzmann router's Gumbel draws."""
    m = cfg.moe
    gs = min(m.group_size, n_tokens)
    return -(-n_tokens // gs), gs, m.n_experts


def draw_gumbel(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel draws -log(-log u), u uniform in [tiny, 1) from `gen`
    (on its own device), as jax.random.gumbel draws them; then moved to
    `device`, so a CPU generator gives the card and the CPU the same draws."""
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def _select_experts(logits, m, gumbel=None):
    """Return (indices (..., k), weights (..., k), probs (..., E))."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    scores = logits.to(torch.float32)
    if m.router_mode == "boltzmann":
        if gumbel is None:
            raise ValueError("the boltzmann router needs its Gumbel draws (`gumbel`)")
        scores = scores / m.router_temp + gumbel.to(torch.float32)
    # a stable sort puts the lower index first among tied scores, as
    # lax.top_k does (torch.topk leaves their order open); the padded
    # tokens' all-zero logits tie everywhere
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., : m.top_k]
    w = torch.gather(probs, -1, idx)
    w = w / w.sum(dim=-1, keepdim=True)
    return idx, w, probs


def moe_apply(moe: MoE, x, cfg, gumbel=None, *, with_aux: bool = False):
    """x: (B, S, D) -> out (B, S, D), or (out, aux_loss scalar) with
    `with_aux` (training; serving drops the loss and does not compute it).
    `gumbel` (G, gs, E): the Boltzmann router's draws, G groups of gs tokens
    after padding."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    gs = min(m.group_size, T)
    pad = (-T) % gs  # pad T to a multiple of the group size
    G = (T + pad) // gs
    # under a mesh the tokens are sharded on the batch alone, and on none
    # where the groups do not divide the batch axes: then the merge of
    # (B, S) into tokens and their split into (G, gs) keep that sharding
    # (`partition.reshape`: the sharded dimension leads both, evenly)
    batch = "batch" if G % active_axis_size("batch") == 0 else None
    # expert parallelism where the tensor axis divides the experts (their
    # weights are sharded on them); otherwise the weights are sharded on
    # their FFN width (the rules' next mapping) and the experts' inputs
    # stay whole on the tensor axis: GSPMD pads 60 experts to 64 on 16
    # ranks, DTensor pads nothing
    experts = "experts" if m.n_experts % active_axis_size("experts") == 0 else None
    x = constrain(x, (batch, None, None))
    tokens = partition.reshape(x, (T, D))
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    xg = constrain(partition.reshape(tokens, (G, gs, D)), (batch, None, None))

    # the routing is laid out as the tokens: the einsums below take it so
    logits = constrain(moe.router(xg), (batch, None, None))  # (G, gs, E)
    idx, w, probs = _select_experts(logits, m, gumbel)  # (G,gs,k), (G,gs,k)

    C = _capacity(gs, m)
    # (G,gs,k,E); a comparison, since F.one_hot checks its indices on the host
    onehot = (idx[..., None] == torch.arange(m.n_experts, device=x.device)).to(torch.float32)
    # capacity slot per (token, choice): running count of earlier tokens
    # routed to the same expert within the group
    pos_in_expert = torch.cumsum(partition.reshape(onehot, (G, gs * m.top_k, m.n_experts)), dim=1)
    pos_in_expert = partition.reshape(pos_in_expert, (G, gs, m.top_k, m.n_experts)) * onehot - 1.0
    kept = (pos_in_expert < C) & (pos_in_expert >= 0)
    # one_hot of the slot, all zeros for -1 (not routed) and for slots >= C
    slot_oh = (pos_in_expert[..., None] == torch.arange(C, device=x.device)).to(torch.float32)
    slot_oh = slot_oh * kept.to(torch.float32)[..., None]
    # the einsums on each rank's shards (`partition.einsum`): torch's bmm
    # would flatten a sharded dimension inside a run of dimensions
    dispatch = partition.einsum("gske,gskec->gsec", onehot, slot_oh)
    # dispatch: (G, gs, E, C) — 1 where token s goes to expert e slot c
    combine = dispatch * (w[..., None] * onehot).sum(dim=2)[..., None]

    expert_in = partition.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
    expert_in = constrain(expert_in, (batch, experts, None, None))
    # the weights as the products use them: sharded on the experts or on
    # their FFN width, gathered over their fsdp axis (a serving step's
    # weights are still fsdp-sharded; a training layer's gathered already)
    ffn = None if experts else "mlp"
    w_in = (experts, None, ffn)
    up = partition.einsum("gecd,edf->gecf", expert_in, constrain(moe.w_up, w_in))
    if hasattr(moe, "w_gate"):
        gate = partition.einsum("gecd,edf->gecf", expert_in, constrain(moe.w_gate, w_in))
        h = (F.silu(gate) if cfg.act == "swiglu" else F.gelu(gate, approximate="tanh")) * up
    else:
        h = F.gelu(up, approximate="tanh")
    expert_out = partition.einsum("gecf,efd->gecd", h, constrain(moe.w_down, (experts, ffn, None)))
    expert_out = constrain(expert_out, (batch, experts, None, None))
    out = partition.einsum("gsec,gecd->gsd", combine.to(x.dtype), expert_out)
    out = partition.reshape(constrain(out, (batch, None, None)), (-1, D))
    out = partition.reshape(out[:T] if pad else out, (B, S, D))

    if m.n_shared > 0:
        # the shared experts' partial sums reduced here, laid out as the
        # routed output (batch-sharded): in the backward pass the gate's
        # gradient then reaches its matmul with the sequence whole
        shared = constrain(layers.mlp_apply(moe.shared, x, cfg.act), (batch, None, None))
        out = out + torch.sigmoid(moe.shared_gate(x)) * shared

    if not with_aux:
        return out
    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e
    f = onehot.sum(dim=2).mean(dim=(0, 1))  # fraction routed
    p = probs.mean(dim=(0, 1))  # mean router prob
    return out, m.n_experts * (f * p).sum() * m.aux_loss_weight
