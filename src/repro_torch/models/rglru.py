"""RG-LRU recurrent block (Griffin / RecurrentGemma).

The port of `repro/models/rglru.py`. Block: x -> [W1 -> causal depthwise
conv(4) -> RG-LRU] * gelu(W2 x) -> W_out.

RG-LRU (per channel):
    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    log a_t = -c * softplus(Lambda) * r_t (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A prompt runs the linear recurrence as a log-depth scan over time, where
the JAX package calls `jax.lax.associative_scan`: Hillis-Steele doubling over
the (a, b) pairs with (a1, b1) o (a2, b2) = (a1 a2, b1 a2 + b2), ceil(log2 S)
rounds of elementwise ops on the whole (B, S, R) tensors, never a loop over
S. The two scans associate the products in another order, so their h differ
by f32 rounding (the tests bound it). Decode is one step carrying (h, the
last W - 1 conv inputs), written into the state in place.

The gates are computed in float32 from the conv output, with the weights
cast to float32, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.sharding import partition
from repro_torch.sharding.partition import constrain

_C = 8.0


class RGLRUState(NamedTuple):
    h: torch.Tensor     # (B, R) recurrent state, float32
    conv: torch.Tensor  # (B, W-1, R) last conv inputs, in the model's dtype


class RGLRU(nn.Module):
    """w_in1, w_in2 (D -> R), w_out (R -> D), w_a, w_x (R -> R), the depthwise
    conv_w (W, R), the biases b_a, b_x and lambda_raw (R,)."""

    AXES = {"w_in1.weight": ("mlp", "fsdp"), "w_in2.weight": ("mlp", "fsdp"),
            "w_out.weight": ("fsdp", "mlp"), "conv_w": (None, "mlp"),
            "w_a.weight": ("mlp", "mlp"), "w_x.weight": ("mlp", "mlp"),
            "b_a": ("mlp",), "b_x": ("mlp",), "lambda_raw": ("mlp",)}

    def __init__(self, gen, cfg, dtype):
        super().__init__()
        R, D, dev = cfg.lru_width or cfg.d_model, cfg.d_model, layers.device_of(gen)
        self.w_in1 = layers.dense_init(gen, D, R, dtype)
        self.w_in2 = layers.dense_init(gen, D, R, dtype)
        self.w_out = layers.dense_init(gen, R, D, dtype)
        self.conv_w = nn.Parameter(layers.normal(gen, (cfg.conv_width, R), 0.1, dtype))
        self.w_a = layers.dense_init(gen, R, R, dtype, scale=0.02)
        self.w_x = layers.dense_init(gen, R, R, dtype, scale=0.02)
        self.b_a = nn.Parameter(torch.zeros((R,), dtype=dtype, device=dev))
        self.b_x = nn.Parameter(torch.zeros((R,), dtype=dtype, device=dev))
        # Lambda so that a spans (0.9, 0.999) at r = 1 (Griffin's init range)
        lam = 0.9 + 0.099 * torch.rand((R,), generator=gen, device=dev)
        self.lambda_raw = nn.Parameter(torch.log(torch.expm1(-torch.log(lam) / _C)).to(dtype))


def rglru_init(gen, cfg, dtype) -> RGLRU:
    return RGLRU(gen, cfg, dtype)


def _gates(mod: RGLRU, u):
    """u: (..., R) conv output -> (a, b) in float32. Under a mesh u is laid
    out by batch and channels, as w_a's and w_x's input channels are
    (row-parallel): each product's partial sums are reduce-scattered onto
    the channels before the bias, which is sharded so."""
    lead = ("batch",) + (None,) * (u.ndim - 2)
    uf = constrain(u.to(torch.float32), lead + ("mlp",))

    def gate(lin, bias):
        z = constrain(F.linear(uf, lin.weight.to(torch.float32)), lead + ("mlp",))
        return torch.sigmoid(z + bias.to(torch.float32))

    r, i = gate(mod.w_a, mod.b_a), gate(mod.w_x, mod.b_x)
    log_a = -_C * F.softplus(mod.lambda_raw.to(torch.float32)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * i * uf
    return a, b


def _conv_train(conv_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over (B, S, R): y_t = sum_i w_i x_{t-W+1+i}."""
    W, S = conv_w.shape[0], x.shape[1]
    acc = torch.zeros_like(x)
    for i in range(W):
        shift = W - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :S]
        acc = acc + conv_w[i] * xi
    return acc


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 over axis 1 of (B, S, R), in
    ceil(log2 S) doubling rounds (Hillis-Steele): after the round of offset
    k, (a_t, b_t) is the composition of steps t - 2k + 1 .. t."""
    S = a.shape[1]
    k = 1
    while k < S:
        b = torch.cat([b[:, :k], b[:, :-k] * a[:, k:] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    return b


def _rglru_scan(mod: RGLRU, x):
    """The prompt pass: (u1, u2, h) of x (B, S, D); h (B, S, R) float32.
    Under a mesh the conv and the scan run on each rank's shards
    (`partition.on_shards`): both mix only the sequence, which u1 and the
    gates hold whole (batch and channels sharded, the conv's taps sharded
    on the channels as u1 is)."""
    u1 = constrain(mod.w_in1(x), ("batch", None, "mlp"))
    u2 = mod.w_in2(x)
    conv_w = constrain(mod.conv_w, (None, "mlp"))
    c = partition.on_shards(lambda u, w: _conv_train(w, u), u1, conv_w)
    a, b = (constrain(t, ("batch", None, "mlp")) for t in _gates(mod, c))
    return u1, u2, partition.on_shards(linear_scan, a, b)


def _out(mod: RGLRU, h, u2, dtype):
    y = h.to(dtype) * F.gelu(u2, approximate="tanh")
    return mod.w_out(constrain(y, ("batch",) + (None,) * (y.ndim - 2) + ("mlp",)))


def rglru_train(mod: RGLRU, x, cfg) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D), the whole sequence through the scan."""
    _, u2, h = _rglru_scan(mod, x)
    return _out(mod, h, u2, x.dtype)


def rglru_init_state(cfg, batch: int, dtype, device) -> RGLRUState:
    R = cfg.lru_width or cfg.d_model
    return RGLRUState(h=torch.zeros((batch, R), dtype=torch.float32, device=device),
                      conv=torch.zeros((batch, cfg.conv_width - 1, R), dtype=dtype,
                                       device=device))


def rglru_decode(mod: RGLRU, x, cfg, state: RGLRUState):
    """x: (B, 1, D); one step. Returns (y (B, 1, D), state) with the state
    written in place."""
    u1 = mod.w_in1(x[:, 0])  # (B, R)
    u2 = mod.w_in2(x[:, 0])
    window = torch.cat([state.conv, u1[:, None].to(state.conv.dtype)], dim=1)
    # the taps' product on each rank's shards: the window and the taps are
    # laid out on the channels alike (the state's layout)
    window = constrain(window, ("kv_batch", None, "mlp"))
    c = partition.einsum("bwr,wr->br", window.to(x.dtype), constrain(mod.conv_w, (None, "mlp")))
    a, b = _gates(mod, c)
    h = a * state.h + b
    state.h.copy_(h)
    state.conv.copy_(window[:, 1:])
    return _out(mod, h, u2, x.dtype)[:, None], state
