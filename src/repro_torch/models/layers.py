"""Shared layer primitives: norms, RoPE, MLPs, embeddings.

The port of `repro/models/layers.py`. Weights live in modules: a dense
weight is an `nn.Linear` of shape (d_out, d_in), the transpose of the JAX
package's (d_in, d_out) array applied as `x @ W`. Initialisers draw from an
explicit `torch.Generator` on the device the weights are made on, at the JAX
package's scales (1/sqrt(d_in); 0.02 for the embedding and the untied head);
torch cannot replay JAX's random stream, so `convert.params_from_jax` carries
JAX weights across where the two must agree.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.sharding import partition
from repro_torch.sharding.partition import constrain

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def device_of(gen: torch.Generator) -> torch.device:
    """Where the parameters drawn from `gen` are made: the generator's own
    device, or the meta device inside `torch.device("meta")` (shapes only,
    no memory: `model.init_params(..., device="meta")`)."""
    default = torch.get_default_device()
    return default if default.type == "meta" else gen.device


def normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """N(0, scale^2) drawn in float32 on `device_of(gen)`, then cast."""
    return (torch.randn(shape, generator=gen, device=device_of(gen)) * scale).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, scale: Optional[float] = None,
               bias: bool = False) -> nn.Linear:
    """An `nn.Linear(d_in, d_out)` with weights N(0, scale^2), scale
    1/sqrt(d_in) by default, and a zero bias when `bias`; made on the
    generator's device, never on the host."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    lin = nn.utils.skip_init(nn.Linear, d_in, d_out, bias=bias, device=device_of(gen), dtype=dtype)
    lin.weight = nn.Parameter(normal(gen, (d_out, d_in), scale, dtype))
    if bias:
        lin.bias = nn.Parameter(torch.zeros((d_out,), dtype=dtype, device=device_of(gen)))
    return lin


def param_axes(module: nn.Module) -> dict[str, tuple]:
    """{name: logical axes} of every parameter of `module`, as the `AXES`
    table of the module class that owns it declares them: the JAX leaf's
    axes without the stacked "layers" axis, reversed for an nn.Linear weight
    (the transpose of the JAX layout). A parameter no table declares, or
    axes of another rank than the parameter's, raise."""
    declared = {}
    for prefix, mod in module.named_modules():
        for local, axes in getattr(type(mod), "AXES", {}).items():
            declared[f"{prefix}.{local}" if prefix else local] = axes
    out = {}
    for name, p in module.named_parameters():
        if name not in declared:
            raise KeyError(f"no AXES entry declares the parameter {name}")
        if len(declared[name]) != p.ndim:
            raise ValueError(f"{name}: axes {declared[name]} for shape {tuple(p.shape)}")
        out[name] = declared[name]
    return out


@contextlib.contextmanager
def fsdp_gathered(module: nn.Module):
    """Within, `module` computes with each parameter all-gathered over the
    mesh axes of its "fsdp" dimension, when the active rules map "fsdp" to
    more than one device: each parameter stays sharded and is gathered
    where its layer runs, as FSDP does, and the gather's backward
    reduce-scatters the gradient into the shards. A layer list's (an
    nn.ModuleList child's) parameters are left to each layer, which gathers
    its own: inside its checkpointed region, so the recomputation gathers
    again and a rank holds one layer's gathered weights at a time. Without
    such rules nothing changes.

    DTensor picks each op's strategy by the cost of moving its inputs
    alone: left to it, a product of batch-sharded activations with an
    fsdp-sharded weight contracts the sharded dimension and all-reduces the
    whole output (the vocabulary's logits, at gemma-2b's 256000)."""
    if partition.active_axis_size("fsdp") == 1:
        yield
        return
    from torch.nn.utils.stateless import _reparametrize_module

    lists = {n for n, c in module.named_children() if isinstance(c, nn.ModuleList)}
    axes = param_axes(module)
    full = {}
    for name, p in module.named_parameters():
        if name.split(".")[0] in lists or "fsdp" not in axes[name]:
            continue
        d = axes[name].index("fsdp")
        placements = tuple(Replicate() if pl.is_shard(d) else pl for pl in p.placements)
        if placements != tuple(p.placements):
            full[name] = p.redistribute(p.device_mesh, placements)
    with _reparametrize_module(module, full):
        yield


def linear_weights(module: nn.Module) -> set[str]:
    """The names of the nn.Linear weights of `module`: each the transpose of
    its JAX leaf."""
    return {f"{n}.weight" if n else "weight" for n, mod in module.named_modules()
            if isinstance(mod, nn.Linear)}


class Norm(nn.Module):
    """The scale of an rmsnorm or a layernorm (no bias, as in the JAX package)."""

    AXES = {"scale": (None,)}

    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((d,), dtype=dtype, device=device))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In float32, cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """In float32, cast back to x's dtype; no bias (the JAX package's norms
    have none)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def apply_norm(kind: str, norm: Norm, x: torch.Tensor) -> torch.Tensor:
    """The norm of a block's (or the model's) input. Under a mesh its output
    is gathered over every axis but the batch's: it feeds the projections,
    and a sequence-parallel residual (batch and sequence both sharded) is
    gathered once here, where DTensor would gather it at each projection
    (and its older releases cannot flatten the two sharded dimensions)."""
    y = rmsnorm(x, norm.scale) if kind == "rmsnorm" else layernorm(x, norm.scale)
    return constrain(y, ("batch",) + (None,) * (y.ndim - 1))


def residual(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """x + delta, a block's residual add, with delta laid out as the
    residual stream first (a no-op without a mesh). Under sequence
    parallelism a projection's partial sums then reduce-scatter onto the
    sequence, and in the backward pass the residual's sequence-sharded
    gradient is gathered here, before the projection's matmul flattens
    batch and sequence into one dimension: a merge that keeps only its
    leading dimension sharded (`partition.reshape`), where DTensor would
    otherwise carry a strided shard of the sequence into the weight
    gradients (on a 3-D mesh, a search of its redistribution planner)."""
    return x + constrain(delta, ("batch", "seq", "embed"))


# ---------------------------------------------------------------------------
# A loop over time
# ---------------------------------------------------------------------------


def scan(step, carry: tuple, xs: tuple, consts: tuple = ()):
    """The JAX package's lax.scan over dim 1: for each t, carry, y_t =
    step(carry, *(x[:, t] for x in xs), *consts); returns (the y_t stacked
    on dim 1, the last carry). carry is a tuple of tensors.

    Under an op counter that folds loops (a dispatch mode whose
    `fold_scans` is set: launch.step_analysis.StepCounter) the body runs
    once for all S trips, forward and backward, under the counter's
    `trips(S)`, as hlo_analysis multiplies a while body by its trip count;
    its outputs then stand for every trip's, shapes and not values (the dry
    run's meta tensors hold none, and a meta op costs ~0.2 ms of Python)."""
    S = xs[0].shape[1]
    counter = next((m for m in _get_current_dispatch_mode_stack()
                    if getattr(m, "fold_scans", False)), None)
    if counter is None:
        ys = []
        for x_t in zip(*(x.unbind(1) for x in xs)):
            carry, y = step(carry, *x_t, *consts)
            ys.append(y)
        return torch.stack(ys, dim=1), tuple(carry)
    ins = (*carry, *(x[:, 0] for x in xs), *consts)
    with counter.trips(S):
        if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
            *carry, y = _OneTrip.apply(counter, S, step, len(carry), len(xs), *ins)
        else:
            carry, y = step(tuple(carry), *ins[len(carry):])
    return y.unsqueeze(1).expand(y.shape[0], S, *y.shape[1:]).contiguous(), tuple(carry)


def _kept(t):
    return t


class _OneTrip(torch.autograd.Function):
    """One trip of a folded `scan` whose backward runs under the counter's
    trips as well: the body's graph is built inside and differentiated in
    `backward`. The carry is differentiated as every trip but the first
    differentiates it, and each const's gradient is added to a running sum
    once a trip, as autograd sums a tensor's gradients over the trips that
    read it (counted; one trip's gradient stands for the sum)."""

    @staticmethod
    def forward(ctx, counter, n, step, n_carry, n_x, *ins):
        # the body's graph keeps its own saved tensors: an activation
        # checkpoint's hooks would hand them to its recomputation, which
        # rebuilds a graph of its own here
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(_kept, _kept):
            ctx.ins = [t.detach().requires_grad_(t.requires_grad or (
                i < n_carry and t.is_floating_point())) for i, t in enumerate(ins)]
            carry, y = step(tuple(ctx.ins[:n_carry]), *ctx.ins[n_carry:])
            ctx.outs = (*carry, y)
        ctx.counter, ctx.n, ctx.n_carry, ctx.n_x = counter, n, n_carry, n_x
        ctx.wanted = [t.requires_grad for t in ins]
        return tuple(t.detach() for t in ctx.outs)

    @staticmethod
    def backward(ctx, *grads):
        pairs = [(o, g) for o, g in zip(ctx.outs, grads) if o.requires_grad and g is not None]
        wants = [t for t in ctx.ins if t.requires_grad]
        with ctx.counter.trips(ctx.n):
            got = dict(zip(map(id, wants), torch.autograd.grad(
                [o for o, _ in pairs], wants, [g for _, g in pairs], allow_unused=True)))
            for t in ctx.ins[ctx.n_carry + ctx.n_x:]:
                if got.get(id(t)) is not None:
                    torch.add(got[id(t)], got[id(t)])  # the sum over trips
        return (None,) * 5 + tuple(got.get(id(t)) if want else None
                                   for t, want in zip(ctx.ins, ctx.wanted))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). The head splits
    into halves (not interleaved pairs); angles in float32."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)  # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, dtype, device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


# ---------------------------------------------------------------------------
# MLP (dense FFN): swiglu / geglu / gelu
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """w_gate (gated activations only), w_up, w_down."""

    AXES = {"w_gate.weight": ("mlp", "fsdp"), "w_up.weight": ("mlp", "fsdp"),
            "w_down.weight": ("fsdp", "mlp")}

    def __init__(self, gen, d_model: int, d_ff: int, act: str, dtype):
        super().__init__()
        if act in ("swiglu", "geglu"):
            self.w_gate = dense_init(gen, d_model, d_ff, dtype)
        self.w_up = dense_init(gen, d_model, d_ff, dtype)
        self.w_down = dense_init(gen, d_ff, d_model, dtype)


def mlp_init(gen, d_model: int, d_ff: int, act: str, dtype) -> MLP:
    return MLP(gen, d_model, d_ff, act, dtype)


def mlp_apply(mlp: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    """gelu is the tanh approximation, as in the JAX package."""
    if act == "swiglu":
        h = F.silu(mlp.w_gate(x)) * mlp.w_up(x)
    elif act == "geglu":
        h = F.gelu(mlp.w_gate(x), approximate="tanh") * mlp.w_up(x)
    else:
        h = F.gelu(mlp.w_up(x), approximate="tanh")
    h = constrain(h, ("batch",) + (None,) * (h.ndim - 2) + ("mlp",))
    return mlp.w_down(h)


# ---------------------------------------------------------------------------
# Embeddings / unembedding
# ---------------------------------------------------------------------------


def embed_init(gen, vocab: int, d_model: int, dtype) -> nn.Parameter:
    return nn.Parameter(normal(gen, (vocab, d_model), 0.02, dtype))


def embed_lookup(embed_w: torch.Tensor, tokens: torch.Tensor, scale_by_dim: bool) -> torch.Tensor:
    """With `scale_by_dim` the rows are scaled by sqrt(D) computed in their
    dtype (bf16-rounded at full width), as the JAX package does. Under a
    mesh the lookup runs on each rank's shards (`_sharded_lookup`)."""
    x = _sharded_lookup(embed_w, tokens) if isinstance(tokens, DTensor) else embed_w[tokens]
    if scale_by_dim:  # the scalar on the host: no device scalar to wait for
        x = x * float(torch.tensor(embed_w.shape[-1], dtype=x.dtype).sqrt())
    return x


def _sharded_lookup(embed_w, tokens):
    """embed_w[tokens] on each rank's shards, as GSPMD lowers a gather from a
    vocab-sharded table: the table is gathered over every axis but its
    vocabulary's, and each rank looks up the tokens of its own batch shard
    in its own vocabulary rows, zeros for the tokens other ranks hold; the
    result is a partial sum over the vocabulary's axis. DTensor's gather
    and its gradient take no batch sharded over two mesh axes on older
    releases."""
    table = constrain(embed_w, ("vocab", None))
    vocab_dims = [md for md, p in enumerate(table.placements) if p.is_shard(0)]
    if len(vocab_dims) > 1:
        raise ValueError(f"embedding placed {table.placements}: the vocabulary on two mesh axes")
    mesh = table.device_mesh
    lo = 0
    if vocab_dims:
        md = vocab_dims[0]
        lo = mesh.get_coordinate()[md] * -(-table.shape[0] // mesh.shape[md])
    placements = [Shard(0) if tp.is_shard(0) else Partial() if md in vocab_dims else Replicate()
                  for md, tp in enumerate(tokens.placements)]

    def lookup(tok, rows):
        local = tok - lo
        hit = (local >= 0) & (local < rows.shape[0])
        return rows[local.clamp(0, max(rows.shape[0] - 1, 0))] * hit[..., None].to(rows.dtype)

    return partition.on_shards(lookup, tokens, table, placements=tuple(placements),
                               shape=(*tokens.shape, table.shape[1]))


def unembed(x: torch.Tensor, w_out: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    """x (..., D) against w_out (vocab, D): the embedding itself when tied."""
    logits = F.linear(x, w_out)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return constrain(logits, ("batch",) + (None,) * (logits.ndim - 2) + ("vocab",))
