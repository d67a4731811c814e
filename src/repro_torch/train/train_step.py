"""Train step: loss -> grads (microbatched) -> int8 error-feedback
compression -> clipping, schedule and AdamW, on one device or sharded over
a DeviceMesh.

The port of `repro/train/train_step.py`:

    state = init_state(cfg, tcfg, seed, device)
    step_fn = make_train_step(cfg, tcfg)
    state, metrics = step_fn(state, batch, gen)

Sharded (the JAX driver's `axis_rules` + `struct_shardings` + jit):

    with partition.axis_rules(mesh, rules):
        state = init_state(cfg, tcfg, seed, device, mesh=mesh, rules=rules)
        step_fn = make_train_step(cfg, tcfg, param_axes=state_axes(state).params)
        state, metrics = step_fn(state, dtensor_batch, gen)

There the parameters are DTensors placed by `partition.struct_shardings` of
their logical axes (`DecoderLM.param_axes`), the AdamW moments and the
error-feedback residuals take their parameter's placements (JAX's
`adamw.opt_state_axes`), and the step runs under DTensor's
`implicit_replication`, so a tensor the model makes itself (a mask, RoPE's
angles, an `arange`, a zero state, the router's Gumbel draws) counts as
replicated. The model gathers each layer's parameters over their fsdp axis
where the layer runs, again when a checkpoint recomputes it
(`layers.fsdp_gathered`). With `param_axes` the gradients are constrained
to their parameter's layout before compression and AdamW, as JAX's step
constrains them (the gathers' backward reduce-scatters into the FSDP
shards). Microbatches split each rank's local shard of the batch.

The state is a NamedTuple like the JAX one: `params` is the model (a
`DecoderLM`), `opt` AdamW's moments and count, `ef` the error-feedback
residuals (None without compression), `step` an int. `step_fn` updates the
model's parameters and the moments in place and returns the state with
the new counts. `gen`: the `torch.Generator` the Boltzmann router draws
from (None for a config that draws nothing); the microbatches draw from it
one after another, where the JAX package splits its key per microbatch.

Gradients: `torch.autograd.grad` of the loss in the parameters' dtype for
a whole batch, as JAX differentiates; with microbatches each one's
gradients are added into float32 buffers and divided by their count
(`.grad` would accumulate in the parameters' dtype), as the JAX package's
float32 accumulator does. The metrics are 0-d tensors on the device:
loss, ce_loss, aux_loss, grad_norm, and lr_scale (a CPU float32 scalar).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.models import convert, layers, model
from repro_torch.optim import adamw, compression, schedules
from repro_torch.sharding import partition


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    microbatch: int = 0            # 0 = no gradient accumulation
    warmup_steps: int = 100
    total_steps: int = 10_000
    compress_grads: bool = False   # int8 + error feedback on the gradients


class TrainState(NamedTuple):
    params: model.DecoderLM
    opt: adamw.OptState
    ef: Optional[compression.EFState]
    step: int


def init_state(cfg, tcfg: TrainConfig, seed: int = 0, device=None, *, mesh=None,
               rules: Optional[dict] = None) -> TrainState:
    """A model with random weights from `seed` on `device` (None: the CUDA
    device), zero moments (and residuals with compression), step 0. With a
    `mesh` every parameter becomes a DTensor placed by its logical axes
    under `rules` (`shard_params`), and the moments and residuals follow."""
    m = model.init_params(cfg, seed, device)
    if mesh is not None:
        shard_params(m, mesh, rules)
    params = dict(m.named_parameters())
    ef = compression.init(params) if tcfg.compress_grads else None
    return TrainState(params=m, opt=adamw.init(params), ef=ef, step=0)


def shard_params(m: torch.nn.Module, mesh, rules: Optional[dict] = None) -> None:
    """Replace every parameter of `m` (the same whole tensor on every rank)
    by a DTensor placed by `partition.struct_shardings` of its logical axes:
    each rank keeps its shard."""
    named = dict(m.named_parameters())
    placements = partition.struct_shardings(named, m.param_axes(), mesh, rules,
                                            transposed=layers.linear_weights(m))
    for name, p in named.items():
        owner, _, leaf = name.rpartition(".")
        setattr(m.get_submodule(owner), leaf, torch.nn.Parameter(
            partition.distribute(p.detach(), mesh, placements[name]), requires_grad=p.requires_grad))


def state_axes(state: TrainState) -> TrainState:
    """The logical axes of a train state, {name: axes} per part: the moments
    and the residuals take their parameter's axes; the counts are scalars."""
    axes = state.params.param_axes()
    return TrainState(params=axes, opt=adamw.OptState(mu=axes, nu=axes, count=()),
                      ef=compression.EFState(residual=axes) if state.ef is not None else None,
                      step=())


def _microbatch(v: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Rows i/n of the batch tensor v; of a DTensor, rows i/n of each rank's
    local shard (the batch axis may be split over the mesh)."""
    local = v.to_local() if hasattr(v, "to_local") else v
    if local.shape[0] % n:
        raise ValueError(f"a batch shard of {local.shape[0]} rows does not split into {n} "
                         "microbatches")
    mb = local.shape[0] // n
    part = local[i * mb:(i + 1) * mb]
    if local is v:
        return part
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(part, v.device_mesh, v.placements, run_check=False)


def sharded_step():
    """DTensor's implicit replication under an active mesh: the plain
    tensors the model makes count as replicated."""
    if partition.active_mesh() is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def make_train_step(cfg, tcfg: TrainConfig, param_axes: Optional[dict] = None):
    """Returns step_fn(state, batch, gen=None) -> (state, metrics).

    param_axes: {name: logical axes} of the parameters; when given, each
    gradient is constrained to its parameter's layout before compression
    and AdamW (a no-op without an active mesh)."""

    def grads_of(m, params: dict, batch: dict, gen):
        B = batch["tokens"].shape[0]
        mb = tcfg.microbatch
        if not mb or mb >= B:
            loss, metrics = m.train_forward(batch, gen)
            grads = torch.autograd.grad(loss, list(params.values()))
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(
                zip(params, grads))
        if B % mb:
            raise ValueError(f"batch {B} is no multiple of the microbatch {mb}")
        n = B // mb
        acc = {name: torch.zeros_like(p, dtype=torch.float32) for name, p in params.items()}
        loss_sum, sums = 0.0, {}
        for i in range(n):
            part = {k: _microbatch(v, i, n) for k, v in batch.items()}
            loss, metrics = m.train_forward(part, gen)
            grads = torch.autograd.grad(loss, list(params.values()))
            for a, g in zip(acc.values(), grads):
                a.add_(g)
            loss_sum = loss_sum + loss.detach()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
        return (loss_sum / n, {k: v / n for k, v in sums.items()},
                {name: a / n for name, a in acc.items()})

    decay = None

    def step_fn(state: TrainState, batch: dict, gen: torch.Generator | None = None):
        nonlocal decay
        m = state.params
        params = dict(m.named_parameters())
        if decay is None:
            decay = convert.decay_mask(cfg, params)
        with sharded_step():
            loss, metrics, grads = grads_of(m, params, batch, gen)
            if param_axes is not None:
                grads = {k: partition.constrain(g, param_axes[k]) for k, g in grads.items()}
            ef = state.ef
            if tcfg.compress_grads:
                grads, ef = compression.compress(grads, ef)
            lr_scale = schedules.cosine_with_warmup(state.step, tcfg.warmup_steps,
                                                    tcfg.total_steps)
            opt, opt_m = adamw.update(grads, state.opt, params, tcfg.optimizer, lr_scale,
                                      decay=decay)
        metrics.update(opt_m, loss=loss, lr_scale=lr_scale)
        return TrainState(params=m, opt=opt, ef=ef, step=state.step + 1), metrics

    return step_fn
