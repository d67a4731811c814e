"""Train step: loss -> grads (microbatched) -> int8 error-feedback
compression -> clipping, schedule and AdamW.

The port of `repro/train/train_step.py`, on one device (the JAX package's
sharding constraints and its compressed reduce across a mesh need
`sharding/`, which is not ported):

    state = init_state(cfg, tcfg, seed, device)
    step_fn = make_train_step(cfg, tcfg)
    state, metrics = step_fn(state, batch, gen)

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

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.models import convert, model
from repro_torch.optim import adamw, compression, schedules


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


def init_state(cfg, tcfg: TrainConfig, seed: int = 0, device=None) -> TrainState:
    """A model with random weights from `seed` on `device` (None: the CUDA
    device), zero moments (and residuals with compression), step 0."""
    m = model.init_params(cfg, seed, device)
    params = dict(m.named_parameters())
    ef = compression.init(params) if tcfg.compress_grads else None
    return TrainState(params=m, opt=adamw.init(params), ef=ef, step=0)


def make_train_step(cfg, tcfg: TrainConfig):
    """Returns step_fn(state, batch, gen=None) -> (state, metrics)."""

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
        acc = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for name, p in params.items()}
        loss_sum, sums = 0.0, {}
        for i in range(n):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
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
        loss, metrics, grads = grads_of(m, params, batch, gen)
        ef = state.ef
        if tcfg.compress_grads:
            grads, ef = compression.compress(grads, ef)
        lr_scale = schedules.cosine_with_warmup(state.step, tcfg.warmup_steps, tcfg.total_steps)
        opt, opt_m = adamw.update(grads, state.opt, params, tcfg.optimizer, lr_scale,
                                  decay=decay)
        metrics.update(opt_m, loss=loss, lr_scale=lr_scale)
        return TrainState(params=m, opt=opt, ef=ef, step=state.step + 1), metrics

    return step_fn
