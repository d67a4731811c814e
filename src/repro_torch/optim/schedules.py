"""LR schedules (pure functions of the step counter).

The port of `repro/optim/schedules.py`, computed on the host in float32,
op for op as the JAX package computes it, so the scale is the JAX one bit
for bit (a CPU float32 scalar; the train step reads it as a Python float).
The cosine is the C library's float32 `cosf`, the function XLA's CPU
backend lowers `jnp.cos` of a float32 to; torch's float32 cosine and a
float64 cosine rounded to float32 each differ from it by an ulp at some
steps.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import torch

_F32 = torch.float32


@functools.cache
def _cosf():
    fn = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


def cosine_with_warmup(step, warmup_steps: int, total_steps: int,
                       min_ratio: float = 0.1) -> torch.Tensor:
    """A multiplicative lr scale in [min_ratio, 1] after the warmup, which
    starts at 0 at step 0: a float32 scalar on the CPU."""
    step = torch.as_tensor(step).to(_F32)
    warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = torch.tensor(_cosf()((math.pi * frac).item()), dtype=_F32)
    return warm * (min_ratio + (1 - min_ratio) * 0.5 * (1 + cos))


def constant(step) -> torch.Tensor:
    return torch.ones_like(torch.as_tensor(step, dtype=_F32))
