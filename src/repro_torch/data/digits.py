"""Synthetic 16x16 digit dataset (MNIST stand-in), the port of
`repro.data.digits`.

The paper downsamples MNIST digits to the 16x16 neuron core and trains one
digit class at a time (Fig. 4B). Deterministic 16x16 digit templates plus
Bernoulli pixel noise give the same protocol with an offline data source.
The templates are the JAX package's, array for array; the noise is drawn
from a `torch.Generator`, so a batch of the same seed is another draw than
the JAX one (pass the JAX batch through numpy to hold the two packages to
the same data).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ising import resolve_device

# 7-segment-inspired 16x16 templates for digits 0-9 (1=ink).
_SEGS = {
    # segment: (row slice, col slice) on a 16x16 canvas, 3px strokes
    "top": (slice(1, 3), slice(3, 13)),
    "mid": (slice(7, 9), slice(3, 13)),
    "bot": (slice(13, 15), slice(3, 13)),
    "tl": (slice(1, 9), slice(2, 4)),
    "tr": (slice(1, 9), slice(12, 14)),
    "bl": (slice(7, 15), slice(2, 4)),
    "br": (slice(7, 15), slice(12, 14)),
}

_DIGIT_SEGS = {
    0: ("top", "bot", "tl", "tr", "bl", "br"),
    1: ("tr", "br"),
    2: ("top", "mid", "bot", "tr", "bl"),
    3: ("top", "mid", "bot", "tr", "br"),
    4: ("mid", "tl", "tr", "br"),
    5: ("top", "mid", "bot", "tl", "br"),
    6: ("top", "mid", "bot", "tl", "bl", "br"),
    7: ("top", "tr", "br"),
    8: ("top", "mid", "bot", "tl", "tr", "bl", "br"),
    9: ("top", "mid", "bot", "tl", "tr", "br"),
}


def digit_template(d: int) -> np.ndarray:
    """(16,16) ±1 template for digit d."""
    canvas = np.zeros((16, 16), np.float32)
    for seg in _DIGIT_SEGS[d % 10]:
        rs, cs = _SEGS[seg]
        canvas[rs, cs] = 1.0
    return 2.0 * canvas - 1.0


def digit_batch(d: int, n: int, generator: torch.Generator, flip_prob: float = 0.05,
                device=None) -> torch.Tensor:
    """(n,16,16) ±1 noisy samples of digit d on `device` (None: the CUDA
    device), each pixel flipped w.p. `flip_prob`; `generator` lives there."""
    dev = resolve_device(device)
    t = torch.tensor(digit_template(d), device=dev)
    flips = torch.rand((n, 16, 16), generator=generator, device=dev) < flip_prob
    return torch.where(flips, -t, t)


def mixed_batch(digits_list, n_each: int, generator: torch.Generator, flip_prob: float = 0.05,
                device=None) -> torch.Tensor:
    """`n_each` noisy samples of every digit in `digits_list`, in order."""
    return torch.cat([digit_batch(d, n_each, generator, flip_prob, device) for d in digits_list])
