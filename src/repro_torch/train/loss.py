"""Loss utilities, including sequence-chunked cross-entropy.

The port of `repro/train/loss.py`. The naive CE materialises (B, S, V)
float32 logits; at gemma-2b's vocabulary of 256000 and 4096 tokens a step
that is 4.2 GB. `chunked_ce` computes the same value in slabs of S /
n_chunks positions, each under an activation checkpoint, so that autograd
keeps no slab's logits: the backward pass recomputes each slab's unembed
product, as the JAX package's remat trades it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt


def ce_from_logits(logits, labels):
    """(sum of the cross-entropy over (B, S) in float32, the count B * S)."""
    logits = logits.to(torch.float32)
    # the gold logit as a masked sum over the vocabulary, exact (one term is
    # not zero): on a vocab-sharded DTensor it is a local product and a
    # partial sum, where a gather takes DTensor's masked-partial route,
    # which a checkpoint's recomputation breaks
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(labels[..., None].long() == vocab, logits, 0.0).sum(dim=-1)
    return (torch.logsumexp(logits, dim=-1) - gold).sum(), logits.shape[0] * logits.shape[1]


def _chunk_ce(x, w_out, labels, softcap: float):
    logits = F.linear(x, w_out)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return ce_from_logits(logits, labels)[0]


def chunked_ce(x, w_out, labels, n_chunks: int = 8, softcap: float = 0.0):
    """x (B, S, D) final hidden states; w_out (V, D), the unembedding in
    nn.Linear's layout (the JAX package's transpose); labels (B, S). The
    mean CE over B * S in float32. n_chunks drops to the largest divisor of
    S not above it, as in the JAX package."""
    B, S, _ = x.shape
    n_chunks = max(1, min(n_chunks, S))
    while S % n_chunks:
        n_chunks -= 1
    L = S // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S, L):
        total = total + ckpt.checkpoint(_chunk_ce, x[:, c:c + L], w_out, labels[:, c:c + L],
                                        softcap, use_reentrant=False)
    return total / (B * S)
