"""Deterministic, host-shardable synthetic token pipeline.

The port of `repro/data/pipeline.py`. Each host generates only its shard of
the global batch (`global_batch // n_hosts` rows), a pure function of
(seed, step, host), so any host can recompute any batch and a restarted run
resumes from the step counter alone.

Token ids are Zipf-distributed: uniforms mapped through the Zipf CDF by
`ids_from_uniforms` (searchsorted, then clipped to the vocabulary), the JAX
package's own step. torch cannot replay JAX's threefry stream, so the
uniforms come from a CPU `torch.Generator` seeded from (seed, step, host):
the ids are the port's own, the same on every device, and a test feeds
`ids_from_uniforms` JAX's uniforms to hold the mapping. As in the JAX
package the CDF spans min(vocab_size, 65536) ranks, so a larger vocabulary
(gemma-2b's 256000) only sees ids below 65536 (a reference quirk).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.ising import resolve_device

CDF_RANKS = 65536


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    zipf_alpha: float = 1.1
    seed: int = 0


def _zipf_cdf(vocab_size: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    w = ranks**-alpha
    cdf = np.cumsum(w)
    return (cdf / cdf[-1]).astype(np.float32)


def ids_from_uniforms(cdf: torch.Tensor, u: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """int32 ids: the first rank whose CDF is >= u (searchsorted, side
    left), clipped to vocab_size - 1."""
    ids = torch.searchsorted(cdf, u).to(torch.int32)
    return torch.clamp(ids, 0, vocab_size - 1)


def _seed(seed: int, step: int, host: int) -> int:
    return int(np.random.SeedSequence((seed, step, host)).generate_state(1, np.uint64)[0] >> 1)


class TokenPipeline:
    """Stateless-batch pipeline: batch(step, host) is a pure function; the
    batches are made on the CPU and moved to `device` (None: the CUDA
    device)."""

    def __init__(self, cfg: DataConfig, device=None):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not split across "
                             f"{cfg.n_hosts} hosts")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._cdf = torch.from_numpy(_zipf_cdf(min(cfg.vocab_size, CDF_RANKS), cfg.zipf_alpha))

    def host_batch(self, step: int, host: int = 0) -> dict[str, torch.Tensor]:
        """Tokens and labels (host_batch, seq_len) int32 for one host at one
        step. Deterministic."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(_seed(cfg.seed, step, host))
        u = torch.rand((cfg.global_batch // cfg.n_hosts, cfg.seq_len + 1), generator=gen)
        ids = ids_from_uniforms(self._cdf, u, cfg.vocab_size).to(self.device)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}

    def global_batch(self, step: int) -> dict[str, torch.Tensor]:
        """All hosts' batches, concatenated (single-process drivers and tests)."""
        parts = [self.host_batch(step, h) for h in range(self.cfg.n_hosts)]
        return {k: torch.cat([p[k] for p in parts], dim=0) for k in parts[0]}
