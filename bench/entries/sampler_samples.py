"""Entry `sampler_samples`: `sampler_run`'s jobs, one `run()` call each, on a
problem of many disorder samples (per-sample couplings over one neighbour
table): the configuration's `samples` samples times its `replicas` replicas
as the `n_chains` rows of each call, sample-major, and the same comparison
with the configuration's reference. The rooflines read `samples` beside
`sampler_run`'s shape."""
from __future__ import annotations

from pathlib import Path

from bench.common import load_module

_run = load_module("entries", "sampler_run", Path(__file__).resolve().parents[1])


class Cell(_run.Cell):
    """`sampler_run.Cell` over S disorder samples of R replicas each."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, root):
        S, R = config["samples"], config["replicas"]
        if traffic["n_chains"] != S * R:
            raise ValueError(f"n_chains {traffic['n_chains']} is not samples x replicas = "
                             f"{S} x {R}")
        super().__init__(config, traffic, seed, device, root)
        self.shape["samples"] = S
