"""End-to-end driver (paper Fig. 4): multiplier-free generative training of
a fully-visible Boltzmann machine on the 16x16 core with contrastive
divergence, then image reconstruction from a clamped half-image.

This is the paper's machine-learning experiment: the host computes data
expectations; the PASS sampler (tau-leap async model) computes model
expectations; weight updates are int8-quantized onto the chip grid each
iteration. The port of `examples/boltzmann_mnist.py`.

    PYTHONPATH=src python -m repro_torch.examples.boltzmann_mnist [--steps 300] [--digit 3]
        [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import boltzmann
from repro_torch.core.ising import resolve_device
from repro_torch.data import digits


def show(img, title=""):
    if title:
        print(title)
    for row in np.asarray(img.cpu() if isinstance(img, torch.Tensor) else img):
        print("".join("#" if v > 0 else "." for v in row))
    print()


def main(argv=None) -> dict:
    """Train by CD, reconstruct a half-clamped digit; return the data
    energies before and after and the bottom half's agreement with the
    template."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--digit", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    model_gen = gen(0)  # the model phase of every CD step draws from it
    batch = digits.digit_batch(args.digit, n=128, generator=gen(1), flip_prob=0.06, device=dev)
    show(digits.digit_template(args.digit), f"training digit template ({args.digit}):")

    cfg = boltzmann.CDConfig(lr=0.06, n_model_steps=32, n_chains=32, quantize_bits=8)
    state = boltzmann.init_cd(gen(2), 16, 16, cfg, device=dev)

    e0 = float(boltzmann.free_energy_proxy(state.problem, batch))
    e = e0
    for i in range(args.steps):
        state = boltzmann.cd_step(state, batch, model_gen, cfg)
        if (i + 1) % max(1, args.steps // 6) == 0:
            e = float(boltzmann.free_energy_proxy(state.problem, batch))
            print(f"step {i+1:4d}  data energy {e:9.2f}  (init {e0:.2f})")

    show((torch.mean(state.chains, dim=0) > 0) * 2.0 - 1.0, "model mean activation (learned digit):")

    # reconstruction: clamp the top half, sample the bottom (Fig 4C)
    img = batch[0]
    known = torch.zeros((16, 16), dtype=torch.bool, device=dev)
    known[:8] = True
    partial = torch.where(known, img, -1.0)
    show(partial, "clamped input (top half):")
    rec = boltzmann.reconstruct(state.problem, gen(9), img, known)
    show(rec, "reconstruction:")
    template = digits.digit_template(args.digit)
    agree = float(np.mean(rec.cpu().numpy()[8:] == template[8:]))
    print(f"bottom-half agreement with template: {agree:.2%}")
    return {"device": str(dev), "steps": args.steps, "data_energy_init": e0,
            "data_energy": e, "bottom_half_agreement": agree}


if __name__ == "__main__":
    main()
