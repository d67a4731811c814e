"""Full-core optimization demo (paper Fig. 3F): a 16x16 king's-move MaxCut
whose ground state spells C-A-L, solved by the asynchronous PASS dynamics,
with int8-quantized weights exactly like the silicon. The anneal is a
driver-level `schedule` on the tau-leap kernel (the paper's 'counter that
uniformly decreases the weights' future-work mode). The port of
`examples/optimization_cal.py`.

    PYTHONPATH=src python -m repro_torch.examples.optimization_cal [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import ising, problems, sampler_api
from repro_torch.core.ising import resolve_device


def show(s):
    for row in s.cpu().numpy():
        print("".join("#" if v > 0 else "." for v in row))


def main(argv=None) -> dict:
    """Anneal the C-A-L core from a random state; print the states and
    return the final energy, the ground state's and the template
    agreement |m|."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    lat = problems.cal_problem(device=dev)
    lat = ising.quantize_lattice(lat, bits=8)  # chip's int8 weight grid
    template = torch.as_tensor(problems.cal_template(), device=dev)

    s0 = sampler_api.random_init(torch.Generator(device=dev).manual_seed(0), lat.shape,
                                 device=dev)
    print("initial (random) state:")
    show(s0)

    # PASS asynchronous tau-leap dynamics with a gentle anneal
    res = sampler_api.run(
        lat, sampler_api.TauLeap(dt=0.25), 1,
        n_steps=1200, s0=s0, schedule=sampler_api.linear(0.4, 2.0),
    )
    s, e = res.s, lat.energy(res.s)

    print("\nafter 1200 async steps:")
    show(s)
    agree = float(torch.abs(torch.mean(s * template)))
    e_gs = float(lat.energy(template))
    print(f"\nenergy: {float(e):.1f}  (ground state: {e_gs:.1f})")
    print(f"template agreement |m|: {agree:.3f}  (1.0 = perfect C-A-L)")
    return {"device": str(dev), "energy": float(e), "ground_state_energy": e_gs,
            "template_agreement": agree}


if __name__ == "__main__":
    main()
