"""Quickstart: sample a 4-node MaxCut problem with the PASS async sampler
(paper Fig. 3A) and print the sampled distribution vs the exact one; then
the same dynamics as a multi-chain time-to-solution race, and a sparse-
graph sweep with run diagnostics.

Everything goes through the unified driver: `sampler_api.run(problem,
kernel, seed, ...)` with kernels picked from the registry by name
("random_scan_gibbs" | "chromatic_gibbs" | "colored_gibbs" | "tau_leap" |
"ctmc"). The port of `examples/quickstart.py`; `--device cpu` runs it
without a card.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import ctmc, diagnostics, ising, sampler_api, sparse
from repro_torch.core.ising import resolve_device


def main(argv=None) -> dict:
    """Run the three quickstart demos, print their results and return the
    headlines: the TV distance, whether the ground states were found, the
    race's median hitting time and hit rate, the sweep's mixing summary."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    # the paper's 4-node MaxCut: a square ring, antiferromagnetic J=+1
    J = np.zeros((4, 4))
    for i, j in [(0, 1), (1, 2), (2, 3), (3, 0)]:
        J[i, j] = J[j, i] = 1.0
    prob = ising.DenseIsing.from_numpy(J, np.zeros(4), device=dev)

    states, p_exact = ising.enumerate_boltzmann(prob)

    # PASS asynchronous dynamics (exact event-driven CTMC) via the driver.
    # site_draw="tree" is the O(log n) sum-tree event selection ("auto"
    # would keep the historical O(n) categorical at this tiny size);
    # unroll="auto" lets the kernel pick its event-block size.
    res = sampler_api.run(
        prob,
        sampler_api.CTMC(site_draw="tree"),
        1,
        n_steps=60_000,
        sample_every=1,
        unroll="auto",
    )
    p_model = ctmc.time_weighted_distribution(ctmc.CTMCRun.from_result(res), 4).cpu().numpy()

    print("state     exact   sampled")
    for idx in np.argsort(-p_exact)[:6]:
        bits = "".join("+" if b > 0 else "-" for b in states[idx])
        print(f"{bits}      {p_exact[idx]:.3f}   {p_model[idx]:.3f}")
    tv = 0.5 * np.abs(p_model - p_exact).sum()
    print(f"\nTV distance: {tv:.4f}")
    top2 = set(np.argsort(-p_model)[:2])
    want = set(np.argsort(-p_exact)[:2])
    print("ground states found:", "YES" if top2 == want else "NO",
          "(the two antiphase cuts +-+- / -+-+)")

    # the same dynamic as a time-to-solution race: 8 chains, first-hit TTS
    e_gs = float(prob.energy(torch.as_tensor(states, dtype=torch.float32, device=dev)).min())
    race = sampler_api.run(prob, "ctmc", 2, n_steps=500, n_chains=8, first_hit=e_gs)
    t_hit = race.t_hit.cpu().numpy()
    hit_rate = float(race.hit.float().mean())
    print(f"\n8-chain ground-state TTS (model time): median {np.median(t_hit):.2f}, "
          f"hit rate {hit_rate:.0%}")

    # Sparse graphs: the same antiferromagnetic ring at n=12 in padded
    # neighbor-list form, swept by colored_gibbs (chromatic Gibbs over the
    # greedy coloring — every color class updates in parallel, one sweep =
    # one update per site). diagnostics=True threads flip counters and
    # Welford energy moments through the loop (sampled values stay
    # bit-identical); mixing_summary turns the recorded energies into
    # ESS and split-R-hat across the chains.
    n = 12
    ring = sparse.SparseIsing.from_edges(n, [(i, (i + 1) % n, 1.0) for i in range(n)],
                                         device=dev)
    sweep = sampler_api.run(
        ring,
        "colored_gibbs",
        3,
        n_steps=2_000,
        n_chains=4,
        sample_every=10,
        diagnostics=True,
    )
    d = sweep.diagnostics
    mix = diagnostics.mixing_summary(sweep.energies, sample_every=10)
    flip_rate = float(d.flip_rate.mean())
    print(f"\nsparse ring, colored_gibbs x4 chains: "
          f"flip rate {flip_rate:.3f}/site/sweep, "
          f"energy mean {float(d.energy_mean.mean()):.2f}")
    print(f"mixing: ESS {mix['ess']:.0f} of {4 * mix['n_samples']} samples, "
          f"split-R-hat {mix['split_rhat']:.3f}")
    return {"device": str(dev), "tv": float(tv), "ground_states_found": top2 == want,
            "tts_median": float(np.median(t_hit)), "hit_rate": hit_rate,
            "flip_rate": flip_rate, "ess": float(mix["ess"]),
            "split_rhat": float(mix["split_rhat"])}


if __name__ == "__main__":
    main()
