"""Neural decision making (paper Fig. 5): a fly navigates to one of two
targets by sampling an Ising ring attractor on the PASS dynamics; the
geometry exponent eta moves the bifurcation point. The port of
`examples/neural_decision.py`.

    PYTHONPATH=src python -m repro_torch.examples.neural_decision [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import decision
from repro_torch.core.ising import resolve_device


def ascii_plot(trajs, targets, width=64, height=24):
    ymax = 1200.0
    xlim = 700.0
    grid = [[" "] * width for _ in range(height)]
    for t, marker in zip(trajs, "abcdefg"):
        for x, y in np.asarray(t):
            c = int((x + xlim) / (2 * xlim) * (width - 1))
            r = height - 1 - int(y / ymax * (height - 1))
            if 0 <= r < height and 0 <= c < width:
                grid[r][c] = marker
    for tx, ty in targets:
        c = int((tx + xlim) / (2 * xlim) * (width - 1))
        r = height - 1 - int(ty / ymax * (height - 1))
        if 0 <= r < height and 0 <= c < width:
            grid[r][c] = "X"
    print("\n".join("".join(row) for row in grid))


def main(argv=None, n_seeds: int = 5, max_steps: int = 150) -> dict:
    """Five trajectories (`n_seeds`) of `max_steps` outer steps at eta = 1
    and 4; print them and return, by eta, the commit distances and the
    left/right split of the final positions."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    targets = np.array([[-300.0, 1000.0], [300.0, 1000.0]], np.float32)
    out = {"device": str(dev), "by_eta": {}}
    for eta in (1.0, 4.0):
        print(f"\n=== eta = {eta} (X = targets; letters = individual runs) ===")
        cfg = decision.DecisionConfig(n_neurons=40, eta=eta, max_steps=max_steps)
        trajs, commits = [], []
        for seed in range(n_seeds):
            traj = decision.simulate(seed, targets, cfg, device=dev)
            trajs.append(traj.positions.cpu().numpy())
            commits.append(float(decision.bifurcation_distance(traj.positions, targets)))
        ascii_plot(trajs, targets)
        sides = [np.sign(t[-1][0]) for t in trajs]
        print(f"commit distance (median): {np.median(commits):.0f}; "
              f"left/right split: {sides.count(-1)}/{sides.count(1)}")
        out["by_eta"][eta] = {"commit_distances": commits,
                              "commit_median": float(np.median(commits)),
                              "left": sides.count(-1), "right": sides.count(1),
                              "steps": [len(t) - 1 for t in trajs]}
    return out


if __name__ == "__main__":
    main()
