"""The card's energy over the window (nvidia-smi's power.draw every 200 ms,
integrated) over the window's site updates, nJ."""


def read(run):
    if run.power is None or not run.updates:
        return None
    return run.power.energy_j(*run.wall) / run.updates * 1e9
