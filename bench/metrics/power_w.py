"""The card's mean power.draw over the window, W."""


def read(run):
    if run.power is None:
        return None
    return run.power.mean_w(*run.wall)
