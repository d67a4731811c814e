"""Site updates attempted (chains x sites x steps of every job) over the
whole window, host clock."""


def read(run):
    return run.updates / run.window_s
