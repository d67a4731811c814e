"""The 90th percentile (nearest rank) of the window's job latencies, ms: a
job runs from the call into the program to its results on the host."""
import math


def read(run):
    lat = sorted(run.latencies_s)
    return lat[math.ceil(0.9 * len(lat)) - 1] * 1e3 if lat else None
