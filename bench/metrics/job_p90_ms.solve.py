"""sk2000.solve's 90th-percentile job latency (nearest rank), ms, over the
jobs of the traced run that the profiler did not see: its spread between
runs is too wide for a bound, so there it is read, with no bound, as a
per-layer metric."""
import math


def read(run):
    lat = sorted(run.untraced[0])
    return lat[math.ceil(0.9 * len(lat)) - 1] * 1e3 if lat else None
