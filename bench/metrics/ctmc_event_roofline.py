"""ctmc_event's least time at its frozen bytes and operations over its mean
traced time a call, %."""
from bench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "ctmc_event")
