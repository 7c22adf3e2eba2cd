"""The bloom probe kernel's share of its roofline (frozen bound of a
launch over its traced device time per launch), in %."""

from perfbench.readings import probe_roofline


def read(run):
    return probe_roofline(run, "bytes")
