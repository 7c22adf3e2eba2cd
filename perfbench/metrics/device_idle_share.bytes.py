"""Share of the profiled batches' span in which no operation ran on the
card, in %."""

from perfbench.readings import idle_share


def read(run):
    return idle_share(run, "bytes")
