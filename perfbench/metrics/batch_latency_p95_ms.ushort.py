"""95th percentile of the window's batch latency: a batch's scan call
to its decode return."""

from perfbench.readings import latency_p95_ms


def read(run):
    return latency_p95_ms(run, "tokens")
