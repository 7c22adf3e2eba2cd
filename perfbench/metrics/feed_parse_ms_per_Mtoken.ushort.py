"""The feeder threads' parse self-time (``feed.file`` visits overlapping
the window) per million tokens those visits parsed."""

from perfbench.program_trace import feed_ms_per_mtoken


def read(run):
    return feed_ms_per_mtoken(run, ("parse",))
