"""The feeder threads' lane packing self-time (``feed.file`` visits
overlapping the window) and their batch hand-offs and fresh buffers
(``feed.alloc``), per million tokens the visits parsed."""

from perfbench.program_trace import feed_ms_per_mtoken


def read(run):
    return feed_ms_per_mtoken(run, ("pack",), ("feed.alloc",))
