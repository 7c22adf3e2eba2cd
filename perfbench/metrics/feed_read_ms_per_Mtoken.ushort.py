"""The feeder threads' open and read self-time (``feed.file`` visits
overlapping the window), and their files' close (``feed.close``), per
million tokens the visits parsed."""

from perfbench.program_trace import feed_ms_per_mtoken


def read(run):
    return feed_ms_per_mtoken(run, ("open", "read"), ("feed.close",))
