"""The feeder threads' CPU time over the wall of their ``feed.batch``
spans less ``feed.put`` (the window's), in %: under 100 is time spent
waiting inside their own work, for the interpreter lock or the disk."""

from perfbench.program_trace import feed_cpu_share


def read(run):
    return feed_cpu_share(run)
