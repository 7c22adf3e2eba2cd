"""Host ms of the window's ``feed_wait`` spans per GiB."""

from perfbench.readings import span_ms_per


def read(run):
    return span_ms_per(run, "feed_wait", "bytes")
