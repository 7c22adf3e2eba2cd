"""Host ms of the window's ``scan`` spans per GiB."""

from perfbench.readings import span_ms_per


def read(run):
    return span_ms_per(run, "scan", "bytes")
