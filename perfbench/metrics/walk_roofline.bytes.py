"""The dense DFA walk kernel's share of its roofline over the profiled
batches, in %: the frozen bound of walking their own bytes and writing
their events (``roofline/walk.py``) over the traced device time of every
``dense_walk_kernel`` launch among them. The profiled batches' events are
the window's events a byte times their bytes (the record keeps no count
for them)."""

from perfbench.readings import trace_of
from perfbench.roofline.walk import EVENT_BYTES, walk_bound


def is_walk(name: str) -> bool:
    return "dense_walk_kernel" in name


def read(run):
    tr = trace_of(run, "bytes")
    if tr is None or not tr.symbols or not tr.count(is_walk) or \
            run["symbols"] <= 0:
        return None
    events = sum(run["rec"].reported) / run["symbols"] * tr.symbols
    s = tr.device_s(is_walk)
    bound = walk_bound(tr.symbols, 1, round(events * EVENT_BYTES))
    return bound["bound_ms"] / (s * 1e3) * 100
