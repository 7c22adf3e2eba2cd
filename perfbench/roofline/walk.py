"""The least time the card could take for the dense DFA walk of the
profiled batches: a frozen copy of ``chip_smoke.walk_bound``, so that a
change to the program cannot change the yardstick.

It counts the work and not the walk's layout: each of the batches' own
symbols read once and stepped once (``WALK_OPS`` int32 operations a
step), and each event they hold written once (``EVENT_BYTES``). Warm-up
steps, result slots, table loads and padding are the implementation's
and are not counted. The bound is the larger of bytes at
``HBM_BYTES_PER_S`` and operations at ``INT32_OPS_PER_S`` (the peaks of
``roofline/probe.py``)."""

from __future__ import annotations

from perfbench.roofline.probe import bound_of

WALK_OPS = 5  # a DFA step: the entry's index, the gather, the sign test,
#               the state (abs), the report test
EVENT_BYTES = 8  # an event's lane and end, 4 B each


def walk_bound(steps: int, sym: int, out_bytes: int) -> dict:
    """The bound of a DFA walk of ``steps`` steps over symbols of ``sym``
    bytes that writes ``out_bytes``: each symbol read once, the outputs
    written once, ``WALK_OPS`` a step."""
    return bound_of(steps * sym + out_bytes, steps * WALK_OPS)

