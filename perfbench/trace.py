"""Reduction of a ``torch.profiler`` trace of the profiled batches to what
the per-layer readers take: the device operations (kernels, copies, sets)
with their intervals, the host's marked calls (``feed_wait``, ``scan``,
``decode``) with theirs, the device's busy time (the union of its
operations' intervals) and the idle gaps between them, each named by the
host call that was running at its middle."""

from __future__ import annotations

import dataclasses

import numpy as np

MARKS = ("feed_wait", "scan", "decode")


@dataclasses.dataclass
class Trace:
    ops: list  # (name, start_us, end_us) of every device operation
    marks: list  # (name, start_us, end_us) of the host's marked calls
    window_s: float  # first mark's start to the last mark's end
    busy_s: float  # union of the device operations' intervals
    gaps: list  # (host call, seconds) of the device's idle gaps
    batches: int  # batches decoded in the traced window
    symbols: int  # their own symbols (bytes or tokens)

    def device_s(self, pred) -> float:
        """Seconds of the device operations whose name ``pred`` accepts."""
        return sum(e - s for n, s, e in self.ops if pred(n)) / 1e6

    def count(self, pred=lambda _n: True) -> int:
        return sum(1 for n, _s, _e in self.ops if pred(n))

    def by_name(self) -> list:
        acc: dict = {}
        for n, s, e in self.ops:
            acc[n] = acc.get(n, 0.0) + (e - s) / 1e6
        return sorted(acc.items(), key=lambda kv: -kv[1])


def reduce(prof, batches: int, symbols: int, cuda: bool = True) -> Trace:
    """``cuda=False`` (a run of the plain versions on the CPU, for the
    tests) takes the host's torch operations for the device's."""
    from torch.autograd import DeviceType

    dev_type = DeviceType.CUDA if cuda else DeviceType.CPU
    ops, marks = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.name in MARKS:  # a host mark (or its device-side range)
            if ev.device_type == DeviceType.CPU:
                marks.append((ev.name, float(tr.start), float(tr.end)))
        elif ev.device_type == dev_type and not getattr(
                ev, "is_user_annotation", False):  # e.g. "nccl:all_reduce"
            ops.append((ev.name, float(tr.start), float(tr.end)))
    if not ops:
        raise RuntimeError("the trace holds no device operation")
    if not marks:
        raise RuntimeError("the trace holds none of the host's marks")
    w0 = min(s for _n, s, _e in marks)
    w1 = max(e for _n, _s, e in marks)
    iv = sorted((max(s, w0), min(e, w1)) for _n, s, e in ops
                if e > w0 and s < w1)
    busy = 0.0
    gaps = []
    cur_s, cur_e = w0, w0
    for s, e in iv:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if w1 > cur_e:
        gaps.append((cur_e, w1))
    named = []
    mk = sorted(marks, key=lambda m: m[1])
    starts = np.array([m[1] for m in mk])
    for s, e in gaps:
        mid = (s + e) / 2
        i = int(np.searchsorted(starts, mid, "right")) - 1
        name = mk[i][0] if i >= 0 and mk[i][2] >= mid else "other"
        named.append((name, (e - s) / 1e6))
    named.sort(key=lambda g: -g[1])
    return Trace(ops=ops, marks=marks, window_s=(w1 - w0) / 1e6,
                 busy_s=busy / 1e6, gaps=named, batches=batches,
                 symbols=symbols)


def breakdown(tr: Trace) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps, by the host call they fell in."""
    return {"device_ops": [[n[:64], s] for n, s in tr.by_name()[:10]],
            "idle_gaps": [[n, s] for n, s in tr.gaps[:10]]}
