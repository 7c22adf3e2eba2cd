"""Spans and counters of a run, and its profiler trace.

``RECORDER`` is the process's one recorder. It is always on: the feeder
threads, ``MatchSession.scan`` and ``.decode`` stamp spans into it as
they run, and counters add into it. A span holds its name, thread, batch
id (``HostBatch.seq``, -1 where none), parent span, start and end in
``time.perf_counter_ns()`` (CLOCK_MONOTONIC), a work count (tokens,
bytes or rows) and, on some spans, named parts: self-times added into it
by the calls it encloses (``charge``), which are too many to record one
by one. Records go into a ring of ``RING`` entries; totals by name never
wrap. Nothing is written anywhere until a caller asks: ``totals``,
``counters`` and ``report`` (``RunStats.to_json``), ``spans`` (the
benchmark's readers), and ``device_trace``, which merges the spans of
every thread into the Chrome trace it writes (the CLI's ``--profile``).

Spans and counters by layer:

- feed (``runtime/feeder.py``, ``runtime/buffers.py``), on the feeder
  threads: ``feed.worker`` (a worker thread's life), ``feed.batch`` (one
  flushed batch, from the end of the one before to its hand-off; parts
  ``cpu``, the thread's CPU ns, ``put`` and ``threads``, the feeder's
  worker count), ``feed.file`` (one visit to a file within one batch;
  parts ``open``, ``read``, ``parse``, ``pack``; work, the symbols it
  produced), ``feed.alloc`` (batch hand-off and a fresh buffer),
  ``feed.put`` (blocked on the full queue), ``feed.close`` (closing the
  worker's files at its end); counter ``feed.allocs`` (buffers
  allocated, every ``DataBuffer._alloc``). On the consumer: ``feed.wait``
  (blocked in the queue's ``get``) and counter ``feed.queued`` (the
  queue's length at each get, summed).
- session scan: ``scan`` > ``scan.upload`` (the copies to the device),
  ``scan.probe`` (the device engine's enqueue).
- decode: ``decode`` > ``decode.sync`` (the wait on the device's total),
  ``decode.rows`` (bitmap read-back and candidate rows), ``decode.verify``
  (host or device verify), ``decode.events``; ``batch`` (a batch's scan
  start to its decode return); counters ``verify.candidates``,
  ``verify.events``, ``refine.overflows``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque, namedtuple

RING = 1 << 16  # span records kept: a 51 s window of the ushort feed
# (about 240 a second) and its profiled batches, several times over

SpanRecord = namedtuple(
    "SpanRecord", "name tid seq parent id t0 t1 work parts")

_now = time.perf_counter_ns


class Span:
    """An open span: a context manager, or ``Recorder.begin``/``end``
    where it does not nest lexically. ``work`` and ``parts`` may grow
    until it ends."""

    __slots__ = ("rec", "name", "seq", "work", "parts", "parent", "id",
                 "t0")

    def __init__(self, rec, name, seq, work):
        self.rec, self.name, self.seq, self.work = rec, name, seq, work
        self.parts = None

    def __enter__(self):
        self.rec._open(self)
        return self

    def __exit__(self, *exc):
        self.rec.end(self)
        return False

    def add(self, key: str, n: int) -> None:
        if self.parts is None:
            self.parts = {}
        self.parts[key] = self.parts.get(key, 0) + n


class Recorder:
    def __init__(self, capacity: int = RING):
        self.ring: deque = deque(maxlen=capacity)
        self._totals: dict = {}  # name -> [spans, ns, work]
        self._counters: dict = {}
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self._seqs = itertools.count()
        self.thread_names: dict = {}  # native thread id -> name

    # ------------------------------------------------------------ record

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
            self._tls.tid = threading.get_native_id()
            self.thread_names[self._tls.tid] = \
                threading.current_thread().name
        return st

    def _open(self, sp: Span) -> None:
        st = self._stack()
        if st:  # a span inside a batch's span belongs to that batch
            sp.parent = st[-1].id
            if sp.seq == -1:
                sp.seq = st[-1].seq
        else:
            sp.parent = 0
        sp.id = next(self._ids)
        st.append(sp)
        sp.t0 = _now()

    def span(self, name: str, seq: int = -1, work: int = 0) -> Span:
        """A span to enter with ``with``."""
        return Span(self, name, seq, work)

    def begin(self, name: str, seq: int = -1, work: int = 0) -> Span:
        sp = Span(self, name, seq, work)
        self._open(sp)
        return sp

    def end(self, sp: Span, t1: int | None = None) -> None:
        t1 = _now() if t1 is None else t1
        self._pop(sp)
        self._keep(SpanRecord(sp.name, self._tls.tid, sp.seq, sp.parent,
                              sp.id, sp.t0, t1, sp.work, sp.parts))

    def drop(self, sp: Span) -> None:
        """Close ``sp`` without recording it."""
        self._pop(sp)

    def _pop(self, sp: Span) -> None:
        st = self._tls.stack
        while st:  # spans an exception left open above it go too
            if st.pop() is sp:
                break

    def record(self, name: str, t0: int, t1: int, seq: int = -1,
               work: int = 0) -> None:
        """A span whose ends were taken already, under the calling
        thread's open span."""
        st = self._stack()
        if st and seq == -1:
            seq = st[-1].seq
        self._keep(SpanRecord(name, self._tls.tid, seq,
                              st[-1].id if st else 0, next(self._ids), t0,
                              t1, work, None))

    def _keep(self, r: SpanRecord) -> None:
        self.ring.append(r)
        with self._lock:
            tot = self._totals.get(r.name)
            if tot is None:
                tot = self._totals[r.name] = [0, 0, 0]
            tot[0] += 1
            tot[1] += r.t1 - r.t0
            tot[2] += r.work

    def charge(self, work: int = 0, **ns: int) -> None:
        """Add ``work`` and the self-times ``ns`` (name -> ns) into the
        calling thread's innermost open span; nothing without one."""
        st = getattr(self._tls, "stack", None)
        if not st:
            return
        sp = st[-1]
        sp.work += work
        for k, v in ns.items():
            sp.add(k, v)

    def add(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def next_seq(self) -> int:
        """A new batch id, unique in the process."""
        return next(self._seqs)

    # -------------------------------------------------------------- read

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def totals(self) -> dict:
        """``{name: [spans, ns, work]}`` of every span ended so far."""
        with self._lock:
            return {k: list(v) for k, v in self._totals.items()}

    def report(self, since: tuple | None = None) -> dict:
        """Span totals (count, ms, work) and counters, less those of
        ``since`` (an earlier ``(totals(), counters())``)."""
        tot, cnt = self.totals(), self.counters()
        t0, c0 = since or ({}, {})
        spans = {}
        for k, (n, ns, w) in sorted(tot.items()):
            n0, ns0, w0 = t0.get(k, (0, 0, 0))
            if n > n0:
                spans[k] = {"n": n - n0, "ms": (ns - ns0) / 1e6,
                            "work": w - w0}
        return {"spans": spans,
                "counters": {k: v - c0.get(k, 0)
                             for k, v in sorted(cnt.items())
                             if v != c0.get(k, 0)}}

    def spans(self, lo: int | None = None, hi: int | None = None,
              names=None) -> list:
        """The ring's records that overlap ``[lo, hi]`` (perf_counter
        ns), of ``names`` where given, in the order they ended."""
        out = list(self.ring)
        if names is not None:
            names = {names} if isinstance(names, str) else set(names)
            out = [r for r in out if r.name in names]
        if lo is not None:
            out = [r for r in out if r.t1 >= lo]
        if hi is not None:
            out = [r for r in out if r.t0 <= hi]
        return out

    def oldest(self) -> int | None:
        """The start of the ring's oldest record: records that began
        before it may have been dropped."""
        ring = list(self.ring)
        return min(r.t0 for r in ring) if ring else None

    def chrome_events(self, lo: int, epoch_off: int, base_ns: int,
                      named=()) -> list:
        """The records that end at ``lo`` or later as Chrome trace events
        of this process: ``ts`` in us past ``base_ns`` on the epoch
        clock, which is ``perf_counter_ns() + epoch_off``; the name of
        each thread not in ``named``."""
        pid = os.getpid()
        out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": t,
                "args": {"name": n}}
               for t, n in list(self.thread_names.items())
               if t not in named]
        for r in self.spans(lo=lo):
            args = {"seq": r.seq, "work": r.work}
            if r.parts:
                args.update(r.parts)
            out.append({"ph": "X", "cat": "program", "name": r.name,
                        "pid": pid, "tid": r.tid,
                        "ts": (r.t0 + epoch_off - base_ns) / 1e3,
                        "dur": (r.t1 - r.t0) / 1e3, "args": args})
        return out


RECORDER = Recorder()


def epoch_offset() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the tightest of a
    few readings."""
    best = None
    for _ in range(5):
        p0 = _now()
        e = time.time_ns()
        p1 = _now()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, e - (p0 + p1) // 2)
    return best[1]


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Trace the body with ``torch.profiler`` when ``log_dir`` is set and
    write it there as a Chrome trace (``trace-<pid>.json``, readable in
    Perfetto or chrome://tracing): host ops, the card's kernels and
    copies when a CUDA device is present, and the recorder's spans of
    every thread (category ``program``) on the same time axis."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    lo = _now()
    with profile(activities=activities) as prof:
        yield
    off = epoch_offset()
    path = os.path.join(log_dir, f"trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    # event times are us past baseTimeNanoseconds (absolute us where a
    # torch's export has no base)
    base = int(trace.get("baseTimeNanoseconds", 0))
    named = {e.get("tid") for e in trace["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    trace["traceEvents"].extend(RECORDER.chrome_events(lo, off, base,
                                                       named))
    with open(path, "w") as f:
        json.dump(trace, f)
