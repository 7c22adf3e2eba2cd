"""The timed path: the grep CLI's streaming scan loop (``cli.run`` and
``ushort.run_ushort_grep`` of the port keep it inline, so these lines are
a copy of it), fed by back-to-back feeders over a corpus that is written
once, and recorded batch by batch.

One batch is: a wait on the feed (``cli.rank_batches``: the feeder's
queue, in lockstep rounds on a mesh), ``MatchSession.scan`` (upload,
probe, refinement enqueue), and, one batch later (the CLI's in-flight
depth of 2), ``MatchSession.decode`` (read-back, host verify).
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from collections import deque
from collections.abc import Sequence

import numpy as np


class Cycle(Sequence):
    """``paths`` repeated ``passes`` times: the file list of one feeder.
    Instance ``i`` is the file ``paths[i % len(paths)]``."""

    def __init__(self, paths: list[str], passes: int):
        self.paths = list(paths)
        self.passes = passes

    def __len__(self) -> int:
        return len(self.paths) * self.passes

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        return self.paths[i % len(self.paths)]


class FeedChain:
    """Feeders run back to back, each over ``passes`` passes of the corpus
    (a feeder keeps every file it opened open until it ends, so one
    feeder for a whole window would hold too many). Iterating yields the
    feeders' items, each tagged with ``instance_base`` (the global index
    of its feeder's first file instance); once ``deadline`` (a
    ``time.perf_counter`` value) has passed, the next request ends the
    iteration and stops the feeder, whose rest ``close`` drains."""

    def __init__(self, make_feeder, paths: list[str], passes: int):
        self.make_feeder = make_feeder
        self.cycle = Cycle(paths, passes)
        self.deadline: float | None = None
        self.active = None  # (feeder, its iterator)
        self.feeders = 0

    def __iter__(self):
        while True:
            feeder = self.make_feeder(self.cycle)
            base = self.feeders * len(self.cycle)
            self.feeders += 1
            it = iter(feeder)
            self.active = (feeder, it)
            feeder.start()
            while True:
                if self.deadline is not None and \
                        time.perf_counter() >= self.deadline:
                    feeder.stop()
                    return
                item = next(it, None)
                if item is None:
                    break
                item.instance_base = base
                yield item
            self._join(feeder)
            self.active = None

    def queued(self) -> int:
        """Batches waiting in the running feeder's queue."""
        return self.active[0].q.qsize() if self.active else 0

    @staticmethod
    def _join(feeder) -> None:
        for t in feeder._threads:
            t.join()

    def close(self) -> None:
        """Stop the running feeder, drain its queue and wait for its
        threads."""
        if self.active is None:
            return
        feeder, it = self.active
        feeder.stop()
        for _ in it:
            pass
        self._join(feeder)
        self.active = None


@dataclasses.dataclass
class Record:
    """What the loop saw, batch by batch (host clock, seconds)."""

    feed_wait: list = dataclasses.field(default_factory=list)
    scan: list = dataclasses.field(default_factory=list)
    decode: list = dataclasses.field(default_factory=list)
    latency: list = dataclasses.field(default_factory=list)
    done: list = dataclasses.field(default_factory=list)  # decode returns
    symbols: list = dataclasses.field(default_factory=list)  # per batch
    reported: list = dataclasses.field(default_factory=list)
    lanes: list = dataclasses.field(default_factory=list)  # (inst, base, n)
    events: dict = dataclasses.field(default_factory=dict)  # batch -> [n,3]
    matches_total: int = 0
    window_from: int = 0  # the first batch of the measured window

    @property
    def batches(self) -> int:
        return len(self.decode)

    def window(self) -> "Record":
        """The measured window's batches (spans, symbols) alone."""
        k = self.window_from
        return Record(feed_wait=self.feed_wait[k:], scan=self.scan[k:],
                      decode=self.decode[k:], latency=self.latency[k:],
                      done=self.done[k:],
                      symbols=self.symbols[k:], reported=self.reported[k:],
                      lanes=self.lanes[k:])


def lane_table(item) -> np.ndarray:
    """``[chunks, 3]`` int64: each lane's (file instance, stream offset of
    its first own symbol, own symbols)."""
    b = item.batch
    n = b.chunks
    out = np.empty((n, 3), np.int64)
    out[:, 0] = b.file_ids[:n] + getattr(item, "instance_base", 0)
    out[:, 1] = b.base_off[:n]
    out[:, 2] = b.end_t[:n].astype(np.int64) - b.halo
    return out


def drive(sess, batches, rec: Record, iid_of: np.ndarray, sampled,
          before=None, mark=None) -> None:
    """The CLI's loop over ``batches`` (its ``rank_batches``): scan each
    batch, decode it one batch later; record each batch's spans, lanes,
    and (where ``sampled(k)``) its events as ``(instance, end, iid)``
    rows. ``before(i)`` runs before batch ``i`` is asked of the feed (the
    run's phases change there, on a batch boundary); ``mark(name)`` gives
    a context that marks the three calls for a trace."""
    from tpu_pattern_matching_torch.cli import batch_total

    clock = time.perf_counter
    mark = mark or (lambda _name: contextlib.nullcontext())

    def consume(item, comp, t_scan):
        t0 = clock()
        with mark("decode"):
            bm = sess.decode(item.batch, comp)
        t1 = clock()
        k = rec.batches
        rec.decode.append(t1 - t0)
        rec.latency.append(t1 - t_scan)
        rec.done.append(t1)
        rec.matches_total += batch_total(sess, bm)  # the CLI's STATS
        reported = sum(len(e.pattern_indices) for e in bm.events)
        if bm.overflowed:
            print(f"WARNING: result slots overflowed: "
                  f"{bm.total - bm.reported} match(es) not reported this "
                  f"round (raise -R)", file=sys.stderr)
        lanes = lane_table(item)
        rec.reported.append(reported)
        rec.lanes.append(lanes)
        rec.symbols.append(int(lanes[:, 2].sum()))
        if sampled(k):
            base = getattr(item, "instance_base", 0)
            rows = [(e.file_id + base, e.end_offset, p)
                    for e in bm.events for p in e.pattern_indices]
            ev = np.array(rows, np.int64).reshape(-1, 3)
            ev[:, 2] = iid_of[ev[:, 2]]
            rec.events[k] = ev

    pending: deque = deque()
    it = iter(batches)
    while True:
        if before is not None:
            before(len(rec.scan))
        t0 = clock()
        with mark("feed_wait"):
            item = next(it, None)
        t1 = clock()
        if item is None:
            break
        rec.feed_wait.append(t1 - t0)
        with mark("scan"):
            comp = sess.scan(item.batch)
        rec.scan.append(clock() - t1)
        pending.append((item, comp, t1))
        if len(pending) >= 2:  # the CLI's depth-2 pipeline
            consume(*pending.popleft())
    while pending:
        consume(*pending.popleft())

