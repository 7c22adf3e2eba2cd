"""Whether the timed path's answers are right: every event of the window's
sampled batches, and every batch's event count, against the plain
reference run over the same corpus; and every file instance the window
read, lane by lane, against the file (no symbol skipped or read twice).

The corpus is its files' symbols end to end (``tokens``) and each file's
first symbol in them (``starts``); a reference event is keyed by the
position of its last symbol there. Each number has its limit; an exact
comparison has the limit 0. The numbers are printed beside their limits
by the caller."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.matcher import Matcher

BLOCK_SYMBOLS = 1 << 22  # the reference's symbols per row


def reference_events(tokens: np.ndarray, starts: np.ndarray,
                     sigs: list[np.ndarray], bits: int, device
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Every reference event of the files ``tokens[starts[f]:starts[f +
    1]]``, one per (end, pattern), as ``(keys, patterns)`` sorted by key:
    ``keys`` the position of the event's last symbol in ``tokens``. The
    corpus is matched in rows of ``BLOCK_SYMBOLS``, each with the symbols
    before it, and an event that starts in one file and ends in the next
    is dropped."""
    m = Matcher(sigs, bits, device)
    lens = np.array([len(s) for s in sigs])
    h = int(lens.max()) - 1
    T = len(tokens)
    S = max(1, min(BLOCK_SYMBOLS, T))
    rows = -(-T // S)
    pad = np.full(h + rows * S, -1, np.int32)  # -1 is no symbol
    pad[h:h + T] = tokens
    ix = np.arange(rows)[:, None] * S + np.arange(S + h)[None, :]
    block = torch.from_numpy(pad[ix])
    r, e, p = m.match(block, torch.zeros(rows, dtype=torch.int64),
                      torch.full((rows,), S + h, dtype=torch.int64))
    own = e >= h  # an event ending in a row's history is its row before's
    key = r[own] * S + e[own] - h
    pat = p[own]
    f = np.searchsorted(starts, key, "right") - 1
    whole = key - lens[pat] + 1 >= starts[f]
    key, pat = key[whole], pat[whole]
    order = np.lexsort((pat, key))
    return key[order], pat[order]


def _pack(inst, end, pid) -> np.ndarray:
    return (np.asarray(inst, np.int64) << 42) | (
        np.asarray(end, np.int64) << 20) | np.asarray(pid, np.int64)


def _ranges(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """``concatenate([arange(a, b) for a, b in zip(lo, hi)])``."""
    n = hi - lo
    total = int(n.sum())
    if not total:
        return np.zeros(0, np.int64)
    first = np.cumsum(n) - n
    return np.repeat(lo - first, n) + np.arange(total)


def compare(rec_lanes: list, rec_reported: list, rec_events: dict,
            ref: tuple, starts: np.ndarray, feed_workers: int
            ) -> tuple[dict, int]:
    """The numbers compared, ``{name: (value, limit, "<="|">=")}``, for a
    window whose batch ``k`` had the lanes ``rec_lanes[k]`` (``[chunks,
    3]``: file instance, stream offset, own symbols), reported
    ``rec_reported[k]`` (instance, pattern) events, and, for sampled
    ``k``, the events ``rec_events[k]`` (``[m, 3]``: instance, end, id).
    ``ref`` is :func:`reference_events` of the corpus whose files start
    at ``starts``; instance ``i`` is file ``i % files``, read by feeder
    thread ``i % feed_workers``. Also returns how many batches were found
    wrong."""
    keys, pats = ref
    files = len(starts) - 1
    count_gap = 0
    missing = extra = 0
    window_events = 0
    bad = 0
    for k, lanes in enumerate(rec_lanes):
        if not len(lanes):
            continue
        g0 = starts[lanes[:, 0] % files] + lanes[:, 1]
        lo = np.searchsorted(keys, g0)
        hi = np.searchsorted(keys, g0 + lanes[:, 2])
        want = int((hi - lo).sum())
        window_events += want
        count_gap += abs(want - rec_reported[k])
        wrong = want != rec_reported[k]
        if k in rec_events:
            idx = _ranges(lo, hi)
            inst = np.repeat(lanes[:, 0], hi - lo)
            ref_k = np.sort(_pack(inst, keys[idx] - starts[inst % files],
                                  pats[idx]))
            ev = rec_events[k]
            got = np.sort(_pack(ev[:, 0], ev[:, 1], ev[:, 2]))
            # multiset differences of the two sorted key lists
            both = np.intersect1d(ref_k, got)
            rc = np.searchsorted(ref_k, both, "right") - np.searchsorted(
                ref_k, both, "left")
            gc = np.searchsorted(got, both, "right") - np.searchsorted(
                got, both, "left")
            common = int(np.minimum(rc, gc).sum())
            missing += len(ref_k) - common
            extra += len(got) - common
            wrong = wrong or common != len(ref_k) or common != len(got)
        bad += wrong
    gap = feed_gap(rec_lanes, np.diff(starts), feed_workers)
    return {
        "missing_events": (missing, 0, "<="),
        "extra_events": (extra, 0, "<="),
        "count_gap": (count_gap, 0, "<="),
        "feed_gap": (gap, 0, "<="),
        "window_events": (window_events, 1, ">="),
    }, bad + (gap > 0)


def feed_gap(rec_lanes: list, lengths: np.ndarray, workers: int) -> int:
    """Symbols of the window's file instances that no lane covered, or
    that lanes covered more than once (instance ``i`` is file ``i %
    len(lengths)``): each feeder thread reads its instances ``w, w +
    workers, ...`` in order, so every instance it touched before its last
    must be whole, and the last a prefix; an instance it skipped counts
    whole."""
    lanes = [x for x in rec_lanes if len(x)]
    if not lanes:
        return 0
    lanes = np.concatenate(lanes)
    lanes = lanes[np.lexsort((lanes[:, 1], lanes[:, 0]))]
    inst, base, cnt = lanes[:, 0], lanes[:, 1], lanes[:, 2]
    first = np.concatenate([[True], inst[1:] != inst[:-1]])
    prev_end = np.concatenate([[0], (base + cnt)[:-1]])
    # a lane starts where the one before it in its instance ended, and an
    # instance's first lane at 0
    gap = int(np.abs(np.where(first, base, base - prev_end)).sum())
    last = np.concatenate([np.flatnonzero(first)[1:] - 1, [len(inst) - 1]])
    seen, covered = inst[last], (base + cnt)[last]
    files = len(lengths)
    for w in np.unique(seen % workers):
        top = int(seen[seen % workers == w].max())
        every = np.arange(w, top + 1, workers)
        c = np.zeros(len(every), np.int64)
        mine = seen % workers == w
        c[(seen[mine] - w) // workers] = covered[mine]
        want = lengths[every % files]
        gap += int(np.abs(want[:-1] - c[:-1]).sum())
        gap += max(0, int(c[-1] - want[-1]))
    return gap
