"""The program's own spans in a run, for the per-layer readers of the
feed, of ``scan``'s upload and of the device's idle time: the records of
the port's recorder (``tpu_pattern_matching_torch.runtime.tracing``;
``runtime/tracing.py`` names each span and its parts). A program without
a recorder gives None here, and its readers report nothing.

The recorder stamps ``time.perf_counter_ns()``. The run's window
(``run["rec"]``) is in ``time.perf_counter()`` seconds, the same clock:
it opens at its first batch's feed wait (``done[0] - latency[0] -
feed_wait[0]``) and closes at its last decode's return (``done[-1]``).
The trace of the profiled batches (``run["trace"]``) is in microseconds
on the profiler's axis; ``offset_us`` places the recorder there by the
``scan`` calls that both saw."""

from __future__ import annotations

import bisect
import statistics
import sys

def recorder():
    """The program's recorder, or None where it has none."""
    try:
        from tpu_pattern_matching_torch.runtime import tracing
    except ImportError:
        return None
    return getattr(tracing, "RECORDER", None)


def _kept_since(rec, t0_ns: int) -> bool:
    """Whether the ring still holds every record from ``t0_ns`` on."""
    if len(rec.ring) < rec.ring.maxlen:
        return True
    oldest = rec.oldest()
    if oldest is not None and oldest <= t0_ns:
        return True
    print("[perfbench] the program's span ring dropped records of the "
          "range read", file=sys.stderr)
    return False


def window_ns(run: dict) -> tuple[int, int] | None:
    rec = run["rec"]
    if not (rec.done and rec.latency and rec.feed_wait):
        return None
    lo = rec.done[0] - rec.latency[0] - rec.feed_wait[0]
    return int(lo * 1e9), int(rec.done[-1] * 1e9)


def window_spans(run: dict, names) -> list | None:
    """The recorder's records of ``names`` that overlap the run's window;
    None without a recorder, a window of tokens, or with records of the
    window dropped."""
    rec, win = recorder(), window_ns(run)
    if rec is None or win is None or run["unit"] != "tokens" or \
            not _kept_since(rec, win[0]):
        return None
    return rec.spans(lo=win[0], hi=win[1], names=names)


def part(r, key: str) -> int:
    return (r.parts or {}).get(key, 0)


def ms_per_mtoken(ns: float, tokens: int) -> float | None:
    """ms a million tokens, which is ns a token."""
    return ns / tokens if tokens > 0 else None


def feed_ms_per_mtoken(run: dict, keys, extra=()) -> float | None:
    """The ``feed.file`` visits' self-times ``keys``, and the whole time
    of the spans named in ``extra``, over the tokens the visits parsed."""
    spans = window_spans(run, ("feed.file",) + tuple(extra))
    if spans is None:
        return None
    visits = [r for r in spans if r.name == "feed.file"]
    ns = sum(part(r, k) for r in visits for k in keys)
    ns += sum(r.t1 - r.t0 for r in spans if r.name != "feed.file")
    return ms_per_mtoken(ns, sum(r.work for r in visits))


def _overlap(a0, a1, b0, b1) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def feed_cpu_share(run: dict) -> float | None:
    """The feeder threads' CPU over the wall of their ``feed.batch``
    spans less ``feed.put``, in %; prints how much of the feeder
    threads' window the spans cover."""
    spans = window_spans(run, ("feed.batch", "feed.worker", "feed.file",
                               "feed.alloc", "feed.put"))
    if not spans:
        return None
    batches = [r for r in spans if r.name == "feed.batch"]
    wall = sum(r.t1 - r.t0 - part(r, "put") for r in batches)
    if wall <= 0:
        return None
    _print_coverage(spans, window_ns(run))
    return sum(part(r, "cpu") for r in batches) / wall * 100


def _print_coverage(spans: list, win) -> None:
    lo, hi = win
    every = len(recorder().spans(lo=lo, hi=hi))
    by = {}
    for r in spans:
        by.setdefault(r.name, []).append(r)

    def within(name):
        return sum(_overlap(r.t0, r.t1, lo, hi) for r in by.get(name, ()))

    workers = within("feed.worker")
    visits = by.get("feed.file", ())
    own = sum(part(r, k) for r in visits
              for k in ("open", "read", "parse", "pack"))
    batch = within("feed.batch")
    inner = within("feed.file") + within("feed.alloc") + within("feed.put")
    print(f"[perfbench] program spans in the window: feed.batch cover "
          f"{batch / workers * 100 if workers else 0:.2f}% of the feeder "
          f"threads' wall ({workers / 1e9:.3f} thread-s); feed.file, "
          f"feed.alloc and feed.put {inner / batch * 100 if batch else 0:.2f}"
          f"% of feed.batch; the visits' self-times (open, read, parse, "
          f"pack) {own / sum(r.t1 - r.t0 for r in visits) * 100 if visits else 0:.2f}"
          f"% of their wall; {every} records", file=sys.stderr)


def offset_us(run: dict) -> float | None:
    """``t_trace_us = t_ns / 1e3 + offset``: the median, over the profiled
    batches, of a ``scan`` mark's middle less its ``scan`` span's middle,
    kept inside the offsets that put every span within its mark. The
    spans are the run of consecutive ``scan`` records whose offsets agree
    best (least median deviation) with the marks'; a wait for the
    interpreter lock on entering or leaving a mark moves single offsets
    by milliseconds, a wrong pairing moves all of them by a batch."""
    tr, rec = run["trace"], recorder()
    if tr is None or rec is None:
        return None
    marks = sorted((s, e) for n, s, e in tr.marks if n == "scan")
    scans = sorted((r.t0 / 1e3, r.t1 / 1e3)
                   for r in rec.spans(names="scan"))
    p = len(marks)
    if p < 2 or len(scans) < p:
        return None
    best = None
    for j in range(len(scans) - p + 1):
        offs = [(ms + me) / 2 - (ss + se) / 2
                for (ms, me), (ss, se) in zip(marks, scans[j : j + p])]
        med = statistics.median(offs)
        dev = statistics.median(abs(o - med) for o in offs)
        if best is None or dev < best[0]:
            best = (dev, med, j)
    dev, med, j = best
    spacing = statistics.median(b[0] - a[0] for a, b in zip(marks,
                                                            marks[1:]))
    if dev > spacing / 4:  # no run of spans pairs with the marks
        return None
    pairs = list(zip(marks, scans[j : j + p]))
    lo = max(ms - ss for (ms, _me), (ss, _se) in pairs)
    hi = min(me - se for (_ms, me), (_ss, se) in pairs)
    return min(max(med, lo), hi) if lo <= hi else med


def idle_intervals(tr) -> list:
    """The device's idle intervals (us) between the first and last host
    mark of the trace: the complement of its operations' union."""
    w0 = min(s for _n, s, _e in tr.marks)
    w1 = max(e for _n, _s, e in tr.marks)
    iv = sorted((max(s, w0), min(e, w1)) for _n, s, e in tr.ops
                if e > w0 and s < w1)
    out, cur = [], w0
    for s, e in iv:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        out.append((cur, w1))
    return out


def idle_parse_share(run: dict) -> float | None:
    """Of the device's idle time over the profiled batches, the share in
    which the feeder threads were parsing, in %: each ``feed.file``
    visit's parse self-time spread evenly over the visit, weighted by one
    over its feeder's thread count."""
    tr, rec = run["trace"], recorder()
    if tr is None or rec is None or run["unit"] != "tokens":
        return None
    off = offset_us(run)
    if off is None:
        return None
    idle = idle_intervals(tr)
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return None
    lo, hi = (int((t - off) * 1e3) for t in (idle[0][0], idle[-1][1]))
    if not _kept_since(rec, lo):
        return None
    threads = {r.tid: part(r, "threads")
               for r in rec.spans(names="feed.batch") if part(r, "threads")}
    n_default = max(threads.values(), default=1)
    starts = [s for s, _e in idle]
    acc = 0.0
    for v in rec.spans(lo=lo, hi=hi, names="feed.file"):
        parse = part(v, "parse")
        if not parse or v.t1 <= v.t0:
            continue
        s, e = v.t0 / 1e3 + off, v.t1 / 1e3 + off
        i = max(0, bisect.bisect_right(starts, s) - 1)
        ov = 0.0
        while i < len(idle) and idle[i][0] < e:
            ov += _overlap(s, e, *idle[i])
            i += 1
        acc += parse / 1e3 / (e - s) * ov / threads.get(v.tid, n_default)
    return acc / total * 100
