"""Measuring a kernel on the card: the H100's peak rates, the least time a
launch could take on its inputs (its bound), the card's name and power
limit, and times by CUDA events and by torch.profiler traces. Used by
``chip_smoke.py``, ``bench``, the scripts of ``benchmarks`` and the
calibrator of ``ops.costmodel``; no session path imports it.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

# The card's peaks for the bounds (NVIDIA H100 SXM, data sheet): device
# memory, and int32 operations (132 SMs x 64 INT32 lanes x 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations counted per bank probed (the least a kernel can do):
BANK_OPS = 9  # h = m1 + b*m2; h ^= h >> 13 (2); the unit, word and bit
#               fields (3); the word's address (2); the test


def bound_of(nbytes: int, ops: int) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the int32 operations over their peak rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT32_OPS_PER_S * 1e3
    return dict(bound_ms=max(tb, to), bound_by="bytes" if tb >= to
                else "operations", bytes=int(nbytes), ops=int(ops))


def card() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` gives
    them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def event_ms(fn, n: int) -> float:
    """Mean ms per call over n calls, by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


K_LO, K_HI = 1, 9  # the reference benchmarks' loop lengths


def kloop_seconds(call, device, n: int, k_lo: int = K_LO,
                  k_hi: int = K_HI) -> float:
    """Seconds per call of ``call`` by the reference benchmarks' protocol:
    ``(t(k_hi) - t(k_lo)) / (k_hi - k_lo)``, each ``t(K)`` the best of
    ``n`` runs of K back-to-back calls, after one run of each K as a
    warm-up. The difference cancels what a run pays once (the read-back,
    the first launch's latency).

    ``call()`` returns a device scalar (a total the call computed); a run
    sums its K totals on the device and reads the sum with one ``.item()``
    after the run's end, so no read-back falls inside a call. On a CUDA
    device a run is the span of two CUDA events around its K calls (for a
    call that is many small device operations, that is the host's enqueue
    where it is longer than the card's work: compare ``trace_ms``); on the
    CPU the host clock times the same runs, the read-back included."""
    cuda = torch.device(device).type == "cuda"

    def run(K: int) -> float:
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
        else:
            start = time.perf_counter()
        acc = call().to(torch.int64)
        for _ in range(K - 1):
            acc = acc + call()
        if cuda:
            t1.record()
            acc.item()
            return t0.elapsed_time(t1) / 1e3
        acc.item()
        return time.perf_counter() - start

    run(k_lo)
    run(k_hi)

    def best(K: int) -> float:
        return min(run(K) for _ in range(n))

    return (best(k_hi) - best(k_lo)) / (k_hi - k_lo)


def timed(label: str, call, device, n: int, traced: list | None) -> float:
    """Seconds per call of ``call`` (:func:`kloop_seconds`); the call is
    kept in ``traced`` for :func:`log_device_times`."""
    s = kloop_seconds(call, device, n)
    if traced is not None:
        traced.append((label, call, s))
    return s


def log_device_times(prog: str, traced: list, device) -> None:
    """The :func:`device_time_line` of each call in ``traced`` (from
    :func:`timed`), on stderr, after ``[prog]``."""
    for label, call, s in traced:
        print(f"[{prog}] {device_time_line(label, call, s, device)}",
              file=sys.stderr, flush=True)


def device_time_line(label: str, call, span_s: float, device,
                     n: int = 100) -> str:
    """One line for a timed call: its seconds per call by
    :func:`kloop_seconds` beside, on a CUDA device, the device time of its
    work per call from a torch.profiler trace of ``n`` calls
    (:func:`trace_ms`) and the card's busy share of the span. Where the
    share is low the span is the host's enqueue, not the card's work."""
    span_ms = span_s * 1e3
    if torch.device(device).type != "cuda":
        return (f"{label}: {span_ms:.4f} ms a call (host clock, the plain "
                f"versions on the cpu; no device time)")
    ms, events = trace_ms(call, None, n)
    return (f"{label}: {span_ms:.4f} ms a call by CUDA events (K-loop), "
            f"{ms:.4f} ms of device work a call by torch.profiler "
            f"({events / n:.1f} device operations a call), busy share "
            f"{ms / span_ms if span_ms > 0 else float('nan'):.3f}")


def trace_ms(fn, fn_name: str | None = None, n: int = 100
             ) -> tuple[float, int]:
    """From a torch.profiler trace of n calls of ``fn``: (device ms per
    launch of the kernel ``fn_name``, launches traced), or with no
    ``fn_name`` (device ms per call of all its device work, device events
    traced). Raises if the trace holds no such device work. A launch
    shorter than its wrapper's host cost is timed here, not by CUDA events
    over back-to-back calls, which then time the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and (fn_name is None or fn_name in e.key)]
    count = sum(e.count for e in rows)
    if not count:
        raise RuntimeError(f"no device work of {fn_name or fn} in a trace of "
                           f"{n} calls")
    us = sum(e.device_time_total for e in rows)
    return us / 1e3 / (count if fn_name else n), count
