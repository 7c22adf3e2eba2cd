"""Measuring a kernel on the card: the H100's peak rates, the least time a
launch could take on its inputs (its bound), the card's name and power
limit, and times by CUDA events and by torch.profiler traces. Used by
``chip_smoke.py``, ``benchmarks.exp_bloom`` and the calibrator of
``ops.costmodel``; no session path imports it.
"""

from __future__ import annotations

import subprocess

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
