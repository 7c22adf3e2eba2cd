"""What the metric readers (``metrics/<name>.py``) share: a run's spans
and traced device time per unit of work. A reader returns None where the
run has nothing for it to read, and the harness leaves that metric out.

``run``: ``unit`` ("bytes" or "tokens"), ``symbols`` and ``batches`` of
the measured window, ``window_s``, ``setup_s``, ``rec`` (the window's
``stream.Record``), ``trace`` (the ``trace.Trace`` of the profiled
batches, or None), ``probe_bound`` (the frozen bound of one probe launch
of a profiled batch, or None)."""

from __future__ import annotations

import sys

import numpy as np

GIB = float(1 << 30)


def _volume(run: dict, unit: str, symbols: float) -> float | None:
    if run["unit"] != unit or symbols <= 0:
        return None
    return symbols / (GIB if unit == "bytes" else 1e6)


def span_ms_per(run: dict, span: str, unit: str) -> float | None:
    """Milliseconds of the window's ``span`` calls per GiB (``unit``
    "bytes") or per million tokens ("tokens")."""
    vol = _volume(run, unit, run["symbols"])
    spans = getattr(run["rec"], span)
    if vol is None or not spans:
        return None
    return float(np.sum(spans)) * 1e3 / vol


def latency_p95_ms(run: dict, unit: str) -> float | None:
    """95th percentile of the window's batch latencies (scan call to
    decode return); the sample count goes to standard error."""
    lat = run["rec"].latency
    if run["unit"] != unit or not lat:
        return None
    print(f"[perfbench] batch latency: {len(lat)} batches, median "
          f"{np.median(lat) * 1e3:.4f} ms", file=sys.stderr)
    return float(np.percentile(lat, 95)) * 1e3


def trace_of(run: dict, unit: str):
    if run["trace"] is None or run["unit"] != unit:
        return None
    return run["trace"]


def is_probe(name: str) -> bool:
    """The bloom probe kernels of ``csrc/bloom_probe.cu`` (sampled,
    strided, packed strided)."""
    return "probe_sampled_kernel" in name or "probe_strided" in name


def probe_roofline(run: dict, unit: str) -> float | None:
    """The probe's share of its bound: the frozen bound of a launch over
    its traced device time per launch, in %."""
    tr = trace_of(run, unit)
    if tr is None or not run["probe_bound"] or not tr.count(is_probe):
        return None
    ms = tr.device_s(is_probe) * 1e3 / tr.count(is_probe)
    return run["probe_bound"]["bound_ms"] / ms * 100 if ms else None


def idle_share(run: dict, unit: str) -> float | None:
    tr = trace_of(run, unit)
    if tr is None:
        return None
    return (1 - tr.busy_s / tr.window_s) * 100
