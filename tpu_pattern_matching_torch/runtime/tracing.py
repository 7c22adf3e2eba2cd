"""Profiling hooks (port of the reference's ``runtime/tracing.py``): a
``torch.profiler`` trace of a run (the CLI's ``--profile``) and the
per-phase wall-time accumulator (a copy of the reference's)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Trace the body with ``torch.profiler`` when ``log_dir`` is set and
    write it there as a Chrome trace (``trace-<pid>.json``, readable in
    Perfetto or chrome://tracing): host ops, and the card's kernels and
    copies when a CUDA device is present."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{os.getpid()}.json"))


class PhaseTimer:
    """Accumulates wall time per phase (feed / h2d / scan / decode)."""

    def __init__(self):
        self.acc: dict[str, float] = defaultdict(float)
        self.n: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.acc[name] += time.perf_counter() - t0
            self.n[name] += 1

    def render(self) -> str:
        return " ".join(
            f"{k}={v:.3f}s/{self.n[k]}" for k, v in sorted(self.acc.items())
        )
