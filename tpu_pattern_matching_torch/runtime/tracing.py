"""Profiling hooks (port of the reference's ``runtime/tracing.py``): a
``torch.profiler`` trace of a run (the CLI's ``--profile``) and the
shared per-phase wall-time accumulator."""

from __future__ import annotations

import contextlib
import os

# jax-free at import (it imports jax only inside its device_trace)
from tpu_pattern_matching.runtime.tracing import PhaseTimer  # noqa: F401


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
