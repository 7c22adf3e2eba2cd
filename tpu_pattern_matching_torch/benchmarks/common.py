"""What the benchmark scripts share: where they find the upstream C
project's inputs, when a checkout of it is at hand, and the native
oracle's count of the events a session reports."""

from __future__ import annotations

import os

import numpy as np

# A checkout of gvasilious/gpu_pattern_matching, the C/OpenCL project this
# system is modelled on: its ClamAV signature sets and packet-length
# signature traces are the scripts' real inputs when it is there.
UPSTREAM_ENV = "TPM_UPSTREAM_DIR"


def upstream_path(*parts: str) -> str | None:
    """``parts`` under the checkout named by ``$TPM_UPSTREAM_DIR``, or
    None when the variable is not set."""
    root = os.environ.get(UPSTREAM_ENV)
    return os.path.join(root, *parts) if root else None


def oracle_match_ends(pats, payload: bytes) -> int:
    """The native oracle's distinct match end offsets in ``payload``: one
    event per end, as the session counts them (co-terminating patterns
    are one event)."""
    from tpu_pattern_matching_torch.core.oracle_native import NativeOracle

    off, _pid, total = NativeOracle(pats).match(payload,
                                                cap=4 * len(payload) + 1024)
    if total > len(off):
        raise RuntimeError("oracle capacity exceeded")
    return len(np.unique(off))
