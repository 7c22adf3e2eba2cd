"""Prefix-scan throughput benchmark (port of the reference's
``benchmarks/prefix_sum_bench.py``, itself after the upstream project's
``prefixsum_test.c``).

    python -m tpu_pattern_matching_torch.benchmarks.prefix_sum_bench \
        [--count N] [--device cpu]

Times ``torch.cumsum`` over N int32 counts (the compaction pipeline's scan
input), the reference's ``jnp.cumsum``: the subject here is the library
scan itself, not a kernel of the port. On the card the time per call is
the CUDA-event mean over 20 back-to-back calls after a warm-up; on the CPU
the host clock over 20 calls. Prints Mbit/s like the original, then holds
the scan to the host's ``np.cumsum`` (an exact comparison).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from tpu_pattern_matching_torch.utils.device import entry_device
from tpu_pattern_matching_torch.utils.measure import card, event_ms

ITERS = 20


def run(count: int = 1 << 20, device="cuda") -> dict:
    dev = torch.device(device)
    x = np.random.RandomState(0).randint(0, 16, size=count).astype(np.int32)
    xd = torch.from_numpy(x).to(dev)

    def f():
        return torch.cumsum(xd, 0, dtype=torch.int32)

    if dev.type == "cuda":
        dt = event_ms(f, ITERS) / 1e3  # one warm-up call, then the mean
    else:
        f()  # warm-up (prefixsum_test.c does the same)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            f()
        dt = (time.perf_counter() - t0) / ITERS
    out = {
        "metric": "prefix_sum_mbit_per_s",
        "count": count,
        "value": count * 32 / dt / 1e6,
        "unit": "Mbit/s",
    }
    # correctness against a host scan (the upstream databuf test verifies
    # the same way)
    if not np.array_equal(f().cpu().numpy(), np.cumsum(x, dtype=np.int32)):
        raise RuntimeError("torch.cumsum differs from np.cumsum")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_pattern_matching_torch.benchmarks."
             "prefix_sum_bench")
    ap.add_argument("--count", type=int, default=1 << 20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 2 without a card) or cpu")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    if dev.type == "cuda":
        print(f"[prefix_sum_bench] card: {card()}", file=sys.stderr,
              flush=True)
    print(json.dumps(run(args.count, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
