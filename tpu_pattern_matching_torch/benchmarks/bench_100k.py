"""Large-pattern-set scale points, 100k / 300k / 1M patterns (port of the
reference's ``benchmarks/bench_100k.py``).

    python -m tpu_pattern_matching_torch.benchmarks.bench_100k \
        [N_PATTERNS] [--device cpu]

Random 12-byte patterns (``RandomState(42)``) at the probe-objective
pick, probed on one batch of 4096 lanes x 4096 bytes (aligned to the
pick's row tiles). Besides the probe's bytes/s (timed as in ``bench``:
CUDA-event spans of K eager calls, ``(t(9) - t(1)) / 8``; its device
time goes to stderr), each point reports what the scale curve has to
show: the DFA and filter build seconds, the process's resident memory
(``VmRSS``), the pick, that the fast dense window walker is bound
(``dense_walker_bound``: no silent fallback to the slow walker at
scale), and a save/load round trip of both compiled artifacts (skipped
past 500k patterns, as in the reference).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from tpu_pattern_matching_torch.utils.device import entry_device
from tpu_pattern_matching_torch.utils.measure import (card,
                                                      log_device_times, timed)

LANES = CHUNK = 4096
REPEATS = 5
ROUND_TRIP_MAX = 500_000  # patterns: past it the npz round trip is skipped


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return -1.0


def run(n_patterns: int = 100_000, device="cuda") -> dict:
    from tpu_pattern_matching_torch.bench import batch_rows
    from tpu_pattern_matching_torch.core.dfa import DfaTable, compile_patterns
    from tpu_pattern_matching_torch.engine import best_scan_total_fn
    from tpu_pattern_matching_torch.ops.bloom import BloomFilterTable
    from tpu_pattern_matching_torch.runtime.verify import Verifier

    dev = torch.device(device)
    rng = np.random.RandomState(42)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(n_patterns)]

    t0 = time.time()
    table = compile_patterns(pats)
    dfa_build_s = time.time() - t0
    t0 = time.time()
    # the probe objective: this curve reports the probe alone
    bft = BloomFilterTable.from_table(table, objective="probe")
    filter_build_s = time.time() - t0
    scan_total, halo = best_scan_total_fn(table, LANES, CHUNK,
                                          engine="bloom", bloom_table=bft,
                                          device=dev)
    cfg = bft.cfg

    # the exactness stage must bind the FAST walker at this scale (an
    # int32 table binds as a view: no extra memory)
    verifier = Verifier([p.symbols for p in table.patterns], q=cfg.q,
                        max_pat_len=table.max_pat_len, dense_table=table)
    dense_walker_bound = verifier._dense is not None

    save_s = load_s = -1.0
    if n_patterns <= ROUND_TRIP_MAX:
        with tempfile.TemporaryDirectory() as td:
            t0 = time.time()
            table.save(os.path.join(td, "dfa.npz"))
            bft.save(os.path.join(td, "bloom.npz"))
            save_s = time.time() - t0
            t0 = time.time()
            t2 = DfaTable.load(os.path.join(td, "dfa.npz"))
            b2 = BloomFilterTable.load(os.path.join(td, "bloom.npz"))
            load_s = time.time() - t0
            if t2.num_states != table.num_states or b2.cfg != bft.cfg:
                raise RuntimeError("the saved artifacts load differently")
            del t2, b2

    C = LANES
    _, B = batch_rows(table, cfg, CHUNK, halo)
    data = torch.from_numpy(
        rng.randint(0, 256, size=(C, halo + B)).astype(np.uint8)).to(dev)
    start_t = torch.full((C,), halo, dtype=torch.int32, device=dev)
    end_t = torch.full((C,), halo + B, dtype=torch.int32, device=dev)

    def probe():
        return scan_total(data, start_t, end_t)

    survivors = int(probe())
    traced = []
    per_scan = timed(f"probe at {n_patterns}", probe, dev, REPEATS, traced)
    log_device_times("bench_100k", traced, dev)
    return {
        "metric": f"scan_bytes_per_s_per_chip_{n_patterns // 1000}k_patterns",
        "value": C * B / per_scan,
        "unit": "bytes/s",
        "config": {"mode": "sampled" if cfg.sampled else "strided",
                   "q": cfg.q, "w": cfg.w, "stride": cfg.stride,
                   "k": cfg.kbanks, "v": cfg.v, "grams": bft.n_grams,
                   "fp_est": bft.fp_est},
        "survivor_rate_per_byte": survivors / (C * B),
        "dfa_build_s": round(dfa_build_s, 1),
        "filter_build_s": round(filter_build_s, 1),
        "states": table.num_states,
        "table_mb": round(table.nbytes / 1e6, 1),
        "rss_mb": round(_rss_mb(), 1),
        "dense_walker_bound": dense_walker_bound,
        "artifact_save_s": round(save_s, 1),
        "artifact_load_s": round(load_s, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_pattern_matching_torch.benchmarks.bench_100k")
    ap.add_argument("n_patterns", nargs="?", type=int, default=100_000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 2 without a card) or cpu")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    if dev.type == "cuda":
        print(f"[bench_100k] card: {card()}", file=sys.stderr, flush=True)
    print(json.dumps(run(args.n_patterns, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
