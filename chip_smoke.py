#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``tpu_pattern_matching_torch``).

    python3 chip_smoke.py        # on a machine with one CUDA GPU

Phases, one line each (any failure exits non-zero at once):

1. build   — compile the CUDA probe kernels from
             ``tpu_pattern_matching_torch/csrc/`` with nvcc for sm_90a;
2. kernels — each kernel against its plain PyTorch version on the card,
             bit for bit (bitmap and total), on ragged random batches at
             the bench shape [4224, 4096]; CUDA-event times of both;
3. slice   — ``MatchSession(device="cuda")``: the bench workload (10,000
             random 12-byte signatures, seed 42) over 64 MiB of seeded
             random bytes with planted matches at 1e-3 density, and a
             small pattern set whose filter is strided; events must equal
             the native oracle's, and every probe kernel must have been
             launched by these runs;
4. no jax  — the port never imported jax.

The last lines are the card's name and power limit, a JSON line per-kernel
summary, and ``{"ok": true, "device": {...}}``. Exits non-zero, printing
no result, when there is no CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH_LANES = 4096  # bench.py's batch: 4096 lanes x 4096 bytes
CHUNK_LEN = 4096
STREAM_BYTES = 64 << 20
DENSITY = 1e-3
DEVICE = "cuda"
SOURCE = "tpu_pattern_matching_torch/csrc/bloom_probe.cu"
REPLACES = {  # the Pallas kernel bodies (both launched at bloom.py:1045)
    "sampled": "tpu_pattern_matching/ops/bloom.py:833",
    "strided": "tpu_pattern_matching/ops/bloom.py:687",
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, n: int) -> float:
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


def phase_build(kernels, card_line: str) -> None:
    t0 = time.perf_counter()
    kernels.cuda_library()
    secs = time.perf_counter() - t0
    b = kernels.last_build
    if not b:
        fail("the CUDA library was not built by this run")
    cmd = " ".join(os.path.relpath(c, HERE) if c.startswith(HERE)
                   else os.path.basename(c) for c in b["command"])
    ptxas = [ln.split(":", 1)[-1].strip() for ln in b["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] {cmd}: {b['seconds']:.2f} s (first use {secs:.2f} s) "
          f"on {card_line}; ptxas: {' | '.join(ptxas)}", flush=True)


def random_cfg(bloom, mode, q, sw, k, v, fold, seed):
    rng = np.random.RandomState(seed)
    mix1 = tuple(int(x) | 1 for x in rng.randint(1, 2**31, size=q))
    mix2 = tuple(int(x) | 1 for x in rng.randint(1, 2**31, size=q))
    sampled = mode == "sampled"
    return bloom.BloomConfig(
        q=q, stride=1 if sampled else sw, kbanks=k, v=v, mix1=mix1,
        mix2=mix2, fold_case=fold, gt=128 if sampled else bloom.GT,
        sampled=sampled, w=sw if sampled else 0,
    )


def phase_kernels(torch, bloom, kernels, card_line: str) -> dict:
    """Kernel vs plain on the card, bit for bit; returns per-mode times
    of the bench configs at the bench shape."""
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(1234)
    halo = 16  # pad_halo(11, 4096): the bench batch is [4096, 4112]
    C, T = BATCH_LANES, halo + CHUNK_LEN
    data_np = rng.randint(0, 256, size=(C, T)).astype(np.uint8)
    start = rng.randint(0, halo + 1, size=C).astype(np.int32)
    end = rng.randint(T - 300, T + 1, size=C).astype(np.int32)
    empty = rng.rand(C) < 0.05
    end[empty] = start[empty]  # empty lanes
    end[:64] = rng.randint(0, 200, size=64)  # short lanes
    end[:64] = np.maximum(end[:64], start[:64])
    data = torch.from_numpy(data_np).to(dev)
    bounds = torch.from_numpy(np.stack([start, end])).to(dev)
    configs = [  # (label, mode, q, stride|w, k, v, fold)
        ("bench pick", "sampled", 4, 9, 6, 8, False),
        ("k>8", "sampled", 4, 9, 12, 8, False),
        ("v=256 (global words)", "sampled", 4, 9, 6, 256, False),
        ("w=20 (wide context)", "sampled", 4, 20, 6, 8, False),
        ("nocase", "sampled", 4, 9, 6, 8, True),
        ("strided", "strided", 4, 4, 6, 16, False),
        ("strided nocase k>8", "strided", 3, 5, 10, 4, True),
    ]
    times = {}
    for i, (label, mode, q, sw, k, v, fold) in enumerate(configs):
        cfg = random_cfg(bloom, mode, q, sw, k, v, fold, seed=i)
        # random words: ~half the bits set, so a large share of tested
        # rows survives and every bank decision is compared
        words = torch.from_numpy(
            rng.randint(-(2**31), 2**31, size=(k, v, 128)).astype(np.int32)
        ).to(dev)
        data_tm, Cp = bloom.prep_time_major(data, cfg)
        bp = bloom.pad_bounds(bounds, Cp)
        kb, kt = kernels.launch_probe(data_tm, bp, words, cfg)
        torch.cuda.synchronize()
        pb, pt = bloom.probe_bits_plain(data_tm, bp, words, cfg)
        torch.cuda.synchronize()
        err = int((kb.to(torch.int64) - pb.to(torch.int64)).abs().max())
        if not torch.equal(kb, pb) or int(kt[0]) != int(pt[0]):
            fail(f"[kernels] {mode} {label}: kernel differs from plain "
                 f"(max_abs_err {err}, totals {int(kt[0])} vs {int(pt[0])})")
        line = (f"[kernels] {mode:7s} {label:22s} q{q} {'w' if mode == 'sampled' else 's'}{sw} "
                f"k{k} v{v}{' fold' if fold else ''} [{data_tm.shape[0]}, "
                f"{Cp}]: bits and total equal, tolerance 0 "
                f"({int(kt[0])} survivors)")
        if i in (0, 5):  # the bench configs of each mode: time both
            ms = cuda_ms(torch, lambda: kernels.launch_probe(
                data_tm, bp, words, cfg), 20)
            plain_ms = cuda_ms(torch, lambda: bloom.probe_bits_plain(
                data_tm, bp, words, cfg), 3)
            times[mode] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err)
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                     f"({card_line})")
        print(line, flush=True)
    return times


def plant(rng, pats, size, density):
    data = rng.randint(0, 256, size=size).astype(np.uint8)
    L = len(pats[0])
    n = max(1, int(size * density) // L)
    pos = rng.randint(0, size - L, size=n)
    chosen = rng.randint(0, len(pats), size=n)
    arr = np.frombuffer(b"".join(pats), np.uint8).reshape(len(pats), L)
    data[pos[:, None] + np.arange(L)[None, :]] = arr[chosen]
    return data.tobytes(), n


def oracle_events(pats, data: bytes):
    from tpu_pattern_matching.core.oracle_native import NativeOracle

    off, pid, total = NativeOracle(pats).match(data, cap=1 << 22)
    if total > len(off):
        fail(f"oracle capacity exceeded ({total} events)")
    return sorted(zip(off.tolist(), pid.tolist()))


def run_session(torch, MatchSession, table, pats, data, label, card_line):
    t0 = time.perf_counter()
    sess = MatchSession(table, max_chunks=BATCH_LANES, chunk_len=CHUNK_LEN,
                        device=DEVICE)
    build_s = time.perf_counter() - t0
    cfg = sess.bloom_table.cfg
    want = oracle_events(pats, data)
    sess.find(data[: 1 << 20])  # warm-up: allocator, first launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sess.find(data)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if got != want:
        fail(f"[slice] {label}: {len(got)} events, oracle {len(want)}; "
             f"first difference "
             f"{next((a, b) for a, b in zip(got + [None], want + [None]) if a != b)}")
    mode = "sampled" if cfg.sampled else "strided"
    print(f"[slice] {label}: {mode}_q{cfg.q}s{cfg.stride}w{cfg.w}k{cfg.kbanks}"
          f"v{cfg.v} k_ref {sess._bloom.k_ref}, filter build {build_s:.2f} s; "
          f"find over {len(data)} B -> {len(got)} events == native oracle; "
          f"{len(data) / secs:.6g} B/s end to end (smoke number, {card_line}); "
          f"refine overflows {sess.refine_overflows}", flush=True)
    return mode


def phase_slice(torch, kernels, card_line: str) -> dict:
    from tpu_pattern_matching.core.dfa import compile_patterns
    from tpu_pattern_matching_torch.runtime.session import MatchSession

    rng = np.random.RandomState(42)  # bench.py's workload
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(10_000)]
    t0 = time.perf_counter()
    table = compile_patterns(pats)
    print(f"[slice] workload: {len(pats)} x 12 B signatures (seed 42), DFA "
          f"{table.num_states} states in {time.perf_counter() - t0:.2f} s",
          flush=True)
    drng = np.random.RandomState(7)
    data, n_planted = plant(drng, pats, STREAM_BYTES, DENSITY)
    small = [bytes(drng.randint(0, 256, size=12).astype(np.uint8))
             for _ in range(3)]
    data_small, _ = plant(drng, small, STREAM_BYTES // 4, DENSITY)
    small_table = compile_patterns(small)

    for k in kernels.probe_launches:
        kernels.probe_launches[k] = 0
    modes = [
        run_session(torch, MatchSession, table, pats, data,
                    f"bench workload, {n_planted} planted", card_line),
        run_session(torch, MatchSession, small_table, small, data_small,
                    "3-pattern set", card_line),
    ]
    launches = dict(kernels.probe_launches)
    if sorted(modes) != ["sampled", "strided"]:
        fail(f"[slice] the two sessions picked {modes}, not both modes")
    if not all(launches.values()):
        fail(f"[slice] a probe kernel was never launched: {launches}")
    print(f"[slice] kernel launches on the main path: {launches}", flush=True)
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, HERE)
    import tpu_pattern_matching_torch
    from tpu_pattern_matching_torch.ops import bloom, kernels

    if not tpu_pattern_matching_torch.__file__.startswith(HERE):
        fail(f"imported the port from {tpu_pattern_matching_torch.__file__}")
    card_line = card()
    phase_build(kernels, card_line)
    times = phase_kernels(torch, bloom, kernels, card_line)
    launches = phase_slice(torch, kernels, card_line)
    if "jax" in sys.modules:
        fail("jax was imported")
    print("[no jax] 'jax' not in sys.modules", flush=True)
    summary = {"kernels": [
        {"name": f"bloom_probe_{m}", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[m], "launches": launches[m],
         "max_abs_err": times[m]["max_abs_err"], "ms": times[m]["ms"],
         "plain_ms": times[m]["plain_ms"]}
        for m in ("sampled", "strided")
    ]}
    print(card_line)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
