#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``tpu_pattern_matching_torch``).

    python3 chip_smoke.py        # on a machine with one CUDA GPU

Phases (any failure exits non-zero at once):

1. build    — compile both CUDA libraries of
              ``tpu_pattern_matching_torch/csrc/`` with nvcc for sm_90a, one
              nvcc each, both at once;
2. kernels  — each kernel against its plain PyTorch version on the card,
              bit for bit, with the CUDA-event and host times per call of
              the kernel and the CUDA-event time of the plain version: the
              sampled and strided probes on ragged random batches at the
              bench shape [4096 lanes, 4112], the packed strided probe
              (K3) on the same batch, and the dense lane walk on seeded
              lanes at an int32 (10k patterns) and an int16 (3 patterns)
              table;
3. slice    — ``MatchSession(device="cuda")``, the default path: the bench
              workload (10,000 random 12-byte signatures, seed 42) over 64
              MiB of seeded random bytes with planted matches at 1e-3
              density, and a 3-pattern set whose filter is strided; events
              must equal the native oracle's;
4. packed   — ``hits(packed=True)`` against ``hits(packed=False)`` at the
              bench shape with an s4 filter: equal bitmaps, and the time of
              prep + probe of each (A, B, B, A);
5. verify   — ``MatchSession(verify="device")`` on the same two
              workloads: events equal the oracle's, ``decode_counts``
              equals the oracle's per-group count of distinct match ends;
              the inputs of the window walk's largest launch of each
              workload are kept, and after the phase the kernel is checked
              against its plain version on them and timed, as in phase 2;
6. dense    — ``MatchSession(engine="dense")`` on the same two workloads:
              events equal the oracle's, no result slot overflowed;
7. trace    — torch.profiler traces: each kernel's device time per launch
              (the summary's ``ms``), and the device time of the packed
              A/B's prep + probe per call;
8. no jax   — the port never imported jax.

Each of phases 3-6 sets every launch count to 0 before its path and reads
them after it; each fails unless the kernels of its path were launched.
The last lines are the card's name and power limit, a JSON line with the
per-kernel summary, and ``{"ok": true, "device": {...}}``. Exits non-zero,
printing no result, when there is no CUDA device.
"""

from __future__ import annotations

import functools
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH_LANES = 4096  # bench.py's batch: 4096 lanes x 4096 bytes
CHUNK_LEN = 4096
HALO = 16  # pad_halo(11, 4096): the bench batch is [4096, 4112]
STREAM_BYTES = 64 << 20
DENSITY = 1e-3
DEVICE = "cuda"
AB = (False, True, True, False)  # packed A/B order: byte, packed, packed, byte
PROBE_SRC = "tpu_pattern_matching_torch/csrc/bloom_probe.cu"
WALK_SRC = "tpu_pattern_matching_torch/csrc/dfa_walk.cu"
KERNELS = {  # launch-count key: (summary name, __global__ function,
    #                               source, TPU kernel replaced)
    "sampled": ("bloom_probe_sampled", "probe_sampled_kernel", PROBE_SRC,
                "tpu_pattern_matching/ops/bloom.py:833"),
    "strided": ("bloom_probe_strided", "probe_strided_kernel", PROBE_SRC,
                "tpu_pattern_matching/ops/bloom.py:687"),
    "strided_packed": ("bloom_probe_strided_packed",
                       "probe_strided_packed_kernel", PROBE_SRC,
                       "tpu_pattern_matching/ops/bloom.py:730"),
    "window_walk": ("dfa_window_walk", "window_walk_kernel", WALK_SRC,
                    "tpu_pattern_matching/ops/verify_device.py:260"),
    "dense_walk": ("dfa_dense_walk", "dense_walk_kernel", WALK_SRC,
                   "tpu_pattern_matching/ops/match_xla.py:69"),
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


def host_ms(torch, fn, n: int) -> float:
    """Host ms per call over n calls without a sync: the launch cost."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs * 1e3 / n


def timed(torch, fn, plain, n: int, n_plain: int, err: int,
          card_line: str) -> tuple[dict, str]:
    """The CUDA-event and host times per call of a kernel and the
    CUDA-event time of its plain version, for the summary and a print
    line; ``fn`` is kept for the trace phase, which adds the device
    time."""
    t = dict(event_ms=cuda_ms(torch, fn, n), host_ms=host_ms(torch, fn, n),
             plain_ms=cuda_ms(torch, plain, n_plain), max_abs_err=err,
             fn=fn)
    return t, (f"; kernel {t['event_ms']:.4f} ms per call by CUDA events "
               f"over {n} calls, {t['host_ms']:.4f} ms host per call; plain "
               f"{t['plain_ms']:.4f} ms ({card_line})")


def trace_ms(torch, fn, fn_name=None, n: int = 100) -> tuple[float, int]:
    """From a torch.profiler trace of n calls of ``fn``: (device ms per
    launch of the kernel ``fn_name``, launches traced), or with no
    ``fn_name`` (device ms per call of all its device work, device
    events traced)."""
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
        fail(f"[trace] no device work of {fn_name or fn} in {n} calls")
    us = sum(e.device_time_total for e in rows)
    return us / 1e3 / (count if fn_name else n), count


def phase_trace(torch, times, ab_fns, card_line: str) -> None:
    """Device times from torch.profiler traces: each kernel's per launch,
    and the packed A/B's per call (every kernel of prep + probe). Runs
    last, so that the profiler's set-up and hooks cannot touch the
    host-bound times taken before it."""
    for key, t in times.items():
        t["ms"], count = trace_ms(torch, t.pop("fn"), KERNELS[key][1])
        print(f"[trace] {key:14s} {t['ms']:.4f} ms device time per launch "
              f"({count} launches traced of 100 calls); {t['event_ms']:.4f} "
              f"ms per call by CUDA events, {t['host_ms']:.4f} ms host per "
              f"call ({card_line})", flush=True)
    ab = [trace_ms(torch, ab_fns[packed])[0] for packed in AB]
    print(f"[trace] packed A/B, device time of prep + probe per call: byte "
          f"path {ab[0]:.4f}, {ab[3]:.4f} ms, packed path {ab[1]:.4f}, "
          f"{ab[2]:.4f} ms (A, B, B, A); packed/byte "
          f"{(ab[1] + ab[2]) / (ab[0] + ab[3]):.4f} ({card_line})", flush=True)


def max_abs_err(torch, got, want) -> int:
    """Largest elementwise difference over paired integer outputs."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"shape/dtype {tuple(g.shape)} {g.dtype} vs "
                 f"{tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
    return err


def reset(kernels) -> None:
    for k in kernels.launches:
        kernels.launches[k] = 0


def read_launches(kernels, label: str, needed) -> dict:
    got = dict(kernels.launches)
    missing = [k for k in needed if not got[k]]
    if missing:
        fail(f"[{label}] kernels of this path were never launched: "
             f"{missing} ({got})")
    print(f"[{label}] kernel launches on this path: {got}", flush=True)
    return got


def phase_build(kernels, card_line: str) -> None:
    t0 = time.perf_counter()
    kernels.build_all()
    secs = time.perf_counter() - t0
    for name in ("libtpm_probe_cuda.so", "libtpm_walk_cuda.so"):
        b = kernels.builds.get(name)
        if not b:
            fail(f"{name} was not built by this run")
        cmd = " ".join(os.path.relpath(c, HERE) if c.startswith(HERE)
                       else os.path.basename(c) for c in b["command"])
        ptxas = [ln.split(":", 1)[-1].strip() for ln in b["log"].splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
        print(f"[build] {cmd}: {b['seconds']:.2f} s on {card_line}; ptxas: "
              f"{' | '.join(ptxas)}", flush=True)
    print(f"[build] both libraries in {secs:.2f} s (parallel)", flush=True)


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


def ragged_batch(torch, seed):
    """The bench-shaped batch [4096, 4112] with ragged spans, on the card."""
    rng = np.random.RandomState(seed)
    C, T = BATCH_LANES, HALO + CHUNK_LEN
    data_np = rng.randint(0, 256, size=(C, T)).astype(np.uint8)
    start = rng.randint(0, HALO + 1, size=C).astype(np.int32)
    end = rng.randint(T - 300, T + 1, size=C).astype(np.int32)
    empty = rng.rand(C) < 0.05
    end[empty] = start[empty]  # empty lanes
    end[:64] = rng.randint(0, 200, size=64)  # short lanes
    end[:64] = np.maximum(end[:64], start[:64])
    dev = torch.device(DEVICE)
    return (torch.from_numpy(data_np).to(dev),
            torch.from_numpy(np.stack([start, end])).to(dev))


def phase_probes(torch, bloom, kernels, card_line: str) -> dict:
    """K1, K2 and K3 against the plain probe on the card, bit for bit;
    returns the times of the bench configs of each mode."""
    dev = torch.device(DEVICE)
    data, bounds = ragged_batch(torch, 1234)
    rng = np.random.RandomState(99)
    configs = [  # (label, mode, q, stride|w, k, v, fold, packed)
        ("bench pick", "sampled", 4, 9, 6, 8, False, False),
        ("k>8", "sampled", 4, 9, 12, 8, False, False),
        ("v=256 (global words)", "sampled", 4, 9, 6, 256, False, False),
        ("w=20 (wide context)", "sampled", 4, 20, 6, 8, False, False),
        ("nocase", "sampled", 4, 9, 6, 8, True, False),
        ("strided", "strided", 4, 4, 6, 16, False, False),
        ("strided nocase k>8", "strided", 3, 5, 10, 4, True, False),
        ("packed s4", "strided", 4, 4, 6, 16, False, True),
        ("packed s8 nocase k>8", "strided", 4, 8, 10, 4, True, True),
        ("packed s12 q6 v=256", "strided", 6, 12, 6, 256, False, True),
    ]
    timed_modes = ("bench pick", "strided", "packed s4")
    times = {}
    for i, (label, mode, q, sw, k, v, fold, packed) in enumerate(configs):
        cfg = random_cfg(bloom, mode, q, sw, k, v, fold, seed=i)
        # random words: ~half the bits set, so a large share of tested
        # rows survives and every bank decision is compared
        words = torch.from_numpy(
            rng.randint(-(2**31), 2**31, size=(k, v, 128)).astype(np.int32)
        ).to(dev)
        data_tm, Cp = bloom.prep_time_major(data, cfg, packed=packed)
        bp = bloom.pad_bounds(bounds, Cp)
        kb, kt = kernels.launch_probe(data_tm, bp, words, cfg)
        torch.cuda.synchronize()
        pb, pt = bloom.probe_bits_plain(data_tm, bp, words, cfg)
        torch.cuda.synchronize()
        err = max_abs_err(torch, (kb, kt), (pb, pt))
        kind = kernels.probe_mode(data_tm, cfg)
        if err or int(kt[0]) != int(pt[0]):
            fail(f"[kernels] {kind} {label}: kernel differs from plain "
                 f"(max_abs_err {err}, totals {int(kt[0])} vs {int(pt[0])})")
        line = (f"[kernels] {kind:14s} {label:22s} q{q} "
                f"{'w' if mode == 'sampled' else 's'}{sw} k{k} v{v}"
                f"{' fold' if fold else ''} {data_tm.dtype} "
                f"[{data_tm.shape[0]}, {Cp}]: bits and total equal, "
                f"tolerance 0 ({int(kt[0])} survivors)")
        if label in timed_modes:
            times[kind], text = timed(
                torch,
                functools.partial(kernels.launch_probe, data_tm, bp, words,
                                  cfg),
                functools.partial(bloom.probe_bits_plain, data_tm, bp, words,
                                  cfg),
                50, 3, err, card_line)
            line += text
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


def planted_batch(torch, pats, seed):
    """A bench-shaped batch [4096, 4112] of planted matches at 1e-2, with
    ragged spans: the inputs of the walk kernels."""
    rng = np.random.RandomState(seed)
    C, T = BATCH_LANES, HALO + CHUNK_LEN
    raw, _ = plant(rng, pats, C * T, 1e-2)
    data = np.frombuffer(raw, np.uint8).reshape(C, T)
    start = np.where(rng.rand(C) < 0.2, HALO, 0).astype(np.int32)
    end = rng.randint(T - 300, T + 1, size=C).astype(np.int32)
    end[rng.rand(C) < 0.03] = HALO  # empty lanes
    dev = torch.device(DEVICE)
    return (torch.from_numpy(data.copy()).to(dev),
            torch.from_numpy(np.stack([start, end])).to(dev))


def phase_dense_walk(torch, kernels, workloads, card_line: str) -> dict:
    """W1 (dense walk) against its plain version on the card, bit for
    bit, at the int32 and the int16 table."""
    from tpu_pattern_matching_torch.ops import match_xla
    from tpu_pattern_matching_torch.ops.table import DeviceTable

    dev = torch.device(DEVICE)
    times = {}
    for w in workloads:
        table, pats = w["table"], w["pats"]
        dt = DeviceTable.put(table, dev)
        data, bounds = planted_batch(torch, pats, seed=len(pats))
        C, T = data.shape
        data_tm = data.t().contiguous()
        dkw = dict(alphabet_size=256, halo=HALO, max_results=16,
                   state_gid=dt.state_gid, num_groups=dt.num_groups)
        got = kernels.launch_dense_walk(dt.table_flat, data_tm, bounds, **dkw)
        torch.cuda.synchronize()
        want = match_xla.dense_walk_plain(dt.table_flat, data_tm, bounds,
                                          **dkw)
        err = max_abs_err(torch, got, want)
        if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"[kernels] dense walk, {w['label']}: kernel differs from "
                 f"plain (max_abs_err {err})")
        line = (f"[kernels] dense_walk     {w['label']:22s} "
                f"{dt.table_flat.dtype} table, [{T}, {C}] R16 with gcounts: "
                f"counts, slots and gcounts equal, tolerance 0 "
                f"({int(want[0].sum())} reports, max {int(want[0].max())} "
                f"in a lane)")
        if w["label"] == "bench workload":
            times["dense_walk"], text = timed(
                torch,
                functools.partial(kernels.launch_dense_walk, dt.table_flat,
                                  data_tm, bounds, **dkw),
                functools.partial(match_xla.dense_walk_plain, dt.table_flat,
                                  data_tm, bounds, **dkw),
                10, 1, err, card_line)
            line += text
        print(line, flush=True)
    return times


def oracle_events(pats, data: bytes):
    from tpu_pattern_matching.core.oracle_native import NativeOracle

    off, pid, total = NativeOracle(pats).match(data, cap=1 << 22)
    if total > len(off):
        fail(f"oracle capacity exceeded ({total} events)")
    return sorted(zip(off.tolist(), pid.tolist()))


def make_workloads() -> list:
    from tpu_pattern_matching.core.dfa import compile_patterns

    rng = np.random.RandomState(42)  # bench.py's workload
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(10_000)]
    t0 = time.perf_counter()
    table = compile_patterns(pats)
    print(f"[workloads] {len(pats)} x 12 B signatures (seed 42), DFA "
          f"{table.num_states} states ({table.goto_signed.dtype}) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    drng = np.random.RandomState(7)
    data, n_planted = plant(drng, pats, STREAM_BYTES, DENSITY)
    small = [bytes(drng.randint(0, 256, size=12).astype(np.uint8))
             for _ in range(3)]
    data_small, n_small = plant(drng, small, STREAM_BYTES // 4, DENSITY)
    out = []
    for label, p, d, n in (("bench workload", pats, data, n_planted),
                           ("3-pattern set", small, data_small, n_small)):
        t = table if p is pats else compile_patterns(p)
        out.append(dict(label=label, pats=p, table=t, data=d, n_planted=n,
                        want=oracle_events(p, d)))
    return out


def timed_find(torch, sess, w, label):
    sess.find(w["data"][: 1 << 20])  # warm-up: allocator, first launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sess.find(w["data"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want = w["want"]
    if got != want:
        fail(f"[{label}] {w['label']}: {len(got)} events, oracle "
             f"{len(want)}; first difference "
             f"{next((a, b) for a, b in zip(got + [None], want + [None]) if a != b)}")
    return len(w["data"]) / secs


def cfg_name(cfg) -> str:
    mode = "sampled" if cfg.sampled else "strided"
    return f"{mode}_q{cfg.q}s{cfg.stride}w{cfg.w}k{cfg.kbanks}v{cfg.v}"


def session(MatchSession, w, **kw):
    return MatchSession(w["table"], max_chunks=BATCH_LANES,
                        chunk_len=CHUNK_LEN, device=DEVICE, **kw)


def phase_slice(torch, kernels, MatchSession, workloads, card_line) -> dict:
    """The default path (bloom + host verify) on both workloads."""
    reset(kernels)
    modes = []
    for w in workloads:
        t0 = time.perf_counter()
        sess = session(MatchSession, w)
        build_s = time.perf_counter() - t0
        cfg = sess.bloom_table.cfg
        rate = timed_find(torch, sess, w, "slice")
        modes.append("sampled" if cfg.sampled else "strided")
        print(f"[slice] {w['label']}, {w['n_planted']} planted: "
              f"{cfg_name(cfg)} k_ref {sess._bloom.k_ref}, filter build "
              f"{build_s:.2f} s; find over {len(w['data'])} B -> "
              f"{len(w['want'])} events == native oracle; {rate:.6g} B/s "
              f"end to end (smoke number, {card_line}); refine overflows "
              f"{sess.refine_overflows}", flush=True)
    if sorted(modes) != ["sampled", "strided"]:
        fail(f"[slice] the two sessions picked {modes}, not both modes")
    return read_launches(kernels, "slice", ("sampled", "strided"))


def phase_packed(torch, bloom, kernels, card_line) -> tuple[dict, dict]:
    """hits(packed=True) vs hits(packed=False), s4 filter, bench shape."""
    from tpu_pattern_matching_torch.ops.bloom import BloomFilterTable

    rng = np.random.RandomState(3)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(300)]
    bft = BloomFilterTable.build(pats, force=("strided", 4, 4, 6, 16))
    words = torch.from_numpy(bft.words).to(DEVICE)
    # the bench-shaped batch, with the filter's own patterns planted at
    # 1e-2 so that true grams survive
    data, bounds = planted_batch(torch, pats, seed=77)
    cfg = bft.cfg
    reset(kernels)
    t_pk, b_pk = bloom.hits(data, bounds, words, cfg, packed=True)
    torch.cuda.synchronize()
    launches = read_launches(kernels, "packed", ("strided_packed",))
    t_by, b_by = bloom.hits(data, bounds, words, cfg, packed=False)
    torch.cuda.synchronize()
    if not torch.equal(b_pk, b_by) or int(t_pk[0]) != int(t_by[0]):
        fail("[packed] hits(packed=True) and hits(packed=False) differ")
    fns = {packed: functools.partial(bloom.hits, data, bounds, words, cfg,
                                     packed=packed)
           for packed in (False, True)}
    ab = [cuda_ms(torch, fns[packed], 20) for packed in AB]
    print(f"[packed] {cfg_name(cfg)} at [{data.shape[0]}, {data.shape[1]}]: "
          f"bitmaps and totals equal ({int(t_pk[0])} survivors); prep + "
          f"probe per call by CUDA events: byte path {ab[0]:.4f}, "
          f"{ab[3]:.4f} ms, packed path {ab[1]:.4f}, {ab[2]:.4f} ms (A, B, "
          f"B, A; {card_line}); packed/byte "
          f"{(ab[1] + ab[2]) / (ab[0] + ab[3]):.4f}; PACKED_AUTO stays "
          f"{bloom.PACKED_AUTO}", flush=True)
    return launches, fns


def oracle_group_counts(sess, want) -> tuple[int, np.ndarray]:
    """Per-group counts of the oracle's distinct match ends."""
    ends: dict[int, set] = {}
    for off, pid in want:
        ends.setdefault(off, set()).add(pid)
    gc = np.zeros(sess.table.num_groups, np.int64)
    for pids in ends.values():
        gc[sess._gid_of_pidset[tuple(sorted(pids))]] += 1
    return len(ends), gc


def stream_counts(sess, data: bytes):
    from tpu_pattern_matching.runtime.buffers import StreamState

    buf = sess.new_buffer()
    fobj = io.BytesIO(data)
    stream = StreamState(file_id=0)
    total, gc = 0, None
    while True:
        code, rd = buf.add_stream(fobj, stream)
        if buf.chunks and (code == -1 or rd == 0):
            batch = buf.to_batch()
            t, g = sess.decode_counts(batch, sess.scan(batch))
            total += t
            gc = g if gc is None else gc + g
            buf.reset()
        if rd == 0:
            return total, gc


def phase_verify(torch, kernels, MatchSession, workloads, card_line):
    """verify="device" on both workloads. Returns the launch counts and,
    per workload, the inputs of the window walk's largest launch (most
    slots; the first of equals)."""
    from tpu_pattern_matching_torch.ops.verify_device import MAX_DEVICE_CAND

    walks = {}
    launch = kernels.launch_window_walk

    def keep_largest(*args, **kw):
        lane = args[3]
        if label not in walks or lane.shape[0] > walks[label][0][3].shape[0]:
            walks[label] = (args, kw)  # fresh tensors, never reused
        return launch(*args, **kw)

    reset(kernels)
    kernels.launch_window_walk = keep_largest
    try:
        for w in workloads:
            label = w["label"]
            sess = session(MatchSession, w, verify="device")
            totals = []
            orig = sess._dvf.verify

            def spy(data, bounds, bits, total, orig=orig, totals=totals):
                totals.append(total)
                return orig(data, bounds, bits, total)

            sess._dvf.verify = spy
            rate = timed_find(torch, sess, w, "verify")
            n_ev, gc = stream_counts(sess, w["data"])
            o_ev, o_gc = oracle_group_counts(sess, w["want"])
            if n_ev != o_ev or not np.array_equal(gc, o_gc):
                fail(f"[verify] {label}: decode_counts {n_ev} events, "
                     f"oracle {o_ev} distinct ends (per-group equal: "
                     f"{np.array_equal(gc, o_gc)})")
            split = sum(t > MAX_DEVICE_CAND for t in totals)
            print(f"[verify] {label}: {cfg_name(sess.bloom_table.cfg)}, "
                  f"find over {len(w['data'])} B -> {len(w['want'])} events "
                  f"== native oracle; decode_counts {n_ev} events == "
                  f"oracle's distinct ends, per group equal; largest "
                  f"unrefined probe total per batch {max(totals)} of the "
                  f"one-pass cap {MAX_DEVICE_CAND} at {BATCH_LANES} lanes "
                  f"({split} batches verified in lane passes); sticky "
                  f"k_walk {sess._dvf._k_walk}; {rate:.6g} B/s end to end "
                  f"(smoke number, {card_line})", flush=True)
    finally:
        kernels.launch_window_walk = launch
    launches = read_launches(kernels, "verify",
                             ("sampled", "strided", "window_walk"))
    return launches, walks


def phase_window_walk(torch, kernels, walks, card_line) -> dict:
    """W2 against its plain version on the inputs of the verify phase's
    largest launch of each workload, bit for bit, timed at the bench
    workload's."""
    from tpu_pattern_matching_torch.ops import verify_device

    times = {}
    for label, (args, kw) in walks.items():
        got = kernels.launch_window_walk(*args, **kw)
        torch.cuda.synchronize()
        want = verify_device.window_walk_plain(*args, **kw)
        err = max_abs_err(torch, got, want)
        if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"[kernels] window walk, {label}: kernel differs from "
                 f"plain (max_abs_err {err})")
        line = (f"[kernels] window_walk    {label:22s} {args[0].dtype} "
                f"table, the verify phase's largest launch: "
                f"{args[3].shape[0]} slots ({int(args[5][0])} live) x "
                f"{kw['steps']} steps over [{kw['C']}, {kw['T']}]: rep and "
                f"state equal, tolerance 0 ({int(want[0].sum())} reports)")
        if label == "bench workload":
            times["window_walk"], text = timed(
                torch,
                functools.partial(kernels.launch_window_walk, *args, **kw),
                functools.partial(verify_device.window_walk_plain, *args,
                                  **kw),
                500, 5, err, card_line)
            line += text
        print(line, flush=True)
    if "window_walk" not in times:
        fail(f"[kernels] no window walk of the bench workload ({list(walks)})")
    return times


def phase_dense(torch, kernels, MatchSession, workloads, card_line) -> dict:
    """engine="dense" on both workloads (find raises on slot overflow)."""
    reset(kernels)
    for w in workloads:
        sess = session(MatchSession, w, engine="dense")
        rate = timed_find(torch, sess, w, "dense")
        print(f"[dense] {w['label']}: table {sess.dev.nbytes} B "
              f"({sess.dev.table_flat.dtype}), find over {len(w['data'])} B "
              f"-> {len(w['want'])} events == native oracle, no result-slot "
              f"overflow (R {sess.max_results}); {rate:.6g} B/s end to end "
              f"(smoke number, {card_line})", flush=True)
    return read_launches(kernels, "dense", ("dense_walk",))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, HERE)
    import tpu_pattern_matching_torch
    from tpu_pattern_matching_torch.ops import bloom, kernels
    from tpu_pattern_matching_torch.runtime.session import MatchSession

    if not tpu_pattern_matching_torch.__file__.startswith(HERE):
        fail(f"imported the port from {tpu_pattern_matching_torch.__file__}")
    card_line = card()
    phase_build(kernels, card_line)
    times = phase_probes(torch, bloom, kernels, card_line)
    workloads = make_workloads()
    times.update(phase_dense_walk(torch, kernels, workloads, card_line))
    launches = phase_slice(torch, kernels, MatchSession, workloads,
                           card_line)
    packed_launches, ab_fns = phase_packed(torch, bloom, kernels, card_line)
    launches["strided_packed"] = packed_launches["strided_packed"]
    verify_launches, walks = phase_verify(torch, kernels, MatchSession,
                                          workloads, card_line)
    launches["window_walk"] = verify_launches["window_walk"]
    times.update(phase_window_walk(torch, kernels, walks, card_line))
    launches["dense_walk"] = phase_dense(
        torch, kernels, MatchSession, workloads, card_line)["dense_walk"]
    phase_trace(torch, times, ab_fns, card_line)
    if "jax" in sys.modules:
        fail("jax was imported")
    print("[no jax] 'jax' not in sys.modules", flush=True)
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[key],
         "max_abs_err": times[key]["max_abs_err"], "ms": times[key]["ms"],
         "plain_ms": times[key]["plain_ms"]}
        for key, (name, _fn, src, rep) in KERNELS.items()
    ]}
    print(card_line)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
