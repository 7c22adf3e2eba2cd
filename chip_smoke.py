#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``tpu_pattern_matching_torch``).

    python3 chip_smoke.py   # on a machine with one CUDA GPU

Phases (any failure exits non-zero at once):

0. pin      — ``TPM_COST_CONSTANTS`` is set to a missing path, so every
              filter is built with the reference's v5e constants and picks
              the reference's configs whatever cost file the host holds;
1. build    — compile the three CUDA libraries of
              ``tpu_pattern_matching_torch/csrc/`` with nvcc for sm_90a, one
              nvcc each, all at once; print each kernel's ptxas line
              (registers, stack, spills);
2. kernels  — each kernel against its plain PyTorch version on the card,
              bit for bit, with the CUDA-event and host times per call of
              the kernel, the CUDA-event time of the plain version and the
              launch's bound (``probe_bound``, ``walk_bound``): the
              sampled and strided probes on ragged random batches at the
              bench shape [4096 lanes, 4112] (with each launch's tiling:
              tiles, blocks, the dynamic shared memory opted into), the
              packed strided probe (K3, also with its tiling) on the same
              batch, both probes at both widths on batches of one tile and
              of two lane tiles, and the dense lane walk (with its plan:
              sub-spans per lane, steps per thread, threads, blocks) on
              seeded lanes at an int32 (10k patterns) and an int16 (3
              patterns) table, and on batches built for the seams between
              its sub-spans at uint8/int32, uint8/int16 and uint16/int16;
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
              equals the oracle's per-group count of distinct match ends
              (the sessions' dispatch numbers: phase 13); the
              inputs of the walk-and-emit kernel's largest launch of each
              workload are kept, and after the phase the kernel (stages
              3-5: the window walk, the compaction of its reports, the
              group counts) is checked against its plain version on them,
              bit for bit (meta, packed, gcounts), also with a forced
              event overflow and on a launch of over 64 blocks of dense
              candidates, and timed, as in phase 2;
6. dense    — ``MatchSession(engine="dense")`` on the same two workloads:
              events equal the oracle's, no result slot overflowed; then
              one more find of each with every scan and decode
              synchronised and timed;
7. ushort   — the packet-metadata path on uint16 token lanes: 2,000
              seeded signatures of 6-16 tokens (packet-length-like values)
              over 64 flow files of 8 M tokens in all, planted at 1e-3 per
              token, through the port's CLI (``main([... "--ushort", "-v",
              ...])`` in this process) with ``--engine bloom``, ``--engine
              bloom --verify device`` and ``--engine dense``, and through a
              library session whose filter is forced to the sampled
              (winnowing) mode; then the 3-signature fixture of
              tests/test_ushort.py on each engine. The (file, offset,
              pattern id) set of every run equals the native oracle's.
              Before it, the uint16 builds of the probes (a sampled and a
              strided config) and of the dense walk (the 2,000-signature
              int16 table, and cast to int32) are checked against their
              plain versions at the ushort CLI's batch shape [4096 lanes,
              16 + 2048 tokens]; after it, the uint16 walk-and-emit kernel
              on the device-verify run's own largest launch;
8. cli      — the byte CLI: the 10k x 12 B workload split over 16 files
              (64 MiB, ``--load-dfa``/``--load-bloom``, ``--json-stats``):
              totals equal the oracle's; a ``-v -t`` run of the 3-pattern
              set: its "Pattern ..." lines equal the oracle's events;
9. sentiment — ``apps.sentiment.run_library_mode`` on a seeded word list:
              per-word counts equal the oracle's;
10. main inputs — the sampled and strided probes, at both widths, on the
              main paths' own inputs kept from phases 3 and 7 (the fullest
              batch of each), against the plain probe, timed, with bounds;
10b. pshard — pattern shards on one device (``parallel/pshard.py``): the
              bench workload in 4 shard filters through ``MatchSession(
              pat_shards=4)`` with host and with device verify (events
              equal the oracle's; the probe kernels' launches move by 4 a
              batch), the OR-into-bitmap launches on the batch of the
              largest probe total against ``sharded_probe_bits_plain``,
              bit for bit, timed beside their bounds and one shard's
              launch; the deployment point of the reference's
              ``benchmarks/bench_pshard.py`` (300,000 random 12-byte
              patterns, 8 shards, probe only) the same way; the ushort
              CLI with ``--pat-shards 2`` and the byte CLI with
              ``--pat-shards 4 --save-bloom``, then ``--load-bloom``, each
              against the oracle; ``entry.entry()`` against the plain
              probe; and about 10 trials of the port's fuzz campaign
              (``tools.fuzz_campaign``) on the card, bounded to about
              20 s;
10c. mesh1 — the data-parallel mesh (``parallel/mesh.py``) at world 1: a
              1-rank NCCL group in this process on cuda:0, through
              ``MatchSession(mesh=...)`` with host verify, device verify
              and dense on both workloads (events equal the oracle's and,
              batch by batch with their totals, the flat session's; the
              find ms of each beside the flat find's; the collectives'
              ms a batch by CUDA events and on the host),
              ``ShardedBloomCounter.count`` against the flat device-verify
              ``decode_counts`` on every bench batch, and the byte CLI with
              ``--mesh all`` on phase 8's 16 files (totals equal the
              oracle's); the group is destroyed after it;
10d. mesh2 — two gloo ranks on cuda:0, spawned as ``chip_smoke.py
              --mesh2-rank R DIR``, each on 2048 lanes of the bench
              workload's first 4096-lane batch: per path, the union of the
              ranks' events, their totals and counts equal the flat
              session's on the same batch in this process, the count step
              equals the flat ``decode_counts``, and each rank's launch
              counts show the path's kernels; a rank's failure, or one
              that runs past MESH_TIMEOUT_S, fails the script;
10e. grid2 — the ("pat", "data") grid (``parallel.pshard.Mesh2DContext``):
              two gloo ranks on cuda:0, spawned as ``chip_smoke.py
              --grid2-rank R DIR``, holding the 2 shards of the bench
              workload's filter over one column of the full 4096 lanes:
              its 64 MiB through ``MatchSession(mesh=grid)`` with host and
              device verify (the leader's ``find`` equals the oracle's,
              the follower's is empty; batch by batch the leader's
              events, totals and counts equal the flat ``pat_shards=2``
              session's in this process, the follower's totals and
              counts are 0 or the global ones; the broadcast, the
              ``all_gather``s, the ``all_reduce``s and the leader's row
              gather in ms a batch by CUDA events and on the host), the
              count step (``global_pattern_counts`` of its ``gcounts``
              equal the oracle's per-pattern counts), and the probe step
              of the 300,000-pattern point of
              ``benchmarks/bench_pshard.py`` in 2 shards (the union bitmap
              equals the flat ``sharded_hits``, bit for bit); each rank's
              launch counts show K1 or K2 once a batch and W2 per
              dispatch;
10f. calibrate — the chooser's calibrator (``ops.costmodel``: the
              measurement and fit of ``calibrate``, ``run_calibration``,
              and its file written as ``calibrate`` writes it) at the
              reference's full shapes on the card (the 10k x 12 B
              point's [4096, 4112+] byte batch, the 2,000-signature
              point's [2048, 4096+] uint16 batch), into a file of the
              run's temporary directory: the six constants beside the v5e
              defaults, both points' picks, units and candidate counts,
              each timed call's CUDA-event ms per call (its probe launch
              and all its device work come from the trace phase), the
              file loaded (every constant positive and finite, source
              ``calibrated:cuda:...``), the user's cache file untouched,
              both points' probes against the plain probe on their
              batches; then the bench workload's and the ushort CLI's
              filters built again under the calibrated constants: a pick
              that differs runs its workload against the native oracle
              (the byte one as timed finds, A B B A), and both picks'
              probes are traced;
11. proto   — the prototype probes of the reference's
              ``benchmarks/exp_bloom.py`` (K4, one tile [286, 512]; K5, the
              grid [58368, 1024] of 128 tiles with their pad rows), each
              against its plain version on the card bit for bit, and
              against the copied NumPy model (K4; K5's first and last
              tile), timed beside its bound; then the port's experiment
              (``benchmarks.exp_bloom.main``), whose correctness line must
              say ok and whose launches are the summary's. It runs
              last before the trace: run right after phase 2, it
              slowed the slice phase's timed find 3-4x;
12. trace   — torch.profiler traces: each kernel's device time per launch
              (the summary's ``ms``) beside its bound and share, also on
              the main paths' inputs (and for the walk and emit, the
              device time of its call: two fills and the kernel), the
              sharded probes' device time per batch (S launches) beside
              their bounds and one shard's launch, and the device time of
              the packed A/B's prep + probe per call;
13. dispatch — per phase-5 session, on its batch of the largest probe
              total: the median host ms to enqueue one
              ``verify_candidates`` dispatch (in all and in stages 3-5)
              and per ``DeviceVerifier.verify``, synchronised; then the
              device operations (kernels, fills, copies) of the dispatch,
              in all and in stages 3-5, from torch.profiler traces
              (``dispatch_numbers``; after the trace phase: a profiler
              session thins the traces after it);
14. no jax  — the port never imported jax nor the JAX package.

Each of phases 3-9, 10b, 10c, 10d and 10e (in each rank), 10f and 11
sets every launch count to 0 before its path and reads them after it;
each fails unless the kernels of its path were launched. Each of phases
7-9, 10b-10f and 11 prints its wall time. The summary's ``launches``
are the main path's alone; it gives each kernel's launches in the
calibration (``calibration_launches``; the phase's record:
``calibration``), on the mesh and grid paths (``mesh_launches``) and in
the grid ranks (``grid_launches``).
The last lines are the card's name and power limit, a JSON line with the
per-kernel summary (every kernel at each symbol width, with its bound,
share and, for the probes, its numbers on the main path's inputs), and
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when there is no CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import sys
import tempfile
import time
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from tpu_pattern_matching_torch.utils.measure import (  # noqa: E402
    BANK_OPS, bound_of, card, event_ms, trace_ms)

# The chooser prices with the reference's v5e defaults whatever cost
# constants file the host holds (tests/conftest.py pins them alike), so
# every phase checks the reference's picks; the calibration phase points
# it at its own file for a while. Spawned ranks inherit the pin.
COST_ENV, COST_PIN = "TPM_COST_CONSTANTS", "/nonexistent/tpm-cost-constants"
os.environ[COST_ENV] = COST_PIN

BATCH_LANES = 4096  # bench.py's batch: 4096 lanes x 4096 bytes
CHUNK_LEN = 4096
HALO = 16  # pad_halo(11, 4096): the bench batch is [4096, 4112]
STREAM_BYTES = 64 << 20
DENSITY = 1e-3
DEVICE = "cuda"
AB = (False, True, True, False)  # packed A/B order: byte, packed, packed, byte
# the ushort CLI's batch at -B 4096 -G 4096: 2048 uint16 tokens a lane
U16_LANES = 4096
U16_TOKENS = 2048
U16_HALO = 16  # pad_halo(15, 2048): signatures are at most 16 tokens
U16_SIGS = 2000
U16_FILES = 64
U16_TOTAL = 8 << 20  # tokens in all (16 MiB of uint16 payload)
U16_DENSITY = 1e-3  # planted tokens per token
# the chooser's pick for 30,000 such signatures (the 2,000-signature set
# picks strided q3 s4 k6 v8): the forced filter of the sampled ushort run
SAMPLED_U16 = ("sampled", 3, 4, 8, 32)
SIGS = ("40,32,287,32,106,196; 6; File scanner (metasploit file scanning)\n"
        "40,32,287,32,106,186,32; 7; Directory scanner\n"
        "5,5,5; 3; triple five\n")  # tests/test_ushort.py's fixture
CLI_FILES = 16  # the byte CLI phase splits the 64 MiB stream into 16 files
PSHARD_BENCH = 4  # pattern shards of the bench workload (10k x 12 B)
# benchmarks/bench_pshard.py's deployment point (:73-85): 300,000 random
# 12-byte patterns (RandomState 42) in 8 shards, objective "probe", probed
# on a random batch of 4096 lanes x (halo + 4096) (RandomState 7)
PSHARD_DEPLOY = (300_000, 8)
FUZZ_TRIALS, FUZZ_SECONDS = 10, 20.0  # the fuzz campaign's trials on the card
CUDA_LIBRARIES = ("libtpm_probe_cuda.so", "libtpm_walk_cuda.so",
                  "libtpm_proto_cuda.so")
PROBE_SRC = "tpu_pattern_matching_torch/csrc/bloom_probe.cu"
WALK_SRC = "tpu_pattern_matching_torch/csrc/dfa_walk.cu"
PROTO_SRC = "tpu_pattern_matching_torch/csrc/proto_probe.cu"
KERNELS = {  # launch-count key: (summary name, __global__ function,
    #                               source, TPU kernel replaced)
    "sampled": ("bloom_probe_sampled", "probe_sampled_kernel", PROBE_SRC,
                "tpu_pattern_matching/ops/bloom.py:833"),
    "strided": ("bloom_probe_strided", "probe_strided_kernel", PROBE_SRC,
                "tpu_pattern_matching/ops/bloom.py:687"),
    "strided_packed": ("bloom_probe_strided_packed",
                       "probe_strided_packed_kernel", PROBE_SRC,
                       "tpu_pattern_matching/ops/bloom.py:730"),
    "window_walk": ("dfa_window_walk", "walk_emit_kernel", WALK_SRC,
                    "tpu_pattern_matching/ops/verify_device.py:260"),
    "dense_walk": ("dfa_dense_walk", "dense_walk_kernel", WALK_SRC,
                   "tpu_pattern_matching/ops/match_xla.py:69"),
    "sampled_u16": ("bloom_probe_sampled_u16", "probe_sampled_kernel",
                    PROBE_SRC, "tpu_pattern_matching/ops/bloom.py:833"),
    "strided_u16": ("bloom_probe_strided_u16", "probe_strided_kernel",
                    PROBE_SRC, "tpu_pattern_matching/ops/bloom.py:687"),
    "window_walk_u16": ("dfa_window_walk_u16", "walk_emit_kernel",
                        WALK_SRC,
                        "tpu_pattern_matching/ops/verify_device.py:260"),
    "dense_walk_u16": ("dfa_dense_walk_u16", "dense_walk_kernel", WALK_SRC,
                       "tpu_pattern_matching/ops/match_xla.py:69"),
    "proto_tile": ("bloom_proto_tile", "proto_probe_kernel", PROTO_SRC,
                   "benchmarks/exp_bloom.py:53"),
    "proto_grid": ("bloom_proto_grid", "proto_probe_kernel", PROTO_SRC,
                   "benchmarks/exp_bloom.py:130"),
}


# int32 operations counted per unit of work (the least a kernel can do;
# the card's peaks and BANK_OPS are in utils/measure.py):
SEL_OPS = 6  # a row's selection hash past its q multiply-adds (3) and its
#              share of a sliding window minimum (3)
WALK_OPS = 5  # a DFA step: the entry's index, the gather, the sign test,
#               the state (abs), the report test


def probe_bound(torch, bloom, data_tm, bp, words, cfg) -> dict:
    """The bound of one probe launch on its inputs: bytes = the symbol rows
    the grams read, the bounds and the words once, the bitmap and total
    written once; ops = (sampled) every row's selection hash, then per
    tested row its gram hash (q multiply-adds for m2 when sampled, 2q when
    strided) and BANK_OPS per bank probed until the first miss, counted on
    these inputs."""
    tested, m1, m2 = bloom.probe_tested(data_tm, bp, cfg)
    alive, probes = tested, 0
    for b in range(cfg.kbanks):
        probes += int(alive.sum())
        alive = alive & bloom.bank_hit(words, m1, m2, cfg, b)
    del m1, m2
    packed = data_tm.dtype == torch.int32
    T, Cp = data_tm.shape[0] * (4 if packed else 1), data_tm.shape[1]
    sym = 2 if data_tm.dtype == torch.uint16 else 1
    rows = T if cfg.sampled else T // cfg.stride * min(cfg.q, cfg.stride)
    nbytes = (rows * Cp * sym + bp.numel() * 4 + words.numel() * 4
              + T // (32 * cfg.stride) * Cp * 4 + 4)
    n_tested = int(tested.sum())
    if cfg.sampled:
        ops = T * Cp * (cfg.q + SEL_OPS) + n_tested * cfg.q
    else:
        ops = n_tested * 2 * cfg.q
    return dict(bound_of(nbytes, ops + probes * BANK_OPS), tested=n_tested,
                bank_probes=probes)


def sharded_bound(torch, bloom, data_tm, bp, words, cfg) -> tuple:
    """Bounds of the S-shard probe of one batch (``words [S, k, v, 128]``):
    (the function's: the batch, its bounds and the union bitmap once,
    every shard's words once, the selection and gram hashes once (the
    shards share ``cfg`` and its mixes), each shard's bank probes; the S
    launches': the sum of ``probe_bound`` over the shards plus the S - 1
    reads of the bitmap that the OR makes; shard 0's launch alone)."""
    per = [probe_bound(torch, bloom, data_tm, bp, words[s], cfg)
           for s in range(words.shape[0])]
    S = len(per)
    T = data_tm.shape[0] * (4 if data_tm.dtype == torch.int32 else 1)
    bitmap = T // (32 * cfg.stride) * bp.shape[1] * 4
    fn = bound_of(per[0]["bytes"] + (S - 1) * words[0].numel() * 4,
                  per[0]["ops"] + BANK_OPS * sum(p["bank_probes"]
                                                 for p in per[1:]))
    fn.update(tested=per[0]["tested"],
              bank_probes=sum(p["bank_probes"] for p in per))
    launches = bound_of(sum(p["bytes"] for p in per) + (S - 1) * bitmap,
                        sum(p["ops"] for p in per))
    return fn, launches, per[0]


def walk_bound(steps: int, sym: int, out_bytes: int) -> dict:
    """The bound of a DFA walk of ``steps`` steps: each symbol read once,
    the outputs written once, WALK_OPS per step; the table's entries are
    gathers that the caches serve (not counted)."""
    return bound_of(steps * sym + out_bytes, steps * WALK_OPS)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


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
          card_line: str, bound: dict) -> tuple[dict, str]:
    """The CUDA-event and host times per call of a kernel and the
    CUDA-event time of its plain version, with the launch's ``bound``,
    for the summary and a print line; ``fn`` is kept for the trace phase,
    which adds the device time."""
    t = dict(event_ms=event_ms(fn, n), host_ms=host_ms(torch, fn, n),
             plain_ms=event_ms(plain, n_plain), max_abs_err=err,
             fn=fn, **bound)
    return t, (f"; kernel {t['event_ms']:.4f} ms per call by CUDA events "
               f"over {n} calls, {t['host_ms']:.4f} ms host per call; plain "
               f"{t['plain_ms']:.4f} ms; {bound_text(bound)} ({card_line})")


def bound_text(b: dict) -> str:
    return (f"bound {b['bound_ms']:.6f} ms by {b['bound_by']} ({b['bytes']} "
            f"B, {b['ops']} int32 ops)")


def phase_trace(torch, times, main, shards, ab_fns, cal,
                card_line: str) -> None:
    """Device times from torch.profiler traces: each kernel's per launch
    (also on the main path's inputs, ``main``), the sharded probes' per
    batch (``shards``: S launches) and one shard's launch on the same
    batch, the packed A/B's per call (every kernel of prep + probe), and
    each call of the calibration phase (``cal``): its probe launch and all
    its device work per call, beside its CUDA-event time per call.
    Runs last, so that the profiler's set-up and hooks cannot touch the
    host-bound times taken before it."""
    for key, t in times.items():
        fn = t.pop("fn")
        t["ms"], count = trace_ms(fn, KERNELS[key][1])
        call = ""
        if key.startswith("window_walk"):  # two fills and the kernel
            t["call_ms"], n_ops = trace_ms(fn)
            call = (f", {t['call_ms']:.4f} ms device time per call (all "
                    f"{n_ops} device operations of 100 calls)")
        print(f"[trace] {key:14s} {t['ms']:.4f} ms device time per launch "
              f"({count} launches traced of 100 calls){call}; "
              f"{t['event_ms']:.4f} ms per call by CUDA events, "
              f"{t['host_ms']:.4f} ms host per call; {bound_text(t)}, share "
              f"{t['bound_ms'] / t['ms']:.4f} ({card_line})", flush=True)
    for key, t in main.items():
        t["ms"], count = trace_ms(t.pop("fn"), KERNELS[key][1])
        print(f"[trace] {key:14s} on the main path's inputs ({t['label']}): "
              f"{t['ms']:.4f} ms device time per launch ({count} launches "
              f"traced of 100 calls); {bound_text(t)}, share "
              f"{t['bound_ms'] / t['ms']:.4f} ({card_line})", flush=True)
    for key, t in shards.items():
        kernel = KERNELS[t["mode"]][1]
        t["launch_ms"], count = trace_ms(t.pop("fn"), kernel)
        t["ms"] = t["launch_ms"] * t["shards"]
        t["one_shard_ms"], _ = trace_ms(t.pop("one_fn"), kernel)
        print(f"[trace] {key} ({t['label']}): {t['ms']:.4f} ms device time "
              f"per batch, {t['shards']} launches of {t['launch_ms']:.4f} ms "
              f"({count} launches traced of 100 batches); "
              f"{bound_text(t)}, share {t['bound_ms'] / t['ms']:.4f}; the "
              f"{t['shards']} launches' bound {t['launches_bound_ms']:.6f} "
              f"ms, share {t['launches_bound_ms'] / t['ms']:.4f}; one "
              f"shard's launch on the same batch {t['one_shard_ms']:.4f} ms "
              f"(bound {t['one_shard_bound_ms']:.6f} ms); sharded / one "
              f"shard {t['ms'] / t['one_shard_ms']:.4f} ({card_line})",
              flush=True)
    for label, t in cal.items():
        fn = t.pop("fn")
        t["probe_ms"], count = trace_ms(fn, KERNELS[t["key"]][1])
        t["device_ms"], t["device_ops"] = trace_ms(fn)
        print(f"[trace] {label}: {t['event_ms']:.4f} ms per call by CUDA "
              f"events, {t['device_ms']:.4f} ms device time per call (all "
              f"{t['device_ops']} device operations of 100 calls; busy "
              f"{t['device_ms'] / t['event_ms']:.4f} of the event span), "
              f"its {t['key']} launch {t['probe_ms']:.4f} ms ({count} "
              f"launches traced) ({card_line})", flush=True)
    ab = [trace_ms(ab_fns[packed])[0] for packed in AB]
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
    for name in CUDA_LIBRARIES:  # every run builds from the sources
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(kernels.BUILD_DIR, name))
    t0 = time.perf_counter()
    kernels.build_all()
    secs = time.perf_counter() - t0
    for name in CUDA_LIBRARIES:
        b = kernels.builds.get(name)
        if not b:
            fail(f"{name} was not built by this run")
        cmd = " ".join(os.path.relpath(c, HERE) if c.startswith(HERE)
                       else os.path.basename(c) for c in b["command"])
        print(f"[build] {cmd}: {b['seconds']:.2f} s on {card_line}",
              flush=True)
        for kernel, info in ptxas_lines(b["log"]):
            print(f"[build] ptxas {kernel}: {info}", flush=True)
    print(f"[build] all {len(CUDA_LIBRARIES)} libraries in {secs:.2f} s "
          f"(parallel)", flush=True)


# a kernel's name in its mangled symbol, after its length (the anonymous
# namespace's prefix holds the file name and a hash)
KERNEL_NAME = re.compile(r"\d+([a-z][a-z_]*_kernel)I?([ht]?)")


def ptxas_lines(log: str) -> list:
    """(kernel, its ptxas registers / shared memory / spill line) of each
    entry function in an nvcc -Xptxas -v log; ``<u8>``/``<u16>`` mark the
    symbol width of a template instance (the dynamic shared memory a
    launch opts into is not in it: see the plans printed by the kernels
    phases)."""
    out, name, info = [], None, []
    for ln in log.splitlines() + ["Compiling entry function 'end'"]:
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            if name:
                k = KERNEL_NAME.search(name)
                width = {"h": "<u8>", "t": "<u16>"}.get(k.group(2), "")
                out.append((k.group(1) + width if k else name,
                            "; ".join(info)))
            name, info = m.group(1), []
        elif name and ("spill" in ln or "Used" in ln):
            info.append(ln.split(":", 1)[-1].strip())
    return out


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


def ragged_batch(torch, seed, T=HALO + CHUNK_LEN, halo=HALO, n_sym=256):
    """A batch [4096, T] of random symbols (uint8, or uint16 when the
    alphabet is wider than a byte) with ragged spans, on the card."""
    rng = np.random.RandomState(seed)
    C = BATCH_LANES
    data_np = rng.randint(0, n_sym, size=(C, T)).astype(
        np.uint8 if n_sym <= 256 else np.uint16)
    start = rng.randint(0, halo + 1, size=C).astype(np.int32)
    end = rng.randint(T - 300, T + 1, size=C).astype(np.int32)
    empty = rng.rand(C) < 0.05
    end[empty] = start[empty]  # empty lanes
    end[:64] = rng.randint(0, 200, size=64)  # short lanes
    end[:64] = np.maximum(end[:64], start[:64])
    dev = torch.device(DEVICE)
    return (torch.from_numpy(data_np).to(dev),
            torch.from_numpy(np.stack([start, end])).to(dev))


def check_probes(torch, bloom, kernels, data, bounds, configs, timed_modes,
                 seed0, card_line) -> dict:
    """Each probe config's kernel against the plain probe on the card, bit
    for bit, on one batch; returns the times of the ``timed_modes``
    configs, keyed by launch-count key."""
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(99 + seed0)
    times = {}
    for i, (label, mode, q, sw, k, v, fold, packed, *gt) in enumerate(
            configs):
        cfg = random_cfg(bloom, mode, q, sw, k, v, fold, seed=seed0 + i)
        if gt:  # a tile height of its own (the one-tile configs)
            cfg = dataclasses.replace(cfg, gt=gt[0])
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
        line += f"; {plan_text(kernels.probe_plan(data_tm, cfg))}"
        if label in timed_modes:
            times[kind], text = timed(
                torch,
                functools.partial(kernels.launch_probe, data_tm, bp, words,
                                  cfg),
                functools.partial(bloom.probe_bits_plain, data_tm, bp, words,
                                  cfg),
                50, 3, err, card_line,
                probe_bound(torch, bloom, data_tm, bp, words, cfg))
            times[kind]["args"] = (data_tm, bp, words, cfg)
            line += text
        print(line, flush=True)
    return times


def plan_text(plan: dict) -> str:
    return (f"tiles of {plan['words']} words x {plan['lanes']} lanes, "
            f"{plan['tiles']} tiles on {plan['blocks']} blocks of "
            f"{plan['threads']} threads, {plan['smem_bytes']} B of dynamic "
            f"shared memory opted into, bank words in "
            f"{'shared memory' if plan['words_in_smem'] else 'L2'}")


def phase_probes(torch, bloom, kernels, card_line) -> dict:
    """K1, K2 and K3 against the plain probe on the card, bit for bit;
    returns the times of the bench configs of each mode."""
    data, bounds = ragged_batch(torch, 1234)
    configs = [  # (label, mode, q, stride|w, k, v, fold, packed)
        ("bench pick", "sampled", 4, 9, 6, 8, False, False),
        ("k>8", "sampled", 4, 9, 12, 8, False, False),
        ("v=256 (global words)", "sampled", 4, 9, 6, 256, False, False),
        ("w=20 (wide context)", "sampled", 4, 20, 6, 8, False, False),
        ("nocase", "sampled", 4, 9, 6, 8, True, False),
        ("w=1", "sampled", 2, 1, 3, 4, False, False),
        ("q=8", "sampled", 8, 9, 6, 8, False, False),
        ("strided", "strided", 4, 4, 6, 16, False, False),
        ("strided nocase k>8", "strided", 3, 5, 10, 4, True, False),
        ("strided q=1", "strided", 1, 2, 3, 4, False, False),
        ("strided q=8 v=256", "strided", 8, 8, 4, 256, False, False),
        ("packed s4", "strided", 4, 4, 6, 16, False, True),
        ("packed s8 nocase k>8", "strided", 4, 8, 10, 4, True, True),
        ("packed s12 q6 v=256", "strided", 6, 12, 6, 256, False, True),
    ]
    return check_probes(torch, bloom, kernels, data, bounds, configs,
                        ("bench pick", "strided", "packed s4"), 0, card_line)


def phase_probes_u16(torch, bloom, kernels, card_line) -> dict:
    """The uint16 builds of K1 and K2 against the plain probe on a ragged
    uint16 batch at the ushort CLI's shape, bit for bit."""
    data, bounds = ragged_batch(torch, 4321, T=U16_HALO + U16_TOKENS,
                                halo=U16_HALO, n_sym=2048)
    _, q, w, k, v = SAMPLED_U16
    configs = [  # (label, mode, q, stride|w, k, v, fold, packed)
        ("30k-signature pick", "sampled", q, w, k, v, False, False),
        ("sampled w9 k>8", "sampled", 3, 9, 10, 8, False, False),
        ("2000-signature pick", "strided", 3, 4, 6, 8, False, False),
        ("fixture pick", "strided", 2, 2, 2, 1, False, False),
        ("strided v=256", "strided", 3, 8, 8, 256, False, False),
        ("sampled q=8 w=20", "sampled", 8, 20, 4, 8, False, False),
    ]
    return check_probes(torch, bloom, kernels, data, bounds, configs,
                        ("30k-signature pick", "2000-signature pick"), 100,
                        card_line)


def phase_probe_edges(torch, bloom, kernels, card_line) -> None:
    """K1 and K2 at both widths on batches of one tile (T of one tile,
    Cp = 128; gt 64 sampled, 32 strided) and of two lane tiles with spans
    that end inside tiles, bit for bit."""
    for n_sym, seed in ((256, 500), (2048, 600)):
        for C, T, gt in ((100, 60, True), (250, 250, False)):
            rng = np.random.RandomState(seed + C)
            dt = np.uint8 if n_sym == 256 else np.uint16
            data = rng.randint(0, n_sym, size=(C, T)).astype(dt)
            start = rng.randint(0, 20, size=C).astype(np.int32)
            end = rng.randint(T // 3, T + 1, size=C).astype(np.int32)
            end[::9] = start[::9]  # empty lanes
            dev = torch.device(DEVICE)
            configs = [  # (label, mode, q, stride|w, k, v, fold, packed, gt)
                ("one tile" if gt else "two lane tiles", "sampled", 3, 4, 8,
                 32, False, False, 64 if gt else 128),
                ("one tile" if gt else "two lane tiles", "strided", 3, 4, 6,
                 8, False, False, 32 if gt else bloom.GT),
            ]
            check_probes(torch, bloom, kernels,
                         torch.from_numpy(data).to(dev),
                         torch.from_numpy(np.stack([start, end])).to(dev),
                         configs, (), seed, card_line)


def phase_proto(torch, kernels, card_line) -> tuple[dict, dict]:
    """K4 and K5 (``benchmarks.exp_bloom``) on the experiment's own inputs
    (``make_tables(0)`` and the next two draws): each kernel against the
    plain version on the card, bit for bit, and against the copied NumPy
    model (K4; K5's first and last tile), timed beside its bound
    (``probe_work``: the rows read, output and table once; 2q ops a row and
    BANK_OPS per bank probed to the first miss). Then the port's
    experiment, ``exp_bloom.main()``: its correctness line must say ok.
    Returns the times and the launch counts of the experiment's run."""
    from tpu_pattern_matching_torch.benchmarks import exp_bloom as eb

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    bloom_np, mix1, mix2, rng = eb.make_tables(0)
    bloom = torch.from_numpy(bloom_np).to(dev)
    tile = rng.randint(0, 256, size=(eb.G * eb.S + eb.Q, eb.C))
    grid = rng.randint(0, 256, size=(eb.TILES * (eb.TT + eb.PADR), eb.CT))
    times = {}
    for key, run, data_np, geom, n in (
            ("proto_tile", eb.run_probe, tile, dict(eb.TILE, tiles=1), 200),
            ("proto_grid", eb.run_grid, grid, dict(eb.GRID, tiles=eb.TILES),
             50)):
        data_np = data_np.astype(np.uint8)
        data = torch.from_numpy(data_np).to(dev)
        got = run(data, bloom, mix1, mix2)
        torch.cuda.synchronize()
        got = got[None] if key == "proto_tile" else got  # [tiles, rows, C]
        want = eb.probe_plain(data, bloom, mix1, mix2, **geom)
        err = max_abs_err(torch, (got,), (want,))
        if err or not torch.equal(got, want):
            fail(f"[proto] {key}: kernel differs from plain (max_abs_err "
                 f"{err})")
        pitch, host = geom["pitch"], got.cpu().numpy()
        ends = sorted({0, geom["tiles"] - 1})
        for i in ends:
            win = eb.np_windows(data_np[i * pitch : (i + 1) * pitch],
                                geom["rows"])
            if not np.array_equal(host[i], eb.np_probe(
                    win, bloom_np, mix1, mix2).astype(np.int8)):
                fail(f"[proto] {key}: tile {i} differs from np_probe")
        work = eb.probe_work(data, bloom, mix1, mix2, **geom)
        times[key], text = timed(
            torch, functools.partial(run, data, bloom, mix1, mix2),
            functools.partial(eb.probe_plain, data, bloom, mix1, mix2,
                              **geom),
            n, 3, err, card_line, bound_of(work["bytes"], work["ops"]))
        print(f"[proto] {key:14s} {data.dtype} [{data.shape[0]}, "
              f"{data.shape[1]}] -> int8 {list(want.shape)}: equal to the "
              f"plain version and to np_probe on tiles {ends}, tolerance 0 "
              f"({work['hits']} hits, {work['bank_probes']} bank probes, "
              f"{work['bank_probes'] / want.numel():.4f} a row){text}",
              flush=True)
    t_main = time.perf_counter()
    reset(kernels)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = eb.main(["--device", DEVICE])
    launches = read_launches(kernels, "proto", ("proto_tile", "proto_grid"))
    for ln in out.getvalue().splitlines():
        print(f"[proto] exp_bloom.main: {ln}", flush=True)
    if rc or "ok = True" not in out.getvalue():
        fail(f"[proto] exp_bloom.main exited {rc} without an ok line")
    now = time.perf_counter()
    print(f"[proto] phase wall time {now - t_phase:.2f} s (exp_bloom.main "
          f"{now - t_main:.2f} s)", flush=True)
    return times, launches


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


def check_dense_walk(torch, kernels, table_flat, data_tm, bounds, dkw,
                     label, card_line, timed_key=None):
    """W1 against its plain version on the card, bit for bit; times it
    when ``timed_key`` names its launch-count key."""
    from tpu_pattern_matching_torch.ops import match_xla

    T, C = data_tm.shape
    got = kernels.launch_dense_walk(table_flat, data_tm, bounds, **dkw)
    torch.cuda.synchronize()
    want = match_xla.dense_walk_plain(table_flat, data_tm, bounds, **dkw)
    err = max_abs_err(torch, got, want)
    if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail(f"[kernels] dense walk, {label}: kernel differs from plain "
             f"(max_abs_err {err})")
    key = "dense_walk_u16" if data_tm.dtype == torch.uint16 else "dense_walk"
    plan = kernels.dense_plan(data_tm, halo=dkw["halo"],
                              max_pat_len=dkw["max_pat_len"])
    line = (f"[kernels] {key:14s} {label:22s} {table_flat.dtype} table "
            f"({table_flat.numel() * table_flat.element_size()} B), "
            f"{data_tm.dtype} [{T}, {C}] R{dkw['max_results']} with "
            f"gcounts: counts, slots and gcounts equal, tolerance 0 "
            f"({int(want[0].sum())} reports, max {int(want[0].max())} in a "
            f"lane); {plan['subspans']} sub-spans a lane, {plan['steps']} "
            f"steps a thread with the warm-up of {dkw['max_pat_len'] - 1}, "
            f"{plan['blocks']} blocks of {plan['threads']} threads, "
            f"{dense_loads(bounds, T, dkw, plan['subspans'])} table loads")
    times = {}
    if timed_key:
        times[timed_key], text = timed(
            torch,
            functools.partial(kernels.launch_dense_walk, table_flat, data_tm,
                              bounds, **dkw),
            functools.partial(match_xla.dense_walk_plain, table_flat,
                              data_tm, bounds, **dkw),
            10, 1, err, card_line, dense_bound(torch, data_tm, bounds, dkw))
        line += text
    print(line, flush=True)
    return times


def dense_loads(bounds, T: int, dkw, S: int) -> int:
    """W1's dependent table loads on these lanes: the steps of each of the
    S sub-spans of every lane, warm-up included (dfa_walk.cuh,
    dense_walk_piece)."""
    b = bounds.cpu().numpy().astype(np.int64)
    start = np.maximum(b[0], 0)[:, None]
    end = np.minimum(b[1], T)[:, None]
    halo, warm = dkw["halo"], dkw["max_pat_len"] - 1
    piece = -(-max(T - halo, 0) // S)
    first = halo + piece * np.arange(S)[None, :]
    lo = np.where(first < start, start, np.minimum(first, T))
    hi = np.minimum(first + piece, end)
    return int(np.where(lo < hi, hi - np.maximum(lo - warm, start), 0).sum())


def dense_bound(torch, data_tm, bounds, dkw) -> dict:
    """W1's bound: a step per symbol of each lane's span; outputs: the
    counts, R slots of (state, position) and the group counts."""
    C = data_tm.shape[1]
    steps = int((bounds[1].to(torch.int64) - bounds[0]).clamp(min=0).sum())
    out = C * 4 + 2 * C * dkw["max_results"] * 4 + dkw["num_groups"] * 4
    return walk_bound(steps, data_tm.element_size(), out + bounds.numel() * 4)


def window_bound(args, kw, meta) -> dict:
    """W2's bound, the work of stages 3-5 (the walk and emit): inputs lane
    and row per slot, the bounds, and the symbols of the live slots'
    windows, each distinct symbol once; outputs 12 B (lane, end, state)
    per reported event, the group counts and meta; ops WALK_OPS per step
    of each live slot."""
    data_flat, bounds, lane, row, n_exact = args[2:7]
    live = int(n_exact.reshape(()))
    lo = (lane[:live].cpu().numpy().astype(np.int64).clip(max=kw["C"] - 1)
          * kw["T"] + row[:live].cpu().numpy().astype(np.int64)
          - (kw["lmax"] - kw["q"]))
    pos = (lo[:, None] + np.arange(kw["steps"])[None, :]).clip(
        0, kw["C"] * kw["T"] - 1)
    syms = np.unique(pos).size * data_flat.element_size()
    nbytes = (lane.shape[0] * 8 + bounds.numel() * 4 + syms
              + int(meta[1]) * 12 + kw["num_groups"] * 4 + 5 * 4)
    return dict(bound_of(nbytes, live * kw["steps"] * WALK_OPS),
                live=live)


def phase_dense_walk(torch, kernels, workloads, card_line: str) -> dict:
    """W1 (dense walk) against its plain version on the card, bit for
    bit, at the int32 and the int16 table."""
    from tpu_pattern_matching_torch.ops.table import DeviceTable

    dev = torch.device(DEVICE)
    times = {}
    for w in workloads:
        table, pats = w["table"], w["pats"]
        dt = DeviceTable.put(table, dev)
        data, bounds = planted_batch(torch, pats, seed=len(pats))
        dkw = dict(alphabet_size=256, halo=HALO, max_results=16,
                   max_pat_len=table.max_pat_len, state_gid=dt.state_gid,
                   num_groups=dt.num_groups)
        times.update(check_dense_walk(
            torch, kernels, dt.table_flat, data.t().contiguous(), bounds,
            dkw, w["label"], card_line,
            "dense_walk" if w["label"] == "bench workload" else None))
    for wide, table_dtype in ((False, np.int32), (False, np.int16),
                              (True, np.int16)):
        table, data_tm, bounds = seam_batch(wide, table_dtype)
        dt = DeviceTable.put(table, dev)
        dkw = dict(alphabet_size=table.alphabet_size, halo=8, max_results=4,
                   max_pat_len=table.max_pat_len, state_gid=dt.state_gid,
                   num_groups=dt.num_groups)
        check_dense_walk(torch, kernels, dt.table_flat,
                         torch.from_numpy(data_tm).to(dev),
                         torch.from_numpy(bounds).to(dev), dkw, "seams",
                         card_line)
    return times


def seam_batch(wide: bool, table_dtype, C=300, T=8 + 600, halo=8):
    """A batch built for the seams between the dense walk's sub-spans
    (also the CPU tests' batch, tests/test_torch_dense.py): a 9-symbol
    pattern (the longest) planted every 13 rows at a shift of its own in
    each lane, so that it straddles every seam; patterns that end at one
    position (ab, cab, abcab); "aa" over a lane of a's, past its R slots
    (lane 5); lanes 10-39 start after the halo with a match across their
    start_t (a warm-up must clip there); empty lanes, lanes of 3 rows, a
    lane that ends before it starts and one that ends 2 rows past the
    halo; C need not be a multiple of 32 (the last warp of lanes is
    masked). ``wide``: uint16 symbols over the alphabet of 2048, a = 2047,
    with filler tokens past it (3000, 65535) that read as a. Returns
    (table, time-major data [T, C], bounds [2, C])."""
    from tpu_pattern_matching_torch.core.dfa import AhoCorasick

    rng = np.random.RandomState(31 + wide)
    a, b, c, d = (2047, 5, 1000, 7) if wide else (97, 98, 99, 100)
    pats = [(a, b, b, a, c, a, b, c, a), (a, a), (a, b), (c, a, b),
            (a, b, c, a, b)]
    ac = AhoCorasick(2048 if wide else 256)
    for pat in pats:
        ac.add_pattern(pat)
    table = ac.compile()
    table.goto_signed = table.goto_signed.astype(table_dtype)
    sym = np.uint16 if wide else np.uint8
    data = np.full((C, T), d, sym)
    if wide:  # never two fillers in a row
        data[:, 3::10] = rng.choice([3000, 65535], size=data[:, 3::10].shape)
    for lane in range(C):
        for o in range(lane % 13, T - 9, 13):
            data[lane, o : o + 9] = pats[0]
    data[5] = a
    data[9, 20:60] = np.tile(np.asarray(pats[4], sym), 8)
    start = np.where(rng.rand(C) < 0.5, 0, halo).astype(np.int32)
    end = rng.randint(T - 40, T + 1, size=C).astype(np.int32)
    start[10:40] = rng.randint(halo + 1, T // 2, size=30)
    for lane in range(10, 40):
        data[lane, start[lane] - 2 : start[lane] + 7] = pats[0]
    end[3::17] = start[3::17]
    end[4::17] = start[4::17] + 3
    start[6], end[6] = halo - 1, halo + 2
    end[7] = start[7] - 1
    return table, np.ascontiguousarray(data.T), np.stack([start, end])


def phase_dense_walk_u16(torch, kernels, ush, card_line: str) -> dict:
    """The uint16 build of W1 against its plain version on the card at
    the ushort CLI's batch shape and alphabet 2048: the 2,000-signature
    table as compiled (int16) and cast to int32, signatures planted at
    1e-2 per token."""
    from tpu_pattern_matching_torch.ops.table import DeviceTable

    dev = torch.device(DEVICE)
    dt = DeviceTable.put(ush["table"], dev)
    rng = np.random.RandomState(5)
    C, T = U16_LANES, U16_HALO + U16_TOKENS
    data = plant_tokens(rng, ush["sigs"], C * T, 1e-2).reshape(C, T)
    start = np.where(rng.rand(C) < 0.2, U16_HALO, 0).astype(np.int32)
    end = rng.randint(T - 300, T + 1, size=C).astype(np.int32)
    end[rng.rand(C) < 0.03] = U16_HALO  # empty lanes
    data_tm = torch.from_numpy(data).to(dev).t().contiguous()
    bounds = torch.from_numpy(np.stack([start, end])).to(dev)
    dkw = dict(alphabet_size=2048, halo=U16_HALO, max_results=16,
               max_pat_len=ush["table"].max_pat_len, state_gid=dt.state_gid,
               num_groups=dt.num_groups)
    print(f"[kernels] ushort table: {ush['table'].num_states} states x 2048 "
          f"symbols, {dt.table_flat.dtype}, {dt.nbytes} B on the card "
          f"(int32: {dt.table_flat.numel() * 4} B)", flush=True)
    times = check_dense_walk(torch, kernels, dt.table_flat, data_tm, bounds,
                             dkw, "2000 signatures", card_line,
                             "dense_walk_u16")
    check_dense_walk(torch, kernels, dt.table_flat.to(torch.int32), data_tm,
                     bounds, dkw, "same, cast to int32", card_line)
    return times


def oracle_events(pats, data: bytes):
    from tpu_pattern_matching_torch.core.oracle_native import NativeOracle

    off, pid, total = NativeOracle(pats).match(data, cap=1 << 22)
    if total > len(off):
        fail(f"oracle capacity exceeded ({total} events)")
    return sorted(zip(off.tolist(), pid.tolist()))


def make_workloads() -> list:
    from tpu_pattern_matching_torch.core.dfa import compile_patterns

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


@contextlib.contextmanager
def keep_probe_inputs(kernels, store: dict):
    """Keep the inputs of the probe launch of each kind (launch count key)
    with the most rows inside its lanes' spans made inside the block: the
    main path's own inputs at their fullest batch. It syncs at every
    launch, so it wraps only untimed runs made after the timed ones."""
    launch = kernels.launch_probe

    def keep(data_tm, bounds, words, cfg):
        key = kernels.probe_mode(data_tm, cfg)
        live = int((bounds[1] - bounds[0]).clamp(min=0).sum())
        if key not in store or live > store[key][0]:
            store[key] = (live, (data_tm, bounds, words, cfg))  # fresh
        return launch(data_tm, bounds, words, cfg)

    kernels.launch_probe = keep
    try:
        yield
    finally:
        kernels.launch_probe = launch


def phase_slice(torch, kernels, MatchSession, workloads, probe_inputs,
                card_line) -> dict:
    """The default path (bloom + host verify) on both workloads; then one
    more, untimed find of each keeps its probes' inputs in
    ``probe_inputs``."""
    reset(kernels)
    modes, sessions = [], []
    for w in workloads:
        t0 = time.perf_counter()
        sess = session(MatchSession, w)
        build_s = time.perf_counter() - t0
        cfg = sess.bloom_table.cfg
        w["bloom_table"] = sess.bloom_table  # for the CLI phase
        rate = timed_find(torch, sess, w, "slice")
        sessions.append(sess)
        modes.append("sampled" if cfg.sampled else "strided")
        print(f"[slice] {w['label']}, {w['n_planted']} planted: "
              f"{cfg_name(cfg)} k_ref {sess._bloom.k_ref}, filter build "
              f"{build_s:.2f} s; find over {len(w['data'])} B -> "
              f"{len(w['want'])} events == native oracle; {rate:.6g} B/s "
              f"end to end (smoke number, {card_line}); refine overflows "
              f"{sess.refine_overflows}", flush=True)
    if sorted(modes) != ["sampled", "strided"]:
        fail(f"[slice] the two sessions picked {modes}, not both modes")
    launches = read_launches(kernels, "slice", ("sampled", "strided"))
    with keep_probe_inputs(kernels, probe_inputs):
        for sess, w in zip(sessions, workloads):
            sess.find(w["data"])
    return launches


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
    ab = [event_ms(fns[packed], 20) for packed in AB]
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
    from tpu_pattern_matching_torch.runtime.buffers import StreamState

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


def device_ops(torch, fn, n: int = 20) -> tuple[int, int]:
    """(device operations: kernels, fills, copies; torch ops called from
    Python: aten ops under no other aten op) per call of ``fn``, from a
    torch.profiler trace of n calls: the mean, rounded, so that a device
    record that a trace misses or takes over from an earlier one cannot
    change the count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = sum(e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA)
    ops = sum(1 for e in prof.events()
              if e.device_type == DeviceType.CPU
              and e.name.startswith("aten::")
              and not (e.cpu_parent is not None
                       and e.cpu_parent.name.startswith("aten::")))
    return round(dev / n), round(ops / n)


class _Stop(Exception):
    pass


def dispatch_numbers(torch, sess, data: bytes, n: int = 200) -> dict:
    """On the batch of ``data``'s largest probe total: the device
    operations of one ``verify_candidates`` dispatch (the last of
    ``DeviceVerifier.verify``'s, after its retries), in all and in stages
    3-5 (all, less those of a run stopped where stage 3 is entered,
    ``verify_device.walk_and_emit``), the median host ms to enqueue the
    dispatch (not waiting for the card), in all and in stages 3-5 (the
    same subtraction, the two timed in turns), and the median host ms per
    ``DeviceVerifier.verify`` over n calls, each synchronised (timed
    before the profiler's sessions). It calls the session's launches of
    every kernel it reaches, so it runs after a phase's launch counts are
    read."""
    from tpu_pattern_matching_torch.ops import verify_device as vd

    dvf, kept = sess._dvf, {}
    verify = dvf.verify

    def spy(*args):
        if args[3] > kept.get("total", -1):
            kept.update(args=args, total=args[3])
        return verify(*args)

    dvf.verify = spy
    try:
        sess.find(data)
    finally:
        del dvf.verify  # the instance attribute shadowed the method
    args = kept["args"]
    dispatch = vd.verify_candidates
    calls = []

    def last_call(*a, **kw):
        calls.append((a, kw))
        return dispatch(*a, **kw)

    vd.verify_candidates = last_call
    try:
        dvf.verify(*args)
    finally:
        vd.verify_candidates = dispatch
    a, kw = calls[-1]
    entry = vd.walk_and_emit

    def stop(*_a, **_kw):
        raise _Stop

    def until_stage3():
        vd.walk_and_emit = stop
        try:
            dispatch(*a, **kw)
        except _Stop:
            pass
        finally:
            vd.walk_and_emit = entry

    def host_ms(*fns, sync_after: bool = False) -> list:
        """Per fn, its host ms per call (median over n rounds that call
        each fn once, in turns, so that drift on the host falls on all
        alike; each call starts on an idle card)."""
        times = [[] for _ in fns]
        for _ in range(n + 1):
            for fn, ts in zip(fns, times):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                if sync_after:
                    torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return [float(np.median(ts[1:])) for ts in times]

    enqueue, enqueue_1_2 = host_ms(lambda: dispatch(*a, **kw), until_stage3)
    (verify_ms,) = host_ms(lambda: dvf.verify(*args), sync_after=True)
    # the profiler last, so that no session of it precedes the timings
    total = device_ops(torch, lambda: dispatch(*a, **kw))
    before = device_ops(torch, until_stage3)
    return dict(total=kept["total"], dispatches=len(calls),
                k=(kw["k_cand"], kw.get("k_walk"), kw["k_ev"]),
                device_ops=total[0], stages_1_2=before[0],
                stages_3_5=total[0] - before[0], torch_ops=total[1],
                torch_ops_3_5=total[1] - before[1],
                enqueue_ms=enqueue, enqueue_3_5_ms=enqueue - enqueue_1_2,
                verify_host_ms=verify_ms)


def dispatch_text(d: dict) -> str:
    return (f"one verify_candidates dispatch (probe total {d['total']}, "
            f"k_cand/k_walk/k_ev {d['k']}, {d['dispatches']} dispatches in "
            f"the verify call): {d['device_ops']} device operations, "
            f"{d['stages_3_5']} of them in stages 3-5 (from walk_and_emit "
            f"on), {d['stages_1_2']} before; {d['torch_ops']} torch ops "
            f"called, {d['torch_ops_3_5']} in stages 3-5; median host ms to "
            f"enqueue the dispatch {d['enqueue_ms']:.4f}, its stages 3-5 "
            f"{d['enqueue_3_5_ms']:.4f} (less the median of a run stopped "
            f"at stage 3); median host ms per DeviceVerifier.verify, "
            f"synchronised: {d['verify_host_ms']:.4f}")


def phase_verify(torch, kernels, MatchSession, workloads, card_line):
    """verify="device" on both workloads. Returns the launch counts,
    per workload the inputs of the walk-and-emit kernel's largest launch
    (most slots; the first of equals), and the sessions with their
    workloads (for ``phase_dispatch``)."""
    from tpu_pattern_matching_torch.ops.verify_device import MAX_DEVICE_CAND

    walks = {}
    launch = kernels.launch_walk_and_emit

    def keep_largest(*args, **kw):
        lane = args[4]
        if label not in walks or lane.shape[0] > walks[label][0][4].shape[0]:
            walks[label] = (args, kw)  # fresh tensors, never reused
        return launch(*args, **kw)

    sessions = []
    reset(kernels)
    kernels.launch_walk_and_emit = keep_largest
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
            del sess._dvf.verify
            sessions.append((w, sess))
    finally:
        kernels.launch_walk_and_emit = launch
    launches = read_launches(kernels, "verify",
                             ("sampled", "strided", "window_walk"))
    return launches, walks, sessions


def phase_dispatch(torch, sessions, card_line) -> None:
    """Phase 5's sessions' dispatch numbers (``dispatch_numbers``); after
    the trace phase, whose traces its profiler sessions would thin."""
    for w, sess in sessions:
        d = dispatch_numbers(torch, sess, w["data"])
        if d["stages_3_5"] > 3:
            fail(f"[dispatch] {w['label']}: stages 3-5 took "
                 f"{d['stages_3_5']} device operations, not <= 3")
        print(f"[dispatch] {w['label']}: {dispatch_text(d)} ({card_line})",
              flush=True)


def dense_candidates(torch, kernels, args, kw, pats, every: int = 8):
    """Stages 3-5's inputs on the batch of ``args`` with dense candidates
    and dense matches: as many whole lanes as make over 64 blocks of
    slots are overwritten with ``pats`` planted at 0.5 (half their bytes
    pattern bytes) and given spans of the whole lane; every
    ``every``-th row of them is a candidate; then sentinels to the
    bucketed capacity."""
    from tpu_pattern_matching_torch.ops.verify_device import INT32_MAX, \
        next_cap

    C, T = kw["C"], kw["T"]
    rows = np.arange(0, T - kw["q"] + 1, every)
    block = kernels.emit_layout(kernels.walk_library(), 0, 0, 0)[
        "block_slots"]
    lanes = min(C, -(-(64 * block + 1) // rows.size))
    dev = args[0].device
    raw, _ = plant(np.random.RandomState(17), pats, lanes * T, 0.5)
    data = args[2].clone()
    data[: lanes * T] = torch.from_numpy(np.frombuffer(raw, np.uint8).copy()
                                         ).to(dev)
    bounds = args[3].clone()
    bounds[0, :lanes] = 0
    bounds[1, :lanes] = T
    lane = np.repeat(np.arange(lanes), rows.size).astype(np.int32)
    row = np.tile(rows, lanes).astype(np.int32)
    cap = next_cap(lane.size)
    lane_t = torch.full((cap,), C, dtype=torch.int32, device=dev)
    row_t = torch.full((cap,), INT32_MAX, dtype=torch.int32, device=dev)
    lane_t[: lane.size] = torch.from_numpy(lane).to(dev)
    row_t[: row.size] = torch.from_numpy(row).to(dev)
    n = torch.tensor([lane.size], dtype=torch.int64, device=dev)
    return ((args[0], args[1], data, bounds, lane_t, row_t, n, n, args[8]),
            dict(kw, k_ev=cap))


def emit_blocks(kernels, slots: int) -> int:
    """Blocks of a walk-and-emit launch of ``slots`` slots."""
    return kernels.emit_layout(kernels.walk_library(), slots, 0, 0)["blocks"]


def check_emit(torch, kernels, args, kw, what: str) -> tuple:
    """Stages 3-5's kernel against their plain version, bit for bit;
    returns (the plain outputs, max_abs_err, the text of the check)."""
    from tpu_pattern_matching_torch.ops import verify_device

    got = kernels.launch_walk_and_emit(*args, **kw)
    torch.cuda.synchronize()
    want = verify_device.walk_and_emit_plain(*args, **kw)
    err = max_abs_err(torch, got, want)
    if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail(f"[kernels] walk and emit, {what}: kernel differs from plain "
             f"(max_abs_err {err}; meta {got[0].tolist()} vs "
             f"{want[0].tolist()})")
    meta = want[0].tolist()
    slots = args[4].shape[0]
    return want, err, (
        f"{what}: {slots} slots ({int(args[6].reshape(()))} live, "
        f"{emit_blocks(kernels, slots)} blocks) x {kw['steps']} steps "
        f"over [{kw['C']}, {kw['T']}], k_ev {kw['k_ev']}: meta, packed and "
        f"gcounts equal, tolerance 0 (meta {meta})")


def phase_window_walk(torch, kernels, walks, timed_label, card_line,
                      pats=None) -> dict:
    """W2, the walk and emit (stages 3-5), against its plain version on
    the inputs of a verify run's largest launch of each workload, bit for
    bit, and timed at ``timed_label``'s (under the launch-count key of its
    symbol width); at ``timed_label``, also with the event capacity
    forced below its events, and (given the table's patterns ``pats``)
    on dense candidates over 64 blocks of slots."""
    from tpu_pattern_matching_torch.ops import verify_device

    times = {}
    for label, (args, kw) in walks.items():
        key = ("window_walk_u16" if args[2].dtype == torch.uint16
               else "window_walk")
        want, err, text = check_emit(
            torch, kernels, args, kw,
            f"{label}, the verify run's largest launch")
        print(f"[kernels] {key:15s} {args[0].dtype} table, {args[2].dtype} "
              f"symbols, {text}", flush=True)
        if label != timed_label:
            continue
        n_ev = int(want[0][0])
        over = dict(kw, k_ev=max(1, n_ev // 2))
        _w, _e, text = check_emit(torch, kernels, args, over,
                                  f"{label}, event capacity forced to "
                                  f"{over['k_ev']}")
        print(f"[kernels] {key:15s} {text}", flush=True)
        if pats:
            dargs, dkw = dense_candidates(torch, kernels, args, kw, pats)
            _w, _e, text = check_emit(torch, kernels, dargs, dkw,
                                      "dense candidates (every 8th row of "
                                      "whole lanes)")
            if emit_blocks(kernels, dargs[4].shape[0]) < 64:
                fail(f"[kernels] the dense-candidate launch has under 64 "
                     f"blocks ({dargs[4].shape[0]} slots)")
            print(f"[kernels] {key:15s} {text}", flush=True)
        bound = window_bound(args, kw, want[0].tolist())
        times[key], text = timed(
            torch,
            functools.partial(kernels.launch_walk_and_emit, *args, **kw),
            functools.partial(verify_device.walk_and_emit_plain, *args,
                              **kw),
            500, 5, err, card_line, bound)
        print(f"[kernels] {key:15s} {label}, timed ({bound['live']} live "
              f"slots){text}", flush=True)
    if not times:
        fail(f"[kernels] no walk and emit of {timed_label} ({list(walks)})")
    return times


def phase_dense(torch, kernels, MatchSession, workloads, card_line) -> dict:
    """engine="dense" on both workloads (find raises on slot overflow);
    then, after the launch counts are read, one more find of each with
    every scan and decode synchronised and timed."""
    reset(kernels)
    sessions = []
    for w in workloads:
        sess = session(MatchSession, w, engine="dense")
        rate = timed_find(torch, sess, w, "dense")
        sessions.append(sess)
        print(f"[dense] {w['label']}: table {sess.dev.nbytes} B "
              f"({sess.dev.table_flat.dtype}), find over {len(w['data'])} B "
              f"-> {len(w['want'])} events == native oracle, no result-slot "
              f"overflow (R {sess.max_results}); {rate:.6g} B/s end to end "
              f"(smoke number, {card_line})", flush=True)
    launches = read_launches(kernels, "dense", ("dense_walk",))
    for sess, w in zip(sessions, workloads):
        find_ms, spent, n = staged_find_ms(torch, sess, w["data"])
        print(f"[dense] {w['label']}: find {find_ms:.4f} ms with each stage "
              f"synchronised: scan {spent['scan']:.4f} ms, decode "
              f"{spent['decode']:.4f} ms over {n} batches, rest "
              f"{find_ms - spent['scan'] - spent['decode']:.4f} ms (host "
              f"clock, {card_line})", flush=True)
    return launches


def staged_find_ms(torch, sess, data: bytes) -> tuple[float, dict, int]:
    """One find of ``data`` with each ``scan`` and ``decode`` of the
    session synchronised and timed on the host clock: (find ms, ms spent
    per stage, batches)."""
    spent = {"scan": 0.0, "decode": 0.0}
    n = [0]

    def timed_stage(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            spent[name] += (time.perf_counter() - t0) * 1e3
            n[0] += name == "scan"
            return out
        return run

    sess.scan = timed_stage("scan", sess.scan)
    sess.decode = timed_stage("decode", sess.decode)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.find(data)
        torch.cuda.synchronize()
        find_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del sess.scan, sess.decode  # the instance attributes shadowed them
    return find_ms, spent, n[0]


def plant_tokens(rng, sigs, n_tokens, density):
    """n_tokens uint16 tokens like packet lengths (mostly 40-1514, one in
    ten anywhere below 2048) with ``sigs`` planted at ``density`` planted
    tokens per token (later plants may overwrite earlier ones; the oracle
    reads the result)."""
    data = packet_lengths(rng, n_tokens)
    mean = np.mean([len(s) for s in sigs])
    n = max(1, int(n_tokens * density / mean))
    for pos, k in zip(rng.randint(0, n_tokens - 16, size=n),
                      rng.randint(0, len(sigs), size=n)):
        data[pos : pos + len(sigs[k])] = sigs[k]
    return data


def packet_lengths(rng, n):
    v = rng.randint(40, 1515, size=n)
    wild = rng.rand(n) < 0.1
    v[wild] = rng.randint(0, 2048, size=int(wild.sum()))
    return v.astype(np.uint16)


def make_ushort_workload(tmp) -> dict:
    """2,000 seeded signatures of 6-16 tokens and 64 flow files of 8 M
    tokens in all, written under ``tmp``, with the native oracle's events
    as (file, start offset, pattern id)."""
    from tpu_pattern_matching_torch.core.oracle_native import NativeOracle
    from tpu_pattern_matching_torch.ushort import compile_signatures

    rng = np.random.RandomState(2000)
    sigs = [tuple(int(x) for x in packet_lengths(rng, rng.randint(6, 17)))
            for _ in range(U16_SIGS)]
    sig_path = os.path.join(tmp, "ushort.signatures")
    with open(sig_path, "w") as f:
        f.writelines(f"{','.join(map(str, sg))}; {len(sg)}; sig {i}\n"
                     for i, sg in enumerate(sigs))
    t0 = time.perf_counter()
    table = compile_signatures(sig_path)
    compile_s = time.perf_counter() - t0
    flow_dir = os.path.join(tmp, "flows")
    os.makedirs(flow_dir)
    per_file = U16_TOTAL // U16_FILES
    oracle = NativeOracle(sigs, alphabet=2048)
    want = set()
    for i in range(U16_FILES):
        toks = plant_tokens(rng, sigs, per_file, U16_DENSITY)
        name = os.path.join(flow_dir, f"10.0.{i // 8}.{i % 8 + 1}_"
                            f"{40000 + i}_172.16.0.{i + 1}_443_tcp")
        with open(name, "w") as f:
            f.write(",".join(map(str, toks.tolist())))
        oracle.reset()
        off, pid, total = oracle.match(toks, cap=1 << 20)
        if total > len(off):
            fail("ushort oracle capacity exceeded")
        want |= {(name, int(e) - len(sigs[p]) + 1, int(p))
                 for e, p in zip(off, pid)}
    print(f"[ushort] {U16_SIGS} signatures of 6-16 tokens (seed 2000): "
          f"DFA {table.num_states} states x 2048 symbols, "
          f"{table.goto_signed.dtype}, {table.nbytes} B, compiled in "
          f"{compile_s:.2f} s; {U16_FILES} flow files, {U16_TOTAL} tokens, "
          f"{len(want)} oracle events", flush=True)
    return dict(sigs=sigs, sig_path=sig_path, table=table,
                flow_dir=flow_dir, want=want)


USHORT_LINE = re.compile(r"^Pattern (-?\d+) \('(.*)'\) found in file '(.*)' "
                         r"at sequence offset (\d+) \[end: (\d+)\]$")
BYTE_LINE = re.compile(r"^Pattern (-?\d+) \('(.*)'\) found in file '(.*)' "
                       r"at offset (\d+) \[relative: (-?\d+)\]$")


def run_cli(cli_main, argv, pattern=None) -> tuple[set, dict]:
    """The port's CLI in this process: (the (file, offset, pattern id)
    set of its verbose lines, its --json-stats record)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv + ["--json-stats", "--device", DEVICE])
    if rc:
        fail(f"[cli] {argv} exited {rc}")
    lines = out.getvalue().split("\n")
    stats = json.loads(next(ln for ln in reversed(lines)
                            if ln.startswith("{")))
    events = set()
    for ln in lines:
        m = pattern and ln.startswith("Pattern ") and pattern.match(ln)
        if m:
            events.add((m.group(3), int(m.group(4)), int(m.group(1))))
    return events, stats


def check_events(label, got, want) -> None:
    if got != want:
        fail(f"[{label}] {len(got)} events, oracle {len(want)}; only in the "
             f"run: {sorted(got - want)[:3]}, only in the oracle: "
             f"{sorted(want - got)[:3]}")


def phase_ushort(torch, kernels, ush, probe_inputs, card_line):
    """The packet-metadata path through the CLI on each engine and a
    sampled library session; returns the launch counts and the inputs of
    the device-verify run's largest uint16 window walk. Then the bloom CLI
    run and one find of the sampled session again, untimed, keep the
    probes' inputs in ``probe_inputs``."""
    from tpu_pattern_matching_torch.core.oracle_native import NativeOracle
    from tpu_pattern_matching_torch.cli import main as cli_main
    from tpu_pattern_matching_torch.runtime.session import MatchSession

    t_phase = time.perf_counter()
    walks = {}
    launch = kernels.launch_walk_and_emit

    def keep_largest(*args, **kw):
        best = walks.get("ushort")
        if best is None or args[4].shape[0] > best[0][4].shape[0]:
            walks["ushort"] = (args, kw)  # fresh tensors, never reused
        return launch(*args, **kw)

    base = ["-f", ush["flow_dir"], "-p", ush["sig_path"], "--ushort", "-v",
            "-B", str(2 * U16_TOKENS), "-G", str(U16_LANES)]
    runs = [("bloom", ["--engine", "bloom"], ("strided_u16",)),
            ("bloom + device verify", ["--engine", "bloom", "--verify",
                                       "device"],
             ("strided_u16", "window_walk_u16")),
            ("dense", ["--engine", "dense"], ("dense_walk_u16",))]
    reset(kernels)
    kernels.launch_walk_and_emit = keep_largest
    try:
        for label, extra, needed in runs:
            before = dict(kernels.launches)
            got, st = run_cli(cli_main, base + extra, USHORT_LINE)
            check_events(f"ushort {label}", got, ush["want"])
            moved = {k: kernels.launches[k] - before[k] for k in needed}
            if not all(moved.values()):
                fail(f"[ushort] {label}: uint16 kernels not launched {moved}")
            rate = U16_TOTAL / (st["wall_us"] / 1e6)
            print(f"[ushort] CLI --engine {label}: {len(got)} events == "
                  f"native oracle, matches_total {st['matches_total']}, "
                  f"{st['rounds']} batches, launches {moved}; {rate:.6g} "
                  f"tokens/s over the CLI's STATS time (smoke number, "
                  f"{card_line})", flush=True)
    finally:
        kernels.launch_walk_and_emit = launch
    # the sampled (winnowing) uint16 probe: a library session whose filter
    # is forced to the 30,000-signature pick
    t0 = time.perf_counter()
    before = kernels.launches["sampled_u16"]
    sess = MatchSession(ush["table"], max_chunks=U16_LANES,
                        chunk_len=U16_TOKENS, device=DEVICE, engine="bloom",
                        bloom_opts={"force": SAMPLED_U16})
    got = set()
    for name in sorted(os.listdir(ush["flow_dir"])):
        path = os.path.join(ush["flow_dir"], name)
        with open(path, "rb") as f:
            for e, p in sess.find(f.read()):
                got.add((path, e - len(ush["sigs"][p]) + 1, p))
    last_flow = path
    check_events("ushort sampled", got, ush["want"])
    if kernels.launches["sampled_u16"] == before:
        fail("[ushort] the sampled session never launched sampled_u16")
    print(f"[ushort] library session, forced {cfg_name(sess.bloom_table.cfg)}"
          f": {len(got)} events == native oracle, "
          f"{kernels.launches['sampled_u16'] - before} sampled_u16 launches "
          f"in {time.perf_counter() - t0:.2f} s (one find per file)",
          flush=True)
    # the 3-signature fixture of tests/test_ushort.py, on each engine
    fx = os.path.join(os.path.dirname(ush["sig_path"]), "fixture")
    os.makedirs(os.path.join(fx, "flows"))
    with open(os.path.join(fx, "sigs"), "w") as f:
        f.write(SIGS)
    flows = {"10.0.0.1_444_10.0.0.2_443_tcp": [7, 40, 32, 287, 32, 106, 196,
                                               9],
             "10.0.0.3_80_10.0.0.4_443_tcp": [5, 5, 5, 5, 40, 32, 287, 32,
                                              106, 186, 32]}
    fsigs = [(40, 32, 287, 32, 106, 196), (40, 32, 287, 32, 106, 186, 32),
             (5, 5, 5)]
    oracle, fwant = NativeOracle(fsigs, alphabet=2048), set()
    for name, toks in flows.items():
        path = os.path.join(fx, "flows", name)
        with open(path, "w") as f:
            f.write(",".join(map(str, toks)))
        oracle.reset()
        off, pid, _ = oracle.match(np.asarray(toks, np.int32))
        fwant |= {(path, int(e) - len(fsigs[p]) + 1, int(p))
                  for e, p in zip(off, pid)}
    for label, extra, _ in runs:
        got, _st = run_cli(cli_main, ["-f", os.path.join(fx, "flows"), "-p",
                                      os.path.join(fx, "sigs"), "--ushort",
                                      "-v"] + extra, USHORT_LINE)
        check_events(f"ushort fixture {label}", got, fwant)
    print(f"[ushort] 3-signature fixture: {len(fwant)} events == native "
          f"oracle on every engine", flush=True)
    launches = read_launches(kernels, "ushort",
                             ("sampled_u16", "strided_u16", "window_walk_u16",
                              "dense_walk_u16"))
    print(f"[ushort] phase wall time {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    with keep_probe_inputs(kernels, probe_inputs):
        run_cli(cli_main, base + runs[0][1], USHORT_LINE)
        with open(last_flow, "rb") as f:
            sess.find(f.read())
    return launches, walks


def phase_main_probes(torch, bloom, kernels, inputs, card_line) -> dict:
    """K1 and K2 at both widths on the main paths' own inputs, kept from
    their runs: each against the plain probe, bit for bit, timed, with
    its bound. The sampled uint16 filter (the forced 30,000-signature
    pick) is probed on the ushort CLI's own batch."""
    inputs = {k: args for k, (_live, args) in inputs.items()}
    u16 = inputs["strided_u16"]
    cases = [
        ("sampled", "the 10k x 12 B bench filter on a batch of the 64 MiB "
         "stream", inputs["sampled"]),
        ("strided", "the 3-pattern set's filter on a batch of its stream",
         inputs["strided"]),
        ("strided_u16", "the 2,000-signature filter on the ushort CLI's "
         "batch", u16),
        ("sampled_u16", "the forced 30k-signature pick's filter on the "
         "ushort CLI's batch", (u16[0], u16[1], *inputs["sampled_u16"][2:])),
    ]
    main = {}
    for key, label, (data_tm, bp, words, cfg) in cases:
        kb, kt = kernels.launch_probe(data_tm, bp, words, cfg)
        torch.cuda.synchronize()
        pb, pt = bloom.probe_bits_plain(data_tm, bp, words, cfg)
        err = max_abs_err(torch, (kb, kt), (pb, pt))
        if err or int(kt[0]) != int(pt[0]):
            fail(f"[main inputs] {key} on {label}: kernel differs from "
                 f"plain (max_abs_err {err})")
        bound = probe_bound(torch, bloom, data_tm, bp, words, cfg)
        main[key], text = timed(
            torch,
            functools.partial(kernels.launch_probe, data_tm, bp, words, cfg),
            functools.partial(bloom.probe_bits_plain, data_tm, bp, words,
                              cfg),
            50, 3, err, card_line, bound)
        main[key].update(label=label, args=(data_tm, bp, words, cfg),
                         config=cfg_name(cfg), shape=list(data_tm.shape))
        print(f"[main inputs] {key:14s} {cfg_name(cfg)} {data_tm.dtype} "
              f"[{data_tm.shape[0]}, {data_tm.shape[1]}], {label}: bits and "
              f"total equal, tolerance 0 ({int(kt[0])} survivors of "
              f"{bound['tested']} tested rows, {bound['bank_probes']} bank "
              f"probes); {plan_text(kernels.probe_plan(data_tm, cfg))}"
              f"{text}", flush=True)
    return main


def cli_oracle(w) -> tuple[int, int]:
    """The oracle's (distinct match ends, events) of the bench workload
    over the byte CLI's 16 files: the events whose occurrence lies inside
    one file (12-byte patterns)."""
    size = len(w["data"]) // CLI_FILES
    inside = [(e, p) for e, p in w["want"] if (e - 11) // size == e // size]
    return len({e for e, _ in inside}), len(inside)


def phase_cli(torch, kernels, workloads, tmp, card_line) -> dict:
    """The byte CLI on the bench workload split over 16 files (totals
    against the oracle) and a -v -t run of the 3-pattern set (events
    against the oracle)."""
    from tpu_pattern_matching_torch.cli import main as cli_main

    t_phase = time.perf_counter()
    w = workloads[0]
    d = os.path.join(tmp, "bytes")
    os.makedirs(d)
    size = len(w["data"]) // CLI_FILES
    for i in range(CLI_FILES):
        with open(os.path.join(d, f"part{i:02d}"), "wb") as f:
            f.write(w["data"][i * size : (i + 1) * size])
    dfa, bft = os.path.join(tmp, "bench.dfa.npz"), os.path.join(
        tmp, "bench.bloom.npz")
    w["table"].save(dfa)
    w["bloom_table"].save(bft)
    want_total, n_inside = cli_oracle(w)
    reset(kernels)
    _, st = run_cli(cli_main, ["-f", d, "--load-dfa", dfa, "--load-bloom",
                               bft, "-B", str(CHUNK_LEN), "-G",
                               str(BATCH_LANES)])
    if (st["matches_total"], st["matches_reported"]) != (want_total,
                                                         n_inside):
        fail(f"[cli] bench workload: matches {st['matches_total']}/"
             f"{st['matches_reported']}, oracle {want_total}/{n_inside}")
    print(f"[cli] bench workload over {CLI_FILES} files ({len(w['data'])} B):"
          f" matches_total {st['matches_total']} == oracle, {st['rounds']} "
          f"batches; {st['throughput_mbps']:.6g} Mbps by the CLI's STATS "
          f"(smoke number, {card_line})", flush=True)
    launches = read_launches(kernels, "cli", ("sampled",))
    s = workloads[1]
    pat_path = os.path.join(tmp, "three.hex")
    with open(pat_path, "w") as f:
        f.writelines(p.hex() + "\n" for p in s["pats"])
    data_path = os.path.join(tmp, "three.bin")
    with open(data_path, "wb") as f:
        f.write(s["data"])
    # text mode drops only matches across a newline: the oracle's events
    # of the patterns with no newline in them
    want = {(data_path, e - 11, p) for e, p in s["want"]
            if b"\n" not in s["pats"][p]}
    reset(kernels)
    got, st = run_cli(cli_main, ["-f", data_path, "-p", pat_path, "-x", "-v",
                                 "-t", "-B", str(CHUNK_LEN), "-G",
                                 str(BATCH_LANES)], BYTE_LINE)
    check_events("cli -v -t", got, want)
    print(f"[cli] 3-pattern set, -v -t: {len(got)} 'Pattern' lines == "
          f"native oracle's events ({st['lines']} lines processed)",
          flush=True)
    launches.update(read_launches(kernels, "cli -t", ("strided",)))
    print(f"[cli] phase wall time {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    return launches


def phase_sentiment(torch, kernels, tmp, card_line) -> None:
    """``run_library_mode`` of the port's sentiment app on a seeded word
    list: the per-word counts equal the native oracle's."""
    from tpu_pattern_matching_torch.core.oracle_native import NativeOracle
    from tpu_pattern_matching_torch.apps import sentiment

    t_phase = time.perf_counter()
    rng = np.random.RandomState(11)

    def word():
        return "".join(chr(97 + c)
                       for c in rng.randint(0, 26, size=rng.randint(4, 9)))

    vocab = sorted({word() for _ in range(600)})
    neg, pos = vocab[:30], vocab[30:60]
    paths = {k: os.path.join(tmp, f"sentiment.{k}") for k in
             ("neg", "pos", "patterns", "text")}
    for k, words in (("neg", neg), ("pos", pos)):
        with open(paths[k], "w") as f:
            f.write("\n".join(words) + "\n")
    sentiment.build_sentiment_patterns(paths["neg"], paths["pos"], None,
                                       paths["patterns"])
    lines = [" ".join(rng.choice(vocab, size=rng.randint(5, 16)))
             for _ in range(50_000)]
    text = ("\n".join(lines) + "\n").encode()
    with open(paths["text"], "wb") as f:
        f.write(text)
    captured = []
    saved = sentiment.print_reports, sentiment.time
    # a fixed clock makes every decay factor exactly 1: counters are counts
    sentiment.time = types.SimpleNamespace(time=lambda: 1e9)
    sentiment.print_reports = captured.append
    reset(kernels)
    try:
        sentiment.run_library_mode(types.SimpleNamespace(
            patterns=paths["patterns"], input=paths["text"],
            chunk_size=CHUNK_LEN, global_ws=BATCH_LANES, interval=1e18,
            device=DEVICE))
    finally:
        sentiment.print_reports, sentiment.time = saved
    ana = captured[-1]
    words = [f" {w} ".encode() for w in neg + pos]
    off, pid, total = NativeOracle(words).match(text, cap=1 << 22)
    want = np.bincount(pid, minlength=len(words))
    got = np.zeros(len(words), np.int64)
    for pi, c in ana.freq[60].items():
        got[neg.index(ana.labels[pi]) if ana.iids[pi] < 0
            else 30 + pos.index(ana.labels[pi])] = c.get()
    if not np.array_equal(got, want) or ana.matches != total:
        fail(f"[sentiment] per-word counts differ from the oracle "
             f"({ana.matches} vs {total} matches)")
    launches = read_launches(kernels, "sentiment", ())
    if not launches["sampled"] + launches["strided"]:
        fail(f"[sentiment] no probe kernel was launched ({launches})")
    print(f"[sentiment] library mode over {len(text)} B of text: {total} "
          f"matches of {len(words)} words, per-word counts == native oracle "
          f"(launches {({k: v for k, v in launches.items() if v})}); phase "
          f"wall time {time.perf_counter() - t_phase:.2f} s ({card_line})",
          flush=True)


@contextlib.contextmanager
def keep_largest_union(bloom, store: dict):
    """Keep the inputs and total of the sharded probe of the batch with the
    largest union total. It syncs at every batch, so it wraps only
    untimed runs made after the timed ones."""
    probe = bloom.sharded_probe_bits

    def keep(data_tm, bounds, words, cfg):
        bits, total = probe(data_tm, bounds, words, cfg)
        n = int(total[0])
        if n > store.get("total", -1):
            store.update(total=n, args=(data_tm, bounds, words, cfg))
        return bits, total

    bloom.sharded_probe_bits = keep
    try:
        yield
    finally:
        bloom.sharded_probe_bits = probe


def check_union(torch, bloom, kernels, args, label, launches,
                card_line) -> dict:
    """The S launches into one bitmap against ``sharded_probe_bits_plain``
    on one batch, bit for bit, timed beside the bounds and one shard's
    launch; returns the summary's record (``fn`` and ``one_fn`` kept for
    the trace phase)."""
    data_tm, bp, words, cfg = args
    S = words.shape[0]
    union = functools.partial(bloom.or_shards, kernels.launch_probe, data_tm,
                              bp, words, cfg)
    plain = functools.partial(bloom.sharded_probe_bits_plain, data_tm, bp,
                              words, cfg)
    kb, kt = union()
    torch.cuda.synchronize()
    pb, pt = plain()
    torch.cuda.synchronize()
    err = max_abs_err(torch, (kb, kt), (pb, pt))
    if err or int(kt[0]) != int(pt[0]):
        fail(f"[pshard] {label}: the {S} OR-into-bitmap launches differ from "
             f"sharded_probe_bits_plain (max_abs_err {err}, totals "
             f"{int(kt[0])} vs {int(pt[0])})")
    fn_bound, launches_bound, one_bound = sharded_bound(
        torch, bloom, data_tm, bp, words, cfg)
    t, text = timed(torch, union, plain, 50, 2, err, card_line, fn_bound)
    one = functools.partial(kernels.launch_probe, data_tm, bp, words[0], cfg)
    one_total = int(one()[1][0])
    one_ms = event_ms(one, 50)
    mode = kernels.probe_mode(data_tm, cfg)
    t.update(one_fn=one, mode=mode, shards=S, label=label,
             launches=launches, config=cfg_name(cfg),
             shape=list(data_tm.shape),
             launches_bound_ms=launches_bound["bound_ms"],
             one_shard_bound_ms=one_bound["bound_ms"])
    print(f"[pshard] {label}: {S} x {mode} {cfg_name(cfg)} {data_tm.dtype} "
          f"{list(data_tm.shape)}, union bits and total equal "
          f"sharded_probe_bits_plain, tolerance 0 ({int(kt[0])} survivors; "
          f"shard 0 alone {one_total}); "
          f"{plan_text(kernels.probe_plan(data_tm, cfg))}{text}; the {S} "
          f"launches' bound {launches_bound['bound_ms']:.6f} ms; one "
          f"shard's launch {one_ms:.4f} ms by CUDA events (bound "
          f"{one_bound['bound_ms']:.6f} ms)", flush=True)
    return t


def phase_pshard(torch, bloom, kernels, MatchSession, workloads, ush, tmp,
                 card_line) -> dict:
    """Pattern shards on one device: the bench point's sessions and union
    check, the deployment point's union check, both CLIs, ``entry`` and
    the fuzz campaign on the card. Returns the sharded probes' records,
    keyed for the summary."""
    from tpu_pattern_matching_torch import entry
    from tpu_pattern_matching_torch.cli import main as cli_main
    from tpu_pattern_matching_torch.parallel.pshard import ShardedBloom
    from tpu_pattern_matching_torch.tools import fuzz_campaign

    t_phase = time.perf_counter()
    out = {}
    w = workloads[0]
    t0 = time.perf_counter()
    sb = ShardedBloom.from_table(w["table"], PSHARD_BENCH)
    build_s = time.perf_counter() - t0
    mode = "sampled" if sb.cfg.sampled else "strided"
    print(f"[pshard] bench workload in {PSHARD_BENCH} shards: "
          f"{cfg_name(sb.cfg)}, {sb.n_grams} grams, fp_est "
          f"{[round(f, 6) for f in sb.fp_est]}, build {build_s:.2f} s",
          flush=True)
    reset(kernels)
    sessions = []
    for verify in ("host", "device"):
        sess = session(MatchSession, w, bloom_table=sb, verify=verify)
        before = kernels.launches[mode]
        rate = timed_find(torch, sess, w, f"pshard {verify}")
        batches = -(-len(w["data"]) // (BATCH_LANES * CHUNK_LEN))
        print(f"[pshard] MatchSession(pat_shards={sess.pat_shards}, "
              f"verify={verify!r}): find over {len(w['data'])} B -> "
              f"{len(w['want'])} events == native oracle; {mode} launches "
              f"{kernels.launches[mode] - before} for the warm-up and about "
              f"{batches} batches; refine overflows {sess.refine_overflows};"
              f" {rate:.6g} B/s end to end (smoke number, {card_line})",
              flush=True)
        sessions.append(sess)
    needed = (mode, "window_walk")
    launches = read_launches(kernels, "pshard", needed)
    largest = {}
    with keep_largest_union(bloom, largest):
        sessions[0].find(w["data"])
    out[f"{mode}_pshard{PSHARD_BENCH}"] = check_union(
        torch, bloom, kernels, largest["args"],
        "the bench workload's batch of the largest union total",
        launches[mode], card_line)
    # the deployment point of benchmarks/bench_pshard.py, probe only
    n_pats, S = PSHARD_DEPLOY
    rng = np.random.RandomState(42)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(n_pats)]
    t0 = time.perf_counter()
    big = ShardedBloom.build(pats, S, objective="probe")
    build_s = time.perf_counter() - t0
    del pats
    halo = 16  # pad_halo(12 - 1, 4096)
    B = CHUNK_LEN + (-(halo + CHUNK_LEN)) % big.cfg.tile_rows
    drng = np.random.RandomState(7)
    dev = torch.device(DEVICE)
    data = torch.from_numpy(drng.randint(
        0, 256, size=(BATCH_LANES, halo + B)).astype(np.uint8)).to(dev)
    bounds = torch.from_numpy(np.stack([
        np.full(BATCH_LANES, halo, np.int32),
        np.full(BATCH_LANES, halo + B, np.int32)])).to(dev)
    dbig = big.put(dev)
    deploy = {}
    reset(kernels)
    with keep_largest_union(bloom, deploy):
        h = dbig.hits(data, bounds)
    big_mode = "sampled" if big.cfg.sampled else "strided"
    moved = read_launches(kernels, "pshard deploy", (big_mode,))[big_mode]
    if moved != S:
        fail(f"[pshard] the deployment point made {moved} launches, not {S}")
    print(f"[pshard] deployment point: {n_pats} random 12-byte patterns in "
          f"{S} shards (objective probe): {cfg_name(big.cfg)}, fp_est per "
          f"shard {big.fp_est[0]:.6g}, build {build_s:.2f} s on the card's "
          f"host; union total {int(h.meta[0])} on [{BATCH_LANES}, "
          f"{halo + B}]", flush=True)
    out[f"{big_mode}_pshard{S}"] = check_union(
        torch, bloom, kernels, deploy["args"],
        f"{n_pats // 1000}k patterns, a random batch", moved, card_line)
    # the ushort CLI with --pat-shards 2
    t0 = time.perf_counter()
    base = ["-f", ush["flow_dir"], "-p", ush["sig_path"], "--ushort", "-v",
            "-B", str(2 * U16_TOKENS), "-G", str(U16_LANES)]
    before = dict(kernels.launches)
    got, st = run_cli(cli_main, base + ["--pat-shards", "2"], USHORT_LINE)
    check_events("pshard ushort", got, ush["want"])
    moved = {k: v - before[k] for k, v in kernels.launches.items()
             if v != before[k]}
    print(f"[pshard] ushort CLI --pat-shards 2: {len(got)} events == native "
          f"oracle, {st['rounds']} batches, launches {moved}, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    # the byte CLI: --pat-shards 4 --save-bloom, then --load-bloom
    d = os.path.join(tmp, "bytes")
    dfa, dump = (os.path.join(tmp, "bench.dfa.npz"),
                 os.path.join(tmp, "pshard.bloom.npz"))
    want_total, n_inside = cli_oracle(w)
    for argv in (["--load-dfa", dfa, "--pat-shards", str(PSHARD_BENCH),
                  "--save-bloom", dump],
                 ["--load-dfa", dfa, "--load-bloom", dump]):
        t0 = time.perf_counter()
        _, st = run_cli(cli_main, ["-f", d, "-B", str(CHUNK_LEN), "-G",
                                   str(BATCH_LANES)] + argv)
        if (st["matches_total"], st["matches_reported"]) != (want_total,
                                                             n_inside):
            fail(f"[pshard] byte CLI {argv}: matches {st['matches_total']}/"
                 f"{st['matches_reported']}, oracle {want_total}/{n_inside}")
        print(f"[pshard] byte CLI {' '.join(os.path.basename(a) for a in argv)}"
              f": matches_total {st['matches_total']} == oracle, "
              f"{st['rounds']} batches, {time.perf_counter() - t0:.2f} s",
              flush=True)
    with np.load(dump) as z:
        if z["pshard_words"].shape[0] != PSHARD_BENCH:
            fail(f"[pshard] the dump holds {z['pshard_words'].shape[0]} "
                 f"shards")
    # entry.entry() on the card against the plain probe
    fn, args = entry.entry(DEVICE)
    total, bits = fn(*args)
    torch.cuda.synchronize()
    p_total, p_bits = fn(*(a.cpu() for a in args))
    if not torch.equal(bits.cpu(), p_bits) or int(total[0]) != int(
            p_total[0]):
        fail("[pshard] entry(): the kernel's forward differs from the plain "
             "version's")
    print(f"[pshard] entry.entry(): forward {tuple(bits.shape)} bits and "
          f"total {int(total[0])} equal the plain version's on the CPU",
          flush=True)
    # the fuzz campaign on the card, bounded in wall time
    t0 = time.perf_counter()
    arms: dict = {}
    trials = 0
    while trials < FUZZ_TRIALS and time.perf_counter() - t0 < FUZZ_SECONDS:
        for a in fuzz_campaign.run_trial(trials, 0, DEVICE)["arms"]:
            arms[a] = arms.get(a, 0) + 1
        trials += 1
    print(f"[pshard] fuzz campaign on the card: {trials} trials (seed 0) == "
          f"oracle in {time.perf_counter() - t0:.2f} s; arms {arms}",
          flush=True)
    if "pat_shards" not in arms:
        fail(f"[pshard] no fuzz trial ran the pat_shards arm ({arms})")
    print(f"[pshard] phase wall time {time.perf_counter() - t_phase:.2f} s "
          f"({card_line})", flush=True)
    return out


# ------------------------------------------------------------ mesh phases

MESH_DEVICE = "cuda:0"  # the mesh phases' device: every rank's
MESH2_RANKS = 2  # ranks of the mesh2 phase, all on MESH_DEVICE over gloo
MESH_TIMEOUT_S = 300  # a mesh2 rank past it is killed and the script fails
MESH_PATHS = (  # (label, session options); the probe kernel comes from the
    # workload's filter (sampled: the bench workload, strided: the other)
    ("host verify", {}),
    ("device verify", {"verify": "device"}),
    ("dense", {"engine": "dense"}),
)


def path_kernels(kw, w) -> tuple:
    """The launch-count keys a mesh path must move on workload ``w``."""
    if kw.get("engine") == "dense":
        return ("dense_walk",)
    probe = "sampled" if w["bloom_table"].cfg.sampled else "strided"
    return (probe, "window_walk") if kw.get("verify") == "device" else (
        probe,)


class CollectiveTimer:
    """Times the collectives of mesh contexts while it is installed: device
    ms by CUDA events on the current stream around each call (for NCCL,
    its kernel; for gloo with CUDA tensors, the copies and the wait for
    the host), and host ms of the calls. ``targets`` are ``(label, object,
    method name)``, every ``all_reduce`` of ``ctx`` by default; a call
    made inside another timed call counts in both labels."""

    def __init__(self, torch, ctx, targets=None):
        self.torch = torch
        self.targets = targets or [("all_reduce", ctx, "all_reduce")]
        self.pairs, self.host_s, self.originals = {}, {}, []
        for label, obj, name in self.targets:
            orig = getattr(obj, name)
            self.originals.append((obj, name, orig))
            setattr(obj, name, self._timed(label, orig))

    def _timed(self, label, orig):
        torch = self.torch

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            self.host_s[label] = (self.host_s.get(label, 0.0)
                                  + time.perf_counter() - t0)
            stop.record()
            self.pairs.setdefault(label, []).append((start, stop))
            return out

        return timed

    def close_labels(self) -> dict:
        """{label: (device ms, host ms, calls)} of the calls timed; the
        methods are restored."""
        for obj, name, orig in self.originals:
            if isinstance(obj, types.ModuleType):
                setattr(obj, name, orig)
            else:  # the instance attribute shadowed the method
                delattr(obj, name)
        self.torch.cuda.synchronize()
        return {label: (sum(a.elapsed_time(b) for a, b in pairs),
                        self.host_s[label] * 1e3, len(pairs))
                for label, pairs in self.pairs.items()}

    def close(self) -> tuple[float, float, int]:
        """(device ms, host ms, calls) of every collective timed."""
        got = self.close_labels().values()
        return (sum(g[0] for g in got), sum(g[1] for g in got),
                sum(g[2] for g in got))


def find_ms(torch, sess, w, label) -> float:
    """ms of one ``find`` of the workload (after a 1 MiB warm-up), whose
    events must equal the oracle's."""
    return len(w["data"]) / timed_find(torch, sess, w, label) * 1e3


def batch_events(bm) -> list:
    return sorted((e.lane, e.file_id, e.end_offset, e.gid,
                   tuple(e.pattern_indices)) for e in bm.events)


def phase_mesh1(torch, kernels, MatchSession, workloads, tmp,
                card_line) -> dict:
    """The data-parallel mesh at world 1: a 1-rank NCCL group in this
    process on cuda:0 (``parallel.mesh.world_context``), through
    ``MatchSession(mesh=...)`` on each path and both workloads (events
    equal the oracle's and, batch by batch with their totals, the flat
    session's; find ms beside the flat find's; the collectives' ms a
    batch), ``ShardedBloomCounter`` against the flat ``decode_counts`` on
    every bench batch, and the byte CLI with ``--mesh all`` on phase 8's
    16 files. Returns the launch counts of each path's mesh find."""
    import torch.distributed as dist

    from tpu_pattern_matching_torch.cli import main as cli_main
    from tpu_pattern_matching_torch.parallel.mesh import (
        ShardedBloomCounter,
        default_backend,
        world_context,
    )
    from tpu_pattern_matching_torch.runtime.buffers import StreamState

    t_phase = time.perf_counter()
    if dist.is_initialized():
        fail("[mesh1] a process group exists before the phase")
    ctx = world_context(MESH_DEVICE)
    if (ctx.world_size, ctx.device, ctx.backend) != (
            1, torch.device(MESH_DEVICE), default_backend(ctx.device)):
        fail(f"[mesh1] {ctx}")
    launches = {}
    try:
        for w in workloads:
            batches = -(-len(w["data"]) // (BATCH_LANES * CHUNK_LEN))
            for label, kw in MESH_PATHS:
                flat = session(MatchSession, w, bloom_table=w["bloom_table"],
                               **kw)
                sess = session(MatchSession, w, bloom_table=w["bloom_table"],
                               mesh=ctx, **kw)
                flat_ms = find_ms(torch, flat, w, "mesh1 flat")
                reset(kernels)
                mesh_ms = find_ms(torch, sess, w, "mesh1")
                got = read_launches(kernels, f"mesh1 {label}",
                                    path_kernels(kw, w))
                for k, n in got.items():
                    launches[k] = launches.get(k, 0) + n
                for i, (a, b) in enumerate(zip(
                        sess.scan_stream(io.BytesIO(w["data"])),
                        flat.scan_stream(io.BytesIO(w["data"])))):
                    if batch_events(a) != batch_events(b) or (
                            a.total, a.reported, a.overflowed) != (
                            b.total, b.reported, b.overflowed):
                        fail(f"[mesh1] {label}, {w['label']}, batch {i}: "
                             f"{a.total}/{a.reported} events, flat "
                             f"{b.total}/{b.reported}")
                timer = CollectiveTimer(torch, ctx)
                sess.find(w["data"])
                dev_ms, host_ms, calls = timer.close()
                print(f"[mesh1] {label}, {w['label']}: find over "
                      f"{len(w['data'])} B -> {len(w['want'])} events == "
                      f"native oracle, every batch's events and totals == "
                      f"the flat session's; find {mesh_ms:.4f} ms on the "
                      f"1-rank mesh, {flat_ms:.4f} ms flat; collectives "
                      f"{dev_ms / batches:.4f} ms a batch by CUDA events, "
                      f"{host_ms / batches:.4f} ms host ({calls} all_reduce "
                      f"over {batches} batches, {ctx.backend} world 1; "
                      f"{card_line})",
                      flush=True)
        w = workloads[0]
        mesh_b = session(MatchSession, w, bloom_table=w["bloom_table"],
                         mesh=ctx)
        flat_d = session(MatchSession, w, bloom_table=w["bloom_table"],
                         verify="device")
        counter = ShardedBloomCounter(
            ctx, mesh_b._bloom, w["table"], halo=mesh_b.halo,
            gram_keys=w["bloom_table"].gram_keys)
        buf = mesh_b.new_buffer()
        fobj, stream, n_b = io.BytesIO(w["data"]), StreamState(file_id=0), 0
        reset(kernels)
        while True:
            code, rd = buf.add_stream(fobj, stream)
            if buf.chunks and (code == -1 or rd == 0):
                batch = buf.to_batch()
                data = torch.from_numpy(batch.data).to(ctx.device)
                bounds = torch.from_numpy(np.stack(
                    [batch.start_t, batch.end_t])).to(ctx.device)
                gc, n_ev = counter.count(data, bounds)
                n_f, gc_f = flat_d.decode_counts(batch, flat_d.scan(batch))
                if n_ev != n_f or not np.array_equal(gc, gc_f):
                    fail(f"[mesh1] count step, batch {n_b}: {n_ev} events, "
                         f"flat decode_counts {n_f}")
                n_b += 1
                buf.reset()
            if rd == 0:
                break
        print(f"[mesh1] ShardedBloomCounter.count == flat decode_counts on "
              f"{n_b} bench batches; capacities k_cand {counter.k_cand} "
              f"k_ev {counter.k_ev} k_walk {counter.k_walk}", flush=True)
        d = os.path.join(tmp, "bytes")  # phase 8's 16 files and dumps
        want_total, n_inside = cli_oracle(w)
        reset(kernels)
        _, st = run_cli(cli_main, ["-f", d, "--load-dfa",
                                   os.path.join(tmp, "bench.dfa.npz"),
                                   "--load-bloom",
                                   os.path.join(tmp, "bench.bloom.npz"),
                                   "-B", str(CHUNK_LEN), "-G",
                                   str(BATCH_LANES), "--mesh", "all"])
        if (st["matches_total"], st["matches_reported"]) != (want_total,
                                                             n_inside):
            fail(f"[mesh1] cli --mesh all: matches {st['matches_total']}/"
                 f"{st['matches_reported']}, oracle {want_total}/{n_inside}")
        read_launches(kernels, "mesh1 cli", ("sampled",))
        print(f"[mesh1] byte CLI --mesh all over {CLI_FILES} files: "
              f"matches_total {st['matches_total']} == oracle", flush=True)
    finally:
        dist.destroy_process_group()
    print(f"[mesh1] phase wall time {time.perf_counter() - t_phase:.2f} s "
          f"({card_line})", flush=True)
    return launches


def mesh2_rank(rank: int, tmp: str) -> None:
    """One rank of phase mesh2 (``chip_smoke.py --mesh2-rank R DIR``): a
    gloo rank on cuda:0 that runs each path on its lanes of the global
    batch in ``DIR`` and the count step, reads its launch counts, and
    writes ``DIR/rank<R>.npz``."""
    import torch
    import torch.distributed as dist

    from tpu_pattern_matching_torch.core.dfa import DfaTable
    from tpu_pattern_matching_torch.ops import kernels
    from tpu_pattern_matching_torch.ops.bloom import BloomFilterTable
    from tpu_pattern_matching_torch.parallel import mesh
    from tpu_pattern_matching_torch.runtime.buffers import HostBatch
    from tpu_pattern_matching_torch.runtime.session import MatchSession

    mesh.init_distributed(f"file://{tmp}/rendezvous", MESH2_RANKS, rank,
                          backend="gloo", device=MESH_DEVICE)
    ctx = mesh.world_context(MESH_DEVICE)
    table = DfaTable.load(os.path.join(tmp, "table.npz"))
    bft = BloomFilterTable.load(os.path.join(tmp, "bloom.npz"))
    c_local = BATCH_LANES // MESH2_RANKS
    lanes = slice(rank * c_local, (rank + 1) * c_local)
    with np.load(os.path.join(tmp, "batch.npz")) as z:
        part = {k: np.ascontiguousarray(z[k][lanes]) for k in (
            "data", "start_t", "end_t", "file_ids", "base_off")}
        halo = int(z["halo"])
    batch = HostBatch(chunks=int((part["file_ids"] >= 0).sum()), halo=halo,
                      **part)
    out = {}
    for p, (label, kw) in enumerate(MESH_PATHS):
        sess = MatchSession(table, max_chunks=BATCH_LANES,
                            chunk_len=CHUNK_LEN, mesh=ctx, bloom_table=bft,
                            **kw)
        if sess.local_chunks != c_local:
            raise RuntimeError(f"{label}: {sess.local_chunks} lanes a rank")
        sess.decode(batch, sess.scan(batch))  # warm-up
        reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bm = sess.decode(batch, sess.scan(batch))
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3
        out[f"launches_{p}"] = np.array([kernels.launches[k] for k in (
            "sampled", "window_walk", "dense_walk")])
        n, gc = sess.decode_counts(batch, sess.scan(batch))
        timer = CollectiveTimer(torch, ctx)
        sess.decode(batch, sess.scan(batch))
        dev_ms, host_ms, calls = timer.close()
        out[f"events_{p}"] = np.array(
            [[e.lane + rank * c_local, e.file_id, e.end_offset, e.gid]
             for e in bm.events], np.int64).reshape(-1, 4)
        out[f"totals_{p}"] = np.array([bm.total, bm.reported, bm.overflowed])
        out[f"counts_{p}"] = np.concatenate([[n], gc])
        out[f"times_{p}"] = np.array([batch_ms, dev_ms, host_ms, calls])
    counter = mesh.ShardedBloomCounter(ctx, bft.put(ctx.device), table,
                                       halo=halo, gram_keys=bft.gram_keys)
    data = torch.from_numpy(batch.data).to(ctx.device)
    bounds = torch.from_numpy(np.stack([batch.start_t, batch.end_t])).to(
        ctx.device)
    gc, n_ev = counter.count(data, bounds)
    out["count"] = np.concatenate([[n_ev], gc])
    imported = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "tpu_pattern_matching")]
    if imported:
        raise RuntimeError(f"imported {imported}")
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def phase_mesh2(torch, MatchSession, workloads, tmp, card_line) -> dict:
    """Two gloo ranks on cuda:0 (spawned ``chip_smoke.py --mesh2-rank``),
    each on 2048 lanes of the bench point's first global batch (4096
    lanes x 4112): per path, the union of the ranks' events and their
    totals and counts equal the flat session's on the same batch in this
    process, the count step equals the flat ``decode_counts``, and each
    rank's launch counts show the path's kernels. Returns the ranks'
    launch counts."""
    import subprocess

    from tpu_pattern_matching_torch.runtime.buffers import DataBuffer
    from tpu_pattern_matching_torch.runtime.buffers import StreamState

    t_phase = time.perf_counter()
    w = workloads[0]
    d = os.path.join(tmp, "mesh2")
    os.makedirs(d)
    w["table"].save(os.path.join(d, "table.npz"))
    w["bloom_table"].save(os.path.join(d, "bloom.npz"))
    buf = DataBuffer(BATCH_LANES, CHUNK_LEN, HALO)
    buf.add_stream(io.BytesIO(w["data"]), StreamState(file_id=0))
    batch = buf.to_batch()
    np.savez(os.path.join(d, "batch.npz"), data=batch.data,
             start_t=batch.start_t, end_t=batch.end_t,
             file_ids=batch.file_ids, base_off=batch.base_off,
             halo=batch.halo)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh2-rank", str(r),
         d], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=HERE) for r in range(MESH2_RANKS)]
    try:
        flat = []  # the flat sessions' results on the same global batch
        for label, kw in MESH_PATHS:
            sess = session(MatchSession, w, bloom_table=w["bloom_table"],
                           **kw)
            bm = sess.decode(batch, sess.scan(batch))
            n, gc = sess.decode_counts(batch, sess.scan(batch))
            flat.append((sorted((e.lane, e.file_id, e.end_offset, e.gid)
                                for e in bm.events),
                         (bm.total, bm.reported, bm.overflowed),
                         np.concatenate([[n], gc])))
        logs = []
        for r, p in enumerate(procs):
            try:
                logs.append(p.communicate(timeout=MESH_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                fail(f"[mesh2] rank {r} did not finish in {MESH_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode:
            fail(f"[mesh2] rank {r} exited {p.returncode}:\n{log[-3000:]}")
    ranks = []
    for r in range(MESH2_RANKS):
        with np.load(os.path.join(d, f"rank{r}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
    launches = {f"rank{r}": {} for r in range(MESH2_RANKS)}
    for p, (label, kw) in enumerate(MESH_PATHS):
        want, (total, reported, over), counts = flat[p]
        got = sorted(tuple(int(x) for x in e) for o in ranks
                     for e in o[f"events_{p}"])
        if got != want:
            fail(f"[mesh2] {label}: {len(got)} events from the ranks, flat "
                 f"{len(want)}")
        totals = [o[f"totals_{p}"] for o in ranks]
        rank_counts = [o[f"counts_{p}"] for o in ranks]
        if kw:  # dense and device verify: global totals on every rank
            ok = all(tuple(t) == (total, t[1], over) for t in totals) and all(
                np.array_equal(c, counts) for c in rank_counts)
        else:  # host verify: each rank's own; their sums
            ok = sum(t[0] for t in totals) == total and np.array_equal(
                sum(rank_counts), counts)
        if not ok or sum(t[1] for t in totals) != reported:
            fail(f"[mesh2] {label}: totals {totals}, counts differ from the "
                 f"flat session's ({total}, {reported}, {over})")
        needed = path_kernels(kw, w)
        path_launches = []
        for r, o in enumerate(ranks):
            n = dict(zip(("sampled", "window_walk", "dense_walk"),
                         (int(x) for x in o[f"launches_{p}"])))
            if any(not n[k] for k in needed):
                fail(f"[mesh2] rank {r} {label}: kernels of the path were "
                     f"never launched ({n})")
            path_launches.append({k: n[k] for k in needed})
            for k in needed:
                launches[f"rank{r}"][k] = launches[f"rank{r}"].get(k, 0) + n[k]
        t = np.array([o[f"times_{p}"] for o in ranks])
        print(f"[mesh2] {label}: {len(got)} events (union of "
              f"{MESH2_RANKS} ranks) == the flat session's on the same "
              f"{BATCH_LANES}-lane batch, totals and counts equal; launches "
              f"per rank {path_launches}"
              f"; scan + decode {', '.join(f'{x:.4f}' for x in t[:, 0])} ms "
              f"a batch per rank; collectives "
              f"{', '.join(f'{x:.4f}' for x in t[:, 1])} ms a batch by CUDA "
              f"events, {', '.join(f'{x:.4f}' for x in t[:, 2])} ms host "
              f"({int(t[0, 3])} all_reduce a batch, gloo, 2 ranks on cuda:0; "
              f"{card_line})", flush=True)
    counts = flat[1][2]  # the flat device-verify decode_counts
    for r, o in enumerate(ranks):
        if not np.array_equal(o["count"], counts):
            fail(f"[mesh2] rank {r}: count step {o['count'][0]} events, "
                 f"flat decode_counts {counts[0]}")
    print(f"[mesh2] ShardedBloomCounter.count == flat decode_counts "
          f"({int(counts[0])} events) on every rank; phase wall time "
          f"{time.perf_counter() - t_phase:.2f} s ({card_line})", flush=True)
    return launches


# --------------------------------------------------------------- grid phase

GRID2_RANKS = 2  # phase grid2: 2 gloo ranks on MESH_DEVICE, S = 2, D = 1
GRID_SHARDS = 2
# benchmarks/bench_pshard.py's point (:73-85): 300,000 random 12-byte
# patterns (RandomState 42), here in the grid's 2 shards, probe only
GRID_DEPLOY = 300_000
GRID_TIMED = ("broadcast", "all_gather", "all_reduce", "row gather")


def host_batches(sess, data: bytes):
    """The batches ``sess.scan_stream`` would scan, one at a time (each is
    the buffer's own arrays: use it before asking for the next)."""
    from tpu_pattern_matching_torch.runtime.buffers import StreamState

    buf, fobj, stream = sess.new_buffer(), io.BytesIO(data), StreamState(0)
    while True:
        code, rd = buf.add_stream(fobj, stream)
        eof = rd == 0 and code != -1
        if eof:
            buf.finalize_stream(stream)
        if buf.chunks and (code == -1 or eof):
            yield buf.to_batch()
            buf.reset()
        if eof:
            return


def grid_events(bm) -> list:
    return sorted((e.lane, e.file_id, e.end_offset, e.gid,
                   *(int(p) for p in e.pattern_indices)) for e in bm.events)


def grid_timer(torch, grid, pshard):
    """A ``CollectiveTimer`` of the grid's collectives: the column's
    broadcast (the batch) and ``all_gather`` (bitmaps, and the event rows'
    lengths and rows), every ``all_reduce`` (column, row, world), and the
    row gather to the leader (``gather_varlen`` in ``verify_rows``)."""
    return CollectiveTimer(torch, None, [
        ("broadcast", grid.col, "broadcast"),
        ("all_gather", grid.col, "all_gather"),
        ("all_reduce", grid.col, "all_reduce"),
        ("all_reduce", grid.row, "all_reduce"),
        ("all_reduce", grid.world, "all_reduce"),
        ("row gather", pshard, "gather_varlen")])


def grid2_rank(rank: int, tmp: str) -> None:
    """One rank of phase grid2 (``chip_smoke.py --grid2-rank R DIR``): a
    gloo rank on cuda:0 in the grid of 2 shards and 1 column. Runs the
    bench point's 64 MiB through host and device verify (timed finds,
    then per batch ``decode`` and ``decode_counts``) and the count step,
    and the 300k point's probe step; reads its launch counts and times
    the collectives; writes ``DIR/rank<R>.npz``."""
    import torch
    import torch.distributed as dist

    from tpu_pattern_matching_torch.core.dfa import DfaTable
    from tpu_pattern_matching_torch.ops import kernels
    from tpu_pattern_matching_torch.parallel import mesh, pshard
    from tpu_pattern_matching_torch.runtime.session import MatchSession

    mesh.init_distributed(f"file://{tmp}/rendezvous", GRID2_RANKS, rank,
                          backend="gloo", device=MESH_DEVICE)
    grid = pshard.Mesh2DContext.build(mesh.world_context(MESH_DEVICE),
                                      GRID_SHARDS)
    table = DfaTable.load(os.path.join(tmp, "table.npz"))
    sb = pshard.ShardedBloom.load(os.path.join(tmp, "sharded.npz"))
    with open(os.path.join(tmp, "data.bin"), "rb") as f:
        data = f.read()
    probe = "sampled" if sb.cfg.sampled else "strided"
    out = {}
    for p, verify in enumerate(("host", "device")):
        sess = MatchSession(table, max_chunks=BATCH_LANES,
                            chunk_len=CHUNK_LEN, mesh=grid, bloom_table=sb,
                            verify=verify)
        if sess.local_chunks != BATCH_LANES:
            raise RuntimeError(f"{verify}: {sess.local_chunks} lanes")
        sess.find(data[: 1 << 20])  # warm-up
        reset(kernels)
        timer = grid_timer(torch, grid, pshard)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        found = sess.find(data)
        torch.cuda.synchronize()
        find_ms = (time.perf_counter() - t0) * 1e3
        times = timer.close_labels()
        out[f"launches_{p}"] = np.array(
            [kernels.launches[k] for k in (probe, "window_walk")])
        out[f"find_{p}"] = np.array(found, np.int64).reshape(-1, 2)
        out[f"find_ms_{p}"] = np.array(find_ms)
        out[f"times_{p}"] = np.array([times.get(k, (0.0, 0.0, 0))
                                      for k in GRID_TIMED])
        for i, batch in enumerate(host_batches(sess, data)):
            bm = sess.decode(batch, sess.scan(batch))
            n, gc = sess.decode_counts(batch, sess.scan(batch))
            out[f"events_{p}_{i}"] = np.array(json.dumps(grid_events(bm)))
            out[f"totals_{p}_{i}"] = np.array([bm.total, bm.reported,
                                               bm.overflowed])
            out[f"counts_{p}_{i}"] = np.concatenate([[n], gc])
            out["batches"] = np.array(i + 1)
    # the count step, batch by batch, against this rank's shard table
    s = grid.pat_index
    bloom = sb.put_shard(s, grid.world.device)
    tab = pshard.shard_table(table, sb.parts[s])
    step = pshard.make_pattern_sharded_count_step(
        grid, bloom, tab, halo=sess.halo,
        shard_gram_keys=sb.shard_gram_keys)
    flat, gids = (torch.from_numpy(np.ascontiguousarray(a)).to(
        grid.world.device) for a in (tab.goto_signed.reshape(-1),
                                     tab.state_gid.astype(np.int32)))
    gcounts = None
    reset(kernels)
    for batch in host_batches(sess, data):
        d = torch.from_numpy(batch.data).to(grid.world.device)
        b = torch.from_numpy(np.stack([batch.start_t, batch.end_t])).to(
            grid.world.device)
        gc, _n_ev, flags = step(bloom.words, flat, gids, d, b)
        if flags.any():
            raise RuntimeError(f"count step flags {flags.tolist()}")
        gcounts = gc if gcounts is None else gcounts + gc
    out["count_launches"] = np.array(
        [kernels.launches[k] for k in (probe, "window_walk")])
    out["gcounts"] = gcounts.cpu().numpy()
    # the 300k point: the probe step on one random batch
    big = pshard.ShardedBloom.load(os.path.join(tmp, "big.npz"))
    with np.load(os.path.join(tmp, "big_batch.npz")) as z:
        d, b = (torch.from_numpy(z[k]).to(grid.world.device)
                for k in ("data", "bounds"))
    bbig = big.put_shard(s, grid.world.device)
    bstep = pshard.make_pattern_sharded_bloom_step(grid, bbig)
    big_probe = "sampled" if big.cfg.sampled else "strided"
    bstep(bbig.words, d, b)  # warm-up
    reset(kernels)
    meta, union = bstep(bbig.words, d, b)
    out["big_launches"] = np.array(kernels.launches[big_probe])
    out["big_meta"], out["big_union"] = meta.cpu().numpy(), union.cpu().numpy()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        bstep(bbig.words, d, b)
    stop.record()
    torch.cuda.synchronize()
    out["big_ms"] = np.array(start.elapsed_time(stop) / 10)
    imported = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "tpu_pattern_matching")]
    if imported:
        raise RuntimeError(f"imported {imported}")
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def phase_grid2(torch, MatchSession, workloads, tmp, card_line) -> dict:
    """The ("pat", "data") grid on one card: two gloo ranks on cuda:0
    (spawned ``chip_smoke.py --grid2-rank``), S = 2 shards of one column
    of the full 4096 lanes. The leader's events (``find``, and batch by
    batch with totals and counts) equal the flat ``pat_shards=2`` session's
    in this process and the oracle's; the follower returns none, its
    totals 0 (host verify) or the global ones (device verify); the count
    step's ``global_pattern_counts`` equal the oracle's per-pattern
    counts; the 300k point's union bitmap equals the flat
    ``sharded_hits`` of the same shards, bit for bit; each rank's launch
    counts show K1/K2 once a batch and W2 per dispatch. Prints the
    collectives' ms a batch. Returns the ranks' launch counts."""
    import subprocess

    from tpu_pattern_matching_torch.parallel.pshard import (
        ShardedBloom,
        global_pattern_counts,
        shard_table,
        sharded_hits,
    )

    t_phase = time.perf_counter()
    w = workloads[0]
    d = os.path.join(tmp, "grid2")
    os.makedirs(d)
    t0 = time.perf_counter()
    sb = ShardedBloom.from_table(w["table"], GRID_SHARDS)
    build_s = time.perf_counter() - t0
    sb.save(os.path.join(d, "sharded.npz"))
    w["table"].save(os.path.join(d, "table.npz"))
    with open(os.path.join(d, "data.bin"), "wb") as f:
        f.write(w["data"])
    rng = np.random.RandomState(42)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(GRID_DEPLOY)]
    t0 = time.perf_counter()
    big = ShardedBloom.build(pats, GRID_SHARDS, objective="probe")
    big_s = time.perf_counter() - t0
    del pats
    big.save(os.path.join(d, "big.npz"))
    halo = 16  # pad_halo(12 - 1, 4096)
    B = CHUNK_LEN + (-(halo + CHUNK_LEN)) % big.cfg.tile_rows
    drng = np.random.RandomState(7)
    big_data = drng.randint(0, 256, size=(BATCH_LANES, halo + B)).astype(
        np.uint8)
    big_bounds = np.stack([np.full(BATCH_LANES, halo, np.int32),
                           np.full(BATCH_LANES, halo + B, np.int32)])
    np.savez(os.path.join(d, "big_batch.npz"), data=big_data,
             bounds=big_bounds)
    print(f"[grid2] bench workload in {GRID_SHARDS} shards: "
          f"{cfg_name(sb.cfg)}, build {build_s:.2f} s; {GRID_DEPLOY} "
          f"patterns in {GRID_SHARDS} shards (objective probe): "
          f"{cfg_name(big.cfg)}, build {big_s:.2f} s on the card's host",
          flush=True)
    # the flat pat_shards=2 sessions' finds, timed before the ranks start
    flat_sessions = [session(MatchSession, w, bloom_table=sb, verify=v)
                     for v in ("host", "device")]
    flat_ms = [find_ms(torch, f, w, "grid2 flat") for f in flat_sessions]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--grid2-rank", str(r),
         d], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=HERE) for r in range(GRID2_RANKS)]
    try:
        flat = []  # the flat pat_shards=2 sessions on the same batches
        for sess in flat_sessions:
            per = []
            for batch in host_batches(sess, w["data"]):
                bm = sess.decode(batch, sess.scan(batch))
                n, gc = sess.decode_counts(batch, sess.scan(batch))
                per.append((grid_events(bm), (bm.total, bm.reported,
                                              bm.overflowed),
                            np.concatenate([[n], gc])))
            flat.append(per)
        tabs = [shard_table(w["table"], part) for part in sb.parts]
        dev = torch.device(MESH_DEVICE)
        bd, bb = (torch.from_numpy(a).to(dev) for a in (big_data,
                                                        big_bounds))
        want_union = sharded_hits(bd, bb, torch.from_numpy(big.words).to(
            dev), big.cfg)
        logs = []
        for r, p in enumerate(procs):
            try:
                logs.append(p.communicate(timeout=MESH_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                fail(f"[grid2] rank {r} did not finish in {MESH_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode:
            fail(f"[grid2] rank {r} exited {p.returncode}:\n{log[-3000:]}")
    ranks = []
    for r in range(GRID2_RANKS):
        with np.load(os.path.join(d, f"rank{r}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
    batches = int(ranks[0]["batches"])
    if batches != len(flat[0]):
        fail(f"[grid2] {batches} batches, flat {len(flat[0])}")
    probe = "sampled" if sb.cfg.sampled else "strided"
    launches = {f"rank{r}": {} for r in range(GRID2_RANKS)}
    want = np.array(w["want"], np.int64).reshape(-1, 2)
    for p, verify in enumerate(("host", "device")):
        for r, o in enumerate(ranks):
            if not np.array_equal(o[f"find_{p}"], want if r == 0 else
                                  want[:0]):
                fail(f"[grid2] {verify} verify: rank {r}'s find gave "
                     f"{len(o[f'find_{p}'])} events, oracle {len(want)}")
        for i, (events, (total, reported, over), counts) in enumerate(
                flat[p]):
            lead, fol = (json.loads(str(o[f"events_{p}_{i}"]))
                         for o in ranks)
            if lead != [list(e) for e in events] or fol:
                fail(f"[grid2] {verify} verify, batch {i}: leader "
                     f"{len(lead)} events, follower {len(fol)}, flat "
                     f"{len(events)}")
            t_lead, t_fol = (tuple(o[f"totals_{p}_{i}"]) for o in ranks)
            c_lead, c_fol = (o[f"counts_{p}_{i}"] for o in ranks)
            follower = ((total, 0, 0), counts) if verify == "device" else (
                (0, 0, 0), np.zeros_like(counts))
            if (t_lead != (total, reported, over)
                    or not np.array_equal(c_lead, counts)
                    or t_fol != follower[0]
                    or not np.array_equal(c_fol, follower[1])):
                fail(f"[grid2] {verify} verify, batch {i}: totals "
                     f"{t_lead}/{t_fol}, flat {(total, reported, over)}")
        path_launches = []
        for r, o in enumerate(ranks):
            n = dict(zip((probe, "window_walk"),
                         (int(x) for x in o[f"launches_{p}"])))
            needed = (probe, "window_walk") if verify == "device" else (
                probe,)
            if n[probe] != batches or any(not n[k] for k in needed):
                fail(f"[grid2] rank {r} {verify} verify: launches {n} over "
                     f"{batches} batches")
            path_launches.append({k: n[k] for k in needed})
            for k in needed:
                launches[f"rank{r}"][k] = launches[f"rank{r}"].get(k, 0) + n[k]
        t = np.array([o[f"times_{p}"] for o in ranks])  # [rank, op, 3]
        ops = "; ".join(
            f"{op} {', '.join(f'{x:.4f}' for x in t[:, j, 0] / batches)} "
            f"ms by CUDA events, {', '.join(f'{x:.4f}' for x in t[:, j, 1] / batches)}"
            f" host ({int(t[0, j, 2])} calls)"
            for j, op in enumerate(GRID_TIMED))
        print(f"[grid2] {verify} verify: find over {len(w['data'])} B -> "
              f"{len(want)} events == native oracle on the leader, none on "
              f"the follower; every batch's events, totals and counts == "
              f"the flat pat_shards={GRID_SHARDS} session's; find "
              f"{', '.join(f'{float(o[f'find_ms_{p}']):.4f}' for o in ranks)}"
              f" ms per rank (the flat session's {flat_ms[p]:.4f} ms); "
              f"launches per rank {path_launches}; a batch "
              f"(of {batches}): {ops} (gloo, {GRID2_RANKS} ranks on cuda:0; "
              f"{card_line})", flush=True)
    want_pc = np.zeros(len(w["pats"]), np.int64)
    for _off, pid in w["want"]:
        want_pc[pid] += 1
    for r, o in enumerate(ranks):
        pc = global_pattern_counts(sb, tabs, o["gcounts"])
        n = dict(zip((probe, "window_walk"),
                     (int(x) for x in o["count_launches"])))
        if not np.array_equal(pc, want_pc) or n[probe] != batches or not n[
                "window_walk"]:
            fail(f"[grid2] rank {r}: count step {int(pc.sum())} pattern "
                 f"events, oracle {int(want_pc.sum())}; launches {n}")
        for k, v in n.items():
            launches[f"rank{r}"][k] += v
    print(f"[grid2] count step: global_pattern_counts == the oracle's "
          f"per-pattern counts ({int(want_pc.sum())}) on every rank",
          flush=True)
    big_probe = "sampled" if big.cfg.sampled else "strided"
    w_total, w_bits = want_union
    for r, o in enumerate(ranks):
        if (not np.array_equal(o["big_union"], w_bits.cpu().numpy())
                or int(o["big_meta"][0]) != int(w_total[0])
                or int(o["big_launches"]) != 1):
            fail(f"[grid2] rank {r}: the {GRID_DEPLOY} point's union "
                 f"({int(o['big_meta'][0])}) differs from sharded_hits "
                 f"({int(w_total[0])}) or made {int(o['big_launches'])} "
                 f"launches")
        launches[f"rank{r}"][big_probe] = launches[f"rank{r}"].get(
            big_probe, 0) + int(o["big_launches"])
    print(f"[grid2] {GRID_DEPLOY} patterns in {GRID_SHARDS} shards: each "
          f"rank's union bitmap and total ({int(w_total[0])}) == flat "
          f"sharded_hits, bit for bit; probe step (1 {big_probe} launch, "
          f"gather, OR, 2 all_reduce) "
          f"{', '.join(f'{float(o['big_ms']):.4f}' for o in ranks)} ms a "
          f"batch per rank by CUDA events; phase wall time "
          f"{time.perf_counter() - t_phase:.2f} s ({card_line})", flush=True)
    return launches


COST_FIELDS = ("probe_ns_per_unit", "refine_ns_per_slot",
               "refine_fixed_ns_per_byte", "verify_ns_per_cand",
               "probe_ns_per_unit_u2048", "verify_ns_per_cand_u2048")


@contextlib.contextmanager
def cost_constants(path: str):
    """The chooser prices with the constants file ``path`` inside the
    block; the pin to the defaults comes back after it."""
    os.environ[COST_ENV] = path
    try:
        yield
    finally:
        os.environ[COST_ENV] = COST_PIN


def file_stamp(path: str):
    return (os.stat(path).st_mtime_ns, os.stat(path).st_size) if (
        os.path.exists(path)) else None


def probe_key(cfg, ushort: bool) -> str:
    """The launch-count key of a filter's probe kernel."""
    return ("sampled" if cfg.sampled else "strided") + ("_u16" if ushort
                                                        else "")


def phase_calibrate(torch, bloom, kernels, MatchSession, workloads, ush, tmp,
                    card_line) -> tuple[dict, dict, dict]:
    """The chooser's calibrator (``ops.costmodel.run_calibration``, then
    the constants saved as ``calibrate`` saves them) at the reference's
    full shapes on the card, into a temporary file: the
    constants beside the v5e defaults, the picks, the timed calls; the
    file loads, every constant is positive and finite, and the user's
    cache file is untouched. The probes of both points are held to the
    plain probe on the calibration's batches. Then the bench workload's
    and the ushort CLI's filters are built again under the calibrated
    constants; a pick that differs runs its workload against the oracle,
    and both picks' probes are timed (traced in the trace phase). Returns
    (launches, the calls to trace, the summary's record)."""
    from tpu_pattern_matching_torch.ops import costmodel

    t_phase = time.perf_counter()
    cache = file_stamp(costmodel.DEFAULT_PATH)
    path = os.path.join(tmp, "cost_constants.json")
    reset(kernels)
    run = costmodel.run_calibration(device=DEVICE)  # calibrate() = run + save
    cc = run.constants
    cc.save(path)
    byte, ushort = run.points
    launches = read_launches(kernels, "calibrate", (
        probe_key(byte.bft.cfg, False), probe_key(ushort.bft.cfg, True)))
    loaded = costmodel.CostConstants.load(path)
    bad = [f for f in COST_FIELDS
           if not (getattr(loaded, f) > 0 and np.isfinite(getattr(loaded, f)))]
    if loaded != cc or bad or not loaded.source.startswith(
            "calibrated:cuda:"):
        fail(f"[calibrate] the file holds {loaded} (returned {cc}); not "
             f"positive and finite: {bad}")
    if file_stamp(costmodel.DEFAULT_PATH) != cache:
        fail(f"[calibrate] the user cache {costmodel.DEFAULT_PATH} changed")
    cal_s = run.seconds
    default = costmodel.CostConstants()
    for f in COST_FIELDS:  # a None ushort default prices with the byte one
        dv = getattr(default, f) or getattr(default, f.replace("_u2048", ""))
        print(f"[calibrate] {f:26s} {getattr(cc, f):.6g} calibrated, {dv} "
              f"v5e default ({card_line})", flush=True)
    m = run.measurement
    record = dict(constants=dataclasses.asdict(cc), seconds=cal_s,
                  n_cand=m.n_cand, u_n_cand=m.u_n_cand, picks={})
    print(f"[calibrate] source {cc.source!r}; byte point "
          f"{cfg_name(byte.bft.cfg)} ({byte.units} units) on "
          f"[{byte.data.shape[0]}, {byte.data.shape[1]}] uint8, n_cand "
          f"{m.n_cand}; ushort point {cfg_name(ushort.bft.cfg)} "
          f"({ushort.units} units) on [{ushort.data.shape[0]}, "
          f"{ushort.data.shape[1]}] uint16, u_n_cand {m.u_n_cand}; "
          f"host verify {m.verify_s * 1e3:.4f}, {m.u_verify_s * 1e3:.4f} ms",
          flush=True)
    traces = {}
    for label, c in run.calls.items():
        key = probe_key(c["cfg"], c["ushort"])
        traces[f"calibrate {label}"] = dict(fn=c["fn"], key=key,
                                            event_ms=c["s"] * 1e3)
        print(f"[calibrate] {label:15s} {c['s'] * 1e3:.4f} ms per call by "
              f"CUDA events (best of 4 rounds of 20 calls), probe "
              f"{key} {cfg_name(c['cfg'])} ({card_line})", flush=True)
    print(f"[calibrate] calibrate() wall time {cal_s:.2f} s", flush=True)
    # the kernels of both points against the plain probe on its batches
    uploaded = {}
    for point, ushort_point in ((byte, False), (ushort, True)):
        cfg = point.bft.cfg
        data = torch.from_numpy(point.data).to(DEVICE)
        bounds = torch.from_numpy(np.stack([point.start, point.end])).to(
            DEVICE)
        uploaded[ushort_point] = (data, bounds)
        data_tm, Cp = bloom.prep_time_major(data, cfg)
        bp = bloom.pad_bounds(bounds, Cp)
        words = point.bft.put(DEVICE).words
        got = kernels.launch_probe(data_tm, bp, words, cfg)
        want = bloom.probe_bits_plain(data_tm, bp, words, cfg)
        err = max_abs_err(torch, got, want)
        if err:
            fail(f"[calibrate] {cfg_name(cfg)} differs from the plain probe "
                 f"on the calibration's batch (max_abs_err {err})")
    print("[calibrate] both points' probe kernels == plain probe on the "
          "calibration's batches, bit for bit", flush=True)
    # the filters of the bench workload and the ushort CLI, built again
    # under the calibrated constants
    from tpu_pattern_matching_torch.ops.bloom import BloomFilterTable

    for label, w, ushort_point in (
            ("bench workload", workloads[0], False),
            ("ushort CLI set", ush, True)):
        t0 = time.perf_counter()
        picks = [BloomFilterTable.from_table(w["table"])]
        with cost_constants(path):
            picks.append(BloomFilterTable.from_table(w["table"]))
        names = [cfg_name(b.cfg) for b in picks]
        record["picks"][label] = names
        print(f"[calibrate] {label}: default pick {names[0]}, calibrated "
              f"pick {names[1]} (both built in "
              f"{time.perf_counter() - t0:.2f} s)", flush=True)
        if names[0] == names[1]:
            continue
        if ushort_point:
            sess = MatchSession(ush["table"], max_chunks=U16_LANES,
                                chunk_len=U16_TOKENS, device=DEVICE,
                                engine="bloom", bloom_table=picks[1])
            got = set()
            for name in sorted(os.listdir(ush["flow_dir"])):
                path = os.path.join(ush["flow_dir"], name)
                with open(path, "rb") as f:
                    for e, p in sess.find(f.read()):
                        got.add((path, e - len(ush["sigs"][p]) + 1, p))
            check_events("calibrate ushort", got, ush["want"])
            print(f"[calibrate] {label}, calibrated pick: {len(got)} events "
                  f"== native oracle", flush=True)
        else:
            rates = [timed_find(torch, session(MatchSession, w,
                                               bloom_table=picks[i]), w,
                                "calibrate")
                     for i in (0, 1, 1, 0)]
            print(f"[calibrate] {label}, 1e-3 planted: find over "
                  f"{len(w['data'])} B == native oracle with either pick; "
                  f"{rates[0]:.6g}, {rates[3]:.6g} B/s default, "
                  f"{rates[1]:.6g}, {rates[2]:.6g} B/s calibrated (A, B, "
                  f"B, A; smoke numbers, {card_line})", flush=True)
        data, bounds = uploaded[ushort_point]
        for which, b in zip(("default", "calibrated"), picks):
            words = b.put(DEVICE).words
            traces[f"{label} {which} pick"] = dict(
                fn=functools.partial(bloom.hits, data, bounds, words, b.cfg),
                key=probe_key(b.cfg, ushort_point),
                event_ms=event_ms(functools.partial(
                    bloom.hits, data, bounds, words, b.cfg), 20))
    record["seconds_phase"] = time.perf_counter() - t_phase
    print(f"[calibrate] phase wall time {record['seconds_phase']:.2f} s "
          f"({card_line})", flush=True)
    return launches, traces, record


def main() -> None:
    import torch

    if len(sys.argv) == 4 and sys.argv[1] == "--mesh2-rank":
        return mesh2_rank(int(sys.argv[2]), sys.argv[3])
    if len(sys.argv) == 4 and sys.argv[1] == "--grid2-rank":
        return grid2_rank(int(sys.argv[2]), sys.argv[3])
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    import tpu_pattern_matching_torch
    from tpu_pattern_matching_torch.ops import bloom, kernels
    from tpu_pattern_matching_torch.runtime.session import MatchSession

    if not tpu_pattern_matching_torch.__file__.startswith(HERE):
        fail(f"imported the port from {tpu_pattern_matching_torch.__file__}")
    card_line = card()
    phase_build(kernels, card_line)
    times = phase_probes(torch, bloom, kernels, card_line)
    times.update(phase_probes_u16(torch, bloom, kernels, card_line))
    phase_probe_edges(torch, bloom, kernels, card_line)
    workloads = make_workloads()
    times.update(phase_dense_walk(torch, kernels, workloads, card_line))
    probe_inputs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke.") as tmp:
        ush = make_ushort_workload(tmp)
        times.update(phase_dense_walk_u16(torch, kernels, ush, card_line))
        launches = phase_slice(torch, kernels, MatchSession, workloads,
                               probe_inputs, card_line)
        packed_launches, ab_fns = phase_packed(torch, bloom, kernels,
                                               card_line)
        launches["strided_packed"] = packed_launches["strided_packed"]
        verify_launches, walks, dispatch_sessions = phase_verify(
            torch, kernels, MatchSession, workloads, card_line)
        launches["window_walk"] = verify_launches["window_walk"]
        times.update(phase_window_walk(torch, kernels, walks,
                                       "bench workload", card_line,
                                       workloads[0]["pats"]))
        launches["dense_walk"] = phase_dense(
            torch, kernels, MatchSession, workloads, card_line)["dense_walk"]
        u16_launches, u16_walks = phase_ushort(torch, kernels, ush,
                                               probe_inputs, card_line)
        for key in ("sampled_u16", "strided_u16", "window_walk_u16",
                    "dense_walk_u16"):
            launches[key] = u16_launches[key]
        times.update(phase_window_walk(torch, kernels, u16_walks, "ushort",
                                       card_line))
        main_times = phase_main_probes(torch, bloom, kernels, probe_inputs,
                                       card_line)
        phase_cli(torch, kernels, workloads, tmp, card_line)
        phase_sentiment(torch, kernels, tmp, card_line)
        shards = phase_pshard(torch, bloom, kernels, MatchSession, workloads,
                              ush, tmp, card_line)
        mesh_launches = {"mesh1": phase_mesh1(torch, kernels, MatchSession,
                                              workloads, tmp, card_line)}
        for rank, got in phase_mesh2(torch, MatchSession, workloads, tmp,
                                     card_line).items():
            mesh_launches[f"mesh2_{rank}"] = got
        grid_launches = phase_grid2(torch, MatchSession, workloads, tmp,
                                    card_line)
        for rank, got in grid_launches.items():
            mesh_launches[f"grid2_{rank}"] = got
        cal_launches, cal_traces, calibration = phase_calibrate(
            torch, bloom, kernels, MatchSession, workloads, ush, tmp,
            card_line)
    # phase 11, last before the trace (why: the docstring)
    proto_times, proto_launches = phase_proto(torch, kernels, card_line)
    times.update(proto_times)
    for key in ("proto_tile", "proto_grid"):
        launches[key] = proto_launches[key]
    phase_trace(torch, times, main_times, shards, ab_fns, cal_traces,
                card_line)
    calibration["calls"] = cal_traces
    phase_dispatch(torch, dispatch_sessions, card_line)
    imported = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "tpu_pattern_matching")]
    if imported:
        fail(f"imported {imported}")
    print("[no jax] neither jax nor the JAX package (tpu_pattern_matching) "
          "is in sys.modules", flush=True)
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[key],
         "max_abs_err": times[key]["max_abs_err"], "ms": times[key]["ms"],
         "plain_ms": times[key]["plain_ms"],
         "bound_ms": times[key]["bound_ms"],
         "bound_by": times[key]["bound_by"],
         "share": times[key]["bound_ms"] / times[key]["ms"],
         "library_ms": None,  # no PyTorch call probes a bloom or walks a DFA
         # W2's ms is its kernel's; call_ms adds the two fills of its buffer,
         # the scope of its bound_ms and plain_ms
         **({"call_ms": times[key]["call_ms"]}
            if "call_ms" in times[key] else {}),
         # the calibration phase's share of launches
         **({"calibration_launches": cal_launches[key]}
            if cal_launches.get(key) else {}),
         # the kernel's launches on the mesh phases' paths (per run)
         **({"mesh_launches": {run: got[key] for run, got in
                               mesh_launches.items() if got.get(key)}}
            if any(got.get(key) for got in mesh_launches.values()) else {}),
         **({"main_path": {
             k: main_times[key][k] for k in (
                 "label", "config", "shape", "max_abs_err", "ms", "plain_ms",
                 "bound_ms", "bound_by")}} if key in main_times else {})}
        for key, (name, _fn, src, rep) in KERNELS.items()
    ] + [
        # the pattern-shard sequence: S launches of one probe kernel into
        # one bitmap per batch; ms, plain_ms and the bounds per batch
        {"name": f"bloom_probe_{key}", "route": "cuda", "source": PROBE_SRC,
         "replaces": "tpu_pattern_matching/parallel/pshard.py:277",
         "launches": t["launches"],
         "max_abs_err": t["max_abs_err"], "ms": t["ms"],
         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
         "bound_by": t["bound_by"], "share": t["bound_ms"] / t["ms"],
         "library_ms": None, "shards": t["shards"],
         "launch_ms": t["launch_ms"],
         "launches_bound_ms": t["launches_bound_ms"],
         "one_shard_ms": t["one_shard_ms"], "config": t["config"],
         "shape": t["shape"]}
        for key, t in shards.items()
    ], "grid_launches": grid_launches, "calibration": calibration}
    print(card_line)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
