"""The five BASELINE.json benchmark configs, and the feed-only baseline
(port of the reference's ``benchmarks/run_configs.py``).

    python -m tpu_pattern_matching_torch.benchmarks.run_configs [--config N]
        [--data-dir DIR] [--device cpu]

Each config prints one JSON line with the reference's keys; ``--config N``
selects, the default runs all.

1. generated word corpus against the CPU oracle, exact offsets
2. 2,000 hex signatures over 32 MiB of random binary
3. 10,000 hex signatures over 2 x 32 MiB with the sorted pipeline
4. 15,000 hex signatures truncated to 12 bytes, streaming four files
   through the feeder (the CLI's depth-2 pipeline)
5. sentiment word patterns over generated text, lanes sharded over the
   ranks of a ``torch.distributed`` group, three arms that must agree: the
   dense sharded step's reduced group counts, the bloom engine through
   ``MatchSession(mesh=)`` with host verify, and the bloom probe with
   device verify (``make_sharded_bloom_count_step``). One process is a
   1-rank group; ``--num-processes W --process-id R --coordinator ADDR``
   runs W ranks, each on its lane slice of the one global batch (only
   config 5 runs so);
6. the feed alone (feeder and batch assembly, no device work), byte and
   ushort.

Corpora are generated from fixed seeds at the reference's scale points;
with ``$TPM_UPSTREAM_DIR`` naming a checkout of the upstream C project,
configs 2-4 read its real ClamAV sets instead (``_sig_set``). Every
parity check runs the native oracle and raises on a difference (the
reference skipped parity when its oracle was unavailable, and checked
config 4's matches against nothing; here they must equal the oracle's
events over its four files, counted after the timed span). Wall times are
host-clock spans of whole pipelines, as in the reference.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tempfile
import time
from collections import deque

import numpy as np
import torch

from tpu_pattern_matching_torch.benchmarks.common import (
    oracle_match_ends,
    upstream_path,
)
from tpu_pattern_matching_torch.utils.device import entry_device
from tpu_pattern_matching_torch.utils.measure import card

MIB = 32  # the data files: 32 MiB each (the upstream corpus's 8 x 32 MB)
SIGS = {2: 2000, 3: 10_000, 4: 15_000}  # signatures of configs 2-4
FLOW_BYTES = 32 << 20  # config 6's flow-token text


def _hex_sigs(n: int, seed: int, length: int) -> list[bytes]:
    rng = np.random.RandomState(seed)
    return [bytes(rng.randint(0, 256, size=length).astype(np.uint8))
            for _ in range(n)]


def _sig_set(n: int, seed: int, length: int, limit: int = -1):
    """The upstream project's real ClamAV signature set of ``n`` (its
    ``clamav_sample_sigs/<n>.txt``) when ``$TPM_UPSTREAM_DIR`` holds it,
    else synthetic hex of the same scale. Returns (sigs, source_tag)."""
    path = upstream_path("clamav_sample_sigs", f"{n}.txt")
    if path and os.path.exists(path):
        from tpu_pattern_matching_torch.core.patterns import load_pattern_file

        parsed = load_pattern_file(path, hex_pat=True, pat_size_limit=limit)
        return [p.data for p in parsed], "clamav"
    return _hex_sigs(n, seed, length if limit < 0 else limit), "synthetic"


def _random_file(path: str, mib: int, seed: int) -> str:
    if not os.path.exists(path) or os.path.getsize(path) != mib << 20:
        rng = np.random.RandomState(seed)
        with open(path, "wb") as f:
            for _ in range(mib):
                f.write(rng.bytes(1 << 20))
    return path


def _flow_file(path: str, size: int = FLOW_BYTES, seed: int = 5) -> str:
    """Comma-separated packet-length tokens, at least ``size`` bytes."""
    if not os.path.exists(path) or os.path.getsize(path) < size:
        rng = np.random.RandomState(seed)
        with open(path, "w") as f:
            while f.tell() < size:
                f.write(",".join(map(str, rng.randint(0, 1500, size=65536)))
                        + ",")
    return path


def wall_seconds(fn, device) -> tuple[object, float]:
    """``(fn(), seconds)``: the host clock from a drained queue to the end
    of the work ``fn`` queued on ``device``."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def emit(name: str, **kw) -> dict:
    out = {"config": name, **kw}
    print(json.dumps(out), flush=True)
    return out


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def config1(device) -> dict:
    """Word corpus against the CPU oracle: exact (offset, pattern)
    parity."""
    from tpu_pattern_matching_torch.benchmarks.corpus import (
        random_words_corpus,
    )
    from tpu_pattern_matching_torch.core.dfa import compile_patterns
    from tpu_pattern_matching_torch.core.oracle import match_python
    from tpu_pattern_matching_torch.runtime.session import MatchSession

    patterns, corpus = random_words_corpus(seed=31, n_lines=2000)
    sess = MatchSession(compile_patterns(patterns), max_chunks=256,
                        chunk_len=128, device=device)
    got, dt = wall_seconds(lambda: sess.find(corpus, text_mode=True), device)
    ok = got == sorted(match_python(patterns, corpus))
    out = emit("1_oracle_parity_words", parity=ok, events=len(got),
               wall_s=round(dt, 3))
    require(ok, "config 1: events differ from the oracle's")
    return out


def _scan_file_throughput(sigs: list[bytes], path: str, *, sort: bool,
                          check_oracle: bool, device) -> dict:
    from tpu_pattern_matching_torch.core.dfa import compile_patterns
    from tpu_pattern_matching_torch.runtime.session import MatchSession

    table = compile_patterns(sigs)
    sess = MatchSession(table, max_chunks=2048, chunk_len=4096, sort=sort,
                        device=device)
    size = os.path.getsize(path)

    def one_pass():
        ev = []
        with open(path, "rb") as f:
            t0 = time.perf_counter()
            for bm in sess.scan_stream(f, file_id=0):
                ev.extend((e.end_offset, p) for e in bm.events
                          for p in e.pattern_indices)
            return ev, time.perf_counter() - t0

    one_pass()  # warm-up pass: allocator, first launches
    events, dt = one_pass()
    out = {
        "bytes": size,
        "wall_s": round(dt, 3),
        "bytes_per_s": size / dt,
        "events": len(events),
        "states": table.num_states,
    }
    if check_oracle:
        from tpu_pattern_matching_torch.core.oracle_native import NativeOracle

        with open(path, "rb") as f:
            data = f.read()
        out["parity"] = sorted(events) == NativeOracle(sigs).match_events(
            data)
    return out


def _plant(path: str, sigs: list[bytes], n: int, chunk: int = 4096) -> None:
    """Plant signature occurrences (some straddling chunk boundaries) so
    the oracle-parity check is substantive."""
    rng = np.random.RandomState(123)
    with open(path, "r+b") as f:
        size = os.path.getsize(path)
        for k in range(n):
            sig = sigs[rng.randint(len(sigs))]
            if k % 4 == 0:  # straddle a chunk boundary
                pos = chunk * rng.randint(1, size // chunk - 1) - len(sig) // 2
            else:
                pos = rng.randint(0, size - len(sig))
            f.seek(pos)
            f.write(sig)


def config2(data_dir: str, device) -> dict:
    sigs, src = _sig_set(SIGS[2], seed=2, length=16)
    path = _random_file(os.path.join(data_dir, "32MB.7p.bin"), MIB, seed=7)
    _plant(path, sigs, 400)
    out = _scan_file_throughput(sigs, path, sort=False, check_oracle=True,
                                device=device)
    line = emit("2_clamav2000_32MB", sigs=src, **out)
    require(out["parity"] is True, "config 2: events differ from the "
            "native oracle's")
    require(out["events"] > 300, f"config 2: {out['events']} events, not "
            f"the plants' (over 300)")
    return line


def config3(data_dir: str, device) -> dict:
    sigs, src = _sig_set(SIGS[3], seed=3, length=16)
    p7 = _random_file(os.path.join(data_dir, "32MB.7q.bin"), MIB, seed=7)
    p8 = _random_file(os.path.join(data_dir, "32MB.8.bin"), MIB, seed=8)
    _plant(p7, sigs, 500)  # exact-parity evidence at the 10k scale point
    out7 = _scan_file_throughput(sigs, p7, sort=True, check_oracle=True,
                                 device=device)
    out8 = _scan_file_throughput(sigs, p8, sort=True, check_oracle=False,
                                 device=device)
    tot = out7["bytes"] + out8["bytes"]
    dt = out7["wall_s"] + out8["wall_s"]
    line = emit(
        "3_clamav10000_compact_sort",
        bytes=tot,
        wall_s=round(dt, 3),
        bytes_per_s=tot / dt,
        events=out7["events"] + out8["events"],
        states=out7["states"],
        parity=out7["parity"],
        sigs=src,
    )
    require(out7["parity"] is True, "config 3: events differ from the "
            "native oracle's")
    return line


def config4(data_dir: str, device) -> dict:
    """15k sigs truncated to 12 B, multi-file streaming via the feeder."""
    from tpu_pattern_matching_torch.core.dfa import compile_patterns
    from tpu_pattern_matching_torch.runtime.feeder import Feeder
    from tpu_pattern_matching_torch.runtime.session import MatchSession

    sigs, src = _sig_set(SIGS[4], seed=4, length=12, limit=12)  # -m 12
    files = [_random_file(os.path.join(data_dir, f"32MB.{i}.bin"), MIB,
                          seed=i) for i in (1, 2, 3, 4)]
    table = compile_patterns(sigs)
    sess = MatchSession(table, max_chunks=2048, chunk_len=4096,
                        device=device)
    feeder = Feeder(files, n_workers=2, max_chunks=2048, chunk_len=4096,
                    halo=sess.halo)
    t0 = time.perf_counter()
    feeder.start()
    total_bytes = total_matches = rounds = 0
    pending: deque = deque()

    def consume(item, comp):
        nonlocal total_bytes, total_matches, rounds
        bm = sess.decode(item.batch, comp)
        total_bytes += item.bytes
        total_matches += bm.total
        rounds += 1

    for item in feeder:
        # depth-2 pipeline (decode of batch k overlaps scan of k+1), as
        # the CLI does
        pending.append((item, sess.scan(item.batch)))
        if len(pending) >= 2:
            consume(*pending.popleft())
    while pending:
        consume(*pending.popleft())
    dt = time.perf_counter() - t0
    line = emit(
        "4_clamav15000_streaming",
        bytes=total_bytes,
        wall_s=round(dt, 3),
        bytes_per_s=total_bytes / dt,
        matches=total_matches,
        rounds=rounds,
        states=table.num_states,
        sigs=src,
    )
    want = 0  # the native oracle's events over the same files, untimed
    for path in files:
        with open(path, "rb") as f:
            want += oracle_match_ends(sigs, f.read())
    require(total_matches == want, f"config 4: {total_matches} matches, "
            f"the native oracle {want} events")
    return line


def config6(data_dir: str) -> list[dict]:
    """The data path alone: feeder and batch assembly without any device
    work, the role of the upstream project's ``_EMPTY`` no-op kernel; then
    the ushort arm, flow text to tokens (the parse cost)."""
    from tpu_pattern_matching_torch.runtime.buffers import UshortBuffer
    from tpu_pattern_matching_torch.runtime.feeder import Feeder

    files = [_random_file(os.path.join(data_dir, f"32MB.{i}.bin"), MIB,
                          seed=i) for i in (1, 2)]
    feeder = Feeder(files, n_workers=2, max_chunks=2048, chunk_len=4096,
                    halo=16)
    t0 = time.perf_counter()
    feeder.start()
    total_bytes = rounds = 0
    for item in feeder:
        total_bytes += item.bytes  # batches assembled, never dispatched
        rounds += 1
    dt = time.perf_counter() - t0
    lines = [emit(
        "6_datapath_only_empty_kernel",
        bytes=total_bytes,
        wall_s=round(dt, 3),
        bytes_per_s=total_bytes / dt,
        rounds=rounds,
    )]

    flow = _flow_file(os.path.join(data_dir, "flow_tokens.txt"))
    feeder = Feeder([flow], n_workers=1, max_chunks=2048, chunk_len=2048,
                    halo=16, buffer_factory=UshortBuffer)
    t0 = time.perf_counter()
    feeder.start()
    raw_bytes = tokens = 0
    for item in feeder:
        raw_bytes += item.bytes
        tokens += item.batch.payload_bytes // 2
    dt = time.perf_counter() - t0
    lines.append(emit(
        "6u_ushort_datapath_only",
        text_bytes=raw_bytes,
        tokens=tokens,
        wall_s=round(dt, 3),
        text_bytes_per_s=raw_bytes / dt,
        tokens_per_s=tokens / dt,
    ))
    return lines


def config5(device) -> dict | None:
    """Sentiment group counts with lanes sharded over the ranks of the
    process group (a 1-rank group when there is none). Each rank holds
    the lane slice ``[r*C_local, (r+1)*C_local)`` of one global batch
    that holds the whole corpus. Three arms, all required to agree
    exactly: the dense sharded step's reduced group counts (W1); the
    bloom engine through ``MatchSession(mesh=)`` with host-verified
    event counts, summed over the ranks; and the bloom probe + device
    verify + reduction (``make_sharded_bloom_count_step``, W2), no host
    CPU in the verify loop. Rank 0 prints the line and returns it."""
    from tpu_pattern_matching_torch.benchmarks.corpus import (
        random_words_corpus,
    )
    from tpu_pattern_matching_torch.core.dfa import compile_patterns
    from tpu_pattern_matching_torch.ops.table import DeviceTable
    from tpu_pattern_matching_torch.parallel.mesh import (
        allreduce_host_counts,
        make_sharded_bloom_count_step,
        make_sharded_scan_step,
        world_context,
    )
    from tpu_pattern_matching_torch.runtime.buffers import (
        DataBuffer,
        HostBatch,
        StreamState,
    )
    from tpu_pattern_matching_torch.runtime.session import MatchSession
    from tpu_pattern_matching_torch.utils.common import cdiv, roundup

    words, corpus = random_words_corpus(seed=55, n_lines=5000,
                                        n_patterns=64)
    patterns = [b" " + w + b" " for w in words]
    table = compile_patterns(patterns)
    ctx = world_context(device)
    dev = DeviceTable.put(table, ctx.device)
    halo = table.max_pat_len - 1
    n_dev = ctx.world_size
    # lanes to hold the WHOLE corpus in one global batch, rounded to the
    # mesh's 128 lanes per rank
    C = roundup(cdiv(len(corpus), 256) + 1, 128 * n_dev)
    c_local = C // n_dev
    lanes = slice(ctx.rank * c_local, (ctx.rank + 1) * c_local)

    def local_batch(halo: int) -> HostBatch:
        buf = DataBuffer(C, 256, halo)
        buf.add_stream(io.BytesIO(corpus), StreamState(file_id=0))
        b = buf.to_batch()
        part = {f: np.ascontiguousarray(getattr(b, f)[lanes])
                for f in ("data", "start_t", "end_t", "file_ids",
                          "base_off")}
        return HostBatch(chunks=int(np.count_nonzero(part["file_ids"] >= 0)),
                         halo=b.halo, **part)

    def up(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(ctx.device)
                for a in arrays]

    batch = local_batch(halo)
    step = make_sharded_scan_step(ctx, dev, halo=halo, max_results=16,
                                  num_groups=table.num_groups)
    args = (dev.table_flat, dev.state_gid,
            *up(batch.data, batch.start_t, batch.end_t))
    step(*args)
    out, dt = wall_seconds(lambda: step(*args), ctx.device)
    gcounts = out[3].cpu().numpy()

    # the bloom engine on the same mesh via the product path
    sess = MatchSession(table, max_chunks=C, chunk_len=256, engine="bloom",
                        mesh=ctx, device=ctx.device)
    b2 = local_batch(sess.halo)
    t1 = time.perf_counter()
    bm = sess.decode(b2, sess.scan(b2))
    bcounts = sess.event_group_counts(bm)
    bloom_dt = time.perf_counter() - t1
    bcounts = allreduce_host_counts(bcounts, ctx)
    agree = bool(np.array_equal(bcounts, gcounts.astype(np.int64)))

    # arm 3: bloom probe + DEVICE verify + reduction, no host CPU in the loop
    cstep = make_sharded_bloom_count_step(
        ctx, sess._bloom, table, halo=sess.halo,
        gram_keys=sess.bloom_table.gram_keys)
    cargs = (sess._bloom.words, dev.table_flat, dev.state_gid,
             *up(b2.data, np.stack([b2.start_t, b2.end_t])))
    cstep(*cargs)
    out2, dev_verify_dt = wall_seconds(lambda: cstep(*cargs), ctx.device)
    dcounts, _n_ev, flags, _needs = (x.cpu().numpy() for x in out2)
    require(int(flags) == 0, "config 5: per-shard candidate capacity "
            "overflowed")
    dev_agree = bool(np.array_equal(dcounts.astype(np.int64), bcounts))
    line = None
    if ctx.rank == 0:
        line = emit(
            "5_sentiment_psum_sharded",
            devices=n_dev,
            bytes=len(corpus),
            wall_s=round(dt, 4),
            bytes_per_s=len(corpus) / dt,
            group_events=int(gcounts.sum()),
            bloom_engine_agrees=agree,
            bloom_wall_s=round(bloom_dt, 4),
            device_verify_agrees=dev_agree,
            device_verify_wall_s=round(dev_verify_dt, 4),
        )
    require(agree and dev_agree, f"config 5: the arms disagree (bloom "
            f"{agree}, device verify {dev_agree})")
    return line


def run(todo, data_dir: str, device) -> list[dict]:
    """Runs the configs ``todo`` in order on ``device``; returns their
    lines (config 6 gives two; a rank other than 0 none for config 5).
    Raises when a parity or agreement check fails."""
    os.makedirs(data_dir, exist_ok=True)
    runners = {
        1: lambda: config1(device),
        2: lambda: config2(data_dir, device),
        3: lambda: config3(data_dir, device),
        4: lambda: config4(data_dir, device),
        5: lambda: config5(device),
        6: lambda: config6(data_dir),
    }
    lines = []
    for c in todo:
        got = runners[c]()
        lines.extend(got if isinstance(got, list) else
                     [] if got is None else [got])
    return lines


def main(argv=None) -> int:
    from tpu_pattern_matching_torch.parallel.mesh import (
        init_distributed,
        owned_world,
    )

    ap = argparse.ArgumentParser(
        prog="python -m tpu_pattern_matching_torch.benchmarks.run_configs")
    ap.add_argument("--config", type=int, default=0,
                    help="1-6, 0=all (6 = data-path-only _EMPTY baseline)")
    ap.add_argument("--data-dir", default=os.path.join(
        tempfile.gettempdir(), "tpm_bench_data"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 2 without a card) or cpu")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="ranks of config 5's process group")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--coordinator", default=None,
                    help="host:port or file:///path rendezvous")
    args = ap.parse_args(argv)
    if entry_device(args.device).type == "cuda":
        print(f"[run_configs] card: {card()}", file=sys.stderr, flush=True)
    if args.num_processes > 1 and args.config != 5:
        print("ERROR: --num-processes > 1 runs config 5 only (--config 5)",
              file=sys.stderr)
        return 2
    todo = [args.config] if args.config else [1, 2, 3, 4, 5, 6]
    with owned_world():
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id, device=args.device)
        run(todo, args.data_dir, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
