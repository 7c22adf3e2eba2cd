"""``torch_aho_grep`` — the grep-style CLI of the PyTorch port.

    python -m tpu_pattern_matching_torch.cli -f INPUT -p PATTERNS [flags]

Port of the reference's ``tpu_pattern_matching/cli.py`` (``tpu_aho_grep``):
the same flags, messages, exit codes, verbose lines ("Pattern <id>
('<label>') found in file ..."), context echo and STATS block, so the
apps that read its standard output work unchanged.

  -f file(s)      input: a directory, a single file, or comma-separated files
  -p file         pattern file (one per line; auto-detected "ID PATTERN"
                  categorical format)
  -B chunk_size   bytes per chunk lane
  -G global_ws    chunk lanes per batch (buffer = G * B bytes)
  -L local_ws     accepted for compatibility
  -D devpos       CUDA device ordinal (default 0; on a mesh, rank r takes
                  device r % count)
  -m max          truncate patterns to max bytes
  -w cpu_threads  feeder threads (round-robin over files, default 2)
  -R max          result slots per chunk (default 16)
  -v              verbose per-match lines
  -t              text mode (line-wise chunks)
  -x              printable-hex patterns
  -F              follow mode (keep scanning growing files/FIFOs)
  -M              accepted for compatibility
  -i              ASCII case-insensitive matching
  --ushort        packet-metadata mode (signature files, flow files)
  --engine        auto | bloom | dense;  --verify auto | host | device
  --pat-shards S  partition the pattern set into S shard filters (bloom)
  --mesh N|all    data-parallel mesh on torch.distributed: one lane shard
                  per rank, N the world size (a 1-rank group when run alone);
                  with --pat-shards S the ("pat", "data") grid: rank r holds
                  shard r % S of lane column r // S (the world size must be
                  a multiple of S)
  --num-processes W --process-id p --coordinator host:port
                  start rank p of a W-process mesh (implies --mesh all);
                  each rank reads its own share of the files and prints
                  its own matches (on the grid: each column's first rank),
                  rank 0 prints the global STATS
  --sort, --sort-global, --save-dfa/--load-dfa, --save-bloom/--load-bloom
  (a pattern-sharded dump loads as one), --json-stats, --profile DIR (a
  torch.profiler Chrome trace of the run)
  --device        cuda (default) | cpu

``--device cpu`` runs the kernels' plain PyTorch versions on the CPU (the
counterpart of the reference's ``JAX_PLATFORMS=cpu``) and is the only way
onto the CPU: without a GPU, ``--device cuda`` exits with an error.

A two-process run on one host, e.g. on the CPU over gloo::

    python -m tpu_pattern_matching_torch.cli -f DIR -p PATS -v \
        --num-processes 2 --process-id 0 --coordinator localhost:29500 \
        --device cpu &
    python -m tpu_pattern_matching_torch.cli -f DIR -p PATS -v \
        --num-processes 2 --process-id 1 --coordinator localhost:29500 \
        --device cpu

On CUDA devices the ranks run NCCL, one rank per device: two ranks on one
device exit 2. ``--coordinator`` also takes a ``file:///path`` rendezvous.
``--pat-shards S`` (or a pattern-sharded ``--load-bloom`` dump) on a mesh
whose world size is not a multiple of S exits 2.

``check_args``, ``align_parameters``, ``raise_nofile_limit`` and
``compile_table`` are copies of the reference's: its module imports the
JAX session at its top.
"""

from __future__ import annotations

import argparse
import signal
import sys

import numpy as np
import torch

from tpu_pattern_matching_torch.core.dfa import ALPHABET_USHORT, AhoCorasick, DfaTable
from tpu_pattern_matching_torch.core.patterns import (
    load_pattern_file,
    load_signature_file,
)
from tpu_pattern_matching_torch.runtime.feeder import Feeder
from tpu_pattern_matching_torch.runtime.files import expand_paths
from tpu_pattern_matching_torch.runtime.stats import RunStats
from tpu_pattern_matching_torch.utils.common import now_us
from tpu_pattern_matching_torch.runtime.session import MatchSession


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="torch_aho_grep",
        description="GPU multi-pattern matcher (Aho-Corasick DFA scan, "
        "PyTorch + CUDA)",
    )
    ap.add_argument("-f", dest="data_path", required=True, help="input file(s)/dir")
    ap.add_argument("-p", dest="pat_path", help="pattern file")
    ap.add_argument("-B", dest="chunk_size", type=int, default=4096)
    ap.add_argument("-G", dest="global_ws", type=int, default=2048)
    ap.add_argument("-L", dest="local_ws", type=int, default=0)  # compat no-op
    ap.add_argument("-D", dest="dev_pos", type=int, default=None,
                    help="CUDA device ordinal (default 0; on a mesh, rank r "
                    "takes device r %% count)")
    ap.add_argument("-m", dest="pat_size_limit", type=int, default=-1)
    ap.add_argument("-w", dest="thread_no", type=int, default=2)
    ap.add_argument("-R", dest="max_results", type=int, default=16)
    ap.add_argument("-v", dest="verbose", action="store_true")
    ap.add_argument("-t", dest="text_mode", action="store_true")
    ap.add_argument("-x", dest="hex_pat", action="store_true")
    ap.add_argument("-F", dest="follow", action="store_true")
    ap.add_argument("-M", dest="mapped", action="store_true")  # compat no-op
    ap.add_argument(
        "-i",
        dest="nocase",
        action="store_true",
        help="ASCII case-insensitive matching",
    )
    ap.add_argument("--ushort", action="store_true", help="packet-metadata mode")
    ap.add_argument("--sort", action="store_true")
    ap.add_argument(
        "--sort-global",
        dest="sort_global",
        action="store_true",
        help="buffer ALL verbose match lines and emit them in one global "
        "canonical (file, offset) order at end of run (requires -v; "
        "memory grows with the total match count; incompatible with -F, "
        "which never ends)",
    )
    ap.add_argument(
        "--mesh",
        default=None,
        metavar="N|all",
        help="data-parallel mesh on torch.distributed: each rank scans "
        "its own lane shard on its own device, the filter/DFA table "
        "replicates and totals all-reduce; N must equal the world size "
        "(a 1-rank group when run alone)",
    )
    ap.add_argument(
        "--pat-shards",
        dest="pat_shards",
        type=int,
        default=1,
        metavar="S",
        help="partition the pattern set into S balanced shards, each "
        "with its own smaller bloom filter (the 300k+-pattern capacity "
        "axis); the S probes run on one device and OR into one bitmap, "
        "or with --mesh on S ranks of each lane column (the (pat, data) "
        "grid). Bloom engine only",
    )
    ap.add_argument(
        "--coordinator",
        default=None,
        metavar="HOST:PORT",
        help="multi-process rendezvous: rank 0's host:port (a TCP store) "
        "or file:///path (run the same command in every process with its "
        "--process-id)",
    )
    ap.add_argument("--num-processes", type=int, default=1,
                    help="multi-process: total number of processes (ranks)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="multi-process: this process's rank (0-based)")
    ap.add_argument(
        "--engine",
        choices=("auto", "bloom", "dense"),
        default="auto",
        help="scan engine: auto (default; bloom for byte patterns; for "
        "--ushort bloom on a CUDA device, dense on the CPU), bloom "
        "(q-gram filter + exact verify), dense (DFA walk, exact on device)",
    )
    ap.add_argument(
        "--verify",
        choices=("auto", "host", "device"),
        default="auto",
        help="bloom engine exactness stage: host (native CPU window "
        "walker), device (candidate windows walk the dense table on the "
        "device), auto (host)",
    )
    ap.add_argument("--save-dfa", dest="save_dfa")
    ap.add_argument("--load-dfa", dest="load_dfa")
    ap.add_argument(
        "--save-bloom", dest="save_bloom",
        help="dump the compiled bloom filter (npz) after building it",
    )
    ap.add_argument(
        "--load-bloom", dest="load_bloom",
        help="load a precompiled bloom filter instead of rebuilding "
        "(pair with --load-dfa for a build-free cold start)",
    )
    ap.add_argument("--json-stats", action="store_true")
    ap.add_argument("--profile",
                    help="write a torch.profiler trace to this dir")
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cuda (default; exits with an error without a GPU) or cpu "
        "(the kernels' plain PyTorch versions)",
    )
    return ap


MAX_PAT_SIZE = 4096  # reference utils.h:14


def check_args(args) -> None:
    """Argument validation (reference check_args, ocl_aho_grep.c:210-267).

    argparse covers presence/typing; the value-range rules are mirrored
    here with the reference's messages."""
    import os

    err = 0
    if args.pat_path and not os.path.exists(args.pat_path) and not args.load_dfa:
        print(f"ERROR: File '{args.pat_path}' does not exist", file=sys.stderr)
        err += 1
    if args.thread_no <= 0:
        print("ERROR: The thread number must be greater than 0", file=sys.stderr)
        err += 1
    if args.pat_size_limit != -1 and args.pat_size_limit <= 0:
        print("ERROR: The pattern size limit should be >= 1", file=sys.stderr)
        err += 1
    if args.pat_size_limit >= MAX_PAT_SIZE:
        print(
            f"ERROR: The pattern size limit should be <= {MAX_PAT_SIZE - 1}",
            file=sys.stderr,
        )
        err += 1
    if args.max_results <= 0:
        print("ERROR: The maximum result cells should be >= 1", file=sys.stderr)
        err += 1
    if args.chunk_size <= 0 or args.global_ws <= 0:
        print("ERROR: chunk size and global work size must be >= 1",
              file=sys.stderr)
        err += 1
    if getattr(args, "sort_global", False) and args.follow:
        print(
            "ERROR: --sort-global buffers the whole run's matches; a -F "
            "follow stream never ends (use --sort for per-batch order)",
            file=sys.stderr,
        )
        err += 1
    if err:
        sys.exit(2)


def align_parameters(args) -> None:
    """Round -B (and -L/-G, accepted for compatibility) to 16 with a
    warning (reference align_parameters, ocl_aho_grep.c:315-346)."""
    from tpu_pattern_matching_torch.utils.common import roundup

    if args.local_ws % 16:
        fixed = roundup(args.local_ws, 16)
        print(
            f"WARNING: local work size '{args.local_ws}' is not 16B "
            f"aligned. Will use '{fixed}' instead",
            file=sys.stderr,
        )
        args.local_ws = fixed
    if args.global_ws % 16:
        fixed = roundup(args.global_ws, 16)
        print(
            f"WARNING: global work size {args.global_ws} is not 16B "
            f"aligned. Will use '{fixed}' instead.",
            file=sys.stderr,
        )
        args.global_ws = fixed
    if args.chunk_size % 16:
        fixed = roundup(args.chunk_size, 16)
        print(
            f"WARNING: max chunk size '{args.chunk_size}' is not 16B aligned. "
            f"Will use '{fixed}' instead.",
            file=sys.stderr,
        )
        args.chunk_size = fixed


def raise_nofile_limit() -> None:
    """Expand RLIMIT_NOFILE to the hard max (ocl_aho_grep.c:462-472)."""
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < hard:
            resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except Exception:
        pass


def compile_table(args) -> DfaTable:
    if args.load_dfa:
        return DfaTable.load(args.load_dfa)
    if not args.pat_path:
        print("ERROR: No pattern file", file=sys.stderr)
        sys.exit(2)
    if args.ushort:
        parsed = load_signature_file(args.pat_path)
        ac = AhoCorasick(ALPHABET_USHORT)
    else:
        parsed = load_pattern_file(
            args.pat_path, hex_pat=args.hex_pat, pat_size_limit=args.pat_size_limit
        )
        ac = AhoCorasick(nocase=getattr(args, "nocase", False))
    if not parsed:
        print("ERROR: pattern file is empty", file=sys.stderr)
        sys.exit(2)
    for p in parsed:
        ac.add_pattern(p.data, iid=p.iid, label=p.label)
    table = ac.compile()
    if args.save_dfa:
        table.save(args.save_dfa)
    return table


def check_grid(args, n_shards: int) -> None:
    """Exit 2 when a mesh run (``--mesh`` or ``--num-processes``) cannot
    hold ``n_shards`` pattern shards: its world size (``--num-processes``,
    else the process group's, 1 without one) is not a multiple of it."""
    import torch.distributed as dist

    from tpu_pattern_matching_torch.parallel import pshard

    if n_shards <= 1 or (args.mesh is None and args.num_processes <= 1):
        return
    world = args.num_processes if args.num_processes > 1 else (
        dist.get_world_size() if dist.is_initialized() else 1)
    try:
        pshard.check_grid(world, n_shards)
    except ValueError as e:
        print(f"ERROR: --pat-shards {n_shards}: {e}", file=sys.stderr)
        sys.exit(2)


def select_device(args) -> torch.device:
    """The run's device from ``--device`` and ``-D``; exits 2 (never falls
    back) when it does not exist. Without ``-D`` a CUDA device has no
    ordinal: device 0, or on a mesh rank r's ``r % count``."""
    if args.device == "cpu":
        if args.dev_pos not in (None, 0):
            print(f"ERROR: device position {args.dev_pos} not available",
                  file=sys.stderr)
            sys.exit(2)
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print("ERROR: --device cuda: no CUDA device is available "
              "(torch.cuda.is_available() is False); pass --device cpu to "
              "run the plain PyTorch path", file=sys.stderr)
        sys.exit(2)
    if args.dev_pos is None:
        return torch.device("cuda")
    if not 0 <= args.dev_pos < torch.cuda.device_count():
        print(f"ERROR: device position {args.dev_pos} not available",
              file=sys.stderr)
        sys.exit(2)
    return torch.device("cuda", args.dev_pos)


def start_processes(args, device: torch.device) -> None:
    """``--num-processes`` > 1: join the ranks' process group before any
    device use (NCCL on CUDA devices, gloo on the CPU); the run is then a
    mesh run. Exits 2 on a bad layout (no ``--process-id``, two NCCL ranks
    on one device)."""
    from tpu_pattern_matching_torch.parallel.mesh import (
        DeviceConflict,
        init_distributed,
    )

    if args.num_processes <= 1:
        return
    if args.process_id is None:
        print("ERROR: --num-processes needs --process-id", file=sys.stderr)
        sys.exit(2)
    try:
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id, device=device)
    except (DeviceConflict, ValueError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        sys.exit(2)
    if args.mesh is None:
        args.mesh = "all"  # a multi-process run IS a mesh run


def mesh_spec(args):
    """``--mesh`` as a session's ``mesh=``: "all", the world size, or
    None. Exits 2 on any other value."""
    from tpu_pattern_matching_torch.parallel.mesh import check_mesh_size

    mesh = getattr(args, "mesh", None)  # library callers may not set it
    if mesh is None:
        return None
    if mesh in ("all", "auto"):
        return "all"
    try:
        return check_mesh_size(int(mesh))
    except ValueError as e:
        print(f"ERROR: --mesh {mesh}: {e}", file=sys.stderr)
        sys.exit(2)


def rank_feeder(sess, filenames, **kw) -> Feeder:
    """The ``Feeder`` of this rank's share of ``filenames``: every file
    without a mesh, the rank's round-robin share on the data mesh, its
    column's share (``process_id=d`` of ``D``) on a grid column's
    leader. A grid follower owns no file: it scans its leader's
    batches."""
    grid, ctx = sess._grid, sess._mesh_ctx
    if grid is not None and not grid.is_leader:
        return Feeder([], **dict(kw, follow=False))
    if grid is not None:
        pid, n = grid.data_index, grid.data_size
    else:
        pid, n = (ctx.rank, ctx.world_size) if ctx else (0, 1)
    return Feeder(filenames, process_id=pid, num_processes=n, **kw)


def rank_batches(sess, feeder):
    """The feeder's items, in lockstep rounds across the ranks of a
    multi-process mesh (a rank whose files are done scans an empty batch
    until every rank is done)."""
    from tpu_pattern_matching_torch.parallel.mesh import lockstep
    from tpu_pattern_matching_torch.runtime.feeder import FeedItem

    ctx = sess._mesh_ctx
    if ctx is None or ctx.world_size == 1:
        return iter(feeder)
    idle = FeedItem(batch=sess.new_buffer().to_batch(), lines=0, bytes=0)
    return lockstep(feeder, ctx, idle)


def batch_total(sess, bm) -> int:
    """A batch's contribution to the STATS total: its total, except that a
    total counted over every rank of the mesh is added by rank 0 only, so
    the run-end sum over the ranks counts each event once."""
    ctx = sess._mesh_ctx
    return 0 if sess.global_totals and ctx.rank else bm.total


def reduce_stats(sess, stats) -> bool:
    """Sum the run's counters over the ranks of a multi-process mesh;
    True on the rank that prints the STATS block (rank 0, or the only
    process)."""
    from tpu_pattern_matching_torch.parallel.mesh import allreduce_host_counts

    ctx = sess._mesh_ctx
    if ctx is None or ctx.world_size == 1:
        return True
    tot = allreduce_host_counts(np.asarray(
        [stats.matches_total, stats.matches_reported, stats.bytes,
         stats.lines, stats.rounds], np.int64), ctx)
    (stats.matches_total, stats.matches_reported, stats.bytes, stats.lines,
     stats.rounds) = (int(x) for x in tot)
    return ctx.rank == 0


def scan_files(args, sess, feeder, stats, on_batch) -> int:
    """Scan the feeder's batches with ``sess`` (both grep CLIs' loop) and
    return the run's start (``now_us``) for ``report_stats``.

    SIGINT stops the feeder, which drains and flushes a final batch
    (ocl_aho_grep.c:25-31, 61-65); off the main thread (a library
    embedding) no handler is installed. Inside ``device_trace`` the
    device scans batch k+1 while the host decodes batch k (depth 2);
    follow mode runs depth 1: a held batch's matches would wait for the
    NEXT batch, which a quiet stream may never produce. Each decoded
    batch adds a round, its total (``batch_total``) and the pattern ids
    it reports (one per pattern of a co-terminating group, as the
    reference CLI counts them), warns on a slot overflow, and then goes
    to ``on_batch(item, bm)`` for the mode's bytes, lines and ``-v``
    lines."""
    from collections import deque

    from tpu_pattern_matching_torch.runtime.tracing import device_trace

    try:
        signal.signal(signal.SIGINT, lambda *_: feeder.stop())
    except ValueError:  # not the main thread (library embedding)
        pass

    def consume(item, comp):
        bm = sess.decode(item.batch, comp)
        stats.rounds += 1
        stats.matches_total += batch_total(sess, bm)
        stats.matches_reported += sum(len(e.pattern_indices)
                                      for e in bm.events)
        if bm.overflowed:
            print(
                f"WARNING: result slots overflowed: {bm.total - bm.reported} "
                f"match(es) not reported this round (raise -R)",
                file=sys.stderr,
            )
        on_batch(item, bm)

    start = now_us()
    with device_trace(getattr(args, "profile", None)):
        feeder.start()
        depth = 1 if getattr(args, "follow", False) else 2
        pending: deque = deque()
        for item in rank_batches(sess, feeder):
            pending.append((item, sess.scan(item.batch)))
            if len(pending) >= depth:
                consume(*pending.popleft())
        while pending:
            consume(*pending.popleft())
    return start


def report_stats(args, sess, stats, start: int) -> int:
    """The run's STATS tail: ``wall_us`` since ``start``, the counters
    summed over a mesh's ranks, and, on the rank that prints them (each
    rank printed its own ``-v`` lines), the STATS block and the
    ``--json-stats`` line. Returns the exit code, 0."""
    stats.wall_us = now_us() - start
    if reduce_stats(sess, stats):
        print(stats.render())
        if getattr(args, "json_stats", False):
            print(stats.to_json())
    return 0


def load_bloom(path: str):
    """The port's filter from a ``--save-bloom`` dump of either package:
    a pattern-sharded dump (``pshard_words``) loads as a ``ShardedBloom``,
    any other as a ``BloomFilterTable``."""
    from tpu_pattern_matching_torch.ops.bloom import BloomFilterTable
    from tpu_pattern_matching_torch.parallel.pshard import ShardedBloom

    with np.load(path) as z:
        is_sharded = "pshard_words" in z
    return (ShardedBloom if is_sharded else BloomFilterTable).load(path)


def main(argv: list[str] | None = None) -> int:
    from tpu_pattern_matching_torch.parallel.mesh import owned_world

    with owned_world():  # a process group this run made ends with it
        return run(build_argparser().parse_args(argv))


def run(args) -> int:
    raise_nofile_limit()
    check_args(args)
    align_parameters(args)
    # stdout is the apps' API (they consume the verbose match lines); when
    # it is a pipe Python block-buffers ~8 KB, so in -F follow mode a match
    # line could sit invisible to the consumer. Line-buffer it.
    try:
        sys.stdout.reconfigure(line_buffering=True)
    except (AttributeError, ValueError):  # non-standard streams
        pass
    check_grid(args, args.pat_shards)
    device = select_device(args)
    start_processes(args, device)

    if args.ushort:
        from tpu_pattern_matching_torch.ushort import run_ushort_grep

        return run_ushort_grep(args, device)

    table = compile_table(args)

    filenames = expand_paths(args.data_path)
    if not filenames:
        print("ERROR: Could not open input file(s) for reading.", file=sys.stderr)
        sys.exit(2)

    bloom_table = load_bloom(args.load_bloom) if args.load_bloom else None
    check_grid(args, getattr(bloom_table, "n_shards", 1))

    sess = MatchSession(
        table,
        max_chunks=args.global_ws,
        chunk_len=args.chunk_size,
        max_results=args.max_results,
        sort=args.sort or args.sort_global,
        engine=args.engine,
        verify=args.verify,
        device=device,
        bloom_table=bloom_table,
        pat_shards=args.pat_shards,
        mesh=mesh_spec(args),
    )
    if args.save_bloom:
        if sess.engine == "bloom":
            sess.bloom_table.save(args.save_bloom)
        else:
            print(
                f"WARNING: --save-bloom ignored: the session resolved to "
                f"the '{sess.engine}' engine (no filter was built); pass "
                f"--engine bloom to force one",
                file=sys.stderr,
            )

    feeder = rank_feeder(
        sess,
        filenames,
        n_workers=args.thread_no,
        # the session may round max_chunks up for mesh lane alignment; a
        # rank assembles only its own lane shard from its own files
        max_chunks=sess.local_chunks,
        chunk_len=args.chunk_size,
        halo=sess.halo,
        text_mode=args.text_mode,
        follow=args.follow,
    )

    stats = RunStats(
        files=len(filenames),
        automaton_states=table.num_states,
        automaton_bytes=table.nbytes,
    )

    def context_echo(batch, ev, pat_n: int) -> str:
        """The reference's match-context echo (ocl_aho_grep.c:289-303):
        text mode prints the matched line; binary mode a +-10-byte window
        around the occurrence, cut at the first newline."""
        row = batch.data[ev.lane]
        lo = int(batch.start_t[ev.lane])
        hi = int(batch.end_t[ev.lane])
        if args.text_mode:
            return bytes(row[batch.halo : hi]).decode(
                "latin-1", "replace"
            ).rstrip("\n")
        end_row = batch.halo + int(ev.end_offset - batch.base_off[ev.lane])
        w0 = max(lo, end_row - pat_n + 1 - 10)
        w1 = min(hi, end_row + 1 + 10)
        window = bytes(row[w0:w1])
        nl = window.find(b"\n")
        if nl != -1:
            window = window[:nl]
        return " ... " + window.decode("latin-1", "replace") + " ... "

    global_out: list = []  # --sort-global: (canonical key, rendered lines)

    def on_batch(item, bm):
        stats.bytes += item.bytes
        stats.lines += item.lines
        if args.verbose:
            for ev in bm.events:
                fname = filenames[ev.file_id]
                for pidx in ev.pattern_indices:
                    pat = table.patterns[pidx]
                    start_off = ev.end_offset - pat.n + 1
                    rel = start_off - int(item.batch.base_off[ev.lane])
                    lines = (
                        f"Pattern {pat.iid} ('{pat.label}') found in file "
                        f"'{fname}' at offset {start_off} [relative: {rel}]"
                        f"\n{context_echo(item.batch, ev, pat.n)}"
                    )
                    if args.sort_global:
                        # run-end sort on the canonical key (MATCHING.md
                        # "--sort semantics"): the order is global across
                        # worker and batch interleaving
                        global_out.append(
                            ((ev.file_id, ev.end_offset, pidx), lines)
                        )
                    else:
                        print(lines)

    start = scan_files(args, sess, feeder, stats, on_batch)
    if args.sort_global:
        global_out.sort(key=lambda kv: kv[0])
        for _key, lines in global_out:
            print(lines)
    return report_stats(args, sess, stats, start)


if __name__ == "__main__":
    sys.exit(main())
