"""Packet-metadata (ushort-alphabet) matching mode (port of the reference's
``ushort.py``).

Signatures are sequences of packet metadata (e.g. payload lengths):
``"40,32,287,...; 22; attack name"``; inputs are per-flow files named by
5-tuple whose content is a comma-separated int sequence. The generic DFA
compiler and the port's engines run with ``alphabet_size=2048`` on uint16
token lanes (the uint16 builds of the probe and walk kernels); values >=
the alphabet are clamped to ``alphabet - 1``.

``run_ushort_grep`` streams: flow text parses incrementally into uint16
token lanes (``runtime.buffers.UshortBuffer``, shared with the reference) fed
through the threaded feeder in rounds, and ``-F`` follow mode works on
growing flow files and FIFOs. ``--mesh`` and ``--num-processes`` run it on
the data-parallel mesh as they run the byte CLI.

``compile_signatures`` and ``lanes_from_sequences`` are copies of the
reference's: its module imports the JAX session at its top.
"""

from __future__ import annotations

import sys

import numpy as np

from tpu_pattern_matching_torch.core.dfa import (
    ALPHABET_USHORT,
    AhoCorasick,
    DfaTable,
)
from tpu_pattern_matching_torch.core.patterns import load_signature_file
from tpu_pattern_matching_torch.runtime.buffers import UshortBuffer
from tpu_pattern_matching_torch.runtime.files import expand_paths
from tpu_pattern_matching_torch.runtime.stats import RunStats
from tpu_pattern_matching_torch.utils.common import cdiv
from tpu_pattern_matching_torch.runtime.session import MatchSession


def compile_signatures(path: str, max_tokens: int = 16) -> DfaTable:
    parsed = load_signature_file(path, max_tokens=max_tokens)
    if not parsed:
        raise ValueError(f"no signatures in {path}")
    ac = AhoCorasick(ALPHABET_USHORT)
    for p in parsed:
        seq = tuple(min(v, ALPHABET_USHORT - 1) for v in p.data)
        ac.add_pattern(seq, iid=p.iid, label=p.label)
    return ac.compile()


def lanes_from_sequences(
    seqs: list[tuple[int, np.ndarray]],
    chunk_len: int,
    halo: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Tile per-flow token sequences into uint16 lanes with prefix halos.

    Returns (data [C, halo+B] uint16, start_t, end_t, file_ids, base_off).
    One-shot batch assembly for library/test use; ``run_ushort_grep``
    streams through UshortBuffer instead.
    """
    B, H = chunk_len, halo
    C = sum(max(1, cdiv(len(s), B)) for _, s in seqs)
    data = np.zeros((C, H + B), np.uint16)
    start_t = np.full(C, H, np.int32)
    end_t = np.full(C, H, np.int32)
    file_ids = np.full(C, -1, np.int32)
    base_off = np.zeros(C, np.int64)
    lane = 0
    for fid, s in seqs:
        off = 0
        while off < len(s) or (off == 0 and len(s) == 0):
            part = s[off : off + B]
            hist = s[max(0, off - H) : off]
            data[lane, H - len(hist) : H] = hist
            data[lane, H : H + len(part)] = part
            start_t[lane] = H - len(hist)
            end_t[lane] = H + len(part)
            file_ids[lane] = fid
            base_off[lane] = off
            lane += 1
            off += B
            if len(s) == 0:
                break
    return data, start_t, end_t, file_ids, base_off


def run_ushort_grep(args, device) -> int:
    """Drive the metadata-sequence grep on ``device`` (a ``torch.device``
    the CLI resolved: CUDA, or the CPU with the kernels' plain versions).

    Streaming rounds: flow files feed through UshortBuffer lanes via the
    threaded feeder (batched rounds, follow mode supported), scanned by a
    MatchSession on the chosen engine — ``bloom`` probes the alphabet-2048
    filter and verifies candidates (host walker, or ``--verify device``);
    ``dense`` walks the DFA on the device. "auto" is bloom on a CUDA
    device and dense elsewhere (the reference: bloom on a TPU);
    ``--pat-shards`` > 1 forces bloom (S shard filters, one union
    bitmap). On a mesh (``--mesh``, or the process group the CLI joined
    for ``--num-processes``) each rank reads its own share of the flow
    files (on the grid, each column's leader), the ranks scan in lockstep
    rounds and rank 0 prints the global STATS, as in the byte CLI."""
    from tpu_pattern_matching_torch.cli import (
        mesh_spec,
        rank_feeder,
        report_stats,
        scan_files,
    )

    engine = getattr(args, "engine", "auto")
    if engine == "auto":
        engine = "bloom" if device.type == "cuda" else "dense"
    pat_shards = getattr(args, "pat_shards", 1)
    if pat_shards > 1:  # pattern shards are bloom filters
        engine = "bloom"
    table = compile_signatures(args.pat_path, max_tokens=16)

    filenames = expand_paths(args.data_path)
    if not filenames:
        print("ERROR: Could not open input file(s) for reading.", file=sys.stderr)
        return 2

    B = max(16, args.chunk_size // 2)  # tokens per lane
    sess = MatchSession(
        table,
        max_chunks=args.global_ws,
        chunk_len=B,
        max_results=args.max_results,
        sort=getattr(args, "sort", False),
        engine=engine,
        verify=getattr(args, "verify", "auto"),
        device=device,
        pat_shards=pat_shards,
        mesh=mesh_spec(args),
    )
    feeder = rank_feeder(
        sess,
        filenames,
        n_workers=args.thread_no,
        max_chunks=sess.local_chunks,
        chunk_len=B,
        halo=sess.halo,
        follow=getattr(args, "follow", False),
        buffer_factory=UshortBuffer,
    )

    stats = RunStats(
        files=len(filenames),
        automaton_states=table.num_states,
        automaton_bytes=table.nbytes,
    )

    def on_batch(item, bm):
        if item.batch.chunks:  # not a mesh rank's idle round
            stats.bytes += item.batch.payload_bytes * 2  # uint16 tokens
        if args.verbose:
            for ev in bm.events:
                fname = filenames[ev.file_id]
                for pidx in ev.pattern_indices:
                    pat = table.patterns[pidx]
                    off = ev.end_offset
                    print(
                        f"Pattern {pat.iid} ('{pat.label}') found in file "
                        f"'{fname}' at sequence offset {off - pat.n + 1} "
                        f"[end: {off}]"
                    )

    start = scan_files(args, sess, feeder, stats, on_batch)
    return report_stats(args, sess, stats, start)
