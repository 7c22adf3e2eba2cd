"""Engine selection: the scan-total hook of benchmarks and bake-offs (port
of the reference's ``engine.py``).

- ``bloom`` — the q-gram bloom probe (the CUDA probe kernels on a card)
- ``dense`` — the signed-table DFA walk of every lane (the CUDA lane walk)

``best_scan_total_fn`` returns ``f(data, start_t, end_t) -> int32 scalar``
whose value depends on every lane's scan, so the whole computation must
run, plus the halo the caller must provide. The reference's "auto" is
bloom on a TPU (``on_tpu()``) and dense elsewhere; here the card plays the
TPU's part: bloom on a CUDA device, dense on the CPU.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpu_pattern_matching_torch.core.dfa import DfaTable
from tpu_pattern_matching_torch.utils.common import pad_halo
from tpu_pattern_matching_torch.utils.device import resolve_device


def best_scan_total_fn(
    table: DfaTable,
    max_chunks: int,
    chunk_len: int,
    engine: str = "auto",
    bloom_table=None,
    device="cuda",
) -> tuple[Callable, int]:
    """(scan_total, halo): scan_total(data, start_t, end_t) -> int32 total,
    for a lane-major batch ``data [C, halo + chunk_len]`` and its int32
    lane bounds, all on ``device``.

    ``bloom_table`` (this package's ``BloomFilterTable``, or a
    ``parallel.pshard.ShardedBloom``, whose total is the union's over its
    S shard probes) reuses a prebuilt filter: the chooser's build takes
    tens of seconds at 100k patterns. ``max_chunks`` is accepted for the reference's signature;
    the batch's own shape decides."""
    dev = resolve_device(device)
    if engine == "auto":
        engine = "bloom" if dev.type == "cuda" else "dense"
    halo = pad_halo(table.max_pat_len - 1, chunk_len)

    if engine == "bloom":
        from tpu_pattern_matching_torch.ops.bloom import BloomFilterTable

        bft = (
            bloom_table
            if bloom_table is not None
            else BloomFilterTable.from_table(table)
        )
        db = bft.put(dev)

        def scan_total(data, start_t, end_t):
            return db.probe_total(data, start_t, end_t, halo=halo)

        return scan_total, halo
    if engine != "dense":
        raise ValueError(f"unknown engine {engine!r}")

    from tpu_pattern_matching_torch.ops.match_xla import dense_walk
    from tpu_pattern_matching_torch.ops.table import DeviceTable

    dt = DeviceTable.put(table, dev)

    def scan_total(data, start_t, end_t):
        counts, *_ = dense_walk(
            dt.table_flat, data.t().contiguous(),
            torch.stack([start_t, end_t]).to(torch.int32),
            alphabet_size=dt.alphabet_size, halo=halo, max_results=16,
            max_pat_len=dt.max_pat_len,
        )
        return counts.sum().to(torch.int32)

    return scan_total, halo
