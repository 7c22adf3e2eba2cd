"""Match session on one torch device: compiled table + bloom probe +
host verify (port of the reference's ``runtime/session.py``).

This is the reference's default pipeline — ``engine="bloom"``,
``verify="host"``, on-device exact-gram refinement, one device. Each
batch is uploaded (a blocking copy: ``scan_stream`` reuses a host buffer
once ``depth + 1`` batches are in flight), probed by the CUDA kernel (or
its plain PyTorch version on the CPU), refined on the device, and decoded
with at most two transfers: the survivor total, then the bitmap only if
the total is not zero. The native window walker of the reference
(``runtime/verify.py``, shared) turns candidates into exact events.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
queue-1 item): the dense engine, device verify, pattern shards, meshes
and the ushort alphabet.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Iterator, Sequence

import numpy as np
import torch

from tpu_pattern_matching.core.dfa import DfaTable
from tpu_pattern_matching.runtime.buffers import (
    DataBuffer,
    HostBatch,
    StreamState,
)
from tpu_pattern_matching_torch.ops.bloom import BloomHits
from tpu_pattern_matching_torch.utils.device import resolve_device


@dataclasses.dataclass
class MatchEvent:
    """One decoded match: absolute END offset of the occurrence in its file,
    the full pattern-index set ending there, and the representative id.
    ``lane`` is the batch lane it was found in; ``gid`` the match-group id
    (-1 when unknown)."""

    file_id: int
    end_offset: int
    pattern_indices: list[int]
    rep_index: int
    lane: int = -1
    gid: int = -1

    def expand(self) -> Iterator[tuple[int, int]]:
        for p in self.pattern_indices:
            yield (self.end_offset, p)


@dataclasses.dataclass
class BatchMatches:
    """Host-decoded results of one batch."""

    events: list[MatchEvent]
    total: int
    reported: int
    overflowed: bool


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP queue "
        f"1, {item}); use tpu_pattern_matching for it"
    )


class MatchSession:
    def __init__(
        self,
        table: DfaTable,
        max_chunks: int = 1024,
        chunk_len: int = 1024,
        halo: int | None = None,
        sort: bool = False,
        engine: str = "auto",
        bloom_opts: dict | None = None,
        device="cuda",
        bloom_table=None,
        verify: str = "auto",
        mesh=None,
        pat_shards: int = 1,
    ):
        """``device``: ``"cuda"`` (default; raises when there is no GPU),
        ``"cpu"`` (the plain PyTorch versions of the kernels), a
        ``torch.device`` or a CUDA ordinal — never switched silently.

        ``engine``: "bloom", or "auto", which is bloom for byte-alphabet
        tables (the only tables this package takes yet). ``verify``:
        "host" or "auto" (= host). ``bloom_table``: a precompiled filter
        of this package (``BloomFilterTable.load`` or ``from_reference``)
        skips the chooser."""
        from tpu_pattern_matching.runtime.verify import Verifier
        from tpu_pattern_matching.utils.common import pad_halo
        from tpu_pattern_matching.utils.debug import dprint
        from tpu_pattern_matching_torch.ops.bloom import (
            REFINE_HEADROOM,
            BloomFilterTable,
        )
        from tpu_pattern_matching_torch.ops.verify_device import (
            MAX_DEVICE_CAND,
            next_cap,
        )

        if engine not in ("auto", "bloom", "dense"):
            raise ValueError(f"unknown engine {engine!r}")
        if verify not in ("auto", "host", "device"):
            raise ValueError(f"unknown verify mode {verify!r}")
        if pat_shards < 1:
            raise ValueError(f"pat_shards must be >= 1, got {pat_shards}")
        if table.alphabet_size != 256:
            raise _not_ported("the ushort alphabet", "item 8")
        if engine == "dense":
            raise _not_ported("engine='dense'", "item 6")
        if verify == "device":
            raise _not_ported("verify='device'", "item 7")
        if pat_shards > 1:
            raise _not_ported("pat_shards > 1", "item 10")
        if mesh is not None:
            raise _not_ported("mesh=", "item 11")
        self.engine = "bloom"
        self.verify_mode = "host"
        self.device = resolve_device(device)
        self.table = table
        self.max_chunks = max_chunks
        self.chunk_len = chunk_len
        self.sort = sort
        bft = (
            bloom_table
            if bloom_table is not None
            else BloomFilterTable.from_table(table, **(bloom_opts or {}))
        )
        self.bloom_table = bft
        self._bloom = bft.put(self.device)
        self._verifier = Verifier(
            [p.symbols for p in table.patterns],
            alphabet_size=table.alphabet_size,
            q=bft.cfg.q,
            max_pat_len=table.max_pat_len,
            fold_case=bft.cfg.fold_case,
            dense_table=table,  # fast native window walker
        )
        base_halo = (table.max_pat_len - 1) if halo is None else halo
        self.halo = pad_halo(base_halo, chunk_len)
        # batches whose candidates overflowed the refinement capacity
        # (their unrefined bitmap went to the host verifier)
        self.refine_overflows = 0
        if bft.gram_keys is not None and len(bft.gram_keys):
            # refine the survivor bitmap on the device with the exact
            # inserted gram set, so the host walks only true gram
            # occurrences; the capacity comes from the chooser's modeled
            # candidate rate with REFINE_HEADROOM slack
            batch_positions = max_chunks * (self.halo + chunk_len)
            rate = bft.expected_cand_rate()
            k_ref = next_cap(int(min(
                MAX_DEVICE_CAND,
                max(2048, REFINE_HEADROOM * rate * batch_positions),
            )))
            self._bloom.attach_exact(bft.gram_keys, k_ref, bits=bft.gram_bits)
        dprint(1, "session: engine=bloom chunks=%dx%d halo=%d device=%s",
               max_chunks, chunk_len, self.halo, self.device)
        self._groups = table.groups_as_lists()
        self._gid_of_pidset = {
            tuple(sorted(pids)): g for g, pids in enumerate(self._groups)
        }

    # ------------------------------------------------------------- plumbing

    def new_buffer(self) -> DataBuffer:
        return DataBuffer(self.max_chunks, self.chunk_len, self.halo)

    def scan(self, batch: HostBatch) -> BloomHits:
        """Upload one batch (blocking) and run probe + refinement on the
        device; returns the device-resident ``BloomHits``."""
        data = torch.from_numpy(batch.data).to(self.device)
        bounds = torch.from_numpy(
            np.stack([batch.start_t, batch.end_t])
        ).to(self.device)
        return self._bloom.hits(data, bounds)

    def decode(self, batch: HostBatch, comp: BloomHits) -> BatchMatches:
        return self._decode_bloom(batch, comp)

    def _candidate_rows(self, comp: BloomHits):
        """(rows, lanes) of candidate grams from the survivor bitmap."""
        from tpu_pattern_matching_torch.ops.bloom import unpack_hit_rows

        return unpack_hit_rows(
            comp.bits.cpu().numpy(), self.bloom_table.cfg.stride
        )

    def _events_from_arrays(
        self, batch: HostBatch, ln_a, e_a, gid_a
    ) -> list[MatchEvent]:
        """MatchEvents from verified (lane, end, gid) arrays. ``sort``
        applies the canonical (file_id, absolute end_offset) order
        (MATCHING.md "--sort semantics")."""
        file_ids = batch.file_ids
        base_off = batch.base_off
        halo = batch.halo
        if self.sort and len(ln_a):
            end_abs = base_off[ln_a] + e_a - halo
            order = np.lexsort((end_abs, file_ids[ln_a]))
            ln_a, e_a, gid_a = ln_a[order], e_a[order], gid_a[order]
        groups = self._groups
        events = []
        for ln, e, g in zip(ln_a.tolist(), e_a.tolist(), gid_a.tolist()):
            pids = groups[g]
            events.append(
                MatchEvent(
                    file_id=int(file_ids[ln]),
                    end_offset=int(base_off[ln]) + e - halo,
                    pattern_indices=pids,
                    rep_index=pids[0],
                    lane=ln,
                    gid=g,
                )
            )
        return events

    def _batch_total(self, comp: BloomHits) -> int:
        """The survivor total (one device sync); on a refinement overflow
        grow ``k_ref`` so a match-dense stream stops paying full host
        verify every batch (capped at MAX_DEVICE_CAND)."""
        from tpu_pattern_matching.utils.debug import dprint
        from tpu_pattern_matching_torch.ops.verify_device import (
            MAX_DEVICE_CAND,
            next_cap,
        )

        total = int(comp.meta[0])
        bl = self._bloom
        if bl.exact is not None and total > bl.k_ref:
            # the probe passed the unrefined bitmap through (absorbed by
            # the host verify); a refined total never exceeds k_ref, so
            # the check is exact
            self.refine_overflows += 1
            if bl.k_ref < MAX_DEVICE_CAND:
                bl.k_ref = int(min(MAX_DEVICE_CAND, next_cap(total)))
                dprint(1, "bloom refine overflow (%d candidates): k_ref -> %d",
                       total, bl.k_ref)
        return total

    def _verify(self, batch: HostBatch, comp: BloomHits, total: int):
        if total:
            rows, lanes = self._candidate_rows(comp)
        else:
            rows = lanes = np.zeros(0, np.int64)
        return rows, lanes, self._verifier.verify_batch_arrays(
            batch.data, lanes, rows, batch.halo, batch.start_t, batch.end_t
        )

    def _decode_bloom(self, batch: HostBatch, comp: BloomHits) -> BatchMatches:
        """Exact events of one batch: total, then (if not zero) the
        bitmap, then the native window walker over the candidates."""
        total = self._batch_total(comp)
        rows, lanes, arr = self._verify(batch, comp, total)
        events = []
        if arr is not None:
            ln_a, e_a, st_a = arr
            gid_a = self.table.state_gid[st_a]
            events = self._events_from_arrays(batch, ln_a, e_a, gid_a)
        else:  # no native dense walker: tuple fallback
            grouped: dict[tuple[int, int], set[int]] = {}
            for ln, e, pid in self._verifier.verify_batch(
                batch.data, lanes, rows, batch.halo,
                batch.start_t, batch.end_t,
            ):
                grouped.setdefault((ln, e), set()).add(pid)
            for ln, e in grouped.keys():
                pids = sorted(grouped[(ln, e)])
                events.append(
                    MatchEvent(
                        file_id=int(batch.file_ids[ln]),
                        end_offset=int(batch.base_off[ln]) + e - batch.halo,
                        pattern_indices=pids,
                        rep_index=pids[0],
                        lane=ln,
                        gid=self._gid_of_pidset.get(tuple(pids), -1),
                    )
                )
            if self.sort:
                events.sort(key=lambda ev: (ev.file_id, ev.end_offset))
        return BatchMatches(
            events=events,
            total=len(events),
            reported=len(events),
            overflowed=False,
        )

    def decode_counts(
        self, batch: HostBatch, comp: BloomHits
    ) -> tuple[int, np.ndarray]:
        """(total_events, per-group counts [G]) without materializing
        per-event objects: a bincount over the walker's verified rows.
        Like ``decode``, it grows ``k_ref`` on a refinement overflow (the
        reference grows it in ``decode`` only)."""
        G = self.table.num_groups
        total = self._batch_total(comp)
        if not total:
            return 0, np.zeros(G, np.int64)
        _rows, _lanes, arr = self._verify(batch, comp, total)
        if arr is None:
            bm = self._decode_bloom(batch, comp)
            return bm.total, self.event_group_counts(bm)
        ln_a, _e_a, st_a = arr
        gid_a = self.table.state_gid[st_a]
        return len(ln_a), np.bincount(gid_a, minlength=G).astype(np.int64)

    def event_group_counts(self, bm: BatchMatches) -> np.ndarray:
        """Per-group event counts [G] from decoded events."""
        g = np.zeros(self.table.num_groups, np.int64)
        for ev in bm.events:
            if ev.gid >= 0:
                g[ev.gid] += 1
        return g

    # ----------------------------------------------------------- high level

    def scan_stream(
        self,
        fobj,
        file_id: int = 0,
        text_mode: bool = False,
        depth: int = 4,
    ) -> Iterator[BatchMatches]:
        """Scan one stream batch by batch (continuity via halos), keeping
        ``depth`` batches in flight before the first decode; buffers
        rotate, so at most ``depth + 1`` are allocated."""
        from collections import deque

        depth = max(1, depth)
        bufs = [self.new_buffer()]
        cur = 0
        pending: deque[tuple[HostBatch, BloomHits]] = deque()
        stream = StreamState(file_id=file_id)
        while True:
            buf = bufs[cur]
            if text_mode:
                code, rd, _ = buf.add_lines(fobj, stream)
            else:
                code, rd = buf.add_stream(fobj, stream)
            eof = rd == 0 and code != -1
            if eof:
                buf.finalize_stream(stream)
            if buf.chunks and (code == -1 or eof):
                batch = buf.to_batch()
                pending.append((batch, self.scan(batch)))
                if len(pending) > depth:
                    yield self.decode(*pending.popleft())
                if len(bufs) < depth + 1:
                    bufs.append(self.new_buffer())
                cur = (cur + 1) % len(bufs)
                bufs[cur].reset()
            if eof:
                break
        while pending:
            yield self.decode(*pending.popleft())

    def find(
        self, data: bytes, text_mode: bool = False
    ) -> list[tuple[int, int]]:
        """All (end_offset, pattern_index) events in ``data``, sorted —
        the simplest library entry point; equal to the CPU oracle's. The
        bloom engine has no result-slot cap, so nothing can overflow."""
        out: list[tuple[int, int]] = []
        for bm in self.scan_stream(io.BytesIO(data), text_mode=text_mode):
            for ev in bm.events:
                out.extend(ev.expand())
        return sorted(out)


def session_for_patterns(
    patterns: Sequence[bytes], **kw
) -> MatchSession:
    from tpu_pattern_matching.core.dfa import compile_patterns

    return MatchSession(compile_patterns(patterns), **kw)
