"""Match session on one torch device (port of the reference's
``runtime/session.py``): compiled table + device engine + result decoding.

Three single-device pipelines, as in the reference:

- ``engine="bloom"``, ``verify="host"`` (the default): each batch is
  uploaded (a blocking copy: ``scan_stream`` reuses a host buffer once
  ``depth + 1`` batches are in flight), probed by the CUDA kernel (or its
  plain PyTorch version on the CPU), refined on the device with the exact
  gram set, and decoded with at most two transfers: the survivor total,
  then the bitmap only if the total is not zero. The reference's native
  window walker (``runtime/verify.py``, shared) turns candidates into
  exact events.
- ``engine="bloom"``, ``verify="device"``: the probe's candidates are
  refined, walked and compacted into exact events on the device
  (``ops/verify_device.py``, the walk-and-emit kernel); a batch past
  ``MAX_DEVICE_CAND`` candidates is verified there in several passes.
- ``engine="dense"``: every lane walks the whole DFA on the device
  (``ops/match_xla.py``, the dense-walk kernel) and the per-lane result
  slots compact into match tuples (``ops/compact.py``).

Byte tables (alphabet 256) run on uint8 lanes; ushort tables (alphabet
2048, packet metadata) on uint16 token lanes (``UshortBuffer``, which
parses flow text), with 11-bit exact-gram keys, through the same three
pipelines and the uint16 builds of the kernels.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
queue-1 item): pattern shards and meshes.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Iterator, Sequence

import numpy as np
import torch

from tpu_pattern_matching_torch.core.dfa import DfaTable
from tpu_pattern_matching_torch.runtime.buffers import (
    DataBuffer,
    HostBatch,
    StreamState,
    UshortBuffer,
)
from tpu_pattern_matching_torch.ops.bloom import BloomHits
from tpu_pattern_matching_torch.ops.compact import (
    CompactMatches,
    per_group_counts,
)
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
        max_results: int = 16,
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

        ``engine``: "bloom" (q-gram bloom probe + exact verify), "dense"
        (the exact DFA walk of every lane on the device, with
        ``max_results`` result slots per lane and exact counts past
        them), or "auto". The reference's "auto" is bloom for byte tables
        on a TPU (``on_tpu()``) and dense elsewhere; here the card plays
        the TPU's part, and "auto" is bloom for byte tables on any
        device (the CPU runs the kernels' plain versions) and dense for
        ushort tables, as in the reference.

        ``verify`` (bloom engine; "n/a" for dense): "host" (native window
        walker on the CPU), "device" (window walk on the device: exact
        events and per-group counts; a batch past ``MAX_DEVICE_CAND``
        candidates is verified in passes over ranges of lanes), or
        "auto" (= host).
        ``bloom_table``: a precompiled filter of this package
        (``BloomFilterTable.load`` or ``from_reference``) skips the
        chooser."""
        from tpu_pattern_matching_torch.runtime.verify import Verifier
        from tpu_pattern_matching_torch.utils.common import pad_halo
        from tpu_pattern_matching_torch.utils.debug import dprint
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
        if pat_shards > 1:
            raise _not_ported("pat_shards > 1", "item 10")
        if mesh is not None:
            raise _not_ported("mesh=", "item 11")
        if engine == "auto":
            engine = "bloom" if table.alphabet_size == 256 else "dense"
        self.engine = engine
        self.verify_mode = (
            "host" if verify == "auto" else verify
        ) if engine == "bloom" else "n/a"
        self.device = resolve_device(device)
        self.table = table
        self.max_chunks = max_chunks
        self.chunk_len = chunk_len
        self.max_results = max_results
        self.sort = sort
        base_halo = (table.max_pat_len - 1) if halo is None else halo
        self.halo = pad_halo(base_halo, chunk_len)
        # batches whose candidates overflowed the refinement capacity
        # (their unrefined bitmap went to the host verifier)
        self.refine_overflows = 0
        self._bloom = self._verifier = self._dvf = self.dev = None
        self.bloom_table = None
        self._groups = table.groups_as_lists()
        self._gid_of_pidset = {
            tuple(sorted(pids)): g for g, pids in enumerate(self._groups)
        }
        if engine == "dense":
            from tpu_pattern_matching_torch.ops.table import DeviceTable

            self.dev = DeviceTable.put(table, self.device)
            dprint(1, "session: engine=dense chunks=%dx%d halo=%d device=%s",
                   max_chunks, chunk_len, self.halo, self.device)
            return
        bft = (
            bloom_table
            if bloom_table is not None
            else BloomFilterTable.from_table(table, **(bloom_opts or {}))
        )
        self.bloom_table = bft
        self._bloom = bft.put(self.device)
        if self.verify_mode == "device":
            from tpu_pattern_matching_torch.ops.verify_device import (
                DeviceVerifier,
            )

            # the verify stage refines its own candidates: the probe
            # attaches no refinement of its own
            self._dvf = DeviceVerifier(table, bft.cfg, self.halo,
                                       self.device, gram_keys=bft.gram_keys)
        else:
            self._verifier = Verifier(
                [p.symbols for p in table.patterns],
                alphabet_size=table.alphabet_size,
                q=bft.cfg.q,
                max_pat_len=table.max_pat_len,
                fold_case=bft.cfg.fold_case,
                dense_table=table,  # fast native window walker
            )
            if bft.gram_keys is not None and len(bft.gram_keys):
                # refine the survivor bitmap on the device with the exact
                # inserted gram set, so the host walks only true gram
                # occurrences; the capacity comes from the chooser's
                # modeled candidate rate with REFINE_HEADROOM slack
                batch_positions = max_chunks * (self.halo + chunk_len)
                rate = bft.expected_cand_rate()
                k_ref = next_cap(int(min(
                    MAX_DEVICE_CAND,
                    max(2048, REFINE_HEADROOM * rate * batch_positions),
                )))
                self._bloom.attach_exact(bft.gram_keys, k_ref,
                                         bits=bft.gram_bits)
        dprint(1, "session: engine=bloom verify=%s chunks=%dx%d halo=%d "
               "device=%s", self.verify_mode, max_chunks, chunk_len,
               self.halo, self.device)

    # ------------------------------------------------------------- plumbing

    def new_buffer(self) -> DataBuffer:
        """A batch buffer of this session's symbol width: the byte
        ``DataBuffer`` (binary or text) for byte tables, the token-parsing
        ``UshortBuffer`` (flow text -> uint16 lanes) for ushort tables."""
        if self.table.alphabet_size != 256:
            return UshortBuffer(self.max_chunks, self.chunk_len, self.halo)
        return DataBuffer(self.max_chunks, self.chunk_len, self.halo)

    def scan(self, batch: HostBatch):
        """Upload one batch (blocking) and run the device engine: probe +
        refinement (``BloomHits``; with device verify it keeps the
        uploaded arrays for the verify stage) or the dense walk +
        compaction (``CompactMatches``)."""
        from tpu_pattern_matching_torch.ops.compact import scan_and_compact

        data = torch.from_numpy(batch.data).to(self.device)
        bounds = torch.from_numpy(
            np.stack([batch.start_t, batch.end_t])
        ).to(self.device)
        if self.dev is not None:
            return scan_and_compact(
                self.dev, data, bounds, halo=batch.halo,
                max_results=self.max_results, sort=self.sort,
                chunk_len=self.chunk_len,
            )
        h = self._bloom.hits(data, bounds)
        if self._dvf is not None:
            h.data, h.bounds = data, bounds
        return h

    def decode(self, batch: HostBatch, comp) -> BatchMatches:
        """Exact events of one batch; for the dense engine at most two
        transfers: ``meta``, then the packed tuples only when matches
        exist."""
        if isinstance(comp, BloomHits):
            return self._decode_bloom(batch, comp)
        total, reported = (int(x) for x in comp.meta.cpu())
        events = []
        if reported:
            # fetch a power-of-two bucket >= reported: the transfer stays
            # proportional to the matches
            bucket = 256
            while bucket < reported:
                bucket *= 2
            lane, pos, _state, gid, _rep = (
                comp.packed[:, : min(bucket, comp.packed.shape[1])]
                .cpu().numpy()[:, :reported].tolist()
            )
            groups = self._groups
            for ln, p, g in zip(lane, pos, gid):
                pids = groups[g]
                events.append(
                    MatchEvent(
                        file_id=int(batch.file_ids[ln]),
                        end_offset=int(batch.base_off[ln]) + p,
                        pattern_indices=pids,
                        rep_index=pids[0],
                        lane=ln,
                        gid=g,
                    )
                )
            if self.sort:
                # canonical order (MATCHING.md "--sort semantics"), the
                # same key as the bloom engine's
                events.sort(key=lambda ev: (ev.file_id, ev.end_offset))
        return BatchMatches(
            events=events,
            total=total,
            reported=reported,
            overflowed=total > reported,
        )

    def scan_and_decode(self, batch: HostBatch) -> BatchMatches:
        """``decode(batch, scan(batch))``: one batch's events."""
        return self.decode(batch, self.scan(batch))

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
        from tpu_pattern_matching_torch.utils.debug import dprint
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
        device verify stage's events, or the bitmap and the native window
        walker over its candidates."""
        total = self._batch_total(comp)
        events = []
        if self._dvf is not None:
            if total:
                _meta, (ln_a, e_a, st_a), _gc = self._dvf.verify(
                    comp.data, comp.bounds, comp.bits, total)
                gid_a = self.table.state_gid[st_a]
                events = self._events_from_arrays(batch, ln_a, e_a, gid_a)
            return BatchMatches(
                events=events,
                total=len(events),
                reported=len(events),
                overflowed=False,
            )
        rows, lanes, arr = self._verify(batch, comp, total)
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
        self, batch: HostBatch, comp
    ) -> tuple[int, np.ndarray]:
        """(total_events, per-group counts [G]) without materializing
        per-event objects. Dense: the in-walk gcounts, exact past slot
        overflow. Device verify: the gcounts of the verify stage. Host
        verify: a bincount over the walker's verified rows; like
        ``decode``, it grows ``k_ref`` on a refinement overflow (the
        reference grows it in ``decode`` only)."""
        G = self.table.num_groups
        if isinstance(comp, CompactMatches):
            return int(comp.meta[0]), per_group_counts(
                self.dev, comp).cpu().numpy().astype(np.int64)
        total = self._batch_total(comp)
        if not total:
            return 0, np.zeros(G, np.int64)
        if self._dvf is not None:
            meta, _packed, gc = self._dvf.verify(comp.data, comp.bounds,
                                                 comp.bits, total)
            return int(meta[0]), gc.astype(np.int64)
        _rows, _lanes, arr = self._verify(batch, comp, total)
        if arr is None:
            bm = self._decode_bloom(batch, comp)
            return bm.total, self.event_group_counts(bm)
        ln_a, _e_a, st_a = arr
        gid_a = self.table.state_gid[st_a]
        return len(ln_a), np.bincount(gid_a, minlength=G).astype(np.int64)

    def group_counts(self, comp: CompactMatches) -> np.ndarray:
        """Device-side per-group counts (dense engine); bloom sessions
        count verified events instead — use decode_counts or
        event_group_counts."""
        if self.dev is None:
            raise ValueError(
                "group_counts needs the dense engine; bloom sessions "
                "count via decode_counts/event_group_counts"
            )
        return per_group_counts(self.dev, comp).cpu().numpy()

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
        pending: deque[tuple[HostBatch, object]] = deque()
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
        the simplest library entry point; equal to the CPU oracle's. For
        ushort tables ``data`` is flow text (comma- or space-separated
        tokens) and offsets count tokens.

        Raises if the dense engine's per-lane result slots overflow (raise
        ``max_results`` or use the bloom engine, which has no slot cap):
        a partial answer would be silent loss. ``scan_stream`` consumers
        read ``BatchMatches.overflowed`` themselves."""
        out: list[tuple[int, int]] = []
        for bm in self.scan_stream(io.BytesIO(data), text_mode=text_mode):
            if bm.overflowed:
                raise RuntimeError(
                    f"result slots overflowed ({bm.total - bm.reported} "
                    f"events dropped in one batch): raise max_results "
                    f"(currently {self.max_results}) or use the bloom "
                    f"engine (no capacity cap)"
                )
            for ev in bm.events:
                out.extend(ev.expand())
        return sorted(out)


def session_for_patterns(
    patterns: Sequence[bytes], **kw
) -> MatchSession:
    from tpu_pattern_matching_torch.core.dfa import compile_patterns

    return MatchSession(compile_patterns(patterns), **kw)
