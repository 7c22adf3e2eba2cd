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

``pat_shards=S`` (bloom engine) partitions the pattern set into S shard
filters under one config (``parallel/pshard.py``): the S probes OR into
one union bitmap on the device, which either verify stage walks as it
walks one filter's. As in the reference, the union bitmap is not refined
on the device: the host verifier walks it as probed.

``mesh=`` (``parallel/mesh.py``) runs the bloom engine (host or device
verify) and the dense engine on a ``torch.distributed`` data-parallel
mesh: each rank owns one device and ``local_chunks`` lanes of the global
batch, feeds and decodes only those, and the totals are reduced over the
ranks. With ``pat_shards > 1`` as well it is the ("pat", "data") grid
(``parallel/pshard.py``): each rank holds one pattern shard of one data
column, the column's leader feeds and decodes the column's lanes, and
its followers return no events.
"""

from __future__ import annotations

import dataclasses
import io
import time
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
from tpu_pattern_matching_torch.parallel.mesh import MeshDenseMatches
from tpu_pattern_matching_torch.runtime.tracing import RECORDER
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


def placement_device(sharding, device):
    """The device a session places on, given the reference's ``sharding``
    argument: None keeps ``device``; a ``torch.device`` replaces the
    default ``"cuda"`` and must otherwise name the same device."""
    if sharding is None:
        return device
    if not isinstance(sharding, torch.device):
        raise TypeError(
            f"sharding must be None or a torch.device, got "
            f"{type(sharding).__name__}")
    if isinstance(device, str) and device == "cuda":
        return sharding
    dev = (torch.device("cuda", device) if isinstance(device, int)
           else torch.device(device))
    if dev.type != sharding.type or (
            dev.type == "cuda"
            and resolve_device(dev) != resolve_device(sharding)):
        raise ValueError(
            f"sharding={sharding} contradicts device={device!r}")
    return device


class MatchSession:
    def __init__(
        self,
        table: DfaTable,
        max_chunks: int = 1024,
        chunk_len: int = 1024,
        max_results: int = 16,
        halo: int | None = None,
        sharding=None,
        sort: bool = False,
        engine: str = "auto",
        bloom_opts: dict | None = None,
        mesh=None,
        device="cuda",
        bloom_table=None,
        verify: str = "auto",
        pat_shards: int = 1,
    ):
        """The parameters are the reference's, in its order.

        ``device``: ``"cuda"`` (default; raises when there is no GPU),
        ``"cpu"`` (the plain PyTorch versions of the kernels), a
        ``torch.device`` or a CUDA ordinal — never switched silently.
        ``sharding`` (the reference's placement of a batch) is None or a
        ``torch.device``: the placement device when ``device`` is left at
        its default, and a ``ValueError`` when it names another device
        than ``device``.

        ``engine``: "bloom" (q-gram bloom probe + exact verify), "dense"
        (the exact DFA walk of every lane on the device, with
        ``max_results`` result slots per lane and exact counts past
        them; every slot of a batch comes back, where the reference keeps
        8192 tuples a batch, ROADMAP queue 3), or "auto". The reference's
        "auto" is bloom for byte tables on a TPU (``on_tpu()``) and
        dense elsewhere; here the card plays the TPU's part, and "auto"
        is bloom for byte tables on any device (the CPU runs the
        kernels' plain versions) and dense for ushort tables, as in the
        reference.

        ``verify`` (bloom engine; "n/a" for dense): "host" (native window
        walker on the CPU), "device" (window walk on the device: exact
        events and per-group counts; a batch past ``MAX_DEVICE_CAND``
        candidates is verified in passes over ranges of lanes), or
        "auto" (= host).
        ``bloom_table``: a precompiled filter of this package
        (``BloomFilterTable`` or ``parallel.pshard.ShardedBloom``, built,
        loaded or ``from_reference``) skips the chooser.

        ``pat_shards=S`` partitions the PATTERN SET into S balanced
        shards, each with its own smaller bloom filter under one common
        config (``parallel/pshard.py``) — the capacity axis for 300k+
        pattern sets, where a single filter saturates. The S probes OR
        into one bitmap on the device, so decode and verify see one union
        bitmap and events are IDENTICAL to the unsharded engine's. Bloom
        engine only; inferred from a precompiled ``ShardedBloom``.

        ``mesh`` turns on the data-parallel path (``parallel/mesh.py``):
        a ``MeshContext``, ``"all"``/``"auto"``/``True`` (the initialized
        ``torch.distributed`` world, or a 1-rank group made here), or an
        int equal to the world size. This rank runs on its own device
        (``device``; ``"cuda"`` without an ordinal is ``cuda:(rank %
        device_count)``) over its own ``local_chunks`` lanes, the filter
        or table replicated. ``max_chunks`` is the GLOBAL batch, rounded
        up to ``world * 128`` lanes (bloom) or ``world`` (dense). Events
        are this rank's; ``BatchMatches.total`` is global where the
        reference's is (dense, device verify) and this rank's with host
        verify. Every rank must call ``scan``/``decode`` in lockstep (an
        idle rank scans an empty batch).

        ``mesh`` with ``pat_shards=S > 1`` (or a
        ``parallel.pshard.Mesh2DContext``) is the ("pat", "data") grid of
        W = S x D ranks (``W % S != 0`` raises ValueError): rank r holds
        pattern shard ``r % S`` of data column ``r // S``, ``max_chunks``
        is rounded up to ``D * 128`` lanes and a column's ``local_chunks``
        are fed by its leader (``r % S == 0``): a follower's batch is only
        a shape. Only leaders return events; a follower's ``total`` is 0
        where the reference's is this process's (host verify)."""
        from tpu_pattern_matching_torch.parallel.pshard import (
            Mesh2DContext,
            ShardedBloom,
        )
        from tpu_pattern_matching_torch.runtime.verify import Verifier
        from tpu_pattern_matching_torch.utils.common import pad_halo, roundup
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
        device = placement_device(sharding, device)
        if isinstance(bloom_table, ShardedBloom):
            if pat_shards not in (1, bloom_table.n_shards):
                raise ValueError(
                    f"pat_shards={pat_shards} but the precompiled filter "
                    f"has {bloom_table.n_shards} shards"
                )
            pat_shards = bloom_table.n_shards
        if pat_shards < 1:
            raise ValueError(f"pat_shards must be >= 1, got {pat_shards}")
        if isinstance(mesh, Mesh2DContext):
            if pat_shards not in (1, mesh.n_shards):
                raise ValueError(
                    f"pat_shards={pat_shards} but the grid has "
                    f"{mesh.n_shards} shards")
            pat_shards = mesh.n_shards
        if engine == "auto":
            engine = "bloom" if table.alphabet_size == 256 else "dense"
        if pat_shards > 1 and engine != "bloom":
            raise ValueError(
                "pat_shards applies to the bloom engine (the dense walk "
                "has no filter to shard); pass engine='bloom'"
            )
        self.pat_shards = pat_shards
        self.engine = engine
        self.verify_mode = (
            "host" if verify == "auto" else verify
        ) if engine == "bloom" else "n/a"
        self._mesh_ctx = ctx = self._grid = None
        if mesh is not None:
            from tpu_pattern_matching_torch.parallel.mesh import (
                as_mesh_context,
            )

            if isinstance(mesh, Mesh2DContext):
                self._grid = mesh
            elif pat_shards > 1:
                self._grid = Mesh2DContext.build(
                    as_mesh_context(mesh, device), pat_shards)
            ctx = self._mesh_ctx = (self._grid.world if self._grid
                                    else as_mesh_context(mesh, device))
            # a rank's lanes stay 128-aligned for the bloom bitmap's
            # column -> lane mapping (parallel.mesh.check_lanes); dense
            # lanes just divide evenly
            max_chunks = roundup(max_chunks, self._columns * (
                128 if engine == "bloom" else 1))
            self.device = ctx.device
        else:
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
        self._bloom_step = self._dense_step = None
        self.bloom_table = None
        self._groups = table.groups_as_lists()
        self._gid_of_pidset = {
            tuple(sorted(pids)): g for g, pids in enumerate(self._groups)
        }
        if engine == "dense":
            from tpu_pattern_matching_torch.ops.table import DeviceTable

            self.dev = DeviceTable.put(table, self.device)
            # every result slot of the rank's lanes, with or without a
            # mesh: the reference's 8192-tuple cap is not kept (ROADMAP
            # queue 3)
            self._dense_capacity = self.local_chunks * max_results
            if ctx is not None:
                from tpu_pattern_matching_torch.parallel.mesh import (
                    make_sharded_dense_step,
                )

                self._dense_step = make_sharded_dense_step(
                    ctx, self.dev, halo=self.halo, max_results=max_results,
                    num_groups=table.num_groups,
                    capacity=self._dense_capacity)
            dprint(1, "session: engine=dense chunks=%dx%d halo=%d device=%s "
                   "mesh=%s", max_chunks, chunk_len, self.halo, self.device,
                   ctx)
            return
        if bloom_table is not None:
            bft = bloom_table
        elif pat_shards > 1:
            bft = ShardedBloom.from_table(table, pat_shards,
                                          **(bloom_opts or {}))
        else:
            bft = BloomFilterTable.from_table(table, **(bloom_opts or {}))
        self.bloom_table = bft
        grid = self._grid
        if grid is not None:
            from tpu_pattern_matching_torch.parallel.pshard import (
                make_pattern_sharded_bloom_step,
            )

            if not isinstance(bft, ShardedBloom):
                raise ValueError("the grid needs a pattern-sharded filter "
                                 "(ShardedBloom), not a flat one")
            # this rank's shard alone: 1/S of the filter
            self._bloom = bft.put_shard(grid.pat_index, self.device)
            self._bloom_step = make_pattern_sharded_bloom_step(
                grid, self._bloom)
        else:
            self._bloom = bft.put(self.device)
            if ctx is not None:
                from tpu_pattern_matching_torch.parallel.mesh import (
                    make_sharded_bloom_step,
                )

                self._bloom_step = make_sharded_bloom_step(ctx, self._bloom)
        if self.verify_mode == "device" and grid is not None:
            from tpu_pattern_matching_torch.parallel.pshard import (
                PshardDeviceVerifier,
                shard_table,
            )

            # only this rank's shard table is built: its 1/S of the
            # global one, walked against the column's union bitmap
            self._dvf = PshardDeviceVerifier(
                grid, bft,
                shard_table(table, bft.parts[grid.pat_index]), self.halo)
        elif self.verify_mode == "device":
            from tpu_pattern_matching_torch.ops.verify_device import (
                DeviceVerifier,
            )

            # the verify stage refines its own candidates: the probe
            # attaches no refinement of its own
            self._dvf = DeviceVerifier(table, bft.cfg, self.halo,
                                       self.device, gram_keys=bft.gram_keys,
                                       mesh=ctx)
        elif grid is None or grid.is_leader:  # a follower never decodes
            self._verifier = Verifier(
                [p.symbols for p in table.patterns],
                alphabet_size=table.alphabet_size,
                q=bft.cfg.q,
                max_pat_len=table.max_pat_len,
                fold_case=bft.cfg.fold_case,
                dense_table=table,  # fast native window walker
            )
            if (ctx is None and not isinstance(bft, ShardedBloom)
                    and bft.gram_keys is not None and len(bft.gram_keys)):
                # refine the survivor bitmap on the device with the exact
                # inserted gram set, so the host walks only true gram
                # occurrences; the capacity comes from the chooser's
                # modeled candidate rate with REFINE_HEADROOM slack. A
                # sharded filter's union bitmap, and a mesh's bitmap, go
                # to the host as probed, as in the reference
                batch_positions = max_chunks * (self.halo + chunk_len)
                rate = bft.expected_cand_rate()
                k_ref = next_cap(int(min(
                    MAX_DEVICE_CAND,
                    max(2048, REFINE_HEADROOM * rate * batch_positions),
                )))
                self._bloom.attach_exact(bft.gram_keys, k_ref,
                                         bits=bft.gram_bits)
        dprint(1, "session: engine=bloom verify=%s pat_shards=%d "
               "chunks=%dx%d halo=%d device=%s mesh=%s", self.verify_mode,
               pat_shards, max_chunks, chunk_len, self.halo, self.device,
               ctx)

    # ------------------------------------------------------------- plumbing

    @property
    def _columns(self) -> int:
        """The lane shards of a batch: 1 without a mesh, the world size
        on the data mesh, D on the grid (a column's S ranks share one)."""
        if self._grid is not None:
            return self._grid.data_size
        return self._mesh_ctx.world_size if self._mesh_ctx else 1

    @property
    def local_chunks(self) -> int:
        """Lanes THIS RANK feeds per batch: ``max_chunks`` without a mesh,
        ``max_chunks // world`` on one (each rank assembles only its own
        lane shard, from its own input files), ``max_chunks // D`` on the
        grid (the column's lanes, fed by its leader)."""
        return self.max_chunks // self._columns

    @property
    def global_totals(self) -> bool:
        """Whether ``BatchMatches.total`` counts every rank's events (the
        mesh's dense and device-verify paths) rather than this rank's."""
        return self._mesh_ctx is not None and self.verify_mode != "host"

    def new_buffer(self) -> DataBuffer:
        """A batch buffer of this session's symbol width: the byte
        ``DataBuffer`` (binary or text) for byte tables, the token-parsing
        ``UshortBuffer`` (flow text -> uint16 lanes) for ushort tables.
        Sized to this rank's lanes (``local_chunks``)."""
        if self.table.alphabet_size != 256:
            return UshortBuffer(self.local_chunks, self.chunk_len, self.halo)
        return DataBuffer(self.local_chunks, self.chunk_len, self.halo)

    def scan(self, batch: HostBatch):
        """Upload one batch (blocking) and run the device engine: probe +
        refinement (``BloomHits``; with device verify it keeps the
        uploaded arrays for the verify stage) or the dense walk +
        compaction (``CompactMatches``). On a mesh ``batch`` is this
        rank's lane shard, the probe's ``meta`` is ``[global total, max
        per-rank total]`` and the dense step gives ``MeshDenseMatches``.
        On the grid the column leader's ``batch`` is broadcast over the
        column, and ``bits`` are the column's union.

        Spans: ``scan`` > ``scan.upload``, ``scan.probe``; the result
        carries the scan's start for ``decode``'s ``batch`` span."""
        seq = getattr(batch, "seq", -1)
        work = batch.symbols
        with RECORDER.span("scan", seq, work) as sp:
            with RECORDER.span("scan.upload", work=work):
                data = torch.from_numpy(batch.data).to(self.device)
                bounds = torch.from_numpy(
                    np.stack([batch.start_t, batch.end_t])
                ).to(self.device)
                if self._grid is not None:  # the column's leader feeds
                    # its lanes as bytes: neither gloo nor NCCL has uint16
                    self._grid.col.broadcast(data.view(torch.uint8))
                    self._grid.col.broadcast(bounds)
            with RECORDER.span("scan.probe", work=work):
                comp = self._scan_on_device(batch, data, bounds)
        comp.scan_t0 = sp.t0
        return comp

    def _scan_on_device(self, batch: HostBatch, data, bounds):
        """The device engine on one uploaded batch (``scan``)."""
        from tpu_pattern_matching_torch.ops.compact import scan_and_compact

        if self._dense_step is not None:
            return self._dense_step(data, bounds)
        if self.dev is not None:
            return scan_and_compact(
                self.dev, data, bounds, halo=batch.halo,
                max_results=self.max_results,
                capacity=self._dense_capacity, sort=self.sort,
                chunk_len=self.chunk_len,
            )
        if self._bloom_step is not None:
            meta, bits = self._bloom_step(self._bloom.words, data, bounds)
            h = BloomHits(meta=meta, bits=bits)
        else:
            h = self._bloom.hits(data, bounds)
        if self._dvf is not None:
            h.data, h.bounds = data, bounds
        return h

    def decode(self, batch: HostBatch, comp) -> BatchMatches:
        """Exact events of one batch; for the dense engine at most two
        transfers: ``meta``, then the packed tuples only when matches
        exist.

        Spans: ``decode`` > ``decode.sync``, ``decode.rows``,
        ``decode.verify``, ``decode.events``; then ``batch``, from the
        batch's ``scan`` start to here."""
        seq = getattr(batch, "seq", -1)
        work = batch.symbols
        with RECORDER.span("decode", seq, work):
            bm = self._decode(batch, comp)
        t0 = getattr(comp, "scan_t0", None)
        if t0 is not None:
            RECORDER.record("batch", t0, time.perf_counter_ns(), seq, work)
        return bm

    def _decode(self, batch: HostBatch, comp) -> BatchMatches:
        if isinstance(comp, BloomHits):
            return self._decode_bloom(batch, comp)
        if isinstance(comp, MeshDenseMatches):
            return self._decode_dense_mesh(batch, comp)
        with RECORDER.span("decode.sync"):
            total, reported = (int(x) for x in comp.meta.cpu())
        with RECORDER.span("decode.events"):
            events = self._dense_events(batch, comp.packed, reported)
        RECORDER.add("verify.events", len(events))
        return BatchMatches(
            events=events,
            total=total,
            reported=reported,
            overflowed=total > reported,
        )

    def _dense_events(self, batch: HostBatch, packed, reported: int
                      ) -> list[MatchEvent]:
        """MatchEvents of the first ``reported`` compacted dense tuples
        ``packed [5, K]`` (lane, pos, state, gid, rep_pid): one transfer
        of a power-of-two bucket >= reported (proportional to the
        matches), then the array-driven ``_events_from_arrays`` (a
        tuple's ``pos`` is its end past the halo)."""
        if not reported:
            return []
        bucket = 256
        while bucket < reported:
            bucket *= 2
        lane, pos, _state, gid, _rep = (
            packed[:, : min(bucket, packed.shape[1])].cpu().numpy()
            [:, :reported].astype(np.int64))
        return self._events_from_arrays(batch, lane, pos + batch.halo, gid)

    def _decode_dense_mesh(self, batch: HostBatch,
                           comp: MeshDenseMatches) -> BatchMatches:
        """This rank's events from its own compacted tuples (lanes are
        local already) in array form; the total is global, as in the
        reference."""
        g_total, g_rep, _l_total, l_rep = (int(x) for x in comp.metas.cpu())
        events = self._dense_events(batch, comp.packed, l_rep)
        return BatchMatches(
            events=events,  # this rank's lanes
            total=g_total,  # exact GLOBAL count (slot overflow included)
            reported=len(events),
            overflowed=g_total > g_rep,
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

        with RECORDER.span("decode.sync"):
            total = int(comp.meta[0])
        bl = self._bloom
        if bl.exact is not None and total > bl.k_ref:
            # the probe passed the unrefined bitmap through (absorbed by
            # the host verify); a refined total never exceeds k_ref, so
            # the check is exact
            self.refine_overflows += 1
            RECORDER.add("refine.overflows")
            if bl.k_ref < MAX_DEVICE_CAND:
                bl.k_ref = int(min(MAX_DEVICE_CAND, next_cap(total)))
                dprint(1, "bloom refine overflow (%d candidates): k_ref -> %d",
                       total, bl.k_ref)
        return total

    def _verify(self, batch: HostBatch, comp: BloomHits, total: int):
        with RECORDER.span("decode.rows"):
            if total:
                rows, lanes = self._candidate_rows(comp)
            else:
                rows = lanes = np.zeros(0, np.int64)
        RECORDER.add("verify.candidates", len(rows))
        with RECORDER.span("decode.verify", work=len(rows)):
            arr = self._verifier.verify_batch_arrays(
                batch.data, lanes, rows, batch.halo, batch.start_t,
                batch.end_t)
        return rows, lanes, arr

    def _device_verify(self, comp: BloomHits, total: int):
        """The device verify stage of one batch: ``(meta, (lanes, ends,
        states), gcounts)``. On a mesh every rank calls it together, with
        the probe's largest per-rank total, and ``meta[0]`` (the events)
        and ``gcounts`` are sums over the ranks."""
        if self._mesh_ctx is not None:
            total = int(comp.meta[1])
        return self._dvf.verify(comp.data, comp.bounds, comp.bits, total)

    def _grid_events(self, comp: BloomHits):
        """The grid's device verify of one batch, every rank calling it
        together with the probe's largest column total: on the column's
        leader its merged events as ``(lanes, ends, pattern id lists,
        global group ids)`` (``merge_shard_rows``), empty on a
        follower."""
        from tpu_pattern_matching_torch.parallel.pshard import (
            merge_shard_rows,
        )

        sh, ln, e, g, _gc = self._dvf.verify_rows(
            comp.data, comp.bounds, comp.bits, int(comp.meta[1]))
        ln_a, e_a, bounds, pids = merge_shard_rows(sh, ln, e, g,
                                                   self._dvf.shard_groups)
        pid_l = pids.tolist()
        sets = [pid_l[bounds[i]:bounds[i + 1]] for i in range(len(ln_a))]
        gid_a = np.array([self._gid_of_pidset.get(tuple(p), -1)
                          for p in sets], np.int64)
        return ln_a, e_a, sets, gid_a

    def _merge_pshard_events(self, batch: HostBatch, ln_a, e_a, sets,
                             gid_a) -> list[MatchEvent]:
        """MatchEvents of the grid's merged events (``_grid_events``):
        event i at lane ``ln_a[i]``, row ``e_a[i]``, with the global
        co-terminating set ``sets[i]`` and its group ``gid_a[i]``."""
        file_ids, base_off, halo = batch.file_ids, batch.base_off, batch.halo
        order = range(len(ln_a))
        if self.sort and len(ln_a):  # canonical order (MATCHING.md)
            order = np.lexsort((base_off[ln_a] + e_a - halo,
                                file_ids[ln_a])).tolist()
        events = []
        for i in order:
            ln = int(ln_a[i])
            events.append(MatchEvent(
                file_id=int(file_ids[ln]),
                end_offset=int(base_off[ln]) + int(e_a[i]) - halo,
                pattern_indices=sets[i],
                rep_index=sets[i][0],
                lane=ln,
                gid=int(gid_a[i]),
            ))
        return events

    def _decode_bloom(self, batch: HostBatch, comp: BloomHits) -> BatchMatches:
        """Exact events of one batch: total, then (if not zero) the
        device verify stage's events, or the bitmap and the native window
        walker over its candidates. On the grid a follower returns none."""
        total = self._batch_total(comp)
        events = []
        if self._grid is not None and self._dvf is not None:
            from tpu_pattern_matching_torch.parallel.mesh import (
                allreduce_host_counts,
            )

            n_ev = 0
            if total:  # the global total: every rank verifies
                events = self._merge_pshard_events(batch,
                                                   *self._grid_events(comp))
                n_ev = int(allreduce_host_counts(
                    np.array([len(events)], np.int64), self._mesh_ctx)[0])
            return BatchMatches(
                events=events,  # the column's, on its leader
                total=n_ev,  # every column's
                reported=len(events),
                overflowed=False,
            )
        if self._grid is not None and not self._grid.is_leader:
            return BatchMatches(events=[], total=0, reported=0,
                                overflowed=False)
        if self._dvf is not None:
            n_ev = 0
            if total:  # on a mesh the global total: every rank verifies
                with RECORDER.span("decode.verify", work=total):
                    meta, (ln_a, e_a, st_a), _gc = self._device_verify(
                        comp, total)
                n_ev = int(meta[0])
                with RECORDER.span("decode.events"):
                    gid_a = self.table.state_gid[st_a]
                    events = self._events_from_arrays(batch, ln_a, e_a,
                                                      gid_a)
                RECORDER.add("verify.events", len(events))
            return BatchMatches(
                events=events,  # on a mesh, this rank's lanes
                total=n_ev,  # on a mesh, every rank's
                reported=len(events),
                overflowed=False,
            )
        rows, lanes, arr = self._verify(batch, comp, total)
        with RECORDER.span("decode.events"):
            events = self._host_events(batch, rows, lanes, arr)
        RECORDER.add("verify.events", len(events))
        return BatchMatches(
            events=events,
            total=len(events),
            reported=len(events),
            overflowed=False,
        )

    def _host_events(self, batch: HostBatch, rows, lanes, arr
                     ) -> list[MatchEvent]:
        """MatchEvents of host verify's walker output ``arr`` (or, without
        the native walker, of its tuple fallback over ``rows``/``lanes``)."""
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
        return events

    def decode_counts(
        self, batch: HostBatch, comp
    ) -> tuple[int, np.ndarray]:
        """(total_events, per-group counts [G]) without materializing
        per-event objects. Dense: the in-walk gcounts, exact past slot
        overflow. Device verify: the gcounts of the verify stage. Host
        verify: a bincount over the walker's verified rows; like
        ``decode``, it grows ``k_ref`` on a refinement overflow (the
        reference grows it in ``decode`` only).

        On a mesh, the dense and device-verify counts come back reduced
        over every rank (do not reduce them again); host verify counts
        this rank's lanes (``parallel.mesh.allreduce_host_counts``), none
        on a grid follower."""
        G = self.table.num_groups
        if isinstance(comp, CompactMatches):
            return int(comp.meta[0]), per_group_counts(
                self.dev, comp).cpu().numpy().astype(np.int64)
        if isinstance(comp, MeshDenseMatches):
            return int(comp.metas[0]), comp.gcounts.cpu().numpy().astype(
                np.int64)
        total = self._batch_total(comp)
        if not total:
            return 0, np.zeros(G, np.int64)
        if self._grid is not None and self._dvf is not None:
            # the column's merged events counted on its leader, then
            # summed over the ranks: the global merged counts everywhere
            from tpu_pattern_matching_torch.parallel.mesh import (
                allreduce_host_counts,
            )

            *_rows, gid_a = self._grid_events(comp)
            loc = np.append(np.bincount(gid_a[gid_a >= 0], minlength=G),
                            len(gid_a))  # [counts..., total]
            red = allreduce_host_counts(loc, self._mesh_ctx)
            return int(red[G]), red[:G].astype(np.int64)
        if self._grid is not None and not self._grid.is_leader:
            return 0, np.zeros(G, np.int64)
        if self._dvf is not None:
            meta, _packed, gc = self._device_verify(comp, total)
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
                batch.seq = RECORDER.next_seq()
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
