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

``MatchSession.__init__`` names the pipeline once: "dense" (flat or on
the mesh), "host" (host verify: flat, refined, pattern-sharded, on the
mesh or on a grid column's leader), "device" (device verify, flat or on
the mesh), "grid" (device verify on the grid) or "follower" (a grid
rank under host verify that is not its column's leader). ``scan``,
``decode`` and ``decode_counts`` dispatch on that name, and every decode
hands its verified (lane, end, group) rows to one bulk event builder.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import io
import operator
import time
from collections import deque
from itertools import repeat
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


@dataclasses.dataclass(slots=True)
class MatchEvent:
    """One decoded match: absolute END offset of the occurrence in its file,
    the full pattern-index set ending there, and the representative id.
    ``lane`` is the batch lane it was found in; ``gid`` the match-group id
    (-1 when unknown). Slotted: a batch's events are made natively, an
    object and six slot stores each (``MatchSession._events_from_arrays``,
    ``runtime/events_native.py``); events of one group share its pattern
    list. The cyclic collector does not track them (they hold ints and a
    list of ints, so no cycle passes through them); one is tracked again
    when a field is given a value the collector tracks."""

    file_id: int
    end_offset: int
    pattern_indices: list[int]
    rep_index: int
    lane: int = -1
    gid: int = -1

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if not gc.is_tracked(self) and gc.is_tracked(value):
            _event_builder().track(self)

    def expand(self) -> Iterator[tuple[int, int]]:
        for p in self.pattern_indices:
            yield (self.end_offset, p)


_EVENT_FIELDS = tuple(f.name for f in dataclasses.fields(MatchEvent))
_NO_ROWS = (np.zeros(0, np.int64),) * 3  # a batch without verified rows


@functools.cache
def _event_builder():
    """The native builder of ``MatchEvent``s, or None where its library
    cannot be built: the events are then built in Python."""
    from tpu_pattern_matching_torch.runtime.events_native import (
        EventBuilder,
        EventsUnavailable,
    )

    try:
        return EventBuilder(MatchEvent, _EVENT_FIELDS)
    except EventsUnavailable as e:
        from tpu_pattern_matching_torch.utils.debug import dprint

        dprint(1, "%s; building events in Python", e)
        return None


@dataclasses.dataclass
class BatchMatches:
    """Host-decoded results of one batch."""

    events: list[MatchEvent]
    total: int  # exact device-side event count (incl. slot overflow)
    reported: int
    overflowed: bool
    group_counts: np.ndarray | None = None  # [G] int32 when requested


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
        grid = self._grid
        # The pipeline, named here once: scan, decode and decode_counts
        # dispatch on it. "host" verifies flat (refined or not), pattern-
        # sharded, on the mesh or on a grid column's leader; "device" flat
        # or on the mesh; "grid" is device verify on the grid; a grid's
        # other ranks under host verify ("follower") decode nothing.
        if engine == "dense":
            self._pipeline = "dense"
        elif self.verify_mode == "device":
            self._pipeline = "device" if grid is None else "grid"
        elif grid is None or grid.is_leader:
            self._pipeline = "host"
        else:
            self._pipeline = "follower"
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
        self._reps = [pids[0] for pids in self._groups]
        self._gid_of_pidset = {
            tuple(sorted(pids)): g for g, pids in enumerate(self._groups)
        }
        if engine == "dense":
            from tpu_pattern_matching_torch.ops.table import DeviceTable

            self.dev = DeviceTable.put(table, self.device)
            # every result slot of the rank's lanes, with or without a
            # mesh: the reference's 8192-tuple cap is not kept (ROADMAP
            # queue 3)
            capacity = self.local_chunks * max_results
            if ctx is None:
                from tpu_pattern_matching_torch.ops.compact import (
                    scan_and_compact,
                )

                self._step = functools.partial(
                    scan_and_compact, self.dev, max_results=max_results,
                    capacity=capacity, sort=sort, chunk_len=chunk_len)
            else:
                from tpu_pattern_matching_torch.parallel.mesh import (
                    make_sharded_dense_step,
                )

                walk = make_sharded_dense_step(
                    ctx, self.dev, halo=self.halo, max_results=max_results,
                    num_groups=table.num_groups, capacity=capacity)
                self._step = lambda data, bounds, halo: walk(data, bounds)
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
        probe = None
        if grid is not None:
            from tpu_pattern_matching_torch.parallel.pshard import (
                make_pattern_sharded_bloom_step,
            )

            if not isinstance(bft, ShardedBloom):
                raise ValueError("the grid needs a pattern-sharded filter "
                                 "(ShardedBloom), not a flat one")
            # this rank's shard alone: 1/S of the filter
            self._bloom = bft.put_shard(grid.pat_index, self.device)
            probe = make_pattern_sharded_bloom_step(grid, self._bloom)
        else:
            self._bloom = bft.put(self.device)
            if ctx is not None:
                from tpu_pattern_matching_torch.parallel.mesh import (
                    make_sharded_bloom_step,
                )

                probe = make_sharded_bloom_step(ctx, self._bloom)
        bloom = self._bloom
        if probe is None:
            self._step = bloom.hits
        else:  # the mesh's or the grid's step: meta reduced over ranks
            self._step = lambda data, bounds: BloomHits(
                *probe(bloom.words, data, bounds))
        if self._pipeline == "grid":
            from tpu_pattern_matching_torch.parallel.pshard import (
                PshardDeviceVerifier,
                shard_table,
            )

            # only this rank's shard table is built: its 1/S of the
            # global one, walked against the column's union bitmap
            self._dvf = PshardDeviceVerifier(
                grid, bft,
                shard_table(table, bft.parts[grid.pat_index]), self.halo)
        elif self._pipeline == "device":
            from tpu_pattern_matching_torch.ops.verify_device import (
                DeviceVerifier,
            )

            # the verify stage refines its own candidates: the probe
            # attaches no refinement of its own
            self._dvf = DeviceVerifier(table, bft.cfg, self.halo,
                                       self.device, gram_keys=bft.gram_keys,
                                       mesh=ctx)
        elif self._pipeline == "host":
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
        """The pipeline's device step on one uploaded batch (``scan``):
        the dense walk and compaction, or the bloom probe, whose result
        keeps the uploaded arrays for a device verify stage."""
        if self._pipeline == "dense":
            return self._step(data, bounds, halo=batch.halo)
        h = self._step(data, bounds)
        if self._pipeline in ("device", "grid"):
            h.data, h.bounds = data, bounds
        return h

    def decode(self, batch: HostBatch,
               comp: BloomHits | CompactMatches | MeshDenseMatches
               ) -> BatchMatches:
        """Exact events of one batch: the pipeline's verified rows (lane,
        end past the halo, group), then one bulk build of their events
        (``_events_from_arrays``). The dense engine reads ``meta``, then
        one slice of the packed tuples only when matches exist; the bloom
        engine reads its survivor total, then verifies the candidates on
        the host or the device when it is not zero.

        Spans: ``decode`` > ``decode.sync``, ``decode.rows``,
        ``decode.verify``, ``decode.events``; then ``batch``, from the
        batch's ``scan`` start to here. Counter ``verify.events``."""
        seq = getattr(batch, "seq", -1)
        work = batch.symbols
        with RECORDER.span("decode", seq, work):
            total, overflowed, rows = self._ROWS[self._pipeline](
                self, batch, comp)
            with RECORDER.span("decode.events"):
                events = self._events_from_arrays(batch, *rows)
            RECORDER.add("verify.events", len(events))
            bm = BatchMatches(events=events, total=total,
                              reported=len(events), overflowed=overflowed)
        t0 = getattr(comp, "scan_t0", None)
        if t0 is not None:
            RECORDER.record("batch", t0, time.perf_counter_ns(), seq, work)
        return bm

    # Each pipeline's verified rows of one batch, for ``decode`` and
    # ``decode_counts``: ``(total, overflowed, (lanes, ends past the halo,
    # gids[, pattern lists]))``.

    def _dense_rows(self, batch: HostBatch, comp):
        """The dense walk's compacted tuples. ``meta`` begins with the
        total and the reported count it overflows past, and ends with the
        count of tuples in ``packed``: ``[total, reported]`` flat, ``[global
        total, global reported, local total, local reported]`` on a mesh
        (where the events are this rank's lanes'). ``packed [5, K]`` (lane,
        pos, state, gid, rep_pid) comes back in one transfer of a
        power-of-two bucket >= those tuples; ``pos`` is a tuple's end past
        the halo."""
        with RECORDER.span("decode.sync"):
            meta = comp.meta.tolist()
        n = meta[-1]
        rows = _NO_ROWS
        if n:
            with RECORDER.span("decode.rows"):
                bucket = max(256, 1 << (n - 1).bit_length())
                lane, pos, _state, gid, _rep = (
                    comp.packed[:, :bucket].cpu().numpy()[:, :n])
            rows = lane, pos, gid
        return meta[0], meta[0] > meta[1], rows

    def _host_rows(self, batch: HostBatch, comp: BloomHits):
        """Host verify: the survivor total, then the bitmap's candidate
        rows (read only when the total is not zero) walked by the native
        window walker; without it, the tuple fallback's (lane, end,
        pattern) tuples grouped by (lane, end), each with its pattern
        list. The total counts the events."""
        from tpu_pattern_matching_torch.ops.bloom import unpack_hit_rows

        total = self._batch_total(comp)
        with RECORDER.span("decode.rows"):
            if total:
                rows, lanes = unpack_hit_rows(comp.bits.cpu().numpy(),
                                              self.bloom_table.cfg.stride)
            else:
                rows = lanes = np.zeros(0, np.int64)
        RECORDER.add("verify.candidates", len(rows))
        args = (batch.data, lanes, rows, batch.halo, batch.start_t,
                batch.end_t)
        with RECORDER.span("decode.verify", work=len(rows)):
            arr = self._verifier.verify_batch_arrays(*args)
            if arr is None:  # no native dense walker: the tuple fallback
                grouped: dict[tuple[int, int], set[int]] = {}
                for ln, e, pid in self._verifier.verify_batch(*args):
                    grouped.setdefault((ln, e), set()).add(pid)
                ln_a, e_a = np.array(list(grouped), np.int64).reshape(-1, 2).T
                pids = list(map(sorted, grouped.values()))
                return len(pids), False, (ln_a, e_a - batch.halo,
                                          self._gids_of(pids), pids)
        ln_a, e_a, st_a = arr
        return len(ln_a), False, (ln_a, e_a - batch.halo,
                                  self.table.state_gid[st_a])

    def _device_rows(self, batch: HostBatch, comp: BloomHits):
        """Device verify: the survivor total, then, if it is not zero, the
        verify stage's events. On a mesh every rank verifies (the total
        is global), the events are this rank's lanes' and the total every
        rank's."""
        total = self._batch_total(comp)
        if not total:
            return 0, False, _NO_ROWS
        with RECORDER.span("decode.verify", work=total):
            meta, (ln_a, e_a, st_a), _gc = self._device_verify(comp, total)
        return int(meta[0]), False, (ln_a, e_a - batch.halo,
                                     self.table.state_gid[st_a])

    def _grid_rows(self, batch: HostBatch, comp: BloomHits):
        """The grid's device verify: if the global survivor total is not
        zero, every rank verifies together with the probe's largest
        column total, and the column's leader merges its shards' rows
        (``merge_shard_rows``), each event's pattern list the global
        co-terminating set. The events are the column's, on its leader;
        the total every column's."""
        from tpu_pattern_matching_torch.parallel.mesh import (
            allreduce_host_counts,
        )
        from tpu_pattern_matching_torch.parallel.pshard import (
            merge_shard_rows,
        )

        if not self._batch_total(comp):
            return 0, False, _NO_ROWS
        with RECORDER.span("decode.verify"):
            sh, ln, e, g, _gc = self._dvf.verify_rows(
                comp.data, comp.bounds, comp.bits, int(comp.meta[1]))
            ln_a, e_a, bounds, pids = merge_shard_rows(
                sh, ln, e, g, self._dvf.shard_groups)
        b = bounds.tolist()
        sets = list(map(pids.tolist().__getitem__, map(slice, b, b[1:])))
        n_ev = allreduce_host_counts(np.array([len(sets)], np.int64),
                                     self._mesh_ctx)[0]
        return int(n_ev), False, (ln_a, e_a - batch.halo,
                                  self._gids_of(sets), sets)

    def _follower_rows(self, batch: HostBatch, comp: BloomHits):
        """A grid follower under host verify: its column's leader decodes
        the column, so no events and a total of 0."""
        self._batch_total(comp)
        return 0, False, _NO_ROWS

    _ROWS = {"dense": _dense_rows, "host": _host_rows,
             "device": _device_rows, "grid": _grid_rows,
             "follower": _follower_rows}

    def scan_and_decode(self, batch: HostBatch) -> BatchMatches:
        """``decode(batch, scan(batch))``: one batch's events."""
        return self.decode(batch, self.scan(batch))

    def _events_from_arrays(
        self, batch: HostBatch, ln_a, own_a, gid_a, pids=None
    ) -> list[MatchEvent]:
        """MatchEvents from verified (lane, end, gid) arrays; ``own_a`` is
        an event's end row past its lane's halo. An event's pattern list
        is its group's, shared by the group's events, unless ``pids``
        gives every event's list: where a path cannot name each group
        (the grid's merge, host verify's tuple fallback; gid -1 there).
        ``sort`` applies the canonical (file_id, absolute end_offset)
        order (MATCHING.md "--sort semantics").

        numpy gathers each column; the native builder (``_event_builder``)
        makes the events from them in one call, untracked by the cyclic
        collector (counter ``events.native``). Where its library cannot be
        built, they are built in bulk in Python, with no Python frame an
        event: ``tolist`` makes each column Python ints once; one
        ``itemgetter`` call gathers the groups' pattern lists and their
        representatives; ``object.__new__`` mapped over the count makes
        the events, and ``object.__setattr__`` mapped over each column
        fills one slot of every event."""
        n = len(ln_a)
        if not n:
            return []
        end_a = batch.base_off[ln_a] + own_a
        file_a = batch.file_ids[ln_a]
        if self.sort:
            order = np.lexsort((end_a, file_a))
            ln_a, end_a, file_a, gid_a = (
                ln_a[order], end_a[order], file_a[order], gid_a[order])
            if pids is not None:
                pids = list(map(pids.__getitem__, order.tolist()))
        build = _event_builder()
        if build is not None:
            events = build(file_a, end_a, ln_a, gid_a, self._groups,
                           self._reps, pids)
            RECORDER.add("events.native", n)
            return events
        gids = gid_a.tolist()
        if pids is None:
            take = operator.itemgetter(*gids)
            pids, reps = take(self._groups), take(self._reps)
            if n == 1:  # itemgetter of one key returns the item bare
                pids, reps = (pids,), (reps,)
        else:
            reps = list(map(operator.itemgetter(0), pids))
        events = list(map(object.__new__, repeat(MatchEvent, n)))
        for name, col in zip(_EVENT_FIELDS, (
                file_a.tolist(), end_a.tolist(), pids, reps, ln_a.tolist(),
                gids)):
            deque(map(object.__setattr__, events, repeat(name), col),
                  maxlen=0)
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

    def _device_verify(self, comp: BloomHits, total: int):
        """The device verify stage of one batch: ``(meta, (lanes, ends,
        states), gcounts)``. On a mesh every rank calls it together, with
        the probe's largest per-rank total, and ``meta[0]`` (the events)
        and ``gcounts`` are sums over the ranks."""
        if self._mesh_ctx is not None:
            total = int(comp.meta[1])
        return self._dvf.verify(comp.data, comp.bounds, comp.bits, total)

    def _gids_of(self, pid_lists) -> np.ndarray:
        """The group of each ascending pattern list, -1 where none is."""
        return np.array(list(map(self._gid_of_pidset.get,
                                 map(tuple, pid_lists), repeat(-1))),
                        np.int64)

    def decode_counts(
        self, batch: HostBatch, comp
    ) -> tuple[int, np.ndarray]:
        """(total_events, per-group counts [G]) without materializing
        per-event objects. Dense: the in-walk gcounts, exact past slot
        overflow. Device verify: the gcounts of the verify stage. Host
        verify and the grid: a bincount over the verified rows; like
        ``decode``, it grows ``k_ref`` on a refinement overflow (the
        reference grows it in ``decode`` only).

        On a mesh, the dense and device-verify counts come back reduced
        over every rank (do not reduce them again), and so do the grid's;
        host verify counts this rank's lanes
        (``parallel.mesh.allreduce_host_counts``), none on a grid
        follower."""
        G = self.table.num_groups
        if self._pipeline == "dense":
            return int(comp.meta[0]), per_group_counts(
                self.dev, comp).cpu().numpy().astype(np.int64)
        if self._pipeline == "device":
            total = self._batch_total(comp)
            if not total:
                return 0, np.zeros(G, np.int64)
            meta, _packed, gc = self._device_verify(comp, total)
            return int(meta[0]), gc.astype(np.int64)
        total, _over, (_ln, _own, gid_a, *_pids) = self._ROWS[
            self._pipeline](self, batch, comp)
        counts = np.bincount(gid_a[gid_a >= 0], minlength=G).astype(np.int64)
        if self._pipeline == "grid":  # the leaders' counts, every rank's sum
            from tpu_pattern_matching_torch.parallel.mesh import (
                allreduce_host_counts,
            )

            counts = allreduce_host_counts(counts, self._mesh_ctx)
        return total, counts

    def group_counts(self, comp: CompactMatches) -> np.ndarray:
        """Device-side per-group counts (dense engine); bloom sessions
        count verified events instead — use decode_counts or
        event_group_counts."""
        if self._pipeline != "dense":
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
