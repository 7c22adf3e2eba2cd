"""The data-parallel mesh on ``torch.distributed`` (port of the reference's
``parallel/mesh.py``): one lane shard per rank.

The reference's mesh is SPMD: one process drives every device of a
``jax.sharding.Mesh`` with the axis ``"data"``, the filter and DFA table
replicate, batch lanes shard over the axis, and XLA inserts the
collectives. PyTorch's idiom is one process per device, so here the mesh
is a ``torch.distributed`` process group and each rank owns one device and
one contiguous lane shard of the global batch (rank r holds lanes
``[r*C_local, (r+1)*C_local)``): it feeds only those lanes, probes or walks
them with the single-device kernels (K1/K2 for the bloom probe, W1 for the
dense walk, W2 for device verify) and decodes them into its own events.
This is exactly the reference's multi-process form, where each process
feeds and decodes only its own lanes.

The reference's collectives map onto the group: ``psum`` is
``all_reduce(SUM)``, ``pmax`` is ``all_reduce(MAX)`` and
``process_allgather`` + sum is ``all_reduce(SUM)``. The overflow flags are
bitmasks and NCCL has no bitwise OR, so each bit is reduced with MAX, as
the reference does. Every rank makes the same collective calls in the same
order: a retry decision is taken only from reduced values, and a rank
with no survivors still joins every reduce.

NCCL runs one rank per device: two ranks of one communicator on one card
fail at their first collective ("Duplicate GPU detected"), so
``init_distributed`` refuses that layout before the group exists
(``DeviceConflict``). Gloo takes CUDA tensors too (it stages them through
host memory), which is how two ranks share one card. Every group gets a
timeout of ``TIMEOUT_S`` seconds, so a rank that never joins fails the
others in bounded time.

A ``MeshContext`` may also name a sub-group of the world (``group`` and
its members' global ``ranks``): the ("pat", "data") grid of
``parallel/pshard.py`` reduces over a data column's ranks and a pattern
shard's ranks. Gloo takes CUDA tensors for ``all_reduce``, ``broadcast``
and the list form of ``all_gather`` on sub-groups too (``chip_smoke.py``'s
grid phase runs them so on the card), so no call stages through the host
by hand.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import socket

import numpy as np
import torch
import torch.distributed as dist

from tpu_pattern_matching_torch.ops.bloom import hits
from tpu_pattern_matching_torch.ops.compact import _compact
from tpu_pattern_matching_torch.ops.match_xla import dense_walk
from tpu_pattern_matching_torch.ops.verify_device import (
    MAX_DEVICE_CAND,
    DeviceVerifier,
    exact_table,
    next_cap,
    verify_candidates,
)
from tpu_pattern_matching_torch.utils.device import resolve_device

TIMEOUT_S = 60  # every process group: a rank that never joins fails the rest
FLAG_BITS = (1, 2, 4)  # verify flags: candidate, event, refined overflow
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class DeviceConflict(RuntimeError):
    """Two NCCL ranks would share one CUDA device."""


def group_timeout() -> datetime.timedelta:
    """Every process group's timeout, ``TIMEOUT_S`` seconds."""
    return datetime.timedelta(seconds=TIMEOUT_S)


def coordinator_url(coordinator: str) -> str:
    """The rendezvous URL of ``--coordinator``: ``host:port`` is a TCP
    store (rank 0 listens there); a URL with a scheme (``file:///path``,
    ``tcp://host:port``) is used as it is."""
    if not coordinator:
        raise ValueError("a multi-process run needs a coordinator "
                         "(host:port or file:///path)")
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: ``"cuda"`` without an ordinal is
    ``cuda:(rank % device_count)``; any other spec is taken as it is
    (``resolve_device``: raises when the device does not exist)."""
    dev = (torch.device("cuda", device) if isinstance(device, int)
           else torch.device(device))
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)  # raises without a card
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return resolve_device(dev)


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def check_distinct_devices(store, rank: int, world: int,
                           ident: str) -> None:
    """Publish this rank's device identity in the rendezvous ``store`` and
    raise ``DeviceConflict`` when another rank holds the same one (NCCL
    allows one rank per device). Every rank reads every identity, so all
    of them raise together."""
    store.set(f"tpm_mesh/device/{rank}", ident)
    others = [r for r in range(world) if r != rank
              and store.get(f"tpm_mesh/device/{r}").decode() == ident]
    if others:
        raise DeviceConflict(
            f"rank {rank} and rank(s) {others} are all on {ident}: NCCL "
            f"runs one rank per CUDA device; start at most as many "
            f"processes as there are devices, or use the gloo backend")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     device="cuda") -> bool:
    """Join a ``num_processes``-rank group as rank ``process_id`` through
    the rendezvous at ``coordinator`` (``coordinator_url``). Returns True
    when it created the default group; a no-op (False) for one process or
    when a group already exists (a library embedder may have made it).

    ``backend`` defaults to NCCL for a CUDA device and gloo for the CPU,
    chosen once: an NCCL layout with two ranks on one device raises
    ``DeviceConflict`` before the group exists, it never switches to
    gloo."""
    if num_processes is None or num_processes <= 1 or dist.is_initialized():
        return False
    dev = rank_device(device, process_id)
    backend = backend or default_backend(dev)
    store, rank, world = next(dist.rendezvous(
        coordinator_url(coordinator), process_id, num_processes,
        timeout=group_timeout()))
    store.set_timeout(group_timeout())
    if backend == "nccl":
        uuid = torch.cuda.get_device_properties(dev).uuid
        check_distinct_devices(store, rank, world,
                               f"{socket.gethostname()} GPU {uuid}")
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=group_timeout())
    return True


@contextlib.contextmanager
def owned_world():
    """Destroy the default process group on exit if this block made it."""
    made = not dist.is_initialized()
    try:
        yield
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


@dataclasses.dataclass
class MeshContext:
    """A rank of a process group: this rank's index in the group, the
    group's size, the rank's device and the backend. ``group`` is None for
    the default group (the data-parallel mesh spans it); a sub-group
    carries its members' global ``ranks`` in group order."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: object = None
    ranks: tuple | None = None

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` in place over the group (``"sum"`` or ``"max"``)
        and return it."""
        dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of every rank of the group, stacked in group order:
        ``[world_size, *t.shape]``. (The list form: gloo's
        ``all_gather_into_tensor`` refuses a stacked output.)"""
        out = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return torch.stack(out)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite ``t`` in place with group rank ``src``'s and return
        it."""
        root = self.ranks[src] if self.ranks is not None else src
        dist.broadcast(t, src=root, group=self.group)
        return t


def world_context(device="cuda") -> MeshContext:
    """The rank's context in the default group. Where none exists, a
    1-rank group over an in-process ``HashStore`` is made on ``device``
    (NCCL for a CUDA device, gloo for the CPU), so the collectives are
    real calls even at world 1."""
    if not dist.is_initialized():
        dev = rank_device(device, 0)
        dist.init_process_group(default_backend(dev), store=dist.HashStore(),
                                rank=0, world_size=1, timeout=group_timeout())
    rank = dist.get_rank()
    dev = rank_device(device, rank)
    backend = dist.get_backend()
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the process group is NCCL, which reduces CUDA "
                         f"tensors only; rank {rank}'s device is {dev}")
    return MeshContext(rank, dist.get_world_size(), dev, backend)


def as_mesh_context(spec, device="cuda") -> MeshContext:
    """Coerce a user-facing mesh spec into this rank's ``MeshContext``.

    Accepts a ``MeshContext``; ``"all"``, ``"auto"`` or ``True`` (the
    initialized world, ``world_context``); or an int, which must equal the
    world size. A rank drives one device, so the reference's "the first n
    devices" of one process has no counterpart (ROADMAP queue 3).
    ``device`` is the rank's device (``rank_device``)."""
    if isinstance(spec, MeshContext):
        return spec
    if spec is True or spec in ("all", "auto"):
        return world_context(device)
    if isinstance(spec, int):
        check_mesh_size(spec)
        return world_context(device)
    raise TypeError(f"cannot build a mesh from {spec!r}")


def check_mesh_size(n: int) -> int:
    """``n``, when it is the world size (1 without a process group);
    raises ValueError naming both numbers otherwise."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(
            f"mesh size {n} is not the world size {world}: each rank "
            f"drives one device, so a mesh spans every rank of the "
            f"process group")
    return n


def check_lanes(c_local: int) -> None:
    """The bloom bitmap's columns are lanes padded to 128: a rank's lane
    count must be a multiple of 128, or the padding would shift every
    later rank's lanes in the global column order."""
    if c_local % 128:
        raise ValueError(
            f"per-device lane count {c_local} must be a multiple of 128 "
            f"(pad the batch to mesh_size*128 lanes)")


def allreduce_host_counts(counts, ctx: MeshContext | None = None
                          ) -> np.ndarray:
    """Sum a host count vector over the ranks of ``ctx`` (an int64
    ``all_reduce(SUM)`` on the rank's device). A no-op at world 1 or
    without a mesh, as in the reference."""
    counts = np.asarray(counts)
    if ctx is None or ctx.world_size == 1:
        return counts
    t = torch.from_numpy(counts.astype(np.int64)).to(ctx.device)
    return ctx.all_reduce(t).cpu().numpy()


def lockstep(items, ctx: MeshContext, idle):
    """Yield ``items`` in rounds that every rank of ``ctx`` takes together:
    a round is one ``all_reduce(SUM)`` of "I have an item"; a rank whose
    items ran out yields ``idle`` (an empty batch) until every rank is
    done, so the ranks' scans stay in step."""
    it = iter(items)
    while True:
        item = next(it, None)
        if not allreduce_host_counts(np.array([item is not None]), ctx)[0]:
            return
        yield idle if item is None else item


# ------------------------------------------------------------------ steps


def make_sharded_scan_step(ctx: MeshContext, table, *, halo: int,
                           max_results: int, num_groups: int):
    """The dense walk (W1) of this rank's lanes: ``step(table_flat,
    state_gid, data [C_local, T], start_t, end_t) -> (counts, slot_state,
    slot_pos, gcounts)``, the per-lane results local and the in-walk
    per-group counts all-reduced over the mesh (the reference's psum)."""

    def step(table_flat, state_gid, data, start_t, end_t):
        counts, slot_state, slot_pos, gcounts = dense_walk(
            table_flat, data.t().contiguous(),
            torch.stack([start_t, end_t]).to(torch.int32),
            alphabet_size=table.alphabet_size, halo=halo,
            max_results=max_results, max_pat_len=table.max_pat_len,
            state_gid=state_gid, num_groups=num_groups)
        return counts, slot_state, slot_pos, ctx.all_reduce(gcounts)

    return step


@dataclasses.dataclass
class MeshDenseMatches:
    """Dense-engine results of one rank's lanes.

    ``meta = [global_total, global_reported, local_total,
    local_reported]`` (the first two all-reduced; ``CompactMatches.meta``
    too begins with the total and the reported count it overflows past,
    and ends with the count of tuples in ``packed``); ``packed [5, cap]``
    this rank's compacted (lane, pos, state, gid, rep_pid) tuples over
    its own lanes; ``gcounts`` the in-walk per-group counts, all-reduced
    (exact past slot and capacity overflow)."""

    meta: torch.Tensor  # [4] int32
    packed: torch.Tensor  # [5, cap] int32
    gcounts: torch.Tensor  # [G] int32


def make_sharded_dense_step(ctx: MeshContext, table, *, halo: int,
                            max_results: int, num_groups: int,
                            capacity: int):
    """W1 plus the compaction (``ops/compact.py``) of this rank's lanes:
    ``run(data, bounds) -> MeshDenseMatches``, with one ``all_reduce`` of
    ``[total, reported, gcounts...]`` a batch. ``capacity`` bounds the
    rank's packed block; the totals stay exact past it."""

    def run(data, bounds) -> MeshDenseMatches:
        counts, slot_state, slot_pos, gcounts = dense_walk(
            table.table_flat, data.t().contiguous(), bounds,
            alphabet_size=table.alphabet_size, halo=halo,
            max_results=max_results, max_pat_len=table.max_pat_len,
            state_gid=table.state_gid, num_groups=num_groups)
        meta, packed = _compact(counts, slot_state, slot_pos,
                                table.state_gid, table.group_rep, capacity)
        red = ctx.all_reduce(torch.cat([meta, gcounts]))
        return MeshDenseMatches(meta=torch.cat([red[:2], meta]),
                                packed=packed, gcounts=red[2:])

    return run


def make_sharded_bloom_step(ctx: MeshContext, bloom):
    """The bloom probe (K1/K2, ``ops.bloom.hits``) of this rank's lanes
    against the replicated filter: ``step(words, data [C_local, T],
    bounds) -> (meta [2], bits [W, C_local])``, ``meta = [global total,
    max local total]`` (one ``all_reduce`` SUM and one MAX); the bitmap
    stays local. No exact refinement is attached on a mesh, as in the
    reference."""
    cfg = bloom.cfg

    def step(words, data, bounds):
        check_lanes(data.shape[0])
        total, bits = hits(data, bounds, words, cfg)
        meta = torch.cat([ctx.all_reduce(total.clone(), "sum"),
                          ctx.all_reduce(total.clone(), "max")])
        return meta, bits

    return step


def flag_bits(flags):
    """The overflow flags' bits (``FLAG_BITS``), one per element: their
    MAX over a group is the flags' OR."""
    return flags & torch.tensor(FLAG_BITS, dtype=flags.dtype,
                                device=flags.device)


def reduce_verify(ctx: MeshContext, meta, gcounts,
                  counts_ctx: MeshContext | None = None):
    """The collectives of one verify dispatch (``verify_candidates``'
    ``meta [5]`` and ``gcounts``) over ``ctx``: one ``all_reduce`` SUM of
    ``[n_events, gcounts...]`` and one MAX of ``[n_events, n_cand,
    n_exact, flag bit 0, bit 1, bit 2]`` (MAX of each bit is its OR).
    Returns ``(meta [6], gcounts)``: ``meta = [summed n_events, this
    rank's reported, largest n_cand, ORed flags, largest n_exact, largest
    n_events]`` and the summed gcounts.

    ``counts_ctx`` (default ``ctx``) is the group the gcounts are summed
    over instead, in an ``all_reduce`` of their own: on the grid the
    needs span every rank while a shard's group ids index its own table,
    so its counts sum over the ranks of that shard only."""
    if counts_ctx is None or counts_ctx is ctx:
        sums = ctx.all_reduce(torch.cat([meta[:1], gcounts]))
        n_events, gcounts = sums[0], sums[1:]
    else:
        n_events = ctx.all_reduce(meta[:1].clone())[0]
        gcounts = counts_ctx.all_reduce(gcounts)
    maxes = ctx.all_reduce(torch.cat([meta[[0, 2, 4]], flag_bits(meta[3])]),
                           "max")
    meta = torch.stack([n_events, meta[1], maxes[1], maxes[3:].sum(),
                        maxes[2], maxes[0]])
    return meta, gcounts


def make_sharded_bloom_count_step(ctx: MeshContext, bloom, table, *,
                                  halo: int, k_cand: int = 4096,
                                  k_ev: int = 4096, gram_keys=None,
                                  k_walk: int | None = None):
    """The all-device count path: the bloom probe, device verify (with
    exact-gram refinement when ``gram_keys`` are given) and the per-group
    counts on each rank, then the reductions.

    Returns ``step(words, table_flat, state_gid, data, bounds) ->
    (gcounts [G], n_events [], flags [], needs [3])``, every one reduced
    over the mesh: ``flags`` ORs the ranks' overflow bits (bit 0
    candidates, bit 1 event slots, bit 2 refined candidates; gcounts are
    then incomplete), ``needs`` are the largest per-rank ``[n_events,
    n_candidates, n_refined]``, the capacities a rescan must cover
    (``ShardedBloomCounter`` rescans on its own); ``n_events`` is exact
    either way. The capacities are fixed per step, as in the reference."""
    cfg = bloom.cfg
    dx = exact_table(gram_keys, cfg, table, ctx.device)
    kw = k_walk if k_walk is not None else k_cand

    def step(words, table_flat, state_gid, data, bounds):
        check_lanes(data.shape[0])
        _total, bits = hits(data, bounds, words, cfg)
        meta, _packed, gcounts = verify_candidates(
            table_flat, state_gid, data, bounds, bits, dx,
            alphabet_size=table.alphabet_size, stride=cfg.stride, q=cfg.q,
            lmax=table.max_pat_len, halo=halo, k_cand=k_cand, k_ev=k_ev,
            num_groups=table.num_groups, k_walk=kw)
        meta, gcounts = reduce_verify(ctx, meta, gcounts)
        return gcounts, meta[0], meta[3], meta[[5, 2, 4]]

    return step


class ShardedBloomCounter:
    """The count path with capacity retry: on any overflow flag the same
    batch is counted again at capacities that cover the reduced needs
    (``next_cap``, at most 8 rounds), and the grown capacities stay for
    the next batch. Every decision reads reduced values, so every rank
    retries together. Its dispatches are those of this rank's
    ``DeviceVerifier`` on the mesh, at the counter's capacities."""

    def __init__(self, ctx: MeshContext, bloom, table, *, halo: int,
                 k_cand: int = 4096, k_ev: int = 4096, gram_keys=None,
                 k_walk: int | None = None):
        self.bloom = bloom
        self.verifier = DeviceVerifier(table, bloom.cfg, halo, ctx.device,
                                       gram_keys=gram_keys, mesh=ctx)
        self.k_cand = k_cand
        self.k_ev = k_ev
        self.k_walk = k_walk if k_walk is not None else (
            k_cand if gram_keys is None else min(k_cand, 1024))

    def _step(self, data, bounds, k_cand: int, k_ev: int, k_walk: int):
        """One count dispatch at these capacities: the probe, then the
        verify dispatch and its reductions (``DeviceVerifier._dispatch``).
        Returns the host ``meta [6]`` and reduced ``gcounts``."""
        check_lanes(data.shape[0])
        _total, bits = hits(data, bounds, self.bloom.words, self.bloom.cfg)
        meta, _packed, gcounts = self.verifier._dispatch(
            data, bounds, bits, k_cand, k_ev, k_walk)
        return meta, gcounts.cpu().numpy()

    def count(self, data, bounds) -> tuple[np.ndarray, int]:
        """(gcounts [G] int64, n_events) of the mesh's batch (this rank's
        ``data [C_local, T]`` and ``bounds``), exact, retrying capacities
        as needed. Raises RuntimeError past MAX_DEVICE_CAND per rank
        (host verify is the tool for match-saturated batches)."""
        for _ in range(8):  # log-bounded: 8 covers any ladder walk
            meta, gcounts = self._step(data, bounds, self.k_cand,
                                       self.k_ev, self.k_walk)
            f = int(meta[3])
            if not f:
                return gcounts.astype(np.int64), int(meta[0])
            if f & 1:  # candidate overflow: the exact need is meta[2]
                if int(meta[2]) > MAX_DEVICE_CAND:
                    raise RuntimeError(
                        f"{int(meta[2])} candidates on one shard exceed "
                        f"the device cap {MAX_DEVICE_CAND}; use host "
                        f"verify for this stream")
                self.k_cand = next_cap(int(meta[2]))
            if f & 4:  # refined-candidate overflow
                self.k_walk = min(next_cap(int(meta[4])),
                                  max(self.k_cand, 256))
            if f & 2:  # event-slot overflow
                if int(meta[5]) > MAX_DEVICE_CAND:
                    raise RuntimeError(
                        f"{int(meta[5])} events on one shard exceed the "
                        f"device cap {MAX_DEVICE_CAND}; use host verify "
                        f"for this stream")
                self.k_ev = next_cap(int(meta[5]))
        raise RuntimeError("capacity retry did not converge (bug)")
