"""Pattern-set sharding (port of the reference's ``parallel/pshard.py``):
S shard filters on one device, and the ("pat", "data") grid of ranks.

A single bloom filter saturates as the pattern set grows: past ~300k
patterns its false-positive rate climbs even at the largest filters the
chooser allows. Sharding partitions the PATTERN SET into S balanced
shards, each with its own smaller filter under ONE common
``BloomConfig`` (one kernel shape probes every shard), so each filter is
chosen for G/S grams.

Exactness is unchanged: a position is a candidate iff SOME shard's
filter accepts its gram, so the shard survivor bitmaps OR together on
the device (one ``[W, Cp]`` bitmap comes back whatever S) and the verify
stages (host native walker, device walk) run on the union exactly as for
one filter.

On one device the S probes are S launches of the same probe kernel into
one bitmap, each ORing into the words of the one before, the last one
counting the union's popcount (``ops.bloom.or_shards``); on the CPU the
plain version ORs S plain probes.

**The grid** (``Mesh2DContext``; ``MatchSession(mesh=..., pat_shards=S)``)
spreads the shards over ranks: W = S x D ranks, one device each, rank r
holding pattern shard ``s = r % S`` of data column ``d = r // S``. The
reference is SPMD: one process owns every device of its data columns, so
a column's S pattern rows share one host batch and one decode. Here a
rank owns one device, so a column is S ranks, and:

- **Layout.** A column's S ranks are contiguous, so when S divides the
  ranks per host a column never spans two hosts (the reference keeps
  "all S pat rows of a column on one process"). ``W % S != 0`` raises
  ``ValueError`` naming both, world 1 with ``S = 2`` included. Every
  rank makes every column group (S ranks) and every row group (D ranks,
  one shard's) with ``dist.new_group``, in one order, each with the
  mesh's ``TIMEOUT_S``: ``new_group`` is collective over the world.
- **Input.** The column's leader (``s == 0``) feeds the column's lanes:
  ``MatchSession.scan`` broadcasts its ``data [C_local, T]`` and
  ``bounds [2, C_local]`` over the column group; a follower's own batch
  is only a shape. Why not have all S ranks read the same files: the
  feeder's threads queue batches in no fixed order, and a FIFO or a
  followed file can be read only once. In the CLIs leaders own files as
  ``process_id=d, num_processes=D``; followers own none and take part in
  the lockstep rounds with an empty batch.
- **Filter.** A rank holds only shard s's words (``put_shard``): 1/S of
  the filter, which is the point of the grid. The probe step launches
  K1/K2 once on the rank's lanes, ``all_gather``s the ``[W, C_local]``
  bitmaps over the column (NCCL has no bitwise-OR reduce, which is why
  the reference gathers too), ORs them and reduces the union's popcount
  over the ROW group (over the world it would count each column's union
  S times).
- **Verify and counts.** A rank walks the union against its own shard's
  table (W2), refined by its own shard's exact gram set; only shard s's
  table is built on rank s. The retry needs reduce over the world, the
  group counts over the row group (shards' group ids index different
  tables, so a world sum would mix them), then the column gathers them.
- **Decode.** Only the column's leader decodes: the shards' event rows
  ``(shard, lane, end, group)`` are gathered to it (each rank maps its
  states to its shard's groups; the leader holds every shard's group
  lists, gathered once) and merged on ``(lane, end)``. A follower
  returns no events; ``BatchMatches.total`` is global where the
  reference's is and otherwise the rank's own (0 on a follower). Each
  event is reported exactly once, and the union over the ranks equals
  the reference's union over processes.

``ShardedBloom`` dumps (``save``/``load``) use the reference's npz keys,
so a dump written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from tpu_pattern_matching_torch.core.dfa import AhoCorasick
from tpu_pattern_matching_torch.ops import bloom
from tpu_pattern_matching_torch.ops.bloom import (
    BloomConfig,
    BloomFilterTable,
    BloomHits,
    DeviceBloom,
    config_from_reference,
)
from tpu_pattern_matching_torch.ops.exact_gram import (
    DeviceExact,
    tables_from_keys_common,
)
from tpu_pattern_matching_torch.ops.verify_device import (
    DeviceVerifier,
    verify_candidates,
)
from tpu_pattern_matching_torch.parallel.mesh import (
    MeshContext,
    allreduce_host_counts,
    check_lanes,
    flag_bits,
    group_timeout,
    reduce_verify,
)


def shard_pattern_ids(lengths, n_shards: int) -> list[np.ndarray]:
    """Partition pattern ids into balanced shards: deal longest-first
    round-robin, so gram load and max_pat_len stay even and the globally
    shortest pattern (which constrains the common q/stride/w choice)
    lands in the LAST shard."""
    order = np.argsort(-np.asarray(lengths), kind="stable")
    return [np.sort(order[s::n_shards]) for s in range(n_shards)]


@dataclasses.dataclass
class ShardedBloom:
    """S per-shard filters under ONE common BloomConfig (a single kernel
    shape probes any shard). Duck-types the BloomFilterTable surface the
    session touches (cfg / max_pat_len / gram_keys / put / save)."""

    words: np.ndarray  # [S, kbanks, v, 128] int32
    cfg: BloomConfig
    parts: list[np.ndarray]  # global pattern ids per shard
    max_pat_len: int  # global (over all shards)
    n_grams: list[int]  # per shard
    fp_est: list[float]  # per shard
    shard_gram_keys: list | None = None  # per-shard exact inserted gram
    # keys (sorted uint64 arrays, ops/exact_gram.pack_grams layout)

    @property
    def n_shards(self) -> int:
        return len(self.parts)

    @property
    def gram_keys(self):
        """UNION of the per-shard inserted gram sets: a union-bitmap
        candidate is true iff its gram is in SOME shard's set, so one
        exact table over the union refines the union bitmap (device
        verify's refinement)."""
        if self.shard_gram_keys is None:
            return None
        return np.unique(np.concatenate(self.shard_gram_keys))

    @staticmethod
    def from_table(table, n_shards: int, **kw) -> "ShardedBloom":
        """Build from a compiled :class:`core.dfa.DfaTable` (byte or
        ushort alphabet; the alphabet rides along, so a 2048-alphabet
        build packs 11-bit gram keys)."""
        return ShardedBloom.build(
            [p.symbols for p in table.patterns],
            n_shards,
            fold_case=getattr(table, "nocase", False),
            alphabet_size=table.alphabet_size,
            **kw,
        )

    @staticmethod
    def build(
        patterns,
        n_shards: int,
        *,
        fold_case: bool = False,
        **build_opts,
    ) -> "ShardedBloom":
        """Partition + choose ONE config + build S filters.

        The chooser runs once, on the shard holding the globally shortest
        pattern (its length constraints bind every legal config; shards
        are gram-balanced, so its load is representative), with
        ``rate_scale=S`` so verify pricing and eligibility see the UNION
        candidate rate. The other shards build with ``force=`` pinning the
        chosen (mode, q, stride/w, k, v); the shared seed makes the hash
        mixes identical, which the build asserts.
        """
        pats = [list(p) for p in patterns]
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if n_shards > len(pats):
            raise ValueError(
                f"{n_shards} shards for {len(pats)} patterns; "
                f"shards must be non-empty"
            )
        parts = shard_pattern_ids([len(p) for p in pats], n_shards)
        # longest-first dealing puts the globally shortest pattern (dealt
        # last) in shard (N-1) mod S
        chooser = (len(pats) - 1) % n_shards
        build_opts.setdefault("rate_scale", float(n_shards))
        first = BloomFilterTable.build(
            [pats[i] for i in parts[chooser]],
            fold_case=fold_case,
            **build_opts,
        )
        cfg = first.cfg
        force = (
            ("sampled", cfg.q, cfg.w, cfg.kbanks, cfg.v)
            if cfg.sampled
            else ("strided", cfg.q, cfg.stride, cfg.kbanks, cfg.v)
        )
        shards: list[BloomFilterTable] = [None] * n_shards  # type: ignore
        shards[chooser] = first
        for s in range(n_shards):
            if s == chooser:
                continue
            shards[s] = BloomFilterTable.build(
                [pats[i] for i in parts[s]],
                fold_case=fold_case,
                force=force,
                **build_opts,
            )
            if shards[s].cfg != cfg:  # same seed -> same mixes; verify
                raise AssertionError(
                    f"shard {s} config diverged: {shards[s].cfg} != {cfg}"
                )
        if all(sh.gram_keys is not None for sh in shards):
            shard_gram_keys = [sh.gram_keys for sh in shards]
        else:
            shard_gram_keys = None
        return ShardedBloom(
            words=np.stack([sh.words for sh in shards]),
            cfg=cfg,
            parts=parts,
            max_pat_len=max(len(p) for p in pats),
            n_grams=[sh.n_grams for sh in shards],
            fp_est=[sh.fp_est for sh in shards],
            shard_gram_keys=shard_gram_keys,
        )

    @staticmethod
    def from_reference(obj) -> "ShardedBloom":
        """The port's sharded filter from the reference package's
        ``ShardedBloom`` (or any object with its fields): the same words,
        config, parts and gram keys, as numpy arrays — how a filter
        compiled by one package feeds the other."""
        keys = obj.shard_gram_keys
        return ShardedBloom(
            words=np.ascontiguousarray(np.asarray(obj.words), np.int32),
            cfg=config_from_reference(obj.cfg),
            parts=[np.asarray(p) for p in obj.parts],
            max_pat_len=int(obj.max_pat_len),
            n_grams=[int(x) for x in obj.n_grams],
            fp_est=[float(x) for x in obj.fp_est],
            shard_gram_keys=(None if keys is None else
                             [np.asarray(k, np.uint64) for k in keys]),
        )

    def put(self, device) -> "DeviceShardedBloom":
        return DeviceShardedBloom(
            words=torch.from_numpy(
                np.ascontiguousarray(self.words, np.int32)
            ).to(device),
            cfg=self.cfg,
            max_pat_len=self.max_pat_len,
        )

    def put_shard(self, s: int, device) -> DeviceBloom:
        """Shard ``s``'s filter alone (``words [k, v, 128]``) on ``device``,
        as a flat ``DeviceBloom``: a grid rank's 1/S of the filter."""
        return DeviceBloom(
            words=torch.from_numpy(
                np.ascontiguousarray(self.words[s], np.int32)).to(device),
            cfg=self.cfg,
            max_pat_len=self.max_pat_len,
        )

    # -- serialization (the reference's sharded dump: plain arrays only) ---

    def save(self, path: str) -> None:
        plen = np.asarray([len(p) for p in self.parts], np.int64)
        np.savez_compressed(
            path,
            pshard_words=self.words,
            cfg=np.array(
                [self.cfg.q, self.cfg.stride, self.cfg.kbanks, self.cfg.v,
                 int(self.cfg.fold_case), self.cfg.gt, self.cfg.ct,
                 int(self.cfg.blockwise), int(self.cfg.sampled),
                 self.cfg.w],
                dtype=np.int64,
            ),
            mix1=np.asarray(self.cfg.mix1, np.int64),
            mix2=np.asarray(self.cfg.mix2, np.int64),
            max_pat_len=np.int64(self.max_pat_len),
            part_lens=plen,
            part_ids=np.concatenate(
                [np.asarray(p, np.int64) for p in self.parts]
            ),
            n_grams=np.asarray(self.n_grams, np.int64),
            fp_est=np.asarray(self.fp_est, np.float64),
            **(
                {
                    "gram_keys_flat": np.concatenate(self.shard_gram_keys),
                    "gram_keys_lens": np.asarray(
                        [len(k) for k in self.shard_gram_keys], np.int64
                    ),
                }
                if self.shard_gram_keys is not None
                else {}
            ),
        )

    @staticmethod
    def load(path: str) -> "ShardedBloom":
        with np.load(path) as z:
            if "pshard_words" not in z:
                raise ValueError(
                    f"{path} is a flat filter dump, not a sharded one "
                    f"(load with BloomFilterTable.load)"
                )
            c = z["cfg"]
            cfg = BloomConfig(
                q=int(c[0]), stride=int(c[1]), kbanks=int(c[2]),
                v=int(c[3]),
                mix1=tuple(int(x) for x in z["mix1"]),
                mix2=tuple(int(x) for x in z["mix2"]),
                fold_case=bool(c[4]), gt=int(c[5]), ct=int(c[6]),
                blockwise=bool(c[7]), sampled=bool(c[8]), w=int(c[9]),
            )
            parts = _split(z["part_ids"], z["part_lens"])
            shard_gram_keys = (
                _split(z["gram_keys_flat"], z["gram_keys_lens"])
                if "gram_keys_flat" in z.files else None
            )
            return ShardedBloom(
                words=z["pshard_words"],
                cfg=cfg,
                parts=parts,
                max_pat_len=int(z["max_pat_len"]),
                n_grams=[int(x) for x in z["n_grams"]],
                fp_est=[float(x) for x in z["fp_est"]],
                shard_gram_keys=shard_gram_keys,
            )


def _split(flat: np.ndarray, lens) -> list[np.ndarray]:
    """``flat`` cut into consecutive pieces of ``lens``."""
    out, off = [], 0
    for n in lens:
        out.append(flat[off : off + int(n)].copy())
        off += int(n)
    return out


def sharded_hits(data, bounds, words, cfg: BloomConfig):
    """S probes + OR on the device: a lane-major batch ``data [C, T]``,
    ``bounds [2, C]`` and ``words [S, k, v, 128]`` in, ``(total [1], bits
    [W, Cp])`` of the UNION out (port of the reference's
    ``_sharded_hits_jit``).

    The pad and transpose of the batch happen once, shared by all shard
    probes (the packed layout when ``ops.bloom.PACKED_AUTO`` and the
    config allow it, as for one filter); ``total`` is the popcount of the
    union: the exact candidate count the decode stage walks (a position
    is counted once however many shards accept it)."""
    packed = bloom.PACKED_AUTO and bloom.packed_eligible(cfg, data.dtype)
    data_tm, Cp = bloom.prep_time_major(data, cfg, packed)
    bits, total = bloom.sharded_probe_bits(
        data_tm, bloom.pad_bounds(bounds, Cp), words, cfg)
    return total, bits


@dataclasses.dataclass
class DeviceShardedBloom:
    """The sharded filter on a torch device (``ShardedBloom.put``), with
    the ``DeviceBloom`` probe surface. It has no exact-gram refinement, as
    in the reference: the host verifier walks the union bitmap as
    probed."""

    words: object  # torch [S, k, v, 128] int32
    cfg: BloomConfig
    max_pat_len: int
    exact = None  # no refinement attached (a class attribute, not a field)

    def hits(self, data, bounds) -> BloomHits:
        """data: ``[C, T]`` lane-major symbols; bounds: ``[2, C]``
        start_t/end_t — both on this filter's device."""
        meta, bits = sharded_hits(data, bounds, self.words, self.cfg)
        return BloomHits(meta=meta, bits=bits)

    def probe_total(self, data, start_t, end_t):
        """Benchmark hook: union survivor total (runs all S probes)."""
        total, _ = sharded_hits(data, torch.stack([start_t, end_t]),
                                self.words, self.cfg)
        return total[0]


# ------------------------------------------------------------------ the grid


def check_grid(world_size: int, n_shards: int) -> None:
    """Raise ValueError, naming both numbers, unless ``world_size`` ranks
    split into ``n_shards`` pattern shards of equal data columns."""
    if n_shards < 1 or world_size % n_shards:
        raise ValueError(
            f"{world_size} ranks do not split into {n_shards} pattern "
            f"shards: each rank holds one pattern shard of one lane column")


@dataclasses.dataclass
class Mesh2DContext:
    """This rank's place in the ("pat", "data") grid: the world, its data
    column (``col``: the S ranks that hold the column's lanes, one shard
    each, in shard order) and its pattern shard's row (``row``: the D
    ranks that hold that shard, in column order)."""

    world: MeshContext  # the default group
    col: MeshContext  # the column group
    row: MeshContext  # the row group

    @staticmethod
    def build(world: MeshContext, n_shards: int) -> "Mesh2DContext":
        """The grid of the world's ranks: rank r holds shard ``r % S`` of
        column ``r // S`` (so a column's ranks are contiguous). Collective
        over the world: every rank makes every group in one order."""
        W, S = world.world_size, n_shards
        check_grid(W, S)
        D = W // S
        cols = [tuple(range(d * S, (d + 1) * S)) for d in range(D)]
        rows = [tuple(range(s, W, S)) for s in range(S)]
        col_groups = [dist.new_group(list(c), timeout=group_timeout())
                      for c in cols]
        row_groups = [dist.new_group(list(r), timeout=group_timeout())
                      for r in rows]
        s, d = world.rank % S, world.rank // S
        return Mesh2DContext(
            world=world,
            col=MeshContext(s, S, world.device, world.backend, col_groups[d],
                            cols[d]),
            row=MeshContext(d, D, world.device, world.backend, row_groups[s],
                            rows[s]),
        )

    @property
    def n_shards(self) -> int:
        return self.col.world_size

    @property
    def data_size(self) -> int:
        return self.row.world_size

    @property
    def pat_index(self) -> int:
        return self.col.rank

    @property
    def data_index(self) -> int:
        return self.row.rank

    @property
    def is_leader(self) -> bool:
        """Whether this rank feeds and decodes its column."""
        return self.col.rank == 0


def gathered_union(grid: Mesh2DContext, data, bounds, words, cfg):
    """The column's union bitmap ``[W, C_local]``: this rank's shard probed
    on its lanes (K1/K2, one flat launch), the column's bitmaps gathered
    and ORed."""
    check_lanes(data.shape[0])
    _total, bits = bloom.hits(data, bounds, words, cfg)
    bits_all = grid.col.all_gather(bits)  # [S, W, C_local], a new tensor
    union = bits_all[0]
    for b in bits_all[1:]:
        union |= b
    return union


def make_pattern_sharded_bloom_step(grid: Mesh2DContext, shard_bloom):
    """The grid's probe: ``step(words, data [C_local, T], bounds) -> (meta
    [2], union [W, C_local])`` with ``words`` this rank's shard
    (``ShardedBloom.put_shard``). ``meta = [global union total, largest
    column's union total]``: the union's popcount summed and maxed over
    the row group (every column once), the capacity bound of the grid's
    device verify."""
    cfg = shard_bloom.cfg

    def step(words, data, bounds):
        union = gathered_union(grid, data, bounds, words, cfg)
        local = bloom.popcount(union)
        meta = torch.cat([grid.row.all_reduce(local.clone(), "sum"),
                          grid.row.all_reduce(local.clone(), "max")])
        return meta, union

    return step


# ------------------------------------------------------ all-device count path


def pad_shard_tables(tables) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Stack per-shard dense tables: [S, states_max * A] signed goto rows
    and [S, states_max] state->group ids, zero-padded (padded states are
    unreachable: walks start at state 0 of each shard's own automaton).
    Returns (table_flat, state_gid, lmax, gmax)."""
    A = tables[0].alphabet_size
    smax = max(t.num_states for t in tables)
    S = len(tables)
    flat = np.zeros((S, smax * A), np.int32)
    gids = np.zeros((S, smax), np.int32)
    for s, t in enumerate(tables):
        flat[s, : t.num_states * A] = np.ascontiguousarray(
            t.goto_signed
        ).reshape(-1)
        gids[s, : t.num_states] = t.state_gid.astype(np.int32)
    lmax = max(t.max_pat_len for t in tables)
    gmax = max(t.num_groups for t in tables)
    return flat, gids, lmax, gmax


def shard_table(table, part):
    """The dense table of the patterns ``part`` (global ids) of ``table``,
    compiled alone: one shard's table."""
    ac = AhoCorasick(table.alphabet_size,
                     nocase=getattr(table, "nocase", False))
    for pid in part:
        ac.add_pattern(table.patterns[pid].symbols)
    return ac.compile()


def shard_dims(grid: Mesh2DContext, table) -> tuple[int, int]:
    """(lmax, gmax) over the S shard tables of this rank's column: the
    longest pattern and the most groups, by one MAX over the column (each
    rank holds only its own table)."""
    t = torch.tensor([table.max_pat_len, table.num_groups],
                     dtype=torch.int64, device=grid.world.device)
    lmax, gmax = grid.col.all_reduce(t, "max").tolist()
    return int(lmax), int(gmax)


def shard_exact_table(shard_gram_keys, s: int, cfg: BloomConfig,
                      alphabet_size: int, device):
    """Shard ``s``'s exact-gram table on ``device``, built with every
    shard's under shared constants (``tables_from_keys_common``) and the
    shards' least member count (``n`` only feeds the empty-set early-out),
    so that its arrays equal the reference's stacked shard tables'."""
    xts = tables_from_keys_common(shard_gram_keys, cfg.q,
                                  bits=(alphabet_size - 1).bit_length())
    xt = dataclasses.replace(xts[s], n=min(t.n for t in xts))
    return DeviceExact.put(xt, cfg.fold_case, device)


def make_pattern_sharded_count_step(grid: Mesh2DContext, shard_bloom, table,
                                    *, halo: int, k_cand: int = 4096,
                                    k_ev: int = 4096, shard_gram_keys=None,
                                    k_walk: int | None = None):
    """Probe + device verify + count on the grid, with the TABLE sharded:
    this rank walks its column's union bitmap against its own shard's
    ``table`` (W2), refined by its own shard's exact gram set when
    ``shard_gram_keys`` (every shard's, ``ShardedBloom.shard_gram_keys``)
    are given, so bloom false positives and other shards' true grams die
    before the walk.

    Returns ``step(words, table_flat, state_gid, data, bounds) -> (gcounts
    [S, Gmax], n_events [S], flags [S])``, the same on every rank: a
    shard's counts and events summed over its row group, its flags ORed
    there (per-bit MAX), then gathered over the column. Map ``gcounts``
    to per-pattern counts with :func:`global_pattern_counts`. Events are
    per SHARD: patterns co-terminating across shards count one event in
    each shard's total (per-pattern counts are unaffected). The
    capacities are fixed; ``flags[s] != 0`` means shard s's row is
    incomplete. Building the step makes one collective (``shard_dims``)."""
    cfg = shard_bloom.cfg
    lmax, gmax = shard_dims(grid, table)
    dx = None if shard_gram_keys is None else shard_exact_table(
        shard_gram_keys, grid.pat_index, cfg, table.alphabet_size,
        grid.world.device)
    kw = k_walk if k_walk is not None else k_cand

    def step(words, table_flat, state_gid, data, bounds):
        union = gathered_union(grid, data, bounds, words, cfg)
        meta, _packed, gcounts = verify_candidates(
            table_flat, state_gid, data, bounds, union, dx,
            alphabet_size=table.alphabet_size, stride=cfg.stride, q=cfg.q,
            lmax=lmax, halo=halo, k_cand=k_cand, k_ev=k_ev,
            num_groups=gmax, k_walk=kw)
        sums = grid.row.all_reduce(torch.cat([meta[:1], gcounts]))
        flags = grid.row.all_reduce(flag_bits(meta[3]), "max").sum()
        rows = grid.col.all_gather(torch.cat([sums, flags.reshape(1)]))
        return rows[:, 1:-1], rows[:, 0], rows[:, -1]

    return step


def global_pattern_counts(sharded: ShardedBloom, shard_tables,
                          gcounts) -> np.ndarray:
    """Map per-shard per-group counts [S, Gmax] to global per-pattern
    counts [n_patterns]: shard-local group g expands to its member
    patterns, which translate through the shard's id map. Exact for every
    pattern (a pattern lives in exactly one shard)."""
    n_pats = sum(len(p) for p in sharded.parts)
    out = np.zeros(n_pats, np.int64)
    gcounts = np.asarray(gcounts)
    for s, t in enumerate(shard_tables):
        part = sharded.parts[s]
        for g, pids in enumerate(t.groups_as_lists()):
            c = int(gcounts[s, g])
            if c:
                for pid in pids:
                    out[part[pid]] += c
    return out


# ------------------------------------------------------ device-exact events


def gather_varlen(ctx, arrays: list[np.ndarray]) -> list[list[np.ndarray]]:
    """Every rank's int64 1-D ``arrays`` (the same number on each), over
    ``ctx``'s group: ``out[rank][i]``. One ``all_gather`` of the lengths,
    then one of the arrays padded to the longest (none when all are
    empty)."""
    dev = ctx.device
    lens = ctx.all_gather(torch.tensor([len(a) for a in arrays],
                                       dtype=torch.int64, device=dev))
    lens = lens.cpu().numpy()
    cap = int(lens.max()) if lens.size else 0
    if not cap:
        return [[np.zeros(0, np.int64) for _ in arrays] for _ in lens]
    pad = np.zeros((len(arrays), cap), np.int64)
    for i, a in enumerate(arrays):
        pad[i, : len(a)] = a
    got = ctx.all_gather(torch.from_numpy(pad).to(dev)).cpu().numpy()
    return [[got[r, i, : lens[r, i]] for i in range(len(arrays))]
            for r in range(len(lens))]


class PshardDeviceVerifier(DeviceVerifier):
    """Device-exact events on the grid: the flat ``DeviceVerifier`` (one
    capacity ladder) given this rank's shard ``table``, its own shard's
    exact gram set and the grid.

    Every dispatch's needs reduce over the WORLD (SUM and MAX of events,
    MAX of refined candidates, OR of the flags), so every rank retries
    together; its group counts reduce over the ROW group. Past
    ``MAX_DEVICE_CAND`` a rank verifies its lanes in lane passes, as on
    the data mesh (the reference falls back to the host). ``verify_rows``
    then gathers the column's event rows to its leader."""

    def __init__(self, grid: Mesh2DContext, sharded: ShardedBloom, table,
                 halo: int):
        super().__init__(table, sharded.cfg, halo, grid.world.device,
                         mesh=grid.world)
        self.grid = grid
        self.lmax, self.num_groups = shard_dims(grid, table)
        keys = sharded.shard_gram_keys
        if keys is not None and all(len(k) for k in keys):
            self.exact = shard_exact_table(keys, grid.pat_index, sharded.cfg,
                                           table.alphabet_size,
                                           grid.world.device)
        self.state_gid_host = table.state_gid
        # every shard's groups as global pattern ids (offsets, pids), for
        # the leader's merge
        part = np.asarray(sharded.parts[grid.pat_index], np.int64)
        got = gather_varlen(grid.col, [
            np.asarray(table.group_offsets, np.int64),
            part[np.asarray(table.group_pids, np.int64)]])
        self.shard_groups = [tuple(g) for g in got]

    def _reduce(self, meta, gcounts):
        return reduce_verify(self.grid.world, meta, gcounts, self.grid.row)

    def _reduce_counts(self, n_events: int, gcounts):
        n = allreduce_host_counts(np.array([n_events], np.int64),
                                  self.grid.world)[0]
        return n, allreduce_host_counts(gcounts.astype(np.int64),
                                        self.grid.row)

    def verify_rows(self, data, bounds, bits, total_max: int):
        """``(shards, lanes, ends, gids, gcounts)``: on the column's leader
        every shard's event rows of the column's lanes (shard-local group
        ids, shard order), elsewhere none; ``gcounts [S, Gmax]`` the
        shards' group counts summed over their rows, on every rank. Every
        rank calls it together, with the probe's largest column total."""
        _meta, packed, gc = self.verify(data, bounds, bits, total_max)
        lanes, ends, states = packed.astype(np.int64)
        gids = self.state_gid_host[states].astype(np.int64)
        got = gather_varlen(self.grid.col, [lanes, ends, gids,
                                            gc.astype(np.int64)])
        gcounts = np.stack([g[3] for g in got]).astype(np.int32)
        if not self.grid.is_leader:
            z = np.zeros(0, np.int64)
            return z, z, z, z, gcounts
        shards = np.concatenate([np.full(len(g[0]), s, np.int64)
                                 for s, g in enumerate(got)])
        return (shards, *(np.concatenate([g[i] for g in got])
                          for i in range(3)), gcounts)


def merge_shard_rows(shards, lanes, ends, gids, shard_groups):
    """Merge per-shard event rows into global events, vectorised.

    A pattern lives in exactly one shard, so the union over shards of the
    per-shard co-terminating sets at one (lane, end) is the global
    co-terminating set there. Row i's group ``gids[i]`` of shard
    ``shards[i]`` expands to its global pattern ids through
    ``shard_groups[s] = (offsets, pids)``. Returns ``(lanes [E], ends [E],
    bounds [E + 1], pids)``: events in (lane, end) order, event e's
    patterns ``pids[bounds[e]:bounds[e + 1]]`` ascending."""
    n_groups = [len(off) - 1 for off, _ in shard_groups]
    g_base = np.concatenate([[0], np.cumsum(n_groups)]).astype(np.int64)
    p_base = np.concatenate(
        [[0], np.cumsum([len(p) for _, p in shard_groups])]).astype(np.int64)
    starts = np.concatenate([off[:-1] + p_base[s] for s, (off, _) in
                             enumerate(shard_groups)]).astype(np.int64)
    sizes = np.concatenate([np.diff(off) for off, _ in shard_groups]
                           ).astype(np.int64)
    all_pids = np.concatenate([p for _, p in shard_groups]).astype(np.int64)
    gg = g_base[np.asarray(shards, np.int64)] + np.asarray(gids, np.int64)
    n = sizes[gg]
    total = int(n.sum())
    row_of = np.repeat(np.arange(len(gg)), n)
    within = np.arange(total) - np.repeat(np.cumsum(n) - n, n)
    pid = all_pids[np.repeat(starts[gg], n) + within]
    ln = np.asarray(lanes, np.int64)[row_of]
    e = np.asarray(ends, np.int64)[row_of]
    order = np.lexsort((pid, e, ln))
    ln, e, pid = ln[order], e[order], pid[order]
    new = np.ones(total, bool)
    new[1:] = (ln[1:] != ln[:-1]) | (e[1:] != e[:-1])
    first = np.flatnonzero(new)
    return ln[first], e[first], np.append(first, total), pid
