"""Pattern-set sharding on one device (port of the single-device half of
the reference's ``parallel/pshard.py``).

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

On the card the S probes are S launches of the same probe kernel into
one bitmap, each ORing into the words of the one before, the last one
counting the union's popcount (``ops.bloom.or_shards``); on the CPU the
plain version ORs S plain probes. The reference's ("pat", "data") mesh
(``Mesh2DContext`` and everything below it) waits for the second half of
the multi-GPU port (ROADMAP queue 1, item 11b); the 1-D data mesh is
``parallel/mesh.py``.

``ShardedBloom`` dumps (``save``/``load``) use the reference's npz keys,
so a dump written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_pattern_matching_torch.ops import bloom
from tpu_pattern_matching_torch.ops.bloom import (
    BloomConfig,
    BloomFilterTable,
    BloomHits,
    config_from_reference,
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
        import torch

        return DeviceShardedBloom(
            words=torch.from_numpy(
                np.ascontiguousarray(self.words, np.int32)
            ).to(device),
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
        import torch

        total, _ = sharded_hits(data, torch.stack([start_t, end_t]),
                                self.words, self.cfg)
        return total[0]
