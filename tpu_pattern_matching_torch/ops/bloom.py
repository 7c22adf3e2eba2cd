"""q-gram bloom-filter engine: host build + device probe (torch / CUDA).

Port of the reference's ``ops/bloom.py``. The host half — ``BloomConfig``,
the chooser and ``BloomFilterTable`` (build, ``expected_cand_rate``, the
npz dump format) and ``unpack_hit_rows`` — is a faithful copy: the
reference module imports ``jax`` at its top, and the machine with the GPU
has no ``jax``. The chooser keeps the reference's TPU-priced cost model on
purpose (ops/costmodel.py), so both packages build bit-identical filters;
it is not a GPU choice.

The device half runs one batch:

1. ``prep_time_major`` pads lanes to 128 and time to the tile height and
   transposes to time-major, so a warp's 32 threads (one lane each) read
   32 adjacent symbols per row — uint8 bytes, or uint16 tokens for the
   ushort alphabet of 2048 (packet metadata); its packed form (strided
   configs with ``stride % 4 == 0``, bytes only) transposes uint32 words
   of 4 bytes instead;
2. ``probe_bits`` writes the survivor bitmap ``[T/(32*stride), Cp]`` and
   its popcount: the hand-written CUDA kernels of ``csrc/`` for a CUDA
   tensor (sampled and strided at either symbol width, packed strided),
   the plain PyTorch version below for a CPU tensor;
3. ``hits_refined`` compacts the survivors, checks each against the exact
   inserted gram set (ops/exact_gram.py; 8-bit keys for bytes, 11-bit
   for the ushort alphabet) and scatters the members into a
   fresh bitmap; past the ``k_ref`` capacity the unrefined bitmap passes
   through unchanged.

Pattern shards (``parallel/pshard.py``): ``sharded_probe_bits`` probes
one batch with S filters under one config into one union bitmap and its
popcount — on the card S launches of the same kernels, each ORing into
the bitmap of the one before (``or_shards``), the last one counting.

Bitmap contract (shared with ``bitmap_to_candidates`` and
``unpack_hit_rows``): bit b of ``bits[w, c]`` is the gram starting at row
``(w*32 + b) * stride`` of lane c.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from tpu_pattern_matching_torch.utils.debug import kernel_debug

MASK32 = 0xFFFFFFFF
MAX_BANKS_PER_KERNEL = 8  # the TPU kernel's bank-group size; only the
# chooser's cost model uses it here (the CUDA kernels probe all k banks in
# one pass, and their bitmap equals the reference's AND of the groups)
REFINE_HEADROOM = 2.0  # k_ref capacity = headroom x modeled candidate rate
# x batch positions (runtime/session.py). The refinement stage's cost is
# linear in the CAPACITY bucket, so headroom is a real per-batch tax;
# overflow is graceful (the unrefined bitmap passes through and the host
# absorbs it), so modest headroom + the {1,1.5}x2^k next_cap ladder is the
# trade the reference chose.
GT = 64  # stride-groups (tested rows) per tile; shapes the bitmap's
# time padding (``cfg.tile_rows``), so it stays part of the contract
MAX_LANE_TILE = 1024  # TPU lane-tile width; kept in cfg for the npz format


def probe_cost_units(q: int, k: int, v: int, *, s: int = 1, w: int = 0
                     ) -> float:
    """Model element-ops per input byte for a probe config — the chooser's
    probe-cost currency, and the unit the calibrator (ops/costmodel.py)
    prices in ns on the attached chip.

    hash (2.5/symbol) + k banks of (index math + v gathers&selects);
    strided amortizes over the stride, sampled pays every position plus
    ~3 ops per window step for the winnowing min chains. The penalty
    factors (non-pow2 strides, bank groups past MAX_BANKS_PER_KERNEL, the
    unroll budget, the strided 1.3x) were fitted to the TPU kernels by the
    reference; they are kept unchanged so the port makes the reference's
    picks (a GPU cost model is ROADMAP queue 1, chooser pricing)."""
    if w:
        c = 2.5 * q + 3.0 * w + k * (4 + 5 * v)
    else:
        c = (2.5 * q + k * (4 + 5 * v)) / s
        if s not in (1, 2, 4, 8, 16):
            c *= 1.6
        c *= 1.3
    groups = -(-k // MAX_BANKS_PER_KERNEL)
    c *= 1 + 0.5 * (groups - 1)
    if min(k, MAX_BANKS_PER_KERNEL) * v * 8 > 1024:
        c *= 1.3
    return c


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    """Static shape/hash parameters (hashable: used as a jit static arg).

    Two sampling modes select which gram positions are tested:

    - **strided** (``sampled=False``): positions at multiples of ``stride``;
      grams inserted at pattern offsets 0..stride-1 (bloom load =
      stride x patterns).
    - **sampled/winnowing** (``sampled=True``): every position is hashed;
      a position is tested iff it is the rightmost-argmin of some
      ``w``-window of the selection hash (Schleimer et al. winnowing).
      The builder inserts only each pattern's per-window rightargmin grams
      (~1 gram/pattern when pattern length ~= lmin), cutting bloom load
      ~stride-fold — the enabler for 100k+ pattern sets, where strided
      mode's bloom capacity (k*v gather chains) is the wall.
    """

    q: int  # gram length (symbols)
    stride: int  # tested-position stride; q <= stride (strided mode; 1 when sampled)
    kbanks: int  # independent bloom banks (ALL must hit)
    v: int  # 4096-bit units per bank
    mix1: tuple[int, ...]  # per-symbol odd multipliers, hash 1
    mix2: tuple[int, ...]  # per-symbol odd multipliers, hash 2
    fold_case: bool = False  # ASCII-fold input symbols before hashing
    gt: int = GT  # tested rows per tile; multiple of 32
    ct: int = MAX_LANE_TILE  # lane-tile width; multiple of 128
    blockwise: bool = False  # TPU layout knob, kept for the npz format;
    # the CUDA kernels ignore it and ``ct``
    sampled: bool = False  # winnowing selection instead of strided
    w: int = 0  # winnowing window (gram positions); w <= lmin - q + 1

    @property
    def bits(self) -> int:
        return self.kbanks * self.v * 4096

    @property
    def tile_rows(self) -> int:
        return self.gt * self.stride


def config_from_reference(c) -> BloomConfig:
    """The port's ``BloomConfig`` from the reference package's (or any
    object with its fields)."""
    return BloomConfig(**{
        f.name: (tuple(int(x) for x in getattr(c, f.name))
                 if f.name in ("mix1", "mix2") else getattr(c, f.name))
        for f in dataclasses.fields(BloomConfig)
    })


def _hash_fields_np(m1, m2, b, v):
    """Host model of the device hash (uint64 arrays masked to 32 bits)."""
    h = (m1 + b * m2) & MASK32
    h = h ^ (h >> np.uint64(13))
    vi = (h >> np.uint64(17)) & np.uint64(v - 1)
    w7 = (h >> np.uint64(10)) & np.uint64(127)
    bit = (h >> np.uint64(5)) & np.uint64(31)
    return vi, w7, bit


def _grams_of(symbols: Sequence[int], q: int, offsets) -> list[tuple]:
    s = list(symbols)
    return [tuple(s[o : o + q]) for o in offsets if o + q <= len(s)]


def _sel_hash_np(m1: np.ndarray) -> np.ndarray:
    """Host model of the device selection hash (31-bit, so INT32_MAX can
    serve as the out-of-bounds sentinel on device)."""
    h = (m1 ^ (m1 >> np.uint64(13))) & np.uint64(MASK32)
    return h & np.uint64(0x7FFFFFFF)


def _winnow_grams(pats: list[list[int]], q: int, w: int, mix1) -> set:
    """Winnowing fingerprint gram set over a whole pattern list,
    vectorized per length group (the per-pattern Python loop is minutes at
    100k patterns; this is milliseconds)."""
    from numpy.lib.stride_tricks import sliding_window_view

    by_len: dict[int, list[list[int]]] = {}
    for p in pats:
        by_len.setdefault(len(p), []).append(p)
    mix = np.asarray(mix1[:q], np.uint64)
    grams: set = set()
    for L, group in by_len.items():
        arr = np.asarray(group, np.uint64)  # [N, L]
        M = L - q + 1
        if M < w:
            # coverage needs a full w-window of gram positions inside
            # every pattern (w <= Lmin - q + 1, enforced by the chooser)
            raise ValueError(f"pattern length {L} too short for q={q} w={w}")
        m1 = np.zeros((len(group), M), np.uint64)
        for i in range(q):
            m1 = (m1 + arr[:, i : i + M] * mix[i]) & np.uint64(MASK32)
        h = _sel_hash_np(m1)  # [N, M]
        win = sliding_window_view(h, w, axis=1)  # [N, M-w+1, w]
        # rightmost argmin = (w-1) - argmin of the reversed window
        ridx = (w - 1) - np.argmin(win[:, :, ::-1], axis=2)  # [N, M-w+1]
        offs = ridx + np.arange(M - w + 1)[None, :]
        barr = arr.astype(np.uint16)
        for r in range(len(group)):
            row = barr[r]
            for o in set(offs[r].tolist()):
                grams.add(tuple(int(x) for x in row[o : o + q]))
    return grams


@dataclasses.dataclass
class BloomFilterTable:
    """Host-side compiled filter: bloom words + config + diagnostics."""

    words: np.ndarray  # [kbanks, v, 128] int32 (bit-packed)
    cfg: BloomConfig
    max_pat_len: int
    n_grams: int
    fp_est: float  # expected false-positive rate per tested position
    gram_keys: np.ndarray | None = None  # sorted uint64 packed gram keys
    # (the EXACT inserted set, ops/exact_gram.pack_grams layout at
    # ``gram_bits`` per symbol) — feeds the exact-membership refinement
    # stage; None when q*bits > 64 or for loads of pre-refinement dumps
    # (refinement silently unavailable)
    alphabet_size: int = 256  # symbol universe (2048 for the ushort mode)

    @property
    def gram_bits(self) -> int:
        """Symbol width of the gram_keys packing (8 byte / 11 ushort)."""
        return (self.alphabet_size - 1).bit_length()

    @staticmethod
    def from_table(table, **kw) -> "BloomFilterTable":
        """Build from a compiled :class:`core.dfa.DfaTable` (byte or ushort
        alphabet; byte patterns are already case-folded when
        table.nocase)."""
        return BloomFilterTable.build(
            [p.symbols for p in table.patterns],
            alphabet_size=table.alphabet_size,
            fold_case=getattr(table, "nocase", False),
            **kw,
        )

    @staticmethod
    def build(
        patterns: Sequence[Sequence[int] | bytes],
        fp_target: float = 1e-3,
        max_v: int = 16,
        max_k: int = 16,
        max_stride: int = 16,
        seed: int = 0x5EED,
        fold_case: bool = False,
        alphabet_size: int = 256,
        mode: str = "auto",
        force: tuple | None = None,  # ("strided", q, s, k, v) or
        # ("sampled", q, w, k, v): bypass the chooser (A/B experiments
        # validating the cost model against the chip, exp_verify_ab.py)
        objective: str = "refined",
        verify_ns_per_cand: float | None = None,  # host verify cost per
        # candidate; None reads the constants
        # (ops/costmodel.get_cost_constants)
        rate_scale: float = 1.0,  # candidate-rate multiplier for verify
        # pricing and eligibility: the sharded build (parallel/pshard.py)
        # passes S, because the verifier walks the UNION of S shard
        # bitmaps — per-shard fp sums over shards while probe cost per
        # CHIP stays per-shard on a ("pat","data") mesh. Without this the
        # probe objective's cap admits configs whose union candidate
        # flood no verifier absorbs
    ) -> "BloomFilterTable":
        """Compile the filter, choosing (mode, q, stride/w, kbanks, v).

        Two sampling modes compete in the search (``mode="auto"``; force
        with "strided"/"sampled"):

        **strided** — coverage needs grams at pattern offsets 0..stride-1
        for ANY stride <= Lmin-q+1; the kernel's window trick needs
        q <= stride. Larger stride costs fewer probes per byte but loads
        the bloom with stride grams per pattern (worse fp).

        **sampled (winnowing)** — every position hashes, a position is
        tested iff it is the rightmost-argmin of some w-window; the bloom
        holds only each pattern's per-window rightargmin grams (~1 per
        pattern at L ~= Lmin). ~stride-x more probe work per byte, but
        bloom load drops ~stride-fold — past ~30k patterns (where strided
        k*v hits the 128-words-per-gather ceiling) this is the only way to
        keep the candidate rate down (BENCH_NOTES.md round-1 plan).

        kbanks beyond MAX_BANKS_PER_KERNEL split across ANDed kernel
        invocations, so large pattern sets can buy fp headroom with extra
        probe passes.

        ``objective`` picks what the search minimizes:

        - "refined" (default) — the PIPELINED per-byte cost of the
          pipeline sessions actually run: the device pays probe +
          on-device exact-gram refinement (fixed top_k + a headroom-scaled
          per-slot marginal), the host pays only the true-gram residue.
          A config whose grams cannot pack into one uint64 key
          (q*bits > 64 — never hit by byte alphabets, q > 5 for the
          ushort/2048 alphabet) runs unrefined, so it is priced with the
          "joint" formula instead.
        - "joint" — max(probe_ns, rate x verify_ns_per_cand): the
          UNREFINED host-verify pipeline (probe and host verify overlap in
          scan_stream, the slower stage is the throughput). The peak
          single-chip mode when a spare host core exists and the bitmap
          D2H is cheap.
        - "probe" — legacy probe-cost objective with a soft verify
          surcharge (the round-2 rule; kept for probe-only benchmarking
          continuity, bench.py primary metric).

        If no config meets the eligibility rate cap, the lowest-rate one
        wins — correctness never depends on fp, only verify cost does.
        """
        if fold_case and alphabet_size != 256:
            raise ValueError("fold_case requires the byte alphabet")
        if mode not in ("auto", "strided", "sampled"):
            raise ValueError(f"unknown mode {mode!r}")
        pats = [list(p) for p in patterns]
        if not pats:
            raise ValueError("no patterns")
        sym_bits = (alphabet_size - 1).bit_length()
        lmin = min(len(p) for p in pats)
        lmax = max(len(p) for p in pats)
        q_max = max(1, min(6, (lmin + 1) // 2))

        rng = np.random.RandomState(seed)
        # fixed-size draw (q never exceeds 8): the mix streams must not
        # depend on lmin, so pattern SUBSETS built with the same seed get
        # identical mixes — the sharded build (parallel/pshard.py) relies
        # on one config probing every shard's filter
        mix1_full = tuple(int(x) | 1 for x in rng.randint(1, 2**31, size=8))
        mix2_full = tuple(int(x) | 1 for x in rng.randint(1, 2**31, size=8))

        def n_est(q, s):
            return sum(min(s, len(p) - q + 1) for p in pats)

        _fingerprints: dict[tuple[int, int], int] = {}

        def n_sampled(q, w):
            # exact winnowing fingerprint count (the real insertion set)
            if (q, w) not in _fingerprints:
                _fingerprints[(q, w)] = len(
                    _winnow_grams(pats, q, w, mix1_full)
                )
            return _fingerprints[(q, w)]

        def candidate_rate(q, n, k, v, *, s=1, w=0):
            # expected candidates per input byte on uniform data: true gram
            # occurrences (the filter cannot reject a gram that IS in the
            # set — this is what kills tiny q for large sets) + bloom fp.
            # Strided: amortized over the stride. Sampled: only selected
            # positions (density ~2/(w+1)) can become candidates.
            universe = float(alphabet_size) ** q
            distinct = universe * -np.expm1(-n / universe)
            true_rate = distinct / universe
            fp = float((1.0 - np.exp(-n / (v * 4096.0))) ** k)
            if w:
                return (min(1.0, true_rate) + fp) * 2.0 / (w + 1)
            return (min(1.0, true_rate) + fp) / s

        def true_rate_of(q, n, *, s=1, w=0):
            # the component of candidate_rate the exact-gram refinement
            # CANNOT erase: grams literally in the inserted set
            universe = float(alphabet_size) ** q
            tr = min(1.0, universe * -np.expm1(-n / universe) / universe)
            return tr * 2.0 / (w + 1) if w else tr / s

        probe_cost = probe_cost_units

        best = None  # (objective, q, s, w, k, v) meeting the rate cap
        fallback = None  # (rate, cost, q, s, w, k, v) best-effort

        # Priced hardware (ops/costmodel.py): env/cache-file constants
        # with the reference's TPU numbers as fallback. The meanings:
        # PROBE_NS_PER_UNIT — ns/byte per probe_cost_units unit.
        # Exact-gram refinement pricing (objective="refined"): the
        # refinement runs ON DEVICE in the probe's jit, so its cost adds
        # to the device side while the host sees only true-gram
        # candidates: a fixed stage-1 top_k term per byte (1/stride the
        # words on strided bitmaps) + a per-CAPACITY-SLOT marginal
        # (stage-2 compaction + q gram gathers + dmax exact probes +
        # scatter-back, all linear in k_ref). Slots are sized
        # REFINE_HEADROOM x modeled rate (runtime/session.py uses the
        # same constant), so the per-candidate price is headroom-scaled.
        # VERIFY_NS_PER_CAND — host native-walker cost per candidate.
        from tpu_pattern_matching_torch.ops.costmodel import get_cost_constants

        _cc = get_cost_constants(alphabet_size)
        PROBE_NS_PER_UNIT = _cc.probe_ns_per_unit
        REFINE_NS_PER_SLOT = _cc.refine_ns_per_slot
        REFINE_FIXED_NS_PER_BYTE = _cc.refine_fixed_ns_per_byte
        if verify_ns_per_cand is None:
            verify_ns_per_cand = _cc.verify_ns_per_cand

        # Legacy probe-objective surcharge (round-2 rule, kept for
        # objective="probe"): a soft verify tax + throughput-coupled cap.
        VERIFY_UNITS = 1800.0

        # a config can run refined iff its grams pack into one uint64 key
        # (ops/exact_gram.pack_grams): q*bits <= 64 — always true for byte
        # alphabets at q <= 8, and for the ushort alphabet at q <= 5
        def refinable(q):
            return q * sym_bits <= 64

        def rate_cap(cost):
            if objective == "refined":
                # the device-side refine stage absorbs floods the host
                # never sees; cap only what the compaction capacity
                # (k_ref <= MAX_DEVICE_CAND per ~16 MiB batch) can hold
                return max(fp_target, 5e-3)
            if objective == "joint":
                # eligibility only guards against candidate floods the
                # decode path cannot absorb; the objective itself prices
                # verify correctly
                return max(fp_target, 1e-2)
            return max(fp_target, min(4e-3, 2e-5 * cost))

        def consider(rate, true_rate, cost, q, s, w, k, v):
            nonlocal best, fallback
            rate = rate * rate_scale  # union rate over pattern shards
            true_rate = true_rate * rate_scale
            if rate <= rate_cap(cost):
                if objective == "refined" and refinable(q):
                    # device: probe + on-device exact-gram refinement of
                    # ALL candidates; host: native walk of the TRUE-gram
                    # residue only (bloom fp never crosses the D2H)
                    dev_ns = (
                        cost * PROBE_NS_PER_UNIT
                        + REFINE_FIXED_NS_PER_BYTE / s
                        + rate * REFINE_HEADROOM * REFINE_NS_PER_SLOT
                    )
                    host_ns = true_rate * verify_ns_per_cand
                    obj = max(dev_ns, host_ns) + 0.05 * (dev_ns + host_ns)
                elif objective in ("joint", "refined"):
                    # unrefinable config under the refined objective
                    # (q*bits > 64): the session runs it UNREFINED, so
                    # price the host-verify pipeline it will actually get
                    probe_ns = cost * PROBE_NS_PER_UNIT
                    ver_ns = rate * verify_ns_per_cand
                    # probe (device) and verify (host/device stage)
                    # overlap in the pipeline: the slower stage IS the
                    # throughput; the small sum term breaks ties toward
                    # less total work
                    obj = max(probe_ns, ver_ns) + 0.05 * (probe_ns + ver_ns)
                else:
                    obj = cost + rate * VERIFY_UNITS
                if best is None or obj < best[0]:
                    best = (obj, q, s, w, k, v)
                return True
            if fallback is None or rate < fallback[0] or (
                rate == fallback[0] and cost < fallback[1]
            ):
                fallback = (rate, cost, q, s, w, k, v)
            return False

        # the legacy probe objective is monotone in v (more filter only
        # costs), so its v loop breaks at first eligibility; the joint/
        # refined objectives are NOT (more filter can pay for itself in
        # verify savings) — scan every v
        scan_all_v = objective in ("joint", "refined")

        if force is not None:
            mode = "none"  # skip the search entirely: a forced config
            # must not pay the chooser's per-(q,w) winnowing passes
            # (minutes at 100k+ patterns — the sharded build forces
            # S-1 of its S shard filters, parallel/pshard.py)
        if mode in ("auto", "strided"):
            for q in range(1, q_max + 1):
                for s in range(q, min(max_stride, lmin - q + 1) + 1):
                    n = n_est(q, s)
                    tr = true_rate_of(q, n, s=s)
                    for k in range(2, max_k + 1):
                        v = 1
                        while v <= max_v:
                            rate = candidate_rate(q, n, k, v, s=s)
                            c = probe_cost(q, k, v, s=s)
                            if consider(rate, tr, c, q, s, 0, k, v) and (
                                not scan_all_v
                            ):
                                break
                            v *= 2
        if mode in ("auto", "sampled"):
            # sampled mode exists for huge pattern sets, where bloom
            # capacity is the wall — let its v range stretch far past the
            # strided default (the unit fori_loop path bounds VMEM; the
            # words array tops out at k16 x v256 x 128 x 4B = 8 MB). The
            # round-3 300k point showed why: at v<=32 the filter holds
            # 286k fingerprints at fp 0.15/position — a 3.8e-2/byte
            # candidate flood no verifier absorbs; v=64-256 restores
            # usable fp at 300k-1M patterns.
            max_v_s = max(max_v, 256)
            for q in range(1, min(8, lmin) + 1):
                w_full = lmin - q + 1
                for w in sorted({min(w_full, x) for x in (4, 8, 16)}):
                    if w < 1:
                        continue
                    n = n_sampled(q, w)
                    tr = true_rate_of(q, n, w=w)
                    for k in range(2, max_k + 1):
                        v = 1
                        while v <= max_v_s:
                            rate = candidate_rate(q, n, k, v, w=w)
                            c = probe_cost(q, k, v, w=w)
                            if consider(rate, tr, c, q, 1, w, k, v) and (
                                not scan_all_v
                            ):
                                break
                            v *= 2
        if force is not None:
            fmode, q, sw, k, v = force
            s, w = (sw, 0) if fmode == "strided" else (1, sw)
            if fmode == "strided" and not (q <= s <= lmin - q + 1):
                raise ValueError(f"forced stride violates q<=s<=Lmin-q+1: {force}")
            if fmode == "sampled" and not (1 <= sw <= lmin - q + 1):
                raise ValueError(f"forced w violates 1<=w<=Lmin-q+1: {force}")
        elif best is not None:
            _, q, s, w, k, v = best
        else:
            _, _, q, s, w, k, v = fallback
        stride = s
        mix1 = mix1_full[:q]
        mix2 = mix2_full[:q]
        if w:
            grams = _winnow_grams(pats, q, w, mix1)
        else:
            grams = set()
            for p in pats:
                grams.update(_grams_of(p, q, range(stride)))
        n = len(grams)

        cfg = BloomConfig(q=q, stride=stride, kbanks=k, v=v,
                          mix1=mix1, mix2=mix2, fold_case=fold_case,
                          sampled=bool(w), w=w,
                          # the reference's tile heights; gt shapes the
                          # bitmap's time padding, so it stays
                          gt=128 if w else GT)

        words = np.zeros((k, v, 128), np.uint32)
        if grams:
            g = np.asarray(sorted(grams), np.uint64).reshape(n, q)
            m1 = np.zeros(n, np.uint64)
            m2 = np.zeros(n, np.uint64)
            for i in range(q):
                m1 = (m1 + g[:, i] * np.uint64(mix1[i])) & np.uint64(MASK32)
                m2 = (m2 + g[:, i] * np.uint64(mix2[i])) & np.uint64(MASK32)
            for b in range(k):
                vi, w7, bit = _hash_fields_np(m1, m2, np.uint64(b), v)
                np.bitwise_or.at(
                    words[b],
                    (vi.astype(np.int64), w7.astype(np.int64)),
                    np.uint32(1) << bit.astype(np.uint32),
                )
        dens = [
            float(np.unpackbits(words[b].view(np.uint8)).mean())
            for b in range(k)
        ]
        from tpu_pattern_matching_torch.utils.debug import dprint

        dprint(
            1,
            "bloom build: mode=%s q=%d stride=%d w=%d k=%d v=%d grams=%d "
            "fp_est=%.3g",
            "sampled" if w else "strided", q, stride, w, k, v, n,
            float(np.prod(dens)),
        )
        if q * sym_bits <= 64:
            from .exact_gram import pack_grams

            gram_keys = pack_grams(grams, q, sym_bits)
        else:
            gram_keys = None
        return BloomFilterTable(
            words=words.view(np.int32),
            cfg=cfg,
            max_pat_len=lmax,
            n_grams=n,
            fp_est=float(np.prod(dens)),
            gram_keys=gram_keys,
            alphabet_size=alphabet_size,
        )

    def expected_cand_rate(self) -> float:
        """Modeled candidates per input byte: true-gram occurrences on
        uniform data (the filter cannot erase a gram that IS in the set)
        plus the measured-density bloom fp, de-amortized by the sampling
        mode — the chooser's candidate_rate at the CHOSEN config, exposed
        for capacity sizing (the refined-probe k_ref bucket)."""
        cfg = self.cfg
        true = self.n_grams / float(self.alphabet_size) ** cfg.q
        per_pos = min(1.0, true) + self.fp_est
        if cfg.sampled:
            return per_pos * 2.0 / (cfg.w + 1)
        return per_pos / cfg.stride

    @staticmethod
    def from_reference(obj) -> "BloomFilterTable":
        """The port's table from the reference package's
        ``BloomFilterTable`` (or any object with its fields): the same
        words, config and exact gram keys, as numpy arrays — how a filter
        compiled by one package feeds the other."""
        keys = getattr(obj, "gram_keys", None)
        return BloomFilterTable(
            words=np.ascontiguousarray(np.asarray(obj.words), np.int32),
            cfg=config_from_reference(obj.cfg),
            max_pat_len=int(obj.max_pat_len),
            n_grams=int(obj.n_grams),
            fp_est=float(obj.fp_est),
            gram_keys=None if keys is None else np.asarray(keys, np.uint64),
            alphabet_size=int(getattr(obj, "alphabet_size", 256)),
        )

    def put(self, device) -> "DeviceBloom":
        import torch

        return DeviceBloom(
            words=torch.from_numpy(
                np.ascontiguousarray(self.words, np.int32)
            ).to(device),
            cfg=self.cfg,
            max_pat_len=self.max_pat_len,
        )


    # -- serialization (compiled-filter dump, like DfaTable.save/load) ------

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            words=self.words,
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
            n_grams=np.int64(self.n_grams),
            fp_est=np.float64(self.fp_est),
            alphabet_size=np.int64(self.alphabet_size),
            **(
                {"gram_keys": self.gram_keys}
                if self.gram_keys is not None
                else {}
            ),
        )

    @staticmethod
    def load(path: str) -> "BloomFilterTable":
        z = np.load(path)
        c = z["cfg"]
        cfg = BloomConfig(
            q=int(c[0]), stride=int(c[1]), kbanks=int(c[2]), v=int(c[3]),
            mix1=tuple(int(x) for x in z["mix1"]),
            mix2=tuple(int(x) for x in z["mix2"]),
            fold_case=bool(c[4]), gt=int(c[5]), ct=int(c[6]),
            blockwise=bool(c[7]),
            sampled=bool(c[8]) if len(c) > 8 else False,
            w=int(c[9]) if len(c) > 9 else 0,
        )
        return BloomFilterTable(
            words=z["words"],
            cfg=cfg,
            max_pat_len=int(z["max_pat_len"]),
            n_grams=int(z["n_grams"]),
            fp_est=float(z["fp_est"]),
            gram_keys=z["gram_keys"] if "gram_keys" in z.files else None,
            alphabet_size=(
                int(z["alphabet_size"])
                if "alphabet_size" in z.files
                else 256  # older dumps lack the field; 256 only
                # OVERestimates the true-gram rate for an old ushort dump
                # (larger capacity buckets — safe), and such dumps carry
                # no gram_keys so refinement stays off anyway
            ),
        )


# ----------------------------------------------------------- device half

INT32_MAX = 0x7FFFFFFF
MAX_SAMPLED_CONTEXT = 128  # w-1 rows before and w+q-2 rows after a
# tile: the reference kernel's bound (both contexts fit one gt=128 tile)


def to_int32(x):
    """int64 tensor of uint32 values -> int32 with the same bits."""
    import torch

    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32)


@dataclasses.dataclass
class BloomHits:
    """Survivor bitmap of one batch, on the device.

    ``meta[0]`` is the exact survivor count (after refinement, when it is
    on); ``bits[w, c]`` bit b is the gram starting at row
    ``(w*32 + b) * stride`` of lane c. The host fetches ``bits`` only when
    the total is not zero."""

    meta: object  # torch [1] int32
    bits: object  # torch [W, Cp] int32
    data: object = None  # torch [C, T] the batch the probe scanned, kept
    bounds: object = None  # [2, C] for the device verify stage (else None)


PACKED_AUTO = False  # the policy of hits(packed=None), as in the
# reference: the packed data path stays off until a benchmark on the card
# shows it faster (the A/B is in chip_smoke.py and PERF.md)


def packed_eligible(cfg: BloomConfig, dtype) -> bool:
    """Can ``cfg`` probe the uint32-packed layout? Strided mode with
    ``stride % 4 == 0`` over uint8 symbols: every tested row then starts a
    word, and gram symbol i sits at byte i % 4 of word row + i // 4."""
    import torch

    return (not cfg.sampled) and cfg.stride % 4 == 0 and dtype == torch.uint8


def prep_time_major(data, cfg: BloomConfig, packed: bool = False):
    """Pad a lane-major ``[C, T]`` batch of uint8 or uint16 symbols to
    ``[Cp, Tp]`` (lanes to 128, time to ``cfg.tile_rows``) and transpose
    it: ``[Tp, Cp]`` contiguous, same dtype, zero padding. ``packed``
    (uint8 only): view each 4 bytes of a padded lane as one
    int32 (byte 0 is the low byte, as the reference's bitcast) and
    transpose the words: ``[Tp/4, Cp]`` int32. Returns ``(data_tm, Cp)``."""
    import torch

    C, T = data.shape
    tt = cfg.tile_rows
    Tp = -(-T // tt) * tt
    Cp = -(-C // 128) * 128
    if not packed:
        out = torch.zeros((Tp, Cp), dtype=data.dtype, device=data.device)
        out[:T, :C] = data.t()
        return out, Cp
    if not packed_eligible(cfg, data.dtype):
        raise ValueError(f"packed probe needs a strided config with "
                         f"stride % 4 == 0 and uint8 data, got {cfg} "
                         f"{data.dtype}")
    assert Tp % 4 == 0  # tile_rows = gt * stride, stride % 4 == 0
    lm = torch.zeros((Cp, Tp), dtype=torch.uint8, device=data.device)
    lm[:C, :T] = data
    return lm.view(torch.int32).t().contiguous(), Cp


def unpack_time_major(words):
    """Packed ``[T/4, Cp]`` int32 -> ``[T, Cp]`` int64 symbols: symbol row
    4r + j is byte j of word row r (a logical shift in int64)."""
    import torch

    w = words.to(torch.int64) & MASK32
    j = torch.arange(4, dtype=torch.int64, device=words.device)
    return ((w[:, None, :] >> (8 * j)[None, :, None]) & 255).reshape(
        4 * words.shape[0], words.shape[1])


def pad_bounds(bounds, Cp: int):
    """``[2, C]`` int32 lane bounds -> ``[2, Cp]``: padding lanes get
    start == end == 0 (empty)."""
    import torch

    C = bounds.shape[1]
    out = torch.zeros((2, Cp), dtype=torch.int32, device=bounds.device)
    out[:, :C] = bounds
    return out


def probe_bits(data_tm, bounds, words, cfg: BloomConfig):
    """Survivor bitmap and popcount of one time-major batch.

    ``data_tm``: ``[T, Cp]`` uint8 or uint16 (no ``fold_case``), T a
    multiple of ``cfg.tile_rows``, Cp a multiple of 128, or the packed
    ``[T/4, Cp]`` int32 of
    ``prep_time_major(packed=True)``; ``bounds``: ``[2, Cp]`` int32
    (start_t, end_t); ``words``: ``[k, v, 128]`` int32. Returns
    ``(bits [T/(32*stride), Cp] int32, total [1] int32)``.

    A CUDA tensor goes to the hand-written kernel (ops/kernels.py) or
    raises; a CPU tensor goes to :func:`probe_bits_plain`."""
    if data_tm.is_cuda:
        from tpu_pattern_matching_torch.ops import kernels

        return kernels.launch_probe(data_tm, bounds, words, cfg)
    if data_tm.device.type != "cpu":
        raise ValueError(f"no probe for device {data_tm.device}")
    return probe_bits_plain(data_tm, bounds, words, cfg)


def _shard_count(words) -> int:
    """S of a stack of shard filters ``words [S, k, v, 128]``."""
    if words.dim() != 4 or words.shape[0] < 1:
        raise ValueError(f"words must be [S, k, v, 128] with S >= 1, got "
                         f"{tuple(words.shape)}")
    return words.shape[0]


def or_shards(launch, data_tm, bounds, words, cfg: BloomConfig):
    """The pattern-shard sequence of probe launches: ``words [S, k, v,
    128]`` holds S filters under ``cfg``; shard s is probed by ``launch``
    (``kernels.launch_probe``'s signature) into the bitmap of shard s - 1
    (``into``; shard 0 writes a new one), and only the last launch counts,
    so its total is the union's popcount. For S = 1 it is one plain
    launch. Returns ``(bits, total)`` of the union."""
    n = _shard_count(words)
    bits = total = None
    for s in range(n):
        bits, total = launch(data_tm, bounds, words[s], cfg, into=bits,
                             count=s == n - 1)
    return bits, total


def sharded_probe_bits(data_tm, bounds, words, cfg: BloomConfig):
    """Union survivor bitmap and its popcount of S filters under one
    config (``words [S, k, v, 128]``) on one time-major batch: a position
    is a candidate iff some shard's filter accepts its gram. Same inputs
    and outputs as :func:`probe_bits` otherwise.

    A CUDA tensor goes to S launches of the probe kernel (``or_shards``)
    or raises; a CPU tensor goes to :func:`sharded_probe_bits_plain`."""
    if data_tm.is_cuda:
        from tpu_pattern_matching_torch.ops import kernels

        return or_shards(kernels.launch_probe, data_tm, bounds, words, cfg)
    if data_tm.device.type != "cpu":
        raise ValueError(f"no probe for device {data_tm.device}")
    return sharded_probe_bits_plain(data_tm, bounds, words, cfg)


def sharded_probe_bits_plain(data_tm, bounds, words, cfg: BloomConfig):
    """Plain PyTorch version of :func:`sharded_probe_bits`: S calls of
    :func:`probe_bits_plain`, ORed, and the union's bits counted — the
    CPU path and what the OR-into-bitmap launches are held to on the
    card."""
    bits = None
    for s in range(_shard_count(words)):
        b, _total = probe_bits_plain(data_tm, bounds, words[s], cfg)
        bits = b if bits is None else bits | b
    return bits, popcount(bits)


def popcount(bits):
    """The set bits of an int32 bitmap, as an int32 ``[1]`` tensor
    (torch has no popcount)."""
    import torch

    u = bits.reshape(-1, 1).to(torch.int64) & MASK32
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return ((u >> shifts) & 1).sum().to(torch.int32).reshape(1)


def probe_bits_plain(data_tm, bounds, words, cfg: BloomConfig):
    """Plain PyTorch version of the probe kernels (both modes), vectorised
    over ``[T, Cp]`` in int64 masked to 32 bits (torch's ``>>`` on int32
    is arithmetic, and uint32 lacks ``+``/``>>`` on the CPU). Same
    contract as :func:`probe_bits`; the CPU path and the reference the
    kernels are held to on the GPU.

    Reproduces the reference kernels exactly, including their one
    asymmetry: the sampled mask has a ``start_t`` lower bound, the strided
    mask does not (halo rows are probed). The packed layout (int32) is
    unpacked to bytes first; its bitmap is the byte layout's."""
    import torch

    hit, m1, m2 = probe_tested(data_tm, bounds, cfg)
    for b in range(cfg.kbanks):
        hit = hit & bank_hit(words, m1, m2, cfg, b)
    R, Cp = hit.shape
    shifts = torch.arange(32, dtype=torch.int64, device=hit.device)[
        None, :, None]
    packed = (hit.reshape(R // 32, 32, Cp).to(torch.int64) << shifts).sum(1)
    total = hit.sum().to(torch.int32).reshape(1)
    return to_int32(packed), total


def probe_tested(data_tm, bounds, cfg: BloomConfig):
    """The rows the probe tests and their gram hashes, as the plain
    version computes them: ``(tested [T/stride, Cp] bool, m1, m2 [T/stride,
    Cp] int64)`` over the tested-row grid (every row when sampled): the
    lane mask, and the winnowing selection when sampled."""
    import torch

    if data_tm.dtype == torch.int32:
        if not packed_eligible(cfg, torch.uint8):
            raise ValueError(f"packed data_tm needs stride % 4 == 0: {cfg}")
        d = unpack_time_major(data_tm)
    else:
        d = data_tm.to(torch.int64)
    T, Cp = d.shape
    q, s = cfg.q, cfg.stride
    dev = data_tm.device
    if cfg.fold_case:
        d = torch.where((d >= 65) & (d <= 90), d + 32, d)
    start = bounds[0].to(torch.int64)[None, :]
    end = bounds[1].to(torch.int64)[None, :]
    rows = torch.arange(0, T, s, dtype=torch.int64, device=dev)[:, None]
    R = rows.shape[0]
    # rows past T can never be valid (end_t <= T); zero rows keep the
    # gram reads in range
    d = torch.cat([d, torch.zeros((q, Cp), dtype=torch.int64, device=dev)])
    m1 = torch.zeros((R, Cp), dtype=torch.int64, device=dev)
    m2 = torch.zeros_like(m1)
    for i in range(q):
        sym = d[i : i + T : s] if s > 1 else d[i : i + T]
        m1 = (m1 + sym * cfg.mix1[i]) & MASK32
        m2 = (m2 + sym * cfg.mix2[i]) & MASK32
    lane_live = end > start
    in_array = rows + q <= T
    if not cfg.sampled:
        return (rows + q <= end) & lane_live & in_array, m1, m2
    valid = (rows >= start) & (rows + q <= end) & lane_live & in_array
    hs = (m1 ^ (m1 >> 13)) & INT32_MAX
    hm = torch.where(valid, hs, INT32_MAX)
    ctx = cfg.w - 1
    pad = torch.full((ctx, Cp), INT32_MAX, dtype=torch.int64, device=dev)
    hp = torch.cat([pad, hm, pad])
    # a row is tested iff it is the rightmost argmin of some w-window:
    # (run of predecessors >=) + (run of successors >) >= w-1
    rk = [torch.ones((R, Cp), dtype=torch.bool, device=dev)]
    for k in range(1, cfg.w):
        rk.append(rk[-1] & (hp[ctx + k : ctx + k + R] > hm))
    sel = rk[cfg.w - 1]
    lacc = rk[0]
    for j in range(1, cfg.w):
        lacc = lacc & (hp[ctx - j : ctx - j + R] >= hm)
        sel = sel | (lacc & rk[cfg.w - 1 - j])
    return sel & valid, m1, m2


def bank_hit(words, m1, m2, cfg: BloomConfig, b: int):
    """Whether bank ``b`` has the bit of each gram (m1, m2 from
    :func:`probe_tested`), as a bool tensor of their shape."""
    v = cfg.v
    wflat = words.reshape(-1).to(m1.dtype) & MASK32
    h = (m1 + b * m2) & MASK32
    h = h ^ (h >> 13)
    unit = (h >> 17) & (v - 1)
    word = wflat[(b * v + unit) * 128 + ((h >> 10) & 127)]
    return ((word >> ((h >> 5) & 31)) & 1) == 1


def _use_packed(packed, cfg: BloomConfig, data) -> bool:
    if packed is None:
        return PACKED_AUTO and packed_eligible(cfg, data.dtype)
    return bool(packed)


def _probe(data, bounds, words, cfg: BloomConfig, packed):
    data_tm, Cp = prep_time_major(data, cfg, _use_packed(packed, cfg, data))
    bits, total = probe_bits(data_tm, pad_bounds(bounds, Cp), words, cfg)
    return total, bits


def hits(data, bounds, words, cfg: BloomConfig, packed=None):
    """Pad + transpose + probe + popcount of one lane-major batch:
    ``data [C, T]``, ``bounds [2, C]`` -> ``(total [1], bits [W, Cp])``.

    ``packed=None`` follows ``PACKED_AUTO``; True/False force the
    uint32-packed (K3) or byte data path — the same bitmap either way."""
    total, bits = _probe(data, bounds, words, cfg, packed)
    kernel_debug("bloom batch: {} survivor grams", total)  # TPM_DEBUG>=2
    return total, bits


def hits_refined(data, bounds, words, dx, cfg: BloomConfig, k_ref: int,
                 packed=None):
    """Probe + exact-gram refinement: the emitted bitmap keeps only the
    candidates whose gram is literally in the inserted set.

    Survivors compact to ``k_ref`` slots (ops/verify_device.py), each is
    checked against the exact table ``dx`` (ops/exact_gram.py) over the
    unpadded lane-major batch, and the members scatter back into a fresh
    bitmap (distinct candidates own distinct bits, so an int32 add of
    ``1 << b`` is their OR). If the candidates overflow ``k_ref``, the
    unrefined bitmap and total pass through unchanged — the host verifier
    absorbs them, nothing is lost. No step syncs with the host.
    ``packed`` picks the probe's data path, as in :func:`hits`; the
    exact-gram check reads the lane-major batch either way."""
    import torch

    from .exact_gram import exact_member
    from .verify_device import bitmap_to_candidates

    C, T = data.shape
    total0, bits = _probe(data, bounds, words, cfg, packed)
    n_cand, lane, row, over = bitmap_to_candidates(bits, cfg.stride, k_ref)
    dev = bits.device
    slotv = torch.arange(k_ref, device=dev) < n_cand
    lane = lane.to(torch.int64)
    row = row.to(torch.int64)
    base = lane.clamp(max=C - 1) * T + row.clamp(max=T - 1)
    keep = exact_member(dx, data.reshape(-1), base, slotv)
    W, Cb = bits.shape
    bitrow = row // cfg.stride  # row = (word*32 + bit) * stride
    flat = torch.where(
        keep, (bitrow >> 5) * Cb + lane.clamp(max=Cb - 1), W * Cb
    )
    ref = torch.zeros(W * Cb + 1, dtype=torch.int32, device=dev)
    ref.index_add_(0, flat, to_int32(torch.ones_like(bitrow) << (bitrow & 31)))
    ref = ref[: W * Cb].reshape(W, Cb)
    total = torch.where(over, total0[0], keep.sum().to(torch.int32))
    kernel_debug(
        "bloom batch: {} survivors, {} after exact-gram refinement",
        total0, total,
    )  # TPM_DEBUG>=2
    return total.reshape(1), torch.where(over, bits, ref)


@dataclasses.dataclass
class DeviceBloom:
    """The filter on a torch device (``BloomFilterTable.put``)."""

    words: object  # torch [k, v, 128] int32
    cfg: BloomConfig
    max_pat_len: int
    exact: object | None = None  # DeviceExact once refinement is attached
    k_ref: int = 0  # refinement candidate-capacity bucket

    def attach_exact(self, gram_keys, k_ref: int, bits: int = 8) -> None:
        """Turn on exact-gram refinement: candidates whose gram is not in
        ``gram_keys`` (the builder's inserted set) never reach the host.
        ``k_ref`` is the candidate capacity (overflow passes the unrefined
        bitmap through); ``bits`` the gram_keys symbol width."""
        from .exact_gram import DeviceExact, table_from_keys

        xt = table_from_keys(gram_keys, self.cfg.q, bits=bits)
        self.exact = DeviceExact.put(xt, self.cfg.fold_case, self.words.device)
        self.k_ref = int(k_ref)

    def hits(self, data, bounds) -> BloomHits:
        """data: ``[C, T]`` lane-major symbols; bounds: ``[2, C]``
        start_t/end_t — both on this filter's device."""
        if self.exact is not None:
            meta, bits = hits_refined(
                data, bounds, self.words, self.exact, self.cfg, self.k_ref
            )
        else:
            meta, bits = hits(data, bounds, self.words, self.cfg)
        return BloomHits(meta=meta, bits=bits)

    def probe_total(self, data, start_t, end_t):
        """Benchmark hook: total survivors of the unrefined probe."""
        import torch

        total, _ = hits(data, torch.stack([start_t, end_t]), self.words,
                        self.cfg)
        return total[0]


def unpack_hit_rows(bits: np.ndarray, stride: int):
    """Host-side bitmap expansion: [W, C] int32 -> (rows, lanes) arrays of
    candidate gram start rows (already in row units, halo included).

    Native ctz loop when the oracle library is buildable; the NumPy
    fallback is proportional to NONZERO words, not the bitmap."""
    u = bits.view(np.uint32) if bits.dtype == np.int32 else bits
    try:
        from tpu_pattern_matching_torch.core.oracle_native import unpack_bitmap

        return unpack_bitmap(u, stride)
    except Exception:
        pass
    wi, ci = np.nonzero(u)
    if len(wi) == 0:
        z = np.zeros(0, np.int64)
        return z, z
    vals = u[wi, ci]
    planes = (vals[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    k, bit = np.nonzero(planes)
    rows = (wi[k].astype(np.int64) * 32 + bit) * stride
    return rows, ci[k].astype(np.int64)
