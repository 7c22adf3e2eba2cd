"""Exact q-gram membership: the bloom engine's false-positive eraser.

Port of the reference's ``ops/exact_gram.py``. The host half (packing,
the linear-probe table build, ``member_mask_np``) is a faithful copy:
the reference module cannot be imported without JAX (its package's
``ops/__init__`` imports the XLA engines), and the machine with the GPU
has none. The device half holds the planes on a ``torch.device`` and
checks compacted candidates with torch ops (``exact_member``).

The builder's exact inserted gram set lives in a linear-probe hash table;
a candidate whose gram is not literally in that set can never own a match
(every true occurrence contains an inserted gram at a probed position),
so erasing non-members is exact whenever q*bits <= 64 (the packed key IS
the gram).
"""

from __future__ import annotations

import dataclasses

import numpy as np

_MASK32 = np.uint64(0xFFFFFFFF)
_MIX = np.uint32(0x2C1B3C6D)  # odd avalanche constant (host == device)


def _mix32_np(lo: np.ndarray, hi: np.ndarray, c1: np.uint32, c2: np.uint32):
    """Host model of the device slot hash (uint32 wrap arithmetic)."""
    h = (lo * c1 + hi * c2) & np.uint32(0xFFFFFFFF)
    h = h ^ (h >> np.uint32(15))
    h = (h * _MIX) & np.uint32(0xFFFFFFFF)
    return h ^ (h >> np.uint32(13))


def pack_grams(grams, q: int, bits: int = 8) -> np.ndarray:
    """Gram tuples -> sorted unique uint64 keys, symbol i at bit ``bits*i``.

    ``bits`` is the symbol width: 8 for the byte alphabet, 11 for the
    ushort (alphabet-2048) variant. q*bits <= 64 symbols fit one uint64
    key, so key equality IS gram equality — the exactness of the whole
    scheme rests on this line."""
    if q * bits > 64:
        raise ValueError(
            f"exact gram table needs q*bits <= 64, got q={q} bits={bits}"
        )
    if not grams:
        return np.zeros(0, np.uint64)
    arr = np.asarray(sorted(grams), np.uint64).reshape(-1, q)
    if arr.max() >> np.uint64(bits):
        raise ValueError(f"gram symbol out of range for {bits}-bit packing")
    key = np.zeros(len(arr), np.uint64)
    for i in range(q):
        key |= arr[:, i] << np.uint64(bits * i)
    return np.unique(key)


@dataclasses.dataclass
class ExactGramTable:
    """Linear-probe table over the inserted gram keys.

    ``lo``/``hi`` are [M + dmax] uint32 planes (hi is all-zero and unused
    by the device check when q <= 4). Empty slots hold the FIRST key's
    value — safe: a non-member probe key never equals any member value,
    and a member never probes an empty slot (it found its own within
    dmax by construction)."""

    lo: np.ndarray  # [M + dmax] uint32
    hi: np.ndarray  # [M + dmax] uint32
    q: int
    dmax: int
    m: int  # power-of-two slot count (mask = m - 1)
    c1: int  # per-build hash constants (reseeded until placement fits)
    c2: int
    n: int  # member count
    bits: int = 8  # symbol width (8 = byte alphabet, 11 = ushort/2048)

    @property
    def use_hi(self) -> bool:
        return self.q * self.bits > 32


_DMAX = 4


def _try_place(
    keys: np.ndarray, m: int, c1: np.uint32, c2: np.uint32,
    dmax: int = _DMAX,
) -> np.ndarray | None:
    """Greedy vectorized linear-probe placement: per distance d, every
    unplaced key bids for slot h+d; one winner per slot (np.unique
    first-occurrence), losers re-bid at d+1. Returns the slot array or
    None when some key cannot place within ``dmax``."""
    n = len(keys)
    lo_all = (keys & _MASK32).astype(np.uint32)
    hi_all = (keys >> np.uint64(32)).astype(np.uint32)
    h = (_mix32_np(lo_all, hi_all, c1, c2) & np.uint32(m - 1)).astype(
        np.int64
    )
    slot = np.full(n, -1, np.int64)
    taken = np.zeros(m + dmax, bool)
    pending = np.arange(n)
    for d in range(dmax):
        bid = h[pending] + d
        free = ~taken[bid]
        cand = pending[free]
        bid = bid[free]
        uniq, first = np.unique(bid, return_index=True)
        slot[cand[first]] = uniq
        taken[uniq] = True
        pending = pending[~np.isin(pending, cand[first])]
        if not len(pending):
            return slot
    return None


def _fill_table(
    keys: np.ndarray, slot: np.ndarray, q, dmax, m, c1, c2, bits
) -> ExactGramTable:
    lo_all = (keys & _MASK32).astype(np.uint32)
    hi_all = (keys >> np.uint64(32)).astype(np.uint32)
    # empty slots hold the FIRST key's value (safe, see class docstring)
    lo = np.full(m + dmax, lo_all[0], np.uint32)
    hi = np.full(m + dmax, hi_all[0], np.uint32)
    lo[slot] = lo_all
    hi[slot] = hi_all
    return ExactGramTable(
        lo=lo, hi=hi, q=q, dmax=dmax, m=m,
        c1=int(c1), c2=int(c2), n=len(keys), bits=bits,
    )


def table_from_keys(
    keys: np.ndarray, q: int, seed: int = 0, bits: int = 8
) -> ExactGramTable:
    """Place every key within ``dmax`` linear-probe slots of its hash.

    ``keys``: packed uint64 gram keys (pack_grams layout, e.g. the
    persisted BloomFilterTable.gram_keys). If any key is left unplaced
    after dmax greedy rounds, reseed the hash; after a few seeds, double
    the table. Load factor starts at <= 0.5 so placement virtually always
    succeeds on the first try."""
    return tables_from_keys_common([keys], q, seed, bits)[0]


def tables_from_keys_common(
    keys_list, q: int, seed: int = 0, bits: int = 8
) -> list[ExactGramTable]:
    """Build one table per key set, all sharing (m, dmax, c1, c2).

    The pattern-sharded mesh step walks each shard's table under
    shard_map, where the lookup parameters are STATIC (one compiled
    kernel) and only the [S, m+dmax] planes shard over the "pat" axis —
    so every shard's placement must succeed with the same constants."""
    keys_list = [np.unique(np.asarray(k, np.uint64)) for k in keys_list]
    m0 = 128
    for k in keys_list:
        while m0 < 2 * len(k):
            m0 *= 2
    rng = np.random.RandomState(seed ^ 0xE9AC7)
    # prefer dmax=2 at load <= 0.25 (the per-candidate device check costs
    # dmax gathers — the refinement's hot marginal); fall back to the
    # denser dmax=4 layout, then grow the table
    attempts = [(2, m0 * 2), (4, m0), (2, m0 * 4), (4, m0 * 2)]
    while True:
        for dmax, m in attempts:
            for _try in range(8):
                c1 = np.uint32(int(rng.randint(1, 2**31)) | 1)
                c2 = np.uint32(int(rng.randint(1, 2**31)) | 1)
                slots = []
                for k in keys_list:
                    if len(k) == 0:
                        slots.append(np.zeros(0, np.int64))
                        continue
                    s = _try_place(k, m, c1, c2, dmax)
                    if s is None:
                        break
                    slots.append(s)
                if len(slots) == len(keys_list):
                    out = []
                    for k, s in zip(keys_list, slots):
                        if len(k) == 0:
                            out.append(ExactGramTable(
                                lo=np.zeros(m + dmax, np.uint32),
                                hi=np.zeros(m + dmax, np.uint32),
                                q=q, dmax=dmax, m=m,
                                c1=int(c1), c2=int(c2), n=0, bits=bits,
                            ))
                        else:
                            out.append(
                                _fill_table(k, s, q, dmax, m, c1, c2, bits)
                            )
                    return out
        attempts = [(d, m * 2) for d, m in attempts]


def member_mask_np(table: ExactGramTable, keys: np.ndarray) -> np.ndarray:
    """Host-side membership (tests + host-path mirrors)."""
    lo = (keys & _MASK32).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    h = (
        _mix32_np(lo, hi, np.uint32(table.c1), np.uint32(table.c2))
        & np.uint32(table.m - 1)
    ).astype(np.int64)
    ok = np.zeros(len(keys), bool)
    for d in range(table.dmax):
        hit = table.lo[h + d] == lo
        if table.use_hi:
            hit &= table.hi[h + d] == hi
        ok |= hit
    if table.n == 0:
        ok[:] = False
    return ok



# --------------------------------------------------------------------------
# device side (torch)
# --------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def mul32(a, c: int):
    """``(a * c) mod 2**32`` for an int64 tensor ``a`` of uint32 values and
    a uint32 constant ``c``, without an int64 product past 2**63 (split
    ``c`` into 16-bit halves)."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


@dataclasses.dataclass
class DeviceExact:
    """Planes on a torch device + static lookup parameters.

    The planes hold the uint32 slot values in int64 tensors, so the
    membership compare needs no sign handling."""

    lo: object  # torch [M + dmax] int64
    hi: object | None  # torch [M + dmax] int64, None when q*bits <= 32
    q: int
    dmax: int
    m: int
    c1: int
    c2: int
    n: int
    fold_case: bool
    bits: int = 8  # symbol width (pack_grams layout)

    @staticmethod
    def put(table: ExactGramTable, fold_case: bool, device) -> "DeviceExact":
        import torch

        def plane(a):
            return torch.from_numpy(a.astype(np.int64)).to(device)

        return DeviceExact(
            lo=plane(table.lo),
            hi=plane(table.hi) if table.use_hi else None,
            q=table.q,
            dmax=table.dmax,
            m=table.m,
            c1=table.c1,
            c2=table.c2,
            n=table.n,
            fold_case=fold_case,
            bits=table.bits,
        )


def exact_member(dx: DeviceExact, data_flat, base, valid):
    """Is ``data_flat[base : base + q]`` an inserted gram? (torch port of
    the reference's traced ``exact_member``.)

    ``data_flat``: [N] symbols (uint8 or int); ``base``: [K] integer flat
    gram starts (clipped into range, like the reference's ``mode="clip"``
    gathers); ``valid``: [K] bool — sentinel slots come back False. All
    ops are fixed-shape gathers and elementwise math: no host sync."""
    import torch

    K = base.shape[0]
    if dx.n == 0:
        return torch.zeros(K, dtype=torch.bool, device=base.device)
    size = data_flat.shape[0]
    base = base.to(torch.int64)
    lo = torch.zeros(K, dtype=torch.int64, device=base.device)
    hi = torch.zeros_like(lo)
    for i in range(dx.q):
        s = data_flat[(base + i).clamp(0, size - 1)].to(torch.int64)
        if dx.fold_case:
            s = torch.where((s >= 65) & (s <= 90), s + 32, s)
        # symbol i at key bit bits*i of the pack_grams uint64, split into
        # (lo, hi) 32-bit planes; a symbol straddling bit 32 puts its low
        # part in lo and its high part in hi
        bp = dx.bits * i
        if bp >= 32:
            hi = hi | (s << (bp - 32))
        else:
            lo = lo | (s << bp)
            if bp + dx.bits > 32:
                hi = hi | (s >> (32 - bp))
    lo = lo & M32
    h = (mul32(lo, dx.c1) + mul32(hi, dx.c2)) & M32
    h = h ^ (h >> 15)
    h = mul32(h, int(_MIX))
    h = h ^ (h >> 13)
    h = h & (dx.m - 1)
    last = dx.lo.shape[0] - 1
    ok = torch.zeros(K, dtype=torch.bool, device=base.device)
    for d in range(dx.dmax):
        slot = (h + d).clamp(max=last)
        hit = dx.lo[slot] == lo
        if dx.hi is not None:
            hit = hit & (dx.hi[slot] == hi)
        ok = ok | hit
    return ok & valid
