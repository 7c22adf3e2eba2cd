"""The least time the card could take for one launch of the bloom probe
kernel on its inputs: a frozen copy of ``chip_smoke.probe_bound`` and of
the plain hash arithmetic it counts with (``ops/bloom.probe_tested`` and
``bank_hit`` of the port), so that a change to the program cannot change
the yardstick.

Bytes: the symbol rows the grams read, the lane bounds and the filter's
words once, the survivor bitmap and its total written once. Operations
(int32): when sampled, every row's selection hash; per tested row its
gram hash (q multiply-adds for the second mix when sampled, 2q when
strided) and ``BANK_OPS`` per bank probed until the first miss, counted on
these inputs. The bound is the larger of bytes at ``HBM_BYTES_PER_S`` and
operations at ``INT32_OPS_PER_S``.

Peaks (NVIDIA H100 SXM, 700 W): 3.35 TB/s of device memory (data sheet);
int32 operations 132 SMs x 64 INT32 lanes x 1.98 GHz (derived from the
data sheet's SM count and boost clock)."""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
BANK_OPS = 9  # h = m1 + b*m2; h ^= h >> 13 (2); unit, word, bit (3);
#               the word's address (2); the test
SEL_OPS = 6  # a row's selection hash past its q multiply-adds (3) and
#              its window minimum (3)
MASK32 = 0xFFFFFFFF
INT32_MAX = 0x7FFFFFFF


def bound_of(nbytes: int, ops: int) -> dict:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT32_OPS_PER_S * 1e3
    return dict(bound_ms=max(tb, to), bound_by="bytes" if tb >= to
                else "operations", bytes=int(nbytes), ops=int(ops))


def time_major(data, bounds, cfg):
    """The probe's inputs as the program lays them out: ``data [C, T]`` to
    ``[Tp, Cp]`` (time padded to ``cfg.tile_rows``, lanes to 128, zeros),
    ``bounds [2, C]`` to ``[2, Cp]`` (empty padding lanes)."""
    C, T = data.shape
    Tp = -(-T // cfg.tile_rows) * cfg.tile_rows
    Cp = -(-C // 128) * 128
    d = torch.zeros((Tp, Cp), dtype=data.dtype, device=data.device)
    d[:T, :C] = data.t()
    b = torch.zeros((2, Cp), dtype=torch.int32, device=data.device)
    b[:, :C] = bounds
    return d, b


def tested(data_tm, bounds, cfg):
    """``(tested [T/stride, Cp] bool, m1, m2)``: the rows the probe tests
    and their gram hashes (the winnowing selection when sampled)."""
    d = data_tm.to(torch.int64)
    T, Cp = d.shape
    q, s = cfg.q, cfg.stride
    dev = d.device
    if cfg.fold_case:
        d = torch.where((d >= 65) & (d <= 90), d + 32, d)
    start = bounds[0].to(torch.int64)[None, :]
    end = bounds[1].to(torch.int64)[None, :]
    rows = torch.arange(0, T, s, dtype=torch.int64, device=dev)[:, None]
    R = rows.shape[0]
    d = torch.cat([d, torch.zeros((q, Cp), dtype=torch.int64, device=dev)])
    m1 = torch.zeros((R, Cp), dtype=torch.int64, device=dev)
    m2 = torch.zeros_like(m1)
    for i in range(q):
        sym = d[i:i + T:s] if s > 1 else d[i:i + T]
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
    rk = [torch.ones((R, Cp), dtype=torch.bool, device=dev)]
    for k in range(1, cfg.w):
        rk.append(rk[-1] & (hp[ctx + k:ctx + k + R] > hm))
    sel = rk[cfg.w - 1]
    lacc = rk[0]
    for j in range(1, cfg.w):
        lacc = lacc & (hp[ctx - j:ctx - j + R] >= hm)
        sel = sel | (lacc & rk[cfg.w - 1 - j])
    return sel & valid, m1, m2


def bank_hit(words, m1, m2, cfg, b: int):
    v = cfg.v
    wflat = words.reshape(-1).to(torch.int64) & MASK32
    h = (m1 + b * m2) & MASK32
    h = h ^ (h >> 13)
    unit = (h >> 17) & (v - 1)
    word = wflat[(b * v + unit) * 128 + ((h >> 10) & 127)]
    return ((word >> ((h >> 5) & 31)) & 1) == 1


def probe_bound(data_tm, bounds, words, cfg) -> dict:
    """The bound of one launch on its time-major inputs (``time_major``):
    ``bound_ms``, ``bound_by``, ``bytes``, ``ops``, ``tested``,
    ``bank_probes``."""
    t, m1, m2 = tested(data_tm, bounds, cfg)
    alive, probes = t, 0
    for b in range(cfg.kbanks):
        probes += int(alive.sum())
        alive = alive & bank_hit(words, m1, m2, cfg, b)
    del m1, m2
    T, Cp = data_tm.shape
    sym = 2 if data_tm.dtype == torch.uint16 else 1
    rows = T if cfg.sampled else T // cfg.stride * min(cfg.q, cfg.stride)
    nbytes = (rows * Cp * sym + bounds.numel() * 4 + words.numel() * 4
              + T // (32 * cfg.stride) * Cp * 4 + 4)
    n_tested = int(t.sum())
    if cfg.sampled:
        ops = T * Cp * (cfg.q + SEL_OPS) + n_tested * cfg.q
    else:
        ops = n_tested * 2 * cfg.q
    return dict(bound_of(nbytes, ops + probes * BANK_OPS), tested=n_tested,
                bank_probes=probes)
