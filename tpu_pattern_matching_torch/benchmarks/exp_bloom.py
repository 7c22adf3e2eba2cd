"""Prototype bloom probe: the port of the reference's
``benchmarks/exp_bloom.py`` (its two Pallas bodies, ``kernel`` and
``big_kernel``).

    python -m tpu_pattern_matching_torch.benchmarks.exp_bloom   # on the GPU
    python -m tpu_pattern_matching_torch.benchmarks.exp_bloom --device cpu

The probe: strided row g of a tile (stride S = 7) folds bytes g*S + k,
k < Q = 6, into two 32-bit hashes m1 and m2 with the odd multipliers MIX1
and MIX2; each of the KBANKS = 6 banks tests ``h = m1 + b*m2``, ``h ^= h
>> 13``, then bit ``(h >> 5) & 31`` of word ``(h >> 10) & 127`` of unit
``(h >> 17) & 3`` of its ``[V = 4, 128]`` int32 words (logical shifts: the
hash is unsigned 32-bit). The output is 1 where every bank hits.

- ``run_probe`` (``kernel``, the one-tile prototype): data ``[G*S + Q, C]``
  = ``[286, 512]`` uint8 -> ``[40, 512]`` int8;
- ``run_grid`` (``big_kernel``): disjoint tiles of ``TT + PADR`` rows, 128
  of them in the experiment, data ``[58368, 1024]`` uint8 -> ``[128, 64,
  1024]`` int8; the PADR = 8 pad rows of each tile are never read (Q < S).

Both launch ``proto_probe_kernel`` (``csrc/proto_probe.cu``) for a CUDA
tensor and run ``probe_plain`` for a CPU tensor. ``main`` is the
experiment: the one-tile probe against the NumPy model ``np_probe``, then
the grid's throughput (on the card: device time per launch from a
torch.profiler trace), beside the launch's bound. The reference's timing
loop (a scan whose carry is XOR-ed into the table, so that XLA cannot
hoist the kernel out of it) is not ported: PyTorch launches eagerly.

``make_tables(seed)`` draws the tables from a fresh
``np.random.RandomState(seed)`` in the reference's order: seed 0 gives the
reference module's BLOOM, MIX1 and MIX2, and the generator's next draws
are its ``main``'s one-tile data, then the grid's.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np
import torch

from tpu_pattern_matching_torch.ops.bloom import MASK32, BloomConfig, bank_hit
from tpu_pattern_matching_torch.utils.device import resolve_device
from tpu_pattern_matching_torch.utils.measure import (BANK_OPS, bound_of,
                                                      card, event_ms,
                                                      trace_ms)

G, C = 40, 512  # the one-tile prototype: strided rows x lanes
KBANKS = 6
V = 4  # 128-word units per bank
Q = 6  # gram length
S = 7  # stride
GT, CT = 64, 1024  # a grid tile: strided rows x lanes
TILES = 128
TT = GT * S  # rows of a grid tile
PADR = 8  # pad rows after each grid tile (never read: Q < S)
TILE = dict(rows=G, stride=S, q=Q, pitch=G * S + Q)  # one tile
GRID = dict(rows=GT, stride=S, q=Q, pitch=TT + PADR)  # per grid tile
KERNEL = "proto_probe_kernel"
MAX_TABLE_WORDS = 48 * 1024 // 4  # the kernel keeps the table in 48 KB


def make_tables(seed: int = 0):
    """``(bloom [KBANKS, V, 128] int32, mix1 [Q] int32, mix2 [Q] int32,
    rng)``, drawn from a fresh generator in the reference's order."""
    rng = np.random.RandomState(seed)
    bloom = rng.randint(0, 2**31, size=(KBANKS, V, 128)).astype(np.int32)
    mix1 = rng.randint(1, 2**31, size=Q).astype(np.int32) | 1
    mix2 = rng.randint(1, 2**31, size=Q).astype(np.int32) | 1
    return bloom, mix1, mix2, rng


def np_probe(window_bytes, bloom, mix1, mix2):
    """The reference's NumPy model: gram bytes ``[R, C, q]`` -> hit
    ``[R, C]`` bool, with the tables passed in."""
    w = window_bytes.astype(np.int64)
    m1 = np.zeros(w.shape[:2], np.int64)
    m2 = np.zeros(w.shape[:2], np.int64)
    for k in range(w.shape[-1]):
        m1 = (m1 + w[..., k] * mix1[k]) & 0xFFFFFFFF
        m2 = (m2 + w[..., k] * mix2[k]) & 0xFFFFFFFF
    hit = np.ones(w.shape[:2], bool)
    for b in range(bloom.shape[0]):
        h = (m1 + b * m2) & 0xFFFFFFFF
        h ^= h >> 13
        v = (h >> 17) & (bloom.shape[1] - 1)
        w7 = (h >> 10) & 127
        bit = (h >> 5) & 31
        words = bloom[b, v, w7]
        hit &= ((words >> bit) & 1).astype(bool)
    return hit


def np_windows(tile, rows: int = G, stride: int = S, q: int = Q):
    """The gram bytes ``[rows, C, q]`` of one tile's rows (numpy), as the
    reference's ``main`` gathers them for ``np_probe``."""
    last = (rows - 1) * stride + 1
    return np.stack([tile[k : k + last : stride] for k in range(q)], axis=-1)


def check(data, bloom, mix1, mix2, *, rows, stride, q, pitch, tiles
          ) -> BloomConfig:
    """Validates the probe's contract, the kernel's and the plain
    version's: ``data [tiles * pitch, C]`` uint8 with C a multiple of 4,
    grams inside their tile (``(rows - 1) * stride + q <= pitch``), ``bloom
    [k, v, 128]`` int32 on the same device, v a power of two, at most 48 KB
    of words, q <= 8 multipliers in ``mix1`` and ``mix2``. Returns the
    probe's hash parameters as a strided ``BloomConfig``."""
    if data.dtype != torch.uint8 or data.dim() != 2 or data.shape[1] % 4 \
            or not data.shape[1]:
        raise ValueError(f"data must be 2-D uint8 with lanes a multiple of 4"
                         f", got {data.dtype} {tuple(data.shape)}")
    if min(rows, stride, q, tiles) < 1 or q > 8 \
            or pitch < (rows - 1) * stride + q:
        raise ValueError(f"unsupported geometry rows={rows} stride={stride} "
                         f"q={q} pitch={pitch} tiles={tiles}")
    if data.shape[0] != tiles * pitch:
        raise ValueError(f"data has {data.shape[0]} rows, not {tiles} tiles "
                         f"x pitch {pitch}")
    k, v = bloom.shape[:2] if bloom.dim() == 3 else (0, 0)
    if bloom.dtype != torch.int32 or bloom.dim() != 3 \
            or bloom.shape[2] != 128 or v & (v - 1) \
            or bloom.numel() > MAX_TABLE_WORDS:
        raise ValueError(f"bloom must be int32 [k, v, 128], v a power of two"
                         f", at most {MAX_TABLE_WORDS} words, got "
                         f"{bloom.dtype} {tuple(bloom.shape)}")
    if bloom.device != data.device:
        raise ValueError(f"bloom is on {bloom.device}, data on {data.device}")
    if len(mix1) != q or len(mix2) != q:
        raise ValueError(f"mix1 and mix2 need {q} multipliers each")
    return BloomConfig(q=q, stride=stride, kbanks=k, v=v,
                       mix1=tuple(int(x) & MASK32 for x in mix1),
                       mix2=tuple(int(x) & MASK32 for x in mix2))


def _hashes(data, cfg: BloomConfig, rows: int, pitch: int, tiles: int):
    """m1, m2 ``[tiles, rows, C]`` int64 (uint32 values) of every strided
    row's gram."""
    d = data.reshape(tiles, pitch, data.shape[1])
    last = (rows - 1) * cfg.stride + 1
    m1 = torch.zeros((tiles, rows, data.shape[1]), dtype=torch.int64,
                     device=data.device)
    m2 = torch.zeros_like(m1)
    for k in range(cfg.q):
        sym = d[:, k : k + last : cfg.stride].to(torch.int64)
        m1 = (m1 + sym * cfg.mix1[k]) & MASK32
        m2 = (m2 + sym * cfg.mix2[k]) & MASK32
    return m1, m2


def probe_plain(data, bloom, mix1, mix2, *, rows, stride, q, pitch, tiles):
    """Plain PyTorch version of the prototype probe (``check`` has the
    contract): tile t's strided row g folds data rows ``t * pitch + g *
    stride + k``, k < q; returns the hit map ``[tiles, rows, C]`` int8, in
    int64 arithmetic under a 32-bit mask (torch's ``>>`` on int32 is
    arithmetic). The CPU path, and what the kernel is held to on the
    card."""
    cfg = check(data, bloom, mix1, mix2, rows=rows, stride=stride, q=q,
                pitch=pitch, tiles=tiles)
    m1, m2 = _hashes(data, cfg, rows, pitch, tiles)
    hit = torch.ones_like(m1, dtype=torch.bool)
    for b in range(cfg.kbanks):
        hit &= bank_hit(bloom, m1, m2, cfg, b)
    return hit.to(torch.int8)


def probe_work(data, bloom, mix1, mix2, **geom) -> dict:
    """The least work of a probe launch on these inputs: bytes = the rows
    the grams read (``tiles * rows * q * C``), the int8 output and the
    table, once each; int32 operations = 2q per strided row and lane (the
    two hashes) and BANK_OPS per bank probed up to the first miss, counted
    on these inputs."""
    cfg = check(data, bloom, mix1, mix2, **geom)
    m1, m2 = _hashes(data, cfg, geom["rows"], geom["pitch"], geom["tiles"])
    alive = torch.ones_like(m1, dtype=torch.bool)
    probes = 0
    for b in range(cfg.kbanks):
        probes += int(alive.sum())
        alive &= bank_hit(bloom, m1, m2, cfg, b)
    n = m1.numel()
    return dict(bytes=n * cfg.q + n + bloom.numel() * 4,
                ops=n * 2 * cfg.q + probes * BANK_OPS, bank_probes=probes,
                hits=int(alive.sum()))


def _run(data, bloom, mix1, mix2, kind: str, geom: dict):
    check(data, bloom, mix1, mix2, **geom)
    if data.is_cuda:
        from tpu_pattern_matching_torch.ops import kernels

        return kernels.launch_proto_probe(data, bloom, mix1, mix2, kind=kind,
                                          **geom)
    if data.device.type != "cpu":
        raise ValueError(f"no proto probe for device {data.device}")
    return probe_plain(data, bloom, mix1, mix2, **geom)


def run_probe(data, bloom, mix1, mix2):
    """The one-tile prototype (the reference's ``run_probe``, its tables
    passed in): ``data [G*S + Q, C]`` uint8 -> hit ``[G, C]`` int8. The
    kernel for a CUDA tensor (or it raises), ``probe_plain`` for a CPU
    tensor."""
    return _run(data, bloom, mix1, mix2, "tile", dict(TILE, tiles=1))[0]


def run_grid(data, bloom, mix1, mix2):
    """The grid prototype (the reference's ``big``): ``data [tiles * (TT +
    PADR), C]`` uint8 -> hit ``[tiles, GT, C]`` int8, tile i from rows
    ``i * (TT + PADR)``. The kernel for a CUDA tensor (or it raises),
    ``probe_plain`` for a CPU tensor."""
    tiles = data.shape[0] // GRID["pitch"] if data.dim() == 2 else 0
    return _run(data, bloom, mix1, mix2, "grid", dict(GRID, tiles=tiles))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_pattern_matching_torch.benchmarks.exp_bloom",
        description="The prototype bloom probe: the one-tile probe against "
                    "its NumPy model, then the grid's throughput.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the kernel; raises without a GPU) or cpu "
                         "(the plain PyTorch version)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    repeats = 100 if dev.type == "cuda" else 3  # grid runs timed
    bloom_np, mix1, mix2, rng = make_tables(0)
    bloom = torch.from_numpy(bloom_np).to(dev)
    data = rng.randint(0, 256, size=(G * S + Q, C)).astype(np.uint8)
    want = np_probe(np_windows(data), bloom_np, mix1, mix2)
    out = run_probe(torch.from_numpy(data).to(dev), bloom, mix1, mix2)
    out = out.cpu().numpy()
    ok = np.array_equal(out, want.astype(np.int8))
    where = (f"{KERNEL} on {torch.cuda.get_device_name(dev)}"
             if dev.type == "cuda" else "plain PyTorch version on the cpu")
    print(f"proto probe ({where}): ok = {ok}  hits: {int(out.sum())} / "
          f"{int(want.sum())}", flush=True)
    if not ok:
        return 1
    big = rng.randint(0, 256, size=(TILES * (TT + PADR), CT)).astype(
        np.uint8)
    grid = torch.from_numpy(big).to(dev)
    run = functools.partial(run_grid, grid, bloom, mix1, mix2)
    work = probe_work(grid, bloom, mix1, mix2, **GRID, tiles=TILES)
    b = bound_of(work["bytes"], work["ops"])
    payload = TILES * TT * CT
    shape = f"[{TILES}, {GT}, {CT}]"
    what = (f"{work['bytes']} B, {work['ops']} int32 ops, "
            f"{work['bank_probes']} bank probes")
    if dev.type == "cuda":
        card_line = card()
        event = event_ms(run, repeats)
        ms = trace_ms(run, KERNEL, repeats)[0]
        print(card_line)
        print(f"bloom probe k={KBANKS} V={V} stride={S}: {ms:.4f} ms per "
              f"{payload >> 20} MiB -> {payload / ms / 1e6:.1f} GB/s",
              flush=True)
        print(f"grid {shape}: {ms:.6f} ms device time per launch "
              f"(torch.profiler, {repeats} launches), {event:.6f} ms "
              f"per call by CUDA events; bound {b['bound_ms']:.6f} ms by "
              f"{b['bound_by']} ({what}), share {b['bound_ms'] / ms:.4f} "
              f"({card_line})", flush=True)
        return 0
    t0 = time.perf_counter()
    for _ in range(repeats):
        run()
    ms = (time.perf_counter() - t0) * 1e3 / repeats
    print(f"bloom probe k={KBANKS} V={V} stride={S}: {ms:.4f} ms per "
          f"{payload >> 20} MiB -> {payload / ms / 1e6:.1f} GB/s (the plain "
          f"PyTorch version on the cpu, host clock: not a device time)")
    print(f"grid {shape}: bound on an H100 {b['bound_ms']:.6f} ms by "
          f"{b['bound_by']} ({what})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
