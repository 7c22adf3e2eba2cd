"""Device half of the PyTorch port against the JAX reference, on the CPU.

- The plain PyTorch probe (the CPU path, and what the CUDA kernels are held
  to on the card) equals the reference Pallas kernels run in interpret
  mode, bit for bit: bitmap and total, both kernel modes.
- The CUDA kernels' own tile code (csrc/bloom_probe.cuh), compiled for
  the CPU and run tile by tile, equals the plain version, on tile edges
  too (and there, through it, the reference).
- Compaction, the exact-gram check and the refined probe equal the
  reference's functions.

Every output is an integer, so the tolerance is zero."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pattern_matching.ops import bloom as ref_bloom
from tpu_pattern_matching.ops import exact_gram as ref_exact
from tpu_pattern_matching.ops import verify_device as ref_vd
from tpu_pattern_matching_torch.ops import bloom as port_bloom
from tpu_pattern_matching_torch.ops import exact_gram as port_exact
from tpu_pattern_matching_torch.ops import kernels
from tpu_pattern_matching_torch.ops import verify_device as port_vd


def make_cfg(mode, q, sw, k, v, fold=False, seed=0):
    rng = np.random.RandomState(seed)
    sampled = mode == "sampled"
    return port_bloom.BloomConfig(
        q=q, stride=1 if sampled else sw, kbanks=k, v=v,
        mix1=tuple(int(x) | 1 for x in rng.randint(1, 2**31, size=q)),
        mix2=tuple(int(x) | 1 for x in rng.randint(1, 2**31, size=q)),
        fold_case=fold, gt=128 if sampled else port_bloom.GT,
        sampled=sampled, w=sw if sampled else 0,
    )


def as_ref_cfg(cfg):
    return ref_bloom.BloomConfig(**dataclasses.asdict(cfg))


def ragged_batch(seed, C, T, text=False):
    """Random lanes with ragged spans: halo rows below start_t > 0, empty
    lanes, short lanes, end_t < T, stale bytes outside every span."""
    rng = np.random.RandomState(seed)
    lo, hi = (32, 128) if text else (0, 256)  # text: upper and lower case
    data = rng.randint(lo, hi, size=(C, T)).astype(np.uint8)
    start = rng.randint(0, 9, size=C).astype(np.int32)
    end = rng.randint(T - 20, T + 1, size=C).astype(np.int32)
    end[3] = start[3]  # empty lane
    end[5] = 0
    start[5] = 0  # padding-style empty lane
    end[7] = min(T, int(start[7]) + 5)  # short lane
    return data, np.stack([start, end])


def random_words(cfg, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(
        -(2**31), 2**31, size=(cfg.kbanks, cfg.v, 128)
    ).astype(np.int32)


PROBES = {  # name: (mode, q, stride|w, k, v, fold, lanes, rows)
    "sampled-bench-pick": ("sampled", 4, 9, 6, 8, False, 130, 150),
    "sampled-k10-fold": ("sampled", 3, 5, 10, 2, True, 70, 140),
    "sampled-w1": ("sampled", 2, 1, 2, 1, False, 40, 100),
    "strided": ("strided", 4, 4, 6, 16, False, 130, 200),
    "strided-k9-fold": ("strided", 2, 3, 9, 2, True, 100, 300),
}


@pytest.mark.parametrize("name", list(PROBES))
def test_plain_probe_equals_reference_kernel(name):
    mode, q, sw, k, v, fold, C, T = PROBES[name]
    cfg = make_cfg(mode, q, sw, k, v, fold, seed=len(name))
    words = random_words(cfg, 1)
    data, bounds = ragged_batch(2, C, T, text=fold)
    r_total, r_bits = ref_bloom._hits_jit(
        data, bounds, words, cfg=as_ref_cfg(cfg), interpret=True
    )
    p_total, p_bits = port_bloom.hits(
        torch.from_numpy(data), torch.from_numpy(bounds),
        torch.from_numpy(words), cfg,
    )
    assert p_bits.dtype == torch.int32 and p_total.dtype == torch.int32
    np.testing.assert_array_equal(p_bits.numpy(), np.asarray(r_bits))
    assert int(p_total[0]) == int(r_total[0]) > 0


KERNEL_BODIES = [  # (mode, q, stride|w, k, v, fold[, tile edge])
    ("sampled", 4, 9, 6, 8, False),
    ("sampled", 4, 9, 6, 8, True),
    ("sampled", 4, 20, 6, 8, False),  # wider context than 16 rows
    ("sampled", 5, 16, 12, 256, False),  # words too big for shared memory
    ("sampled", 1, 1, 3, 4, False),
    ("strided", 4, 4, 6, 16, False),
    ("strided", 3, 7, 10, 2, True),  # non-power-of-two stride
    ("strided", 1, 1, 2, 1, False),
    # the tile edges of the kernels' tiling (TILE_EDGES)
    ("sampled", 4, 9, 6, 8, False, "narrow-tiles"),
    ("sampled", 4, 9, 6, 8, False, "span-ends-mid-tile"),
    ("strided", 4, 4, 6, 16, False, "span-ends-mid-tile"),
    ("sampled", 3, 5, 4, 2, False, "one-tile"),
    ("strided", 4, 4, 6, 16, False, "one-tile"),
    ("sampled", 4, 9, 6, 8, True, "cp128"),  # fold
    ("strided", 3, 7, 10, 2, True, "cp128"),  # fold
    ("sampled", 2, 1, 3, 4, False, "narrow-tiles"),  # w = 1
    ("sampled", 4, 20, 6, 8, False, "narrow-tiles"),  # w = 20
    ("sampled", 1, 4, 3, 4, False, "narrow-tiles"),  # q = 1
    ("strided", 1, 2, 3, 4, False, "narrow-tiles"),  # q = 1
    ("sampled", 8, 9, 6, 8, False, "narrow-tiles"),  # q = 8
    ("strided", 8, 8, 4, 2, False, "narrow-tiles"),  # q = 8
    ("strided", 3, 4, 2, 256, False, "cp128"),  # words outside shared memory
    ("sampled", 4, 9, 2, 256, False, "span-ends-mid-tile"),  # same
]

TILE_EDGES = {  # edge: (lanes, rows, gt, shared-memory budget, spans)
    # a 24,000-byte budget leaves 32- or 64-lane tiles of 32 or 64 rows: every
    # window and its context straddle tiles, across lanes and rows
    "narrow-tiles": (150, 300, None, 24_000, "ragged"),
    # spans that start and end inside tiles, lanes in two lane tiles
    "span-ends-mid-tile": (150, 256, None, 0, "mid"),
    # T (and Cp = 128) of exactly one tile: gt = 64 sampled (two words),
    # gt = 32 strided (one word)
    "one-tile": (100, 60, "one", 0, "ragged"),
    "cp128": (128, 300, None, 0, "ragged"),
}


def edge_batch(seed, C, T, spans, text):
    data, bounds = ragged_batch(seed, C, T, text=text)
    if spans == "mid":
        rng = np.random.RandomState(seed + 1)
        bounds[0] = rng.randint(10, 50, size=C)
        bounds[1] = rng.randint(T // 2 - 25, T // 2 + 25, size=C)
        bounds[1, 3] = bounds[0, 3]  # an empty lane
    return data, bounds


@pytest.mark.parametrize(
    "spec", KERNEL_BODIES, ids=["-".join(map(str, s)) for s in KERNEL_BODIES]
)
def test_kernel_body_on_host_equals_plain(spec):
    # bloom_probe.cuh's tile code is the kernels' arithmetic; g++ runs it
    # here over every tile of the launch. The tile-edge cases are held to
    # the reference Pallas kernel (interpret mode) through the plain probe
    cfg = make_cfg(*spec[:6], seed=3)
    C, T, budget, spans = 150, 300, 0, "ragged"
    if len(spec) > 6:
        C, T, gt, budget, spans = TILE_EDGES[spec[6]]
        if gt == "one":
            cfg = dataclasses.replace(cfg, gt=64 if cfg.sampled else 32)
    data, bounds = edge_batch(4, C, T, spans, cfg.fold_case)
    data_tm, Cp = port_bloom.prep_time_major(torch.from_numpy(data), cfg)
    bp = port_bloom.pad_bounds(torch.from_numpy(bounds), Cp)
    words = torch.from_numpy(random_words(cfg, 5))
    h_bits, h_total = kernels.probe_on_host(data_tm, bp, words, cfg,
                                            smem_budget=budget)
    p_bits, p_total = port_bloom.probe_bits_plain(data_tm, bp, words, cfg)
    assert torch.equal(h_bits, p_bits)
    assert int(h_total[0]) == int(p_total[0]) > 0
    if len(spec) == 6:
        return
    plan = kernels.probe_plan_on_host(data_tm.shape[0], Cp, cfg,
                                      smem_budget=budget)
    if budget:
        assert plan["lanes"] < 128
    if cfg.v == 256 or not budget:  # 256 KB of words: read through L2
        assert plan["words_in_smem"] == (cfg.v < 256)
    if gt == "one":  # one tile of rows (Cp / lanes of lanes)
        assert plan["tiles"] * plan["lanes"] == Cp == 128
    r_total, r_bits = ref_bloom._hits_jit(data, bounds, words.numpy(),
                                          cfg=as_ref_cfg(cfg), interpret=True)
    np.testing.assert_array_equal(p_bits.numpy(), np.asarray(r_bits))
    assert int(p_total[0]) == int(r_total[0])


SHARD_EDGES = [  # (mode, q, stride|w, k, v, S, tile edge, data path)
    ("sampled", 4, 9, 6, 8, 3, "narrow-tiles", "u8"),
    ("sampled", 4, 9, 6, 8, 4, "span-ends-mid-tile", "u16"),
    ("sampled", 3, 5, 4, 2, 2, "one-tile", "u8"),
    ("sampled", 4, 9, 2, 256, 2, "cp128", "u8"),  # words outside smem
    ("strided", 4, 4, 6, 16, 2, "span-ends-mid-tile", "u8"),
    ("strided", 3, 7, 10, 2, 3, "cp128", "u16"),
    ("strided", 4, 4, 6, 16, 4, "one-tile", "u8"),
    ("strided", 4, 4, 6, 16, 3, "narrow-tiles", "packed"),
    ("strided", 4, 8, 6, 16, 2, "cp128", "packed"),
]


@pytest.mark.parametrize(
    "spec", SHARD_EDGES, ids=["-".join(map(str, s)) for s in SHARD_EDGES])
def test_or_into_bitmap_on_host_equals_sharded_plain(spec):
    # the pattern-shard flags of the kernels' tile code (or_into, count),
    # run tile by tile by g++: S launches into one bitmap, the last one
    # counting, equal the plain union and its popcount, on tile edges
    mode, q, sw, k, v, S, edge, path = spec
    cfg = make_cfg(mode, q, sw, k, v, seed=S)
    C, T, gt, budget, spans = TILE_EDGES[edge]
    if gt == "one":
        cfg = dataclasses.replace(cfg, gt=64 if cfg.sampled else 32)
    data, bounds = edge_batch(7, C, T, spans, False)
    if path == "u16":
        data = (data.astype(np.uint16) * 8) % 2048
    # shard filters of half their bits (a quarter for k <= 4), so the
    # union is not all ones and every shard adds survivors of its own
    rng = np.random.RandomState(S)
    words = torch.from_numpy(np.stack([
        random_words(cfg, 20 + s) & (random_words(cfg, 40 + s)
                                     if k <= 4 else -1)
        for s in range(S)]))
    data_tm, Cp = port_bloom.prep_time_major(torch.from_numpy(data), cfg,
                                             packed=path == "packed")
    bp = port_bloom.pad_bounds(torch.from_numpy(bounds), Cp)
    launch = functools.partial(kernels.probe_on_host, smem_budget=budget)
    h_bits, h_total = port_bloom.or_shards(launch, data_tm, bp, words, cfg)
    p_bits, p_total = port_bloom.sharded_probe_bits_plain(data_tm, bp, words,
                                                          cfg)
    assert torch.equal(h_bits, p_bits)
    assert int(h_total[0]) == int(p_total[0]) > 0
    one, one_total = port_bloom.probe_bits_plain(data_tm, bp, words[0], cfg)
    assert int(p_total[0]) > int(one_total[0])  # the other shards add bits
    # each flag alone: OR into a bitmap already there (count on), and a
    # count-less write (its total stays 0)
    prior = torch.from_numpy(rng.randint(-(2**31), 2**31, size=one.shape)
                             .astype(np.int32))
    prior[rng.rand(*one.shape) < 0.7] = 0
    b, t = launch(data_tm, bp, words[0], cfg, into=prior.clone())
    assert torch.equal(b, prior | one)
    assert int(t[0]) == int(port_bloom.popcount(prior | one)[0])
    b, t = launch(data_tm, bp, words[0], cfg, count=False)
    assert torch.equal(b, one) and int(t[0]) == 0


def test_cpu_probe_never_reaches_the_kernels():
    cfg = make_cfg("sampled", 4, 9, 6, 8)
    data, bounds = ragged_batch(6, 20, 100)
    before = dict(kernels.launches)
    port_bloom.hits(torch.from_numpy(data), torch.from_numpy(bounds),
                    torch.from_numpy(random_words(cfg, 0)), cfg)
    assert kernels.launches == before
    data_tm, Cp = port_bloom.prep_time_major(torch.from_numpy(data), cfg)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.launch_probe(
            data_tm, port_bloom.pad_bounds(torch.from_numpy(bounds), Cp),
            torch.from_numpy(random_words(cfg, 0)), cfg,
        )


def test_kernel_argument_checks():
    cfg = make_cfg("sampled", 4, 9, 6, 8)
    words = torch.from_numpy(random_words(cfg, 0))
    bounds = torch.zeros((2, 128), dtype=torch.int32)
    good = torch.zeros((128, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="tile height"):
        kernels.probe_on_host(good[:100], bounds, words, cfg)
    with pytest.raises(ValueError, match="bounds"):
        kernels.probe_on_host(good, bounds.to(torch.int64), words, cfg)
    with pytest.raises(ValueError, match="words"):
        kernels.probe_on_host(good, bounds, words[:2], cfg)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.probe_on_host(good.t(), bounds, words, cfg)
    wide = dataclasses.replace(cfg, w=130)
    with pytest.raises(ValueError, match="context"):
        kernels.probe_on_host(good, bounds, words, wide)


def sparse_bitmap(seed, W=5, C=140):
    rng = np.random.RandomState(seed)
    bits = rng.randint(-(2**31), 2**31, size=(W, C)).astype(np.int32)
    bits[rng.rand(W, C) < 0.8] = 0
    bits[:, 17] = 0  # an empty lane
    bits[2, 30] = np.int32(-(2**31))  # bit 31 only
    return bits


@pytest.mark.parametrize("k", [16, 64, 256, 2048])
@pytest.mark.parametrize("stride", [1, 3])
def test_bitmap_to_candidates_equals_reference(k, stride):
    bits = sparse_bitmap(k + stride)
    n_r, lane_r, row_r, over_r = (
        np.asarray(x) for x in ref_vd.bitmap_to_candidates(
            jnp.asarray(bits), stride, k)
    )
    n_p, lane_p, row_p, over_p = port_vd.bitmap_to_candidates(
        torch.from_numpy(bits), stride, k
    )
    assert int(n_p) == int(n_r)
    np.testing.assert_array_equal(lane_p.numpy(), lane_r)  # incl. sentinels
    np.testing.assert_array_equal(row_p.numpy(), row_r)
    assert bool(over_p) == bool(over_r)
    n_bits = int(np.unpackbits(bits.view(np.uint8)).sum())
    assert bool(over_p) == (n_bits > k)


def test_bitmap_to_candidates_flags_word_overflow():
    # 10 nonzero words of one bit each, capacity 4: the first 4 candidates
    # are kept and the overflow is flagged. (The reference flags only the
    # bit stage, counts exactly 4 and reports no overflow, so its refined
    # bitmap drops the other 6 candidates.)
    bits = np.zeros((4, 128), np.int32)
    bits[0, :10] = 1
    n, lane, row, over = port_vd.bitmap_to_candidates(
        torch.from_numpy(bits), 1, 4
    )
    assert bool(over) and int(n) == 4
    assert lane.tolist() == [0, 1, 2, 3] and row.tolist() == [0, 0, 0, 0]


def test_next_cap_equal():
    for n in (0, 1, 255, 256, 257, 384, 385, 3000, 10**6):
        assert port_vd.next_cap(n) == ref_vd.next_cap(n)
    assert port_vd.MAX_DEVICE_CAND == ref_vd.MAX_DEVICE_CAND


@pytest.mark.parametrize("q,bits,fold", [(4, 8, False), (6, 8, True),
                                         (5, 11, False)])
def test_exact_member_equals_reference(q, bits, fold):
    rng = np.random.RandomState(q + bits)
    hi = 1 << bits
    data = rng.randint(0, min(hi, 256), size=3000).astype(
        np.uint8 if bits == 8 else np.int32
    )
    # members: grams at a few data positions (folded, like the builder's)
    starts = rng.randint(0, 3000 - q, size=40)
    gram = [tuple(int(x) for x in data[s : s + q]) for s in starts]
    if fold:
        gram = [tuple(c + 32 if 65 <= c <= 90 else c for c in g)
                for g in gram]
    keys = ref_exact.pack_grams(set(gram), q, bits)
    rt = ref_exact.table_from_keys(keys, q, bits=bits)
    base = np.concatenate([
        starts, rng.randint(-5, 3005, size=200)  # clipped out of range
    ]).astype(np.int32)
    valid = rng.rand(len(base)) < 0.9
    dx_r = ref_exact.DeviceExact.put(rt, fold)
    want = np.asarray(ref_exact.exact_member(
        dx_r, jnp.asarray(data), jnp.asarray(base), jnp.asarray(valid)))
    pt = port_exact.table_from_keys(keys, q, bits=bits)
    dx_p = port_exact.DeviceExact.put(pt, fold, torch.device("cpu"))
    got = port_exact.exact_member(
        dx_p, torch.from_numpy(data), torch.from_numpy(base),
        torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:40].sum() == valid[:40].sum()  # members found
    empty = port_exact.DeviceExact.put(
        port_exact.table_from_keys(np.zeros(0, np.uint64), q, bits=bits),
        fold, torch.device("cpu"))
    assert not port_exact.exact_member(
        empty, torch.from_numpy(data), torch.from_numpy(base),
        torch.from_numpy(valid)).any()


@pytest.mark.parametrize("k_ref,words_kind", [(256, "superset"),
                                              (8, "all-ones")])
def test_refined_probe_equals_reference(k_ref, words_kind):
    # a real filter and planted true grams. "superset": random bits ORed
    # into the words make many survivors bloom false positives, which the
    # refinement erases. "all-ones": every selected row survives, several
    # per bitmap word, so both packages see the overflow of k_ref=8 and
    # pass the unrefined bitmap through
    rng = np.random.RandomState(11)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(60)]
    bft = port_bloom.BloomFilterTable.build(
        pats, force=("sampled", 4, 9, 3, 1))
    cfg = bft.cfg
    # extra random bits: a superset filter, so many survivors are bloom
    # false positives for the refinement to erase
    if words_kind == "all-ones":
        words = np.full_like(bft.words, -1)
    else:
        words = bft.words | (
            rng.randint(-(2**31), 2**31, size=bft.words.shape)
            & rng.randint(-(2**31), 2**31, size=bft.words.shape)
        ).astype(np.int32)
    C, T = 40, 200
    data = rng.randint(0, 256, size=(C, T)).astype(np.uint8)
    for i in range(0, C, 3):
        o = rng.randint(0, T - 12)
        data[i, o : o + 12] = np.frombuffer(pats[i], np.uint8)
    bounds = np.stack([np.full(C, 4, np.int32), np.full(C, T, np.int32)])
    xt = ref_exact.table_from_keys(bft.gram_keys, cfg.q)
    r_total, r_bits = ref_bloom._hits_refined_jit(
        data, bounds, words, xt.lo.view(np.int32), None,
        cfg=as_ref_cfg(cfg), interpret=True,
        exact_meta=xt.device_meta(cfg.fold_case), k_ref=k_ref,
    )
    dx = port_exact.DeviceExact.put(
        port_exact.table_from_keys(bft.gram_keys, cfg.q), cfg.fold_case,
        torch.device("cpu"))
    p_total, p_bits = port_bloom.hits_refined(
        torch.from_numpy(data), torch.from_numpy(bounds),
        torch.from_numpy(words), dx, cfg, k_ref)
    np.testing.assert_array_equal(p_bits.numpy(), np.asarray(r_bits))
    assert int(p_total[0]) == int(r_total[0])
    u_total, _ = port_bloom.hits(torch.from_numpy(data),
                                 torch.from_numpy(bounds),
                                 torch.from_numpy(words), cfg)
    if k_ref == 8:
        assert int(p_total[0]) == int(u_total[0]) > k_ref  # pass-through
    else:
        assert 0 < int(p_total[0]) < int(u_total[0])  # fp erased
