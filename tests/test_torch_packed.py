"""The packed strided probe (K3) of the PyTorch port against the JAX
reference, on the CPU.

The packed data path views each 4 bytes of a lane as one little-endian
int32 and probes those words (strided configs with ``stride % 4 == 0``).
Its bitmap must equal the reference's packed Pallas kernel run in
interpret mode and the port's own byte path, bit for bit; the kernel's
tile code (csrc/bloom_probe.cuh, the strided kernel's steps on staged
word rows), compiled for the CPU and run tile by tile, must equal the
plain version, on tile edges forced by small shared-memory budgets.
Integers: tolerance zero."""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_pattern_matching.ops import bloom as ref_bloom
from tpu_pattern_matching.ops import exact_gram as ref_exact
from tpu_pattern_matching_torch.ops import bloom as port_bloom
from tpu_pattern_matching_torch.ops import exact_gram as port_exact
from tpu_pattern_matching_torch.ops import kernels


def as_ref_cfg(cfg):
    return ref_bloom.BloomConfig(**dataclasses.asdict(cfg))


def packed_case(s, fold, seed=11):
    """A built strided filter at stride s and a 4-lane batch with ragged
    spans (full, halo start, empty, full) and one planted pattern — the
    reference's own packed test (tests/test_bloom_kernel_variants.py)."""
    rng = np.random.RandomState(seed + s)
    q = min(4, s)
    pats = [bytes(rng.randint(0, 256, size=q + s + 3).astype(np.uint8))
            for _ in range(40)]
    bft = port_bloom.BloomFilterTable.build(
        pats, force=("strided", q, s, 3, 2), fold_case=fold)
    C, T = 4, bft.cfg.tile_rows * 2 + 7
    lo, hi = (32, 128) if fold else (0, 256)
    data = rng.randint(lo, hi, size=(C, T)).astype(np.uint8)
    data[1, 5 : 5 + len(pats[0])] = np.frombuffer(pats[0], np.uint8)
    bounds = np.stack([np.asarray([0, 2, 0, T], np.int32),
                       np.asarray([T, T, 0, T], np.int32)])
    return bft, data, bounds


PACKED_CASES = [(4, False), (8, True), (12, False)]


@pytest.mark.parametrize("s,fold", PACKED_CASES)
def test_packed_hits_equal_reference_kernel(s, fold):
    bft, data, bounds = packed_case(s, fold)
    cfg = bft.cfg
    r_total, r_bits = ref_bloom._hits_jit(
        data, bounds, bft.words, cfg=as_ref_cfg(cfg), interpret=True,
        packed=True)
    args = (torch.from_numpy(data), torch.from_numpy(bounds),
            torch.from_numpy(bft.words), cfg)
    p_total, p_bits = port_bloom.hits(*args, packed=True)
    np.testing.assert_array_equal(p_bits.numpy(), np.asarray(r_bits))
    assert int(p_total[0]) == int(r_total[0])
    b_total, b_bits = port_bloom.hits(*args, packed=False)
    assert torch.equal(p_bits, b_bits) and int(b_total[0]) == int(p_total[0])


@pytest.mark.parametrize("k_ref", [256, 2])
def test_packed_refined_equals_reference(k_ref):
    # k_ref=2 overflows: both packages pass the unrefined bitmap through
    bft, data, bounds = packed_case(8, False, seed=5)
    cfg = bft.cfg
    words = np.full_like(bft.words, -1)  # every tested row survives
    xt = ref_exact.table_from_keys(bft.gram_keys, cfg.q)
    r_total, r_bits = ref_bloom._hits_refined_jit(
        data, bounds, words, xt.lo.view(np.int32), None,
        cfg=as_ref_cfg(cfg), interpret=True,
        exact_meta=xt.device_meta(cfg.fold_case), k_ref=k_ref, packed=True)
    dx = port_exact.DeviceExact.put(
        port_exact.table_from_keys(bft.gram_keys, cfg.q), cfg.fold_case,
        torch.device("cpu"))
    p_total, p_bits = port_bloom.hits_refined(
        torch.from_numpy(data), torch.from_numpy(bounds),
        torch.from_numpy(words), dx, cfg, k_ref, packed=True)
    np.testing.assert_array_equal(p_bits.numpy(), np.asarray(r_bits))
    assert int(p_total[0]) == int(r_total[0]) > 0


def make_cfg(q, s, k, v, fold=False, seed=0):
    rng = np.random.RandomState(seed)
    return port_bloom.BloomConfig(
        q=q, stride=s, kbanks=k, v=v,
        mix1=tuple(int(x) | 1 for x in rng.randint(1, 2**31, size=q)),
        mix2=tuple(int(x) | 1 for x in rng.randint(1, 2**31, size=q)),
        fold_case=fold, gt=port_bloom.GT)


PACKED_BODIES = [  # (q, stride, k, v, fold)
    (4, 4, 6, 16, False),
    (3, 8, 10, 2, True),
    (8, 8, 3, 4, False),  # two words per gram
    (5, 12, 2, 1, False),
    (4, 8, 10, 4, True),  # s8 nocase k>8
    (6, 12, 6, 256, False),  # s12 q6 v=256: words read outside shared memory
]


@pytest.mark.parametrize(
    "spec", PACKED_BODIES, ids=["-".join(map(str, s)) for s in PACKED_BODIES])
def test_packed_kernel_body_on_host_equals_plain(spec):
    cfg = make_cfg(*spec, seed=3)
    rng = np.random.RandomState(4)
    C, T = 150, 300
    lo, hi = (32, 128) if cfg.fold_case else (0, 256)
    data = torch.from_numpy(rng.randint(lo, hi, size=(C, T)).astype(np.uint8))
    start = rng.randint(0, 9, size=C).astype(np.int32)
    end = rng.randint(T - 20, T + 1, size=C).astype(np.int32)
    end[3] = start[3]
    bounds = torch.from_numpy(np.stack([start, end]))
    words = torch.from_numpy(rng.randint(
        -(2**31), 2**31, size=(cfg.kbanks, cfg.v, 128)).astype(np.int32))
    data_pk, Cp = port_bloom.prep_time_major(data, cfg, packed=True)
    bp = port_bloom.pad_bounds(bounds, Cp)
    assert data_pk.dtype == torch.int32 and data_pk.is_contiguous()
    h_bits, h_total = kernels.probe_on_host(data_pk, bp, words, cfg)
    p_bits, p_total = port_bloom.probe_bits_plain(data_pk, bp, words, cfg)
    assert torch.equal(h_bits, p_bits)
    assert int(h_total[0]) == int(p_total[0]) > 0
    data_tm, _ = port_bloom.prep_time_major(data, cfg)
    b_bits, b_total = port_bloom.probe_bits_plain(data_tm, bp, words, cfg)
    assert torch.equal(b_bits, p_bits) and int(b_total[0]) == int(p_total[0])


PACKED_TILES = [  # (q, stride, k, v, fold): chip_smoke.py's packed configs
    (4, 4, 6, 16, False),  # packed s4
    (4, 8, 10, 4, True),  # packed s8 nocase k>8
    (6, 12, 6, 256, False),  # packed s12 q6 v=256
]
PACKED_EDGES = {  # edge: (lanes, rows, shared-memory budget, spans)
    "narrow-tiles": (150, 300, 40_000, "ragged"),  # 32-lane tiles
    "span-ends-mid-tile": (150, 600, 40_000, "mid"),
    "cp128": (128, 300, 0, "ragged"),  # one lane tile
    "cp128-narrow": (100, 200, 40_000, "mid"),
}


@pytest.mark.parametrize("edge", list(PACKED_EDGES))
@pytest.mark.parametrize(
    "spec", PACKED_TILES, ids=["-".join(map(str, s)) for s in PACKED_TILES])
def test_packed_tiles_on_host_equal_plain(spec, edge):
    # the packed kernel's tile loop at the edges of its tiling: tiles
    # narrower than the batch, spans that end inside a tile, Cp = 128
    cfg = make_cfg(*spec, seed=6)
    C, T, budget, spans = PACKED_EDGES[edge]
    rng = np.random.RandomState(7)
    lo, hi = (32, 128) if cfg.fold_case else (0, 256)
    data = torch.from_numpy(rng.randint(lo, hi, size=(C, T)).astype(np.uint8))
    start = rng.randint(0, 9, size=C).astype(np.int32)
    end = rng.randint(T - 20, T + 1, size=C).astype(np.int32)
    if spans == "mid":
        start = rng.randint(10, 50, size=C).astype(np.int32)
        end = rng.randint(T // 2 - 40, T // 2 + 40, size=C).astype(np.int32)
    end[3] = start[3]
    bounds = torch.from_numpy(np.stack([start, end]))
    words = torch.from_numpy(rng.randint(
        -(2**31), 2**31, size=(cfg.kbanks, cfg.v, 128)).astype(np.int32))
    data_pk, Cp = port_bloom.prep_time_major(data, cfg, packed=True)
    bp = port_bloom.pad_bounds(bounds, Cp)
    h_bits, h_total = kernels.probe_on_host(data_pk, bp, words, cfg,
                                            smem_budget=budget)
    p_bits, p_total = port_bloom.probe_bits_plain(data_pk, bp, words, cfg)
    assert torch.equal(h_bits, p_bits)
    assert int(h_total[0]) == int(p_total[0]) > 0
    T4 = data_pk.shape[0] * 4
    plan = kernels.probe_plan_on_host(T4, Cp, cfg, smem_budget=budget,
                                      packed=True)
    n_words = T4 // (32 * cfg.stride)
    assert plan["tiles"] == Cp // plan["lanes"] * n_words  # one word a tile
    assert (plan["lanes"] < 128) == (budget > 0)
    if edge.startswith("cp128"):
        assert Cp == 128
    # the packed buffers hold the byte tile's rows, rounded up to words
    byte = kernels.probe_plan_on_host(T4, Cp, cfg, smem_budget=budget)
    assert byte["lanes"] == plan["lanes"]
    assert 0 <= plan["smem_bytes"] - byte["smem_bytes"] <= 2 * 4 * 128


def test_packed_view_is_little_endian():
    # the packed layout's contract, as the reference's bitcast: byte 0 of
    # a lane's 4-byte group is the low byte of its word
    cfg = make_cfg(4, 4, 2, 1)
    data = torch.arange(1, 9, dtype=torch.uint8).reshape(1, 8)
    words, Cp = port_bloom.prep_time_major(data, cfg, packed=True)
    assert Cp == 128 and words.shape == (cfg.tile_rows // 4, 128)
    assert int(words[0, 0]) == 0x04030201 and int(words[1, 0]) == 0x08070605
    assert not words[:, 1:].any() and not words[2:].any()
    back = port_bloom.unpack_time_major(words)
    tm, _ = port_bloom.prep_time_major(data, cfg)
    assert torch.equal(back, tm.to(torch.int64))


def test_packed_policy_and_eligibility():
    assert port_bloom.PACKED_AUTO is ref_bloom.PACKED_AUTO is False
    for s, sampled, dtype, ok in [(4, False, torch.uint8, True),
                                  (12, False, torch.uint8, True),
                                  (6, False, torch.uint8, False),
                                  (1, True, torch.uint8, False),
                                  (4, False, torch.int32, False)]:
        cfg = dataclasses.replace(make_cfg(2, s, 2, 1), sampled=sampled,
                                  w=3 if sampled else 0)
        assert port_bloom.packed_eligible(cfg, dtype) is ok
    cfg = make_cfg(3, 6, 2, 1)
    data = torch.zeros((2, 10), dtype=torch.uint8)
    with pytest.raises(ValueError, match="stride % 4"):
        port_bloom.prep_time_major(data, cfg, packed=True)
    # packed=None follows PACKED_AUTO (off): the byte layout
    s4 = make_cfg(3, 4, 2, 1)
    words = torch.zeros((2, 1, 128), dtype=torch.int32)
    bounds = torch.tensor([[0, 0], [10, 10]], dtype=torch.int32)
    assert torch.equal(port_bloom.hits(data, bounds, words, s4)[1],
                       port_bloom.hits(data, bounds, words, s4, packed=True)[1])
    with pytest.raises(ValueError, match="stride % 4"):
        kernels.probe_on_host(torch.zeros((64, 128), dtype=torch.int32),
                              torch.zeros((2, 128), dtype=torch.int32),
                              words, make_cfg(3, 3, 2, 1))
