"""The frozen copy of the probe's bound equals ``chip_smoke.probe_bound``
of the port at today's two picks (the byte configuration's sampled filter
and the ushort configuration's strided uint16 filter), on batches of the
cells' own shapes cut to a few lanes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.roofline.probe import probe_bound, time_major


def filter_of(kind: str):
    from tpu_pattern_matching_torch.core.dfa import (ALPHABET_USHORT,
                                                     AhoCorasick)
    from tpu_pattern_matching_torch.ops.bloom import BloomFilterTable

    rng = np.random.default_rng(11)
    if kind == "bytes":
        ac = AhoCorasick()
        sigs = rng.integers(0, 256, size=(15000, 12), dtype=np.uint8)
        for s in sigs:
            ac.add_pattern(bytes(s))
    else:
        from perfbench.generators.packet_sigs import make

        ac = AhoCorasick(ALPHABET_USHORT)
        sigs = make({"count": 2000, "min_len": 6, "max_len": 16}, rng)
        for s in sigs:
            ac.add_pattern(tuple(int(x) for x in s))
    table = ac.compile()
    return sigs, BloomFilterTable.from_table(table), table


@pytest.mark.parametrize("kind,pick", [("bytes", "sampled_q4s1w9k8v8"),
                                       ("tokens", "strided")])
def test_frozen_bound_equals_chip_smoke(kind, pick):
    import chip_smoke
    from tpu_pattern_matching_torch.bench import cfg_name
    from tpu_pattern_matching_torch.ops import bloom
    from tpu_pattern_matching_torch.utils.common import pad_halo

    sigs, bft, table = filter_of(kind)
    assert cfg_name(bft.cfg).startswith(pick)
    dtype = np.uint8 if kind == "bytes" else np.uint16
    B = 4096 if kind == "bytes" else 2048
    halo = pad_halo(table.max_pat_len - 1, B)
    C = 96
    rng = np.random.default_rng(5)
    top = 256 if kind == "bytes" else 1500
    data = rng.integers(0, top, size=(C, halo + B)).astype(dtype)
    for k in range(200):  # plants, so banks are probed past the first
        s = sigs[rng.integers(len(sigs))]
        r, t = rng.integers(C), rng.integers(halo, halo + B - len(s))
        data[r, t:t + len(s)] = s
    start = np.full(C, halo, np.int32)
    start[1:] = 0
    end = np.full(C, halo + B, np.int32)
    end[-1] = halo + B // 3
    dt = torch.from_numpy(data)
    bounds = torch.from_numpy(np.stack([start, end]))
    words = bft.put("cpu").words
    data_tm, bp = time_major(dt, bounds, bft.cfg)
    want_tm, Cp = bloom.prep_time_major(dt, bft.cfg)
    assert torch.equal(data_tm, want_tm)
    assert torch.equal(bp, bloom.pad_bounds(bounds, Cp))
    got = probe_bound(data_tm, bp, words, bft.cfg)
    want = chip_smoke.probe_bound(torch, bloom, want_tm,
                                  bloom.pad_bounds(bounds, Cp), words,
                                  bft.cfg)
    assert got == want
    assert got["bank_probes"] > got["tested"]
