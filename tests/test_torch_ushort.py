"""The packet-metadata (ushort) path of the PyTorch port against the JAX
reference, on the CPU: uint16 token lanes over the alphabet of 2048.

- The plain probe at uint16 equals the reference Pallas kernels in
  interpret mode (sampled and strided), and the refined probe with 11-bit
  exact-gram keys equals ``_hits_refined_jit``.
- The dense walk equals ``scan_batch``; ``verify_candidates`` (the window
  walk inside) equals ``_verify_jit``, unrefined and refined.
- The kernels' per-thread code (csrc/*.cuh, built with g++) at uint16
  equals the plain versions, the dense walk's sub-spans included.
- ``MatchSession.find`` on flow text, on all three paths, equals
  ``match_python`` and the reference session, including the
  halo-straddling and out-of-range-clamp cases of tests/test_ushort.py.
- The two "auto" rules: the session's (dense for ushort tables) and the
  ushort grep's, ``run_ushort_grep`` (bloom on a CUDA device, dense
  elsewhere).
- A filter's save/load round trip and ``from_reference`` keep
  ``alphabet_size``.

Every output is an integer, so the tolerance is zero."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from chip_smoke import seam_batch
from tests.test_torch_dense import (SEAMS, SUBSPANS,
                                    check_subspans_equal_plain, walk_args)
from tpu_pattern_matching.core.dfa import AhoCorasick
from tpu_pattern_matching.core.oracle import match_python
from tpu_pattern_matching.ops import bloom as ref_bloom
from tpu_pattern_matching.ops import exact_gram as ref_exact
from tpu_pattern_matching.ops import match_xla as ref_mx
from tpu_pattern_matching.ops import verify_device as ref_vd
from tpu_pattern_matching.ops.table import DeviceTable as RefTable
from tpu_pattern_matching.runtime.session import MatchSession as RefSession
from tpu_pattern_matching_torch.ops import bloom as port_bloom
from tpu_pattern_matching_torch.ops import exact_gram as port_exact
from tpu_pattern_matching_torch.ops import kernels
from tpu_pattern_matching_torch.ops import match_xla as port_mx
from tpu_pattern_matching_torch.ops import verify_device as port_vd
from tpu_pattern_matching_torch.ops.table import DeviceTable
from tpu_pattern_matching_torch.runtime.session import MatchSession

CPU = torch.device("cpu")
A = 2048


def make_cfg(mode, q, sw, k, v, seed=0):
    rng = np.random.RandomState(seed)
    sampled = mode == "sampled"
    return port_bloom.BloomConfig(
        q=q, stride=1 if sampled else sw, kbanks=k, v=v,
        mix1=tuple(int(x) | 1 for x in rng.randint(1, 2**31, size=q)),
        mix2=tuple(int(x) | 1 for x in rng.randint(1, 2**31, size=q)),
        gt=128 if sampled else port_bloom.GT, sampled=sampled,
        w=sw if sampled else 0,
    )


def as_ref_cfg(cfg):
    return ref_bloom.BloomConfig(**dataclasses.asdict(cfg))


def u16_batch(seed, C, T, halo=8, sigs=(), n_plant=0):
    """Random tokens below 2048 with ragged spans (halo rows, an empty
    lane, a short lane) and ``n_plant`` signatures planted."""
    rng = np.random.RandomState(seed)
    data = rng.randint(0, A, size=(C, T)).astype(np.uint16)
    for k in range(n_plant):
        s = sigs[k % len(sigs)]
        lane, o = rng.randint(0, C), rng.randint(0, T - len(s))
        data[lane, o : o + len(s)] = s
    start = np.where(rng.rand(C) < 0.5, 0, halo).astype(np.int32)
    end = rng.randint(T - 20, T + 1, size=C).astype(np.int32)
    end[2] = start[2]  # empty lane
    end[5] = min(T, int(start[5]) + 6)  # short lane
    return data, np.stack([start, end])


def random_sigs(seed, n, lo=3, hi=9):
    rng = np.random.RandomState(seed)
    return [tuple(int(x) for x in rng.randint(0, A, size=rng.randint(lo, hi)))
            for _ in range(n)]


def ushort_table(sigs, table_dtype=None):
    ac = AhoCorasick(A)
    for s in sigs:
        ac.add_pattern(s)
    table = ac.compile()
    if table_dtype is not None:
        table.goto_signed = table.goto_signed.astype(table_dtype)
    return table


def random_words(cfg, seed):
    return np.random.RandomState(seed).randint(
        -(2**31), 2**31, size=(cfg.kbanks, cfg.v, 128)).astype(np.int32)


PROBES = {  # name: (mode, q, stride|w, k, v)
    "sampled-q3w4": ("sampled", 3, 4, 8, 4),
    "strided-2000-pick": ("strided", 3, 4, 6, 8),
    "strided-fixture-pick": ("strided", 2, 2, 2, 1),
}


@pytest.mark.parametrize("name", list(PROBES))
def test_plain_probe_u16_equals_reference_kernel(name):
    cfg = make_cfg(*PROBES[name], seed=len(name))
    words = random_words(cfg, 1)
    data, bounds = u16_batch(2, 130, 150)
    r_total, r_bits = ref_bloom._hits_jit(
        data, bounds, words, cfg=as_ref_cfg(cfg), interpret=True)
    p_total, p_bits = port_bloom.hits(
        torch.from_numpy(data), torch.from_numpy(bounds),
        torch.from_numpy(words), cfg)
    np.testing.assert_array_equal(p_bits.numpy(), np.asarray(r_bits))
    assert int(p_total[0]) == int(r_total[0]) > 0


KERNEL_BODIES = [  # (mode, q, stride|w, k, v[, tile edge])
    ("sampled", 3, 4, 8, 32),  # 128 KB of words: the shared-memory opt-in
    ("sampled", 3, 20, 10, 8),  # wider context than 16 rows
    ("strided", 3, 4, 6, 8),
    ("strided", 2, 3, 9, 2),
    # the tile edges of the kernels' tiling (TILE_EDGES)
    ("sampled", 3, 4, 8, 32, "narrow-tiles"),
    ("sampled", 3, 4, 8, 32, "span-ends-mid-tile"),
    ("strided", 3, 4, 6, 8, "span-ends-mid-tile"),
    ("sampled", 3, 4, 8, 4, "one-tile"),
    ("strided", 3, 4, 6, 8, "one-tile"),
    ("strided", 3, 4, 6, 8, "cp128"),
    ("sampled", 1, 1, 2, 4, "narrow-tiles"),  # q = 1, w = 1
    ("sampled", 8, 20, 4, 8, "narrow-tiles"),  # q = 8, w = 20
    ("strided", 8, 8, 4, 2, "narrow-tiles"),  # q = 8
    ("strided", 3, 8, 8, 256, "cp128"),  # words outside shared memory
]

TILE_EDGES = {  # edge: (lanes, rows, gt, shared-memory budget, spans)
    "narrow-tiles": (150, 300, None, 48_000, "ragged"),  # 32-64 lanes
    "span-ends-mid-tile": (150, 256, None, 0, "mid"),
    "one-tile": (100, 60, "one", 0, "ragged"),  # T and Cp of one tile
    "cp128": (128, 300, None, 0, "ragged"),
}


@pytest.mark.parametrize(
    "spec", KERNEL_BODIES, ids=["-".join(map(str, s)) for s in KERNEL_BODIES])
def test_probe_kernel_body_u16_on_host_equals_plain(spec):
    # the kernels' tile code at uint16 (tiles of twice the bytes); the
    # tile-edge cases are held to the reference kernel through the plain
    # probe
    cfg = make_cfg(*spec[:5], seed=3)
    C, T, budget, spans = 150, 300, 0, "ragged"
    if len(spec) > 5:
        C, T, gt, budget, spans = TILE_EDGES[spec[5]]
        if gt == "one":
            cfg = dataclasses.replace(cfg, gt=64 if cfg.sampled else 32)
    data, bounds = u16_batch(4, C, T)
    if spans == "mid":
        rng = np.random.RandomState(5)
        bounds[0] = rng.randint(10, 50, size=C)
        bounds[1] = rng.randint(T // 2 - 25, T // 2 + 25, size=C)
    data_tm, Cp = port_bloom.prep_time_major(torch.from_numpy(data), cfg)
    assert data_tm.dtype == torch.uint16
    bp = port_bloom.pad_bounds(torch.from_numpy(bounds), Cp)
    words = torch.from_numpy(random_words(cfg, 5))
    h_bits, h_total = kernels.probe_on_host(data_tm, bp, words, cfg,
                                            smem_budget=budget)
    p_bits, p_total = port_bloom.probe_bits_plain(data_tm, bp, words, cfg)
    assert torch.equal(h_bits, p_bits)
    assert int(h_total[0]) == int(p_total[0]) > 0
    assert kernels.probe_mode(data_tm, cfg) == spec[0] + "_u16"
    plan = kernels.probe_plan_on_host(data_tm.shape[0], Cp, cfg, sym16=1,
                                      smem_budget=budget)
    if budget == 0:  # every filter up to k8 v32 is read from shared memory
        assert plan["words_in_smem"] == (cfg.v < 256)
    if len(spec) == 5:
        return
    if budget:
        assert plan["lanes"] < 128
    if gt == "one":  # one tile of rows
        assert plan["tiles"] * plan["lanes"] == Cp == 128
    r_total, r_bits = ref_bloom._hits_jit(data, bounds, words.numpy(),
                                          cfg=as_ref_cfg(cfg), interpret=True)
    np.testing.assert_array_equal(p_bits.numpy(), np.asarray(r_bits))
    assert int(p_total[0]) == int(r_total[0])


def test_u16_symbols_refuse_fold_case_and_packing():
    cfg = dataclasses.replace(make_cfg("strided", 2, 4, 2, 1), fold_case=True)
    data = torch.zeros((3, 100), dtype=torch.uint16)
    data_tm, Cp = port_bloom.prep_time_major(data, cfg)
    with pytest.raises(ValueError, match="fold_case"):
        kernels.probe_on_host(data_tm, torch.zeros((2, Cp), dtype=torch.int32),
                              torch.zeros((2, 1, 128), dtype=torch.int32), cfg)
    with pytest.raises(ValueError, match="uint8"):
        port_bloom.prep_time_major(data, make_cfg("strided", 2, 4, 2, 1),
                                   packed=True)
    with pytest.raises(ValueError, match="uint8 or uint16"):
        kernels.dense_walk_on_host(
            torch.zeros(A, dtype=torch.int16),
            torch.zeros((4, 3), dtype=torch.int32),
            torch.zeros((2, 3), dtype=torch.int32), alphabet_size=A, halo=0,
            max_results=1, max_pat_len=1)


@pytest.mark.parametrize("k_ref", [256, 8])
def test_refined_probe_u16_equals_reference(k_ref):
    # 11-bit exact-gram keys (q=3: 33 bits, both key planes); k_ref=8
    # overflows, so both packages pass the unrefined bitmap through
    sigs = random_sigs(11, 40, 6, 10)
    bft = port_bloom.BloomFilterTable.build(sigs, alphabet_size=A)
    cfg = bft.cfg
    assert bft.gram_bits == 11 and cfg.q * 11 > 32
    rng = np.random.RandomState(12)
    words = bft.words | (rng.randint(-(2**31), 2**31, size=bft.words.shape)
                         & rng.randint(-(2**31), 2**31, size=bft.words.shape)
                         ).astype(np.int32)
    data, bounds = u16_batch(13, 40, 200, sigs=sigs, n_plant=30)
    xt = ref_exact.table_from_keys(bft.gram_keys, cfg.q, bits=11)
    r_total, r_bits = ref_bloom._hits_refined_jit(
        data, bounds, words, xt.lo.view(np.int32), xt.hi.view(np.int32),
        cfg=as_ref_cfg(cfg), interpret=True,
        exact_meta=xt.device_meta(False), k_ref=k_ref)
    dx = port_exact.DeviceExact.put(
        port_exact.table_from_keys(bft.gram_keys, cfg.q, bits=11), False, CPU)
    p_total, p_bits = port_bloom.hits_refined(
        torch.from_numpy(data), torch.from_numpy(bounds),
        torch.from_numpy(words), dx, cfg, k_ref)
    np.testing.assert_array_equal(p_bits.numpy(), np.asarray(r_bits))
    assert int(p_total[0]) == int(r_total[0]) > 0


@pytest.mark.parametrize("table_dtype", [np.int16, np.int32])
def test_dense_walk_u16_equals_scan_batch_and_kernel_body(table_dtype):
    sigs = random_sigs(21, 12, 2, 5)
    table = ushort_table(sigs, table_dtype)
    data, bounds = u16_batch(22, 40, 120, sigs=sigs, n_plant=120)
    r = ref_mx.scan_batch(RefTable.put(table), data, bounds[0], bounds[1], 8,
                          max_results=4)
    dev = DeviceTable.put(table, CPU)
    p = port_mx.scan_batch(dev, torch.from_numpy(data),
                           torch.from_numpy(bounds[0]),
                           torch.from_numpy(bounds[1]), 8, max_results=4)
    for name in ("counts", "slot_state", "slot_pos"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(r, name)))
    assert int(p.total) > 0 and int(p.counts.max()) > 4  # past R slots
    args = (dev.table_flat, torch.from_numpy(data.T.copy()),
            torch.from_numpy(bounds))
    kw = dict(alphabet_size=A, halo=8, max_results=4,
              max_pat_len=table.max_pat_len, state_gid=dev.state_gid,
              num_groups=dev.num_groups)
    for h, q in zip(kernels.dense_walk_on_host(*args, **kw),
                    port_mx.dense_walk_plain(*args, **kw)):
        assert torch.equal(h, q)


@pytest.mark.parametrize("S", SUBSPANS)
@pytest.mark.parametrize("table_dtype", [np.int16, np.int32])
def test_dense_walk_u16_subspans_on_host_equal_plain(table_dtype, S):
    # the kernel's sub-spans and merge at uint16 on the seam batch, with
    # tokens past 2047 (read as 2047, the first symbol of the longest
    # signature)
    table, data_tm, bounds = seam_batch(True, table_dtype, **SEAMS)
    assert data_tm.dtype == np.uint16 and data_tm.max() == 65535
    plain = check_subspans_equal_plain(
        *walk_args(table, data_tm, bounds, SEAMS["halo"], 4, "table"), S)
    assert int(plain[0].max()) > 4 and int(plain[0][5]) > 50


@pytest.mark.parametrize("table_dtype,exact", [(np.int16, False),
                                               (np.int32, True)])
def test_verify_candidates_u16_equals_reference(table_dtype, exact):
    sigs = random_sigs(31, 10, 4, 8)
    table = ushort_table(sigs, table_dtype)
    bft = port_bloom.BloomFilterTable.build(sigs, alphabet_size=A)
    cfg = bft.cfg
    C, T, halo = 24, 160, 8
    data, bounds = u16_batch(32, C, T, halo, sigs=sigs, n_plant=60)
    _, bits = port_bloom.hits(torch.from_numpy(data), torch.from_numpy(bounds),
                              torch.from_numpy(bft.words), cfg)
    rng = np.random.RandomState(33)
    bits = bits.numpy().copy()
    extra = rng.randint(-(2**31), 2**31, size=bits.shape).astype(np.int32)
    extra[rng.rand(*bits.shape) < 0.9] = 0
    bits |= extra
    bits[:, C:] = 0
    statics = dict(alphabet_size=A, stride=cfg.stride, q=cfg.q,
                   lmax=table.max_pat_len, halo=halo, k_cand=1024, k_ev=1024,
                   num_groups=table.num_groups, k_walk=1024)
    lo = hi = meta_x = dx = None
    if exact:
        xt = ref_exact.table_from_keys(bft.gram_keys, cfg.q, bits=11)
        lo = xt.lo.view(np.int32)
        hi = xt.hi.view(np.int32) if xt.use_hi else None
        meta_x = xt.device_meta(False)
        dx = port_exact.DeviceExact.put(
            port_exact.table_from_keys(bft.gram_keys, cfg.q, bits=11), False,
            CPU)
    flat = np.ascontiguousarray(table.goto_signed).reshape(-1)
    gid = table.state_gid.astype(np.int32)
    r = [np.asarray(x) for x in ref_vd._verify_jit(
        flat, gid, data, bounds, bits, lo, hi, exact_meta=meta_x, **statics)]
    p = port_vd.verify_candidates(
        torch.from_numpy(flat), torch.from_numpy(gid), torch.from_numpy(data),
        torch.from_numpy(bounds), torch.from_numpy(bits), dx, **statics)
    for got, want in zip(p, r):
        np.testing.assert_array_equal(got.numpy(), want)
    assert r[0][0] > 0 and (r[0][4] < r[0][2]) == exact
    # the window walk's per-thread code at uint16, on the same candidates
    n, lane, row, _ = port_vd.bitmap_to_candidates(torch.from_numpy(bits),
                                                   cfg.stride, 1024)
    wargs = (torch.from_numpy(flat), torch.from_numpy(data.reshape(-1)),
             torch.from_numpy(bounds), lane, row, n.reshape(1))
    wkw = dict(C=C, T=T, alphabet_size=A, q=cfg.q, lmax=table.max_pat_len,
               halo=halo, steps=port_vd.walk_steps(table.max_pat_len, cfg.q))
    h = kernels.window_walk_on_host(*wargs, **wkw)
    w = port_vd.window_walk_plain(*wargs, **wkw)
    assert torch.equal(h[0], w[0]) and torch.equal(h[1], w[1])
    assert int(w[0].sum()) > 0


SIGS = [(40, 32, 287, 32, 106, 196), (40, 32, 287, 32, 106, 186, 32),
        (5, 5, 5)]  # tests/test_ushort.py's fixture
FLOWS = {  # name: (signatures, flow tokens, session options)
    "fixture": (SIGS, [7, 40, 32, 287, 32, 106, 196, 9, 5, 5, 5, 5, 40, 32,
                       287, 32, 106, 186, 32], dict(max_chunks=4,
                                                    chunk_len=16)),
    # (7, 7, 7, 7) straddles a lane seam: chunk_len 16, match at 14-17
    "halo-straddle": ([(40, 1500, 1500), (7, 7, 7, 7), (2047, 1, 2047)],
                      [3] * 14 + [7, 7, 7, 7] + [40, 1500, 1500, 9] * 8
                      + [2047, 1, 2047], dict(max_chunks=2, chunk_len=16)),
    # 65000 and 40000 parse to 2047, the alphabet's last symbol
    "out-of-range-clamp": ([(100, 200), (2047, 100)],
                           [65000, 100, 200, 40000, 5], dict(max_chunks=4,
                                                             chunk_len=16)),
}
PATHS = {"bloom-host": dict(engine="bloom"),
         "bloom-device": dict(engine="bloom", verify="device"),
         "dense": dict(engine="dense")}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("name", list(FLOWS))
def test_find_on_flow_text_equals_oracle_and_reference(name, path):
    sigs, toks, kw = FLOWS[name]
    table = ushort_table(sigs)
    text = ", ".join(map(str, toks)).encode()
    want = sorted(match_python([list(s) for s in sigs],
                               [min(t, A - 1) for t in toks]))
    port = MatchSession(table, device="cpu", **PATHS[path], **kw)
    got = port.find(text)
    assert got == want and want
    assert got == RefSession(table, **PATHS[path], **kw).find(text)
    if name == "out-of-range-clamp":
        assert (1, 1) in got  # 65000 -> 2047, then 100


def test_session_auto_is_dense_for_ushort_and_bloom_for_bytes():
    from tpu_pattern_matching.core.dfa import compile_patterns

    assert MatchSession(ushort_table(SIGS), device="cpu").engine == "dense"
    assert MatchSession(compile_patterns([b"abcd"]),
                        device="cpu").engine == "bloom"
    assert RefSession(ushort_table(SIGS)).engine == "dense"  # its rule too


def test_ushort_grep_auto_is_bloom_on_cuda_and_dense_elsewhere(
        tmp_path, monkeypatch):
    from tpu_pattern_matching_torch import ushort

    sig = tmp_path / "sigs"
    sig.write_text("40,1500,1500; 3; alpha\n")
    flow = tmp_path / "flow"
    flow.write_text("40, 1500, 1500")
    seen = []

    class Stop(Exception):
        pass

    def fake_session(table, **kw):
        seen.append((kw["engine"], kw["device"]))
        raise Stop

    monkeypatch.setattr(ushort, "MatchSession", fake_session)
    args = types.SimpleNamespace(
        engine="auto", pat_path=str(sig), data_path=str(flow),
        chunk_size=64, global_ws=16, max_results=16, thread_no=1)
    for dev in (torch.device("cuda", 0), CPU):
        with pytest.raises(Stop):
            ushort.run_ushort_grep(args, dev)
    assert seen == [("bloom", torch.device("cuda", 0)), ("dense", CPU)]


def test_bloom_save_load_and_from_reference_keep_alphabet(tmp_path):
    table = ushort_table([(40, 1500, 1500), (7, 7, 7, 7), (2047, 1, 2047)])
    bft = port_bloom.BloomFilterTable.from_table(table)
    path = str(tmp_path / "f.npz")
    bft.save(path)
    back = port_bloom.BloomFilterTable.load(path)
    assert back.alphabet_size == A and back.gram_bits == 11
    np.testing.assert_array_equal(back.gram_keys, bft.gram_keys)
    np.testing.assert_array_equal(back.words, bft.words)
    assert back.cfg == bft.cfg
    ref = ref_bloom.BloomFilterTable.load(path)  # the reference reads it
    assert ref.alphabet_size == A
    conv = port_bloom.BloomFilterTable.from_reference(
        ref_bloom.BloomFilterTable.from_table(table))
    assert conv.alphabet_size == A and conv.cfg == bft.cfg
    text = b"1, 40, 1500, 1500, 7, 7, 7, 7, 7, 2047, 1, 2047"
    sess = MatchSession(table, max_chunks=4, chunk_len=16, device="cpu",
                        engine="bloom", bloom_table=back)
    assert sess._bloom.exact.bits == 11
    assert sess.find(text) == sorted(match_python(
        [p.symbols for p in table.patterns],
        [1, 40, 1500, 1500, 7, 7, 7, 7, 7, 2047, 1, 2047]))


def test_copied_ushort_helpers_equal_reference(tmp_path):
    from tpu_pattern_matching import ushort as ref_ushort
    from tpu_pattern_matching_torch import ushort

    sig = tmp_path / "sigs"
    sig.write_text("40,3000,1500; 3; alpha\n7,7,7; 3; beta\n")
    a, b = ushort.compile_signatures(str(sig)), ref_ushort.compile_signatures(
        str(sig))
    np.testing.assert_array_equal(a.goto_signed, b.goto_signed)
    assert [p.symbols for p in a.patterns] == [p.symbols for p in b.patterns]
    seqs = [(0, np.arange(37, dtype=np.uint16)), (3, np.zeros(0, np.uint16)),
            (1, np.arange(5, dtype=np.uint16))]
    for x, y in zip(ushort.lanes_from_sequences(seqs, 16, 4),
                    ref_ushort.lanes_from_sequences(seqs, 16, 4)):
        np.testing.assert_array_equal(x, y)
