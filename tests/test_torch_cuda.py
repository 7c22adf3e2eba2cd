"""The CUDA kernels and the port's sessions on the card.

Marked ``cuda``: each test skips unless a CUDA device is present. Run on
the machine with the GPU (which has no jax; ``TPM_TEST_TPU=1`` keeps
tests/conftest.py from importing it):

    TPM_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda -q

The kernels' outputs are integers: they must equal the plain PyTorch
versions bit for bit (tolerance 0). This file imports no jax and nothing
of the JAX package.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_pattern_matching_torch.core.dfa import compile_patterns
from tpu_pattern_matching_torch.core.oracle_native import NativeOracle
from tpu_pattern_matching_torch.ops import bloom, kernels
from tpu_pattern_matching_torch.runtime.session import MatchSession

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_cfg(mode, q, sw, k, v, fold=False, seed=0):
    rng = np.random.RandomState(seed)
    sampled = mode == "sampled"
    return bloom.BloomConfig(
        q=q, stride=1 if sampled else sw, kbanks=k, v=v,
        mix1=tuple(int(x) | 1 for x in rng.randint(1, 2**31, size=q)),
        mix2=tuple(int(x) | 1 for x in rng.randint(1, 2**31, size=q)),
        fold_case=fold, gt=128 if sampled else bloom.GT,
        sampled=sampled, w=sw if sampled else 0,
    )


CONFIGS = [  # (mode, q, stride|w, k, v, fold)
    ("sampled", 4, 9, 6, 8, False),
    ("sampled", 4, 9, 12, 8, True),
    ("sampled", 5, 30, 6, 256, False),  # wide context, words in global memory
    ("sampled", 1, 1, 2, 1, False),
    ("strided", 4, 4, 6, 16, False),
    ("strided", 3, 7, 10, 2, True),
]


@pytest.mark.parametrize(
    "spec", CONFIGS, ids=["-".join(map(str, s)) for s in CONFIGS]
)
def test_kernel_equals_plain(cuda, spec):
    cfg = make_cfg(*spec, seed=1)
    rng = np.random.RandomState(2)
    C, T = 300, 1000
    data = rng.randint(0, 256, size=(C, T)).astype(np.uint8)
    start = rng.randint(0, 20, size=C).astype(np.int32)
    end = rng.randint(T - 50, T + 1, size=C).astype(np.int32)
    end[::17] = start[::17]  # empty lanes
    words = rng.randint(-(2**31), 2**31, size=(cfg.kbanks, cfg.v, 128))
    data_tm, Cp = bloom.prep_time_major(torch.from_numpy(data).to(cuda), cfg)
    bp = bloom.pad_bounds(torch.from_numpy(np.stack([start, end])).to(cuda),
                          Cp)
    w = torch.from_numpy(words.astype(np.int32)).to(cuda)
    before = kernels.launches[spec[0]]
    k_bits, k_total = kernels.launch_probe(data_tm, bp, w, cfg)
    torch.cuda.synchronize()
    assert kernels.launches[spec[0]] == before + 1
    p_bits, p_total = bloom.probe_bits_plain(data_tm, bp, w, cfg)
    assert torch.equal(k_bits, p_bits)
    assert int(k_total[0]) == int(p_total[0]) > 0


@pytest.mark.parametrize("spec", [("sampled", 4, 9, 6, 8, 4),
                                  ("strided", 4, 4, 6, 16, 3),
                                  ("sampled", 5, 30, 6, 256, 2)])
def test_or_into_bitmap_kernel_equals_sharded_plain(cuda, spec):
    # S launches of the probe kernel into one bitmap (the pattern-shard
    # sequence): the union and its popcount equal the plain version's
    cfg = make_cfg(*spec[:5], seed=6)
    S = spec[5]
    rng = np.random.RandomState(7)
    C, T = 300, 1000
    data = torch.from_numpy(
        rng.randint(0, 256, size=(C, T)).astype(np.uint8)).to(cuda)
    start = rng.randint(0, 20, size=C).astype(np.int32)
    end = rng.randint(T - 50, T + 1, size=C).astype(np.int32)
    end[::11] = start[::11]
    words = torch.from_numpy(
        (rng.randint(-(2**31), 2**31, size=(S, cfg.kbanks, cfg.v, 128))
         & rng.randint(-(2**31), 2**31, size=(S, cfg.kbanks, cfg.v, 128)))
        .astype(np.int32)).to(cuda)
    data_tm, Cp = bloom.prep_time_major(data, cfg)
    bp = bloom.pad_bounds(torch.from_numpy(np.stack([start, end])).to(cuda),
                          Cp)
    before = kernels.launches[spec[0]]
    k_bits, k_total = bloom.sharded_probe_bits(data_tm, bp, words, cfg)
    torch.cuda.synchronize()
    assert kernels.launches[spec[0]] == before + S
    p_bits, p_total = bloom.sharded_probe_bits_plain(data_tm, bp, words, cfg)
    assert torch.equal(k_bits, p_bits)
    assert int(k_total[0]) == int(p_total[0]) > 0
    # a count-less launch writes its bitmap and leaves its total 0
    one, _ = bloom.probe_bits_plain(data_tm, bp, words[0], cfg)
    b, t = kernels.launch_probe(data_tm, bp, words[0], cfg, count=False)
    torch.cuda.synchronize()
    assert torch.equal(b, one) and int(t[0]) == 0


def test_sharded_session_on_cuda_equals_oracle(cuda):
    from tpu_pattern_matching_torch.parallel.pshard import ShardedBloom

    rng = np.random.RandomState(8)
    pats = [bytes(rng.randint(0, 256, size=int(rng.randint(8, 20)))
                  .astype(np.uint8)) for _ in range(400)]
    data = bytearray(rng.randint(0, 256, size=1 << 20).astype(np.uint8))
    for i, pos in enumerate(rng.randint(0, (1 << 20) - 20, size=300)):
        p = pats[i % len(pats)]
        data[pos : pos + len(p)] = p
    data = bytes(data)
    off, pid, _ = NativeOracle(pats).match(data, cap=1 << 16)
    want = sorted(zip(off.tolist(), pid.tolist()))
    for verify in ("host", "device"):
        sess = MatchSession(compile_patterns(pats), max_chunks=256,
                            chunk_len=1024, device=cuda, pat_shards=3,
                            verify=verify)
        assert isinstance(sess.bloom_table, ShardedBloom)
        assert sess.find(data) == want


def test_rejected_arguments_raise(cuda):
    cfg = make_cfg("sampled", 4, 9, 6, 8)
    w = torch.zeros((6, 8, 128), dtype=torch.int32, device=cuda)
    b = torch.zeros((2, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="tile height"):
        kernels.launch_probe(
            torch.zeros((100, 128), dtype=torch.uint8, device=cuda), b, w, cfg)
    with pytest.raises(ValueError, match="is on cpu"):
        kernels.launch_probe(
            torch.zeros((128, 128), dtype=torch.uint8, device=cuda),
            b.cpu(), w, cfg)


def test_session_on_cuda_equals_oracle(cuda):
    rng = np.random.RandomState(3)
    pats = [bytes(rng.randint(0, 256, size=int(rng.randint(8, 20)))
                  .astype(np.uint8)) for _ in range(500)]
    data = bytearray(rng.randint(0, 256, size=1 << 20).astype(np.uint8))
    for i, pos in enumerate(rng.randint(0, (1 << 20) - 20, size=300)):
        p = pats[i % len(pats)]
        data[pos : pos + len(p)] = p
    data = bytes(data)
    sess = MatchSession(compile_patterns(pats), max_chunks=256,
                        chunk_len=1024, device=cuda)
    off, pid, total = NativeOracle(pats).match(data, cap=1 << 16)
    assert total == len(off) >= 290
    assert sess.find(data) == sorted(zip(off.tolist(), pid.tolist()))


@pytest.mark.parametrize("spec", [(4, 4, 6, 16, False), (3, 8, 10, 2, True),
                                  (8, 8, 3, 256, False)])
def test_packed_kernel_equals_plain_and_byte_kernel(cuda, spec):
    q, s, k, v, fold = spec
    cfg = make_cfg("strided", q, s, k, v, fold, seed=4)
    rng = np.random.RandomState(5)
    C, T = 300, 1000
    data = torch.from_numpy(
        rng.randint(0, 256, size=(C, T)).astype(np.uint8)).to(cuda)
    start = rng.randint(0, 20, size=C).astype(np.int32)
    end = rng.randint(T - 50, T + 1, size=C).astype(np.int32)
    end[::13] = start[::13]
    bounds = torch.from_numpy(np.stack([start, end])).to(cuda)
    w = torch.from_numpy(rng.randint(-(2**31), 2**31, size=(k, v, 128))
                         .astype(np.int32)).to(cuda)
    before = kernels.launches["strided_packed"]
    p_total, p_bits = bloom.hits(data, bounds, w, cfg, packed=True)
    torch.cuda.synchronize()
    assert kernels.launches["strided_packed"] == before + 1
    b_total, b_bits = bloom.hits(data, bounds, w, cfg, packed=False)
    assert torch.equal(p_bits, b_bits) and int(p_total[0]) == int(b_total[0])
    data_pk, Cp = bloom.prep_time_major(data, cfg, packed=True)
    pl_bits, pl_total = bloom.probe_bits_plain(
        data_pk, bloom.pad_bounds(bounds, Cp), w, cfg)
    assert torch.equal(p_bits, pl_bits) and int(pl_total[0]) > 0


def walk_case(cuda, table_dtype, n_pats):
    from tpu_pattern_matching_torch.ops.table import DeviceTable

    rng = np.random.RandomState(n_pats)
    pats = sorted({bytes(rng.choice(np.frombuffer(b"abc", np.uint8),
                                    size=int(rng.randint(3, 9)))
                         .astype(np.uint8)) for _ in range(n_pats)})
    table = compile_patterns(pats)
    table.goto_signed = table.goto_signed.astype(table_dtype)
    C, T, halo = 700, 600, 8
    data = rng.choice(np.frombuffer(b"abcd", np.uint8),
                      size=(C, T)).astype(np.uint8)
    start = np.where(rng.rand(C) < 0.5, 0, halo).astype(np.int32)
    end = rng.randint(T - 40, T + 1, size=C).astype(np.int32)
    end[::11] = start[::11]
    return (DeviceTable.put(table, cuda), torch.from_numpy(data).to(cuda),
            torch.from_numpy(np.stack([start, end])).to(cuda), halo)


EMIT_CASES = {  # name: (candidate draws, slots, k_ev)
    "fits": (3000, 3200, 1 << 16),
    "event-overflow": (3000, 3200, 64),
    "100-blocks": (12000, 12800, 1 << 16),  # the look-back crosses blocks
}


def check_walk_and_emit(cuda, dt, data, bounds, halo, alphabet_size, seed,
                        case):
    """Stages 3-5's kernel against their plain version on random sorted
    candidates of the batch (sentinels after them), bit for bit."""
    from tpu_pattern_matching_torch.ops import verify_device

    draws, slots, k_ev = EMIT_CASES[case]
    C, T = data.shape
    rng = np.random.RandomState(seed)
    keys = np.unique(rng.randint(0, C, size=draws) * T
                     + rng.randint(0, T - 2, size=draws))
    lane = np.full(slots, C, np.int32)
    row = np.full(slots, 0x7FFFFFFF, np.int32)
    lane[: len(keys)] = keys // T
    row[: len(keys)] = keys % T
    n = torch.tensor([len(keys)], dtype=torch.int64, device=cuda)
    args = (dt.table_flat, dt.state_gid, data.reshape(-1), bounds,
            torch.from_numpy(lane).to(cuda), torch.from_numpy(row).to(cuda),
            n, n + 5, torch.tensor([1], dtype=torch.int32, device=cuda))
    kw = dict(C=C, T=T, alphabet_size=alphabet_size, q=2,
              lmax=dt.max_pat_len, halo=halo, k_ev=k_ev,
              num_groups=dt.num_groups,
              steps=verify_device.walk_steps(dt.max_pat_len, 2))
    key = "window_walk_u16" if data.dtype == torch.uint16 else "window_walk"
    before = kernels.launches[key]
    got = kernels.launch_walk_and_emit(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launches[key] == before + 1
    want = verify_device.walk_and_emit_plain(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    meta = want[0].cpu().numpy()
    assert meta[0] > 100 and bool(meta[3] & 2) == (case == "event-overflow")
    assert meta[3] & 1 and meta[2] == len(keys) + 5


@pytest.mark.parametrize("case", list(EMIT_CASES))
@pytest.mark.parametrize("table_dtype", [np.int16, np.int32])
def test_window_walk_kernel_equals_plain(cuda, table_dtype, case):
    dt, data, bounds, halo = walk_case(cuda, table_dtype, 40)
    check_walk_and_emit(cuda, dt, data, bounds, halo, 256, 8, case)


@pytest.mark.parametrize("table_dtype", [np.int16, np.int32])
def test_dense_walk_kernel_equals_plain(cuda, table_dtype):
    from tpu_pattern_matching_torch.ops import match_xla

    dt, data, bounds, halo = walk_case(cuda, table_dtype, 30)
    data_tm = data.t().contiguous()
    kw = dict(alphabet_size=256, halo=halo, max_results=8,
              max_pat_len=dt.max_pat_len, state_gid=dt.state_gid,
              num_groups=dt.num_groups)
    before = kernels.launches["dense_walk"]
    got = kernels.launch_dense_walk(dt.table_flat, data_tm, bounds, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["dense_walk"] == before + 1
    want = match_xla.dense_walk_plain(dt.table_flat, data_tm, bounds, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[0].max()) > 8  # lanes past their R slots


def test_device_verify_and_dense_sessions_equal_oracle(cuda):
    rng = np.random.RandomState(6)
    pats = [bytes(rng.randint(0, 256, size=int(rng.randint(8, 20)))
                  .astype(np.uint8)) for _ in range(300)]
    data = bytearray(rng.randint(0, 256, size=1 << 19).astype(np.uint8))
    for i, pos in enumerate(rng.randint(0, (1 << 19) - 20, size=200)):
        p = pats[i % len(pats)]
        data[pos : pos + len(p)] = p
    data = bytes(data)
    table = compile_patterns(pats)
    off, pid, total = NativeOracle(pats).match(data, cap=1 << 16)
    want = sorted(zip(off.tolist(), pid.tolist()))
    for kw in (dict(verify="device"), dict(engine="dense")):
        sess = MatchSession(table, max_chunks=256, chunk_len=1024,
                            device=cuda, **kw)
        assert sess.find(data) == want
    assert sess.dev.table_flat.is_cuda


def test_device_verify_lane_passes_on_cuda(cuda, monkeypatch):
    # a one-pass cap below every batch's candidates: each batch is
    # verified in passes over lane ranges, on the card, with exact events
    from tpu_pattern_matching_torch.ops import verify_device

    rng = np.random.RandomState(9)
    pats = [bytes(rng.randint(0, 256, size=10).astype(np.uint8))
            for _ in range(50)]
    data = bytearray(rng.randint(0, 256, size=1 << 18).astype(np.uint8))
    for i, pos in enumerate(rng.randint(0, (1 << 18) - 10, size=400)):
        data[pos : pos + 10] = pats[i % len(pats)]
    data = bytes(data)
    off, pid, _total = NativeOracle(pats).match(data, cap=1 << 16)
    sess = MatchSession(compile_patterns(pats), max_chunks=128,
                        chunk_len=1024, device=cuda, verify="device")
    passes = []
    orig = sess._dvf._verify_pass

    def spy(data, bounds, bits, total):
        passes.append(total)
        return orig(data, bounds, bits, total)

    sess._dvf._verify_pass = spy
    monkeypatch.setattr(verify_device, "MAX_DEVICE_CAND", 64)
    before = kernels.launches["window_walk"]
    assert sess.find(data) == sorted(zip(off.tolist(), pid.tolist()))
    assert len(passes) > 2 * 2 and max(passes) <= 64  # 2 batches, split
    assert kernels.launches["window_walk"] >= before + len(passes)


# ------------------------------------------------- uint16 (ushort) symbols


U16_CONFIGS = [  # (mode, q, stride|w, k, v)
    ("sampled", 3, 4, 8, 32),
    ("sampled", 3, 20, 10, 8),
    ("strided", 3, 4, 6, 8),
    ("strided", 2, 2, 2, 1),
]


def u16_case(cuda, seed, C=300, T=1000):
    rng = np.random.RandomState(seed)
    data = rng.randint(0, 2048, size=(C, T)).astype(np.uint16)
    start = rng.randint(0, 20, size=C).astype(np.int32)
    end = rng.randint(T - 50, T + 1, size=C).astype(np.int32)
    end[::17] = start[::17]  # empty lanes
    return (torch.from_numpy(data).to(cuda),
            torch.from_numpy(np.stack([start, end])).to(cuda))


@pytest.mark.parametrize(
    "spec", U16_CONFIGS, ids=["-".join(map(str, s)) for s in U16_CONFIGS])
def test_u16_probe_kernel_equals_plain(cuda, spec):
    cfg = make_cfg(*spec, seed=11)
    data, bounds = u16_case(cuda, 12)
    rng = np.random.RandomState(13)
    w = torch.from_numpy(rng.randint(-(2**31), 2**31, size=(
        cfg.kbanks, cfg.v, 128)).astype(np.int32)).to(cuda)
    data_tm, Cp = bloom.prep_time_major(data, cfg)
    bp = bloom.pad_bounds(bounds, Cp)
    key = spec[0] + "_u16"
    before = kernels.launches[key]
    k_bits, k_total = kernels.launch_probe(data_tm, bp, w, cfg)
    torch.cuda.synchronize()
    assert kernels.launches[key] == before + 1
    p_bits, p_total = bloom.probe_bits_plain(data_tm, bp, w, cfg)
    assert torch.equal(k_bits, p_bits)
    assert int(k_total[0]) == int(p_total[0]) > 0


TILE_EDGES = [  # (symbols, mode, q, stride|w, k, v, lanes, rows, gt)
    ("u16", "sampled", 3, 4, 8, 32, 4096, 2064, 128),  # 128 KB opt-in
    ("u8", "sampled", 4, 9, 6, 8, 100, 60, 64),  # one tile, Cp = 128
    ("u16", "sampled", 3, 4, 8, 32, 100, 60, 64),
    ("u8", "strided", 4, 4, 6, 16, 100, 120, 32),  # one tile, Cp = 128
    ("u16", "strided", 3, 4, 6, 8, 128, 120, 32),
    ("u8", "sampled", 8, 20, 3, 256, 300, 1000, 128),  # v = 256: L2 words
    ("u16", "strided", 1, 2, 2, 256, 300, 1000, 64),
    ("u8", "sampled", 1, 1, 2, 4, 300, 1000, 128),  # q = 1, w = 1
]


@pytest.mark.parametrize(
    "spec", TILE_EDGES, ids=["-".join(map(str, s)) for s in TILE_EDGES])
def test_probe_kernel_tile_edges_equal_plain(cuda, spec):
    # the tiled kernels at the edges of their tiling: the shared-memory
    # opt-in, a grid of one tile, words read through L2, q and w of 1
    width, mode, q, sw, k, v, C, T, gt = spec
    cfg = dataclasses.replace(make_cfg(mode, q, sw, k, v, seed=31), gt=gt)
    rng = np.random.RandomState(32)
    n_sym, dtype = (2048, np.uint16) if width == "u16" else (256, np.uint8)
    data = rng.randint(0, n_sym, size=(C, T)).astype(dtype)
    start = rng.randint(0, 20, size=C).astype(np.int32)
    end = rng.randint(T // 2, T + 1, size=C).astype(np.int32)  # mid-tile
    end[::13] = start[::13]
    w = torch.from_numpy(rng.randint(-(2**31), 2**31, size=(
        k, v, 128)).astype(np.int32)).to(cuda)
    data_tm, Cp = bloom.prep_time_major(torch.from_numpy(data).to(cuda), cfg)
    bp = bloom.pad_bounds(torch.from_numpy(np.stack([start, end])).to(cuda),
                          Cp)
    plan = kernels.probe_plan(data_tm, cfg)
    assert plan["words_in_smem"] == (v < 256)
    if T < 128:  # one tile of rows
        assert plan["tiles"] * plan["lanes"] == 128
    k_bits, k_total = kernels.launch_probe(data_tm, bp, w, cfg)
    torch.cuda.synchronize()
    p_bits, p_total = bloom.probe_bits_plain(data_tm, bp, w, cfg)
    assert torch.equal(k_bits, p_bits)
    assert int(k_total[0]) == int(p_total[0]) > 0


def u16_walk_case(cuda, table_dtype):
    from tpu_pattern_matching_torch.core.dfa import AhoCorasick
    from tpu_pattern_matching_torch.ops.table import DeviceTable

    rng = np.random.RandomState(21)
    sigs = [tuple(int(x) for x in rng.randint(0, 4, size=rng.randint(3, 8)))
            for _ in range(40)]
    ac = AhoCorasick(2048)
    for s in sigs:
        ac.add_pattern(s)
    table = ac.compile()
    table.goto_signed = table.goto_signed.astype(table_dtype)
    C, T, halo = 700, 600, 8
    data = rng.randint(0, 5, size=(C, T)).astype(np.uint16)
    data[:, ::7] = rng.randint(0, 2048, size=data[:, ::7].shape)
    start = np.where(rng.rand(C) < 0.5, 0, halo).astype(np.int32)
    end = rng.randint(T - 40, T + 1, size=C).astype(np.int32)
    end[::11] = start[::11]
    return (DeviceTable.put(table, cuda), torch.from_numpy(data).to(cuda),
            torch.from_numpy(np.stack([start, end])).to(cuda), halo)


@pytest.mark.parametrize("table_dtype", [np.int16, np.int32])
def test_u16_dense_walk_kernel_equals_plain(cuda, table_dtype):
    from tpu_pattern_matching_torch.ops import match_xla

    dt, data, bounds, halo = u16_walk_case(cuda, table_dtype)
    data_tm = data.t().contiguous()
    kw = dict(alphabet_size=2048, halo=halo, max_results=8,
              max_pat_len=dt.max_pat_len, state_gid=dt.state_gid,
              num_groups=dt.num_groups)
    before = kernels.launches["dense_walk_u16"]
    got = kernels.launch_dense_walk(dt.table_flat, data_tm, bounds, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["dense_walk_u16"] == before + 1
    want = match_xla.dense_walk_plain(dt.table_flat, data_tm, bounds, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[0].max()) > 8


@pytest.mark.parametrize("case", list(EMIT_CASES))
@pytest.mark.parametrize("table_dtype", [np.int16, np.int32])
def test_u16_window_walk_kernel_equals_plain(cuda, table_dtype, case):
    dt, data, bounds, halo = u16_walk_case(cuda, table_dtype)
    check_walk_and_emit(cuda, dt, data, bounds, halo, 2048, 22, case)


def test_ushort_sessions_on_cuda_equal_oracle(cuda):
    from tpu_pattern_matching_torch.core.dfa import AhoCorasick

    rng = np.random.RandomState(23)
    sigs = [tuple(int(x) for x in rng.randint(40, 1515, size=rng.randint(
        6, 17))) for _ in range(200)]
    ac = AhoCorasick(2048)
    for s in sigs:
        ac.add_pattern(s)
    table = ac.compile()
    toks = rng.randint(0, 2048, size=200_000).astype(np.uint16)
    for i, pos in enumerate(rng.randint(0, len(toks) - 16, size=150)):
        toks[pos : pos + len(sigs[i % 200])] = sigs[i % 200]
    off, pid, _ = NativeOracle(sigs, alphabet=2048).match(toks)
    want = sorted(zip(off.tolist(), pid.tolist()))
    text = ",".join(map(str, toks.tolist())).encode()
    for kw, key in ((dict(engine="bloom"), "strided_u16"),
                    (dict(engine="bloom", verify="device"), "window_walk_u16"),
                    (dict(engine="bloom", bloom_opts={"force": (
                        "sampled", 3, 4, 8, 32)}), "sampled_u16"),
                    (dict(), "dense_walk_u16")):
        before = kernels.launches[key]
        sess = MatchSession(table, max_chunks=256, chunk_len=512,
                            device=cuda, **kw)
        assert sess.find(text) == want and len(want) >= 140
        assert kernels.launches[key] > before, kw


def test_proto_probe_kernel_equals_plain(cuda):
    # the prototype probe: the one-tile form at its own shape (a small
    # launch: items of 4 lanes) and a 16-tile grid at the grid's lane width
    # (items of 16 lanes, 16-byte rows), then 68 lanes (4-byte rows)
    from tpu_pattern_matching_torch.benchmarks import exp_bloom as eb

    bloom_np, mix1, mix2, rng = eb.make_tables(0)
    bloom = torch.from_numpy(bloom_np).to(cuda)
    tile = rng.randint(0, 256, size=(eb.G * eb.S + eb.Q, eb.C))
    grid = rng.randint(0, 256, size=(16 * (eb.TT + eb.PADR), eb.CT))
    for key, run, data, geom in (
            ("proto_tile", eb.run_probe, tile, dict(eb.TILE, tiles=1)),
            ("proto_grid", eb.run_grid, grid, dict(eb.GRID, tiles=16))):
        data = torch.from_numpy(data.astype(np.uint8)).to(cuda)
        before = kernels.launches[key]
        got = run(data, bloom, mix1, mix2)
        torch.cuda.synchronize()
        assert kernels.launches[key] == before + 1
        want = eb.probe_plain(data, bloom, mix1, mix2, **geom)
        want = want[0] if key == "proto_tile" else want
        assert torch.equal(got, want) and int(want.sum()) > 0
    geom = dict(rows=10, stride=3, q=5, pitch=35, tiles=2)
    data = torch.from_numpy(rng.randint(0, 256, size=(70, 68)).astype(
        np.uint8)).to(cuda)
    got = kernels.launch_proto_probe(data, bloom, mix1[:5], mix2[:5],
                                     kind="grid", **geom)
    want = eb.probe_plain(data, bloom, mix1[:5], mix2[:5], **geom)
    assert torch.equal(got, want) and int(want.sum()) > 0


def test_nccl_world_1_sessions_equal_flat(cuda):
    # mesh="all" with no process group on a CUDA device: a 1-rank NCCL
    # group; every mesh path equals the flat session and the oracle
    import torch.distributed as dist

    from tpu_pattern_matching_torch.parallel.mesh import owned_world

    rng = np.random.RandomState(8)
    pats = [bytes(rng.randint(0, 256, size=int(rng.randint(8, 16)))
                  .astype(np.uint8)) for _ in range(100)]
    data = bytearray(rng.randint(0, 256, size=1 << 18).astype(np.uint8))
    for i, pos in enumerate(rng.randint(0, (1 << 18) - 16, size=150)):
        p = pats[i % len(pats)]
        data[pos : pos + len(p)] = p
    data = bytes(data)
    table = compile_patterns(pats)
    off, pid, _total = NativeOracle(pats).match(data, cap=1 << 16)
    want = sorted(zip(off.tolist(), pid.tolist()))
    with owned_world():
        for kw in (dict(), dict(verify="device"), dict(engine="dense")):
            mesh = MatchSession(table, max_chunks=256, chunk_len=1024,
                                device="cuda", mesh="all", **kw)
            assert mesh._mesh_ctx.backend == "nccl"
            assert mesh._mesh_ctx.device == torch.device("cuda", 0)
            flat = MatchSession(table, max_chunks=256, chunk_len=1024,
                                device=cuda, **kw)
            assert mesh.find(data) == flat.find(data) == want
    assert not dist.is_initialized()


def test_two_nccl_ranks_on_one_device_exit_2(cuda, tmp_path):
    # NCCL runs one rank per device: two ranks on device 0 exit 2 with a
    # message before any group exists; they never switch to gloo
    import os
    import subprocess
    import sys

    (tmp_path / "p.txt").write_text("abc\n")
    (tmp_path / "in.txt").write_text("xxabcxx\n")
    url = f"file://{tmp_path / 'rendezvous'}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpu_pattern_matching_torch.cli", "-f",
         str(tmp_path / "in.txt"), "-p", str(tmp_path / "p.txt"), "-D", "0",
         "--num-processes", "2", "--process-id", str(r), "--coordinator",
         url], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=repo)) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 2, err
        assert "one rank per CUDA device" in err and "Pattern" not in out


def test_small_calibration_on_cuda(cuda, tmp_path, monkeypatch):
    # the calibrator on the card at a small size: its probes launch the
    # kernels, its file loads, and its constants are positive
    import math

    from tpu_pattern_matching_torch.ops import costmodel

    path = str(tmp_path / "cc.json")
    runs = []
    run_calibration = costmodel.run_calibration

    def recorded(*args, **kwargs):
        runs.append(run_calibration(*args, **kwargs))
        return runs[-1]

    monkeypatch.setattr(costmodel, "run_calibration", recorded)
    before = dict(kernels.launches)
    cc = costmodel.calibrate(path=path, n_patterns=300, verbose=False,
                             device=cuda, lanes=256, chunk=1024,
                             u_signatures=200, u_lanes=256, u_chunk=1024,
                             calls=3)
    assert cc.source == f"calibrated:cuda:{torch.cuda.get_device_name(0)}"
    assert costmodel.CostConstants.load(path) == cc
    for f, v in dataclasses.asdict(cc).items():
        if f != "source":
            assert v > 0 and math.isfinite(v), f
    moved = {k for k, n in kernels.launches.items() if n > before[k]}
    byte, ushort = runs[0].points
    assert ("sampled" if byte.bft.cfg.sampled else "strided") in moved
    assert ("sampled_u16" if ushort.bft.cfg.sampled
            else "strided_u16") in moved


def test_small_bench_on_cuda_checks_its_events(cuda):
    """The port's bench at a small point on the card: the reference's keys,
    positive finite rates, and each pick's d1e3 events (host and device
    verify) equal to the native oracle's."""
    from tpu_pattern_matching_torch import bench

    record = {}
    line = bench.run(cuda, 300, 128, 512, record)
    assert list(line) == list(bench.KEYS)
    assert line["value"] == line["refined_pipelined_bytes_per_s_d1e3"]
    assert all(np.isfinite(v) and v > 0 for k, v in line.items()
               if isinstance(v, float) and "per_byte" not in k)
    counts = bench.check_events(record)
    assert counts["joint"] > 0 and counts["refined"] > 0
