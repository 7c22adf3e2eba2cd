"""Device verify of the PyTorch port against the JAX reference, on the CPU.

- The window walk's plain PyTorch version (the CPU path, and what the CUDA
  kernel is held to on the card) and the kernel's own per-thread code
  (csrc/dfa_walk.cuh, built with g++) agree.
- ``verify_candidates`` equals the reference's ``_verify_jit`` on the same
  bitmap — meta, events and group counts — with and without exact-gram
  refinement, at int16 and int32 tables, through the capacity overflows.
- ``MatchSession(verify="device")`` equals the oracle and the reference
  session (the cases of tests/test_verify_device.py).

Every output is an integer, so the tolerance is zero."""

import io

import numpy as np
import pytest
import torch

from tpu_pattern_matching.core.dfa import AhoCorasick, compile_patterns
from tpu_pattern_matching.core.oracle import match_python
from tpu_pattern_matching.ops import exact_gram as ref_exact
from tpu_pattern_matching.ops import verify_device as ref_vd
from tpu_pattern_matching.runtime.buffers import StreamState
from tpu_pattern_matching.runtime.session import MatchSession as RefSession
from tpu_pattern_matching_torch.ops import bloom as port_bloom
from tpu_pattern_matching_torch.ops import exact_gram as port_exact
from tpu_pattern_matching_torch.ops import kernels
from tpu_pattern_matching_torch.ops import verify_device as port_vd
from tpu_pattern_matching_torch.runtime.session import MatchSession

CPU = torch.device("cpu")


def oracle(pats, data):
    return sorted(match_python(pats, data))


def verify_case(seed, table_dtype, C=24, T=160, halo=8, force=None):
    """Patterns over a 2-letter alphabet (dense matches, co-terminating
    groups), a ragged batch, a filter built for them, and its probe bitmap
    with random extra bits (bloom false positives for the refinement)."""
    rng = np.random.RandomState(seed)
    pats = sorted({bytes(rng.choice(np.frombuffer(b"ab", np.uint8),
                                    size=rng.randint(3, 8)).astype(np.uint8))
                   for _ in range(12)})
    table = compile_patterns(pats)
    table.goto_signed = table.goto_signed.astype(table_dtype)
    data = rng.choice(np.frombuffer(b"abcd", np.uint8),
                      size=(C, T)).astype(np.uint8)
    start = np.where(rng.rand(C) < 0.5, 0, halo).astype(np.int32)
    end = rng.randint(T - 30, T + 1, size=C).astype(np.int32)
    end[2] = start[2]  # empty lane
    end[5] = min(T, int(start[5]) + 6)  # short lane
    bounds = np.stack([start, end])
    bft = port_bloom.BloomFilterTable.build(pats, force=force)
    total, bits = port_bloom.hits(torch.from_numpy(data),
                                  torch.from_numpy(bounds),
                                  torch.from_numpy(bft.words), bft.cfg)
    bits = bits.numpy().copy()
    extra = rng.randint(-(2**31), 2**31, size=bits.shape).astype(np.int32)
    extra[rng.rand(*bits.shape) < 0.9] = 0
    bits |= extra
    # only rows inside a lane can hold a candidate (the probe's mask)
    bits[:, C:] = 0
    return table, bft, data, bounds, bits, halo


def walk_inputs(seed, table_dtype):
    table, bft, data, bounds, bits, halo = verify_case(seed, table_dtype)
    k = 1024
    n, lane, row, _ = port_vd.bitmap_to_candidates(
        torch.from_numpy(bits), bft.cfg.stride, k)
    return dict(
        table_flat=torch.from_numpy(table.goto_signed.reshape(-1)),
        data_flat=torch.from_numpy(data.reshape(-1)),
        bounds=torch.from_numpy(bounds), lane=lane, row=row,
        n_valid=n.reshape(1),
    ), dict(C=data.shape[0], T=data.shape[1], alphabet_size=256,
            q=bft.cfg.q, lmax=table.max_pat_len, halo=halo)


@pytest.mark.parametrize("table_dtype", [np.int16, np.int32])
def test_window_walk_kernel_body_on_host_equals_plain(table_dtype):
    t, kw = walk_inputs(1, table_dtype)
    steps = port_vd.walk_steps(kw["lmax"], kw["q"])
    h_rep, h_st = kernels.window_walk_on_host(**t, **kw, steps=steps)
    p_rep, p_st = port_vd.window_walk_plain(**t, **kw, steps=steps)
    assert torch.equal(h_rep, p_rep) and torch.equal(h_st, p_st)
    assert int(p_rep.sum()) > 10  # reports were compared
    assert int(t["n_valid"][0]) < t["lane"].shape[0]  # and sentinel slots
    assert not p_rep[int(t["n_valid"][0]):].any()
    # the dispatcher takes the plain version for CPU tensors
    d_rep, d_st = port_vd.window_walk(**t, **kw)
    assert torch.equal(d_rep, p_rep) and torch.equal(d_st, p_st)


VERIFY_CASES = {  # name: (seed, table dtype, exact, k_ev, k_walk, force)
    "int16-unrefined": (2, np.int16, False, 1024, None, None),
    "int32-unrefined": (3, np.int32, False, 1024, None, None),
    "int16-refined": (4, np.int16, True, 1024, 768, None),
    "int32-refined": (5, np.int32, True, 768, 1024, None),
    "strided-refined": (8, np.int32, True, 1024, 1024,
                        ("strided", 1, 3, 2, 1)),
    "event-overflow": (6, np.int16, False, 16, None, None),
    "refine-overflow": (7, np.int32, True, 1024, 8, None),
}


@pytest.mark.parametrize("name", list(VERIFY_CASES))
def test_verify_candidates_equals_reference(name):
    seed, dtype, exact, k_ev, k_walk, force = VERIFY_CASES[name]
    table, bft, data, bounds, bits, halo = verify_case(seed, dtype,
                                                       force=force)
    cfg = bft.cfg
    statics = dict(alphabet_size=256, stride=cfg.stride, q=cfg.q,
                   lmax=table.max_pat_len, halo=halo, k_cand=1024,
                   k_ev=k_ev, num_groups=table.num_groups, k_walk=k_walk)
    lo = hi = meta_x = dx = None
    if exact:
        xt = ref_exact.table_from_keys(bft.gram_keys, cfg.q)
        lo = xt.lo.view(np.int32)
        meta_x = xt.device_meta(cfg.fold_case)
        dx = port_exact.DeviceExact.put(
            port_exact.table_from_keys(bft.gram_keys, cfg.q), cfg.fold_case,
            CPU)
    flat = np.ascontiguousarray(table.goto_signed).reshape(-1)
    gid = table.state_gid.astype(np.int32)
    r_meta, r_packed, r_gc = (np.asarray(x) for x in ref_vd._verify_jit(
        flat, gid, data, bounds, bits, lo, hi, exact_meta=meta_x, **statics))
    p_meta, p_packed, p_gc = port_vd.verify_candidates(
        torch.from_numpy(flat), torch.from_numpy(gid),
        torch.from_numpy(data), torch.from_numpy(bounds),
        torch.from_numpy(bits), dx, **statics)
    np.testing.assert_array_equal(p_meta.numpy(), r_meta)
    np.testing.assert_array_equal(p_packed.numpy(), r_packed)
    np.testing.assert_array_equal(p_gc.numpy(), r_gc)
    assert r_meta[0] > 0 and r_meta[2] > 0
    assert (cfg.stride > 1) == (force is not None)
    flags = int(r_meta[3])
    assert bool(flags & 2) == (name == "event-overflow")
    assert bool(flags & 4) == (name == "refine-overflow")
    if exact:
        assert r_meta[4] < r_meta[2]  # the refinement erased candidates


# ------------------------------------------------- the verify="device" session


def both(pats, table=None, **kw):
    table = table if table is not None else compile_patterns(pats)
    return (RefSession(table, engine="bloom", verify="device", **kw),
            MatchSession(table, device="cpu", verify="device", **kw))


def test_device_verify_basic_equals_reference_and_oracle():
    pats = [b"he", b"she", b"his", b"hers", b"deadbeef"]
    data = (b"ushers and his deadbeefdeadbeef " * 30) + b"she"
    ref, port = both(pats, max_chunks=8, chunk_len=64)
    assert port.verify_mode == "device" and port._bloom.exact is None
    got = port.find(data)
    assert got == oracle(pats, data) == ref.find(data)
    assert port._verifier is None  # no host walker to fall back to


def test_device_verify_sampled_mode():
    rng = np.random.RandomState(5)
    pats = [bytes(rng.randint(0, 256, size=10).astype(np.uint8))
            for _ in range(12)]
    data = bytearray(rng.randint(0, 256, size=6000).astype(np.uint8))
    for pos in (5, 500, 2111, 5985):
        data[pos : pos + 10] = pats[pos % 12]
    data = bytes(data)
    ref, port = both(pats, max_chunks=8, chunk_len=128,
                     bloom_opts={"mode": "sampled"})
    assert port.bloom_table.cfg.sampled
    got = port.find(data)
    assert got == oracle(pats, data) == ref.find(data) and len(got) == 4


def batch_counts(sess, data):
    buf = sess.new_buffer()
    fobj = io.BytesIO(data)
    stream = StreamState(file_id=0)
    total, gc = 0, None
    while True:
        code, rd = buf.add_stream(fobj, stream)
        if buf.chunks and (code == -1 or rd == 0):
            batch = buf.to_batch()
            t, g = sess.decode_counts(batch, sess.scan(batch))
            total += t
            gc = g if gc is None else gc + g
            buf.reset()
        if rd == 0:
            return total, gc


def test_device_verify_match_dense_counts_and_event_retry():
    # events outnumber candidates: the event-capacity retry runs, and
    # events and per-group counts stay exact through it
    pats = [b"aa", b"aaa"]
    data = b"a" * 3000
    ref, port = both(pats, max_chunks=4, chunk_len=1024)
    seen = []
    orig = port._dvf._dispatch

    def spy(*a):
        out = orig(*a)
        seen.append(int(out[0][3]))
        return out

    port._dvf._dispatch = spy
    want = oracle(pats, data)
    assert port.find(data) == want == ref.find(data)
    assert any(f & 2 for f in seen)  # the event retry happened
    ends = {}
    for off, pid in want:
        ends.setdefault(off, set()).add(pid)
    total, gc = batch_counts(port, data)
    assert total == gc.sum() == len(ends)
    r_total, r_gc = batch_counts(ref, data)
    assert total == r_total and gc.tolist() == r_gc.tolist()


def test_device_verify_past_the_cap_runs_in_lane_passes(monkeypatch):
    # a cap below the batch's candidates: the session verifies each batch
    # in several passes over lane ranges, all on the device
    monkeypatch.setattr(port_vd, "MAX_DEVICE_CAND", 40)
    pats = [b"he", b"she"]
    data = b"ushers she he " * 40
    ref, port = both(pats, max_chunks=8, chunk_len=64)
    totals = []
    orig = port._dvf._verify_pass

    def spy(data, bounds, bits, total):
        totals.append(total)
        return orig(data, bounds, bits, total)

    port._dvf._verify_pass = spy
    want = oracle(pats, data)
    assert port.find(data) == want == ref.find(data)
    assert len(totals) > 1 and max(totals) <= 40
    total, gc = batch_counts(port, data)  # the count path splits too
    r_total, r_gc = batch_counts(ref, data)
    assert total == gc.sum() == len({e for e, _ in want}) == r_total
    assert gc.tolist() == r_gc.tolist()


@pytest.mark.parametrize("name", ["int16-refined", "int32-unrefined"])
@pytest.mark.parametrize("cap_of", ["widest lane", "half the batch"])
def test_lane_passes_equal_one_pass(monkeypatch, name, cap_of):
    seed, dtype, exact, _k_ev, _k_walk, force = VERIFY_CASES[name]
    table, bft, data, bounds, bits, halo = verify_case(seed, dtype,
                                                       force=force)
    dvf = port_vd.DeviceVerifier(table, bft.cfg, halo, CPU,
                                 gram_keys=bft.gram_keys if exact else None)
    # a row whose gram runs past the lane's end (the probe never marks
    # one) reads the next lane's bytes in the refinement: keep the rows
    # the probe could mark, so that lane ranges see what the batch sees
    W, Cb = bits.shape
    fits = (np.arange(W * 32).reshape(W, 32) * bft.cfg.stride + bft.cfg.q
            <= data.shape[1])
    mask = (fits.astype(np.int64) << np.arange(32)).sum(1)
    bits = bits & mask.astype(np.uint32).view(np.int32)[:, None]
    args = (torch.from_numpy(data), torch.from_numpy(bounds),
            torch.from_numpy(bits))
    per_lane = np.unpackbits(bits.view(np.uint8).reshape(W, Cb, 4),
                             axis=2).sum((0, 2))
    total = int(per_lane.sum())
    one = dvf.verify(*args, total)
    cap = int(per_lane.max()) if cap_of == "widest lane" else total // 2
    passes = port_vd.lane_passes(args[2], cap)
    assert len(passes) > 1 and sum(n for *_, n in passes) == total
    assert all(n <= cap for *_, n in passes)
    monkeypatch.setattr(port_vd, "MAX_DEVICE_CAND", cap)
    split = dvf.verify(*args, total)
    for a, b in zip(split, one):
        np.testing.assert_array_equal(a, b)
    assert one[0][0] > 0  # events were compared


def test_device_verify_nocase_equals_reference():
    ac = AhoCorasick(nocase=True)
    ac.add_pattern(b"NeEdLe")
    table = ac.compile()
    ref, port = both([b"needle"], table=table, max_chunks=4, chunk_len=64)
    data = b"xx needle yy NEEDLE zz nEEdLe"
    got = port.find(data)
    assert [e for e, _ in got] == [8, 18, 28]
    assert got == ref.find(data)


def test_device_verify_halo_continuity_and_small_alphabet_fuzz():
    pats = [b"abcdefgh"]
    data = (b"zz" + b"abcdefgh") * 25
    port = MatchSession(compile_patterns(pats), max_chunks=2, chunk_len=8,
                        device="cpu", verify="device")
    assert port.find(data) == oracle(pats, data)
    rng = np.random.RandomState(21)
    ab = np.frombuffer(b"ab", np.uint8)
    pats = sorted({bytes(rng.choice(ab, size=rng.randint(2, 7))
                         .astype(np.uint8)) for _ in range(10)})
    data = bytes(rng.choice(ab, size=4096).astype(np.uint8))
    port = MatchSession(compile_patterns(pats), max_chunks=8, chunk_len=64,
                        device="cpu", verify="device")
    assert port.find(data) == oracle(pats, data)


def test_refinement_erases_candidates_and_equals_unrefined():
    rng = np.random.RandomState(11)
    pats = [bytes(rng.randint(0, 256, size=9).astype(np.uint8))
            for _ in range(300)]
    data = bytearray(rng.randint(0, 256, size=50_000).astype(np.uint8))
    for pos in (77, 5000, 31337):
        data[pos : pos + 9] = pats[pos % 300]
    data = bytes(data)
    kw = dict(max_chunks=16, chunk_len=1024, device="cpu", verify="device",
              bloom_opts={"force": ("strided", 3, 3, 2, 1)})
    sess = MatchSession(compile_patterns(pats), **kw)
    assert sess._dvf.exact is not None
    metas = []
    orig = sess._dvf.verify

    def spy(*a):
        out = orig(*a)
        metas.append(out[0])
        return out

    sess._dvf.verify = spy
    want = oracle(pats, data)
    assert sess.find(data) == want and len(want) == 3
    n_bloom = sum(int(m[2]) for m in metas)
    n_exact = sum(int(m[4]) for m in metas)
    assert n_bloom > 4 * n_exact, (n_bloom, n_exact)
    unref = MatchSession(compile_patterns(pats), **kw)
    unref._dvf.exact = None  # the unrefined pipeline
    assert unref.find(data) == want


def test_refinement_retry_on_small_sticky_bucket():
    pats = [b"ab"]
    data = b"ab" * 2000
    sess = MatchSession(compile_patterns(pats), max_chunks=8,
                        chunk_len=1024, device="cpu", verify="device")
    sess._dvf._k_walk = 256  # deliberately too small
    assert sess.find(data) == oracle(pats, data)
    assert sess._dvf._k_walk >= 1000  # the sticky bucket adapted


def test_device_verify_capacity_error_is_specific(monkeypatch):
    # past the cap the batch splits by lanes; only a single lane that
    # holds more candidates than the cap cannot split, and raises
    table = compile_patterns([b"abcd"])
    cfg = port_bloom.BloomFilterTable.from_table(table).cfg
    dvf = port_vd.DeviceVerifier(table, cfg, 4, CPU)
    assert dvf.table_flat.dtype == torch.int16  # kept as compiled
    monkeypatch.setattr(port_vd, "MAX_DEVICE_CAND", 5)
    bits = torch.zeros((2, 128), dtype=torch.int32)
    bits[0, 3] = 0b1111  # lanes 0-2: nothing; lane 3: 4 candidates
    bits[1, 7] = -1  # lane 7: 32 candidates
    with pytest.raises(RuntimeError, match="lane 7 alone holds 32 "
                                           "candidates, over the "
                                           "device-verify cap 5"):
        dvf.verify(torch.zeros((128, 64 * 32), dtype=torch.uint8),
                   torch.zeros((2, 128), dtype=torch.int32), bits, 36)
