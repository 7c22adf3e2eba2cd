"""Pattern shards on one device (``parallel/pshard.py``) of the PyTorch
port against the reference package on the CPU.

- ``sharded_hits``, ``DeviceShardedBloom`` and ``MatchSession(pat_shards=S)
  .scan`` give the reference's union bitmap and total bit for bit (the
  reference's probes in Pallas interpret mode), for S in {2, 3, 4}, both
  kernel modes, uint8 and uint16 symbols, from filters carried across by
  ``ShardedBloom.from_reference``; the session attaches no refinement, as
  the reference does not.
- The port's own build equals the reference's, and the single-device
  cases of tests/test_pshard.py hold for the port (events equal the
  oracle with host and device verify; validation errors; dumps), with
  dumps written by either package loading in the other.

Every output is an integer: the tolerance is zero."""

import io

import numpy as np
import pytest
import torch

from tests.fixtures import planted_binary
from tpu_pattern_matching.core.dfa import compile_patterns as ref_compile
from tpu_pattern_matching.parallel import pshard as ref_pshard
from tpu_pattern_matching.runtime.session import MatchSession as RefSession
from tpu_pattern_matching_torch.core.dfa import compile_patterns
from tpu_pattern_matching_torch.core.oracle import match_python
from tpu_pattern_matching_torch.parallel import pshard
from tpu_pattern_matching_torch.parallel.pshard import (
    ShardedBloom,
    shard_pattern_ids,
)
from tpu_pattern_matching_torch.runtime.buffers import StreamState
from tpu_pattern_matching_torch.runtime.session import MatchSession

CPU = torch.device("cpu")


def _patterns(n=24, seed=7, alphabet=256):
    # mixed lengths (6..12) so the longest-first deal is exercised and
    # q/w choices are constrained by the global minimum
    rng = np.random.RandomState(seed)
    if alphabet == 256:
        return [bytes(rng.randint(0, 256, size=rng.randint(6, 13))
                      .astype(np.uint8)) for _ in range(n)]
    return [tuple(int(x) for x in rng.randint(0, alphabet,
                                              size=rng.randint(6, 13)))
            for _ in range(n)]


def _oracle_set(patterns, data):
    return set(match_python(patterns, data))


def _event_set(events):
    return {e for ev in events for e in ev.expand()}


def _batch(sess, payload: bytes):
    buf = sess.new_buffer()
    buf.add_stream(io.BytesIO(payload), StreamState(file_id=0))
    return buf.to_batch()


def test_shard_pattern_ids_equal_reference():
    for lens, S in (([3, 9, 5, 7, 4, 8, 6, 10], 3), ([5] * 7, 2),
                    (list(range(20, 0, -1)), 4), ([4, 4, 9], 3)):
        got = shard_pattern_ids(lens, S)
        want = ref_pshard.shard_pattern_ids(lens, S)
        assert [p.tolist() for p in got] == [p.tolist() for p in want]
    parts = shard_pattern_ids([3, 9, 5, 7, 4, 8, 6, 10], 3)
    assert sorted(np.concatenate(parts).tolist()) == list(range(8))
    # the globally shortest pattern (id 0) is dealt last: shard (N-1) % S
    assert 0 in parts[(8 - 1) % 3]
    assert max(map(len, parts)) - min(map(len, parts)) <= 1


@pytest.mark.parametrize("mode", ["auto", "sampled", "strided"])
def test_sharded_build_equals_reference(mode):
    pats = _patterns()
    opts = {} if mode == "auto" else {"mode": mode}
    ref = ref_pshard.ShardedBloom.build([list(p) for p in pats], 4, **opts)
    sb = ShardedBloom.build([list(p) for p in pats], 4, **opts)
    assert sb.n_shards == 4 and sb.words.shape[0] == 4
    assert sb.cfg == pshard.config_from_reference(ref.cfg)
    np.testing.assert_array_equal(sb.words, ref.words)
    assert [p.tolist() for p in sb.parts] == [p.tolist() for p in ref.parts]
    assert sb.n_grams == ref.n_grams and sb.fp_est == ref.fp_est
    for a, b in zip(sb.shard_gram_keys, ref.shard_gram_keys):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sb.gram_keys, ref.gram_keys)
    # every pattern in exactly one shard; the shard filters differ
    assert sorted(np.concatenate(sb.parts).tolist()) == list(range(len(pats)))
    assert not np.array_equal(sb.words[0], sb.words[1])
    # from_reference carries the same filter across
    fr = ShardedBloom.from_reference(ref)
    assert fr.cfg == sb.cfg and fr.max_pat_len == sb.max_pat_len
    np.testing.assert_array_equal(fr.words, sb.words)


def _ragged(seed, C, T, n_sym, halo, pats):
    """Random lanes [C, T] with ragged spans and the patterns planted."""
    rng = np.random.RandomState(seed)
    data = rng.randint(0, n_sym, size=(C, T)).astype(
        np.uint8 if n_sym == 256 else np.uint16)
    for ln in range(0, C, 3):
        p = np.asarray(list(pats[ln % len(pats)]), data.dtype)
        o = rng.randint(0, T - len(p))
        data[ln, o : o + len(p)] = p
    start = rng.randint(0, halo + 1, size=C).astype(np.int32)
    end = rng.randint(T - 30, T + 1, size=C).astype(np.int32)
    end[1] = start[1]  # an empty lane
    end[4] = min(T, int(start[4]) + 7)  # a short lane
    return data, np.stack([start, end])


UNION = [(S, mode, width) for width in ("u8", "u16")
         for mode in ("sampled", "strided") for S in (2, 3, 4)]


@pytest.mark.parametrize("S,mode,width", UNION,
                         ids=[f"S{s}-{m}-{w}" for s, m, w in UNION])
def test_union_bitmap_equals_reference(S, mode, width):
    # the reference's sharded filter, carried across; the session's own
    # batch, then a ragged batch of the same shape, through both packages
    A = 256 if width == "u8" else 2048
    pats = _patterns(n=18, seed=S + 10 * (mode == "sampled"), alphabet=A)
    ref_table = ref_compile(pats, alphabet_size=A)
    ref_sb = ref_pshard.ShardedBloom.from_table(ref_table, S, mode=mode)
    assert ref_sb.cfg.sampled == (mode == "sampled")
    sb = ShardedBloom.from_reference(ref_sb)
    kw = dict(max_chunks=130, chunk_len=64, engine="bloom")
    ref_sess = RefSession(ref_table, bloom_table=ref_sb, **kw)
    sess = MatchSession(compile_patterns(pats, alphabet_size=A),
                        bloom_table=sb, device="cpu", **kw)
    assert ref_sess.pat_shards == sess.pat_shards == S
    # a stream of random symbols with the patterns planted
    rng = np.random.RandomState(S)
    seq = rng.randint(0, A, size=130 * 64 - 100)
    for i in range(0, len(seq) - 20, 97):
        p = list(pats[i % len(pats)])
        seq[i : i + len(p)] = p
    payload = (bytes(seq.astype(np.uint8)) if A == 256 else
               ",".join(map(str, seq)).encode())
    batch = _batch(sess, payload)
    ref_h = ref_sess.scan(batch)
    h = sess.scan(batch)
    np.testing.assert_array_equal(h.bits.numpy(), np.asarray(ref_h.bits))
    assert int(h.meta[0]) == int(np.asarray(ref_h.meta)[0]) > 0
    assert sess._bloom.__class__ is pshard.DeviceShardedBloom
    bm = sess.decode(batch, h)
    assert sess.refine_overflows == 0
    assert _event_set(bm.events) == _oracle_set(pats, seq.tolist())
    # device verify walks the same union bitmap
    dsess = MatchSession(compile_patterns(pats, alphabet_size=A),
                         bloom_table=sb, device="cpu", verify="device", **kw)
    dbm = dsess.decode(batch, dsess.scan(batch))
    assert _event_set(dbm.events) == _event_set(bm.events)
    # a ragged batch of the session's shape: sharded_hits, the device
    # filter's hits and probe_total, against _sharded_hits_jit
    data, bounds = _ragged(S, *batch.data.shape, A, batch.halo, pats)
    r_total, r_bits = ref_pshard._sharded_hits_jit(
        data, bounds, ref_sb.words, cfg=ref_sb.cfg, n_shards=S,
        interpret=True)
    td, tb = torch.from_numpy(data), torch.from_numpy(bounds)
    total, bits = pshard.sharded_hits(td, tb, torch.from_numpy(sb.words),
                                      sb.cfg)
    assert bits.dtype == torch.int32 and total.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy(), np.asarray(r_bits))
    assert int(total[0]) == int(r_total[0]) > 0
    dev = sb.put(CPU)
    assert torch.equal(dev.hits(td, tb).bits, bits)
    assert int(dev.probe_total(td, tb[0], tb[1])) == int(total[0])


def test_sharded_session_matches_oracle_single_device():
    pats = _patterns()
    data, _ = planted_binary(11, 1 << 14, pats, 40)
    table = compile_patterns(pats)
    sess1 = MatchSession(table, max_chunks=128, chunk_len=256,
                         engine="bloom", device="cpu")
    sessS = MatchSession(table, max_chunks=128, chunk_len=256,
                         engine="bloom", pat_shards=4, device="cpu")
    assert sessS.pat_shards == 4
    assert isinstance(sessS.bloom_table, ShardedBloom)
    want = _oracle_set(pats, data)
    assert set(sess1.find(data)) == want
    assert set(sessS.find(data)) == want
    assert sessS.refine_overflows == 0


def test_sharded_union_bitmap_superset_of_single():
    # every true gram position survives the union: one batch through
    # scan and decode gives the oracle's events
    pats = _patterns(n=12, seed=3)
    data, _ = planted_binary(5, 1 << 13, pats, 25)
    table = compile_patterns(pats)
    sess = MatchSession(table, max_chunks=64, chunk_len=256, engine="bloom",
                        pat_shards=3, device="cpu")
    bm = sess.scan_and_decode(_batch(sess, data))
    assert _event_set(bm.events) == _oracle_set(pats, data)
    # decode_counts and scan_stream work unchanged on the union
    b = _batch(sess, data)
    n_ev, gc = sess.decode_counts(b, sess.scan(b))
    assert n_ev == len(bm.events) == int(gc.sum())


def test_pat_shards_with_device_verify():
    # the union bitmap feeds the device verify stage (which walks the
    # whole table, refined by the union's gram keys): oracle-exact
    pats = _patterns(n=12, seed=31)
    data, _ = planted_binary(17, 1 << 13, pats, 25)
    table = compile_patterns(pats)
    sess = MatchSession(table, max_chunks=64, chunk_len=256, engine="bloom",
                        pat_shards=3, verify="device", device="cpu")
    assert set(sess.find(data)) == _oracle_set(pats, data)


def test_pat_shards_validation_equals_reference():
    pats = _patterns(n=6)
    table, ref_table = compile_patterns(pats), ref_compile(pats)
    sb = ShardedBloom.from_table(table, 2)
    ref_sb = ref_pshard.ShardedBloom.from_table(ref_table, 2)
    cases = [  # (port call, reference call, message)
        (lambda: MatchSession(table, engine="dense", pat_shards=2,
                              device="cpu"),
         lambda: RefSession(ref_table, engine="dense", pat_shards=2),
         "dense"),
        (lambda: ShardedBloom.from_table(table, 7),
         lambda: ref_pshard.ShardedBloom.from_table(ref_table, 7), "shards"),
        (lambda: MatchSession(table, engine="bloom", bloom_table=sb,
                              pat_shards=3, device="cpu"),
         lambda: RefSession(ref_table, engine="bloom", bloom_table=ref_sb,
                            pat_shards=3), "precompiled"),
        (lambda: MatchSession(table, engine="bloom", pat_shards=0,
                              device="cpu"),
         lambda: RefSession(ref_table, engine="bloom", pat_shards=0),
         ">= 1"),
    ]
    for port_call, ref_call, match in cases:
        with pytest.raises(ValueError, match=match) as p:
            port_call()
        with pytest.raises(ValueError) as r:
            ref_call()
        assert str(p.value) == str(r.value)
    # pat_shards inferred from a precompiled sharded filter
    sess = MatchSession(table, engine="bloom", bloom_table=sb, device="cpu")
    assert sess.pat_shards == 2
    assert sess.pat_shards == RefSession(ref_table, engine="bloom",
                                         bloom_table=ref_sb).pat_shards


def test_sharded_bloom_save_load_roundtrip(tmp_path):
    pats = _patterns(n=10, seed=9)
    table = compile_patterns(pats)
    sb = ShardedBloom.from_table(table, 3)
    path = str(tmp_path / "psb.npz")
    sb.save(path)
    sb2 = ShardedBloom.load(path)
    assert sb2.cfg == sb.cfg
    np.testing.assert_array_equal(sb2.words, sb.words)
    assert [p.tolist() for p in sb2.parts] == [p.tolist() for p in sb.parts]
    assert sb2.n_grams == sb.n_grams
    # a flat dump is rejected with a clear error
    from tpu_pattern_matching_torch.ops.bloom import BloomFilterTable

    fpath = str(tmp_path / "flat.npz")
    BloomFilterTable.from_table(table).save(fpath)
    with pytest.raises(ValueError, match="flat filter"):
        ShardedBloom.load(fpath)


def test_sharded_save_load_keeps_gram_keys(tmp_path):
    pats = _patterns(n=10, seed=9)
    sb = ShardedBloom.from_table(compile_patterns(pats), 3)
    path = str(tmp_path / "psb_keys.npz")
    sb.save(path)
    sb2 = ShardedBloom.load(path)
    assert len(sb2.shard_gram_keys) == 3
    for a, b in zip(sb.shard_gram_keys, sb2.shard_gram_keys):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sb.gram_keys, sb2.gram_keys)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sharded_dumps_cross_packages(writer, tmp_path):
    # a dump written by either package loads in the other: same words,
    # config, parts and gram keys, and the same union bitmap
    pats = _patterns(n=14, seed=5)
    table, ref_table = compile_patterns(pats), ref_compile(pats)
    path = str(tmp_path / "d.npz")
    if writer == "port":
        src = ShardedBloom.from_table(table, 3)
        src.save(path)
        got = ShardedBloom.from_reference(
            ref_pshard.ShardedBloom.load(path))
    else:
        ref_src = ref_pshard.ShardedBloom.from_table(ref_table, 3)
        ref_src.save(path)
        src = ShardedBloom.from_reference(ref_src)
        got = ShardedBloom.load(path)
    assert got.cfg == src.cfg and got.max_pat_len == src.max_pat_len
    np.testing.assert_array_equal(got.words, src.words)
    assert [p.tolist() for p in got.parts] == [p.tolist() for p in src.parts]
    assert got.n_grams == src.n_grams and got.fp_est == src.fp_est
    for a, b in zip(got.shard_gram_keys, src.shard_gram_keys):
        np.testing.assert_array_equal(a, b)
    data, _ = planted_binary(3, 1 << 12, pats, 10)
    sess = MatchSession(table, max_chunks=16, chunk_len=256, engine="bloom",
                        bloom_table=got, device="cpu")
    assert set(sess.find(data)) == _oracle_set(pats, data)


def test_best_scan_total_fn_takes_a_sharded_filter():
    # the benchmark hook probes all S shards: the union total, equal to
    # the reference's hook on the same sharded filter
    from tpu_pattern_matching.engine import best_scan_total_fn as ref_fn
    from tpu_pattern_matching_torch.engine import best_scan_total_fn

    pats = _patterns(n=12, seed=13)
    ref_sb = ref_pshard.ShardedBloom.from_table(ref_compile(pats), 3)
    C, B = 40, 64
    r_fn, halo = ref_fn(ref_compile(pats), C, B, engine="bloom",
                        bloom_table=ref_sb)
    p_fn, p_halo = best_scan_total_fn(
        compile_patterns(pats), C, B, engine="bloom",
        bloom_table=ShardedBloom.from_reference(ref_sb), device="cpu")
    assert p_halo == halo
    data, bounds = _ragged(4, C, halo + B, 256, halo, pats)
    want = int(r_fn(data, bounds[0], bounds[1]))
    got = p_fn(torch.from_numpy(data), torch.from_numpy(bounds[0]),
               torch.from_numpy(bounds[1]))
    assert got.dtype == torch.int32 and int(got) == want > 0
