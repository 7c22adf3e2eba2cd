"""The dense engine of the PyTorch port against the JAX reference, on the
CPU.

- The dense lane walk's plain PyTorch version (the CPU path, and what the
  CUDA kernel is held to on the card) and the kernel's own per-thread code
  (csrc/dfa_walk.cuh, built with g++) agree, group counts included: the
  kernel's sub-spans (each walked from the root after a warm-up of
  max_pat_len - 1 symbols) and their merge, at 1, 2, 7 and 64 sub-spans
  a lane, on batches built for the seams between them (chip_smoke.py's
  ``seam_batch``, which the card's run checks too).
- ``scan_batch``, ``scan_and_compact``, ``compact_matches``,
  ``sort_matches`` and ``per_group_counts`` equal the reference's on the
  same arrays, through R-slot and capacity overflows.
- ``MatchSession(engine="dense")`` equals the oracle and the reference
  dense session on the probes of the verify notes (boundaries, 0x00
  tails, long patterns, text mode, nocase), and ``find`` raises on a slot
  overflow.

Every output is an integer, so the tolerance is zero."""

import io

import numpy as np
import pytest
import torch

from chip_smoke import seam_batch
from tests.fixtures import random_words_corpus
from tpu_pattern_matching.core.dfa import AhoCorasick, compile_patterns
from tpu_pattern_matching.core.oracle import match_python
from tpu_pattern_matching.ops import compact as ref_compact
from tpu_pattern_matching.ops import match_xla as ref_mx
from tpu_pattern_matching.ops.table import DeviceTable as RefTable
from tpu_pattern_matching.runtime.session import MatchSession as RefSession
from tpu_pattern_matching_torch.ops import compact as port_compact
from tpu_pattern_matching_torch.ops import kernels
from tpu_pattern_matching_torch.ops import match_xla as port_mx
from tpu_pattern_matching_torch.ops.table import DeviceTable
from tpu_pattern_matching_torch.runtime.session import MatchSession

CPU = torch.device("cpu")


def dense_case(seed, table_dtype=None, C=40, T=120, halo=8):
    """Short patterns over a 2-letter alphabet (many matches, several per
    lane past small R, co-terminating groups) and a ragged batch."""
    rng = np.random.RandomState(seed)
    ab = np.frombuffer(b"ab", np.uint8)
    pats = sorted({bytes(rng.choice(ab, size=rng.randint(2, 7))
                         .astype(np.uint8)) for _ in range(10)})
    table = compile_patterns(pats)
    if table_dtype is not None:
        table.goto_signed = table.goto_signed.astype(table_dtype)
    data = rng.choice(np.frombuffer(b"abc", np.uint8),
                      size=(C, T)).astype(np.uint8)
    start = np.where(rng.rand(C) < 0.5, 0, halo).astype(np.int32)
    end = rng.randint(T - 30, T + 1, size=C).astype(np.int32)
    end[1] = start[1]  # empty lane
    end[4] = halo + 3  # short lane
    data[6] = ord("c")  # a lane without matches
    return table, data, np.stack([start, end]), halo


@pytest.mark.parametrize("table_dtype,gcounts", [(np.int16, True),
                                                 (np.int32, True),
                                                 (np.int16, False)])
def test_dense_walk_kernel_body_on_host_equals_plain(table_dtype, gcounts):
    table, data, bounds, halo = dense_case(1, table_dtype)
    dev = DeviceTable.put(table, CPU)
    args = (dev.table_flat, torch.from_numpy(data.T.copy()),
            torch.from_numpy(bounds))
    kw = dict(alphabet_size=256, halo=halo, max_results=4,
              max_pat_len=dev.max_pat_len,
              state_gid=dev.state_gid if gcounts else None,
              num_groups=dev.num_groups)
    host = kernels.dense_walk_on_host(*args, **kw)
    plain = port_mx.dense_walk_plain(*args, **kw)
    for h, p in zip(host[:3], plain[:3]):
        assert torch.equal(h, p)
    if gcounts:
        assert torch.equal(host[3], plain[3])
        assert int(plain[3].sum()) == int(plain[0].sum())
    else:
        assert host[3] is None and plain[3] is None
    assert int(plain[0].max()) > 4  # some lanes overflowed their R slots
    assert dev.table_flat.dtype == torch.from_numpy(
        np.zeros(1, table_dtype)).dtype  # kept as compiled


SUBSPANS = [1, 2, 7, 64]
SEAMS = dict(C=40, T=8 + 122, halo=8)  # pieces of 61 rows down to 2
DENSE_BODIES = {  # name: (batch, table dtype, group ids)
    "dense_case-int16": ("dense", np.int16, "table"),
    "dense_case-int32": ("dense", np.int32, "table"),
    "seams-int32": ("seams", np.int32, "table"),
    "seams-int16": ("seams", np.int16, "table"),
    "seams-int16-gid-minus-1": ("seams", np.int16, "some -1"),
    "seams-int32-no-gcounts": ("seams", np.int32, None),
}


def walk_args(table, data_tm, bounds, halo, R, gids):
    """(args, kw) of a dense walk of the time-major batch; ``gids``:
    "table" (the table's group ids), "some -1" (every other final
    state's id replaced by -1), or None (no group counts)."""
    dev = DeviceTable.put(table, CPU)
    state_gid = None if gids is None else dev.state_gid.clone()
    if gids == "some -1":
        final = torch.nonzero(state_gid >= 0).flatten()
        state_gid[final[::2]] = -1
    return ((dev.table_flat, torch.from_numpy(data_tm),
             torch.from_numpy(bounds)),
            dict(alphabet_size=table.alphabet_size, halo=halo,
                 max_results=R, max_pat_len=table.max_pat_len,
                 state_gid=state_gid, num_groups=dev.num_groups))


def check_subspans_equal_plain(args, kw, S):
    host = kernels.dense_walk_on_host(*args, subspans=S, **kw)
    plain = port_mx.dense_walk_plain(*args, **kw)
    for h, p in zip(host[:3], plain[:3]):
        assert torch.equal(h, p)
    if kw["state_gid"] is None:
        assert host[3] is None and plain[3] is None
    else:
        assert torch.equal(host[3], plain[3])
    return plain


@pytest.mark.parametrize("S", SUBSPANS)
@pytest.mark.parametrize("name", list(DENSE_BODIES))
def test_dense_walk_subspans_on_host_equal_plain(name, S):
    batch, table_dtype, gids = DENSE_BODIES[name]
    if batch == "dense":
        table, data, bounds, halo = dense_case(7, table_dtype)
        data = data.T.copy()
    else:
        table, data, bounds = seam_batch(False, table_dtype, **SEAMS)
        halo = SEAMS["halo"]
    plain = check_subspans_equal_plain(
        *walk_args(table, data, bounds, halo, 4, gids), S)
    counts = plain[0]
    assert int(counts.max()) > 4  # lanes past their R slots
    if batch == "seams":  # the run of a's; an empty lane; end < start
        assert int(counts[5]) > 50 and int(counts[3]) == int(counts[7]) == 0


def test_seam_batch_equals_reference_scan():
    # the seam batch through the reference's scan: the plain version the
    # sub-spans are held to equals it there too
    table, data_tm, bounds = seam_batch(False, np.int32, **SEAMS)
    halo = SEAMS["halo"]
    r = ref_mx.scan_batch(RefTable.put(table), data_tm.T.copy(), bounds[0],
                          bounds[1], halo, max_results=4)
    args, kw = walk_args(table, data_tm, bounds, halo, 4, None)
    plain = port_mx.dense_walk_plain(*args, **kw)
    for name, got in zip(("counts", "slot_state", "slot_pos"), plain):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(r, name)))
    assert int(r.total) > 0


def test_dense_plan():
    bench = kernels.dense_plan_on_host(16 + 4096, 4096, halo=16,
                                       max_pat_len=12)
    assert bench == dict(subspans=32, steps=128 + 11, threads=1024,
                         blocks=128)
    u16 = kernels.dense_plan_on_host(16 + 2048, 4096, halo=16,
                                     max_pat_len=16)
    assert u16 == dict(subspans=32, steps=64 + 15, threads=1024, blocks=128)
    # the warm-up stays within a quarter of a piece; a wide batch fills
    # the card with fewer sub-spans; a batch past the halo has none
    small = kernels.dense_plan_on_host(8 + 122, 40, halo=8, max_pat_len=9)
    assert small["subspans"] == 2 and small["steps"] == 61 + 8
    wide = kernels.dense_plan_on_host(4112, 135168, halo=16, max_pat_len=12)
    assert wide["subspans"] == 1 and wide["blocks"] == 4224
    assert kernels.dense_plan_on_host(16, 64, halo=16,
                                      max_pat_len=4)["subspans"] == 1
    with pytest.raises(ValueError, match="no dense plan"):
        kernels.dense_plan_on_host(16, 64, halo=16, max_pat_len=0)
    table, data, bounds = seam_batch(False, np.int32, **SEAMS)
    args, kw = walk_args(table, data, bounds, 8, 4, None)
    with pytest.raises(ValueError, match="max_pat_len"):
        kernels.dense_walk_on_host(*args, subspans=2,
                                   **dict(kw, max_pat_len=0))


@pytest.mark.parametrize("R", [2, 16])
def test_scan_batch_equals_reference(R):
    table, data, bounds, halo = dense_case(2)
    r = ref_mx.scan_batch(RefTable.put(table), data, bounds[0], bounds[1],
                          halo, max_results=R)
    p = port_mx.scan_batch(DeviceTable.put(table, CPU),
                           torch.from_numpy(data),
                           torch.from_numpy(bounds[0]),
                           torch.from_numpy(bounds[1]), halo, max_results=R)
    for name in ("counts", "slot_state", "slot_pos"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(r, name)))
    assert p.gcounts is None and int(p.total) == int(r.total) > 0


@pytest.mark.parametrize("R,capacity,sort", [(16, None, False),
                                             (16, None, True),
                                             (3, None, True),
                                             (4, 50, False)])
def test_scan_and_compact_equals_reference(R, capacity, sort):
    table, data, bounds, halo = dense_case(3)
    kw = dict(halo=halo, max_results=R, capacity=capacity, sort=sort,
              chunk_len=data.shape[1] - halo)
    r = ref_compact.scan_and_compact(RefTable.put(table), data, bounds, **kw)
    dev = DeviceTable.put(table, CPU)
    p = port_compact.scan_and_compact(dev, torch.from_numpy(data),
                                      torch.from_numpy(bounds), **kw)
    np.testing.assert_array_equal(p.meta.numpy(), np.asarray(r.meta))
    np.testing.assert_array_equal(p.packed.numpy(), np.asarray(r.packed))
    np.testing.assert_array_equal(p.gcounts.numpy(), np.asarray(r.gcounts))
    np.testing.assert_array_equal(
        port_compact.per_group_counts(dev, p).numpy(),
        np.asarray(ref_compact.per_group_counts(RefTable.put(table), r)))
    total, reported = (int(x) for x in p.meta)
    assert int(p.gcounts.sum()) == total
    assert total > reported == (capacity or reported)  # slots overflowed


@pytest.mark.parametrize("capacity", [None, 40])
def test_compact_sort_and_slot_counts_equal_reference(capacity):
    table, data, bounds, halo = dense_case(4)
    rt = RefTable.put(table)
    res = ref_mx.scan_batch(rt, data, bounds[0], bounds[1], halo,
                            max_results=5)
    port_res = port_mx.ScanResult(
        counts=torch.from_numpy(np.array(res.counts)),
        slot_state=torch.from_numpy(np.array(res.slot_state)),
        slot_pos=torch.from_numpy(np.array(res.slot_pos)))
    dev = DeviceTable.put(table, CPU)
    r = ref_compact.compact_matches(rt, res, capacity=capacity)
    p = port_compact.compact_matches(dev, port_res, capacity=capacity)
    np.testing.assert_array_equal(p.meta.numpy(), np.asarray(r.meta))
    np.testing.assert_array_equal(p.packed.numpy(), np.asarray(r.packed))
    assert p.gcounts is None
    # the slot-derived per-group counts (no in-walk gcounts)
    np.testing.assert_array_equal(
        port_compact.per_group_counts(dev, p).numpy(),
        np.asarray(ref_compact.per_group_counts(rt, r)))
    rs = ref_compact.sort_matches(r, chunk_len=128)
    ps = port_compact.sort_matches(p, chunk_len=128)
    np.testing.assert_array_equal(ps.packed.numpy(), np.asarray(rs.packed))


# ----------------------------------------------- the engine="dense" session


def rand_bytes(seed, n):
    return np.random.RandomState(seed).randint(0, 256, size=n).astype(
        np.uint8).tobytes()


def both(pats, table=None, **kw):
    table = table if table is not None else compile_patterns(pats)
    return (RefSession(table, engine="dense", **kw),
            MatchSession(table, device="cpu", engine="dense", **kw))


FIND_CASES = {
    # (patterns, data, session options)
    "words": ([b"he", b"she", b"his", b"hers"],
              b"ushers and his, she sells hershey",
              dict(max_chunks=4, chunk_len=64)),
    "chunk-and-batch-boundaries": ([b"good", b"xgoo"],
                                   (b"x" * 63 + b"good") * 5,
                                   dict(max_chunks=2, chunk_len=64)),
    "nul-near-padded-tails": ([b"\x00\x00\x00", b"a\x00", b"\x00z"],
                              b"a\x00b" * 30 + b"\x00\x00",
                              dict(max_chunks=4, chunk_len=32)),
    "no-match-from-missing-history": ([b"\x00\x00ab"], b"abzzzz",
                                      dict(max_chunks=4, chunk_len=4)),
    "pattern-longer-than-chunk": (
        [rand_bytes(1, 300), b"zz"],
        b"a" * 100 + rand_bytes(1, 300) + b"zz" + b"b" * 50,
        dict(max_chunks=4, chunk_len=128)),
    "empty-input": ([b"abc"], b"", dict(max_chunks=4, chunk_len=64)),
}


@pytest.mark.parametrize("name", list(FIND_CASES))
def test_dense_find_equals_reference_and_oracle(name):
    pats, data, kw = FIND_CASES[name]
    ref, port = both(pats, **kw)
    assert port.engine == "dense" and port.verify_mode == "n/a"
    got = port.find(data)
    assert got == sorted(match_python(pats, data)) == ref.find(data)


def test_dense_text_mode_and_nocase():
    pats, corpus = random_words_corpus(seed=5, n_lines=60)
    corpus += b"x" * 150 + pats[0] + b"\n"
    ref, port = both(pats, max_chunks=8, chunk_len=128)
    got = port.find(corpus, text_mode=True)
    assert got == ref.find(corpus, text_mode=True)
    assert got == sorted(match_python(pats, corpus)) and got
    ac = AhoCorasick(nocase=True)
    ac.add_patterns([b"Hello", b"WORLD"])
    ref, port = both(None, table=ac.compile(), max_chunks=4, chunk_len=32)
    data = b"hello HELLO hElLo world" * 3
    assert port.find(data) == ref.find(data) and len(port.find(data)) == 12


def test_dense_stream_events_sorted_equal_reference():
    pats = [rand_bytes(s, 10) for s in range(50, 60)]
    rng = np.random.RandomState(9)
    data = bytearray(rand_bytes(4, 4000))
    for i, pos in enumerate(rng.randint(0, 3990, size=12)):
        data[pos : pos + 10] = pats[i % 10]
    data = bytes(data)
    ref, port = both(pats, max_chunks=4, chunk_len=256, sort=True)

    def events(sess):
        return [
            [(e.file_id, e.end_offset, e.pattern_indices, e.rep_index,
              e.lane, e.gid) for e in bm.events]
            for bm in sess.scan_stream(io.BytesIO(data), file_id=3)
        ]

    got = events(port)
    assert got == events(ref) and sum(map(len, got)) >= 10


def test_dense_counts_and_slot_overflow():
    # "aa"/"aaa" over a run of a's: every position ends a match, far past
    # R = 4 slots per lane. Counts stay exact; find raises.
    pats = [b"aa", b"aaa", b"zzzz"]
    data = b"a" * 300 + b"zzzzz"
    ref, port = both(pats, max_chunks=4, chunk_len=64, max_results=4)

    def counts(sess):
        buf = sess.new_buffer()
        from tpu_pattern_matching.runtime.buffers import StreamState

        buf.add_stream(io.BytesIO(data), StreamState(file_id=0))
        batch = buf.to_batch()
        comp = sess.scan(batch)
        total, gc = sess.decode_counts(batch, comp)
        bm = sess.decode(batch, comp)
        return (total, gc.tolist(), sess.group_counts(comp).tolist(),
                bm.total, bm.reported, bm.overflowed)

    got = counts(port)
    assert got == counts(ref)
    assert got[0] == got[3] == sum(got[1]) and got[5] and got[4] == 16
    with pytest.raises(RuntimeError, match="max_results"):
        port.find(data)
    big = MatchSession(compile_patterns(pats), max_chunks=4, chunk_len=64,
                       max_results=64, device="cpu", engine="dense")
    assert big.find(data) == sorted(match_python(pats, data))
    bloom = MatchSession(compile_patterns(pats), max_chunks=4, chunk_len=64,
                         device="cpu")
    with pytest.raises(ValueError, match="dense"):
        bloom.group_counts(None)
