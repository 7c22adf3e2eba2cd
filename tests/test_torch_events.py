"""A batch's events built in bulk (``MatchSession._events_from_arrays``)
against the per-event build it replaced, on the CPU.

- Every decode path that builds events from (lane, end, gid) arrays: the
  dense engine flat and on a 1-rank mesh, the native host verify and the
  device verify, on bytes and on ushorts, with ``sort`` off and on. Each
  call's events equal, field for field and in order, a build written here
  one event at a time, and the events equal the oracle's.
- A call with 0 events, with 1 (itemgetter's one-key case) and with a
  group of several patterns; events share their group's pattern list.
- ``MatchEvent``'s interface: keyword construction and defaults,
  ``expand``, equality, a pickle round trip, assignable fields;
  ``BatchMatches.events`` is a list.
- Counter ``events.bulk``: equal to ``verify.events`` in ``--json-stats``
  on the dense and the native host-verify paths, 0 on the tuple fallback.

Events are integers: every comparison is exact."""

import dataclasses
import io
import json
import pickle

import numpy as np
import pytest

from tpu_pattern_matching.core.oracle import match_python
from tpu_pattern_matching_torch.cli import main as port_main
from tpu_pattern_matching_torch.core.dfa import compile_patterns
from tpu_pattern_matching_torch.runtime.buffers import StreamState
from tpu_pattern_matching_torch.runtime.session import (
    BatchMatches,
    MatchEvent,
    MatchSession,
)
from tpu_pattern_matching_torch.runtime.tracing import RECORDER


@pytest.fixture
def world1():
    """A 1-rank gloo world for this test, gone after it."""
    from tpu_pattern_matching_torch.parallel.mesh import owned_world

    with owned_world():
        yield


def reference_build(sess, batch, ln_a, own_a, gid_a):
    """The per-event build: one ``MatchEvent`` a pass of a loop, each
    numpy scalar read on its own, sorted by (file, end) when asked."""
    order = range(len(ln_a))
    if sess.sort:
        order = sorted(order, key=lambda i: (
            int(batch.file_ids[ln_a[i]]),
            int(batch.base_off[ln_a[i]]) + int(own_a[i])))
    out = []
    for i in order:
        ln, g = int(ln_a[i]), int(gid_a[i])
        pids = sess._groups[g]
        out.append(MatchEvent(
            file_id=int(batch.file_ids[ln]),
            end_offset=int(batch.base_off[ln]) + int(own_a[i]),
            pattern_indices=pids, rep_index=pids[0], lane=ln, gid=g))
    return out


def fields(e):
    return tuple(getattr(e, f.name) for f in dataclasses.fields(e))


def assert_same_events(sess, got, want):
    assert type(got) is list
    assert [fields(e) for e in got] == [fields(e) for e in want]
    for e in got:
        assert type(e) is MatchEvent
        assert all(type(v) is int for i, v in enumerate(fields(e)) if i != 2)
        assert e.pattern_indices is sess._groups[e.gid]  # shared


def spy(sess):
    """Wrap the session's bulk build: each call's events and the
    reference build of the same arrays."""
    calls = []
    bulk = sess._events_from_arrays

    def wrapped(batch, ln_a, own_a, gid_a):
        got = bulk(batch, ln_a, own_a, gid_a)
        calls.append((got, reference_build(sess, batch, ln_a, own_a,
                                           gid_a)))
        return got

    sess._events_from_arrays = wrapped
    return calls


def fill(sess, files):
    """One batch of ``files`` ``[(file_id, data)]``, in that lane order."""
    buf = sess.new_buffer()
    for fid, data in files:
        st = StreamState(file_id=fid)
        f = io.BytesIO(data)
        while True:
            code, rd = buf.add_stream(f, st)
            assert code != -1, "the files overflow one batch"
            if rd == 0:
                break
        buf.finalize_stream(st)
    return buf.to_batch()


def corpus(alphabet, seed=3):
    """Patterns with a co-terminating group (``...abc``, ``bc``-like
    suffixes) and three files that plant them, in the symbols of
    ``alphabet``; the files' ids run against their lane order, so
    ``sort`` reorders events across files."""
    rng = np.random.RandomState(seed)
    if alphabet == 256:
        pats = [bytes(rng.randint(97, 123, size=6).astype(np.uint8))
                for _ in range(4)] + [b"xyzabc", b"zabc", b"bc"]
        files = []
        for fid in (7, 2, 5):
            d = bytearray(rng.randint(97, 123, size=900).astype(np.uint8))
            for k, pos in enumerate(range(20, 880, 37)):
                p = pats[(k + fid) % len(pats)]
                d[pos : pos + len(p)] = p
            files.append((fid, bytes(d)))
        syms = {fid: d for fid, d in files}
    else:
        pats = [[int(x) for x in rng.randint(0, 2048, size=5)]
                for _ in range(4)] + [[9, 8, 7, 6], [8, 7, 6], [7, 6]]
        files, syms = [], {}
        for fid in (7, 2, 5):
            seq = rng.randint(0, 2048, size=700)
            for k, pos in enumerate(range(20, 680, 29)):
                p = pats[(k + fid) % len(pats)]
                seq[pos : pos + len(p)] = p
            files.append((fid, ",".join(map(str, seq)).encode()))
            syms[fid] = seq.tolist()
    return pats, files, syms


PATHS = {
    "dense": dict(engine="dense", max_results=32),
    "dense-mesh": dict(engine="dense", max_results=32, mesh="all"),
    "host-verify": dict(engine="bloom", verify="host"),
    "device-verify": dict(engine="bloom", verify="device"),
}


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
@pytest.mark.parametrize("alphabet", [256, 2048], ids=["bytes", "ushorts"])
@pytest.mark.parametrize("path", list(PATHS))
def test_bulk_events_equal_per_event_build(world1, path, alphabet, sort):
    pats, files, syms = corpus(alphabet)
    table = compile_patterns(pats, alphabet_size=alphabet)
    assert max(len(g) for g in table.groups_as_lists()) == 3
    sess = MatchSession(table, max_chunks=128, chunk_len=64, device="cpu",
                        sort=sort, **PATHS[path])
    calls = spy(sess)
    batch = fill(sess, files)
    bm = sess.decode(batch, sess.scan(batch))
    assert isinstance(bm, BatchMatches) and type(bm.events) is list
    assert len(calls) == 1
    got, want = calls[0]
    assert got is bm.events
    assert_same_events(sess, got, want)
    assert any(len(e.pattern_indices) == 3 for e in got)
    if sort:
        keys = [(e.file_id, e.end_offset) for e in got]
        assert keys == sorted(keys) and got[0].file_id == 2
    # the oracle's events, every file
    by_file = {fid: [] for fid in syms}
    for e in got:
        by_file[e.file_id].extend(e.expand())
    for fid, data in syms.items():
        assert sorted(by_file[fid]) == sorted(match_python(pats, data))
    assert bm.reported == len(got) > 20


@pytest.mark.parametrize("n", [0, 1, 5], ids=["none", "one", "five"])
@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
def test_bulk_events_of_few_events(n, sort):
    pats = [b"abc", b"bc", b"c", b"zz"]
    table = compile_patterns(pats)
    sess = MatchSession(table, max_chunks=8, chunk_len=32, device="cpu",
                        engine="dense", sort=sort)
    batch = fill(sess, [(4, b"q" * 70), (1, b"r" * 40)])
    assert batch.chunks >= 4
    rng = np.random.RandomState(n)
    ln_a = rng.randint(0, batch.chunks, size=n).astype(np.int32)
    own_a = rng.randint(0, 32, size=n).astype(np.int32)
    gid_a = rng.randint(0, table.num_groups, size=n).astype(np.int32)
    got = sess._events_from_arrays(batch, ln_a, own_a, gid_a)
    assert_same_events(sess, got,
                       reference_build(sess, batch, ln_a, own_a, gid_a))
    assert len(got) == n


@pytest.mark.parametrize("data,n_events", [
    (b"q" * 200, 0), (b"q" * 100 + b"zz" + b"q" * 50, 1),
    (b"qabcq" * 3, 3)], ids=["none", "one", "group"])
@pytest.mark.parametrize("engine", ["dense", "bloom"])
def test_session_batch_of_few_events(engine, data, n_events):
    pats = [b"abc", b"bc", b"c", b"zz"]
    sess = MatchSession(compile_patterns(pats), max_chunks=8, chunk_len=64,
                        device="cpu", engine=engine)
    calls = spy(sess)
    (bm,) = sess.scan_stream(io.BytesIO(data), file_id=3)
    assert type(bm.events) is list and len(bm.events) == n_events
    for got, want in calls:
        assert_same_events(sess, got, want)
    if n_events:
        assert calls and calls[0][0] is bm.events
    if data.count(b"abc"):
        assert all(e.pattern_indices == [0, 1, 2] for e in bm.events)
    assert sorted(p for e in bm.events for p in e.expand()) == sorted(
        match_python(pats, data))


def test_match_event_interface():
    ev = MatchEvent(file_id=2, end_offset=40, pattern_indices=[3, 5],
                    rep_index=3)
    assert (ev.lane, ev.gid) == (-1, -1)
    assert list(ev.expand()) == [(40, 3), (40, 5)]
    assert ev == MatchEvent(2, 40, [3, 5], 3, -1, -1)
    assert ev != MatchEvent(2, 41, [3, 5], 3)
    assert ev != MatchEvent(2, 40, [3, 5], 3, lane=0)
    full = MatchEvent(file_id=1, end_offset=9, pattern_indices=[0],
                      rep_index=0, lane=6, gid=4)
    for e in (ev, full):
        back = pickle.loads(pickle.dumps(e))
        assert back == e and type(back) is MatchEvent
    assert dataclasses.asdict(full) == dict(
        file_id=1, end_offset=9, pattern_indices=[0], rep_index=0, lane=6,
        gid=4)
    full.end_offset += 1  # fields stay assignable
    assert full == MatchEvent(1, 10, [0], 0, 6, 4)


def run_json_stats(argv, capsys):
    assert port_main(argv + ["--device", "cpu", "--json-stats"]) == 0
    return json.loads(capsys.readouterr().out.splitlines()[-1])


@pytest.mark.parametrize("engine", ["dense", "bloom"])
def test_events_bulk_counter_equals_verify_events(tmp_path, capsys, engine):
    rng = np.random.RandomState(8)
    names = []
    for i in range(3):
        d = bytearray(rng.randint(97, 123, size=5000).astype(np.uint8))
        for pos in range(100, 4900, 97 + i):
            d[pos : pos + 6] = b"needle"
        p = tmp_path / f"in{i}"
        p.write_bytes(bytes(d))
        names.append(str(p))
    (tmp_path / "p.txt").write_text("needle\nedle\n")
    stats = run_json_stats(["-f", ",".join(names), "-p",
                            str(tmp_path / "p.txt"), "-B", "256", "-G", "8",
                            "-w", "2", "--engine", engine], capsys)
    counters = stats["counters"]
    assert counters["events.bulk"] == counters["verify.events"] \
        == stats["matches_total"] > 100


def test_tuple_fallback_builds_no_bulk_events():
    pats = [b"abc", b"bc", b"zz"]
    data = b"qabcqzzq" * 40
    sess = MatchSession(compile_patterns(pats), max_chunks=8, chunk_len=64,
                        device="cpu", engine="bloom", verify="host")
    sess._verifier._dense = None  # no native walker: the tuple fallback
    c0 = RECORDER.counters()
    got = sess.find(data)
    c1 = RECORDER.counters()
    assert got == sorted(match_python(pats, data))
    assert c1.get("events.bulk", 0) == c0.get("events.bulk", 0)
    assert c1["verify.events"] - c0.get("verify.events", 0) == 80
