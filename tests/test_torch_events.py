"""A batch's events built natively and in bulk in Python
(``MatchSession._events_from_arrays``, every decode path's one builder;
the Python build is the fallback where the native builder's library
cannot be built) against a build one event at a time, on the CPU.

- Every decode path: the dense engine flat and on a 1-rank mesh, the
  native host verify and the device verify, on bytes and on ushorts, with
  ``sort`` off and on. Each call's events equal, field for field and in
  order, a build written here one event at a time, and the events equal
  the oracle's.
- The paths that give each event's pattern list: host verify's tuple
  fallback, and the grid's merge on a 1 x 2 gloo grid (two ranks), the
  latter held to the reference's merge loop (``tests/test_torch_grid.py``
  ``loop_merge``) over the shards' rows.
- A call with 0 events, with 1 (itemgetter's one-key case) and with a
  group of several patterns; events share their group's pattern list.
- ``MatchEvent``'s interface: keyword construction and defaults,
  ``expand``, equality, a pickle round trip, assignable fields;
  ``BatchMatches.events`` is a list.
- Counter ``verify.events``: equal to the run's total in
  ``--json-stats`` on the dense and the native host-verify paths; counter
  ``events.native`` equal to it, and 0 where the library fails to load.
- The native build against the Python one on every path above, bytes and
  ushorts, ``sort`` off and on, 0, 1 and 5 events: equal field for field.
  Its events are untracked by the cyclic collector and tracked again when
  a field takes a tracked value; a batch's events, once dropped, leave
  their shared lists' reference counts where they were; ``asdict``,
  equality, pickling and ``copy`` work on them.

Events are integers: every comparison is exact."""

import contextlib
import copy
import dataclasses
import gc
import io
import json
import os
import pickle
import subprocess
import sys
import weakref
from unittest import mock

import numpy as np
import pytest

from tpu_pattern_matching.core.oracle import match_python
from tpu_pattern_matching_torch.cli import main as port_main
from tpu_pattern_matching_torch.core.dfa import compile_patterns
from tpu_pattern_matching_torch.ops import kernels
from tpu_pattern_matching_torch.runtime import session as session_mod
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


def reference_build(sess, batch, ln_a, own_a, gid_a, pids=None):
    """The per-event build: one ``MatchEvent`` a pass of a loop, each
    numpy scalar read on its own, sorted by (file, end) when asked; an
    event's pattern list is its group's, or ``pids[i]`` when given."""
    order = range(len(ln_a))
    if sess.sort:
        order = sorted(order, key=lambda i: (
            int(batch.file_ids[ln_a[i]]),
            int(batch.base_off[ln_a[i]]) + int(own_a[i])))
    out = []
    for i in order:
        ln, g = int(ln_a[i]), int(gid_a[i])
        p = sess._groups[g] if pids is None else pids[i]
        out.append(MatchEvent(
            file_id=int(batch.file_ids[ln]),
            end_offset=int(batch.base_off[ln]) + int(own_a[i]),
            pattern_indices=p, rep_index=p[0], lane=ln, gid=g))
    return out


def fields(e):
    return tuple(getattr(e, f.name) for f in dataclasses.fields(e))


@contextlib.contextmanager
def native_unavailable():
    """The native builder's library fails to build or load: the session
    builds its events in Python."""

    def fail(*_args, **_kw):
        raise RuntimeError("g++ failed")

    session_mod._event_builder.cache_clear()
    try:
        with mock.patch.object(kernels, "python_library", fail):
            assert session_mod._event_builder() is None
            yield
    finally:
        session_mod._event_builder.cache_clear()


def assert_native_events(sess, got, python, want, shared=True):
    """``got`` (the native build) equals the Python build and the
    reference build field for field, its events untracked, the Python
    build's tracked."""
    assert_same_events(sess, got, want, shared)
    assert_same_events(sess, python, want, shared)
    assert not any(map(gc.is_tracked, got))
    assert all(map(gc.is_tracked, python))


def assert_same_events(sess, got, want, shared=True):
    assert type(got) is list
    assert [fields(e) for e in got] == [fields(e) for e in want]
    for e in got:
        assert type(e) is MatchEvent
        assert all(type(v) is int for i, v in enumerate(fields(e)) if i != 2)
        if shared:
            assert e.pattern_indices is sess._groups[e.gid]


def spy(sess):
    """Wrap the session's build: each call's events, the reference build
    of the same arrays, whether the events share their group's list, and
    the Python bulk build of the same arrays."""
    calls = []
    bulk = sess._events_from_arrays

    def wrapped(batch, ln_a, own_a, gid_a, pids=None):
        got = bulk(batch, ln_a, own_a, gid_a, pids)
        with native_unavailable():
            python = bulk(batch, ln_a, own_a, gid_a, pids)
        calls.append((got, reference_build(sess, batch, ln_a, own_a,
                                           gid_a, pids), pids is None,
                      python))
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
    got, want, shared, _python = calls[0]
    assert got is bm.events and shared
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
    for got, want, shared, _python in calls:
        assert_same_events(sess, got, want, shared)
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


def needle_argv(tmp_path, engine):
    """The byte CLI's arguments for three files planted with ``needle``
    (and so ``edle``) every 97-99 bytes."""
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
    return ["-f", ",".join(names), "-p", str(tmp_path / "p.txt"), "-B",
            "256", "-G", "8", "-w", "2", "--engine", engine]


@pytest.mark.parametrize("engine", ["dense", "bloom"])
def test_events_bulk_counter_equals_verify_events(tmp_path, capsys, engine):
    stats = run_json_stats(needle_argv(tmp_path, engine), capsys)
    assert stats["counters"]["verify.events"] == stats["matches_total"] \
        > 100


def test_tuple_fallback_builds_no_bulk_events():
    # the fallback's events, too, come from the one bulk build, each with
    # its own pattern list (the name is from when they did not)
    pats = [b"abc", b"bc", b"zz"]
    data = b"qabcqzzq" * 40
    sess = MatchSession(compile_patterns(pats), max_chunks=8, chunk_len=64,
                        device="cpu", engine="bloom", verify="host")
    sess._verifier._dense = None  # no native walker: the tuple fallback
    calls = spy(sess)
    c0 = RECORDER.counters()
    got = sess.find(data)
    c1 = RECORDER.counters()
    assert got == sorted(match_python(pats, data))
    assert c1["verify.events"] - c0.get("verify.events", 0) == 80
    assert sum(len(c[0]) for c in calls) == 80
    for built, want, shared, _python in calls:
        assert not shared
        assert_same_events(sess, built, want, shared=False)
    assert {tuple(e.pattern_indices) for c in calls for e in c[0]} == {
        (0, 1), (2,)}


def grid_rank(rank: str, url: str, out_dir: str) -> None:
    """One rank of a 1 x 2 grid (two pattern shards of one lane column,
    gloo): ``corpus(256)``'s batch through device verify, with ``sort``
    off and on. Each rank checks its builds against ``reference_build``
    and saves its events, its total and the shards' rows they were merged
    from (``verify_rows``) to ``out_dir``."""
    import torch

    from tpu_pattern_matching_torch.parallel import mesh

    torch.set_num_threads(1)
    rank = int(rank)
    mesh.init_distributed(url, 2, rank, device="cpu")
    pats, files, _syms = corpus(256)
    table = compile_patterns(pats)
    out = {}
    for sort in (0, 1):
        sess = MatchSession(table, max_chunks=128, chunk_len=64,
                            device="cpu", sort=bool(sort), engine="bloom",
                            verify="device", mesh="all", pat_shards=2)
        assert sess._grid.is_leader == (rank == 0)
        rows, verify_rows = [], sess._dvf.verify_rows

        def kept(*args, verify_rows=verify_rows, rows=rows):
            rows.append(verify_rows(*args))
            return rows[-1]

        sess._dvf.verify_rows = kept
        calls = spy(sess)
        batch = (fill(sess, files) if rank == 0
                 else sess.new_buffer().to_batch())
        bm = sess.decode(batch, sess.scan(batch))
        (built, want, shared, python), = calls
        assert built is bm.events and not shared
        assert_native_events(sess, built, python, want, shared=False)
        sh, ln, e, g, _gc = rows[0]
        out[f"rows_{sort}"] = np.stack([sh, ln, e, g])
        out[f"events_{sort}"] = np.array(
            [fields(ev)[:2] + fields(ev)[3:] for ev in bm.events],
            np.int64).reshape(-1, 5)
        out[f"pids_{sort}"] = np.array(
            [len(ev.pattern_indices) for ev in bm.events]
            + [p for ev in bm.events for p in ev.pattern_indices], np.int64)
        out[f"totals_{sort}"] = np.array([bm.total, bm.reported])
    for s, (off, pids) in enumerate(sess._dvf.shard_groups):
        out[f"groups_{s}"] = np.concatenate([[len(off)], off, pids])
    out.update(file_ids=batch.file_ids, base_off=batch.base_off,
               halo=batch.halo)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def test_grid_events_equal_per_event_merge(tmp_path):
    from tests.test_torch_grid import loop_merge
    from tests.test_torch_mesh import REPO, RANK_TIMEOUT_S

    url = f"file://{tmp_path / 'rendezvous'}"
    code = ("import sys; from tests.test_torch_events import grid_rank; "
            "grid_rank(*sys.argv[1:])")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), url, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO, env=env)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0].decode()
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
              for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not failed, "\n".join(failed)
    lead, follow = (np.load(tmp_path / f"rank{r}.npz") for r in range(2))
    pats, _files, syms = corpus(256)
    groups = compile_patterns(pats).groups_as_lists()
    shard_groups = []
    for s in range(2):
        a = lead[f"groups_{s}"]
        off, pids = a[1 : 1 + a[0]], a[1 + a[0]:]
        shard_groups.append([pids[off[i]:off[i + 1]].tolist()
                             for i in range(len(off) - 1)])
    file_ids, base_off, halo = (lead["file_ids"], lead["base_off"],
                                int(lead["halo"]))
    for sort in (0, 1):
        sh, ln, e, g = lead[f"rows_{sort}"]
        identity = [np.arange(len(gl)) for gl in shard_groups]
        # (file, end, rep, lane, gid, patterns), one event a merged set
        want = [(int(file_ids[l_]), int(base_off[l_]) + e_ - halo, p[0],
                 l_, groups.index(list(p)), p)
                for l_, e_, p in loop_merge(sh, ln, e, g, identity,
                                            shard_groups)]
        if sort:
            want.sort(key=lambda w: w[:2])
        ev, pl = lead[f"events_{sort}"], lead[f"pids_{sort}"]
        n = len(ev)
        offs = np.concatenate([[0], np.cumsum(pl[:n])]) + n
        got = [(*ev[k].tolist(), tuple(pl[offs[k]:offs[k + 1]].tolist()))
               for k in range(n)]
        assert got == want
        assert len(got) > 20 and any(len(w[5]) == 3 for w in want)
        by_file = {fid: [] for fid in syms}
        for w in want:
            by_file[w[0]] += [(w[1], p) for p in w[5]]
        for fid, data in syms.items():
            assert sorted(by_file[fid]) == sorted(match_python(pats, data))
        assert lead[f"totals_{sort}"].tolist() == [n, n]
        assert follow[f"events_{sort}"].shape == (0, 5)
        assert follow[f"totals_{sort}"].tolist() == [n, 0]


@pytest.mark.parametrize("native", [True, False],
                         ids=["native", "unavailable"])
@pytest.mark.parametrize("engine", ["dense", "bloom"])
def test_events_native_counter(tmp_path, capsys, engine, native):
    argv = needle_argv(tmp_path, engine)
    with contextlib.nullcontext() if native else native_unavailable():
        stats = run_json_stats(argv, capsys)
    counters = stats["counters"]
    assert counters["verify.events"] == stats["matches_total"] > 100
    assert counters.get("events.native", 0) == (
        counters["verify.events"] if native else 0)


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
@pytest.mark.parametrize("alphabet", [256, 2048], ids=["bytes", "ushorts"])
@pytest.mark.parametrize("path", [*PATHS, "tuple-fallback"])
def test_native_events_equal_python_build(world1, path, alphabet, sort):
    pats, files, _syms = corpus(alphabet)
    table = compile_patterns(pats, alphabet_size=alphabet)
    sess = MatchSession(table, max_chunks=128, chunk_len=64, device="cpu",
                        sort=sort, **PATHS.get(path, PATHS["host-verify"]))
    if path == "tuple-fallback":
        sess._verifier._dense = None  # no native walker
    calls = spy(sess)
    batch = fill(sess, files)
    c0 = RECORDER.counters()
    bm = sess.decode(batch, sess.scan(batch))
    c1 = RECORDER.counters()
    (got, want, shared, python), = calls
    assert got is bm.events and shared == (path != "tuple-fallback")
    assert_native_events(sess, got, python, want, shared)
    assert any(len(e.pattern_indices) == 3 for e in got)
    made = {k: c1[k] - c0.get(k, 0)
            for k in ("events.native", "verify.events")}
    assert made["events.native"] == made["verify.events"] == len(got) > 20


def few_events(n, lists, sort=False, seed=0):
    """A dense session over ``abc``, ``bc``, ``c``, ``zz`` (a group of
    three patterns) and the columns of ``n`` events in its batch, the last
    of the three-pattern group; ``pids`` a fresh list an event, or None."""
    table = compile_patterns([b"abc", b"bc", b"c", b"zz"])
    sess = MatchSession(table, max_chunks=8, chunk_len=32, device="cpu",
                        engine="dense", sort=sort)
    batch = fill(sess, [(4, b"q" * 70), (1, b"r" * 40)])
    rng = np.random.RandomState(seed + n)
    ln_a = rng.randint(0, batch.chunks, size=n).astype(np.int32)
    own_a = rng.randint(0, 32, size=n).astype(np.int32)
    gid_a = rng.randint(0, table.num_groups, size=n).astype(np.int32)
    if n:
        gid_a[-1] = [len(g) for g in sess._groups].index(3)
    pids = [list(sess._groups[g]) for g in gid_a] if lists else None
    return sess, batch, (ln_a, own_a, gid_a, pids)


@pytest.mark.parametrize("lists", [False, True], ids=["groups", "lists"])
@pytest.mark.parametrize("n", [0, 1, 5], ids=["none", "one", "five"])
@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
def test_native_events_of_few_events(n, sort, lists):
    sess, batch, cols = few_events(n, lists, sort)
    got = sess._events_from_arrays(batch, *cols)
    with native_unavailable():
        python = sess._events_from_arrays(batch, *cols)
    assert_native_events(sess, got, python,
                         reference_build(sess, batch, *cols),
                         shared=not lists)
    assert len(got) == n
    assert any(len(e.pattern_indices) == 3 for e in got) == bool(n)


class Sentinel:
    pass


@pytest.mark.parametrize("field", session_mod._EVENT_FIELDS)
def test_native_event_tracked_again(field):
    sess, batch, cols = few_events(5, lists=False)
    got = sess._events_from_arrays(batch, *cols)
    e = got[2]
    assert not gc.is_tracked(e)
    setattr(e, field, 7)  # an int: the collector still has nothing to see
    assert getattr(e, field) == 7 and not gc.is_tracked(e)
    sentinel = Sentinel()
    alive = weakref.ref(sentinel)
    setattr(e, field, [e, sentinel])  # a cycle through the event
    assert gc.is_tracked(e) and getattr(e, field)[0] is e
    assert not any(map(gc.is_tracked, got[:2] + got[3:]))
    del e, got, sentinel
    gc.collect()
    assert alive() is None  # the collector freed the cycle


@pytest.mark.parametrize("lists", [False, True], ids=["groups", "lists"])
def test_native_events_release_their_lists(lists):
    sess, batch, cols = few_events(40, lists)
    held = cols[3] if lists else sess._groups
    before = list(map(sys.getrefcount, held))
    got = sess._events_from_arrays(batch, *cols)
    during = list(map(sys.getrefcount, held))
    uses = [sum(e.pattern_indices is lst for e in got) for lst in held]
    assert [d - b for b, d in zip(before, during)] == uses
    assert sum(uses) == 40
    del got
    assert list(map(sys.getrefcount, held)) == before


@pytest.mark.parametrize("how", ["asdict", "equality", "pickle", "copy",
                                 "deepcopy", "replace"])
def test_native_event_interface(how):
    sess, batch, cols = few_events(5, lists=False)
    e = sess._events_from_arrays(batch, *cols)[4]
    assert not gc.is_tracked(e)
    want = MatchEvent(*fields(e))
    assert gc.is_tracked(want)
    if how == "asdict":
        assert dataclasses.asdict(e) == dataclasses.asdict(want) == dict(
            zip(session_mod._EVENT_FIELDS, fields(e)))
    elif how == "equality":
        assert e == want and not e != want
        assert e != MatchEvent(*fields(e)[:5], e.gid + 1)
    else:
        back = {"pickle": lambda x: pickle.loads(pickle.dumps(x)),
                "copy": copy.copy, "deepcopy": copy.deepcopy,
                "replace": dataclasses.replace}[how](e)
        assert type(back) is MatchEvent and back is not e
        assert back == e == want and fields(back) == fields(e)
    assert fields(e) == fields(want)
