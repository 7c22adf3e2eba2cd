"""The port's span and counter recorder (``runtime/tracing.py``), the spans
the feed, ``scan`` and ``decode`` stamp into it, their place on the
profiler's axis, and the benchmark's readers of them, on the CPU.

- The recorder: nesting, self-times charged into the open span, the ring
  bound with totals kept, four threads at once.
- A ushort CLI run over a few flow files: every batch id in ``feed.batch``,
  ``feed.wait``, ``scan``, ``decode`` and ``batch``; the ``feed.file``
  visits' tokens sum to the tokens scanned; the byte feed alike;
  ``--json-stats`` carries the span totals and counters, the parse's
  ``parse.native_tokens`` or ``parse.numpy_tokens`` among them; ``--ushort
  --profile`` writes one Chrome trace holding the torch ops and the
  program's spans of the main and feeder threads on one axis.
- ``perfbench/program_trace.py``: under ``torch.profiler``, each ``scan``
  span placed by ``offset_us`` lies inside its ``record_function("scan")``.
- The six readers on a synthetic run give their hand-computed values.
"""

import io
import json
import os
import sys
import threading
import time

import numpy as np
import pytest

from perfbench import program_trace, spec
from perfbench.stream import Record
from perfbench.trace import Trace
from tpu_pattern_matching_torch.cli import main as port_main
from tpu_pattern_matching_torch.core.dfa import compile_patterns
from tpu_pattern_matching_torch.runtime.buffers import DataBuffer
from tpu_pattern_matching_torch.runtime.session import MatchSession
from tpu_pattern_matching_torch.runtime.tracing import (
    RECORDER,
    Recorder,
    SpanRecord,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIGS = "40,32,287,32,106,196; 6; scanner\n5,5,5; 3; triple five\n"


# ------------------------------------------------------------- recorder


def test_nesting_self_time_and_batch_ids():
    rec = Recorder()
    with rec.span("outer", seq=7, work=3) as outer:
        rec.charge(work=2, parse=5, read=1)
        rec.charge(parse=4)
        with rec.span("inner"):
            rec.charge(work=1, pack=9)
        rec.record("done", 10, 20)
    got = {r.name: r for r in rec.spans()}
    assert set(got) == {"outer", "inner", "done"}
    o, i, d = got["outer"], got["inner"], got["done"]
    assert o.parent == 0 and i.parent == d.parent == o.id == outer.id
    assert o.seq == i.seq == d.seq == 7  # children take the batch's id
    assert o.work == 5 and o.parts == {"parse": 9, "read": 1}
    assert i.work == 1 and i.parts == {"pack": 9}
    assert o.t0 <= i.t0 <= i.t1 <= o.t1 and (d.t0, d.t1) == (10, 20)
    assert o.tid == i.tid == threading.get_native_id()
    rec.charge(work=4, parse=1)  # no open span: nothing
    assert rec.totals()["outer"][2] == 5
    rec.add("c")
    rec.add("c", 4)
    assert rec.counters() == {"c": 5}


def test_begin_end_drop_and_report_since():
    rec = Recorder()
    a = rec.begin("a")
    b = rec.begin("b")
    rec.end(a)  # b, left open above a, goes with it
    with rec.span("c"):
        pass
    assert [(r.name, r.parent) for r in rec.spans()] == [("a", 0),
                                                         ("c", 0)]
    d = rec.begin("d")
    rec.drop(d)
    assert "d" not in rec.totals() and b.id != d.id
    since = (rec.totals(), rec.counters())
    rec.add("x", 3)
    with rec.span("c", work=2):
        pass
    rep = rec.report(since)
    assert rep["counters"] == {"x": 3}
    assert list(rep["spans"]) == ["c"] and rep["spans"]["c"]["n"] == 1 \
        and rep["spans"]["c"]["work"] == 2


def test_ring_is_bounded_and_totals_are_not():
    rec = Recorder(capacity=16)
    for k in range(100):
        with rec.span("s", seq=k, work=1):
            pass
    kept = rec.spans()
    assert len(kept) == 16 and [r.seq for r in kept] == list(range(84, 100))
    assert rec.totals()["s"][0] == 100 and rec.totals()["s"][2] == 100
    assert rec.oldest() == kept[0].t0
    lo = kept[5].t1
    assert rec.spans(lo=lo) == kept[5:]


def test_four_threads_at_once():
    rec = Recorder()
    n = 2000
    start = threading.Barrier(4)

    def work(k):
        start.wait()
        for i in range(n):
            with rec.span("t", seq=k, work=1):
                rec.charge(parse=1)
                with rec.span("u"):
                    pass
            rec.add("n")

    ts = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as it can
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    tot = rec.totals()
    assert tot["t"][0] == tot["u"][0] == 4 * n and tot["t"][2] == 4 * n
    assert rec.counters() == {"n": 4 * n}
    by_id = {r.id: r for r in rec.spans()}
    assert len(by_id) == 8 * n
    for r in by_id.values():
        if r.name == "u":  # a child's parent is its own thread's span
            p = by_id[r.parent]
            assert p.name == "t" and p.tid == r.tid and p.seq == r.seq
        else:
            assert r.parts == {"parse": 1}
    assert len({r.tid for r in by_id.values()}) == 4


# ----------------------------------------------------------- the port


def write_flows(d, n_files=4, seed=3):
    rng = np.random.RandomState(seed)
    d.mkdir()
    tokens = 0
    for i in range(n_files):
        toks = rng.randint(0, 3000, size=500 + 700 * i).tolist()
        toks[100:106] = [40, 32, 287, 32, 106, 196]
        (d / f"flow{i}").write_text(",".join(map(str, toks)))
        tokens += len(toks)
    return tokens


def run_cli(argv, capsys):
    lo = time.perf_counter_ns()
    assert port_main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    return lo, out


def test_ushort_stream_spans_share_batch_ids(tmp_path, capsys):
    tokens = write_flows(tmp_path / "flows")
    (tmp_path / "sigs").write_text(SIGS)
    lo, out = run_cli(["-f", str(tmp_path / "flows"), "-p",
                       str(tmp_path / "sigs"), "--ushort", "-B", "128",
                       "-G", "8", "-w", "2", "--engine", "bloom",
                       "--json-stats"], capsys)
    spans = RECORDER.spans(lo=lo)

    def seqs(name):
        return {r.seq for r in spans if r.name == name}

    ids = seqs("feed.batch")
    stats = json.loads(out.splitlines()[-1])
    assert len(ids) == stats["rounds"] > 4 and -1 not in ids
    for name in ("scan", "scan.upload", "scan.probe", "decode",
                 "decode.sync", "batch"):
        assert seqs(name) == ids, name
    assert seqs("feed.wait") - {-1} == ids
    # the feed's visits parsed every token, and the scans took them all
    visits = [r for r in spans if r.name == "feed.file"]
    assert sum(r.work for r in visits) == tokens
    assert sum(r.work for r in spans if r.name == "scan") == tokens
    assert sum(r.work for r in spans if r.name == "feed.batch") == tokens
    assert all(r.parts and r.parts["parse"] > 0 for r in visits
               if r.work)
    assert len({r.tid for r in visits}) == 2
    by_id = {r.id: r for r in spans}
    for r in visits:  # a visit lies inside its batch, on its thread
        b = by_id[r.parent]
        assert b.name == "feed.batch" and b.seq == r.seq and b.tid == r.tid
        assert b.t0 <= r.t0 <= r.t1 <= b.t1
    for r in spans:
        if r.name == "feed.batch":
            assert 0 < r.parts["cpu"] and r.parts["threads"] == 2
            assert 0 <= r.parts["put"] <= r.t1 - r.t0
    # --json-stats: this run's span totals and counters
    assert stats["spans"]["scan"]["n"] == stats["rounds"]
    assert stats["spans"]["feed.file"]["work"] == tokens
    assert stats["counters"]["feed.allocs"] == stats["rounds"] + 2
    assert stats["counters"]["verify.events"] == stats["matches_total"] \
        == 4
    assert stats["counters"]["verify.candidates"] >= 4


@pytest.mark.parametrize("native", [True, False], ids=["stager", "numpy"])
def test_byte_feed_visits_count_bytes(tmp_path, capsys, monkeypatch, native):
    if not native:
        monkeypatch.setenv("TPM_NO_NATIVE_STAGER", "1")
    rng = np.random.RandomState(5)
    total = 0
    names = []
    for i in range(3):
        p = tmp_path / f"in{i}"
        p.write_bytes(bytes(rng.randint(0, 256, size=3000 + 2000 * i)
                            .astype(np.uint8)) + b"needle")
        total += 3006 + 2000 * i
        names.append(str(p))
    (tmp_path / "p.txt").write_text("needle\n")
    lo, out = run_cli(["-f", ",".join(names), "-p", str(tmp_path / "p.txt"),
                       "-B", "256", "-G", "8", "-w", "2", "--engine",
                       "bloom", "--json-stats"], capsys)
    spans = RECORDER.spans(lo=lo)
    visits = [r for r in spans if r.name == "feed.file"]
    assert sum(r.work for r in visits) == total
    assert sum(r.work for r in spans if r.name == "scan") == total
    assert all(r.parts["read"] > 0 for r in visits if r.work)
    assert json.loads(out.splitlines()[-1])["matches_total"] == 3


@pytest.mark.parametrize("native", [True, False], ids=["stager", "numpy"])
def test_ushort_parse_counters_name_the_path(tmp_path, capsys, monkeypatch,
                                             native):
    if not native:
        monkeypatch.setenv("TPM_NO_NATIVE_STAGER", "1")
    tokens = write_flows(tmp_path / "flows", n_files=3)
    (tmp_path / "sigs").write_text(SIGS)
    _lo, out = run_cli(["-f", str(tmp_path / "flows"), "-p",
                        str(tmp_path / "sigs"), "--ushort", "-B", "128",
                        "-G", "8", "-w", "2", "--json-stats"], capsys)
    stats = json.loads(out.splitlines()[-1])
    counters = stats["counters"]
    assert stats["spans"]["feed.file"]["work"] == tokens
    used, unused = (("parse.native_tokens", "parse.numpy_tokens") if native
                    else ("parse.numpy_tokens", "parse.native_tokens"))
    assert counters[used] == tokens
    assert counters.get(unused, 0) == 0
    assert stats["matches_total"] == 3


def test_ushort_profile_writes_one_trace_on_one_axis(tmp_path, capsys):
    write_flows(tmp_path / "flows", n_files=3)
    (tmp_path / "sigs").write_text(SIGS)
    prof = tmp_path / "prof"
    _lo, out = run_cli(["-f", str(tmp_path / "flows"), "-p",
                        str(tmp_path / "sigs"), "--ushort", "-B", "128",
                        "-G", "8", "-w", "2", "--profile", str(prof)],
                       capsys)
    assert "Matches:             3" in out  # the STATS block, as before
    files = os.listdir(prof)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((prof / files[0]).read_text())["traceEvents"]
    mine = [e for e in events if e.get("cat") == "program"]
    names = {e["name"] for e in mine}
    assert {"scan", "scan.upload", "decode", "feed.file", "feed.batch",
            "feed.wait"} <= names
    main = {e["tid"] for e in mine if e["name"] == "scan"}
    feeders = {e["tid"] for e in mine if e["name"] == "feed.file"}
    assert len(main) == 1 and len(feeders) == 2 and not main & feeders
    named = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {named[t] for t in feeders} == {"feeder-0", "feeder-1"}
    # one axis: each upload span holds the torch copy it made
    copies = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "cpu_op" and e["name"] == "aten::to"]
    ups = [(e["ts"], e["ts"] + e["dur"]) for e in mine
           if e["name"] == "scan.upload"]
    assert len(ups) >= 4
    for s, e in ups:
        assert any(s <= cs and ce <= e for cs, ce in copies), (s, e)


def test_stream_allocates_at_most_depth_plus_one_buffers():
    """The databuf contract on the port (the ``feed.allocs`` counter): a
    stream hundreds of times the buffer's size allocates at most
    ``depth + 1`` buffers, rotated by ``reset()``."""
    sess = MatchSession(compile_patterns([b"needle!"]), max_chunks=4,
                        chunk_len=64, engine="dense", device="cpu")
    data = (b"x" * 997 + b"needle!") * 30
    depth = 4
    n0 = RECORDER.counters().get("feed.allocs", 0)
    got = sum(len(bm.events) for bm in
              sess.scan_stream(io.BytesIO(data), depth=depth))
    assert got == 30
    n1 = RECORDER.counters().get("feed.allocs", 0)
    assert 0 < n1 - n0 <= depth + 1
    DataBuffer(1, 16, 0)  # every allocation counts
    assert RECORDER.counters().get("feed.allocs", 0) == n1 + 1


# ------------------------------------------------- the benchmark's side


def test_offset_places_scan_spans_inside_their_marks(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench.trace import reduce

    write_flows(tmp_path / "flows", n_files=3)
    (tmp_path / "sigs").write_text(SIGS)
    from tpu_pattern_matching_torch.ushort import compile_signatures
    from tpu_pattern_matching_torch.runtime.buffers import UshortBuffer
    from tpu_pattern_matching_torch.runtime.feeder import Feeder

    sess = MatchSession(compile_signatures(str(tmp_path / "sigs")),
                        max_chunks=8, chunk_len=64, engine="bloom",
                        device="cpu")
    feeder = Feeder(sorted(str(p) for p in (tmp_path / "flows").iterdir()),
                    n_workers=2, max_chunks=8, chunk_len=64,
                    halo=sess.halo, buffer_factory=UshortBuffer)
    feeder.start()
    items = list(feeder)
    for it in items[:2]:  # scans before the profile, as a warm-up's
        sess.decode(it.batch, sess.scan(it.batch))
    stop = threading.Event()

    def busy():  # holds the interpreter lock as a feeder's parse does,
        while not stop.is_set():  # so the marks' edges wait for it
            sum(range(1000))

    spin = threading.Thread(target=busy)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(0.001)
    spin.start()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for it in items[2:6]:
                with record_function("scan"):
                    comp = sess.scan(it.batch)
                with record_function("decode"):
                    sess.decode(it.batch, comp)
    finally:
        stop.set()
        spin.join(timeout=60)
        sys.setswitchinterval(interval)
    assert not spin.is_alive()
    tr = reduce(prof, 4, 0, cuda=False)
    run = {"trace": tr, "unit": "tokens"}
    off = program_trace.offset_us(run)
    assert off is not None
    marks = sorted((s, e) for n, s, e in tr.marks if n == "scan")
    seqs = [it.batch.seq for it in items[2:6]]
    spans = {r.seq: r for r in RECORDER.spans(names="scan")}
    assert len(marks) == len(seqs) >= 4
    for (ms, me), q in zip(marks, seqs):
        r = spans[q]  # within the rounding of us as doubles
        assert ms - 1e-3 <= r.t0 / 1e3 + off and \
            r.t1 / 1e3 + off <= me + 1e-3, (
            ms, me, r.t0 / 1e3 + off, r.t1 / 1e3 + off)


class FakeRecorder(Recorder):
    """A recorder holding given records."""

    def __init__(self, records):
        super().__init__()
        for r in records:
            self.ring.append(r)


def rec_(name, t0, t1, tid=1, work=0, parts=None, seq=0):
    return SpanRecord(name, tid, seq, 0, 0, t0, t1, work, parts)


MS = 1_000_000  # ns


def synthetic_run(monkeypatch):
    """A window of [10, 110] ms, two feeder threads, and a profiled trace
    whose marks lie 5,000 us after the program's clock (us = ns / 1e3 +
    5,000) with the device idle over [5,000 + 20,000, 5,000 + 60,000] us
    but for one op at 40-50 ms."""
    records = [
        # thread 1: a visit inside the window, one at its edge, one outside
        rec_("feed.file", 20 * MS, 60 * MS, work=1000, parts={
            "open": 1 * MS, "read": 2 * MS, "parse": 20 * MS,
            "pack": 3 * MS}),
        rec_("feed.file", 100 * MS, 120 * MS, work=1000, parts={
            "read": 1 * MS, "parse": 4 * MS, "pack": 1 * MS}),
        rec_("feed.file", 200 * MS, 210 * MS, work=5000, parts={
            "parse": 9 * MS}),
        # thread 2
        rec_("feed.file", 30 * MS, 50 * MS, tid=2, work=2000, parts={
            "open": 1 * MS, "parse": 10 * MS}),
        rec_("feed.alloc", 60 * MS, 62 * MS),
        rec_("feed.close", 105 * MS, 108 * MS, work=3),
        rec_("feed.batch", 10 * MS, 70 * MS, parts={
            "cpu": 30 * MS, "put": 10 * MS, "threads": 2}),
        rec_("feed.batch", 10 * MS, 50 * MS, tid=2, parts={
            "cpu": 20 * MS, "put": 0, "threads": 2}),
        rec_("scan.upload", 40 * MS, 41 * MS, tid=3, work=4000),
        rec_("scan.upload", 80 * MS, 83 * MS, tid=3, work=2000),
        rec_("scan.upload", 300 * MS, 301 * MS, tid=3, work=99),
    ]
    # the harness's scan marks: 5 ms after the program's scan spans
    scans = [(10 * MS + k * 20 * MS, 11 * MS + k * 20 * MS)
             for k in range(4)]
    records += [rec_("scan", s, e, tid=3) for s, e in scans]
    fake = FakeRecorder(records)
    monkeypatch.setattr(program_trace, "recorder", lambda: fake)
    marks = [("scan", s / 1e3 + 5000, e / 1e3 + 5000) for s, e in scans]
    marks += [("decode", 70 * 1e3 + 5000, 80 * 1e3 + 5000)]
    ops = [("k", 5000 + 10e3, 5000 + 20e3), ("k", 5000 + 40e3, 5000 + 50e3),
           ("k", 5000 + 60e3, 5000 + 80e3)]
    tr = Trace(ops=ops, marks=marks, window_s=0.07, busy_s=0.04, gaps=[],
               batches=4, symbols=0)
    win = Record(feed_wait=[0.002, 0.0], scan=[0.001, 0.0],
                 decode=[0.0, 0.0], latency=[0.008, 0.0],
                 done=[0.020, 0.110], symbols=[1, 1])
    return {"unit": "tokens", "rec": win, "trace": tr, "symbols": 2,
            "batches": 2, "window_s": 0.1, "setup_s": 1.0,
            "probe_bound": None}


# hand-computed from synthetic_run: the window is [20 - 8 - 2, 110] ms;
# visits 1, 2 (its edge) and 4 overlap it; tokens 1000 + 1000 + 2000
SYNTHETIC = {
    # parse 20 + 4 + 10 ms over 4000 tokens
    "feed_parse_ms_per_Mtoken.ushort": 34e6 / 4000,
    # open + read 1 + 2 + 1 + 1 ms and the close's 3 ms
    "feed_read_ms_per_Mtoken.ushort": 8e6 / 4000,
    # pack 3 + 1 ms and the alloc's 2 ms
    "feed_pack_ms_per_Mtoken.ushort": 6e6 / 4000,
    # cpu 30 + 20 over (60 - 10) + 40 ms
    "feed_cpu_share.ushort": 50 / 90 * 100,
    # the two uploads in the window: 1 + 3 ms over 6000 tokens
    "scan_upload_ms_per_Mtoken.ushort": 4e6 / 6000,
    # on the program's clock the marks span 10-80 ms and the device is
    # idle over 20-40 and 50-60 ms (30 ms). Visit 1 (20-60 ms, parsing
    # half of it) lies over all 30 ms: 15 ms, over 2 threads; visit 4
    # (30-50 ms, half) over 10 ms of it: 5 ms, over 2
    "idle_parse_share.ushort": 10 / 30 * 100,
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_reader_on_a_synthetic_run(name, monkeypatch):
    run = synthetic_run(monkeypatch)
    reader = spec.metric_reader(os.path.join(REPO, "perfbench"), name)
    assert reader.read(run) == pytest.approx(SYNTHETIC[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_reader_reads_nothing_without_a_recorder(name, monkeypatch):
    run = synthetic_run(monkeypatch)
    monkeypatch.setattr(program_trace, "recorder", lambda: None)
    reader = spec.metric_reader(os.path.join(REPO, "perfbench"), name)
    assert reader.read(run) is None
    run = synthetic_run(monkeypatch)
    run["unit"] = "bytes"
    assert reader.read(run) is None
