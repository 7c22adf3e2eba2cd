"""What the benchmark reads in ``ushort2k.long_flows`` stays as it was
when the harness learnt byte configurations: the ushort CLI's session,
arguments and feeder that ``system.build`` makes for the configuration,
and each ushort reader's value on one fixed recorded run. The expected
values were taken from the harness before it took byte configurations."""

from __future__ import annotations

import json
import os
import types

import numpy as np
import pytest

from perfbench import spec, system
from perfbench.harness import rng
from perfbench.readings import GIB
from perfbench.stream import Record
from perfbench.tests.conftest import HARNESS
from perfbench.trace import Trace

USHORT_ARGS = {
    "chunk_size": 4096, "global_ws": 2048, "local_ws": 0, "dev_pos": None,
    "pat_size_limit": -1, "thread_no": 2, "max_results": 16,
    "verbose": False, "text_mode": False, "hex_pat": False, "follow": False,
    "mapped": False, "nocase": False, "ushort": True, "sort": False,
    "sort_global": False, "mesh": None, "pat_shards": 1,
    "coordinator": None, "num_processes": 1, "process_id": None,
    "engine": "auto", "verify": "auto", "save_dfa": None, "load_dfa": None,
    "save_bloom": None, "load_bloom": None, "json_stats": False,
    "profile": None, "device": "cpu"}


class FakeSession:
    """Stands in for ``MatchSession``: keeps what it was built with."""

    local_chunks, halo = 2048, 30

    def __init__(self, table, **kw):
        self.table, self.kw = table, kw


def ushort2k():
    with open(os.path.join(HARNESS, "configs", "ushort2k.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("kind,engine", [("cuda", "bloom"), ("cpu", "dense")])
def test_ushort_session_args_and_feeder_as_before(tmp_path, monkeypatch,
                                                  kind, engine):
    from tpu_pattern_matching_torch import cli
    from tpu_pattern_matching_torch.runtime import session
    from tpu_pattern_matching_torch.runtime.buffers import UshortBuffer

    cfg = ushort2k()
    gen = spec.generator(HARNESS, cfg["signatures"]["generator"])
    sigs = gen.make(cfg["signatures"], rng(2**31 + 17, 1))
    sig_path = str(tmp_path / "signatures.txt")
    gen.write(sig_path, sigs)
    args = system.cli_args(cfg, str(tmp_path), sig_path, "cpu")
    got_args = {k: v for k, v in vars(args).items()
                if k not in ("data_path", "pat_path")}
    assert got_args == USHORT_ARGS
    feeders = []
    monkeypatch.setattr(session, "MatchSession", FakeSession)
    monkeypatch.setattr(cli, "rank_feeder",
                        lambda sess, names, **kw: feeders.append(
                            (sess, names, kw)) or "feeder")
    device = types.SimpleNamespace(type=kind)
    sess, make_feeder, iid_of = system.build(cfg, args, device)
    assert sess.kw == dict(max_chunks=2048, chunk_len=2048, max_results=16,
                           sort=False, engine=engine, verify="auto",
                           device=device, pat_shards=1, mesh=None)
    assert sess.table.alphabet_size == 2048
    assert len(sess.table.patterns) == 2000
    assert np.array_equal(iid_of, np.arange(2000))
    assert iid_of.dtype == np.int64
    assert make_feeder(["a", "b"]) == "feeder"
    assert feeders == [(sess, ["a", "b"], dict(
        n_workers=2, max_chunks=2048, chunk_len=2048, halo=30, follow=False,
        buffer_factory=UshortBuffer))]


def recorder_of(records):
    """The program's recorder, holding ``records`` alone."""
    from tpu_pattern_matching_torch.runtime.tracing import Recorder

    rec = Recorder()
    rec.ring.extend(records)
    return rec


def recorded_run(unit: str):
    """One fixed run: 40 batches of a window that opens at 10 s, their
    harness spans, a trace of 8 of them, and the program's records."""
    from tpu_pattern_matching_torch.runtime.tracing import SpanRecord

    g = np.random.default_rng(20241018)
    n = 40
    feed_wait = (g.random(n) * 0.05).tolist()
    scan = (0.01 + g.random(n) * 0.01).tolist()
    decode = (0.002 + g.random(n) * 0.002).tolist()
    t, done, latency = 10.0, [], []
    for k in range(n):
        t += feed_wait[k] + scan[k]
        latency.append(scan[k] + decode[k] + 0.001)
        done.append(t + decode[k] + 0.001)
        t = done[-1]
    latency[0] = done[0] - 10.0 - feed_wait[0]
    symbols = g.integers(1 << 22, 1 << 23, size=n).tolist()
    rec = Record(feed_wait=feed_wait, scan=scan, decode=decode,
                 latency=latency, done=done, symbols=symbols)

    records, ident = [], iter(range(1, 1 << 20))

    def add(name, tid, t0, t1, work=0, parts=None):
        records.append(SpanRecord(name, tid, -1, 0, next(ident),
                                  int(t0 * 1e9), int(t1 * 1e9), work, parts))

    for tid in (101, 102):
        add("feed.worker", tid, 9.0, done[-1] + 1)
        t0 = 9.5 + tid / 1000
        while t0 < done[-1] + 0.5:
            dt = 0.03 + g.random() * 0.04
            add("feed.batch", tid, t0, t0 + dt, parts={
                "cpu": int(dt * 0.8e9), "put": int(dt * 0.05e9),
                "threads": 2})
            for j in range(3):
                a = t0 + dt * j / 4
                add("feed.file", tid, a, a + dt / 5, work=int(1e6 + j),
                    parts={"open": 20000 + j, "read": 400000 + 7 * j,
                           "parse": 900000 + 11 * j, "pack": 50000 + j})
            add("feed.alloc", tid, t0 + dt * 0.8, t0 + dt * 0.85)
            add("feed.put", tid, t0 + dt * 0.9, t0 + dt * 0.95)
            t0 += dt
        add("feed.close", tid, done[-1] + 0.9, done[-1] + 0.95, work=64)
    marks, ops = [], []
    for k in range(n):
        s0 = done[k] - latency[k]
        add("scan", 1, s0, s0 + scan[k], work=symbols[k])
        add("scan.upload", 1, s0 + 1e-4, s0 + 1e-4 + scan[k] / 10,
            work=symbols[k])
        if 20 <= k < 28:  # profiled: the trace's axis is 5 ms ahead
            us = (s0 + 0.005) * 1e6
            marks.append(("scan", us, us + scan[k] * 1e6))
            marks.append(("decode", us + scan[k] * 1e6 + 10,
                          us + scan[k] * 1e6 + 10 + decode[k] * 1e6))
            ops.append(("void probe_strided_kernel<unsigned short>", us + 50,
                        us + 170))
            ops.append(("Memcpy HtoD (Pageable -> Device)", us + 10,
                        us + 45))
    w0 = min(s for _n, s, _e in marks)
    w1 = max(e for _n, _s, e in marks)
    tr = Trace(ops=ops, marks=marks, window_s=(w1 - w0) / 1e6,
               busy_s=sum(e - s for _n, s, e in ops) / 1e6, gaps=[],
               batches=8, symbols=sum(symbols[20:28]))
    run = dict(unit=unit, symbols=int(sum(symbols)), batches=n,
               window_s=done[-1] - 10.0, setup_s=12.5, rec=rec, trace=tr,
               probe_bound={"bound_ms": 0.02})
    return run, recorder_of(records)


# each ushort reader on the recorded run, as the harness read it before
USHORT_READINGS = {
    "batch_latency_p95_ms.ushort": 23.679550637811925,
    "decode_call_ms_per_Mtoken.ushort": 0.4668226727468662,
    "device_idle_share.ushort": 99.68529645634054,
    "feed_cpu_share.ushort": 84.21052437887019,
    "feed_pack_ms_per_Mtoken.ushort": 0.8858942518287631,
    "feed_parse_ms_per_Mtoken.ushort": 0.9000100534462141,
    "feed_read_ms_per_Mtoken.ushort": 0.42000754506161414,
    "feed_wait_ms_per_Mtoken.ushort": 3.9872272845614978,
    "idle_parse_share.ushort": 5.428612110280193,
    "probe_roofline.ushort": 16.666666666666664,
    "scan_call_ms_per_Mtoken.ushort": 2.3026314766938634,
    "scan_tokens_per_s": 144742870.59663835,
    "scan_upload_ms_per_Mtoken.ushort": 0.23026315459209437,
    "setup_s": 12.5,
}


def read_all(monkeypatch, unit):
    from perfbench import program_trace

    run, fake = recorded_run(unit)
    monkeypatch.setattr(program_trace, "recorder", lambda: fake)
    return {name: spec.metric_reader(HARNESS, name).read(run)
            for name in USHORT_READINGS}


def test_ushort_readers_read_as_before(monkeypatch):
    got = read_all(monkeypatch, "tokens")
    assert got == USHORT_READINGS


def test_ushort_readers_read_nothing_of_bytes(monkeypatch):
    got = read_all(monkeypatch, "bytes")
    assert got.pop("setup_s") == 12.5
    assert set(got.values()) == {None}, got
