"""The byte configurations: the harness builds the byte grep CLI's session
as ``cli.run`` builds it, a tiny byte cell runs correct on the CPU and
fails the check when its timed path is broken or the control stands in,
its generators follow the seed, and the byte readers read what they
say. The runs take the plain versions of the
kernels; the look for a card is skipped (``run_cell`` is called
directly). On a card, a byte cell at the CLI's defaults over the
upstream's corpus shape runs correct and reads every byte reader."""

from __future__ import annotations

import json
import os
import types

import numpy as np
import pytest

from perfbench import spec, system
from perfbench.check import reference_events
from perfbench.control import short_signatures
from perfbench.harness import make_inputs, rng, run_cell
from perfbench.readings import GIB
from perfbench.tests.conftest import (HARNESS, TINY_CONFIGS,
                                      TINY_TRAFFIC, make_root, tiny_cell)
from perfbench.tests.test_bench_faults import FAULTS
from perfbench.tests.test_bench_moved import (FakeSession, read_all,
                                              recorded_run, recorder_of)

SEED = 2**31 + 8086
BYTE_CONFIGS = {
    "tinyb": {"unit": "bytes", "cli": ["-x", "-m", "12", "-B", "256", "-G",
                                       "128", "-w", "2", "-R", "16"],
              "pattern_limit": 12,
              "signatures": {"generator": "hex_sigs", "count": 300,
                             "min_len": 12, "max_len": 20}},
}
# The byte CLI's defaults with -m 12 (the upstream's ClamAV-15k point,
# README:71-83), on 15,000 random signatures that stand for no published
# set, and the upstream's corpus shape: 8 files of 32 MiB of random bytes
# (test.sh:1-11), 32 plants and 32 near misses a file.
DEFAULTS = {"unit": "bytes", "cli": ["-x", "-m", "12", "-B", "4096", "-G",
                                     "2048", "-w", "2", "-R", "16"],
            "pattern_limit": 12,
            "signatures": {"generator": "hex_sigs", "count": 15000,
                           "min_len": 12, "max_len": 12}}
UPSTREAM = {"generator": "urandom_files", "files": 8, "file_bytes": 1 << 25,
            "plants_per_file": 32, "near_misses_per_file": 32, "passes": 64,
            "warmup_batches": 2, "profile_batches": 8, "check_share": 1.0}
BYTE_TRAFFIC = {
    "cl": {"generator": "urandom_files", "files": 8, "file_bytes": 65536,
           "plants_per_file": 4, "near_misses_per_file": 4, "passes": 2,
           "warmup_batches": 2, "profile_batches": 3, "check_share": 1.0},
}
CELL = "tinyb.cl"
BYTE_READERS = ["feed_wait_ms_per_GiB.bytes", "scan_call_ms_per_GiB.bytes",
                "decode_call_ms_per_GiB.bytes",
                "scan_upload_ms_per_GiB.bytes", "probe_roofline.bytes",
                "device_idle_share.bytes"]


def byte_bench(root: str) -> str:
    """``root``'s ``BENCHMARK.json`` with ``scan_bytes_per_s`` end to end
    and every per-layer metric moving it."""
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    rate = next(m for m in bench["per_layer"]
                if m["name"] == "scan_bytes_per_s")
    bench["per_layer"].remove(rate)
    rate = dict(rate, bound=0.25, better="higher")
    del rate["layer"], rate["moves"]
    bench["end_to_end"].append(rate)
    for m in bench["per_layer"]:
        m["moves"] = "scan_bytes_per_s"
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(scope="module")
def byte_root(tmp_path_factory) -> str:
    """A root of the tiny byte cell (and the tiny ushort one), whose
    end-to-end metrics are ``scan_bytes_per_s`` and ``setup_s``."""
    return byte_bench(make_root(
        str(tmp_path_factory.mktemp("bytes") / "root"),
        dict(TINY_CONFIGS, **BYTE_CONFIGS), dict(TINY_TRAFFIC, **BYTE_TRAFFIC),
        {CELL: ("tinyb", "cl"), "tinyu.fl": ("tinyu", "fl")}))


def test_byte_build_is_the_clis(tmp_path, monkeypatch):
    """``system.build`` of a byte configuration gives the session and the
    feeder the arguments that ``cli.run`` gives them for the same
    argv."""
    from tpu_pattern_matching_torch import cli
    from tpu_pattern_matching_torch.runtime import session

    cfg = DEFAULTS
    gen = spec.generator(HARNESS, cfg["signatures"]["generator"])
    sigs = gen.make(cfg["signatures"], rng(SEED, 1))
    sig_path = str(tmp_path / "signatures.txt")
    gen.write(sig_path, sigs)
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "f").write_bytes(b"x")
    made = []

    class Session(FakeSession):
        _mesh_ctx = _grid = None
        engine = "bloom"

        def __init__(self, table, **kw):
            super().__init__(table, **kw)
            made.append(self)

    class Feeder:
        def start(self):
            pass

        def stop(self):
            pass

        def __iter__(self):
            return iter(())

    feeders = []

    def rank_feeder(sess, names, **kw):
        feeders.append((sess, kw))
        return Feeder()

    monkeypatch.setattr(session, "MatchSession", Session)
    monkeypatch.setattr(cli, "MatchSession", Session)
    monkeypatch.setattr(cli, "rank_feeder", rank_feeder)
    args = system.cli_args(cfg, str(tmp_path / "data"), sig_path, "cpu")
    device = types.SimpleNamespace(type="cuda")
    sess, make_feeder, iid_of = system.build(cfg, args, device)
    make_feeder(["f"])
    argv = ["-f", str(tmp_path / "data"), "-p", sig_path, "--device", "cpu",
            *cfg["cli"]]
    assert cli.run(cli.build_argparser().parse_args(argv)) == 0
    ours, clis = made
    assert ours.kw == dict(clis.kw, device=device)
    assert clis.kw["engine"] == "auto" and clis.kw["max_chunks"] == 2048
    assert clis.kw["chunk_len"] == 4096
    assert feeders[0][1] == feeders[1][1]
    assert feeders[0][1]["n_workers"] == 2
    assert [p.symbols for p in ours.table.patterns] == \
        [p.symbols for p in clis.table.patterns] == \
        [tuple(s.tolist()) for s in sigs]
    assert np.array_equal(iid_of, np.arange(len(sigs)))


def test_sound_byte_run_is_correct(byte_root):
    line, numbers = run_cell(tiny_cell(byte_root, CELL), SEED, 1.0, False,
                             "cpu")
    assert line["correct"], numbers
    assert numbers["window_events"][0] > 0
    assert set(line["metrics"]) == {"scan_bytes_per_s", "setup_s"}
    assert line["metrics"]["scan_bytes_per_s"]["value"] > 0


@pytest.mark.parametrize("broken", ["stale", "half_batch", "altered"])
def test_broken_byte_path_is_not_correct(byte_root, broken):
    line, numbers = run_cell(tiny_cell(byte_root, CELL), SEED, 1.0, False,
                             "cpu", stand_in=FAULTS[broken])
    assert not line["correct"], numbers
    assert line["failed"] > 0


def test_byte_control_is_not_correct(byte_root):
    line, numbers = run_cell(tiny_cell(byte_root, CELL), SEED, 1.0, False,
                             "cpu", stand_in=short_signatures)
    assert not line["correct"], numbers
    assert numbers["extra_events"][0] > 0
    assert numbers["missing_events"][0] > 0


def test_traced_byte_run_reads_the_byte_readers(byte_root):
    """A ``--trace 1`` run on the CPU: every byte reader that needs no
    card reads a number, and no ushort reader reads one."""
    line, numbers = run_cell(tiny_cell(byte_root, CELL), SEED + 1, 1.0, True,
                             "cpu")
    assert line["correct"], numbers
    got = line["metrics"]
    # the plain probe runs no kernel of the card for the roofline to time
    assert set(BYTE_READERS) - {"probe_roofline.bytes"} <= set(got)
    assert not [n for n in got if "ushort" in n or "token" in n.lower()]
    assert 0 < got["device_idle_share.bytes"]["value"] < 100
    assert line["device"]["busy_s"] > 0


def make(seed, out, sg=BYTE_CONFIGS["tinyb"]["signatures"]):
    gen = spec.generator(HARNESS, sg["generator"])
    sigs = gen.make(sg, rng(seed, 1))
    os.makedirs(os.path.join(out, "c"))
    gen.write(os.path.join(out, "sigs.txt"), sigs)
    corpus = spec.generator(HARNESS, "urandom_files").make(
        BYTE_TRAFFIC["cl"], sigs, rng(seed, 2), os.path.join(out, "c"))
    with open(os.path.join(out, "sigs.txt")) as f:
        text = f.read()
    files = [open(p, "rb").read() for p in corpus["paths"]]
    return sigs, text, corpus, files


def test_byte_generators_follow_the_seed(tmp_path):
    a = make(SEED, str(tmp_path / "a"))
    b = make(SEED, str(tmp_path / "b"))
    c = make(SEED + 1, str(tmp_path / "c"))
    d = make(-SEED, str(tmp_path / "d"))  # any whole seed
    assert a[1] == b[1] and a[3] == b[3]
    assert np.array_equal(a[2]["tokens"], b[2]["tokens"])
    assert a[1] != c[1] and a[3] != c[3] and d[3] != a[3]
    for x in (a, c, d):  # the same sizes for every seed
        assert [len(f) for f in x[3]] == [65536] * 8
        assert np.array_equal(x[2]["starts"], np.arange(9) * 65536)
        assert x[2]["bits"] == 8
        assert b"".join(x[3]) == x[2]["tokens"].tobytes()
        assert len(x[0]) == 300


def test_signature_file_reads_back(tmp_path):
    """The CLI's reader gives the signatures back, in order, cut to the
    configuration's -m limit, also where the first drawn one is digits
    alone in hex."""
    from tpu_pattern_matching_torch.core.patterns import load_pattern_file

    gen = spec.generator(HARNESS, "hex_sigs")
    sigs, text, _c, _f = make(SEED, str(tmp_path / "a"))
    got = load_pattern_file(str(tmp_path / "a" / "sigs.txt"), hex_pat=True,
                            pat_size_limit=12)
    assert [p.data for p in got] == [s[:12].tobytes() for s in sigs]
    assert [p.iid for p in got] == list(range(len(sigs)))
    assert len(text.splitlines()) == len(sigs)
    digits = np.array([0x12, 0x34, 0x56], np.uint8)

    class Draw:  # a first draw whose hex is digits alone
        def __init__(self):
            self.g = np.random.default_rng(1)

        def integers(self, lo, hi, size):
            return np.full(size, 3)

        def bytes(self, n):
            return digits.tobytes() + self.g.bytes(n - 3)

    sigs = gen.make({"count": 50, "min_len": 3, "max_len": 3}, Draw())
    assert not sigs[0].tobytes().hex().isdigit()
    assert any(np.array_equal(s, digits) for s in sigs)
    gen.write(str(tmp_path / "d.txt"), sigs)
    got = load_pattern_file(str(tmp_path / "d.txt"), hex_pat=True)
    assert [p.data for p in got] == [s.tobytes() for s in sigs]


def test_plants_and_near_misses(tmp_path):
    """Every file holds its plants, each found by the reference inside
    one file, and near misses (of signatures as long as the limit) that
    the reference finds nothing at."""
    sigs, _t, corpus, _f = make(SEED, str(tmp_path), dict(
        BYTE_CONFIGS["tinyb"]["signatures"], max_len=12))
    ref = [s[:12] for s in sigs]
    keys, pats = reference_events(corpus["tokens"], corpus["starts"], ref,
                                  8, "cpu")
    st = corpus["starts"]
    f = np.searchsorted(st, keys, "right") - 1
    assert np.bincount(f, minlength=8).min() == 4
    assert (keys - 11 >= st[f]).all()
    short = reference_events(corpus["tokens"], st, [s[:11] for s in ref], 8,
                             "cpu")[0]
    # an 11-byte prefix ends a byte before each whole one, and near
    # misses add more
    assert len(short) >= len(keys) + 8 * 4
    assert set((keys - 1).tolist()) <= set(short.tolist())


def test_inputs_of_the_byte_cell(byte_root, tmp_path):
    """The harness's inputs of a byte cell: signatures cut to the
    configuration's limit, the corpus of the traffic mix."""
    cell = tiny_cell(byte_root, CELL)
    inputs = make_inputs(cell, SEED, str(tmp_path))
    assert [len(s) for s in inputs.ref_sigs] == [12] * 300
    assert max(len(s) for s in inputs.sigs) > 12
    assert len(inputs.corpus["paths"]) == 8


def test_byte_readers_twin_the_ushort_ones(monkeypatch):
    """On one recorded run read as bytes, each byte reader reads what
    its ushort twin reads as tokens, per GiB where that is per million
    tokens; and nothing as tokens."""
    tokens = read_all(monkeypatch, "tokens")
    run, fake = recorded_run("bytes")
    from perfbench import program_trace

    monkeypatch.setattr(program_trace, "recorder", lambda: fake)

    def read(name, r=run):
        return spec.metric_reader(HARNESS, name).read(r)

    per = GIB / 1e6
    for b, u in [("feed_wait_ms_per_GiB.bytes",
                  "feed_wait_ms_per_Mtoken.ushort"),
                 ("scan_call_ms_per_GiB.bytes",
                  "scan_call_ms_per_Mtoken.ushort"),
                 ("decode_call_ms_per_GiB.bytes",
                  "decode_call_ms_per_Mtoken.ushort"),
                 ("scan_upload_ms_per_GiB.bytes",
                  "scan_upload_ms_per_Mtoken.ushort")]:
        assert read(b) == pytest.approx(tokens[u] * per, rel=1e-12)
    for b, u in [("probe_roofline.bytes", "probe_roofline.ushort"),
                 ("device_idle_share.bytes", "device_idle_share.ushort"),
                 ("scan_bytes_per_s", "scan_tokens_per_s")]:
        assert read(b) == tokens[u]
    run_t, _ = recorded_run("tokens")
    for name in BYTE_READERS + ["scan_bytes_per_s"]:
        assert read(name, run_t) is None


def test_upload_reader_reads_the_kept_part(monkeypatch):
    """Where the program's ring dropped the window's first records, the
    upload reader reads the ``scan.upload`` spans that begin after the
    end of the ring's oldest record."""
    from perfbench import program_trace

    run, whole = recorded_run("bytes")
    records = list(whole.ring)
    ring = recorder_of(records)
    ring.ring = type(ring.ring)(records, maxlen=len(records) // 3)
    monkeypatch.setattr(program_trace, "recorder", lambda: ring)
    cut = ring.ring[0].t1
    lo, hi = program_trace.window_ns(run)
    kept = [r for r in records if r.name == "scan.upload" and
            r.t0 >= max(cut, lo) and r.t1 <= hi]
    assert 0 < len(kept) < run["batches"]
    want = sum(r.t1 - r.t0 for r in kept) / 1e6 / (
        sum(r.work for r in kept) / GIB)
    got = spec.metric_reader(HARNESS, "scan_upload_ms_per_GiB.bytes").read(
        run)
    assert got == pytest.approx(want, rel=1e-12)
    assert program_trace.window_spans(run, "scan.upload", "bytes") is None


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_byte_cell_runs_correct(card, tmp_path):
    """A byte cell at the CLI's defaults over the upstream's corpus shape,
    once untraced and once traced: correct, and every byte reader reads
    a number, the probe's roofline share at most 100%."""
    root = byte_bench(make_root(
        str(tmp_path / "root"), {"defaults": DEFAULTS}, {"upstream": UPSTREAM},
        {"defaults.upstream": ("defaults", "upstream")}))
    cell = tiny_cell(root, "defaults.upstream")
    line, numbers = run_cell(cell, 2147483999, 3.0, False, "cuda")
    assert line["correct"], numbers
    assert line["device"]["platform"] == "gpu"
    assert numbers["window_events"][0] > 0
    line, numbers = run_cell(cell, 2147484001, 3.0, True, "cuda")
    assert line["correct"], numbers
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(BYTE_READERS) <= set(got), got
    assert 0 < got["probe_roofline.bytes"] <= 100
