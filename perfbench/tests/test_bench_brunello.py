"""The CRISPR screen's configuration (``brunello77k``) and mix
(``screen_fastq``): the library and FASTQ generators make what their
files state, the walk's frozen bound is ``chip_smoke``'s, its reader reads
what it says, and a tiny cell of the same shape (the dense walk on byte
lanes of FASTQ) runs correct on the CPU, reads every per-layer entry the
cell lists that needs no card, and fails the check with the control in
the program's place or the timed path broken."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from perfbench import spec
from perfbench.check import reference_events
from perfbench.control import short_signatures
from perfbench.harness import rng, run_cell
from perfbench.stream import Record
from perfbench.tests.conftest import HARNESS, REPO, make_root, tiny_cell
from perfbench.tests.test_bench_bytes import byte_bench
from perfbench.tests.test_bench_faults import FAULTS
from perfbench.trace import Trace

SEED = 2**31 + 1919
CELL = "brunello77k.screen_fastq"


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HARNESS, kind, f"{name}.json")) as f:
        return json.load(f)


def tiny_config() -> dict:
    """``brunello77k`` with a library of 300 guides and 256-byte lanes."""
    c = load("configs", "brunello77k")
    return dict(c, cli=["-B", "256", "-G", "64", "-w", "2", "-R", "32",
                        "--engine", "dense"],
                signatures=dict(c["signatures"], count=300))


def tiny_traffic() -> dict:
    """``screen_fastq`` in 4 files of 64 KiB."""
    return dict(load("traffic", "screen_fastq"), files=4, file_bytes=1 << 16,
                passes=2, warmup_batches=2, profile_batches=3,
                check_share=1.0)


def library(seed, count=2000):
    params = dict(load("configs", "brunello77k")["signatures"], count=count)
    return spec.generator(HARNESS, "sgrna_library").make(params, rng(seed, 1))


def fastq(seed, out, sigs):
    os.makedirs(out)
    return spec.generator(HARNESS, "sgrna_fastq").make(
        tiny_traffic(), sigs, rng(seed, 2), out)


def test_library_is_distinct_acgt_without_tttt():
    sigs = library(SEED)
    text = [s.tobytes() for s in sigs]
    assert len(text) == 2000 and len(set(text)) == 2000
    assert all(len(t) == 20 and set(t) <= set(b"ACGT") for t in text)
    assert not [t for t in text if b"TTTT" in t]
    assert [s.tobytes() for s in library(SEED)] == text
    assert [s.tobytes() for s in library(SEED + 1)] != text
    assert [s.tobytes() for s in library(-SEED)] != text  # any whole seed


def test_library_file_reads_back(tmp_path):
    """The CLI's reader takes the plain lines as the guides, in order,
    numbered by line."""
    from tpu_pattern_matching_torch.core.patterns import load_pattern_file

    sigs = library(SEED, 50)
    path = str(tmp_path / "library.txt")
    spec.generator(HARNESS, "sgrna_library").write(path, sigs)
    got = load_pattern_file(path)
    assert [p.data for p in got] == [s.tobytes() for s in sigs]
    assert [p.iid for p in got] == list(range(50))


def test_fastq_records(tmp_path):
    """Every record is four lines: a CASAVA 1.8 header, a read of 75 nt,
    ``+`` and 75 qualities of the six bins; every file is whole records
    of one length; each guided read holds the promoter and then its guide
    at its stated offset, unless an error fell in them."""
    t = tiny_traffic()
    sigs = library(SEED, 300)
    c = fastq(SEED, str(tmp_path / "a"), sigs)
    lines = b"".join(open(p, "rb").read() for p in c["paths"]).split(b"\n")
    assert lines[-1] == b""
    head, read, plus, qual = (lines[i:-1:4] for i in range(4))
    n = len(c["guide"])
    assert len(head) == len(read) == len(plus) == len(qual) == n
    casava = re.compile(rb"^@NB501950:\d{3}:H[A-Z0-9]{4}BGX9:[1-4]:[12][1-3]"
                        rb"[1-6]\d\d:\d{4}:\d{4} 1:N:0:[ACGT]{8}$")
    assert all(casava.match(h) for h in head)
    assert all(len(r) == 75 and set(r) <= set(b"ACGTN") for r in read)
    assert set(plus) == {b"+"}
    assert all(len(q) == 75 and set(q) <= set(b"EA<6/#") for q in qual)
    assert all(r[i] == ord("N") for r, q in zip(read, qual)
               for i in range(75) if q[i] == ord("#"))
    sizes = [os.path.getsize(p) for p in c["paths"]]
    assert len(set(sizes)) == 1 and sizes[0] <= t["file_bytes"]
    assert sizes[0] % 211 == 0 and n == 4 * (sizes[0] // 211)
    assert np.array_equal(c["starts"], np.arange(5) * sizes[0])
    tok, end, g = c["tokens"], c["guide_end"], c["guide"]
    assert (g == -1).sum() == 4 * round(0.05 * (n // 4))
    promoter = t["promoter"].encode()
    for i in np.flatnonzero(c["clean"]):
        assert tok[end[i] - 19:end[i] + 1].tobytes() == sigs[g[i]].tobytes()
    # the promoter before each guide (errors fall in it as anywhere)
    guided = np.flatnonzero(g >= 0)
    before = [tok[end[i] - 41:end[i] - 19].tobytes() for i in guided]
    assert np.mean([b == promoter for b in before]) > 0.9
    assert 0.8 < c["clean"].mean() < 0.95
    d = fastq(SEED, str(tmp_path / "b"), sigs)
    e = fastq(SEED + 1, str(tmp_path / "c"), sigs)
    assert np.array_equal(c["tokens"], d["tokens"])
    assert not np.array_equal(c["tokens"], e["tokens"])
    assert len(e["tokens"]) == len(c["tokens"])  # the same sizes


def test_clean_guides_are_the_reference_events(tmp_path):
    """The error-free guided reads' guides are exactly the reference's
    events: each at its guide's last base, nothing else."""
    sigs = library(SEED, 300)
    c = fastq(SEED, str(tmp_path / "a"), sigs)
    keys, pats = reference_events(c["tokens"], c["starts"], sigs, 8, "cpu")
    ok = c["clean"]
    want = np.lexsort((c["guide"][ok], c["guide_end"][ok]))
    assert np.array_equal(keys, c["guide_end"][ok][want])
    assert np.array_equal(pats, c["guide"][ok][want])


def test_walk_bound_is_chip_smokes():
    import chip_smoke
    from perfbench.roofline.walk import walk_bound

    for steps, sym, out in [(8388608, 1, 282240), (4194304, 2, 0),
                            (1, 1, 8), (123457, 1, 99)]:
        assert walk_bound(steps, sym, out) == chip_smoke.walk_bound(
            steps, sym, out)


def walk_run(ops, unit="bytes"):
    rec = Record(reported=[35000, 36000], symbols=[8 << 20, 8 << 20])
    tr = Trace(ops=ops, marks=[], window_s=1.0, busy_s=0.1, gaps=[],
               batches=8, symbols=64 << 20)
    return dict(unit=unit, symbols=16 << 20, rec=rec, trace=tr)


def test_walk_roofline_reads_the_walk_launches():
    read = spec.metric_reader(HARNESS, "walk_roofline.bytes").read
    walk = "void (anonymous namespace)::dense_walk_kernel<unsigned char, int>"
    ops = [(walk, 100.0 + 1000 * k, 400.0 + 1000 * k) for k in range(8)]
    ops.append(("Memcpy HtoD (Pageable -> Device)", 0.0, 2000.0))
    events = 71000 / (16 << 20) * (64 << 20)
    nbytes = (64 << 20) + round(events * 8)
    bound_ms = max(nbytes / 3.35e12, (64 << 20) * 5 / (132 * 64 * 1.98e9)) \
        * 1e3
    assert read(walk_run(ops)) == pytest.approx(bound_ms / 2.4 * 100,
                                                rel=1e-12)
    assert read(walk_run(ops[-1:])) is None  # no walk launch: a bloom run
    assert read(walk_run(ops, "tokens")) is None


@pytest.fixture(scope="module")
def screen_root(tmp_path_factory) -> str:
    """A root of the tiny screen cell, with the benchmark's own entries
    for ``brunello77k.screen_fastq``."""
    root = byte_bench(make_root(
        str(tmp_path_factory.mktemp("screen") / "root"),
        {"brunello77k": tiny_config()}, {"screen_fastq": tiny_traffic()},
        {CELL: ("brunello77k", "screen_fastq")}))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        mine = json.load(f)
    for k in ("end_to_end", "per_layer"):
        mine[k] = [m for m in bench[k]
                   if "workloads" not in m or CELL in m["workloads"]]
    with open(path, "w") as f:
        json.dump(mine, f)
    return root


def test_tiny_screen_run_is_correct(screen_root):
    line, numbers = run_cell(tiny_cell(screen_root, CELL), SEED, 1.0, False,
                             "cpu")
    assert line["correct"], numbers
    assert numbers["window_events"][0] > 0
    assert set(line["metrics"]) == {"scan_bytes_per_s", "setup_s"}


def test_tiny_screen_traced_reads_every_entry(screen_root):
    """A traced run reads every per-layer entry of the cell but the
    walk's roofline, which times a kernel of the card (the CPU runs the
    walk's plain version)."""
    cell = tiny_cell(screen_root, CELL)
    line, numbers = run_cell(cell, SEED + 1, 1.0, True, "cpu")
    assert line["correct"], numbers
    names = {m["name"] for m in cell.per_layer}
    assert len(names) == 6 and "walk_roofline.bytes" in names
    assert set(line["metrics"]) == names - {"walk_roofline.bytes"}
    assert 0 < line["metrics"]["device_idle_share.bytes"]["value"] < 100


@pytest.mark.parametrize("broken", ["stale", "half_batch", "altered"])
def test_broken_screen_path_is_not_correct(screen_root, broken):
    line, numbers = run_cell(tiny_cell(screen_root, CELL), SEED, 1.0, False,
                             "cpu", stand_in=FAULTS[broken])
    assert not line["correct"], numbers
    assert line["failed"] > 0


def test_tiny_screen_control_is_not_correct(screen_root):
    """Guides cut to 19 nt end a byte early: every event is missing and
    another is extra."""
    line, numbers = run_cell(tiny_cell(screen_root, CELL), SEED, 1.0, False,
                             "cpu", stand_in=short_signatures)
    assert not line["correct"], numbers
    assert numbers["missing_events"][0] == numbers["window_events"][0] > 0
    assert numbers["extra_events"][0] > 0


def test_configuration_states_its_source_and_cuts():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next(c for c in bench["configs"] if c["name"] == "brunello77k")
    c = load("configs", "brunello77k")
    assert "Doench" in c["source"] and "MAGeCK" in c["source"]
    assert set(entry["reduced"]) == set(c["reduced"]) == {"reads"}
    assert {"signatures", "pattern_file"} <= set(c["assumed"])
    t = load("traffic", "screen_fastq")
    assert {"read_length", "stagger", "abundance", "phix", "errors",
            "qualities", "header", "check_share"} <= set(t["assumed"])


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_screen_cell_runs_correct(card):
    r = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        CELL, "--seed", "2147484011", "--seconds", "3",
                        "--trace", "1"], cwd=REPO, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert 0 < line["metrics"]["walk_roofline.bytes"]["value"] <= 100
