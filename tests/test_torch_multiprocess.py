"""The port's CLIs as two processes of one mesh on the CPU (gloo), as
tests/test_multiprocess.py runs the reference's: ``--num-processes 2
--process-id p --coordinator ... --device cpu`` over 4 files. Each rank
reads its own files only and prints their matches; the union of the two
ranks' verbose lines equals the oracle, and rank 0 alone prints the STATS,
summed over both. With ``--pat-shards 2`` the ranks form the ("pat",
"data") grid: each column's first rank reads the column's files and
prints their matches, its other rank prints none. The rendezvous is a
``file://`` path in tmp, so concurrent test workers never share a port."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from tpu_pattern_matching.core.oracle import match_python
from tpu_pattern_matching_torch.cli import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FILES = 4
TIMEOUT_S = 300  # each rank is killed past it and the test fails
BYTE_LINE = re.compile(r"Pattern (\d+) \('[^']*'\) found in file '[^']*in(\d+)"
                       r"\.bin' at offset (\d+)")
USHORT_LINE = re.compile(r"Pattern (\d+) \('[^']*'\) found in file '[^']*"
                         r"flow(\d+)' at sequence offset (\d+)")


def one_process_stats(argv) -> dict:
    """The STATS of the same run in one process (this one)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port_main([*argv, "--device", "cpu", "--json-stats"]) == 0
    return json.loads(out.getvalue().splitlines()[-1])


def run_ranks(argv, tmp_path, world=2, code=0):
    """Every rank's (stdout, stderr); fails unless all exit ``code``."""
    url = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpu_pattern_matching_torch.cli", *argv,
         "--num-processes", str(world), "--process-id", str(r),
         "--coordinator", url, "--device", "cpu", "--json-stats"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=tmp_path,
        env=env, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == code, f"rank {r} exited {p.returncode}:\n{err}"
    return outs


def events_of(text, line):
    return {(int(m.group(2)), int(m.group(3)), int(m.group(1)))
            for m in line.finditer(text)}


def check_ranks(outs, line, want, single, world=2, shards=1):
    """Disjoint file ownership, the union equal to the oracle, and the
    summed STATS on rank 0 only, equal to the one-process run's
    ``single``. On a grid of ``shards`` pattern shards the file owners are
    the columns' first ranks."""
    union = set()
    columns = world // shards
    for r, (out, _err) in enumerate(outs):
        got = events_of(out, line)
        # worker 0 of column d's leader owns files d, d + columns, ...
        own = {i for i in range(N_FILES)
               if r % shards == 0 and i % columns == r // shards}
        assert got == {e for e in want if e[0] in own}, r
        union |= got
        stats = [ln for ln in out.splitlines() if ln.startswith("{")]
        assert bool(stats) == (r == 0), (r, stats)
    assert union == want and len(want) >= 8
    stats = json.loads([ln for ln in outs[0][0].splitlines()
                        if ln.startswith("{")][-1])
    assert stats["matches_total"] == len({(f, o) for f, o, _ in want})
    assert stats["matches_reported"] == len(want)
    for key in ("matches_total", "matches_reported", "bytes", "lines",
                "files"):
        assert stats[key] == single[key], key


@pytest.fixture
def byte_files(tmp_path):
    rng = np.random.RandomState(3)
    pats = [bytes(rng.randint(0, 256, size=8).astype(np.uint8))
            for _ in range(16)]
    (tmp_path / "pats.txt").write_text("".join(p.hex() + "\n" for p in pats))
    rng3 = np.random.RandomState(99)
    want, n_bytes = set(), 0
    for i in range(N_FILES):
        payload = bytearray(rng3.randint(0, 256, size=40000).astype(np.uint8))
        for pos in (50 + i, 9000 + 7 * i, 30000 + 11 * i):
            payload[pos : pos + 8] = pats[(pos + i) % 16]
        (tmp_path / f"in{i}.bin").write_bytes(bytes(payload))
        n_bytes += len(payload)
        for off, pidx in match_python(pats, bytes(payload)):
            want.add((i, off - len(pats[pidx]) + 1, pidx))
    files = ",".join(str(tmp_path / f"in{i}.bin") for i in range(N_FILES))
    return files, want, n_bytes


@pytest.mark.parametrize("engine", [
    ["--engine", "bloom"],
    ["--engine", "bloom", "--verify", "device"],
    ["--engine", "dense"],
], ids=["bloom-host", "bloom-device", "dense"])
def test_byte_cli_two_processes(engine, byte_files, tmp_path):
    files, want, n_bytes = byte_files
    argv = ["-f", files, "-p", str(tmp_path / "pats.txt"), "-x", "-v", "-B",
            "64", "-G", "512", "-w", "1", *engine]
    outs = run_ranks(argv, tmp_path)
    single = one_process_stats(argv)
    assert single["bytes"] == n_bytes
    check_ranks(outs, BYTE_LINE, want, single)


def test_ushort_cli_mesh_two_processes(tmp_path):
    rng = np.random.RandomState(17)
    sigs = [[int(x) for x in rng.randint(40, 1500, size=rng.randint(3, 6))]
            for _ in range(6)]
    (tmp_path / "sigs").write_text("".join(
        f"{','.join(map(str, s))}; {len(s)}; sig{k}\n"
        for k, s in enumerate(sigs)))
    want = set()
    for i in range(N_FILES):
        seq = rng.randint(0, 2048, size=3000)
        for pos in range(20 + i, 2900, 397):
            s = sigs[(pos + i) % len(sigs)]
            seq[pos : pos + len(s)] = s
        (tmp_path / f"flow{i}").write_text(",".join(map(str, seq)))
        for end, pidx in match_python(sigs, seq.tolist()):
            want.add((i, end - len(sigs[pidx]) + 1, pidx))
    files = ",".join(str(tmp_path / f"flow{i}") for i in range(N_FILES))
    argv = ["-f", files, "-p", str(tmp_path / "sigs"), "--ushort", "-v",
            "-B", "128", "-G", "32", "-w", "1"]
    outs = run_ranks(argv + ["--mesh", "all"], tmp_path)
    check_ranks(outs, USHORT_LINE, want, one_process_stats(argv))


@pytest.mark.parametrize("verify", ["host", "device"])
def test_byte_cli_grid_four_processes(verify, byte_files, tmp_path):
    # the ("pat", "data") grid: 4 ranks, 2 pattern shards, 2 lane columns
    files, want, n_bytes = byte_files
    argv = ["-f", files, "-p", str(tmp_path / "pats.txt"), "-x", "-v", "-B",
            "64", "-G", "512", "-w", "1", "--engine", "bloom", "--verify",
            verify, "--pat-shards", "2"]
    outs = run_ranks(argv, tmp_path, world=4)
    single = one_process_stats(argv)
    assert single["bytes"] == n_bytes
    check_ranks(outs, BYTE_LINE, want, single, world=4, shards=2)


def test_ushort_cli_grid_two_processes(tmp_path):
    rng = np.random.RandomState(23)
    sigs = [[int(x) for x in rng.randint(40, 1500, size=rng.randint(3, 6))]
            for _ in range(6)]
    (tmp_path / "sigs").write_text("".join(
        f"{','.join(map(str, s))}; {len(s)}; sig{k}\n"
        for k, s in enumerate(sigs)))
    want = set()
    for i in range(N_FILES):
        seq = rng.randint(0, 2048, size=3000)
        for pos in range(20 + i, 2900, 397):
            s = sigs[(pos + i) % len(sigs)]
            seq[pos : pos + len(s)] = s
        (tmp_path / f"flow{i}").write_text(",".join(map(str, seq)))
        for end, pidx in match_python(sigs, seq.tolist()):
            want.add((i, end - len(sigs[pidx]) + 1, pidx))
    files = ",".join(str(tmp_path / f"flow{i}") for i in range(N_FILES))
    # -G 128: the grid's batch (one column of 128 lanes), so that the one
    # process's batches, whose halos the ushort STATS bytes count, match
    argv = ["-f", files, "-p", str(tmp_path / "sigs"), "--ushort", "-v",
            "-B", "128", "-G", "128", "-w", "1", "--pat-shards", "2"]
    outs = run_ranks(argv, tmp_path)
    check_ranks(outs, USHORT_LINE, want, one_process_stats(argv), shards=2)


def test_grid_of_three_ranks_in_two_shards_exits_2(byte_files, tmp_path):
    # 3 ranks do not split into 2 pattern shards: every rank exits 2
    # before the rendezvous, with the message and no traceback
    files, _want, _n = byte_files
    outs = run_ranks(["-f", files, "-p", str(tmp_path / "pats.txt"), "-x",
                      "--pat-shards", "2"], tmp_path, world=3, code=2)
    for out, err in outs:
        assert not out and err.startswith(
            "ERROR: --pat-shards 2: 3 ranks do not split into 2 pattern "
            "shards") and "Traceback" not in err
