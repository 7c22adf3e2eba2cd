"""The port's ``benchmarks.run_configs`` against the reference's
``benchmarks/run_configs.py`` on the CPU: its helpers give the reference's
bytes and signatures, and configs 1-6 at reduced sizes (1 MiB files, a
tenth of the signatures; the same in both packages) report the
reference's events, states, rounds and parity. Config 5 also runs as two
gloo ranks. Every compared field is an exact count or flag (tolerance 0);
wall times and rates are not compared."""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_pattern_matching_torch.benchmarks import run_configs as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_SIGS = {2000: 200, 10_000: 500, 15_000: 600}
SMALL_MIB = 1
FIELDS = ("config", "parity", "events", "bytes", "states", "sigs",
          "matches", "rounds", "group_events", "bloom_engine_agrees",
          "device_verify_agrees", "text_bytes", "tokens")


def load_reference():
    """A fresh copy of the reference's ``benchmarks/run_configs.py``."""
    spec = importlib.util.spec_from_file_location(
        "reference_run_configs",
        os.path.join(REPO, "benchmarks", "run_configs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reduced_reference(monkeypatch):
    """The reference at the reduced sizes, its lines collected."""
    ref = load_reference()
    lines = []
    orig_file, orig_sigs = ref._random_file, ref._sig_set
    monkeypatch.setattr(ref, "_random_file", lambda path, mib, seed:
                        orig_file(path, SMALL_MIB, seed))
    monkeypatch.setattr(ref, "_sig_set", lambda n, seed, length, limit=-1:
                        orig_sigs(SMALL_SIGS[n], seed, length, limit))
    monkeypatch.setattr(ref, "emit", lambda name, **kw: lines.append(
        {"config": name, **kw}))
    return ref, lines


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Every config's lines from both packages, each in its own data
    directory."""
    mp = pytest.MonkeyPatch()
    try:
        ref, want = reduced_reference(mp)
        rdir = str(tmp_path_factory.mktemp("ref_data"))
        for c in (1, 2, 3, 4, 5, 6):
            {1: ref.config1, 2: lambda: ref.config2(rdir),
             3: lambda: ref.config3(rdir), 4: lambda: ref.config4(rdir),
             5: ref.config5, 6: lambda: ref.config6(rdir)}[c]()
        mp.setattr(port, "MIB", SMALL_MIB)
        mp.setattr(port, "SIGS", {k: SMALL_SIGS[v] for k, v in
                                  port.SIGS.items()})
        pdir = str(tmp_path_factory.mktemp("port_data"))
        got = port.run([1, 2, 3, 4, 6], pdir, "cpu")
    finally:
        mp.undo()
    return want, got, rdir, pdir


def by_name(lines, prefix):
    (line,) = [x for x in lines if x["config"].startswith(prefix)]
    return line


@pytest.mark.parametrize("prefix", ["1_", "2_", "3_", "4_", "6_", "6u_"])
def test_config_lines_equal_the_reference(both, prefix):
    want, got, _, _ = both
    w, g = by_name(want, prefix), by_name(got, prefix)
    assert list(g) == list(w)
    for key in FIELDS:
        assert g.get(key) == w.get(key), key
    if "parity" in w:
        assert g["parity"] is True


def test_data_files_equal_the_reference(both):
    _, _, rdir, pdir = both
    names = sorted(os.listdir(rdir))
    assert names == sorted(os.listdir(pdir))
    assert "flow_tokens.txt" in names and "32MB.7p.bin" in names
    for name in names:  # planted files included
        with open(os.path.join(rdir, name), "rb") as a, \
                open(os.path.join(pdir, name), "rb") as b:
            assert hashlib.sha256(a.read()).digest() == hashlib.sha256(
                b.read()).digest(), name


@pytest.mark.parametrize("n,seed,length", [(5, 2, 16), (40, 3, 16),
                                           (7, 4, 12)])
def test_hex_sigs_and_random_file_equal_the_reference(tmp_path, n, seed,
                                                      length):
    ref = load_reference()
    assert port._hex_sigs(n, seed, length) == ref._hex_sigs(n, seed, length)
    a = port._random_file(str(tmp_path / "a.bin"), 1, seed)
    b = ref._random_file(str(tmp_path / "b.bin"), 1, seed)
    assert open(a, "rb").read() == open(b, "rb").read()
    sigs = port._hex_sigs(n, seed, length)
    port._plant(a, sigs, 50)
    ref._plant(b, sigs, 50)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_sig_set_reads_upstream_sets_as_the_reference(tmp_path,
                                                      monkeypatch):
    ref = load_reference()
    d = tmp_path / "clamav_sample_sigs"
    d.mkdir()
    rng = np.random.RandomState(9)
    (d / "20.txt").write_text("".join(
        bytes(rng.randint(0, 256, size=int(rng.randint(8, 30))).astype(
            np.uint8)).hex() + "\n" for _ in range(20)))
    monkeypatch.setattr(ref, "CLAMAV_DIR", str(d))
    monkeypatch.setenv("TPM_UPSTREAM_DIR", str(tmp_path))
    for limit in (-1, 12):
        got = port._sig_set(20, seed=2, length=16, limit=limit)
        assert got == ref._sig_set(20, seed=2, length=16, limit=limit)
        assert got[1] == "clamav"
    monkeypatch.delenv("TPM_UPSTREAM_DIR")
    monkeypatch.setattr(ref, "CLAMAV_DIR", str(tmp_path / "missing"))
    got = port._sig_set(20, seed=2, length=16, limit=12)
    assert got == ref._sig_set(20, seed=2, length=16, limit=12)
    assert got[1] == "synthetic"


def test_config5_one_rank_agrees_with_the_reference(both, capsys):
    want, _, _, _ = both
    w = by_name(want, "5_")
    assert port.main(["--config", "5", "--device", "cpu"]) == 0
    g = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(g) == list(w)
    assert g["devices"] == 1
    for key in FIELDS:
        assert g.get(key) == w.get(key), key
    assert g["bloom_engine_agrees"] and g["device_verify_agrees"]


def test_config5_two_ranks_agree_with_the_reference(both, tmp_path):
    want, _, _, _ = both
    w = by_name(want, "5_")
    url = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "tpu_pattern_matching_torch.benchmarks.run_configs", "--config",
         "5", "--device", "cpu", "--num-processes", "2", "--process-id",
         str(r), "--coordinator", url],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    logs = "\n".join(f"rank {r}: rc {p.returncode}\n{o}\n{e}"
                     for r, (p, (o, e)) in enumerate(zip(procs, outs)))
    assert all(p.returncode == 0 for p in procs), logs
    g = json.loads(outs[0][0].strip().splitlines()[-1])
    assert outs[1][0].strip() == "", logs  # rank 0 alone prints
    assert g["devices"] == 2
    for key in FIELDS:
        assert g.get(key) == w.get(key), key


def test_config4_matches_are_held_to_the_oracle(both, monkeypatch):
    """Config 4's matches must equal the native oracle's events over its
    four files (0 on these unplanted files, in both packages); an oracle
    that counts one event a file fails the run."""
    _, got, _, pdir = both
    assert by_name(got, "4_")["matches"] == 0
    monkeypatch.setattr(port, "MIB", SMALL_MIB)
    monkeypatch.setattr(port, "SIGS", {k: SMALL_SIGS[v] for k, v in
                                       port.SIGS.items()})
    monkeypatch.setattr(port, "oracle_match_ends", lambda sigs, data: 1)
    with pytest.raises(RuntimeError, match="config 4: 0 matches, the "
                                           "native oracle 4 events"):
        port.config4(pdir, "cpu")


def test_multi_rank_runs_config5_only(capsys):
    assert port.main(["--config", "2", "--device", "cpu",
                      "--num-processes", "2", "--process-id", "0",
                      "--coordinator", "localhost:1"]) == 2
    assert "config 5 only" in capsys.readouterr().err


def test_without_a_card_it_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request is honoured")
    with pytest.raises(SystemExit) as e:
        port.main(["--config", "1"])
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
