"""The port's CLI (``python -m tpu_pattern_matching_torch.cli``,
``torch_aho_grep``) against the reference CLI (``tpu_aho_grep``) on the
same files, on the CPU (``--device cpu``).

- The verbose "Pattern ..." lines with their context echo, the STATS block
  and ``--json-stats`` equal the reference's line for line (timing fields
  aside) in byte mode (binary, ``-t``, ``-x``, ``-i``, ``-m``, multi-file
  ``-w 2``, directory input, ``--sort-global``, saved and loaded DFA and
  bloom dumps) and in ``--ushort`` mode on the 3-signature fixture, and
  with ``--pat-shards`` in both modes; a sharded ``--save-bloom`` dump of
  either package loads with ``--load-bloom`` in the other.
- ``check_args`` and the other early exits print the reference's messages
  and exit 2; the not-ported multi-device flags exit 2 naming their ROADMAP
  item; ``--device cuda`` without a GPU exits 2.
- ``--profile`` writes a trace; ``-F`` follows a growing file and drains on
  SIGINT (a subprocess, polled).
- ``engine.best_scan_total_fn`` equals the reference's totals."""

import json
import os
import select
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tests.fixtures import random_words_corpus
from tpu_pattern_matching.cli import main as ref_main
from tpu_pattern_matching_torch.cli import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIGS = """40,32,287,32,106,196; 6; File scanner (metasploit file scanning)
40,32,287,32,106,186,32; 7; Directory scanner
5,5,5; 3; triple five
"""


def stable(out: str) -> list[str]:
    """The output's lines without its timing fields."""
    lines = []
    for ln in out.split("\n"):
        if ln.startswith(("Time (secs):", "Throughput (Mbps):")):
            continue
        if ln.startswith("{"):
            d = json.loads(ln)
            d.pop("wall_us")
            d.pop("throughput_mbps")
            # the port's span totals and counters: the reference has none
            d.pop("spans", None)
            d.pop("counters", None)
            ln = json.dumps(d, sort_keys=True)
        lines.append(ln)
    return lines


def both(argv, capsys):
    """(reference lines, port lines) of one argv; both exit 0."""
    assert ref_main(argv) == 0
    ref = stable(capsys.readouterr().out)
    assert port_main(argv + ["--device", "cpu"]) == 0
    return ref, stable(capsys.readouterr().out)


@pytest.fixture
def corpus(tmp_path):
    pats, text = random_words_corpus(seed=7, n_lines=120, plant_every=8)
    pats = pats + [b"Zebra", b"mixed CASE"]
    text += b"a zebra, a ZEBRA and mixed case\n" * 3
    (tmp_path / "p.txt").write_bytes(b"\n".join(pats) + b"\n")
    (tmp_path / "p.hex").write_text("\n".join(p.hex() for p in pats) + "\n")
    cut = [0, len(text) // 3, 2 * len(text) // 3, len(text)]
    d = tmp_path / "dir"
    d.mkdir()
    for i in range(3):
        (d / f"part{i}").write_bytes(text[cut[i] : cut[i + 1]])
    (tmp_path / "all.txt").write_bytes(text)
    return tmp_path


CASES = {  # name: (input, extra flags); -B 64 -G 16 --json-stats -v always
    "binary-bloom": ("all.txt", ["--engine", "bloom", "-w", "1"]),
    "binary-dense": ("all.txt", ["--engine", "dense", "-w", "1"]),
    "binary-device-verify": ("all.txt", ["--engine", "bloom", "--verify",
                                         "device", "-w", "1"]),
    "text": ("all.txt", ["-t", "--engine", "bloom", "-w", "1"]),
    "hex": ("all.txt", ["-x", "--engine", "dense", "-w", "1"]),
    "nocase": ("all.txt", ["-i", "--engine", "bloom", "-w", "1"]),
    "size-limit": ("all.txt", ["-m", "4", "--engine", "dense", "-w", "1"]),
    "multi-file-w2": ("dir/part0,dir/part1,dir/part2",
                      ["-w", "2", "--sort-global", "--engine", "bloom"]),
    "directory": ("dir", ["-w", "1", "--engine", "dense", "--sort"]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_verbose_lines_and_stats_equal_reference(name, corpus, capsys,
                                                 monkeypatch):
    monkeypatch.chdir(corpus)
    inp, extra = CASES[name]
    pat = "p.hex" if "-x" in extra else "p.txt"
    argv = ["-f", inp, "-p", pat, "-B", "64", "-G", "16", "-v",
            "--json-stats"] + extra
    ref, port = both(argv, capsys)
    assert port == ref
    assert sum(ln.startswith("Pattern ") for ln in port) >= 3


def test_save_and_load_dfa_and_bloom(corpus, capsys, monkeypatch):
    monkeypatch.chdir(corpus)
    base = ["-f", "all.txt", "-B", "64", "-G", "16", "-v", "-w", "1",
            "--engine", "bloom"]
    assert port_main(base + ["-p", "p.txt", "--save-dfa", "t.npz",
                             "--save-bloom", "b.npz", "--device",
                             "cpu"]) == 0
    built = stable(capsys.readouterr().out)
    ref, port = both(base + ["--load-dfa", "t.npz", "--load-bloom", "b.npz"],
                     capsys)
    assert port == ref == built
    assert port_main(base + ["-p", "p.txt", "--engine", "dense",
                             "--save-bloom", "x.npz", "--device",
                             "cpu"]) == 0
    assert "--save-bloom ignored" in capsys.readouterr().err


@pytest.mark.parametrize("engine", ["bloom", "dense"])
def test_ushort_fixture_equals_reference(engine, tmp_path, capsys,
                                         monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "sigs").write_text(SIGS)
    d = tmp_path / "flows"
    d.mkdir()
    (d / "10.0.0.1_444_10.0.0.2_443_tcp").write_text("7,40,32,287,32,106,196,9")
    (d / "10.0.0.3_80_10.0.0.4_443_tcp").write_text(
        "5,5,5,5, 40,32,287,32,106,186,32")
    ref, port = both(["-f", "flows", "-p", "sigs", "--ushort", "-v", "-B",
                      "64", "-G", "16", "-w", "1", "--json-stats",
                      "--engine", engine], capsys)
    assert port == ref
    assert sum(ln.startswith("Pattern ") for ln in port) == 4


def test_profile_writes_a_trace(corpus, capsys, monkeypatch):
    monkeypatch.chdir(corpus)
    assert port_main(["-f", "all.txt", "-p", "p.txt", "-B", "64", "-G", "16",
                      "--profile", "prof", "--device", "cpu"]) == 0
    files = os.listdir(corpus / "prof")
    assert files and all(f.endswith(".json") for f in files)
    assert json.loads((corpus / "prof" / files[0]).read_text())["traceEvents"]


BAD_ARGS = {  # name: argv (after -f all.txt)
    "threads": ["-p", "p.txt", "-w", "0"],
    "size-limit-low": ["-p", "p.txt", "-m", "0"],
    "size-limit-high": ["-p", "p.txt", "-m", "5000"],
    "results": ["-p", "p.txt", "-R", "0"],
    "chunk": ["-p", "p.txt", "-B", "0"],
    "sort-global-follow": ["-p", "p.txt", "--sort-global", "-F"],
    "missing-patterns": ["-p", "nope.txt"],
    "no-pattern-file": [],
    "empty-pattern-file": ["-p", "empty.txt"],
    "missing-input": ["-p", "p.txt", "-f", "nope.bin"],
}


@pytest.mark.parametrize("name", list(BAD_ARGS))
def test_early_exits_equal_reference(name, corpus, capsys, monkeypatch):
    monkeypatch.chdir(corpus)
    (corpus / "empty.txt").write_text("")
    argv = ["-f", "all.txt"] + BAD_ARGS[name]
    got = []
    for main, extra in ((ref_main, []), (port_main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(argv + extra)
        got.append((e.value.code, capsys.readouterr().err))
    assert got[0] == got[1]
    assert got[1][0] == 2 and got[1][1].startswith("ERROR")


def test_unaligned_sizes_warn_like_reference(corpus, capsys, monkeypatch):
    monkeypatch.chdir(corpus)
    argv = ["-f", "all.txt", "-p", "p.txt", "-B", "60", "-G", "10", "-L", "3",
            "--engine", "dense"]
    assert ref_main(argv) == 0
    ref = capsys.readouterr()
    assert port_main(argv + ["--device", "cpu"]) == 0
    port = capsys.readouterr()
    assert port.err == ref.err and port.err.count("WARNING") == 3
    assert stable(port.out) == stable(ref.out)


@pytest.mark.parametrize("flags,item", [
    # the ("pat", "data") grid (item 11b) is ported: its world size must
    # be a multiple of the shards, else exit 2 before any process group
    pytest.param(["--mesh", "all", "--pat-shards", "2"],
                 "--pat-shards 2: 1 ranks do not split into 2 pattern shards",
                 id="flags0-item 11"),
    # --pat-shards (item 10) is ported: the run equals the reference's
    pytest.param(["--pat-shards", "2"], None, id="flags1-item 10"),
    pytest.param(["--num-processes", "3", "--process-id", "0",
                  "--pat-shards", "2"],
                 "--pat-shards 2: 3 ranks do not split into 2 pattern shards",
                 id="flags2-item 11"),
])
def test_not_ported_flags_exit_2(flags, item, corpus, capsys, monkeypatch):
    monkeypatch.chdir(corpus)
    argv = ["-f", "all.txt", "-p", "p.txt", "-B", "64", "-G", "16", "-v",
            "-w", "1"]
    if item is None:
        ref, port = both(argv + flags, capsys)
        assert port == ref and any(ln.startswith("Pattern ") for ln in port)
        return
    with pytest.raises(SystemExit) as e:
        port_main(argv + ["--device", "cpu"] + flags)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert err.startswith(f"ERROR: {item}") and "Traceback" not in err
    import torch.distributed as dist

    assert not dist.is_initialized()  # refused before any process group


@pytest.mark.parametrize("mode", ["byte", "ushort"])
def test_mesh_all_equals_reference(mode, corpus, capsys, monkeypatch):
    # --mesh all on one process: a 1-rank group, line for line the
    # reference's mesh of every (virtual) device; -G 1024 gives both the
    # same batches (the reference pads to 128 lanes a device)
    monkeypatch.chdir(corpus)
    if mode == "byte":
        argv = ["-f", "all.txt", "-p", "p.txt", "-t", "--engine", "bloom"]
    else:
        (corpus / "sigs").write_text(SIGS)
        (corpus / "flows").mkdir()
        (corpus / "flows" / "10.0.0.1_444_10.0.0.2_443_tcp").write_text(
            "7,40,32,287,32,106,196,9,5,5,5")
        argv = ["-f", "flows", "-p", "sigs", "--ushort", "--engine",
                "bloom"]
    ref, port = both(argv + ["-B", "64", "-G", "1024", "-v", "-w", "1",
                             "--json-stats", "--mesh", "all"], capsys)
    assert port == ref
    assert sum(ln.startswith("Pattern ") for ln in port) >= 2
    import torch.distributed as dist

    assert not dist.is_initialized()  # the run's 1-rank group ended with it


@pytest.mark.parametrize("mesh", ["2", "two"])
def test_mesh_not_the_world_size_exits_2(mesh, corpus, capsys, monkeypatch):
    # a rank drives one device, so --mesh N must be the world size (1 on
    # one process): anything else exits 2 with a message, no traceback
    monkeypatch.chdir(corpus)
    with pytest.raises(SystemExit) as e:
        port_main(["-f", "all.txt", "-p", "p.txt", "--mesh", mesh,
                   "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert err.startswith(f"ERROR: --mesh {mesh}: ")
    assert "Traceback" not in err
    if mesh == "2":
        assert "mesh size 2 is not the world size 1" in err


def test_mesh_with_sharded_dump_exits_2(corpus, capsys, monkeypatch):
    # a pattern-sharded filter on a mesh is the ("pat", "data") grid: the
    # 2-shard dump of the reference needs an even world, and one process
    # is a world of 1, so the run exits 2 naming both numbers
    from tpu_pattern_matching.core.dfa import compile_patterns
    from tpu_pattern_matching.parallel.pshard import ShardedBloom

    monkeypatch.chdir(corpus)
    pats = [p for p in (corpus / "p.txt").read_bytes().split(b"\n") if p]
    ShardedBloom.from_table(compile_patterns(pats), 2).save("sharded.npz")
    with pytest.raises(SystemExit) as e:
        port_main(["-f", "all.txt", "-p", "p.txt", "--engine", "bloom",
                   "--load-bloom", "sharded.npz", "--mesh", "all",
                   "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert err.startswith("ERROR: --pat-shards 2: 1 ranks do not split "
                          "into 2 pattern shards")
    import torch.distributed as dist

    assert not dist.is_initialized()  # the run's 1-rank group ended


def test_two_nccl_ranks_on_one_device_exit_2(capsys, monkeypatch, tmp_path):
    # two ranks of one host on one CUDA device: NCCL refuses that layout,
    # and the CLI exits 2 before any group exists (it never switches to
    # gloo); the device identity check runs here against a stand-in for
    # the other rank's published identity
    import torch.distributed as dist

    from tpu_pattern_matching_torch.parallel import mesh

    store = dist.HashStore()
    store.set("tpm_mesh/device/1", "host GPU 0")
    with pytest.raises(mesh.DeviceConflict, match="one rank per CUDA"):
        mesh.check_distinct_devices(store, 0, 2, "host GPU 0")
    mesh.check_distinct_devices(store, 0, 2, "host GPU 1")

    def conflict(*args, **kw):
        raise mesh.DeviceConflict("rank 0 and rank(s) [1] are all on x")

    monkeypatch.setattr(mesh, "init_distributed", conflict)
    with pytest.raises(SystemExit) as e:
        port_main(["-f", str(tmp_path), "-p", str(tmp_path), "--device",
                   "cpu", "--num-processes", "2", "--process-id", "0",
                   "--coordinator", "localhost:1"])
    assert e.value.code == 2
    assert "all on x" in capsys.readouterr().err
    assert not dist.is_initialized()


def test_sharded_bloom_dump_exits_2(corpus, capsys, monkeypatch):
    # a pattern-sharded dump loads now (it exited 2 before pattern shards
    # were ported): the reference's dump gives the reference's lines
    from tpu_pattern_matching.core.dfa import compile_patterns
    from tpu_pattern_matching.parallel.pshard import ShardedBloom

    monkeypatch.chdir(corpus)
    pats = [p for p in (corpus / "p.txt").read_bytes().split(b"\n") if p]
    ShardedBloom.from_table(compile_patterns(pats), 2).save("sharded.npz")
    ref, port = both(["-f", "all.txt", "-p", "p.txt", "-B", "64", "-G", "16",
                      "-v", "-w", "1", "--engine", "bloom", "--load-bloom",
                      "sharded.npz"], capsys)
    assert port == ref and any(ln.startswith("Pattern ") for ln in port)


@pytest.mark.parametrize("mode", ["byte", "ushort"])
def test_pat_shards_equal_reference(mode, corpus, capsys, monkeypatch):
    # --pat-shards 3, byte mode and --ushort: line for line
    monkeypatch.chdir(corpus)
    if mode == "byte":
        argv = ["-f", "all.txt", "-p", "p.txt", "-t"]
    else:
        (corpus / "sigs").write_text(SIGS)
        (corpus / "flows").mkdir()
        (corpus / "flows" / "10.0.0.1_444_10.0.0.2_443_tcp").write_text(
            "7,40,32,287,32,106,196,9,5,5,5")
        (corpus / "flows" / "10.0.0.3_80_10.0.0.4_443_tcp").write_text(
            "5,5,5,5, 40,32,287,32,106,186,32")
        argv = ["-f", "flows", "-p", "sigs", "--ushort"]
    ref, port = both(argv + ["-B", "64", "-G", "16", "-v", "-w", "1",
                             "--json-stats", "--pat-shards", "3"], capsys)
    assert port == ref
    assert sum(ln.startswith("Pattern ") for ln in port) >= 5


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sharded_save_bloom_loads_in_the_other_cli(writer, corpus, capsys,
                                                   monkeypatch):
    # --pat-shards 3 --save-bloom in one package, --load-bloom in the other
    monkeypatch.chdir(corpus)
    # the reference's "auto" is dense on the CPU: name the engine
    base = ["-f", "all.txt", "-B", "64", "-G", "16", "-v", "-w", "1",
            "--json-stats", "--engine", "bloom"]
    save = base + ["-p", "p.txt", "--pat-shards", "3", "--save-dfa", "t.npz",
                   "--save-bloom", "s.npz"]
    load = base + ["--load-dfa", "t.npz", "--load-bloom", "s.npz"]
    if writer == "port":
        assert port_main(save + ["--device", "cpu"]) == 0
        built = stable(capsys.readouterr().out)
        assert ref_main(load) == 0
    else:
        assert ref_main(save) == 0
        built = stable(capsys.readouterr().out)
        assert port_main(load + ["--device", "cpu"]) == 0
    loaded = stable(capsys.readouterr().out)
    with np.load(corpus / "s.npz") as z:
        assert z["pshard_words"].shape[0] == 3
    assert loaded == built
    assert sum(ln.startswith("Pattern ") for ln in loaded) >= 3


def test_cuda_without_a_gpu_exits_2(corpus, capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request is honoured")
    monkeypatch.chdir(corpus)
    for extra in ([], ["--ushort"]):
        with pytest.raises(SystemExit) as e:
            port_main(["-f", "all.txt", "-p", "p.txt"] + extra)
        assert e.value.code == 2
        assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        port_main(["-f", "all.txt", "-p", "p.txt", "--device", "cpu",
                   "-D", "1"])
    assert "device position 1 not available" in capsys.readouterr().err


def wait_for(proc, needle: bytes, seen: bytes, deadline: float) -> bytes:
    while needle not in seen and time.time() < deadline:
        r, _, _ = select.select([proc.stdout], [], [], 0.5)
        if r:
            chunk = os.read(proc.stdout.fileno(), 65536)
            if not chunk:
                break
            seen += chunk
    return seen


def test_follow_mode_streams_appended_matches_and_drains_on_sigint(
        tmp_path):
    (tmp_path / "p.txt").write_text("first\nsecond\n")
    log = tmp_path / "log.txt"
    log.write_text("xx first yy\n")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_pattern_matching_torch.cli", "-f",
         str(log), "-p", str(tmp_path / "p.txt"), "-v", "-t", "-F", "-B",
         "32", "-G", "16", "-w", "1", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    try:
        deadline = time.time() + 240
        # the first match shows the follower is up; the appended line must
        # then stream out while following, before any shutdown drain
        seen = wait_for(proc, b"Pattern 0 ('first')", b"", deadline)
        assert b"Pattern 0 ('first')" in seen, (seen, proc.stderr.read())
        with open(log, "a") as f:
            f.write("zz second\n")
        seen = wait_for(proc, b"Pattern 1 ('second')", seen, deadline)
        assert b"Pattern 1 ('second')" in seen, seen
        proc.send_signal(signal.SIGINT)
        out, _err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0
    assert b"STATS" in out and b"Matches:             2" in out


@pytest.mark.parametrize("engine", ["bloom", "dense"])
def test_best_scan_total_fn_equals_reference(engine):
    from tpu_pattern_matching.core.dfa import compile_patterns
    from tpu_pattern_matching.engine import best_scan_total_fn as ref_fn
    from tpu_pattern_matching_torch.engine import best_scan_total_fn

    rng = np.random.RandomState(3)
    pats = [bytes(rng.randint(97, 100, size=5).astype(np.uint8))
            for _ in range(6)]
    table = compile_patterns(pats)
    C, B = 40, 64
    r_fn, r_halo = ref_fn(table, C, B, engine=engine)
    p_fn, p_halo = best_scan_total_fn(table, C, B, engine=engine,
                                      device="cpu")
    assert p_halo == r_halo
    data = rng.randint(97, 101, size=(C, p_halo + B)).astype(np.uint8)
    start = np.full(C, p_halo, np.int32)
    end = rng.randint(p_halo, p_halo + B + 1, size=C).astype(np.int32)
    want = int(r_fn(data, start, end))
    got = p_fn(torch.from_numpy(data), torch.from_numpy(start),
               torch.from_numpy(end))
    assert got.dtype == torch.int32 and int(got) == want > 0


def test_best_scan_total_fn_auto_is_dense_on_the_cpu():
    from tpu_pattern_matching.core.dfa import compile_patterns
    from tpu_pattern_matching_torch.engine import best_scan_total_fn

    table = compile_patterns([b"abc"])
    fn, halo = best_scan_total_fn(table, 4, 16, device="cpu")
    data = torch.from_numpy(np.frombuffer(
        (b"\0" * halo + b"abcabcabcabcabca") * 4, np.uint8).reshape(4, -1)
        .copy())
    start = torch.full((4,), halo, dtype=torch.int32)
    end = torch.full((4,), halo + 16, dtype=torch.int32)
    assert int(fn(data, start, end)) == 4 * 5
