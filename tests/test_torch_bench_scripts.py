"""The port's benchmark scripts (``benchmarks.match_dense_bench``,
``bench_ushort``, ``bench_100k``, ``prefix_sum_bench``) against the
reference's on the CPU, at the same small arguments: the same keys, and
the same events, picks, survivor and residue rates, states and walker
binding. The reference runs whole (its Pallas probes in interpret mode);
the port's timing loops are cut to one call (timings are not compared).
Every compared field is exact (tolerance 0). Each entry point exits 2
without a card unless given ``--device cpu``."""

import contextlib
import importlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from tpu_pattern_matching_torch.benchmarks import bench_100k as port_100k
from tpu_pattern_matching_torch.benchmarks import bench_ushort as port_ushort
from tpu_pattern_matching_torch.benchmarks import match_dense_bench as port_md
from tpu_pattern_matching_torch.benchmarks import prefix_sum_bench as port_ps
from tpu_pattern_matching_torch.utils import measure

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY_POINTS = ("tpu_pattern_matching_torch.bench",
                "tpu_pattern_matching_torch.benchmarks.run_configs",
                "tpu_pattern_matching_torch.benchmarks.match_dense_bench",
                "tpu_pattern_matching_torch.benchmarks.bench_ushort",
                "tpu_pattern_matching_torch.benchmarks.bench_100k",
                "tpu_pattern_matching_torch.benchmarks.prefix_sum_bench")


def load_reference(name):
    """A fresh copy of the reference's ``benchmarks/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def json_lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def run_reference(fn, argv):
    """The reference's ``fn()`` under ``sys.argv = argv``; its JSON
    lines."""
    out = io.StringIO()
    saved = sys.argv
    sys.argv = argv
    try:
        with contextlib.redirect_stdout(out):
            fn()
    finally:
        sys.argv = saved
    return json_lines(out.getvalue())


def one_call(call, device, n, **_):
    """``kloop_seconds`` cut to one call (the tests compare no time)."""
    call().item()
    return 1e-3


def signature_file(path, n=200, seed=2000):
    """Packet-length signatures of 6-16 tokens, as ``chip_smoke.py``
    generates its ushort set."""
    rng = np.random.RandomState(seed)

    def lengths(k):
        v = rng.randint(40, 1515, size=k)
        wild = rng.rand(k) < 0.1
        v[wild] = rng.randint(0, 2048, size=int(wild.sum()))
        return v

    with open(path, "w") as f:
        for i in range(n):
            sg = lengths(rng.randint(6, 17))
            f.write(f"{','.join(map(str, sg))}; {len(sg)}; sig {i}\n")
    return str(path)


@pytest.fixture(scope="module")
def dense_lines():
    ref = load_reference("match_dense_bench")
    return run_reference(ref.main, ["match_dense_bench", "--patterns", "300",
                                    "--mib", "1"])


@pytest.mark.parametrize("engine", ["bloom", "dense"])
def test_match_dense_bench_equals_the_reference(dense_lines, engine,
                                                capsys):
    assert port_md.main(["--patterns", "300", "--mib", "1", "--engine",
                         engine, "--device", "cpu"]) == 0
    out = capsys.readouterr()
    got = json_lines(out.out)
    assert out.err.count("== native oracle") == len(port_md.DENSITIES)
    assert [g["density"] for g in got] == [w["density"]
                                           for w in dense_lines]
    for g, w in zip(got, dense_lines):
        assert list(g) == list(w)
        # events are the engine's own exact count: the same for both
        for key in ("metric", "density", "events", "patterns", "unit"):
            assert g[key] == w[key], key
        assert g["engine"] == engine
    assert got[-1]["events"] > got[1]["events"] > 0


def test_match_dense_bench_raises_when_the_oracle_disagrees(monkeypatch,
                                                            capsys):
    monkeypatch.setattr(port_md, "oracle_match_ends",
                        lambda pats, payload: -1)
    with pytest.raises(RuntimeError, match="density 0.0: 0 events, the "
                                           "native oracle -1"):
        port_md.run(300, 1, "bloom", "cpu")
    assert len(json_lines(capsys.readouterr().out)) == 1


def test_bench_ushort_equals_the_reference(tmp_path, monkeypatch):
    path = signature_file(tmp_path / "u.signatures")
    ref = load_reference("bench_ushort")
    (want,) = run_reference(ref.main, ["bench_ushort", path])
    monkeypatch.setattr(measure, "kloop_seconds", one_call)
    got = port_ushort.run([path], "cpu")
    assert list(got) == list(want)
    for key in ("metric", "signatures_in", "signatures_used", "states",
                "probe_config", "refined_config", "refined_k_ref",
                "refined_residue_per_token"):
        assert got[key] == want[key], key


def test_bench_ushort_signature_sets(tmp_path, monkeypatch):
    ref = load_reference("bench_ushort")
    monkeypatch.delenv("TPM_UPSTREAM_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="TPM_UPSTREAM_DIR"):
        port_ushort.default_sigs()
    d = tmp_path / "AC_ushorts" / "input"
    d.mkdir(parents=True)
    for i, name in enumerate(port_ushort.REF_SIGS):
        signature_file(d / name, n=30, seed=i)
    with open(d / "rx.signatures", "a") as f:  # a duplicate, a 1-token
        f.write("40,52; 2; dup\n40,52; 2; dup again\n1400; 1; one\n"
                "3000,5000,40; 3; past 2047\n")
    monkeypatch.setenv("TPM_UPSTREAM_DIR", str(tmp_path))
    paths = port_ushort.default_sigs()
    got_t, got_in, got_used = port_ushort.build_table(paths)
    want_t, want_in, want_used = ref.build_table(paths)
    assert (got_in, got_used) == (want_in, want_used) == (94, 92)
    assert got_t.num_states == want_t.num_states
    np.testing.assert_array_equal(got_t.goto_signed, want_t.goto_signed)


def test_bench_100k_equals_the_reference(monkeypatch, capsys):
    import bench as ref_bench

    ref = load_reference("bench_100k")
    monkeypatch.setattr(ref_bench, "devices_with_retry", lambda: None)
    (want,) = run_reference(lambda: ref.main(2000), ["bench_100k"])
    monkeypatch.setattr(measure, "kloop_seconds", one_call)
    assert port_100k.main(["2000", "--device", "cpu"]) == 0
    (got,) = json_lines(capsys.readouterr().out)
    assert list(got) == list(want)
    for key in ("metric", "config", "survivor_rate_per_byte", "states",
                "table_mb", "dense_walker_bound"):
        assert got[key] == want[key], key
    assert got["dense_walker_bound"] is True
    assert got["artifact_save_s"] >= 0 and got["artifact_load_s"] >= 0


def test_prefix_sum_bench_equals_the_reference():
    ref = load_reference("prefix_sum_bench")
    (want,) = run_reference(ref.main, ["prefix_sum_bench", "--count",
                                       "5000"])
    got = port_ps.run(5000, "cpu")
    assert list(got) == list(want)
    assert (got["metric"], got["count"], got["unit"]) == (
        want["metric"], want["count"], want["unit"])


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_without_a_card_each_entry_point_exits_2(module, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request is honoured")
    main = importlib.import_module(module).main
    with pytest.raises(SystemExit) as e:
        main(["1000"] if module.endswith("bench_100k") else [])
    assert e.value.code == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no CUDA device" in captured.err
    assert "--device cpu" in captured.err
