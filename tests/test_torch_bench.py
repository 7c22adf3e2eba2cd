"""The port's benchmark (``tpu_pattern_matching_torch.bench``) against the
reference's ``bench.py`` on the CPU: the JSON line's keys, the chooser's
three picks with their batches and refinement capacity at the full 10k x
12 B point, and at small points the deterministic outputs of
``joint_metrics`` (the reference's Pallas probes run in interpret mode)
and each pick's d1e3 events against the native oracle. Timings are not
compared; every other comparison is exact (tolerance 0)."""

import ast
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as ref
from tpu_pattern_matching.core.dfa import compile_patterns as ref_compile
from tpu_pattern_matching.ops.bloom import REFINE_HEADROOM
from tpu_pattern_matching.ops.bloom import BloomFilterTable as RefBloom
from tpu_pattern_matching.ops.verify_device import MAX_DEVICE_CAND
from tpu_pattern_matching.ops.verify_device import next_cap as ref_next_cap
from tpu_pattern_matching.utils.common import pad_halo as ref_pad_halo
from tpu_pattern_matching_torch import bench as port
from tpu_pattern_matching_torch.ops.bloom import BloomFilterTable
from tpu_pattern_matching_torch.ops.costmodel import get_cost_constants
from tpu_pattern_matching_torch.utils import measure

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ((300, 128, 512), (600, 128, 1024))  # (patterns, C, B0)
DETERMINISTIC = ("joint_config", "survivors_per_byte_d0",
                 "survivors_per_byte_d1e3", "refined_config",
                 "refined_k_ref", "refined_residue_per_byte_d0",
                 "refined_residue_per_byte_d1e3")


def ref_patterns(n):
    rng = np.random.RandomState(42)
    return [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(n)]


def ref_main_literal_keys():
    """The keys written out in the reference ``main``'s JSON dict (its
    ``**extra`` follows them), read from its source."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    dicts = [n for n in ast.walk(main) if isinstance(n, ast.Dict)
             and any(k is None for k in n.keys)]
    (d,) = dicts
    return [k.value for k in d.keys if k is not None]


@pytest.fixture(scope="module", params=SMALL, ids=lambda p: "x".join(map(
    str, p)))
def small_point(request):
    """Both packages' ``joint_metrics`` at one small point from a fresh
    ``RandomState(7)``, and the port's d1e3 record."""
    n, C, B0 = request.param
    want = ref.joint_metrics(jax, jnp, ref_compile(ref_patterns(n)), C, B0,
                             np.random.RandomState(7))
    record = {"patterns": ref_patterns(n)}
    got = port.joint_metrics(port.build_workload(n), C, B0,
                             np.random.RandomState(7), "cpu",
                             record=record)
    return want, got, record


def test_kloop_seconds_differences_the_best_runs(monkeypatch):
    clock = [0.0]
    calls = []

    def call():  # one call advances the host clock by one second
        clock[0] += 1.0
        calls.append(1)
        return torch.tensor(2, dtype=torch.int32)

    monkeypatch.setattr(measure.time, "perf_counter", lambda: clock[0])
    got = measure.kloop_seconds(call, "cpu", n=3)
    assert got == 1.0  # (t(9) - t(1)) / 8 with t(K) = K seconds
    # a warm-up run of each K, then n runs of each
    assert len(calls) == (1 + 9) + 3 * (9 + 1)


def test_timed_keeps_each_call_for_its_device_time_line(monkeypatch,
                                                        capsys):
    monkeypatch.setattr(measure, "kloop_seconds", lambda call, dev, n: 0.002)
    traced = []

    def call():
        return torch.tensor(1)

    assert measure.timed("probe", call, "cpu", 3, traced) == 0.002
    assert measure.timed("untraced", call, "cpu", 3, None) == 0.002
    assert traced == [("probe", call, 0.002)]
    measure.log_device_times("bench", traced, "cpu")
    assert capsys.readouterr().err == (
        "[bench] probe: 2.0000 ms a call (host clock, the plain versions on "
        "the cpu; no device time)\n")


def test_keys_equal_the_reference(small_point):
    want, got, _ = small_point
    ref_keys = ref_main_literal_keys() + list(want)
    assert list(port.KEYS) == ref_keys
    assert list(got) == list(want)
    line = port.run("cpu", 300, 128, 512)
    assert list(line) == list(port.KEYS)
    assert line["value"] == line["refined_pipelined_bytes_per_s_d1e3"]
    assert line["metric"] == port.METRIC
    assert line["calibration"] == get_cost_constants().source


@pytest.mark.parametrize("key", DETERMINISTIC)
def test_joint_metrics_deterministic_outputs_equal_the_reference(
        small_point, key):
    want, got, _ = small_point
    assert got[key] == want[key]


def test_d1e3_events_equal_the_native_oracle(small_point):
    _, _, record = small_point
    counts = port.check_events(record)
    assert counts["joint"] > 0 and counts["refined"] > 0
    for name in ("joint", "refined"):
        r = record[name]
        assert int(r["device_meta"][0]) == len(r["device_pairs"])
    # a dropped event fails the check
    record["refined"]["host_events"] = record["refined"]["host_events"][1:]
    with pytest.raises(RuntimeError, match="host verify"):
        port.check_events(record)


def test_full_point_picks_batches_and_k_ref_equal_the_reference():
    """The three chooser picks at 10,000 x 12 B (host builds only), each
    pick's halo and B, and k_ref, against the reference's and against
    the reference's own run on a TPU (BENCH_r05.json)."""
    table = port.build_workload()
    rtable = ref_compile(ref_patterns(port.N_PATTERNS))
    assert table.num_states == rtable.num_states
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        r05 = json.load(f)["parsed"]
    for kw, key in ((dict(objective="probe"), None),
                    (dict(objective="joint"), "joint_config"),
                    ({}, "refined_config")):
        bft = BloomFilterTable.from_table(table, **kw)
        rbft = RefBloom.from_table(rtable, **kw)
        name = port.cfg_name(bft.cfg)
        assert name == port.cfg_name(rbft.cfg)
        if key:
            assert name == r05[key]
        halo = ref_pad_halo(rtable.max_pat_len - 1, port.CHUNK)
        B = port.CHUNK + (-(halo + port.CHUNK)) % rbft.cfg.tile_rows
        assert port.batch_rows(table, bft.cfg, port.CHUNK) == (halo, B)
        if not kw:
            size = port.LANES * B
            want = ref_next_cap(int(min(MAX_DEVICE_CAND, max(
                2048, REFINE_HEADROOM * rbft.expected_cand_rate() * size))))
            assert port.k_ref_for(bft, size) == want == r05["refined_k_ref"]


def test_a_failing_arm_propagates(monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("refined arm failed")

    small = port.run
    monkeypatch.setattr(port, "refined_metrics", broken)
    monkeypatch.setattr(port, "run", lambda dev, record=None: small(
        dev, 300, 128, 512, record))
    with pytest.raises(RuntimeError, match="refined arm failed"):
        port.main(["--device", "cpu"])
    assert capsys.readouterr().out == ""  # no JSON line, no error key


def test_without_a_card_it_exits_2():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request is honoured")
    r = subprocess.run([sys.executable, "-m", "tpu_pattern_matching_torch.bench"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 2
    assert r.stdout == ""
    assert "--device cpu" in r.stderr and "no CUDA device" in r.stderr
