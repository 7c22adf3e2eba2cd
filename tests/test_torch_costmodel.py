"""The port's calibrator (``tpu_pattern_matching_torch/ops/costmodel.py``)
against the reference's ``ops/costmodel.py`` on the CPU.

- The draws: the reference's ``calibrate`` runs with its timers, probes
  and verifier stubbed (nothing in the JAX package changes; the test
  patches names the function looks up when it runs), and every array it
  hands to ``jax.device_put`` is captured. The port's ``draw_points``
  gives the same byte and ushort batches and filters, tolerance 0.
- The fit: the stubbed reference turns fixed seconds and candidate counts
  into constants by its own formulas; the port's ``fit`` on the same
  numbers agrees within 1e-12 relative.
- A whole calibration of the plain versions at a small size writes a file
  that loads in both packages and prices both choosers alike; perturbed
  constants move the picks of both packages alike; each package reads its
  own cache path; ``device="cuda"`` without a card raises.
"""

import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpu_pattern_matching.ops import bloom as ref_bloom
from tpu_pattern_matching.ops import costmodel as ref_cost
from tpu_pattern_matching_torch.ops import bloom as port_bloom
from tpu_pattern_matching_torch.ops import costmodel as port_cost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PATTERNS = 300  # the byte point's pattern count in the draw tests
SMALL = dict(lanes=128, chunk=256, u_signatures=100, u_lanes=128,
             u_chunk=256, calls=2, verbose=False)
FLOATS = ("probe_ns_per_unit", "refine_ns_per_slot",
          "refine_fixed_ns_per_byte", "verify_ns_per_cand",
          "probe_ns_per_unit_u2048", "verify_ns_per_cand_u2048")
# (probe, refined at K_REF[0], refined at K_REF[1], ushort probe) seconds,
# byte and ushort candidate counts, and the host verify seconds
TIMES = {
    "plain": ((0.0021, 0.0043, 0.0079, 0.0017), (1234, 567), 0.00321),
    # the slot cost and the fixed term fall to their floors
    "clamped": ((0.0040, 0.0030, 0.0020, 0.0009), (0, 3), 0.0005),
}


def run_reference(monkeypatch, seconds, n_cands, verify_s):
    """The reference's calibrate(path=None) with its timers, probes and
    verifier stubbed: (its constants, the arrays it put on the device)."""
    import jax

    from tpu_pattern_matching.runtime import verify as ref_verify

    puts = []

    def device_put(x, *args, **kw):
        puts.append(x)
        return x

    class Verifier:
        def __init__(self, *args, **kw):
            pass

        def verify_batch_arrays(self, *args):
            return None

    secs, cands, clock = iter(seconds), iter(n_cands), itertools.count()
    monkeypatch.setattr(jax, "device_put", device_put)
    monkeypatch.setattr(ref_cost, "_best_delta", lambda run: next(secs))
    monkeypatch.setattr(
        ref_bloom, "_hits_jit", lambda *a, **kw: (
            np.array([next(cands)], np.int32), np.zeros((1, 128), np.int32)))
    monkeypatch.setattr(ref_bloom, "unpack_hit_rows", lambda bits, stride: (
        np.zeros(0, np.int64), np.zeros(0, np.int64)))
    monkeypatch.setattr(ref_verify, "Verifier", Verifier)
    # each call of this thread reads one tick later: every verify round
    # takes verify_s (other threads keep the real clock)
    me, real = threading.get_ident(), time.perf_counter
    monkeypatch.setattr(time, "perf_counter", lambda: (
        next(clock) * verify_s if threading.get_ident() == me else real()))
    cc = ref_cost.calibrate(path=None, n_patterns=N_PATTERNS, verbose=False)
    monkeypatch.undo()
    return cc, puts


@pytest.fixture(scope="module")
def port_points():
    return port_cost.draw_points(N_PATTERNS)


@pytest.mark.parametrize("case", list(TIMES))
def test_draws_and_fit_equal_reference(monkeypatch, port_points, case):
    seconds, n_cands, verify_s = TIMES[case]
    ref_cc, puts = run_reference(monkeypatch, seconds, n_cands, verify_s)
    byte, ushort = port_points
    # (a) the draws: byte batch, bounds, filter words; ushort batch,
    # bounds, filter words; tolerance 0
    u8 = [a for a in puts if a.ndim == 2 and a.dtype == np.uint8]
    u16 = [i for i, a in enumerate(puts) if a.dtype == np.uint16]
    assert len(u8) == len(u16) == 1
    i = u16[0]
    for got, want in ((byte.data, puts[0]),
                      (np.stack([byte.start, byte.end]), puts[1]),
                      (byte.bft.words, puts[2]),
                      (ushort.data, puts[i]),
                      (np.stack([ushort.start, ushort.end]), puts[i + 1]),
                      (ushort.bft.words, puts[i + 2])):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert byte.data.shape == (4096, byte.halo + byte.size // 4096)
    assert ushort.data.shape == (2048, ushort.halo + ushort.size // 2048)
    # (b) the fit on the same seconds, sizes, units and counts
    cfg = byte.bft.cfg
    m = port_cost.Measurement(
        probe_s=seconds[0], refined_s=seconds[1:3], verify_s=verify_s,
        n_cand=n_cands[0], size=byte.size, units=byte.units,
        s_eff=1 if cfg.sampled else cfg.stride, u_probe_s=seconds[3],
        u_verify_s=verify_s, u_n_cand=n_cands[1], u_size=ushort.size,
        u_units=ushort.units)
    got = port_cost.fit(m, "calibrated:test")
    for f in FLOATS:
        assert math.isclose(getattr(got, f), getattr(ref_cc, f),
                            rel_tol=1e-12, abs_tol=0), f
    if case == "clamped":
        assert got.refine_ns_per_slot == 1.0
        assert got.refine_fixed_ns_per_byte == 1e-4


def test_draws_follow_the_reference_pick():
    # the batches are tile-aligned for the picked configs, with the
    # reference's 1e-3 planting: small draws keep the invariants
    byte, ushort = port_cost.draw_points(40, **{
        k: v for k, v in SMALL.items() if k not in ("calls", "verbose")})
    for p, lanes in ((byte, 128), (ushort, 128)):
        T = p.data.shape[1]
        assert p.data.shape[0] == lanes and T % p.bft.cfg.tile_rows == 0
        assert (p.start == p.halo).all() and (p.end == T).all()
        assert p.size == lanes * (T - p.halo)
        assert p.units == port_bloom.probe_cost_units(
            p.bft.cfg.q, p.bft.cfg.kbanks, p.bft.cfg.v,
            s=1 if p.bft.cfg.sampled else p.bft.cfg.stride,
            w=p.bft.cfg.w if p.bft.cfg.sampled else 0)
    assert byte.data.dtype == np.uint8 and ushort.data.dtype == np.uint16


def test_cpu_calibration_file_crosses_packages(tmp_path, monkeypatch):
    # (c) a whole run of the plain versions at a small size
    path = str(tmp_path / "cc.json")
    runs = []
    run_calibration = port_cost.run_calibration

    def recorded(*args, **kwargs):
        runs.append(run_calibration(*args, **kwargs))
        return runs[-1]

    monkeypatch.setattr(port_cost, "run_calibration", recorded)
    cc = port_cost.calibrate(path=path, n_patterns=200, device="cpu",
                             **SMALL)
    (run,) = runs
    assert run.constants == cc
    assert cc.source.startswith("calibrated:cpu")
    for f in FLOATS:
        assert getattr(cc, f) > 0 and math.isfinite(getattr(cc, f)), f
    assert port_cost.CostConstants.load(path) == cc
    assert dataclasses.asdict(ref_cost.CostConstants.load(path)) == (
        dataclasses.asdict(cc))
    assert set(run.calls) == {"probe", "refined_k4096", "refined_k24576",
                              "u_probe"}
    assert run.calls["u_probe"]["ushort"]
    assert port_cost.fit(run.measurement, cc.source) == cc
    monkeypatch.setenv(port_cost.ENV_VAR, path)
    assert port_cost.get_cost_constants() == cc
    assert port_cost.get_cost_constants(2048) == cc.for_alphabet(2048)
    # both choosers price with it alike
    pats = patterns(11, 400)
    ref_table = ref_bloom.BloomFilterTable.build(pats)
    port_table = port_bloom.BloomFilterTable.build(pats)
    assert dataclasses.asdict(port_table.cfg) == dataclasses.asdict(
        ref_table.cfg)


def patterns(seed, n, alphabet=256):
    rng = np.random.RandomState(seed)
    if alphabet == 256:
        return [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
                for _ in range(n)]
    return [tuple(int(x) for x in rng.randint(0, alphabet, size=8))
            for _ in range(n)]


PERTURBED = {  # name: (constants, does the byte pick move, the ushort's)
    "probe-dear": (port_cost.CostConstants(
        probe_ns_per_unit=1e6, refine_ns_per_slot=1e-6,
        refine_fixed_ns_per_byte=1e-9, verify_ns_per_cand=1e-6,
        source="perturbed"), True, True),
    "ushort-probe-dear": (port_cost.CostConstants(
        probe_ns_per_unit_u2048=1e6, verify_ns_per_cand_u2048=1e-6,
        source="perturbed-ushort"), False, True),
    "verify-dear": (port_cost.CostConstants(
        verify_ns_per_cand=1e6, verify_ns_per_cand_u2048=1e6,
        source="perturbed-verify"), True, True),
}


@pytest.mark.parametrize("name", list(PERTURBED))
def test_perturbed_constants_move_both_picks_alike(tmp_path, monkeypatch,
                                                   name):
    # (d) the reference's sensitivity tests (tests/test_costmodel.py), in
    # both packages at once
    cc, byte_moves, ushort_moves = PERTURBED[name]
    sets = ((patterns(11, 400), 256), (patterns(3, 300, 2048), 2048))

    def picks():
        out = []
        for pats, alphabet in sets:
            r = ref_bloom.BloomFilterTable.build(pats, alphabet_size=alphabet)
            p = port_bloom.BloomFilterTable.build(pats,
                                                  alphabet_size=alphabet)
            assert dataclasses.asdict(p.cfg) == dataclasses.asdict(r.cfg)
            np.testing.assert_array_equal(p.words, r.words)
            out.append(dataclasses.asdict(p.cfg))
        return out

    monkeypatch.setenv(port_cost.ENV_VAR, str(tmp_path / "absent.json"))
    before = picks()
    cc.save(str(tmp_path / "cc.json"))
    monkeypatch.setenv(port_cost.ENV_VAR, str(tmp_path / "cc.json"))
    after = picks()
    for moves, b, a in zip((byte_moves, ushort_moves), before, after):
        assert (a != b) == moves, (name, b, a)


CACHE_PROBE = """
import json, os, sys
from tpu_pattern_matching.ops import costmodel as ref
from tpu_pattern_matching_torch.ops import costmodel as port
def source(path, name):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    json.dump({"probe_ns_per_unit": 0.5, "source": name}, open(path, "w"))
def seen():
    return [ref.get_cost_constants().source, port.get_cost_constants().source]
out = [ref.DEFAULT_PATH, port.DEFAULT_PATH, seen()]
source(ref.DEFAULT_PATH, "ref-cache")
out.append(seen())
source(port.DEFAULT_PATH, "port-cache")
out.append(seen())
os.remove(ref.DEFAULT_PATH)
out.append(seen())
source(os.path.join(os.environ["HOME"], "env.json"), "env")
os.environ[ref.ENV_VAR] = os.path.join(os.environ["HOME"], "env.json")
out.append(seen())
print(json.dumps(out))
"""


def test_each_package_reads_its_own_cache_path(tmp_path):
    # (e) the user cache files, under a HOME of the test's own
    env = {k: v for k, v in os.environ.items() if k != port_cost.ENV_VAR}
    env.update(HOME=str(tmp_path), PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", CACHE_PROBE], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    ref_path, port_path, *seen = json.loads(r.stdout)
    assert ref_path == str(
        tmp_path / ".cache" / "tpu_pattern_matching" / "cost_constants.json")
    assert port_path == str(tmp_path / ".cache" / "tpu_pattern_matching_torch"
                            / "cost_constants.json")
    default = "v5e-r4-default"
    assert seen == [[default, default], ["ref-cache", default],
                    ["ref-cache", "port-cache"], [default, "port-cache"],
                    ["env", "env"]]


def test_calibrate_on_cuda_without_a_card_raises():
    # (f) no silent CPU: the request raises before anything is drawn
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request is honoured")
    with pytest.raises(RuntimeError, match="cuda"):
        port_cost.calibrate(path=None, n_patterns=10, verbose=False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_cost.main([os.devnull])


def test_main_prints_the_constants(monkeypatch, capsys):
    got = []
    cc = port_cost.CostConstants(probe_ns_per_unit=0.25, source="x")

    def calibrate(path, device):
        got.append((path, device))
        return cc

    monkeypatch.setattr(port_cost, "calibrate", calibrate)
    assert port_cost.main([]) == 0
    assert port_cost.main(["/x/cc.json", "--device", "cpu"]) == 0
    assert got == [(port_cost.DEFAULT_PATH, "cuda"), ("/x/cc.json", "cpu")]
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(s) for s in lines] == [dataclasses.asdict(cc)] * 2
