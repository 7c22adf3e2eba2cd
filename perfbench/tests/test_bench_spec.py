"""The harness is driven by data: a configuration, a traffic mix and a
cell added as new files and entries run with no file of the harness
changed; and a run loads nothing of JAX or the JAX package."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from perfbench import spec
from perfbench.tests.conftest import (REPO, TINY_CONFIGS, TINY_TRAFFIC,
                                      make_root)


def test_new_config_and_mix_found_by_name(tmp_path):
    configs = dict(TINY_CONFIGS, brandnew=dict(
        TINY_CONFIGS["tinyu"], signatures={"generator": "packet_sigs",
                                           "count": 50, "min_len": 4,
                                           "max_len": 10},
        cli=["--ushort", "--engine", "bloom", "-B", "128", "-G", "128"],
        pattern_limit=10))
    traffic = dict(TINY_TRAFFIC, sparse=dict(TINY_TRAFFIC["fl"],
                                             plant_density=0.01, flows=100))
    root = make_root(str(tmp_path / "root"), configs, traffic,
                     {"brandnew.sparse": ("brandnew", "sparse")})
    cell = spec.load("brandnew.sparse", os.path.join(root, "BENCHMARK.json"),
                     root=root)
    assert cell.config["signatures"]["count"] == 50
    assert cell.traffic["plant_density"] == 0.01
    assert [m["name"] for m in cell.end_to_end] == ["scan_tokens_per_s",
                                                    "setup_s"]
    from perfbench.harness import run_cell

    line, numbers = run_cell(cell, 5, 1.0, False, "cpu")
    assert line["correct"], numbers
    assert set(line["metrics"]) == {"scan_tokens_per_s", "setup_s"}


def test_benchmark_files_resolve():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell = spec.load(w["name"], os.path.join(REPO, "BENCHMARK.json"))
        assert cell.config["name"] == w["config"]
        assert spec.generator(cell.root, cell.traffic["generator"])
        assert spec.generator(cell.root,
                              cell.config["signatures"]["generator"])
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric_reader(cell.root, m["name"]).read)
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_run_loads_no_jax(tmp_path):
    """A whole run on the CPU, then the loaded modules: none of jax,
    jaxlib, flax or tpu_pattern_matching by top-level name (compared
    whole: tpu_pattern_matching_torch is the program)."""
    root = make_root(str(tmp_path / "root"))
    code = f"""
import os, sys
sys.path.insert(0, {REPO!r})
from perfbench import spec, harness, control, run, trace, readings
from perfbench.tests.conftest import tiny_cell
cell = tiny_cell({root!r}, "tinyu.fl")
line, _ = harness.run_cell(cell, 3, 0.5, True, "cpu")
for m in cell.per_layer:
    spec.metric_reader(cell.root, m["name"])
assert "tpu_pattern_matching_torch" in sys.modules
print(harness.forbidden_modules())
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compared_whole(monkeypatch):
    from perfbench.harness import forbidden_modules

    monkeypatch.setitem(sys.modules, "tpu_pattern_matching_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxx", sys)
    assert "tpu_pattern_matching_torch_x" not in forbidden_modules()
    assert "jaxx" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "tpu_pattern_matching.cli", sys)
    assert {"jax.numpy", "tpu_pattern_matching.cli"} <= set(
        forbidden_modules())
