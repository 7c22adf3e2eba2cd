"""Fixtures of the benchmark's CPU tests: a benchmark root of tiny cells
(its own ``BENCHMARK.json``, configurations and traffic mixes, the
harness's generators and metric readers), whose runs take the plain
versions of the kernels on the CPU."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
os.environ.setdefault("TPM_COST_CONSTANTS", "/nonexistent/tpm-cost-constants")
HARNESS = os.path.join(REPO, "perfbench")

TINY_CONFIGS = {
    "tinyu": {"unit": "tokens", "cli": ["--ushort", "--engine", "bloom",
                                        "-B", "256", "-G", "128", "-w", "2",
                                        "-R", "16"],
              "pattern_limit": 16,
              "signatures": {"generator": "packet_sigs", "count": 200,
                             "min_len": 6, "max_len": 16}},
}
TINY_TRAFFIC = {
    "fl": {"generator": "flow_trains", "flows": 400, "min_packets": 8,
           "tail_index": 1.2,
           "payload_mix": {"ack": 0.45, "mss": 0.3, "mss_bytes": 1460},
           "plant_density": 0.02, "passes": 1, "warmup_batches": 2,
           "profile_batches": 3, "check_share": 1.0},
}
TINY_CELLS = {"tinyu.fl": ("tinyu", "fl")}


def metrics(cells: list) -> tuple[list, list]:
    """End-to-end and per-layer entries for every reader under
    ``perfbench/metrics/``, each reported by every cell."""
    names = sorted(f[:-3] for f in os.listdir(os.path.join(HARNESS,
                                                           "metrics"))
                   if f.endswith(".py"))
    e2e, per = [], []
    for n in names:
        m = {"name": n, "unit": "x", "better": "lower",
             "source": "host_clock", "workloads": list(cells)}
        if n == "setup_s":
            e2e.append(dict(m, bound=0.25))
        elif n == "scan_tokens_per_s":
            e2e.append(dict(m, bound=0.25, better="higher"))
        else:
            per.append(dict(m, layer="test", moves="scan_tokens_per_s"))
    return e2e, per


def make_root(path: str, configs=TINY_CONFIGS, traffic=TINY_TRAFFIC,
              cells=TINY_CELLS) -> str:
    """A benchmark root at ``path``: the harness's generators and readers
    (copied), and a ``BENCHMARK.json`` of ``cells`` (name -> (config,
    traffic)) over the given configurations and mixes, with a metric for
    every reader."""
    os.makedirs(os.path.join(path, "configs"))
    os.makedirs(os.path.join(path, "traffic"))
    for d in ("generators", "metrics"):
        shutil.copytree(os.path.join(HARNESS, d), os.path.join(path, d))
    for name, c in configs.items():
        with open(os.path.join(path, "configs", f"{name}.json"), "w") as f:
            json.dump(dict(c, name=name), f)
    for name, t in traffic.items():
        with open(os.path.join(path, "traffic", f"{name}.json"), "w") as f:
            json.dump(t, f)
    bench = {"command": ["python3", "-m", "perfbench.run"],
             "paths": ["perfbench"], "run_seconds": 1}
    bench["configs"] = [{"name": n, "source": "test", "file":
                         f"configs/{n}.json", "reduced": [], "why": "test"}
                        for n in configs]
    bench["workloads"] = [{"name": w, "config": c, "traffic": t,
                           "chips": 1, "why": "test"}
                          for w, (c, t) in cells.items()]
    bench["end_to_end"], bench["per_layer"] = metrics(list(cells))
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> str:
    return make_root(str(tmp_path_factory.mktemp("bench") / "root"))


def tiny_cell(root: str, workload: str):
    from perfbench import spec

    return spec.load(workload, os.path.join(root, "BENCHMARK.json"),
                     root=root)
