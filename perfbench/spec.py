"""The cell a run measures, read from ``BENCHMARK.json`` and the files it
names: the workload entry, its configuration (``configs/<name>.json``) and
its traffic mix (``traffic/<name>.json``), and the generators and metric
readers they name (``generators/<name>.py``, ``metrics/<name>.py``). A new
cell, configuration, mix or metric is new files and entries; no file here
changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]  # the cell's end-to-end metrics
    per_layer: list[dict]  # the cell's per-layer metrics
    root: str  # the directory of the harness's files
    bench: str  # the benchmark file it came from


def load_module(path: str):
    """A module from a file, by path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + os.path.basename(path)[:-3].replace(".", "_")
        .replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(root: str, name: str):
    return load_module(os.path.join(root, "generators", f"{name}.py"))


def metric_reader(root: str, name: str):
    return load_module(os.path.join(root, "metrics", f"{name}.py"))


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_of_cell if "moves" in metric else True


def load(workload: str, bench_path: str = "BENCHMARK.json",
         root: str = HERE) -> Cell:
    """The cell ``workload`` of the benchmark file ``bench_path``; its
    configuration and traffic files are read under ``root``."""
    with open(bench_path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the benchmark has "
                         f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(os.path.dirname(os.path.abspath(bench_path)),
                           configs[w["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(name=workload, chips=w["chips"], config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer,
                root=root, bench=os.path.abspath(bench_path))
