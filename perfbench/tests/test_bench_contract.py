"""``BENCHMARK.json`` keeps to the benchmark's format: its keys, names,
units and lengths, bounds, and every cell reporting ``setup_s``, another
end-to-end metric and a per-layer metric, each metric with a reader."""

from __future__ import annotations

import json
import os
import re

from perfbench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_file_format():
    path = os.path.join(REPO, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        b = json.load(f)
    assert set(b) == KEYS
    assert 1 <= len(b["command"]) <= 32 and all(map(text_ok, b["command"]))
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(REPO, p))
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and text_ok(c["source"]) and \
            text_ok(c["why"]) and len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        with open(os.path.join(REPO, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and text_ok(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(REPO, "perfbench", "metrics",
                                           f"{m['name']}.py"))
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert text_ok(w["why"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))

        def reports(m, cell=w["name"]):
            return "workloads" not in m or cell in m["workloads"]

        mine = [m for m in b["end_to_end"] if reports(m)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(reports(m) and m["moves"] in {x["name"] for x in mine}
                   for m in b["per_layer"])
    assert {w["config"] for w in b["workloads"]} == set(configs)
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)
