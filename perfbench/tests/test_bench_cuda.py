"""On the card: one short run of the first cell, whole, through the
benchmark's command. Skips without a CUDA card (decided in the fixture)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench.tests.conftest import REPO


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_first_cell_runs_correct(card):
    r = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        "ushort2k.long_flows", "--seed", "2147483999",
                        "--seconds", "3", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
