"""The port's entry point, fuzz campaign and ``kernel_debug`` on the CPU.

- ``entry.entry("cpu")`` equals ``__graft_entry__.entry()``: the same
  arguments, and its forward step (pad + transpose + probe + popcount)
  gives the reference's total and bitmap (the Pallas probe in interpret
  mode) bit for bit.
- ``entry.dryrun_multichip`` passes on 2 and 4 gloo ranks, the
  pattern-shard grid block included.
- ``tools.fuzz_campaign.run_trial`` passes its trials against the oracle
  (it raises on a divergence), and on the trials compared makes the
  reference campaign's draws and runs its arms: alone, every arm but the
  mesh arms; inside 2 gloo ranks, the mesh arms too.
- ``utils.debug.kernel_debug`` logs its values at ``TPM_DEBUG=2`` only,
  and below that touches none of them."""

import importlib.util
import json
import logging
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from tpu_pattern_matching_torch import entry as port_entry
from tpu_pattern_matching_torch.tools import fuzz_campaign
from tpu_pattern_matching_torch.utils import debug

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference campaign's arms that need a device mesh (the port's run
# inside a process group of 2 or more ranks)
MESH_ARMS = {"mesh_bloom", "mesh_device_verify", "pshard_device_verify",
             "mesh_dense", "u_mesh"}
RANK_TIMEOUT_S = 300  # each campaign rank is killed past it and the test fails
# one rank of the campaign in a gloo group: argv rank, world, url, trials
CAMPAIGN_RANK = """
import json, sys
sys.modules["jax"] = None
sys.modules["tpu_pattern_matching"] = None
import torch
from tpu_pattern_matching_torch.parallel import mesh
from tpu_pattern_matching_torch.tools import fuzz_campaign
torch.set_num_threads(1)
rank, world, url = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
mesh.init_distributed(url, world, rank, device="cpu")
out = [fuzz_campaign.run_trial(int(t), 0, "cpu") for t in sys.argv[4:]]
torch.distributed.destroy_process_group()
print(json.dumps(out))
"""


def test_entry_equals_reference():
    fn, args = port_entry.entry("cpu")
    r_fn, r_args = graft.entry()
    assert len(args) == len(r_args) == 4
    for a, r in zip(args, r_args):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    total, bits = fn(*args)
    r_total, r_bits = jax.jit(r_fn)(*r_args)
    assert total.dtype == bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy(), np.asarray(r_bits))
    assert total.shape == (1,) and int(total[0]) == int(r_total[0])
    assert bits.ndim == 2 and bits.shape[1] >= 16


def test_dryrun_multichip_on_two_gloo_ranks(capsys):
    # the checks of __graft_entry__.dryrun_multichip (its pat_shards=2
    # block on the grid of 2 ranks included) in 2 spawned ranks of a gloo
    # group; on 1 rank the grid block is left out, as the reference's is
    # on an odd device count
    port_entry.dryrun_multichip(2, device="cpu")
    assert port_entry.main(["--device", "cpu", "--multichip", "1"]) == 0
    assert "dryrun_multichip OK: 1 ranks\n" in capsys.readouterr().out


def test_dryrun_multichip_grid_block_on_four_gloo_ranks(capsys):
    # 4 ranks: the grid of 2 shards over 2 lane columns, each column's
    # leader finding its payload's oracle events and its follower none
    assert port_entry.main(["--device", "cpu", "--multichip", "4"]) == 0
    assert ("dryrun_multichip OK: 4 ranks (with the pat_shards=2 grid)"
            in capsys.readouterr().out)


def test_entry_main_runs_on_the_cpu(capsys):
    assert port_entry.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("entry OK:")


@pytest.mark.parametrize("trial", [0, 2, 3, 5, 6, 7])
def test_fuzz_trial_equals_oracle(trial):
    res = fuzz_campaign.run_trial(trial, 0, "cpu")
    assert res["arms"][0] == "bloom_auto" and "dense" in res["arms"]


def test_fuzz_campaign_summary_line(capsys):
    assert fuzz_campaign.main(["2", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[-1])
    assert rec["metric"] == "fuzz_campaign" and rec["trials"] == 2
    assert rec["master_seed"] == 3 and rec["mismatches"] == 0
    assert rec["arm_trials"]["bloom_auto"] == 2


@pytest.fixture(scope="module")
def ref_campaign():
    spec = importlib.util.spec_from_file_location(
        "ref_fuzz_campaign", os.path.join(REPO, "tools", "fuzz_campaign.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("trial", [1, 4])
def test_fuzz_trial_equals_reference_arm_by_arm(trial, ref_campaign):
    # trials 1 and 4 run the pattern-shard arm in both campaigns
    want = ref_campaign.run_trial(trial, 0)
    got = fuzz_campaign.run_trial(trial, 0, "cpu")
    assert got["events"] == want["events"]
    assert got["arms"] == [a for a in want["arms"] if a not in MESH_ARMS]
    assert "pat_shards" in got["arms"]


def test_fuzz_mesh_arms_in_two_gloo_ranks(ref_campaign, tmp_path):
    # trials 2 and 6 (mod 4 == 2) inside 2 gloo ranks: each rank runs the
    # reference's arms, mesh arms included, in its order, every arm's
    # events equal to the oracle's (the grid follower's: none)
    trials = ["2", "6"]
    url = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", CAMPAIGN_RANK, str(r), "2", url, *trials],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), text=True) for r in range(2)]
    try:
        want = [ref_campaign.run_trial(int(t), 0) for t in trials]
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err}"
        got = json.loads(out.splitlines()[-1])
        assert got == want, r
    assert MESH_ARMS <= set(want[0]["arms"]) | set(want[1]["arms"])


def test_kernel_debug_logs_at_level_2_only(monkeypatch, caplog):
    class Untouchable:
        def tolist(self):
            raise AssertionError("read below TPM_DEBUG=2")

    monkeypatch.setenv("TPM_DEBUG", "1")
    with caplog.at_level(logging.DEBUG, logger="tpu_pattern_matching_torch"):
        debug.kernel_debug("kernel value {}", Untouchable())
    assert "kernel value" not in caplog.text
    monkeypatch.setenv("TPM_DEBUG", "2")
    with caplog.at_level(logging.DEBUG, logger="tpu_pattern_matching_torch"):
        debug.kernel_debug("kernel value {} of {}",
                           torch.tensor([7], dtype=torch.int32),
                           torch.arange(3))
    assert "kernel value 7 of [0, 1, 2]" in caplog.text


def test_kernel_debug_call_sites(monkeypatch, caplog):
    # the reference's two sites: the probe's survivor count, and the
    # refined probe's counts before and after the exact-gram check
    from tpu_pattern_matching_torch.runtime.session import (
        session_for_patterns,
    )

    data = b"xxabcdexx" * 20
    for lvl, seen in (("1", False), ("2", True)):
        monkeypatch.setenv("TPM_DEBUG", lvl)
        caplog.clear()
        with caplog.at_level(logging.DEBUG,
                             logger="tpu_pattern_matching_torch"):
            s = session_for_patterns([b"abcd", b"cde"], max_chunks=4,
                                     chunk_len=64, device="cpu")
            assert len(s.find(data)) == 40
            # device verify attaches no refinement to the probe
            session_for_patterns([b"abcd", b"cde"], max_chunks=4,
                                 chunk_len=64, device="cpu",
                                 verify="device").find(data)
        assert ("after exact-gram refinement" in caplog.text) == seen
        assert ("survivor grams" in caplog.text) == seen
