"""Entry point of the PyTorch port (counterpart of the reference's
``__graft_entry__.entry``).

``entry(device)`` returns the single-device forward step of the flagship
engine (the bloom probe: pad + transpose + probe + popcount,
``ops.bloom.hits``) and its example arguments on the reference's small
problem: 32 random patterns of 4-11 bytes (``RandomState(0)``) and 16
lanes of ``halo + 64`` random bytes. On a CUDA device the step launches
the probe kernel; on the CPU it runs the kernel's plain version.

    python -m tpu_pattern_matching_torch.entry [--device cpu] [--multichip N]

``dryrun_multichip(n_ranks, device)`` runs the checks of the reference's
``dryrun_multichip`` on a ``torch.distributed`` mesh of ``n_ranks``
spawned ranks (gloo on the CPU): bloom, dense and device-verify ``find``
against the oracle, the pattern-shard block on an even number of ranks
(``pat_shards=2``, the ("pat", "data") grid, host and device verify), and
the sharded scan step's shapes.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch


def small_problem(num_lanes: int = 16, chunk_len: int = 64):
    """(table, halo, data, start_t, end_t): the reference's
    ``_small_problem`` with the same draws, as numpy arrays."""
    from tpu_pattern_matching_torch.core.dfa import compile_patterns

    rng = np.random.RandomState(0)
    patterns = [
        bytes(rng.randint(0, 256, size=rng.randint(4, 12)).astype(np.uint8))
        for _ in range(32)
    ]
    table = compile_patterns(patterns)
    halo = table.max_pat_len - 1
    data = rng.randint(0, 256, size=(num_lanes, halo + chunk_len)).astype(
        np.uint8)
    start_t = np.full(num_lanes, halo, np.int32)
    end_t = np.full(num_lanes, halo + chunk_len, np.int32)
    return table, halo, data, start_t, end_t


def entry(device="cuda"):
    """``(forward, (words, data, start_t, end_t))``: the forward scan step
    and its arguments as tensors on ``device`` (``"cuda"`` raises without
    a GPU). ``forward`` returns ``(total [1], bits [W, Cp])`` int32, the
    reference's ``_hits_jit`` outputs."""
    from tpu_pattern_matching_torch.ops.bloom import BloomFilterTable, hits
    from tpu_pattern_matching_torch.utils.device import resolve_device

    dev = resolve_device(device)
    table, _halo, data, start_t, end_t = small_problem()
    bft = BloomFilterTable.from_table(table)
    cfg = bft.cfg

    def forward(words, data, start_t, end_t):
        return hits(data, torch.stack([start_t, end_t]), words, cfg)

    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (bft.words, data, start_t, end_t))
    return forward, args


DRYRUN_TIMEOUT_S = 300  # every rank of dryrun_multichip, start to end


def _dryrun_rank(rank: int, world: int, url: str, device: str) -> None:
    """One rank of ``dryrun_multichip`` (a spawned process)."""
    import torch.distributed as dist

    from tpu_pattern_matching_torch.core.dfa import compile_patterns
    from tpu_pattern_matching_torch.core.oracle import match_python
    from tpu_pattern_matching_torch.ops.table import DeviceTable
    from tpu_pattern_matching_torch.parallel.mesh import (
        init_distributed,
        make_sharded_scan_step,
        world_context,
    )
    from tpu_pattern_matching_torch.runtime.session import MatchSession

    torch.set_num_threads(1)
    init_distributed(url, world, rank, device=device)
    try:
        ctx = world_context(device)
        patterns = [b"needle!", b"\xde\xad\xbe\xef", b"abcab"]
        table = compile_patterns(patterns)
        # each rank scans its own payload (one batch each, so the ranks'
        # scans stay in step)
        payload = (b"r%d " % rank + b"xx needle! xx" * 40
                   + b"\xde\xad\xbe\xef" + b"abcabcab")
        expect = sorted(match_python(patterns, payload))
        for kw in (dict(engine="bloom"), dict(engine="dense"),
                   dict(engine="bloom", verify="device")):
            sess = MatchSession(table, max_chunks=4 * world, chunk_len=64,
                                mesh=ctx, **kw)
            if sess.max_chunks % world:
                raise RuntimeError(f"{kw}: {sess.max_chunks} lanes")
            got = sess.find(payload)
            if got != expect:
                raise RuntimeError(f"rank {rank} {kw}: {got} != {expect}")
        if world % 2 == 0:
            # the ("pat", "data") grid: a column's two ranks scan one
            # payload, fed and decoded by the column's leader alone
            col_payload = (b"r%d " % (rank // 2) + b"xx needle! xx" * 40
                           + b"\xde\xad\xbe\xef" + b"abcabcab")
            col_expect = sorted(match_python(patterns, col_payload))
            for kw in (dict(), dict(verify="device")):
                sess = MatchSession(table, max_chunks=4 * world,
                                    chunk_len=64, mesh=ctx, engine="bloom",
                                    pat_shards=2, **kw)
                got = sess.find(col_payload)
                want = col_expect if sess._grid.is_leader else []
                if got != want:
                    raise RuntimeError(f"rank {rank} pshard {kw}: {got} != "
                                       f"{want}")
        # the per-group count-reduction step, on this rank's 4 lanes
        table2, halo, data, start_t, end_t = small_problem(
            num_lanes=4 * world)
        dev = DeviceTable.put(table2, ctx.device)
        step = make_sharded_scan_step(ctx, dev, halo=halo, max_results=16,
                                      num_groups=table2.num_groups)
        lanes = slice(4 * rank, 4 * rank + 4)
        counts, _slot_state, _slot_pos, gcounts = step(
            dev.table_flat, dev.state_gid,
            *(torch.from_numpy(np.ascontiguousarray(a[lanes])).to(ctx.device)
              for a in (data, start_t, end_t)))
        if (tuple(counts.shape) != (4,)
                or tuple(gcounts.shape) != (table2.num_groups,)):
            raise RuntimeError(f"scan step shapes {tuple(counts.shape)}, "
                               f"{tuple(gcounts.shape)}")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_ranks: int, device="cuda") -> None:
    """The reference's multi-chip dry run on ``n_ranks`` spawned ranks of
    a ``torch.distributed`` group (rendezvous in a temporary file; the
    backend as ``parallel.mesh.init_distributed`` picks it: gloo on the
    CPU, NCCL on CUDA devices, one rank per device): bloom (host verify),
    dense and device-verify ``MatchSession(mesh=...).find`` against the
    oracle on every rank, and the shapes of ``make_sharded_scan_step``'s
    outputs; on an even number of ranks also the reference's
    ``pat_shards=2`` block (the ("pat", "data") grid: a column's leader
    must find the oracle's events, its follower none). Raises
    RuntimeError when a rank fails or ``DRYRUN_TIMEOUT_S`` seconds
    pass."""
    import multiprocessing

    spawn = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tpm_dryrun.") as tmp:
        url = "file://" + os.path.join(tmp, "rendezvous")
        procs = [spawn.Process(target=_dryrun_rank,
                               args=(r, n_ranks, url, str(device)))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        raise RuntimeError(f"dryrun_multichip({n_ranks}): ranks {hung} "
                           f"timed out after {DRYRUN_TIMEOUT_S} s; exit "
                           f"codes {codes}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--multichip", type=int, default=0, metavar="N",
                    help="also run dryrun_multichip on N spawned ranks")
    a = ap.parse_args(argv)
    fn, args = entry(a.device)
    out = fn(*args)
    if out[0].is_cuda:
        torch.cuda.synchronize()
    print("entry OK:", [tuple(o.shape) for o in out])
    if a.multichip:
        dryrun_multichip(a.multichip, a.device)
        print(f"dryrun_multichip OK: {a.multichip} ranks" + (
            " (with the pat_shards=2 grid)" if a.multichip % 2 == 0 else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
