"""One rank of the port's data-parallel mesh or ("pat", "data") grid, for
tests/test_torch_mesh.py and tests/test_torch_grid.py.

    python tests/torch_mesh_worker.py RANK WORLD RENDEZVOUS_URL IN_DIR OUT_DIR

Joins a gloo group of WORLD ranks on the CPU, runs every case directory of
IN_DIR in sorted order (every rank in the same order, so the collectives
line up) on its own lane slice ``[rank*C_local, (rank+1)*C_local)`` of the
case's global batches (on the grid, its column's slice ``[d*C_local,
(d+1)*C_local)``, ``d = rank // S``; a follower gets zeros of that shape,
since only its leader's batch counts), and writes
``OUT_DIR/<case>.rank<RANK>.npz``. A case is ``case.json`` (its kind and
parameters; ``n_shards`` for the grid), ``table.npz`` (a saved
``DfaTable``), optionally ``bloom.npz`` (a saved ``BloomFilterTable`` or
sharded ``ShardedBloom``) and ``batches.npz`` (global batches
``<field>_<i>``). It imports neither jax nor the JAX package: both are
blocked before anything is imported.
"""

import json
import os
import sys

sys.modules["jax"] = None  # any import of jax now raises
sys.modules["jaxlib"] = None
sys.modules["tpu_pattern_matching"] = None
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_pattern_matching_torch.core.dfa import DfaTable  # noqa: E402
from tpu_pattern_matching_torch.cli import load_bloom  # noqa: E402
from tpu_pattern_matching_torch.ops.table import DeviceTable  # noqa: E402
from tpu_pattern_matching_torch.parallel import mesh, pshard  # noqa: E402
from tpu_pattern_matching_torch.runtime.buffers import HostBatch  # noqa: E402
from tpu_pattern_matching_torch.runtime.session import (  # noqa: E402
    MatchSession,
)

FIELDS = ("data", "start_t", "end_t", "file_ids", "base_off")


def global_batches(path: str) -> list[dict]:
    with np.load(path) as z:
        n = int(z["n"])
        halo = int(z["halo"])
        return [dict({f: z[f"{f}_{i}"] for f in FIELDS}, halo=halo)
                for i in range(n)]


def local_batch(b: dict, rank: int, c_local: int,
                shape_only: bool = False) -> HostBatch:
    """This rank's lane slice of a global batch (zeros of its shape when
    ``shape_only``: a grid follower's batch)."""
    lanes = slice(rank * c_local, (rank + 1) * c_local)
    part = {f: np.ascontiguousarray(b[f][lanes]) for f in FIELDS}
    if shape_only:
        part = {f: np.zeros_like(a) for f, a in part.items()}
    chunks = int(np.count_nonzero(part["file_ids"] >= 0))
    return HostBatch(chunks=chunks, halo=b["halo"], **part)


def tensors(ctx, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(ctx.device)
            for a in arrays]


def run_scan_step(ctx, p, table, bft, batches):
    b = global_batches(batches)[0]
    c_local = b["data"].shape[0] // ctx.world_size
    lanes = slice(ctx.rank * c_local, (ctx.rank + 1) * c_local)
    dev = DeviceTable.put(table, ctx.device)
    step = mesh.make_sharded_scan_step(
        ctx, dev, halo=b["halo"], max_results=p["max_results"],
        num_groups=table.num_groups)
    out = step(dev.table_flat, dev.state_gid,
               *tensors(ctx, b["data"][lanes], b["start_t"][lanes],
                        b["end_t"][lanes]))
    return dict(zip(("counts", "slot_state", "slot_pos", "gcounts"),
                    (t.numpy() for t in out)))


def run_bloom_step(ctx, p, table, bft, batches):
    b = global_batches(batches)[0]
    c_local = b["data"].shape[0] // ctx.world_size
    lanes = slice(ctx.rank * c_local, (ctx.rank + 1) * c_local)
    bloom = bft.put(ctx.device)
    step = mesh.make_sharded_bloom_step(ctx, bloom)
    data, start, end = tensors(ctx, b["data"][lanes], b["start_t"][lanes],
                               b["end_t"][lanes])
    try:
        meta, bits = step(bloom.words, data, torch.stack([start, end]))
    except ValueError as e:  # raised before any collective, on every rank
        return dict(error=np.array(str(e)))
    return dict(meta=meta.numpy(), bits=bits.numpy())


def run_count_step(ctx, p, table, bft, batches):
    b = global_batches(batches)[0]
    c_local = b["data"].shape[0] // ctx.world_size
    lanes = slice(ctx.rank * c_local, (ctx.rank + 1) * c_local)
    bloom = bft.put(ctx.device)
    data, start, end = tensors(ctx, b["data"][lanes], b["start_t"][lanes],
                               b["end_t"][lanes])
    bounds = torch.stack([start, end])
    gram_keys = bft.gram_keys if p["refine"] else None
    if p["counter"]:
        counter = mesh.ShardedBloomCounter(
            ctx, bloom, table, halo=b["halo"], k_cand=p["k_cand"],
            k_ev=p["k_ev"], gram_keys=gram_keys, k_walk=p["k_walk"])
        rounds = []
        step = counter._step

        def counted(*args):
            rounds[-1] += 1
            return step(*args)

        counter._step = counted
        out = {}
        for i in range(2):  # the second count starts at sticky capacities
            rounds.append(0)
            gcounts, n_ev = counter.count(data, bounds)
            out[f"gcounts_{i}"] = gcounts
            out[f"n_events_{i}"] = np.array(n_ev)
        out["rounds"] = np.array(rounds)
        out["caps"] = np.array([counter.k_cand, counter.k_ev,
                                counter.k_walk])
        return out
    step = mesh.make_sharded_bloom_count_step(
        ctx, bloom, table, halo=b["halo"], k_cand=p["k_cand"],
        k_ev=p["k_ev"], gram_keys=gram_keys, k_walk=p["k_walk"])
    table_flat, state_gid = tensors(
        ctx, table.goto_signed.reshape(-1), table.state_gid.astype(np.int32))
    out = step(bloom.words, table_flat, state_gid, data, bounds)
    return dict(zip(("gcounts", "n_events", "flags", "needs"),
                    (t.numpy() for t in out)))


def run_session(ctx, p, table, bft, batches):
    from tpu_pattern_matching_torch.ops import verify_device

    cap, lane_passes = verify_device.MAX_DEVICE_CAND, verify_device.lane_passes
    calls = []

    def counted(*args):
        calls.append(1)
        return lane_passes(*args)

    # a case may force device verify's lane passes with a smaller cap
    mesh.MAX_DEVICE_CAND = verify_device.MAX_DEVICE_CAND = p.get(
        "max_device_cand", cap)
    verify_device.lane_passes = counted
    try:
        out = session_outputs(ctx, p, table, bft, batches)
    finally:
        mesh.MAX_DEVICE_CAND = verify_device.MAX_DEVICE_CAND = cap
        verify_device.lane_passes = lane_passes
    return dict(out, lane_passes=np.array(len(calls)))


def session_outputs(ctx, p, table, bft, batches):
    sess = MatchSession(table, max_chunks=p["max_chunks"],
                        chunk_len=p["chunk_len"], mesh="all", device="cpu",
                        bloom_table=bft, **p["session"])
    c_local = sess.local_chunks
    grid = sess._grid
    col = grid.data_index if grid else ctx.rank
    out = dict(max_chunks=np.array(sess.max_chunks),
               local_chunks=np.array(c_local))
    for i, b in enumerate(global_batches(batches)):
        if b["data"].shape[0] != sess.max_chunks:
            raise ValueError(f"batch of {b['data'].shape[0]} lanes, session "
                             f"of {sess.max_chunks}")
        batch = local_batch(b, col, c_local,
                            shape_only=grid is not None and not grid.is_leader)
        bm = sess.decode(batch, sess.scan(batch))
        ev = bm.events
        out[f"events_{i}"] = np.array(
            [[e.lane + col * c_local, e.file_id, e.end_offset, e.gid,
              e.rep_index] for e in ev], np.int64).reshape(-1, 5)
        out[f"pids_{i}"] = np.array(
            [len(e.pattern_indices) for e in ev] + [
                pid for e in ev for pid in e.pattern_indices], np.int64)
        out[f"totals_{i}"] = np.array([bm.total, bm.reported,
                                       bm.overflowed])
        out[f"event_groups_{i}"] = sess.event_group_counts(bm)
        n, gc = sess.decode_counts(batch, sess.scan(batch))
        out[f"counts_{i}"] = np.concatenate([[n], gc])
    return out


def run_mesh_spec(ctx, p, table, bft, batches):
    """``as_mesh_context`` of the world size, and of one more."""
    same = mesh.as_mesh_context(ctx.world_size, "cpu")
    try:
        mesh.as_mesh_context(ctx.world_size + 1, "cpu")
    except ValueError as e:
        return dict(error=np.array(str(e)), rank=np.array(same.rank))
    return dict(rank=np.array(same.rank))


# ------------------------------------------------------------------ the grid


def grid_inputs(ctx, p, bft, batches):
    """(grid, this rank's shard filter, its column's data and bounds, the
    global batch) of a grid step case."""
    grid = pshard.Mesh2DContext.build(ctx, p["n_shards"])
    b = global_batches(batches)[0]
    c_local = b["data"].shape[0] // grid.data_size
    lanes = slice(grid.data_index * c_local, (grid.data_index + 1) * c_local)
    data, start, end = tensors(ctx, b["data"][lanes], b["start_t"][lanes],
                               b["end_t"][lanes])
    return (grid, bft.put_shard(grid.pat_index, ctx.device), data,
            torch.stack([start, end]), b)


def run_grid_bloom_step(ctx, p, table, bft, batches):
    grid, bloom, data, bounds, _b = grid_inputs(ctx, p, bft, batches)
    step = pshard.make_pattern_sharded_bloom_step(grid, bloom)
    meta, union = step(bloom.words, data, bounds)
    return dict(meta=meta.numpy(), bits=union.numpy())


def run_grid_count_step(ctx, p, table, bft, batches):
    grid, bloom, data, bounds, b = grid_inputs(ctx, p, bft, batches)
    tab = pshard.shard_table(table, bft.parts[grid.pat_index])
    step = pshard.make_pattern_sharded_count_step(
        grid, bloom, tab, halo=b["halo"], k_cand=p["k_cand"],
        k_ev=p["k_ev"], k_walk=p["k_walk"],
        shard_gram_keys=bft.shard_gram_keys if p["refine"] else None)
    table_flat, state_gid = tensors(
        ctx, tab.goto_signed.reshape(-1), tab.state_gid.astype(np.int32))
    out = step(bloom.words, table_flat, state_gid, data, bounds)
    return dict(zip(("gcounts", "n_events", "flags"),
                    (t.numpy() for t in out)))


def run_grid_verify(ctx, p, table, bft, batches):
    """The probe step, then ``PshardDeviceVerifier.verify_rows`` and the
    merge, twice (the second dispatch starts at the sticky capacity)."""
    grid, bloom, data, bounds, b = grid_inputs(ctx, p, bft, batches)
    step = pshard.make_pattern_sharded_bloom_step(grid, bloom)
    meta, union = step(bloom.words, data, bounds)
    dvf = pshard.PshardDeviceVerifier(
        grid, bft, pshard.shard_table(table, bft.parts[grid.pat_index]),
        b["halo"])
    out = {}
    for i in range(2):
        sh, ln, e, g, gc = dvf.verify_rows(data, bounds, union,
                                           int(meta[1]))
        out[f"rows_{i}"] = np.stack([sh, ln, e, g])
        out[f"gcounts_{i}"] = gc
        ln_m, e_m, bnd, pids = pshard.merge_shard_rows(sh, ln, e, g,
                                                       dvf.shard_groups)
        c_local = data.shape[0]
        out[f"merged_{i}"] = np.stack([ln_m + grid.data_index * c_local,
                                       e_m])
        out[f"bounds_{i}"], out[f"pids_{i}"] = bnd, pids
    out["k_walk"] = np.array(dvf._k_walk)
    return out


def run_grid_spec(ctx, p, table, bft, batches):
    """A grid of one shard more than the ranks, built directly and through
    a session: both raise, before any group exists."""
    errors = []
    for build in (lambda: pshard.Mesh2DContext.build(ctx, ctx.world_size + 1),
                  lambda: MatchSession(table, mesh="all", device="cpu",
                                       pat_shards=ctx.world_size + 1)):
        try:
            build()
        except ValueError as e:
            errors.append(str(e))
    return dict(errors=np.array(errors))


KINDS = {"scan_step": run_scan_step, "bloom_step": run_bloom_step,
         "count_step": run_count_step, "session": run_session,
         "mesh_spec": run_mesh_spec, "grid_bloom_step": run_grid_bloom_step,
         "grid_count_step": run_grid_count_step,
         "grid_verify": run_grid_verify, "grid_spec": run_grid_spec}


def main(rank: int, world: int, url: str, in_dir: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    mesh.init_distributed(url, world, rank, device="cpu")
    ctx = mesh.world_context("cpu")
    if (ctx.rank, ctx.world_size, ctx.backend) != (rank, world, "gloo"):
        raise RuntimeError(f"joined as {ctx}")
    for name in sorted(os.listdir(in_dir)):
        case = os.path.join(in_dir, name)
        with open(os.path.join(case, "case.json")) as f:
            p = json.load(f)
        table = DfaTable.load(os.path.join(case, "table.npz"))
        bloom_path = os.path.join(case, "bloom.npz")
        bft = (load_bloom(bloom_path) if os.path.exists(bloom_path)
               else None)
        out = KINDS[p["kind"]](ctx, p, table, bft,
                               os.path.join(case, "batches.npz"))
        np.savez(os.path.join(out_dir, f"{name}.rank{rank}.npz"), **out)
    imported = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "tpu_pattern_matching") and sys.modules[m]]
    if imported:
        raise RuntimeError(f"imported {imported}")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
