"""The port's data-parallel mesh (``tpu_pattern_matching_torch.parallel.mesh``
and ``MatchSession(mesh=...)``) at 2 and 4 gloo ranks on the CPU, held to
the reference on a 2- and a 4-device mesh with tolerance 0.

The cases mirror tests/test_multichip.py. For each world size W one
fixture builds every case's inputs from seeds (tables, filters and the
global batches, by the reference's own code), starts W ranks of
tests/torch_mesh_worker.py once (a ``file://`` rendezvous in tmp, so
concurrent test workers never share a port), computes the reference on
the first W of conftest's virtual CPU devices while the ranks run, and
collects the ranks' ``npz`` outputs. Rank r runs lanes ``[r*C_local,
(r+1)*C_local)`` of each global batch; its lanes are rebased to global
ones before the comparison: the union of the ranks' events equals the
reference's, and every global total, ``gcounts``, ``metas``, ``flags`` and
``needs`` equals the reference's on every rank.
"""

import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from tests.fixtures import planted_binary
from tpu_pattern_matching.core.dfa import (
    ALPHABET_USHORT,
    AhoCorasick,
    compile_patterns,
)
from tpu_pattern_matching.core.oracle import match_python
from tpu_pattern_matching.ops.bloom import BloomFilterTable
from tpu_pattern_matching.ops.table import DeviceTable
from tpu_pattern_matching.parallel.mesh import (
    MeshContext,
    ShardedBloomCounter,
    make_mesh,
    make_sharded_bloom_count_step,
    make_sharded_bloom_step,
    make_sharded_scan_step,
)
from tpu_pattern_matching.runtime.buffers import HostBatch, StreamState
from tpu_pattern_matching.runtime.session import MatchSession as RefSession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")
FIELDS = ("data", "start_t", "end_t", "file_ids", "base_off")
WORLDS = (2, 4)
RANK_TIMEOUT_S = 400  # every rank is killed past it and the world fails

# ------------------------------------------------------------------- cases
# Each case function returns (params, table, bloom filter or None, global
# batches); ``params["kind"]`` names the worker's runner.

PATS3 = [b"\xde\xad\xbe\xef", b"needle!", b"abcab"]
WORDS = (b" alpha  beta  alpha  gamma " * 40) + b" beta "


def stream_batches(sess, data: bytes) -> list[dict]:
    """The global batches ``sess.scan_stream`` would scan, as copies."""
    buf = sess.new_buffer()
    stream = StreamState(file_id=0)
    fobj = io.BytesIO(data)
    out = []
    while True:
        code, rd = buf.add_stream(fobj, stream)
        eof = rd == 0 and code != -1
        if eof:
            buf.finalize_stream(stream)
        if buf.chunks and (code == -1 or eof):
            b = buf.to_batch()
            out.append(dict({f: getattr(b, f).copy() for f in FIELDS},
                            halo=b.halo, chunks=b.chunks))
            buf.reset()
        if eof:
            return out


def host_batch(b: dict) -> HostBatch:
    return HostBatch(**b)


def session_case(ctx, table, data, max_chunks, chunk_len, **kw):
    """A session case: the reference session on ``ctx`` cuts the global
    batches; the port's ranks get its filter."""
    ref = RefSession(table, max_chunks=max_chunks, chunk_len=chunk_len,
                     mesh=ctx, **kw)
    params = dict(kind="session", max_chunks=max_chunks, chunk_len=chunk_len,
                  session=kw)
    return params, table, getattr(ref, "bloom_table", None), stream_batches(
        ref, data)


def ushort_problem():
    rng = np.random.RandomState(17)
    pat_list = [
        tuple(int(x) for x in rng.randint(0, 2048, size=rng.randint(2, 6)))
        for _ in range(8)
    ]
    ac = AhoCorasick(ALPHABET_USHORT)
    for p in pat_list:
        ac.add_pattern(p)
    seq = rng.randint(0, 2048, size=4000)
    for pos in range(10, 3900, 333):
        p = pat_list[pos % len(pat_list)]
        seq[pos : pos + len(p)] = p
    return ac.compile(), (",".join(str(int(x)) for x in seq)).encode()


def lanes_batch(data: np.ndarray, halo: int = 0) -> list[dict]:
    C, T = data.shape
    return [dict(data=data, start_t=np.zeros(C, np.int32),
                 end_t=np.full(C, T, np.int32),
                 file_ids=np.zeros(C, np.int32),
                 base_off=np.zeros(C, np.int64), halo=halo, chunks=C)]


def case_scan_planted(ctx, W):
    data, _ = planted_binary(21, 1 << 14, PATS3, 30)
    table = compile_patterns(PATS3)
    sess = RefSession(table, max_chunks=64, chunk_len=256, engine="dense")
    return (dict(kind="scan_step", max_results=16), table, None,
            stream_batches(sess, data)[:1])


def case_scan_abc(ctx, W):
    table = compile_patterns([b"ab", b"bc"])
    sess = RefSession(table, max_chunks=16, chunk_len=64, engine="dense")
    return (dict(kind="scan_step", max_results=64), table, None,
            stream_batches(sess, b"abcabc" * 100)[:1])


def case_bloom_step(ctx, W):
    rng = np.random.RandomState(3)
    pats = [bytes(rng.randint(0, 256, size=8).astype(np.uint8))
            for _ in range(16)]
    table = compile_patterns(pats)
    lanes = 128 * W
    data = rng.randint(0, 256, size=(lanes, 256)).astype(np.uint8)
    for ln in (0, 130, lanes - 1):  # planted occurrences on several ranks
        data[ln, 100:108] = np.frombuffer(pats[ln % 16], np.uint8)
    return (dict(kind="bloom_step"), table,
            BloomFilterTable.from_table(table), lanes_batch(data))


def case_bloom_unaligned(ctx, W):
    table = compile_patterns([b"abcdef"])
    data = np.zeros((64 * W, 256), np.uint8)  # 64 lanes a rank
    return (dict(kind="bloom_step"), table,
            BloomFilterTable.from_table(table), lanes_batch(data))


def count_words(ctx, W, **kw):
    table = compile_patterns([b" alpha ", b" beta ", b" gamma "])
    params, _t, bft, batches = session_case(ctx, table, WORDS, W * 128, 64,
                                            engine="bloom")
    return dict(params, kind="count_step", **kw), table, bft, batches[:1]


def case_count_step(ctx, W):
    return count_words(ctx, W, counter=False, refine=False, k_cand=512,
                       k_ev=512, k_walk=None)


def case_count_step_refined(ctx, W):
    rng = np.random.RandomState(21)
    pats = [bytes(rng.randint(97, 123, size=6).astype(np.uint8))
            for _ in range(30)]
    words = bytearray(rng.randint(97, 123, size=W * 128 * 64).astype(
        np.uint8))
    for pos in range(50, len(words) - 6, 977):
        words[pos : pos + 6] = pats[pos % 30]
    table = compile_patterns(pats)
    params, _t, bft, batches = session_case(ctx, table, bytes(words),
                                            W * 128, 64, engine="bloom")
    return (dict(params, kind="count_step", counter=False, refine=True,
                 k_cand=2048, k_ev=2048, k_walk=512), table, bft,
            batches[:1])


def counter_case(ctx, W, **kw):
    table = compile_patterns([b"ababab"])
    params, _t, bft, batches = session_case(
        ctx, table, b"ab" * (W * 128 * 32), W * 128, 64, engine="bloom")
    return (dict(params, kind="count_step", counter=True, refine=True, **kw),
            table, bft, batches[:1])


def case_counter_default(ctx, W):
    return counter_case(ctx, W, k_cand=4096, k_ev=4096, k_walk=None)


def case_counter_small(ctx, W):
    return counter_case(ctx, W, k_cand=256, k_ev=256, k_walk=256)


def case_session_bloom(ctx, W):
    data, _ = planted_binary(77, 1 << 14, PATS3, 25)
    return session_case(ctx, compile_patterns(PATS3), data, 16, 128,
                        engine="bloom")


def case_session_dense(ctx, W):
    data, _ = planted_binary(77, 1 << 14, PATS3, 25)
    return session_case(ctx, compile_patterns(PATS3), data, 16, 128,
                        engine="dense")


def case_session_groups(ctx, W):
    table = compile_patterns([b" alpha ", b" beta ", b" gamma "])
    return session_case(ctx, table, WORDS, 16, 64, engine="bloom")


def case_session_device(ctx, W):
    data, _ = planted_binary(5, 1 << 14, PATS3, 40)
    return session_case(ctx, compile_patterns(PATS3), data, 16, 128,
                        engine="bloom", verify="device")


def case_session_device_passes(ctx, W):
    # past the device-verify cap (forced to 8 candidates in the ranks)
    # each rank verifies its lanes in passes, where the reference falls
    # back to host verify (ROADMAP queue 3); every output stays equal
    params, *rest = case_session_device(ctx, W)
    return (dict(params, max_device_cand=8), *rest)


def case_session_device_overflow(ctx, W):
    # a match every 2 bytes: the first dispatch's event capacity overflows
    return session_case(ctx, compile_patterns([b"ababab"]),
                        b"ab" * (1 << 13), 16, 256, engine="bloom",
                        verify="device")


def case_ushort_bloom(ctx, W):
    table, text = ushort_problem()
    return session_case(ctx, table, text, 16, 64, engine="bloom")


def case_ushort_device(ctx, W):
    table, text = ushort_problem()
    return session_case(ctx, table, text, 16, 64, engine="bloom",
                        verify="device")


def case_ushort_dense(ctx, W):
    table, text = ushort_problem()
    return session_case(ctx, table, text, 16, 64, engine="dense",
                        max_results=64)


def case_dense_cap(ctx, W):
    # 32 matches in every 64-byte lane, 512 lanes a rank: 16384 tuples a
    # rank, past the reference's 8192-tuple block
    lanes = 512 * W
    return session_case(ctx, compile_patterns([b"ab"]), b"ab" * (lanes * 32),
                        lanes, 64, engine="dense", max_results=64)


def case_mesh_spec(ctx, W):
    return (dict(kind="mesh_spec"), compile_patterns([b"ab"]), None,
            lanes_batch(np.zeros((W, 8), np.uint8)))


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}
SESSION_CASES = [n for n in CASES if n.startswith(("session", "ushort"))]


# --------------------------------------------------------------- reference


def reference(ctx, params, table, bft, batches):
    """The reference's outputs of one case on the mesh ``ctx``."""
    kind = params["kind"]
    b = batches[0]
    if kind == "mesh_spec":  # the reference's int spec: the first n devices
        return dict(size=MeshContext(make_mesh(
            jax.devices()[: ctx.num_devices])).num_devices)
    if kind == "scan_step":
        dev = DeviceTable.put(table, ctx.replicated)
        step = make_sharded_scan_step(
            ctx, dev, halo=b["halo"], max_results=params["max_results"],
            num_groups=table.num_groups)
        out = step(dev.table_flat, dev.state_gid,
                   jax.device_put(b["data"], ctx.lane_sharded),
                   b["start_t"], b["end_t"])
        return dict(zip(("counts", "slot_state", "slot_pos", "gcounts"),
                        (np.asarray(x) for x in out)))
    if kind == "bloom_step":
        bloom = bft.put(ctx.replicated)
        step = make_sharded_bloom_step(ctx, bloom)
        try:
            meta, bits = step(
                bloom.words, jax.device_put(b["data"], ctx.lane_sharded),
                jax.device_put(np.stack([b["start_t"], b["end_t"]]),
                               ctx.lane_sharded2d))
        except ValueError as e:
            return dict(error=str(e))
        return dict(meta=np.asarray(meta), bits=np.asarray(bits))
    if kind == "count_step":
        bloom = bft.put(ctx.replicated)
        gram_keys = bft.gram_keys if params["refine"] else None
        data = jax.device_put(b["data"], ctx.lane_sharded)
        bounds = jax.device_put(np.stack([b["start_t"], b["end_t"]]),
                                ctx.lane_sharded2d)
        if params["counter"]:
            counter = ShardedBloomCounter(
                ctx, bloom, table, halo=b["halo"], k_cand=params["k_cand"],
                k_ev=params["k_ev"], gram_keys=gram_keys,
                k_walk=params["k_walk"])
            rounds = []
            step = counter._step

            def counted(*args):
                rounds[-1] += 1
                return step(*args)

            counter._step = counted
            out = {}
            for i in range(2):
                rounds.append(0)
                gcounts, n_ev = counter.count(data, bounds)
                out[f"gcounts_{i}"] = gcounts
                out[f"n_events_{i}"] = n_ev
            return dict(out, rounds=rounds,
                        caps=[counter.k_cand, counter.k_ev, counter.k_walk])
        step = make_sharded_bloom_count_step(
            ctx, bloom, table, halo=b["halo"], k_cand=params["k_cand"],
            k_ev=params["k_ev"], gram_keys=gram_keys,
            k_walk=params["k_walk"])
        out = step(bloom.words,
                   jax.device_put(np.ascontiguousarray(
                       table.goto_signed).reshape(-1), ctx.replicated),
                   jax.device_put(table.state_gid.astype(np.int32),
                                  ctx.replicated),
                   data, bounds)
        return dict(zip(("gcounts", "n_events", "flags", "needs"),
                        (np.asarray(x) for x in out)))
    sess = RefSession(table, max_chunks=params["max_chunks"],
                      chunk_len=params["chunk_len"], mesh=ctx,
                      bloom_table=bft, **params["session"])
    out = dict(max_chunks=sess.max_chunks, batches=[])
    for b in batches:
        batch = host_batch(b)
        bm = sess.decode(batch, sess.scan(batch))
        n, gc = sess.decode_counts(batch, sess.scan(batch))
        out["batches"].append(dict(
            events=sorted((e.lane, e.file_id, e.end_offset, e.gid,
                           e.rep_index) for e in bm.events),
            totals=(bm.total, bm.reported, bm.overflowed),
            event_groups=sess.event_group_counts(bm),
            counts=np.concatenate([[n], gc])))
    return out


def write_case(case_dir, params, table, bft, batches):
    os.makedirs(case_dir)
    with open(os.path.join(case_dir, "case.json"), "w") as f:
        json.dump(params, f)
    table.save(os.path.join(case_dir, "table.npz"))
    if bft is not None:
        bft.save(os.path.join(case_dir, "bloom.npz"))
    arrays = {f"{f}_{i}": b[f] for i, b in enumerate(batches) for f in FIELDS}
    np.savez(os.path.join(case_dir, "batches.npz"), n=len(batches),
             halo=batches[0]["halo"], **arrays)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"W{w}")
def world(request, tmp_path_factory):
    """{case: (reference outputs, [rank outputs])} of one world size."""
    W = request.param
    if len(jax.devices()) < W:
        pytest.skip(f"needs {W} (virtual) devices for the reference mesh")
    ctx = MeshContext(make_mesh(jax.devices()[:W]))
    tmp = tmp_path_factory.mktemp(f"mesh_w{W}")
    in_dir, out_dir = tmp / "in", tmp / "out"
    out_dir.mkdir()
    cases = {name: fn(ctx, W) for name, fn in CASES.items()}
    for name, case in cases.items():
        write_case(str(in_dir / name), *case)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    url = f"file://{tmp / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(W), url, str(in_dir),
         str(out_dir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        cwd=REPO, env=env) for r in range(W)]
    try:
        # the reference runs while the ranks do
        refs = {name: reference(ctx, *case) for name, case in cases.items()}
        logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0].decode()
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [f"rank {r} of {W} exited {p.returncode}:\n{log[-3000:]}"
              for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not failed, "\n".join(failed)
    outs = {}
    for name in cases:
        outs[name] = []
        for r in range(W):
            with np.load(out_dir / f"{name}.rank{r}.npz") as z:
                outs[name].append({k: z[k] for k in z.files})
    return W, {name: (refs[name], outs[name], cases[name][0])
               for name in cases}


def lane_slice(arr, r, W, axis=0):
    c = arr.shape[axis] // W
    return np.take(arr, range(r * c, (r + 1) * c), axis=axis)


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("case", ["scan_planted", "scan_abc"])
def test_scan_step_equals_reference(world, case):
    W, res = world
    ref, ranks, _ = res[case]
    for r, out in enumerate(ranks):
        for key in ("counts", "slot_state", "slot_pos"):
            np.testing.assert_array_equal(out[key], lane_slice(ref[key], r, W))
        np.testing.assert_array_equal(out["gcounts"], ref["gcounts"])
    assert ref["gcounts"].sum() > 0


def test_bloom_step_equals_reference(world):
    W, res = world
    ref, ranks, _ = res["bloom_step"]
    assert ref["meta"][0] > 0
    for r, out in enumerate(ranks):
        # [global total, max per-rank total] on every rank; local bitmap
        np.testing.assert_array_equal(out["meta"], ref["meta"])
        np.testing.assert_array_equal(out["bits"],
                                      lane_slice(ref["bits"], r, W, axis=1))


def test_unaligned_lanes_rejected(world):
    W, res = world
    ref, ranks, _ = res["bloom_unaligned"]
    assert "128" in ref["error"]
    for out in ranks:
        assert "128" in str(out["error"])


def test_mesh_size_must_equal_world(world):
    # a rank drives one device: an int mesh spec is the world size, and
    # any other size raises naming both (ROADMAP queue 3)
    W, res = world
    ref, ranks, _ = res["mesh_spec"]
    assert ref["size"] == W
    for r, out in enumerate(ranks):
        assert int(out["rank"]) == r
        assert str(out["error"]) == (
            f"mesh size {W + 1} is not the world size {W}: each rank "
            f"drives one device, so a mesh spans every rank of the process "
            f"group")


@pytest.mark.parametrize("case", ["count_step", "count_step_refined"])
def test_count_step_equals_reference(world, case):
    W, res = world
    ref, ranks, _ = res[case]
    assert int(ref["flags"]) == 0 and int(ref["n_events"]) > 0
    for out in ranks:
        for key in ("gcounts", "n_events", "flags", "needs"):
            np.testing.assert_array_equal(out[key], ref[key])


@pytest.mark.parametrize("case", ["counter_default", "counter_small"])
def test_counter_retries_equal_reference(world, case):
    W, res = world
    ref, ranks, params = res[case]
    want_n = len(match_python([b"ababab"], b"ab" * (W * 128 * 32)))
    for out in ranks:
        for i in range(2):
            assert int(out[f"n_events_{i}"]) == ref[f"n_events_{i}"] == want_n
            np.testing.assert_array_equal(out[f"gcounts_{i}"],
                                          ref[f"gcounts_{i}"])
        # the same capacity decisions, round for round, on every rank
        np.testing.assert_array_equal(out["rounds"], ref["rounds"])
        np.testing.assert_array_equal(out["caps"], ref["caps"])
    if params["k_ev"] == 256:
        assert ref["rounds"][0] > 1 and ref["caps"][1] > 256


@pytest.mark.parametrize("case", SESSION_CASES)
def test_session_equals_reference(world, case):
    W, res = world
    ref, ranks, params = res[case]
    kw = params["session"]
    global_totals = kw["engine"] == "dense" or kw.get("verify") == "device"
    n_ev = 0
    for out in ranks:
        assert int(out["max_chunks"]) == ref["max_chunks"]
        assert int(out["local_chunks"]) * W == ref["max_chunks"]
        # lane passes run exactly where the cap is forced
        assert bool(out["lane_passes"]) == ("max_device_cand" in params)
    for i, want in enumerate(ref["batches"]):
        got = sorted(tuple(e) for out in ranks for e in out[f"events_{i}"])
        assert got == want["events"], (i, len(got), len(want["events"]))
        n_ev += len(got)
        totals = [out[f"totals_{i}"] for out in ranks]
        counts = [out[f"counts_{i}"] for out in ranks]
        groups = sum(out[f"event_groups_{i}"] for out in ranks)
        np.testing.assert_array_equal(groups, want["event_groups"])
        r_total, r_reported, r_over = want["totals"]
        assert sum(t[1] for t in totals) == r_reported
        if global_totals:  # the reference's global totals, on every rank
            assert all(t[0] == r_total and t[2] == r_over for t in totals)
            for c in counts:
                np.testing.assert_array_equal(c, want["counts"])
        else:  # this rank's lanes: their sum is the reference's
            assert sum(t[0] for t in totals) == r_total and not r_over
            np.testing.assert_array_equal(sum(counts), want["counts"])
    assert n_ev > 0


def test_dense_cap_divergence(world):
    # the reference caps each device's packed block at 8192 tuples and
    # flags the rest as overflow; the port's rank returns every event
    # (ROADMAP queue 3)
    W, res = world
    ref, ranks, params = res["dense_cap"]
    (want,) = ref["batches"]
    r_total, r_reported, r_over = want["totals"]
    assert r_over and r_reported == 8192 * W < r_total
    lanes = params["max_chunks"]
    assert r_total == lanes * 32
    got = sorted(tuple(e) for out in ranks for e in out["events_0"])
    assert len(got) == r_total and set(want["events"]) <= set(got)
    for out in ranks:
        total, reported, over = out["totals_0"]
        assert (total, reported, over) == (r_total, r_total // W, 0)


# ------------------------------------------------------ in-process checks


def test_rendezvous_and_device_specs():
    import torch

    from tpu_pattern_matching_torch.parallel import mesh

    assert mesh.coordinator_url("localhost:29500") == "tcp://localhost:29500"
    assert mesh.coordinator_url("file:///tmp/r") == "file:///tmp/r"
    with pytest.raises(ValueError, match="coordinator"):
        mesh.coordinator_url(None)
    assert mesh.rank_device("cpu", 3) == torch.device("cpu")
    assert mesh.default_backend(torch.device("cpu")) == "gloo"
    # a single process joins no group; an existing one is never replaced
    assert mesh.init_distributed("localhost:1", 1, 0, device="cpu") is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mesh.rank_device("cuda", 1)


def test_decode_dense_mesh_equals_loop_version():
    # the session's one dense decode, on a rank's packed block in the
    # mesh's meta layout, against the reference's per-event loop, on
    # random blocks, sorted and not
    import torch

    from tpu_pattern_matching_torch.core.dfa import (
        compile_patterns as port_compile,
    )
    from tpu_pattern_matching_torch.parallel.mesh import MeshDenseMatches
    from tpu_pattern_matching_torch.runtime.buffers import (
        HostBatch as PortBatch,
    )
    from tpu_pattern_matching_torch.runtime.session import MatchSession

    rng = np.random.RandomState(5)
    table = port_compile([b"ab", b"b", b"abc", b"bcd", b"cd"])
    G = table.num_groups
    for sort in (False, True):
        sess = MatchSession(table, engine="dense", device="cpu", sort=sort)
        groups = table.groups_as_lists()
        for trial in range(20):
            C, cap = 32, int(rng.randint(1, 300))
            rep = int(rng.randint(0, cap + 1))
            batch = PortBatch(
                data=np.zeros((C, 8), np.uint8), start_t=np.zeros(C, np.int32),
                end_t=np.full(C, 8, np.int32),
                file_ids=rng.randint(0, 3, size=C).astype(np.int32),
                base_off=rng.randint(0, 1 << 20, size=C).astype(np.int64),
                chunks=C, halo=int(rng.randint(0, 9)))
            packed = np.zeros((5, cap), np.int32)
            packed[0] = rng.randint(0, C, size=cap)
            packed[1] = rng.randint(0, 64, size=cap)
            packed[3] = rng.randint(0, G, size=cap)
            g_total = rep + int(rng.randint(0, 3))
            metas = np.array([g_total, rep, rep, rep], np.int32)
            comp = MeshDenseMatches(torch.from_numpy(metas),
                                    torch.from_numpy(packed),
                                    torch.zeros(G, dtype=torch.int32))
            bm = sess.decode(batch, comp)
            want = []  # the reference's loop (one device: no rebasing)
            for k in range(rep):
                ln, g = int(packed[0][k]), int(packed[3][k])
                want.append((int(batch.file_ids[ln]),
                             int(batch.base_off[ln]) + int(packed[1][k]),
                             groups[g], groups[g][0], ln, g))
            if sort:
                want.sort(key=lambda e: (e[0], e[1]))
            got = [(e.file_id, e.end_offset, e.pattern_indices, e.rep_index,
                    e.lane, e.gid) for e in bm.events]
            assert got == want, (sort, trial)
            assert (bm.total, bm.reported, bm.overflowed) == (
                g_total, rep, g_total > rep)
