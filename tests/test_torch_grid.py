"""The port's ("pat", "data") grid (``tpu_pattern_matching_torch.parallel.
pshard``'s ``Mesh2DContext`` and ``MatchSession(mesh=..., pat_shards=S)``)
on gloo ranks on the CPU, held to the reference's grid with tolerance 0.

Three grids: W = 2 ranks in S = 2 shards (D = 1 column), W = 4 in S = 2
(D = 2) and W = 4 in S = 4 (D = 1). For each, one fixture builds every
case's inputs from seeds (tables and sharded filters by the reference's
own code, saved and loaded by the port), starts W ranks of
tests/torch_mesh_worker.py once (a ``file://`` rendezvous in tmp),
computes the reference on ``Mesh2DContext.build(jax.devices()[:W], S)``
of conftest's virtual CPU devices while the ranks run, and collects the
ranks' outputs. Reference device (s, d) is port rank ``d*S + s``; rank
(s, d) runs column d's lanes ``[d*C_local, (d+1)*C_local)`` (a follower
gets zeros of that shape: only its leader's batch counts).

The cases mirror tests/test_pshard.py: the union bitmap and meta per
column; the count step, unrefined and refined, and its per-pattern
counts; device-verify event rows after the merge, and their counts,
twice (the sticky capacity); sessions' ``decode`` and ``decode_counts``
through host and device verify (the capacity-retry stream, lane passes
past a forced cap, the cross-shard co-terminators, ushort); a shard count
the world cannot hold. Only column leaders return events: the union of
the leaders' events equals the reference's.
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
from tests.test_torch_mesh import (
    FIELDS,
    REPO,
    RANK_TIMEOUT_S,
    WORKER,
    lanes_batch,
    stream_batches,
    ushort_problem,
    write_case,
)
from tpu_pattern_matching.core.dfa import AhoCorasick, compile_patterns
from tpu_pattern_matching.core.oracle import match_python
from tpu_pattern_matching.parallel.mesh import make_mesh
from tpu_pattern_matching.parallel.pshard import (
    Mesh2DContext as RefGrid,
    PshardDeviceVerifier as RefVerifier,
    ShardedBloom as RefSharded,
    global_pattern_counts as ref_global_counts,
    make_pattern_sharded_bloom_step as ref_bloom_step,
    make_pattern_sharded_count_step as ref_count_step,
    pad_shard_tables as ref_pad,
)
from tpu_pattern_matching.runtime.buffers import HostBatch, StreamState
from tpu_pattern_matching.runtime.session import MatchSession as RefSession

GRIDS = ((2, 2), (4, 2), (4, 4))  # (W ranks, S shards)
WORDS = (b" alpha  beta  alpha  gamma " * 30) + b" delta  beta "
WORD_PATS = [b" alpha ", b" beta ", b" gamma ", b" delta "]
THE_PATS = [b" the ", b" and ", b" of the ", b" to "]
THE_WORDS = b" the quick and the lazy of the to and the " * 400
COTERM = [b"wxyzabcd", b"abcd", b"qrst", b"zabcd"]


def rand_patterns(n, seed):
    rng = np.random.RandomState(seed)
    return [bytes(rng.randint(0, 256, size=rng.randint(6, 13)).astype(
        np.uint8)) for _ in range(n)]


def coterm_payload() -> bytes:
    payload = bytearray(b"." * 4000)
    payload[100:108] = COTERM[0]  # ends patterns 0, 1, 3 at offset 107
    payload[900:904] = COTERM[1]  # pattern 1 alone
    payload[2000:2005] = COTERM[3]  # ends patterns 3, 1
    return bytes(payload)


def shard_tables_of(table, sb):
    """The reference session's shard tables (one AhoCorasick a shard)."""
    out = []
    for part in sb.parts:
        ac = AhoCorasick(table.alphabet_size,
                         nocase=getattr(table, "nocase", False))
        for pid in part:
            ac.add_pattern(table.patterns[pid].symbols)
        out.append(ac.compile())
    return out


def one_batch(table, sb, data, max_chunks, chunk_len):
    """The first global batch a flat session cuts from ``data``."""
    sess = RefSession(table, max_chunks=max_chunks, chunk_len=chunk_len,
                      engine="bloom", bloom_table=sb)
    return stream_batches(sess, data)[:1]


# ------------------------------------------------------------------- cases
# Each returns (params, table, sharded filter or None, global batches).


def case_bloom_step(W, S):
    pats = rand_patterns(16, 21)
    table = compile_patterns(pats)
    rng = np.random.RandomState(4)
    lanes = 128 * (W // S)
    data = rng.randint(0, 256, size=(lanes, 256)).astype(np.uint8)
    for ln in (0, 100, lanes - 1):
        p = pats[ln % len(pats)]
        data[ln, 50 : 50 + len(p)] = np.frombuffer(p, np.uint8)
    return (dict(kind="grid_bloom_step"), table,
            RefSharded.from_table(table, S), lanes_batch(data))


def count_case(W, S, **kw):
    table = compile_patterns(WORD_PATS)
    sb = RefSharded.from_table(table, S)
    return (dict(kind="grid_count_step", **kw), table, sb,
            one_batch(table, sb, WORDS, 128 * (W // S), 64))


def case_count_step(W, S):
    return count_case(W, S, refine=False, k_cand=512, k_ev=512, k_walk=None)


def case_count_step_refined(W, S):
    return count_case(W, S, refine=True, k_cand=512, k_ev=512, k_walk=256)


def case_verify_planted(W, S):
    pats = rand_patterns(16, 41)
    data, _ = planted_binary(19, 1 << 13, pats, 40)
    table = compile_patterns(pats)
    sb = RefSharded.from_table(table, S)
    return (dict(kind="grid_verify"), table, sb,
            one_batch(table, sb, data, 128 * (W // S), 64))


def case_verify_dense(W, S):
    # every word a match: the event and refined capacities overflow
    table = compile_patterns(THE_PATS)
    sb = RefSharded.from_table(table, S)
    return (dict(kind="grid_verify"), table, sb,
            one_batch(table, sb, THE_WORDS, 128 * (W // S), 64))


def case_grid_spec(W, S):
    return (dict(kind="grid_spec"), compile_patterns([b"abcd", b"bcde"]),
            None, lanes_batch(np.zeros((W, 8), np.uint8)))


def session_case(W, S, table, data, max_chunks, chunk_len, bloom=None,
                 **kw):
    """A grid session case: the reference session on the first W virtual
    devices cuts the global batches; the port's ranks get its filter."""
    if bloom is None:
        kw["pat_shards"] = S
    ref = RefSession(table, max_chunks=max_chunks, chunk_len=chunk_len,
                     mesh=make_mesh(jax.devices()[:W]), bloom_table=bloom,
                     engine="bloom", **kw)
    params = dict(kind="session", max_chunks=max_chunks, chunk_len=chunk_len,
                  session=dict(kw, engine="bloom"))
    return params, table, ref.bloom_table, stream_batches(ref, data)


def planted_session(W, S, **kw):
    pats = rand_patterns(24, 7)
    data, _ = planted_binary(13, 1 << 14, pats, 40)
    return session_case(W, S, compile_patterns(pats), data, 128 * (W // S),
                        64, **kw)


def case_session_host(W, S):
    return planted_session(W, S)


def case_session_device(W, S):
    return planted_session(W, S, verify="device")


def case_session_device_passes(W, S):
    # past the device-verify cap (forced to 8 candidates in the ranks)
    # each rank verifies its lanes in passes, where the reference falls
    # back to host verify (ROADMAP queue 3); every output stays equal
    params, *rest = planted_session(W, S, verify="device")
    return (dict(params, max_device_cand=8), *rest)


def case_session_retry(W, S):
    return session_case(W, S, compile_patterns(THE_PATS), THE_WORDS,
                        128 * (W // S), 64, verify="device")


def case_session_coterm(W, S):
    table = compile_patterns(COTERM)
    return session_case(W, S, table, coterm_payload(), 128 * (W // S), 64,
                        bloom=RefSharded.from_table(table, S),
                        verify="device")


def case_ushort_host(W, S):
    table, text = ushort_problem()
    return session_case(W, S, table, text, 128 * (W // S), 64)


def case_ushort_device(W, S):
    table, text = ushort_problem()
    return session_case(W, S, table, text, 128 * (W // S), 64,
                        verify="device")


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}
SESSION_CASES = [n for n in CASES if n.startswith(("session", "ushort"))]


# --------------------------------------------------------------- reference


def ref_arrays(ctx2, b):
    return (jax.device_put(b["data"], ctx2.lane_sharded),
            jax.device_put(np.stack([b["start_t"], b["end_t"]]),
                           ctx2.lane_sharded2d))


def loop_merge(sh_a, ln_a, e_a, st_a, state_gid, groups_global):
    """The reference's ``_merge_pshard_events`` loop, to (lane, end,
    pids) tuples sorted by (lane, end)."""
    merged: dict = {}
    for s, ln, e, st in zip(sh_a.tolist(), ln_a.tolist(), e_a.tolist(),
                            st_a.tolist()):
        g = int(state_gid[s][st])
        merged.setdefault((ln, e), set()).update(groups_global[s][g])
    return sorted((ln, e, tuple(sorted(p))) for (ln, e), p in merged.items())


def reference(W, S, params, table, sb, batches):
    """The reference's outputs of one case on its (W, S) grid."""
    kind = params["kind"]
    ctx2 = RefGrid.build(jax.devices()[:W], S)
    b = batches[0]
    if kind == "grid_spec":
        try:
            RefGrid.build(jax.devices()[:W], W + 1)
        except ValueError as e:
            return dict(error=str(e))
        raise AssertionError("the reference built the grid")
    if kind == "grid_bloom_step":
        dev = sb.put(ctx2.pat_sharded)
        meta, bits = ref_bloom_step(ctx2, dev)(dev.words, *ref_arrays(ctx2, b))
        return dict(meta=np.asarray(meta), bits=np.asarray(bits))
    if kind == "grid_count_step":
        tabs = [compile_patterns([WORD_PATS[i] for i in part])
                for part in sb.parts]
        dev = sb.put(ctx2.pat_sharded)
        step = ref_count_step(
            ctx2, dev, tabs, halo=b["halo"], k_cand=params["k_cand"],
            k_ev=params["k_ev"], k_walk=params["k_walk"],
            shard_gram_keys=sb.shard_gram_keys if params["refine"] else None)
        flat, gids, _lmax, _gmax = ref_pad(tabs)
        gcounts, n_ev, flags = step(
            dev.words, jax.device_put(flat, ctx2.pat_sharded),
            jax.device_put(gids, ctx2.pat_sharded), *ref_arrays(ctx2, b))
        return dict(gcounts=np.asarray(gcounts), n_events=np.asarray(n_ev),
                    flags=np.asarray(flags),
                    pattern_counts=ref_global_counts(sb, tabs, gcounts))
    if kind == "grid_verify":
        dev = sb.put(ctx2.pat_sharded)
        data, bounds = ref_arrays(ctx2, b)
        meta, bits = ref_bloom_step(ctx2, dev)(dev.words, data, bounds)
        tabs = shard_tables_of(table, sb)
        dvf = RefVerifier(ctx2, sb, tabs, b["halo"])
        out = {}
        for i in range(2):
            sh, ln, e, st, gc = dvf.verify(data, bounds, bits,
                                           int(np.asarray(meta)[1]))
            out[f"events_{i}"] = loop_merge(sh, ln, e, st,
                                            dvf.shard_state_gid_host,
                                            dvf.shard_groups_global)
            out[f"gcounts_{i}"] = gc
        out["k_walk"] = dvf._k_walk
        return out
    sess = RefSession(table, max_chunks=params["max_chunks"],
                      chunk_len=params["chunk_len"],
                      mesh=make_mesh(jax.devices()[:W]), bloom_table=sb,
                      **params["session"])
    assert sess.pat_shards == S and sess._pshard_ctx is not None
    out = dict(max_chunks=sess.max_chunks, batches=[])
    for b in batches:
        batch = HostBatch(**b)
        bm = sess.decode(batch, sess.scan(batch))
        n, gc = sess.decode_counts(batch, sess.scan(batch))
        out["batches"].append(dict(
            events=sorted((e.lane, e.file_id, e.end_offset, e.gid,
                           e.rep_index, tuple(e.pattern_indices))
                          for e in bm.events),
            totals=(bm.total, bm.reported, bm.overflowed),
            event_groups=sess.event_group_counts(bm),
            counts=np.concatenate([[n], gc])))
    return out


@pytest.fixture(scope="module", params=GRIDS,
                ids=lambda g: f"W{g[0]}S{g[1]}")
def grid(request, tmp_path_factory):
    """(W, S, {case: (reference, [rank outputs], params)}) of one grid."""
    W, S = request.param
    if len(jax.devices()) < W:
        pytest.skip(f"needs {W} (virtual) devices for the reference grid")
    tmp = tmp_path_factory.mktemp(f"grid_w{W}s{S}")
    in_dir, out_dir = tmp / "in", tmp / "out"
    out_dir.mkdir()
    cases = {name: fn(W, S) for name, fn in CASES.items()}
    for name, case in cases.items():
        case[0]["n_shards"] = S
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
        refs = {name: reference(W, S, *case) for name, case in cases.items()}
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
    return W, S, {name: (refs[name], outs[name], cases[name])
                  for name in cases}


def column_lanes(arr, d, D, axis):
    c = arr.shape[axis] // D
    return np.take(arr, range(d * c, (d + 1) * c), axis=axis)


def rank_events(out, i):
    """A session rank's events of batch i as the reference's tuples."""
    ev, pids = out[f"events_{i}"], out[f"pids_{i}"]
    n = len(ev)
    lens, flat = pids[:n], pids[n:]
    offs = np.concatenate([[0], np.cumsum(lens)])
    return [(*(int(x) for x in e), tuple(int(p) for p in
                                         flat[offs[k]:offs[k + 1]]))
            for k, e in enumerate(ev)]


# ------------------------------------------------------------------- tests


def test_union_bitmap_and_meta_equal_reference(grid):
    W, S, res = grid
    ref, ranks, _ = res["bloom_step"]
    assert ref["meta"][0] > 0
    for r, out in enumerate(ranks):
        # [global union total, largest column's] on every rank; the
        # column's union bitmap
        np.testing.assert_array_equal(out["meta"], ref["meta"])
        np.testing.assert_array_equal(
            out["bits"], column_lanes(ref["bits"], r // S, W // S, axis=1))


@pytest.mark.parametrize("case", ["count_step", "count_step_refined"])
def test_count_step_equals_reference(grid, case):
    from tpu_pattern_matching_torch.core.dfa import (
        compile_patterns as port_compile,
    )
    from tpu_pattern_matching_torch.parallel.pshard import (
        ShardedBloom,
        global_pattern_counts,
    )

    W, S, res = grid
    ref, ranks, (_p, _t, sb, _b) = res[case]
    assert not ref["flags"].any() and ref["n_events"].sum() > 0
    want = np.zeros(len(WORD_PATS), np.int64)
    for _off, pid in match_python(WORD_PATS, WORDS):
        want[pid] += 1
    np.testing.assert_array_equal(ref["pattern_counts"], want)
    port_sb = ShardedBloom.from_reference(sb)
    tabs = [port_compile([WORD_PATS[i] for i in part])
            for part in port_sb.parts]
    for out in ranks:
        for key in ("gcounts", "n_events", "flags"):
            np.testing.assert_array_equal(out[key], ref[key])
        np.testing.assert_array_equal(
            global_pattern_counts(port_sb, tabs, out["gcounts"]), want)


@pytest.mark.parametrize("case", ["verify_planted", "verify_dense"])
def test_device_verify_rows_equal_reference(grid, case):
    W, S, res = grid
    ref, ranks, _ = res[case]
    for i in range(2):
        got = []
        for r, out in enumerate(ranks):
            lanes, ends = out[f"merged_{i}"]
            bnd, pids = out[f"bounds_{i}"], out[f"pids_{i}"]
            evs = [(int(lanes[k]), int(ends[k]),
                    tuple(int(p) for p in pids[bnd[k]:bnd[k + 1]]))
                   for k in range(len(lanes))]
            if r % S:  # a follower gets no rows
                assert not evs and out[f"rows_{i}"].shape == (4, 0)
            got += evs
            np.testing.assert_array_equal(out[f"gcounts_{i}"],
                                          ref[f"gcounts_{i}"])
        assert sorted(got) == ref[f"events_{i}"] and got, (i, len(got))
    for out in ranks:  # the same sticky capacity as the reference's
        assert int(out["k_walk"]) == ref["k_walk"]


def test_grid_the_world_cannot_hold_raises(grid):
    W, S, res = grid
    ref, ranks, _ = res["grid_spec"]
    assert ref["error"] == (f"{W} devices do not split into {W + 1} "
                            f"pattern shards")
    want = (f"{W} ranks do not split into {W + 1} pattern shards: each "
            f"rank holds one pattern shard of one lane column")
    for out in ranks:
        assert list(out["errors"]) == [want, want]


@pytest.mark.parametrize("case", SESSION_CASES)
def test_session_equals_reference(grid, case):
    W, S, res = grid
    ref, ranks, (params, *_rest) = res[case]
    device = params["session"].get("verify") == "device"
    for r, out in enumerate(ranks):
        assert int(out["max_chunks"]) == ref["max_chunks"]
        assert int(out["local_chunks"]) * (W // S) == ref["max_chunks"]
        assert bool(out["lane_passes"]) == ("max_device_cand" in params)
    n_ev = 0
    for i, want in enumerate(ref["batches"]):
        got = []
        for r, out in enumerate(ranks):
            evs = rank_events(out, i)
            if r % S:  # followers return no events
                assert not evs and int(out[f"totals_{i}"][1]) == 0
            got += evs
        assert sorted(got) == want["events"], (i, len(got),
                                               len(want["events"]))
        n_ev += len(got)
        totals = [out[f"totals_{i}"] for out in ranks]
        counts = [out[f"counts_{i}"] for out in ranks]
        np.testing.assert_array_equal(
            sum(out[f"event_groups_{i}"] for out in ranks),
            want["event_groups"])
        r_total, r_reported, r_over = want["totals"]
        assert sum(t[1] for t in totals) == r_reported and not r_over
        if device:  # the reference's global totals, on every rank
            assert all(t[0] == r_total and not t[2] for t in totals)
            for c in counts:
                np.testing.assert_array_equal(c, want["counts"])
        else:  # a leader's own column; followers none
            assert sum(t[0] for t in totals) == r_total
            np.testing.assert_array_equal(sum(counts), want["counts"])
            for r in range(W):
                if r % S:
                    assert totals[r][0] == 0 and not counts[r].any()
    assert n_ev > 0


def test_cross_shard_coterminators_merge(grid):
    # patterns co-terminating at one end but in different shards merge
    # into ONE event whose set is the global co-terminating group
    W, S, res = grid
    _ref, ranks, (_p, table, sb, _b) = res["session_coterm"]
    shard_of = {int(pid): s for s, part in enumerate(sb.parts)
                for pid in part}
    assert shard_of[0] != shard_of[3], shard_of
    events = [e for out in ranks[::S] for e in rank_events(out, 0)]
    oracle = {(off, pid) for off, pid in match_python(COTERM,
                                                      coterm_payload())}
    assert {(e[2], p) for e in events for p in e[5]} == oracle
    by_end = {e[2]: e for e in events}
    assert len(by_end) == len(events)
    gid_107 = table.groups_as_lists().index([0, 1, 3])
    assert by_end[107][5] == (0, 1, 3) and by_end[107][3] == gid_107


# ------------------------------------------------------ in-process checks


def test_world_of_one_cannot_hold_two_shards():
    # the reference raises on one device; the port on one rank
    from tpu_pattern_matching_torch.core.dfa import (
        compile_patterns as port_compile,
    )
    from tpu_pattern_matching_torch.parallel.mesh import owned_world
    from tpu_pattern_matching_torch.runtime.session import MatchSession

    with pytest.raises(ValueError, match="1 devices do not split into 2"):
        RefGrid.build(jax.devices()[:1], 2)
    with owned_world(), pytest.raises(
            ValueError, match="1 ranks do not split into 2 pattern shards"):
        MatchSession(port_compile([b"abcd", b"bcde"]), mesh="all",
                     pat_shards=2, device="cpu")


def test_merge_equals_loop_version():
    # the vectorised merge of shard rows against the reference's loop, on
    # seeded rows over seeded shard group tables
    from tpu_pattern_matching_torch.parallel.pshard import merge_shard_rows

    rng = np.random.RandomState(11)
    for trial in range(30):
        S = int(rng.randint(1, 5))
        groups, state_gid, n_pid = [], [], 0
        for _s in range(S):
            G = int(rng.randint(1, 6))
            gl = []
            for _g in range(G):
                k = int(rng.randint(1, 4))
                gl.append(list(range(n_pid, n_pid + k)))
                n_pid += k
            groups.append(gl)
            state_gid.append(rng.randint(0, G, size=20))
        n = int(rng.randint(0, 60))
        sh = rng.randint(0, S, size=n)
        ln = rng.randint(0, 5, size=n)
        e = rng.randint(0, 8, size=n)
        st = rng.randint(0, 20, size=n)
        # one row per (shard, lane, end), as a shard's walk emits
        _, keep = np.unique(np.stack([sh, ln, e]), axis=1, return_index=True)
        sh, ln, e, st = sh[keep], ln[keep], e[keep], st[keep]
        want = loop_merge(sh, ln, e, st, state_gid, groups)
        gid = np.array([state_gid[s][t] for s, t in zip(sh, st)], np.int64)
        csr = [(np.concatenate([[0], np.cumsum([len(g) for g in gl])]),
                np.array([p for g in gl for p in g], np.int64))
               for gl in groups]
        l_m, e_m, bnd, pids = merge_shard_rows(sh, ln, e, gid, csr)
        got = [(int(l_m[k]), int(e_m[k]),
                tuple(int(p) for p in pids[bnd[k]:bnd[k + 1]]))
               for k in range(len(l_m))]
        assert got == want, trial


def test_pad_shard_tables_and_counts_equal_reference():
    from tpu_pattern_matching_torch.core.dfa import (
        compile_patterns as port_compile,
    )
    from tpu_pattern_matching_torch.parallel.pshard import (
        ShardedBloom,
        global_pattern_counts,
        pad_shard_tables,
        shard_table,
    )

    pats = rand_patterns(20, 3)
    table = compile_patterns(pats)
    sb = RefSharded.from_table(table, 3)
    ref_tabs = shard_tables_of(table, sb)
    port_table = port_compile(pats)
    tabs = [shard_table(port_table, part) for part in sb.parts]
    for got, want in zip(pad_shard_tables(tabs), ref_pad(ref_tabs)):
        np.testing.assert_array_equal(got, want)
    gmax = max(t.num_groups for t in tabs)
    gc = np.random.RandomState(2).randint(0, 5, size=(3, gmax))
    np.testing.assert_array_equal(
        global_pattern_counts(ShardedBloom.from_reference(sb), tabs, gc),
        ref_global_counts(sb, ref_tabs, gc))
