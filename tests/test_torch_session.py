"""The PyTorch port's MatchSession on the CPU against the reference
MatchSession (Pallas interpret mode) and the oracle: the same events, the
same per-group counts, the same refinement-capacity growth. Also: the
port imports without jax, and never runs on the CPU when CUDA is asked
for. Events are integers: every comparison is exact."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.fixtures import random_words_corpus
from tpu_pattern_matching.core.dfa import AhoCorasick, compile_patterns
from tpu_pattern_matching.core.oracle import match_python
from tpu_pattern_matching.runtime.session import MatchSession as RefSession
from tpu_pattern_matching_torch.runtime.buffers import StreamState
from tpu_pattern_matching_torch.runtime.session import (
    MatchSession,
    session_for_patterns,
)
from tpu_pattern_matching_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def both(pats, table=None, **kw):
    table = table if table is not None else compile_patterns(pats)
    return (RefSession(table, engine="bloom", **kw),
            MatchSession(table, device="cpu", **kw))


def rand_bytes(seed, n):
    return np.random.RandomState(seed).randint(0, 256, size=n).astype(
        np.uint8).tobytes()


FIND_CASES = {
    # (patterns, data, session options)
    "words": ([b"he", b"she", b"his", b"hers"],
              b"ushers and his, she sells hershey",
              dict(max_chunks=4, chunk_len=64)),
    "chunk-and-batch-boundaries": ([b"good", b"xgoo"],
                                   (b"x" * 63 + b"good") * 5,
                                   dict(max_chunks=2, chunk_len=64)),
    "nul-near-padded-tails": ([b"\x00\x00\x00", b"a\x00", b"\x00z"],
                              b"a\x00b" * 30 + b"\x00\x00",
                              dict(max_chunks=4, chunk_len=32)),
    "pattern-longer-than-chunk": (
        [rand_bytes(1, 300), b"zz"],
        b"a" * 100 + rand_bytes(1, 300) + b"zz" + b"b" * 50,
        dict(max_chunks=4, chunk_len=128)),
    "empty-input": ([b"abc"], b"", dict(max_chunks=4, chunk_len=64)),
    "planted-random": (
        [rand_bytes(s, 12) for s in range(10, 40)],
        rand_bytes(2, 3000)[:500] + rand_bytes(13, 12)
        + rand_bytes(3, 3000)[:700] + rand_bytes(20, 12),
        dict(max_chunks=8, chunk_len=256)),
}


@pytest.mark.parametrize("name", list(FIND_CASES))
def test_find_equals_reference_and_oracle(name):
    pats, data, kw = FIND_CASES[name]
    ref, port = both(pats, **kw)
    want = sorted(match_python(pats, data))
    got = port.find(data)
    assert got == want
    assert got == ref.find(data)
    if name == "planted-random":
        assert len(want) == 2


def test_text_mode_equals_reference_and_oracle():
    pats, corpus = random_words_corpus(seed=5, n_lines=60)
    corpus += b"x" * 150 + pats[0] + b"\n"  # a long line split in pieces
    ref, port = both(pats, max_chunks=8, chunk_len=128)
    got = port.find(corpus, text_mode=True)
    assert got == ref.find(corpus, text_mode=True)
    # text mode drops matches across newlines only; the corpus has none
    assert got == sorted(match_python(pats, corpus))
    assert got


def test_nocase_find_equals_reference():
    pats = [b"Hello", b"WORLD", b"mixed Case"]
    ac = AhoCorasick(nocase=True)
    ac.add_patterns(pats)
    table = ac.compile()
    data = b"hello HELLO hElLo world Mixed CASE" * 3
    ref, port = both(pats, table=table, max_chunks=4, chunk_len=32)
    got = port.find(data)
    assert got == ref.find(data)
    assert len(got) == 15  # 3 x (3 hello + world + mixed case)


def test_stream_events_and_sorted_order_equal_reference():
    pats = [rand_bytes(s, 10) for s in range(50, 60)]
    rng = np.random.RandomState(9)
    data = bytearray(rand_bytes(4, 4000))
    for i, pos in enumerate(rng.randint(0, 3990, size=12)):
        data[pos : pos + 10] = pats[i % 10]
    data = bytes(data)
    ref, port = both(pats, max_chunks=4, chunk_len=256, sort=True)

    def events(sess):
        return [
            [(e.file_id, e.end_offset, e.pattern_indices, e.rep_index,
              e.lane, e.gid) for e in bm.events]
            for bm in sess.scan_stream(io.BytesIO(data), file_id=3)
        ]

    got = events(port)
    assert got == events(ref)
    assert sum(map(len, got)) >= 10


def test_decode_counts_equal_reference():
    pats = [b"abc", b"bc", b"zzzz"]
    data = (b"xxabcx" * 40 + b"zzzzz") * 3
    ref, port = both(pats, max_chunks=4, chunk_len=64)

    def counts(sess):
        buf = sess.new_buffer()
        from tpu_pattern_matching.runtime.buffers import StreamState

        buf.add_stream(io.BytesIO(data), StreamState(file_id=0))
        batch = buf.to_batch()
        total, gc = sess.decode_counts(batch, sess.scan(batch))
        return total, gc.tolist()

    got = counts(port)
    assert got == counts(ref)
    assert got[0] > 0
    buf = port.new_buffer()
    assert port.decode_counts(buf.to_batch(), port.scan(buf.to_batch()))[0] == 0


def batch_events(bm):
    return ([(e.file_id, e.end_offset, list(e.pattern_indices), e.rep_index,
              e.lane, e.gid) for e in bm.events],
            bm.total, bm.reported, bm.overflowed)


@pytest.mark.parametrize("engine", ["bloom", "dense"])
def test_scan_and_decode_equals_reference(engine):
    from tpu_pattern_matching.runtime.buffers import StreamState

    pats = [b"abc", b"bc", b"zzzz"]
    data = (b"xxabcx" * 40 + b"zzzzz") * 3
    table = compile_patterns(pats)
    kw = dict(max_chunks=4, chunk_len=64, engine=engine)
    ref = RefSession(table, **kw)
    port = MatchSession(table, device="cpu", **kw)
    buf = port.new_buffer()
    buf.add_stream(io.BytesIO(data), StreamState(file_id=2))
    batch = buf.to_batch()
    got = batch_events(port.scan_and_decode(batch))
    assert got == batch_events(ref.scan_and_decode(batch))
    assert got == batch_events(port.decode(batch, port.scan(batch)))
    assert got[1] > 40


def test_positional_arguments_take_the_reference_order():
    # MatchSession(table, max_chunks, chunk_len, max_results, halo,
    # sharding, sort, engine, ...) in both packages: the same positional
    # call gives the same session and the same events
    pats = [rand_bytes(s, 12) for s in range(50, 58)] + [b"abc", b"bcd"]
    data = bytearray(rand_bytes(4, 6000))
    for i, p in enumerate(pats):
        data[400 * i + 7 : 400 * i + 7 + len(p)] = p
    data = bytes(data)
    table = compile_patterns(pats)
    args = (table, 128, 64, 16, None, None, True, "dense")
    ref = RefSession(*args)
    port = MatchSession(*args, device="cpu")
    assert (ref.sort, ref.engine) == (port.sort, port.engine) == (
        True, "dense")
    assert (ref.max_chunks, ref.chunk_len, ref.max_results, ref.halo) == (
        port.max_chunks, port.chunk_len, port.max_results, port.halo)
    buf = port.new_buffer()
    buf.add_stream(io.BytesIO(data), StreamState(file_id=1))
    batch = buf.to_batch()
    got = batch_events(port.scan_and_decode(batch))
    assert got == batch_events(ref.scan_and_decode(batch))
    assert got[1] >= len(pats)
    assert port.find(data) == ref.find(data) == sorted(
        match_python(pats, data))


def test_sharding_names_the_placement_device():
    table = compile_patterns([b"abcd"])
    cpu = torch.device("cpu")
    # a torch.device in the reference's sharding place places the session
    # when device is left at its default, and must agree with it otherwise
    assert MatchSession(table, sharding=cpu).device == cpu
    assert MatchSession(table, sharding=cpu, device="cpu").device == cpu
    assert MatchSession(table, 4, 64, 16, None, cpu).find(b"xabcd") == [
        (4, 0)]
    with pytest.raises(ValueError, match="contradicts"):
        MatchSession(table, sharding=torch.device("cuda"), device="cpu")
    with pytest.raises(TypeError, match="sharding"):
        MatchSession(table, sharding="cpu", device="cpu")


def test_refine_overflow_grows_k_ref_like_reference():
    # match-dense input past the refinement capacity: the unrefined bitmap
    # passes through, events stay exact, and k_ref grows as in the
    # reference (the model: tests/test_engine_bloom.py)
    pats = [b"abcd"]
    data = b"abcd" * 64
    ref, port = both(pats, max_chunks=4, chunk_len=64)
    assert port._bloom.exact is not None
    assert port._bloom.k_ref == ref._bloom.k_ref
    ref._bloom.k_ref = port._bloom.k_ref = 8
    assert port.find(data) == ref.find(data) == sorted(
        match_python(pats, data))
    assert port._bloom.k_ref == ref._bloom.k_ref >= 64
    assert port.refine_overflows >= 1


def test_refine_overflow_of_single_bit_words_loses_nothing():
    # one candidate per bitmap word, more words than k_ref: the port flags
    # the word overflow and verifies the unrefined bitmap (the reference
    # flags only multi-bit overflows and returns 8 of these 16 events)
    rng = np.random.RandomState(3)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(4)]
    data = bytearray(rng.randint(0, 256, size=16 * 256).astype(np.uint8))
    for i in range(16):
        data[i * 256 + 100 : i * 256 + 112] = pats[i % 4]
    data = bytes(data)
    port = MatchSession(compile_patterns(pats), max_chunks=16, chunk_len=256,
                        device="cpu",
                        bloom_opts={"force": ("sampled", 4, 9, 6, 8)})
    port._bloom.k_ref = 8
    got = port.find(data)
    assert got == sorted(match_python(pats, data))
    assert len(got) == 16 and port.refine_overflows == 1


def test_precompiled_reference_filter_gives_same_events():
    from tpu_pattern_matching.ops.bloom import BloomFilterTable as RefTable
    from tpu_pattern_matching_torch.ops.bloom import BloomFilterTable

    pats = [rand_bytes(s, 9) for s in range(70, 90)]
    data = rand_bytes(5, 2000) + pats[3] + rand_bytes(6, 900) + pats[11]
    table = compile_patterns(pats)
    bft = BloomFilterTable.from_reference(RefTable.from_table(table))
    port = MatchSession(table, max_chunks=4, chunk_len=512, device="cpu",
                        bloom_table=bft)
    assert port.find(data) == sorted(match_python(pats, data))
    assert session_for_patterns(pats, max_chunks=4, chunk_len=512,
                                device="cpu").find(data) == port.find(data)


@pytest.mark.parametrize("kw,item", [
    # pattern shards (item 10) are ported: the session runs them
    pytest.param(dict(pat_shards=2), None, id="kw0-item 10"),
    # the 1-D mesh (item 11a) and, with pattern shards, the ("pat",
    # "data") grid (item 11b) are ported; the grid needs a world size that
    # is a multiple of the shards, which a world of 1 is not (the
    # reference raises alike on one device)
    pytest.param(dict(mesh="all", pat_shards=2),
                 "1 ranks do not split into 2 pattern shards",
                 id="kw1-item 11"),
])
def test_unported_options_raise(kw, item):
    table = compile_patterns([b"abcd", b"bcde"])
    if item is None:
        sess = MatchSession(table, device="cpu", **kw)
        assert sess.pat_shards == 2
        assert sess.find(b"xabcdex") == [(4, 0), (5, 1)]
        return
    from tpu_pattern_matching_torch.parallel.mesh import owned_world

    with owned_world(), pytest.raises(ValueError, match=item):
        MatchSession(table, device="cpu", **kw)


def test_ushort_tables_raise():
    # ushort tables run every single-device path now
    # (tests/test_torch_ushort.py), the mesh (tests/test_torch_mesh.py) and
    # the grid (tests/test_torch_grid.py); like byte tables, they raise
    # only for layouts that cannot hold them. Pattern shards need the
    # bloom engine: a ushort table's "auto" is dense, which raises as in
    # the reference
    from tpu_pattern_matching_torch.parallel.mesh import owned_world

    table = compile_patterns([[1, 2000, 3], [5, 6]], alphabet_size=2048)
    # the grid of one rank cannot hold 2 shards
    with owned_world(), pytest.raises(ValueError, match="1 ranks do not "
                                      "split into 2 pattern shards"):
        MatchSession(table, device="cpu", engine="bloom", mesh="all",
                     pat_shards=2)
    with pytest.raises(ValueError, match="mesh size 2 is not the world "
                       "size 1"):
        MatchSession(table, device="cpu", mesh=2)
    with pytest.raises(ValueError, match="bloom engine"):
        MatchSession(table, device="cpu", pat_shards=2)
    assert MatchSession(table, device="cpu", engine="bloom",
                        pat_shards=2).find(b"7, 1, 2000, 3, 5, 6") == [
        (3, 0), (5, 1)]
    assert MatchSession(table, device="cpu").find(b"7, 1, 2000, 3") == [
        (3, 0)]


@pytest.fixture
def world1():
    """A 1-rank gloo world for this test (``mesh="all"`` makes it), gone
    after it."""
    from tpu_pattern_matching_torch.parallel.mesh import owned_world

    with owned_world():
        yield


@pytest.mark.parametrize("kw", [
    dict(engine="bloom"), dict(engine="bloom", verify="device"),
    dict(engine="dense", max_results=64),
], ids=["bloom-host", "bloom-device", "dense"])
@pytest.mark.parametrize("alphabet", [256, 2048])
def test_mesh_at_world_1_equals_flat_session(world1, kw, alphabet):
    # mesh="all" with no process group: a 1-rank group, every collective a
    # real call; events, totals and counts equal the flat session's
    rng = np.random.RandomState(alphabet)
    if alphabet == 256:
        pats = [rand_bytes(s, 7) for s in range(5)] + [b"abab"]
        data = bytearray(rand_bytes(4, 20000))
        for pos in range(30, 19900, 211):
            data[pos : pos + 7] = pats[pos % 5]
        data = bytes(data) + b"ab" * 300
        table = compile_patterns(pats)
    else:
        pats = [[int(x) for x in rng.randint(0, 2048, size=4)]
                for _ in range(5)]
        seq = rng.randint(0, 2048, size=6000)
        for pos in range(30, 5900, 97):
            seq[pos : pos + 4] = pats[pos % 5]
        data = ",".join(map(str, seq)).encode()
        table = compile_patterns(pats, alphabet_size=2048)
    mesh = MatchSession(table, max_chunks=16, chunk_len=64, device="cpu",
                        mesh="all", **kw)
    flat = MatchSession(table, max_chunks=mesh.max_chunks, chunk_len=64,
                        device="cpu", **kw)
    assert mesh._mesh_ctx.world_size == 1
    assert mesh.local_chunks == mesh.max_chunks == (
        128 if kw["engine"] == "bloom" else 16)
    got = mesh.find(data)
    assert got == flat.find(data) == sorted(match_python(pats, (
        data if alphabet == 256 else seq.tolist())))
    for a, b in zip(mesh.scan_stream(io.BytesIO(data)),
                    flat.scan_stream(io.BytesIO(data))):
        assert [vars(e) for e in a.events] == [vars(e) for e in b.events]
        assert (a.total, a.reported, a.overflowed) == (
            b.total, b.reported, b.overflowed)
    buf = mesh.new_buffer()
    buf.add_stream(io.BytesIO(data), StreamState(file_id=0))
    batch = buf.to_batch()
    n_m, gc_m = mesh.decode_counts(batch, mesh.scan(batch))
    n_f, gc_f = flat.decode_counts(batch, flat.scan(batch))
    assert n_m == n_f > 0
    np.testing.assert_array_equal(gc_m, gc_f)


def test_dense_keeps_every_slot_past_8192_tuples(world1):
    # 512 lanes of 32 matches each: 16384 tuples in one batch. The
    # reference keeps 8192 of them and flags the rest, so its find raises;
    # the port's dense session keeps every result slot, flat and on a
    # mesh at world 1 alike (ROADMAP queue 3)
    table = compile_patterns([b"ab"])
    data = b"ab" * (512 * 32)
    kw = dict(max_chunks=512, chunk_len=64, engine="dense", max_results=64)
    (ref,) = RefSession(table, **kw).scan_stream(io.BytesIO(data))
    assert ref.overflowed and ref.reported == 8192 < ref.total == 16384
    flat = MatchSession(table, device="cpu", **kw)
    mesh = MatchSession(table, device="cpu", mesh="all", **kw)
    (a,), (b,) = (s.scan_stream(io.BytesIO(data)) for s in (flat, mesh))
    assert (a.total, a.reported, a.overflowed) == (16384, 16384, False)
    assert (b.total, b.reported, b.overflowed) == (16384, 16384, False)
    assert [vars(e) for e in a.events] == [vars(e) for e in b.events]
    assert flat.find(data) == mesh.find(data) == sorted(
        match_python([b"ab"], data))
    with pytest.raises(RuntimeError, match="overflowed"):
        RefSession(table, **kw).find(data)


def test_cuda_request_never_runs_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request is honoured")
    with pytest.raises(RuntimeError, match="cuda"):
        MatchSession(compile_patterns([b"abcd"]))  # default device: cuda
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(0)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_port_imports_and_runs_without_jax(tmp_path):
    # the port imports nothing of the JAX package either: both are blocked
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"  # any 'import jax' now raises
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['tpu_pattern_matching'] = None\n"
        "from tpu_pattern_matching_torch.runtime.session import "
        "session_for_patterns\n"
        "from tpu_pattern_matching_torch.core.oracle import match_python\n"
        "from tpu_pattern_matching_torch.core.oracle_native import "
        "NativeOracle\n"
        "pats = [b'abcd', b'cde']\n"
        "data = b'xxabcdexx' * 20\n"
        "want = NativeOracle(pats).match_events(data)\n"
        "assert want == sorted(match_python(pats, data)), want\n"
        "s = session_for_patterns(pats, max_chunks=4, "
        "chunk_len=64, device='cpu')\n"
        "got = s.find(data)\n"
        "assert got == want and len(got) == 40, got\n"
        "for kw in (dict(verify='device'), dict(engine='dense')):\n"
        "    s = session_for_patterns(pats, max_chunks=4, "
        "chunk_len=64, device='cpu', **kw)\n"
        "    assert s.find(data) == got, kw\n"
        "import tpu_pattern_matching_torch\n"
        "import tpu_pattern_matching_torch.cli\n"
        "import tpu_pattern_matching_torch.engine\n"
        "import tpu_pattern_matching_torch.apps.sentiment\n"
        "import tpu_pattern_matching_torch.runtime.feeder\n"
        "import tpu_pattern_matching_torch.runtime.tracing\n"
        "from tpu_pattern_matching_torch.parallel.pshard import "
        "ShardedBloom\n"
        "s = session_for_patterns(pats, max_chunks=4, chunk_len=64, "
        "device='cpu', pat_shards=2)\n"
        "assert isinstance(s.bloom_table, ShardedBloom)\n"
        "assert s.find(data) == got\n"
        "from tpu_pattern_matching_torch.entry import entry\n"
        "fn, args = entry('cpu')\n"
        "assert fn(*args)[0].shape == (1,)\n"
        "from tpu_pattern_matching_torch.parallel import mesh\n"
        "s = session_for_patterns(pats, max_chunks=4, chunk_len=64, "
        "device='cpu', mesh='all', verify='device')\n"
        "assert s._mesh_ctx.world_size == 1 and s.find(data) == got\n"
        "import torch.distributed as dist\n"
        "dist.destroy_process_group()\n"
        "from tpu_pattern_matching_torch.entry import _dryrun_rank\n"
        "_dryrun_rank(0, 1, 'unused', 'cpu')\n"
        "assert not dist.is_initialized()\n"
        "import numpy as np\n"
        "from tpu_pattern_matching_torch.parallel.pshard import (\n"
        "    Mesh2DContext, PshardDeviceVerifier, global_pattern_counts,\n"
        "    make_pattern_sharded_bloom_step,\n"
        "    make_pattern_sharded_count_step, merge_shard_rows)\n"
        "ln, e, b, p = merge_shard_rows(\n"
        "    np.array([0]), np.array([2]), np.array([5]), np.array([1]),\n"
        "    [(np.array([0, 1, 3]), np.array([0, 1, 2]))])\n"
        "assert (ln.tolist(), p.tolist()) == ([2], [1, 2])\n"
        "from tpu_pattern_matching_torch.tools import fuzz_campaign\n"
        "assert fuzz_campaign.run_trial(1, 0, 'cpu')['arms']\n"
        "from tpu_pattern_matching_torch.ushort import compile_signatures\n"
        "from tpu_pattern_matching_torch.runtime.session import "
        "MatchSession\n"
        "open('sigs', 'w').write('5,500,1999; 3; x\\n')\n"
        "u = MatchSession(compile_signatures('sigs'), max_chunks=4, "
        "chunk_len=16, device='cpu', engine='bloom')\n"
        "assert u.find(b'1, 5, 500, 1999, 5') == [(3, 0)]\n"
        "import torch\n"
        "from tpu_pattern_matching_torch.benchmarks import exp_bloom\n"
        "b, m1, m2, rng = exp_bloom.make_tables(0)\n"
        "d = rng.randint(0, 256, size=(286, 512)).astype('uint8')\n"
        "hit = exp_bloom.run_probe(torch.from_numpy(d), "
        "torch.from_numpy(b), m1, m2)\n"
        "want = exp_bloom.np_probe(exp_bloom.np_windows(d), b, m1, m2)\n"
        "assert (hit.numpy() == want).all() and want.sum() == 264\n"
        "from tpu_pattern_matching_torch.ops.costmodel import calibrate\n"
        "cc = calibrate(path=None, n_patterns=50, verbose=False, "
        "device='cpu', lanes=128, chunk=128, u_signatures=40, "
        "u_lanes=128, u_chunk=128, calls=1)\n"
        "assert cc.source.startswith('calibrated:cpu'), cc\n"
        "import os\n"
        "from tpu_pattern_matching_torch.tools import length_trains\n"
        "os.mkdir('trace')\n"
        "open('trace/10.0.0.1-10.0.0.2-1-2', 'w').write(\n"
        "    '1 0 10.0.0.1 -> 10.0.0.2 TCP 74 x Len=40\\n'\n"
        "    '2 0 10.0.0.2 -> 10.0.0.1 TCP 74 x Len=32\\n')\n"
        "paths = length_trains.extract('trace', '.')\n"
        "assert [open(p).read() for p in paths] == "
        "['40\\n', '32\\n', '40, -32\\n']\n"
        "mods = [m for m in sys.modules if (m.startswith('jax') or "
        "m.split('.')[0] == 'tpu_pattern_matching') and "
        "sys.modules[m] is not None]\n"
        "assert not mods, mods\n"
        "print('OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "OK"
