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
    (dict(engine="dense"), "item 6"),
    (dict(verify="device"), "item 7"),
    (dict(pat_shards=2), "item 10"),
    (dict(mesh=2), "item 11"),
])
def test_unported_options_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        MatchSession(compile_patterns([b"abcd"]), device="cpu", **kw)


def test_ushort_tables_raise():
    table = compile_patterns([[1, 2000, 3]], alphabet_size=2048)
    with pytest.raises(NotImplementedError, match="item 8"):
        MatchSession(table, device="cpu")


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


def test_port_imports_and_runs_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"  # any 'import jax' now raises
        "sys.modules['jaxlib'] = None\n"
        "from tpu_pattern_matching_torch.runtime.session import "
        "session_for_patterns\n"
        "s = session_for_patterns([b'abcd', b'cde'], max_chunks=4, "
        "chunk_len=64, device='cpu')\n"
        "got = s.find(b'xxabcdexx' * 20)\n"
        "assert len(got) == 40, got\n"
        "mods = [m for m in sys.modules if m.startswith('jax') and "
        "sys.modules[m] is not None]\n"
        "assert not mods, mods\n"
        "print('OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "OK"
