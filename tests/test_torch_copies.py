"""The port's copies of the reference's host modules, held to the
reference on the same inputs.

The port imports nothing of the JAX package; what it needs of the
reference's jax-free modules it keeps as copies under the same names
(``core.dfa``, ``core.patterns``, ``core.oracle``, ``core.oracle_native``,
``runtime.buffers``, ``runtime.stager_native``, ``runtime.verify``,
``runtime.feeder``, ``runtime.files``, ``runtime.stats``,
``utils.common``, ``utils.debug``, the sentiment app's counters, the host half of ``ops.exact_gram``, the tool
``tools.length_trains``). Every output here is an integer, a string or
an exact count, so every comparison is exact."""

import os

import numpy as np
import pytest

from tpu_pattern_matching.core import dfa as ref_dfa
from tpu_pattern_matching.core import oracle as ref_oracle
from tpu_pattern_matching.core import oracle_native as ref_native
from tpu_pattern_matching.core import patterns as ref_patterns
from tpu_pattern_matching.ops import bloom as ref_bloom
from tpu_pattern_matching.ops import exact_gram as ref_exact
from tpu_pattern_matching.runtime import buffers as ref_buffers
from tpu_pattern_matching.runtime import files as ref_files
from tpu_pattern_matching.runtime import stats as ref_stats
from tpu_pattern_matching.runtime import verify as ref_verify
from tpu_pattern_matching.utils import common as ref_common
from tpu_pattern_matching_torch.apps import sentiment as port_app
from tpu_pattern_matching_torch.core import dfa as port_dfa
from tpu_pattern_matching_torch.core import oracle as port_oracle
from tpu_pattern_matching_torch.core import oracle_native as port_native
from tpu_pattern_matching_torch.core import patterns as port_patterns
from tpu_pattern_matching_torch.ops import bloom as port_bloom
from tpu_pattern_matching_torch.ops import exact_gram as port_exact
from tpu_pattern_matching_torch.runtime import buffers as port_buffers
from tpu_pattern_matching_torch.runtime import files as port_files
from tpu_pattern_matching_torch.runtime import stats as port_stats
from tpu_pattern_matching_torch.runtime import verify as port_verify
from tpu_pattern_matching_torch.runtime.tracing import Recorder
from tpu_pattern_matching_torch.utils import common as port_common

ARRAYS = ("goto_signed", "state_gid", "group_state", "group_offsets",
          "group_pids", "group_rep")


def rand_bytes(seed, n, hi=256):
    return bytes(np.random.RandomState(seed).randint(0, hi, size=n)
                 .astype(np.uint8))


def assert_tables_equal(a, b):
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    for name in ("alphabet_size", "max_pat_len", "nocase", "num_states",
                 "num_groups", "num_patterns"):
        assert getattr(a, name) == getattr(b, name), name
    assert [(p.symbols, p.iid, p.index, p.label) for p in a.patterns] == [
        (p.symbols, p.iid, p.index, p.label) for p in b.patterns]


def write_pattern_files(tmp_path):
    rng = np.random.RandomState(7)
    words = ["".join(chr(97 + c) for c in rng.randint(0, 26, size=n))
             for n in rng.randint(3, 9, size=40)]
    text = tmp_path / "text.pat"
    text.write_text("\n".join(words + ["", "MiXeD", '"quoted word"']) + "\n")
    categ = tmp_path / "categ.pat"
    categ.write_text("\n".join(f'{i - 20} " {w} "' for i, w in
                               enumerate(words)) + "\nnot-an-id x\n")
    hexp = tmp_path / "hex.pat"
    hexp.write_text("\n".join(rand_bytes(i, 6 + i % 5).hex()
                              for i in range(30)) + "\nabc\n")
    sigs = tmp_path / "sigs"
    sigs.write_text("40,32,287,32,106,196; 6; scanner\n"
                    "5,5,5; 3; triple five\n"
                    "1460[Reassembly, 7, 2047, 4000; 4;\n"
                    "x,y; 2; none\n"
                    + "".join(f"{','.join(map(str, rng.randint(0, 2048, 9)))};"
                              f" 9; sig {i}\n" for i in range(20)))
    return dict(text=str(text), categ=str(categ), hex=str(hexp),
                sigs=str(sigs))


@pytest.mark.parametrize("kind", ["text", "categ", "hex", "hex-limit",
                                  "text-limit", "sigs", "flow-line"])
def test_pattern_parsers_equal(tmp_path, kind):
    paths = write_pattern_files(tmp_path)
    if kind == "flow-line":
        for line in ("1, 2,3;4, x, 70000", "", "5;;6", " 7 "):
            assert port_patterns.parse_flow_line(line) == \
                ref_patterns.parse_flow_line(line)
        return
    if kind == "sigs":
        ref = ref_patterns.load_signature_file(paths["sigs"], max_tokens=8)
        port = port_patterns.load_signature_file(paths["sigs"], max_tokens=8)
    else:
        kw = dict(hex_pat=kind.startswith("hex"),
                  pat_size_limit=4 if kind.endswith("limit") else -1)
        path = paths[kind.split("-")[0]]
        ref = ref_patterns.load_pattern_file(path, **kw)
        port = port_patterns.load_pattern_file(path, **kw)
    assert [(p.data, p.iid, p.label) for p in port] == [
        (p.data, p.iid, p.label) for p in ref] and len(ref) > 3


@pytest.mark.parametrize("kind", ["byte", "hex", "nocase", "ushort"])
def test_compiled_tables_equal(tmp_path, kind):
    paths = write_pattern_files(tmp_path)
    if kind == "ushort":
        parsed = [ref_patterns.load_signature_file(paths["sigs"]),
                  port_patterns.load_signature_file(paths["sigs"])]
        acs = [ref_dfa.AhoCorasick(ref_dfa.ALPHABET_USHORT),
               port_dfa.AhoCorasick(port_dfa.ALPHABET_USHORT)]
    else:
        loaders = [ref_patterns.load_pattern_file,
                   port_patterns.load_pattern_file]
        path = paths["hex" if kind == "hex" else "categ"]
        parsed = [ld(path, hex_pat=kind == "hex") for ld in loaders]
        acs = [ref_dfa.AhoCorasick(nocase=kind == "nocase"),
               port_dfa.AhoCorasick(nocase=kind == "nocase")]
    for ac, ps in zip(acs, parsed):
        for p in ps:  # tokens past the alphabet read as its last symbol
            data = (tuple(min(x, 2047) for x in p.data) if kind == "ushort"
                    else p.data)
            ac.add_pattern(data, iid=p.iid, label=p.label)
    ref, port = (ac.compile() for ac in acs)
    assert_tables_equal(ref, port)
    pats = [rand_bytes(s, 3 + s % 9) for s in range(60)] + [b"ab", b"ab"]
    assert_tables_equal(ref_dfa.compile_patterns(pats),
                        port_dfa.compile_patterns(pats))


def fill_batches(mod, kind, path, chunk_len=64, max_chunks=8, halo=7):
    """Every batch a buffer of ``mod`` makes from the file at ``path``, as
    (data, start_t, end_t, file_ids, base_off, chunks)."""
    cls = mod.UshortBuffer if kind == "ushort" else mod.DataBuffer
    buf = cls(max_chunks, chunk_len, halo)
    stream = mod.StreamState(file_id=3)
    out = []
    with open(path, "rb") as f:
        while True:
            if kind == "text":
                code, rd, _ = buf.add_lines(f, stream)
            else:
                code, rd = buf.add_stream(f, stream)
            if rd == 0:
                buf.finalize_stream(stream)
            if buf.chunks and (code == -1 or rd == 0):
                b = buf.to_batch()
                live = [np.where(np.arange(b.data.shape[1]) < e, row, 0)
                        for row, e in zip(b.data[: b.chunks],
                                          b.end_t[: b.chunks])]
                out.append((np.asarray(live), b.start_t.copy(),
                            b.end_t.copy(), b.file_ids.copy(),
                            b.base_off.copy(), b.chunks, b.payload_bytes))
                buf.reset()
            if rd == 0:
                return out


@pytest.mark.parametrize("kind,native", [
    ("binary", True), ("text", True), ("ushort", True), ("ushort", False),
    ("ushort-long", True), ("ushort-long", False)],
    ids=["binary", "text", "ushort", "ushort-numpy", "ushort-long",
         "ushort-long-numpy"])
def test_buffer_batches_equal(tmp_path, monkeypatch, kind, native):
    """``ushort`` runs the port's native token parse, ``-numpy`` its NumPy
    parse (``TPM_NO_NATIVE_STAGER=1``); ``-long`` is a flow text of
    over 64 KiB in 16 KiB reads, so numbers straddle the reads."""
    if not native:
        monkeypatch.setenv("TPM_NO_NATIVE_STAGER", "1")
    rng = np.random.RandomState(9)
    path = tmp_path / "input"
    kw = {}
    if kind == "ushort":
        path.write_text(",".join(map(str, rng.randint(0, 3000, size=1500))))
    elif kind == "ushort-long":
        toks = rng.choice([0, 1460, 2047, 2048, 65535, 65536, 99999],
                          size=40_000)
        path.write_text(", ".join(map(str, toks)))
        assert path.stat().st_size > 64 * 1024
        kind, kw = "ushort", dict(chunk_len=2048)  # reads of 8 * 2048
    elif kind == "text":
        lines = [rand_bytes(i, int(n), hi=120).replace(b"\n", b"")
                 for i, n in enumerate(rng.randint(0, 150, size=40))]
        path.write_bytes(b"\n".join(lines) + b"\nno newline at the end")
    else:
        path.write_bytes(rand_bytes(10, 3000))
    ref = fill_batches(ref_buffers, kind, str(path), **kw)
    port = fill_batches(port_buffers, kind, str(path), **kw)
    assert len(ref) == len(port) > 1
    for r, p in zip(ref, port):
        for x, y in zip(r, p):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    # the native stager's path (the byte reads, the token parse), or the
    # numpy one
    assert port_buffers._native_stager_ok() == \
        ref_buffers._native_stager_ok()


def test_oracles_and_verifier_events_equal():
    rng = np.random.RandomState(12)
    pats = [rand_bytes(s, 3 + s % 3, hi=4) for s in range(30)]
    data = rand_bytes(99, 4800, hi=4)
    want = ref_native.NativeOracle(pats).match_events(data)
    assert port_native.NativeOracle(pats).match_events(data) == want
    assert port_oracle.match_python(pats, data) == \
        ref_oracle.match_python(pats, data) == want and len(want) > 100
    toks = rng.randint(0, 2048, size=3000).astype(np.int32)
    sigs = [tuple(int(x) for x in toks[i : i + 4]) for i in range(0, 600, 40)]
    assert (port_native.NativeOracle(sigs, alphabet=2048).match_events(toks)
            == ref_native.NativeOracle(sigs, alphabet=2048).match_events(toks))
    bits = rng.randint(-(2**31), 2**31, size=(6, 40)).astype(np.int32)
    bits[rng.rand(6, 40) < 0.7] = 0
    for a, b in zip(port_native.unpack_bitmap(bits.view(np.uint32), 3),
                    ref_native.unpack_bitmap(bits.view(np.uint32), 3)):
        np.testing.assert_array_equal(a, b)
    # the window verifier over one lane-major batch, dense walker and not
    C, T, halo = 12, 400, 8
    batch = np.frombuffer(data[: C * T], np.uint8).reshape(C, T).copy()
    start = np.full(C, halo, np.int32)
    end = rng.randint(T - 50, T + 1, size=C).astype(np.int32)
    lanes = rng.randint(0, C, size=300)
    rows = rng.randint(halo, T - 4, size=300)
    ref_t = ref_dfa.compile_patterns(pats)
    port_t = port_dfa.compile_patterns(pats)
    for dense in (False, True):
        r = ref_verify.Verifier([list(p) for p in pats], q=3,
                                max_pat_len=ref_t.max_pat_len,
                                dense_table=ref_t if dense else None)
        p = port_verify.Verifier([list(p) for p in pats], q=3,
                                 max_pat_len=port_t.max_pat_len,
                                 dense_table=port_t if dense else None)
        got = p.verify_batch(batch, lanes, rows, halo, start, end)
        assert got == r.verify_batch(batch, lanes, rows, halo, start, end)
        assert len(got) > 20


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_dumps_load_across_packages(tmp_path, writer):
    pats = [rand_bytes(s, 12) for s in range(200)]
    dfa_path = str(tmp_path / "t.dfa.npz")
    bloom_path = str(tmp_path / "t.bloom.npz")
    ref_t = ref_dfa.compile_patterns(pats)
    port_t = port_dfa.compile_patterns(pats)
    ref_f = ref_bloom.BloomFilterTable.from_table(ref_t)
    port_f = port_bloom.BloomFilterTable.from_table(port_t)
    np.testing.assert_array_equal(port_f.words, ref_f.words)
    if writer == "reference":
        ref_t.save(dfa_path)
        ref_f.save(bloom_path)
        table = port_dfa.DfaTable.load(dfa_path)
        filt = port_bloom.BloomFilterTable.load(bloom_path)
        want_t, want_f = port_t, port_f
    else:
        port_t.save(dfa_path)
        port_f.save(bloom_path)
        table = ref_dfa.DfaTable.load(dfa_path)
        filt = ref_bloom.BloomFilterTable.load(bloom_path)
        want_t, want_f = ref_t, ref_f
    assert_tables_equal(table, want_t)
    np.testing.assert_array_equal(filt.words, want_f.words)
    assert filt.cfg == want_f.cfg
    np.testing.assert_array_equal(filt.gram_keys, want_f.gram_keys)
    assert (filt.max_pat_len, filt.n_grams, filt.alphabet_size) == (
        want_f.max_pat_len, want_f.n_grams, want_f.alphabet_size)


def test_small_helpers_equal(tmp_path):
    for x, y in ((0, 8), (1, 8), (17, 8), (4096, 128)):
        assert port_common.cdiv(x, y) == ref_common.cdiv(x, y)
        assert port_common.roundup(x, y) == ref_common.roundup(x, y)
        assert port_common.pad_halo(x, 4096) == ref_common.pad_halo(x, 4096)
    for s in ("0a0b0c", "abc", " 00ff "):
        assert port_common.hex_to_bytes(s) == ref_common.hex_to_bytes(s)
    (tmp_path / "d" / "e").mkdir(parents=True)
    for name in ("d/a", "d/e/b", "c"):
        (tmp_path / name).write_bytes(b"x")
    for arg in (str(tmp_path / "d"), f"{tmp_path / 'c'},{tmp_path / 'zz'}"):
        assert port_files.expand_paths(arg) == ref_files.expand_paths(arg)
    kw = dict(matches_total=5, matches_reported=3, bytes=1 << 20, lines=4,
              files=2, rounds=1, automaton_states=9, automaton_bytes=99,
              wall_us=250_000)
    assert port_stats.RunStats(**kw).render() == \
        ref_stats.RunStats(**kw).render()
    rec = Recorder()  # the port's span recorder, which took the phase
    with rec.span("scan"):  # timer's place
        pass
    assert list(rec.totals()) == ["scan"] and rec.totals()["scan"][0] == 1


def test_sentiment_counters_equal(tmp_path):
    from tpu_pattern_matching.apps import sentiment as ref_app

    neg, pos = tmp_path / "neg", tmp_path / "pos"
    neg.write_text("bad\nawful\n\n")
    pos.write_text("good\nnice\n")
    scored = tmp_path / "scored"
    scored.write_text("good 2.5 0.1\nmeh -0.5 0.2\nbroken line\n")
    metas = [m.build_sentiment_patterns(str(neg), str(pos), str(scored),
                                        str(tmp_path / f"out.{i}"))
             for i, m in enumerate((ref_app, port_app))]
    assert metas[0] == metas[1]
    assert (tmp_path / "out.0").read_text() == (tmp_path / "out.1").read_text()
    anas = [m.SentimentAnalyzer(iids=[-1, -2, 1, 2], labels=list("abcd"),
                                metadata={2: 3.0})
            for m in (ref_app, port_app)]
    for ana in anas:
        for i, t in enumerate((10.0, 20.0, 20.0, 4000.0)):
            ana.add_match(i % 4, now=t, n=i + 1)
        ana.add_group_counts(np.array([0, 2, 1]), [[0], [3], [1, 2]],
                             now=5000.0)
    reps = [[(r.window, r.score_pct, r.top_words) for r in a.report(9000.0)]
            for a in anas]
    assert reps[0] == reps[1] and anas[0].matches == anas[1].matches


def random_grams(seed, n, q, alpha=256):
    rng = np.random.RandomState(seed)
    return {tuple(int(x) for x in rng.randint(0, alpha, q)) for _ in range(n)}


EXACT_CASES = {  # name: (grams, q, bits), the cases of tests/test_exact_gram.py
    **{f"random-q{q}": (random_grams(q, 500, q), q, 8)
       for q in (1, 2, 3, 4, 5, 6, 8)},
    "empty": (set(), 4, 8),
    "one-gram": ({(7, 8, 9, 10)}, 4, 8),
    "dense-load-q2": (random_grams(9, 5000, 2), 2, 8),
    **{f"bits11-q{q}": (random_grams(40 + q, 500, q, alpha=2048), q, 11)
       for q in (1, 3, 5)},
}


@pytest.mark.parametrize("name", list(EXACT_CASES))
def test_build_exact_table_equals_reference(name):
    grams, q, bits = EXACT_CASES[name]
    for seed in (0, 7):
        ref = ref_exact.build_exact_table(grams, q, seed=seed, bits=bits)
        port = port_exact.build_exact_table(grams, q, seed=seed, bits=bits)
        for field in ("lo", "hi"):
            a, b = getattr(port, field), getattr(ref, field)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=field)
        for field in ("q", "dmax", "m", "c1", "c2", "n", "bits"):
            assert getattr(port, field) == getattr(ref, field), field
    assert port.n == len(grams)


def load_reference_tool(name: str):
    """The reference's ``tools/<name>.py``, loaded by path (``tools/`` is
    not a package)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"ref_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TRACE_LINES = [
    "1 0.0 10.0.0.1 -> 10.0.0.2 TCP 74 4444->443 [SYN] Seq=0 Len=40",
    "2 0.1 10.0.0.2 -> 10.0.0.1 TCP 74 443->4444 [ACK] Seq=1 Len=32",
    "3 0.2 10.0.0.1 -> 10.0.0.2 TCP 66 4444->443 [ACK] Seq=41",  # no Len=
    "4 0.3 10.0.0.1",  # a short line: no destination, no length
    "5 0.4 10.0.0.1 -> 10.0.0.2 TCP 74 x [PSH] Len=287 Len=9",
    "6 0.5 10.0.0.2 -> 10.0.0.1 TCP 74 x [PSH] Len=abc",
    "",
]


def test_length_trains_equal_reference(tmp_path):
    from tpu_pattern_matching_torch.tools import length_trains as port_lt

    ref_lt = load_reference_tool("length_trains")
    for line in TRACE_LINES:
        assert port_lt.parse_trace_line(line) == ref_lt.parse_trace_line(
            line), line
    trace = tmp_path / "trace"
    trace.mkdir()
    flows = {  # three flows: a client's, a server-heavy one, one empty
        "10.0.0.1-10.0.0.2-4444-443": TRACE_LINES,
        "10.0.0.9-10.0.0.1-5000-80": [
            "1 0.0 10.0.0.9 -> 10.0.0.1 UDP 60 x Len=5",
            "2 0.1 10.0.0.1 -> 10.0.0.9 UDP 60 x Len=1500",
            "3 0.2 10.0.0.1 -> 10.0.0.9 UDP 60 x Len=0",
        ],
        "10.0.0.3-10.0.0.4-1-2": ["no packets here"],
        "nodash": ["1 0.0 10.0.0.1 -> 10.0.0.2 TCP 74 x Len=3"],
    }
    for name, lines in flows.items():
        (trace / name).write_text("\n".join(lines) + "\n")
    (trace / "10.0.0.5-10.0.0.6-7-8").mkdir()  # not a file: skipped
    outs = []
    for i, mod in enumerate((ref_lt, port_lt)):
        out = tmp_path / f"out{i}"
        out.mkdir()
        paths = mod.extract(str(trace), str(out))
        assert [os.path.basename(p) for p in paths] == [
            "tx.signatures", "rx.signatures", "txrx.signatures"]
        outs.append([open(p, "rb").read() for p in paths])
    assert outs[0] == outs[1]
    assert outs[1][2].decode().splitlines() == [
        "40, -32, 287", "", "5, -1500, -0"]


@pytest.mark.parametrize("kw", [dict(seed=31, n_lines=2000),
                                dict(seed=55, n_lines=500, n_patterns=64),
                                {}])
def test_words_corpus_copy_equals_the_fixture(kw):
    """The benchmarks' word corpus (``benchmarks.corpus``) is the
    reference repository's ``tests.fixtures.random_words_corpus``."""
    from tests.fixtures import random_words_corpus
    from tpu_pattern_matching_torch.benchmarks.corpus import (
        random_words_corpus as port_corpus,
    )

    assert port_corpus(**kw) == random_words_corpus(**kw)
