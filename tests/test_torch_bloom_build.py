"""Host half of the PyTorch port against the JAX reference: the bloom
filter build (chooser, words, exact gram keys), its npz dump format, the
exact gram table, the cost constants and the bitmap unpacking must be
identical — the port copies these modules because the reference's cannot
be imported without jax. Integer outputs: every comparison is exact."""

import dataclasses
import os

import numpy as np
import pytest

from tpu_pattern_matching.core.dfa import compile_patterns
from tpu_pattern_matching.ops import bloom as ref_bloom
from tpu_pattern_matching.ops import costmodel as ref_cost
from tpu_pattern_matching.ops import exact_gram as ref_exact
from tpu_pattern_matching_torch.ops import bloom as port_bloom
from tpu_pattern_matching_torch.ops import costmodel as port_cost
from tpu_pattern_matching_torch.ops import exact_gram as port_exact


def random_patterns(seed, n, lo=12, hi=12):
    rng = np.random.RandomState(seed)
    return [
        bytes(rng.randint(0, 256, size=rng.randint(lo, hi + 1))
              .astype(np.uint8))
        for _ in range(n)
    ]


def assert_same_table(r, p):
    assert dataclasses.asdict(r.cfg) == dataclasses.asdict(p.cfg)
    np.testing.assert_array_equal(r.words, p.words)
    assert r.words.dtype == p.words.dtype == np.int32
    assert (r.gram_keys is None) == (p.gram_keys is None)
    if r.gram_keys is not None:
        np.testing.assert_array_equal(r.gram_keys, p.gram_keys)
    assert r.n_grams == p.n_grams
    assert r.fp_est == p.fp_est
    assert r.max_pat_len == p.max_pat_len
    assert r.alphabet_size == p.alphabet_size
    assert r.expected_cand_rate() == p.expected_cand_rate()


BUILDS = {
    # auto on a small set: the chooser takes the strided kernel
    "auto-strided": (dict(), random_patterns(0, 200)),
    # auto with the strided search starved of filter (v <= 1, s <= 2):
    # the chooser takes the sampled (winnowing) kernel
    "auto-sampled": (dict(max_v=1, max_stride=2),
                     random_patterns(1, 1500)),
    "forced-sampled": (dict(force=("sampled", 4, 9, 6, 8)),
                       random_patterns(2, 300)),
    "forced-strided": (dict(force=("strided", 4, 4, 6, 16)),
                       random_patterns(3, 300)),
    "forced-k12": (dict(force=("sampled", 3, 5, 12, 2)),
                   random_patterns(4, 100, 8, 20)),
    "mixed-lengths": (dict(), random_patterns(5, 150, 4, 30)),
}


@pytest.mark.parametrize("name", list(BUILDS))
def test_build_equals_reference(name):
    opts, pats = BUILDS[name]
    r = ref_bloom.BloomFilterTable.build(pats, **opts)
    p = port_bloom.BloomFilterTable.build(pats, **opts)
    assert_same_table(r, p)
    if name == "auto-strided":
        assert not p.cfg.sampled
    if name == "auto-sampled":
        assert p.cfg.sampled


def test_from_table_nocase_equals_reference():
    pats = [b"Hello World", b"sIgNaTuRe", b"abcDEFghi"] + [
        p.upper() for p in random_patterns(6, 40, 9, 14)
    ]
    from tpu_pattern_matching.core.dfa import AhoCorasick

    ac = AhoCorasick(nocase=True)
    ac.add_patterns(pats)
    table = ac.compile()
    r = ref_bloom.BloomFilterTable.from_table(table)
    p = port_bloom.BloomFilterTable.from_table(table)
    assert p.cfg.fold_case
    assert_same_table(r, p)


def test_from_reference_and_npz_both_ways(tmp_path):
    pats = random_patterns(7, 120)
    r = ref_bloom.BloomFilterTable.build(pats)
    assert_same_table(r, port_bloom.BloomFilterTable.from_reference(r))
    ref_path = str(tmp_path / "ref.npz")
    r.save(ref_path)
    assert_same_table(r, port_bloom.BloomFilterTable.load(ref_path))
    port_path = str(tmp_path / "port.npz")
    port_bloom.BloomFilterTable.build(pats).save(port_path)
    assert_same_table(r, ref_bloom.BloomFilterTable.load(port_path))


def test_probe_cost_units_equal():
    for q in (1, 4, 6):
        for k in (2, 9, 16):
            for v in (1, 8, 256):
                for kw in (dict(s=1), dict(s=3), dict(s=8), dict(w=9)):
                    assert ref_bloom.probe_cost_units(q, k, v, **kw) == (
                        port_bloom.probe_cost_units(q, k, v, **kw)
                    )


def test_cost_constants_equal(tmp_path, monkeypatch):
    assert dataclasses.asdict(port_cost.get_cost_constants()) == (
        dataclasses.asdict(ref_cost.get_cost_constants())
    )
    path = str(tmp_path / "c.json")
    ref_cost.CostConstants(
        probe_ns_per_unit=0.5, verify_ns_per_cand=9.0,
        verify_ns_per_cand_u2048=3.0, source="test",
    ).save(path)
    monkeypatch.setenv(port_cost.ENV_VAR, path)
    for alphabet in (256, 2048):
        assert dataclasses.asdict(port_cost.get_cost_constants(alphabet)) == (
            dataclasses.asdict(ref_cost.get_cost_constants(alphabet))
        )


@pytest.mark.parametrize("q,bits", [(4, 8), (6, 8), (3, 11), (5, 11)])
def test_exact_gram_tables_equal(q, bits):
    rng = np.random.RandomState(q * 100 + bits)
    grams = {tuple(int(x) for x in rng.randint(0, 1 << bits, size=q))
             for _ in range(700)}
    rk = ref_exact.pack_grams(grams, q, bits)
    pk = port_exact.pack_grams(grams, q, bits)
    np.testing.assert_array_equal(rk, pk)
    rt = ref_exact.table_from_keys(rk, q, bits=bits)
    pt = port_exact.table_from_keys(pk, q, bits=bits)
    for f in ("q", "dmax", "m", "c1", "c2", "n", "bits", "use_hi"):
        assert getattr(rt, f) == getattr(pt, f), f
    np.testing.assert_array_equal(rt.lo, pt.lo)
    np.testing.assert_array_equal(rt.hi, pt.hi)
    probe = np.concatenate([
        rk[::3], rng.randint(0, 1 << min(63, q * bits), size=500,
                             dtype=np.uint64),
    ])
    want = ref_exact.member_mask_np(rt, probe)
    np.testing.assert_array_equal(port_exact.member_mask_np(pt, probe), want)
    assert want[: len(rk[::3])].all()


def test_shared_exact_constants_across_tables():
    keys = [port_exact.pack_grams({(1, 2, 3), (4, 5, 6)}, 3),
            port_exact.pack_grams({(7, 8, 9)}, 3), np.zeros(0, np.uint64)]
    r = ref_exact.tables_from_keys_common(keys, 3)
    p = port_exact.tables_from_keys_common(keys, 3)
    for a, b in zip(r, p):
        assert (a.m, a.c1, a.c2, a.n) == (b.m, b.c1, b.c2, b.n)
        np.testing.assert_array_equal(a.lo, b.lo)


@pytest.mark.parametrize("stride", [1, 4])
def test_unpack_hit_rows_equal(stride):
    rng = np.random.RandomState(stride)
    bits = rng.randint(-(2**31), 2**31, size=(6, 130)).astype(np.int32)
    bits[rng.rand(6, 130) < 0.7] = 0
    r_rows, r_lanes = ref_bloom.unpack_hit_rows(bits, stride)
    p_rows, p_lanes = port_bloom.unpack_hit_rows(bits, stride)
    np.testing.assert_array_equal(r_rows, p_rows)
    np.testing.assert_array_equal(r_lanes, p_lanes)


def test_session_filter_equals_reference_filter():
    # the filter a session builds from a DfaTable is the reference's
    pats = random_patterns(8, 60, 10, 14)
    table = compile_patterns(pats)
    assert_same_table(
        ref_bloom.BloomFilterTable.from_table(table),
        port_bloom.BloomFilterTable.from_table(table),
    )
    assert os.environ.get("TPM_COST_CONSTANTS")  # hermetic chooser
