"""The input generators: the same seed gives the same inputs, another
seed the same flows in another order with other packets; the files hold
what the reference reads."""

from __future__ import annotations

import os

import numpy as np

from perfbench import spec
from perfbench.generators.flow_trains import flow_lengths
from perfbench.harness import rng
from perfbench.tests.conftest import HARNESS, TINY_CONFIGS, TINY_TRAFFIC

SEED = 2**31 + 987654321  # larger than 32 signed bits


def make(seed, out, traffic="fl"):
    sg = TINY_CONFIGS["tinyu"]["signatures"]
    gen = spec.generator(HARNESS, sg["generator"])
    sigs = gen.make(sg, rng(seed, 1))
    os.makedirs(os.path.join(out, "c"))
    gen.write(os.path.join(out, "sigs.txt"), sigs)
    t = TINY_TRAFFIC[traffic]
    corpus = spec.generator(HARNESS, t["generator"]).make(
        t, sigs, rng(seed, 2), os.path.join(out, "c"))
    with open(os.path.join(out, "sigs.txt")) as f:
        text = f.read()
    files = [open(p, "rb").read() for p in corpus["paths"]]
    return sigs, text, corpus, files


def test_generators_follow_the_seed(tmp_path):
    a = make(SEED, str(tmp_path / "a"))
    b = make(SEED, str(tmp_path / "b"))
    c = make(SEED + 1, str(tmp_path / "c"))
    assert a[1] == b[1] and a[3] == b[3]
    assert np.array_equal(a[2]["tokens"], b[2]["tokens"])
    assert a[1] != c[1] and a[3] != c[3]
    # the same flows, in another order
    la, lc = np.diff(a[2]["starts"]), np.diff(c[2]["starts"])
    assert not np.array_equal(la, lc)
    assert np.array_equal(np.sort(la), np.sort(lc))
    d = make(-SEED, str(tmp_path / "d"))  # any whole seed
    assert np.array_equal(np.sort(np.diff(d[2]["starts"])), np.sort(la))
    assert d[3] != a[3]
    assert [len(s) for s in a[0]] != [len(s) for s in c[0]]


def test_flow_lengths_are_heavy_tailed():
    t = dict(TINY_TRAFFIC["fl"], flows=10000)
    lens = flow_lengths(t)
    assert lens.min() == t["min_packets"]
    assert np.median(lens) < 2.5 * t["min_packets"]
    assert lens.max() > 100 * np.median(lens)


def test_flow_files_parse_to_the_symbols(tmp_path):
    sigs, text, corpus, files = make(SEED, str(tmp_path))
    st, tok = corpus["starts"], corpus["tokens"]
    assert len(files) == len(st) - 1 == TINY_TRAFFIC["fl"]["flows"]
    for i, raw in enumerate(files):
        assert raw.endswith(b"\n") and b"\n" not in raw[:-1]
        assert [int(x) for x in raw.decode().split(", ")] == \
            tok[st[i]:st[i + 1]].tolist()
    for line, s in zip(text.splitlines(), sigs):
        seq, n, _name = line.split(";")
        assert [int(x) for x in seq.split(",")] == s.tolist()
        assert int(n) == len(s)


def test_plants_land_inside_flows(tmp_path):
    """The planted occurrences are there, each inside one flow, at the
    mix's density."""
    from perfbench.check import reference_events

    sigs, _t, corpus, _f = make(SEED, str(tmp_path))
    keys, pats = reference_events(corpus["tokens"], corpus["starts"], sigs,
                                  16, "cpu")
    mean = np.mean([len(s) for s in sigs])
    want = int(len(corpus["tokens"]) * TINY_TRAFFIC["fl"]["plant_density"]
               / mean)
    assert want * 0.8 <= len(keys) <= want + 2
    lens = np.array([len(s) for s in sigs])[pats]
    st = corpus["starts"]
    f = np.searchsorted(st, keys, "right") - 1
    assert (keys - lens + 1 >= st[f]).all()
