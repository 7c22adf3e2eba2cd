"""The port's sentiment app (``tpu_pattern_matching_torch.apps.sentiment``)
on the CPU: library mode against the reference's ``run_library_mode``,
and subprocess mode, which reads the port CLI's verbose lines, against
library mode. A fixed clock makes every decay factor exactly 1, so each
counter holds an exact count and the comparisons are exact."""

import types

import numpy as np
import pytest

from tpu_pattern_matching.apps import sentiment as ref_app
from tpu_pattern_matching.core.oracle import match_python
from tpu_pattern_matching_torch.apps import sentiment as port_app


@pytest.fixture
def inputs(tmp_path):
    rng = np.random.RandomState(4)
    vocab = sorted({"".join(chr(97 + c) for c in rng.randint(0, 26, size=n))
                    for n in rng.randint(3, 7, size=80)})
    neg, pos = vocab[:6], vocab[6:12]
    (tmp_path / "neg").write_text("\n".join(neg) + "\n")
    (tmp_path / "pos").write_text("\n".join(pos) + "\n")
    text = "\n".join(" ".join(rng.choice(vocab, size=rng.randint(4, 12)))
                     for _ in range(300)) + "\n"
    (tmp_path / "text").write_text(text)
    args = types.SimpleNamespace(
        patterns=str(tmp_path / "patterns"), input=str(tmp_path / "text"),
        chunk_size=256, global_ws=16, interval=1e18, device="cpu")
    meta = ref_app.build_sentiment_patterns(
        str(tmp_path / "neg"), str(tmp_path / "pos"), None, args.patterns)
    return args, meta, neg + pos, text.encode()


def capture(monkeypatch, *modules):
    """Analyzers handed to print_reports, under a fixed clock."""
    seen = []
    clock = types.SimpleNamespace(time=lambda: 1.0e9)
    for m in modules:
        monkeypatch.setattr(m, "print_reports", seen.append)
        monkeypatch.setattr(m, "time", clock)
    return seen


def counts(ana):
    """{label: count} of every window's per-word counters, and the
    windows' positive and negative totals."""
    return {w: ({ana.labels[p]: c.get() for p, c in ana.freq[w].items()},
                ana.pos[w].get(), ana.neg[w].get()) for w in ana.windows}


def test_library_mode_equals_reference(inputs, monkeypatch):
    args, meta, words, text = inputs
    seen = capture(monkeypatch, ref_app, port_app)
    assert ref_app.run_library_mode(args, meta) == 0
    assert port_app.run_library_mode(args, meta) == 0
    ref, port = seen[-2], seen[-1]
    assert counts(port) == counts(ref)
    want = match_python([f" {w} ".encode() for w in words], text)
    assert port.matches == ref.matches == len(want) > 20


def test_subprocess_mode_reads_the_port_cli(inputs, monkeypatch):
    args, meta, words, text = inputs
    seen = capture(monkeypatch, ref_app, port_app)
    assert port_app.run_library_mode(args, meta) == 0
    assert port_app.run_subprocess_mode(args) == 0
    lib, sub = seen[-2], seen[-1]
    # subprocess mode takes iids and labels from the lines alone (labels
    # keep the patterns' spaces), every pattern weighing 1, as in the
    # reference
    assert sub.matches == lib.matches > 20
    for w in lib.windows:
        got = {lb.strip(): c for lb, c in counts(sub)[w][0].items()}
        assert got == counts(lib)[w][0]
    lib_iid = dict(zip(lib.labels, lib.iids))
    assert sorted(sub.iids) == sorted(lib_iid[lb.strip()] for lb in sub.labels)
