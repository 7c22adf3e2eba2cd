"""The plain reference against brute force, at both symbol widths."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.reference.matcher import Matcher


def brute(rows, lo, hi, pats):
    out = []
    for r in range(rows.shape[0]):
        for t in range(rows.shape[1]):
            for i, p in enumerate(pats):
                L = len(p)
                if lo[r] <= t and t + L <= hi[r] and \
                        np.array_equal(rows[r, t:t + L], p):
                    out.append((r, t + L - 1, i))
    return sorted(out)


@pytest.mark.parametrize("bits,alphabet,max_len", [(8, 3, 6), (8, 256, 12),
                                                   (16, 3, 9),
                                                   (16, 2048, 16)])
def test_matcher_equals_brute_force(bits, alphabet, max_len):
    rng = np.random.default_rng(bits * 1000 + alphabet)
    pats = [rng.integers(0, alphabet, size=rng.integers(1, max_len + 1))
            for _ in range(40)]
    pats.append(pats[3].copy())  # equal patterns: both ids report
    pats.append(pats[5][1:] if len(pats[5]) > 1 else pats[5])  # a suffix
    rows = rng.integers(0, alphabet, size=(6, 300))
    for k in range(30):  # plant, some across the span's edges
        p = pats[rng.integers(len(pats))]
        r, t = rng.integers(6), rng.integers(0, 300 - len(p))
        rows[r, t:t + len(p)] = p
    lo = np.array([0, 5, 40, 0, 150, 299])
    hi = np.array([300, 200, 41, 0, 300, 300])
    m = Matcher(pats, bits, "cpu")
    r, e, p = m.match(torch.from_numpy(rows), torch.from_numpy(lo),
                      torch.from_numpy(hi))
    assert sorted(zip(r.tolist(), e.tolist(), p.tolist())) == \
        brute(rows, lo, hi, pats)


def test_matcher_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys, perfbench.reference.matcher, perfbench.check; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('tpu_pattern_matching_torch', 'tpu_pattern_matching', 'jax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    from perfbench.tests.conftest import REPO

    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
