"""Deterministic word corpora of the benchmarks (copy of the reference
repository's ``tests/fixtures.random_words_corpus``, which the reference's
``benchmarks/run_configs.py`` imports; held equal by
``tests/test_torch_copies.py``)."""

from __future__ import annotations

import random
import string


def random_words_corpus(
    seed: int = 1234,
    n_lines: int = 400,
    words_per_line: int = 12,
    n_patterns: int = 8,
    plant_every: int = 50,
) -> tuple[list[bytes], bytes]:
    """Word-soup text with patterns planted on ~1/plant_every lines.

    Returns (patterns, corpus_bytes).
    """
    rng = random.Random(seed)

    def word() -> str:
        return "".join(
            rng.choice(string.ascii_lowercase) for _ in range(rng.randint(3, 10))
        )

    patterns = [word() + str(i) for i in range(n_patterns)]
    lines = []
    for ln in range(n_lines):
        ws = [word() for _ in range(words_per_line)]
        if ln % plant_every == plant_every - 1:
            ws[rng.randrange(len(ws))] = rng.choice(patterns)
        lines.append(" ".join(ws))
    corpus = ("\n".join(lines) + "\n").encode()
    return [p.encode() for p in patterns], corpus
