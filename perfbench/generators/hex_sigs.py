"""Body signatures as the byte grep CLI reads them with ``-x``: one
printable-hex pattern a line (``load_pattern_file(hex_pat=True)``), each
of ``min_len`` to ``max_len`` uniform random bytes drawn from the seed.
They stand for no published signature set: a deployment's configuration
needs its set's own key distribution.

The CLI reads a file whose first line is digits alone (before any
blank) as ``ID PATTERN`` lines, so a first pattern whose hex holds no
letter changes place with the first one that holds a letter.

Parameters: ``count``, ``min_len``, ``max_len`` (bytes)."""

from __future__ import annotations

import numpy as np


def make(params: dict, rng: np.random.Generator) -> list[np.ndarray]:
    n = params["count"]
    lens = rng.integers(params["min_len"], params["max_len"] + 1, size=n)
    raw = np.frombuffer(rng.bytes(int(lens.sum())), np.uint8)
    cut = np.concatenate([[0], np.cumsum(lens)])
    sigs = [raw[cut[i]:cut[i + 1]].copy() for i in range(n)]
    if sigs[0].tobytes().hex().isdigit():
        j = next(i for i, s in enumerate(sigs) if not s.tobytes().hex()
                 .isdigit())
        sigs[0], sigs[j] = sigs[j], sigs[0]
    return sigs


def write(path: str, sigs: list[np.ndarray]) -> None:
    with open(path, "w") as f:
        f.writelines(s.tobytes().hex() + "\n" for s in sigs)
