"""A pooled CRISPR knockout library's guides as a screen's user hands them
to ``grep -F -f``: one guide a line, plain ACGT, as the byte grep CLI
reads a pattern file without ``-x``.

``count`` distinct guides of ``length`` nt, uniform over ACGT from the
seed, none holding ``forbid`` (a run of T ends transcription from the U6
promoter, so a library leaves such guides out). The sequences stand in
for a published library's, which are not in the repository; their count,
length and alphabet are the library's.

Parameters: ``count``, ``length``, ``forbid``."""

from __future__ import annotations

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _holds(codes: np.ndarray, run: np.ndarray) -> np.ndarray:
    """Which rows of ``codes [n, L]`` hold the code sequence ``run``."""
    k = len(run)
    hit = np.zeros(len(codes), bool)
    for j in range(codes.shape[1] - k + 1):
        hit |= (codes[:, j:j + k] == run).all(1)
    return hit


def make(params: dict, rng: np.random.Generator) -> list[np.ndarray]:
    n, length = params["count"], params["length"]
    run = np.searchsorted(ACGT, np.frombuffer(params["forbid"].encode(),
                                              np.uint8))
    weights = 4 ** np.arange(length, dtype=np.int64)
    kept = np.zeros((0, length), np.uint8)
    while len(kept) < n:  # draw, leave out forbidden and repeated guides
        codes = rng.integers(0, 4, size=(n + n // 8 + 64, length),
                             dtype=np.uint8)
        codes = np.concatenate([kept, codes[~_holds(codes, run)]])
        _, first = np.unique(codes.astype(np.int64) @ weights,
                             return_index=True)
        kept = codes[np.sort(first)]
    return list(ACGT[kept[:n]])


def write(path: str, sigs: list[np.ndarray]) -> None:
    with open(path, "wb") as f:
        f.write(b"".join(s.tobytes() + b"\n" for s in sigs))
