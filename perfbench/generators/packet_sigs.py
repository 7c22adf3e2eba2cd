"""Packet-metadata signatures of the AC_ushorts format (``seq; len;
name`` lines): token sequences of ``min_len`` to ``max_len`` packet
lengths, nine in ten of them 40-1514 and one in ten anywhere below 2048
(a copy of ``chip_smoke.packet_lengths`` and ``write_signatures``).

Parameters: ``count``, ``min_len``, ``max_len`` (tokens)."""

from __future__ import annotations

import numpy as np


def packet_lengths(rng: np.random.Generator, n: int) -> np.ndarray:
    v = rng.integers(40, 1515, size=n)
    wild = rng.random(n) < 0.1
    v[wild] = rng.integers(0, 2048, size=int(wild.sum()))
    return v.astype(np.uint16)


def make(params: dict, rng: np.random.Generator) -> list[np.ndarray]:
    n = params["count"]
    lens = rng.integers(params["min_len"], params["max_len"] + 1, size=n)
    toks = packet_lengths(rng, int(lens.sum()))
    cut = np.concatenate([[0], np.cumsum(lens)])
    return [toks[cut[i]:cut[i + 1]] for i in range(n)]


def write(path: str, sigs: list[np.ndarray]) -> None:
    with open(path, "w") as f:
        f.writelines(f"{','.join(map(str, s.tolist()))}; {len(s)}; sig {i}\n"
                     for i, s in enumerate(sigs))
