"""Files of uniform random bytes from the seed, each with whole
signatures planted in it, and near misses: a signature whose last byte
is changed, which only the comparison of that byte tells apart.

Each file is cut into ``plants_per_file + near_misses_per_file`` equal
regions, which the seed deals out to plants and near misses; each region
holds one, at a uniform offset where it fits wholly, of a signature
drawn from the seed. Every seed gives the same sizes and counts.

Parameters: ``files``, ``file_bytes``, ``plants_per_file``,
``near_misses_per_file``.

Returns the files' paths, their bytes end to end (``tokens``) and each
file's first byte in them (``starts``, ``files + 1`` entries)."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def make(params: dict, sigs: list[np.ndarray], rng: np.random.Generator,
         out_dir: str) -> dict:
    files, size = params["files"], params["file_bytes"]
    plants, near = params["plants_per_file"], params["near_misses_per_file"]
    slots = plants + near
    region = size // slots
    if max(len(s) for s in sigs) > region:
        raise ValueError("a file's region is shorter than a signature")
    data = np.frombuffer(bytearray(rng.bytes(files * size)), np.uint8)
    starts = np.arange(files + 1, dtype=np.int64) * size
    kinds = np.stack([rng.permutation(slots) < near for _ in range(files)])
    chosen = rng.integers(0, len(sigs), size=(files, slots))
    at = rng.random((files, slots))
    flip = rng.integers(1, 256, size=(files, slots))
    for f in range(files):
        for r in range(slots):
            s = sigs[chosen[f, r]].copy()
            if kinds[f, r]:
                s[-1] ^= flip[f, r]
            o = int(starts[f]) + r * region + int(at[f, r] *
                                                  (region - len(s) + 1))
            data[o:o + len(s)] = s
    paths = [os.path.join(out_dir, f"file_{i:04d}") for i in range(files)]

    def write(i):
        with open(paths[i], "wb") as fh:
            fh.write(data[starts[i]:starts[i + 1]])

    with ThreadPoolExecutor(4) as pool:
        list(pool.map(write, range(files)))
    return {"paths": paths, "tokens": data, "starts": starts, "bits": 8}
