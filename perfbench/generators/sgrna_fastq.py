"""FASTQ files of a pooled CRISPR screen's reads, as a core facility counts
guides in them with ``grep -F -f library``: single-end reads of
``read_length`` nt, each four lines (CASAVA 1.8 header, read, ``+``,
Phred+33 qualities).

A read is a stagger of 0 to ``stagger_max`` random nt, the ``promoter``'s
3' end, a guide of the library, then the ``scaffold``, cut to the read's
length. Guides are drawn by abundance, log-normal of ``abundance_sigma``
over the library (the weights drawn from the seed). ``phix_share`` of the
reads hold no guide: random ACGT for a spike-in. ``error_rate`` of all
bases are substituted, and a base whose quality falls in the bin ``#``
is called ``N``. Qualities are drawn from ``quality_bins`` (character:
share).

Every file holds ``file_bytes // record`` whole records of one length (the
header's numbers have fixed widths), so every seed gives the same sizes
and the same number of reads and errors. File ``f``'s header names lane
``f % 4 + 1`` and a sample index of its own.

Returns the files' paths, their bytes end to end (``tokens``), each
file's first byte in them (``starts``), and per read: the guide it holds
(``guide``, -1 for none), the position in ``tokens`` of that guide's
last base (``guide_end``), and whether the guide was read without an
error (``clean``)."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _text(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), np.uint8)


def _digits(v: np.ndarray, width: int) -> np.ndarray:
    """``[n, width]`` ASCII digits of ``v``, most significant first."""
    p = 10 ** np.arange(width - 1, -1, -1)
    return (48 + v[:, None] // p % 10).astype(np.uint8)


def _headers(params, f, n, run_id, flowcell, index, rng) -> np.ndarray:
    """``[n, width]`` CASAVA 1.8 headers of file ``f``: ``@instrument:run:
    flowcell:lane:tile:x:y 1:N:0:index``, NextSeq tiles (surface, swath,
    camera, tile), four-digit x and y."""
    tile = (10000 * rng.integers(1, 3, n) + 1000 * rng.integers(1, 4, n)
            + 100 * rng.integers(1, 7, n) + rng.integers(1, 13, n))
    x, y = rng.integers(1000, 10000, n), rng.integers(1000, 10000, n)
    head = f"@{params['instrument']}:{run_id}:{flowcell}:{f % 4 + 1}:"
    cols = [np.tile(_text(head), (n, 1)), _digits(tile, 5),
            np.tile(_text(":"), (n, 1)), _digits(x, 4),
            np.tile(_text(":"), (n, 1)), _digits(y, 4),
            np.tile(_text(" 1:N:0:" + index), (n, 1))]
    return np.concatenate(cols, 1)


def make(params: dict, sigs: list[np.ndarray], rng: np.random.Generator,
         out_dir: str) -> dict:
    L, smax = params["read_length"], params["stagger_max"]
    promoter, scaffold = _text(params["promoter"]), _text(params["scaffold"])
    guides = np.stack(sigs)
    G, glen = guides.shape
    if smax + len(promoter) + glen > L or \
            smax + len(promoter) + glen + len(scaffold) < L:
        raise ValueError("a read does not hold the promoter and a guide, or "
                         "outruns the scaffold")
    weight = rng.lognormal(0.0, params["abundance_sigma"], G)
    weight /= weight.sum()
    run_id = int(rng.integers(100, 1000))
    flowcell = "H" + "".join(rng.choice(list("ABCDEFGHJKLMNPRSTVWXY3579"),
                                        4)) + "BGX9"
    bins = params["quality_bins"]
    qchars = _text("".join(bins))
    # a quality bin from 16 random bits, by a table of the bins' shares
    edges = np.round(np.cumsum(list(bins.values())) * 65536).astype(int)
    qbin = np.searchsorted(edges, np.arange(65536), "right").astype(np.uint8)
    no_call = qchars == ord("#")
    template = np.concatenate([promoter, np.zeros(glen, np.uint8), scaffold])
    g0 = len(promoter)  # the guide's first base in the template

    files = params["files"]
    width = len(_headers(params, 0, 1, run_id, flowcell, "A" * 8,
                         np.random.default_rng(0))[0])
    rec = width + 1 + L + 3 + L + 1  # bytes a record
    n = params["file_bytes"] // rec  # records a file
    tokens = np.empty(files * n * rec, np.uint8)
    seeds = rng.integers(0, 2**63, size=(files, 2))  # a stream a file
    paths = [os.path.join(out_dir, f"sample_{f:02d}.fastq")
             for f in range(files)]

    def one_file(f):
        rng = np.random.default_rng(seeds[f])
        index = "".join(rng.choice(list("ACGT"), 8))
        head = _headers(params, f, n, run_id, flowcell, index, rng)
        phix = rng.permutation(n) < round(params["phix_share"] * n)
        g = rng.choice(G, size=n, p=weight)
        g[phix] = -1
        s = rng.integers(0, smax + 1, n)
        seq = ACGT[rng.integers(0, 4, (n, L), dtype=np.uint8)]
        for k in range(smax + 1):  # stagger, promoter, guide, scaffold
            r = np.flatnonzero((s == k) & ~phix)
            seq[r, k:] = template[:L - k]
            seq[r, k + g0:k + g0 + glen] = guides[g[r]]
        err = rng.integers(0, n * L, round(params["error_rate"] * n * L))
        flat = seq.reshape(-1)
        code = np.searchsorted(ACGT, flat[err])
        flat[err] = ACGT[(code + rng.integers(1, 4, len(err))) % 4]
        qual = qbin[rng.integers(0, 65536, (n, L), dtype=np.uint16)]
        bad = no_call[qual]
        seq[bad] = ord("N")
        bad.reshape(-1)[err] = True
        clean = ~phix
        for k in range(smax + 1):
            r = np.flatnonzero(s == k)
            clean[r] &= ~bad[r, k + g0:k + g0 + glen].any(1)
        nl = np.full((n, 1), 10, np.uint8)
        mine = tokens[f * n * rec:(f + 1) * n * rec]
        mine[:] = np.concatenate(
            [head, nl, seq, np.tile(_text("\n+\n"), (n, 1)), qchars[qual],
             nl], 1).reshape(-1)
        with open(paths[f], "wb") as fh:
            fh.write(mine)
        end = (f * n * rec + width + 1 + np.arange(n, dtype=np.int64) * rec
               + s + g0 + glen - 1)
        return g, end, clean

    with ThreadPoolExecutor(4) as pool:
        guide, guide_end, clean = zip(*pool.map(one_file, range(files)))
    return {"paths": paths, "tokens": tokens,
            "starts": np.arange(files + 1, dtype=np.int64) * n * rec,
            "bits": 8, "guide": np.concatenate(guide),
            "guide_end": np.concatenate(guide_end),
            "clean": np.concatenate(clean)}
