"""Every occurrence of a set of fixed patterns in rows of symbols, in plain
PyTorch (any device), written from the matching semantics alone: an event
is ``(row, end, pattern)`` for each pattern whose symbols equal those of
the row ending at position ``end`` (inclusive), inside the row's valid
span ``[lo, hi)``. Overlapping occurrences and patterns that are equal or
suffixes of one another all count, as in Aho-Corasick.

Method: a 64-bit key of each position's first ``p`` symbols (``p`` symbols
of ``bits`` bits, ``p * bits <= 64``) is looked up among the patterns'
prefix keys (a sorted tensor and ``searchsorted``); every position whose
key matches is then compared symbol by symbol with each pattern of that
key. Patterns shorter than the key width take a shorter key of their own.
"""

from __future__ import annotations

import numpy as np
import torch


def _keys(rows: torch.Tensor, p: int, bits: int) -> torch.Tensor:
    """int64 ``[R, T - p + 1]``: symbols ``t .. t+p-1`` of each row packed
    little-endian, ``bits`` bits each (bit patterns; the sign is of no
    account, only equality and order are used)."""
    T = rows.shape[1]
    n = T - p + 1
    key = torch.zeros((rows.shape[0], n), dtype=torch.int64,
                      device=rows.device)
    for j in range(p):
        key |= rows[:, j:j + n].to(torch.int64) << (bits * j)
    return key


def _pattern_keys(pats: list[np.ndarray], p: int, bits: int) -> np.ndarray:
    out = np.zeros(len(pats), np.int64)
    for i, pat in enumerate(pats):
        k = 0
        for j in range(p):
            k |= int(pat[j]) << (bits * j)
        out[i] = np.int64(k - (1 << 64) if k >= (1 << 63) else k)
    return out


class Matcher:
    """Exact matcher of ``patterns`` (a list of 1-D integer arrays, each
    symbol below ``2 ** bits``) on ``device``."""

    def __init__(self, patterns: list[np.ndarray], bits: int, device):
        if not patterns or min(len(p) for p in patterns) < 1:
            raise ValueError("patterns must be non-empty")
        self.bits = bits
        self.device = torch.device(device)
        self.groups = []  # (p, sorted keys, pattern ids in key order, max L)
        kmax = 64 // bits
        lens = np.array([len(p) for p in patterns])
        for p in sorted(set(np.minimum(lens, kmax).tolist())):
            ids = np.flatnonzero(np.minimum(lens, kmax) == p)
            keys = _pattern_keys([patterns[i] for i in ids], p, bits)
            order = np.argsort(keys, kind="stable")
            self.groups.append((p, torch.from_numpy(keys[order]).to(
                self.device), ids[order]))
        self.lens = lens
        L = int(lens.max())
        padded = np.full((len(patterns), L), -1, np.int64)
        for i, pat in enumerate(patterns):
            padded[i, :len(pat)] = pat
        self.padded = torch.from_numpy(padded).to(self.device)
        self.lens_t = torch.from_numpy(lens).to(self.device)

    def match(self, rows: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Events of ``rows [R, T]`` (integer symbols) inside each row's
        ``[lo, hi)``: ``(row, end, pattern)`` int64 arrays, sorted by row,
        end, pattern."""
        rows = rows.to(self.device)
        lo = lo.to(self.device).to(torch.int64)
        hi = hi.to(self.device).to(torch.int64)
        R, T = rows.shape
        L = self.padded.shape[1]
        # one pad of -1 symbols, so a pattern never reads past the row
        ext = torch.cat([rows.to(torch.int64), torch.full(
            (R, L), -1, dtype=torch.int64, device=self.device)], 1)
        out_r, out_e, out_p = [], [], []
        for p, keys, ids in self.groups:
            if T < p:
                continue
            pos_key = _keys(rows, p, self.bits)
            at = torch.searchsorted(keys, pos_key)
            hit = keys[at.clamp(max=len(keys) - 1)] == pos_key
            r_i, t_i = torch.nonzero(hit, as_tuple=True)
            if not len(r_i):
                continue
            first = at[r_i, t_i]
            want = pos_key[r_i, t_i]
            ids_t = torch.from_numpy(ids).to(self.device)
            # every pattern of the key: walk the run of equal keys
            k = 0
            while True:
                j = first + k
                ok = (j < len(keys)) & (
                    keys[j.clamp(max=len(keys) - 1)] == want)
                if not bool(ok.any()):
                    break
                rr, tt = r_i[ok], t_i[ok]
                pid = ids_t[j[ok]]
                pl = self.lens_t[pid]
                span = tt[:, None] + torch.arange(L, device=self.device)
                seg = ext[rr[:, None], span]
                pat = self.padded[pid]
                inside = torch.arange(L, device=self.device)[None, :] < \
                    pl[:, None]
                same = ((seg == pat) | ~inside).all(1)
                end = tt + pl - 1
                keep = same & (tt >= lo[rr]) & (end < hi[rr])
                out_r.append(rr[keep])
                out_e.append(end[keep])
                out_p.append(pid[keep])
                k += 1
        if not out_r:
            z = np.zeros(0, np.int64)
            return z, z.copy(), z.copy()
        r = torch.cat(out_r).cpu().numpy()
        e = torch.cat(out_e).cpu().numpy()
        p = torch.cat(out_p).cpu().numpy()
        order = np.lexsort((p, e, r))
        return r[order], e[order], p[order]
