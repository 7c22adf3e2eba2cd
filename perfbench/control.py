"""The check's control: the plain reference put in the program's place,
one step below what the configuration states, by its ``unit``.

- ``tokens``: the tokens are packet lengths of an alphabet of 2048 (11
  bits, held in 16); the control holds them in 8 bits, clamped to 255 as
  the CLI's parse clamps a number past the alphabet to 2047, in
  signatures and flows alike (the step that would tempt a later PR: the
  byte kernels scan half the data).
- ``bytes``: every signature cut one byte below the length the
  configuration states (11 bytes where ``-m 12`` holds 12), the
  guarantee that would tempt a later PR: a shorter exact comparison. It
  reports each occurrence at the end of its first 11 bytes and takes
  near misses for events.

Each lane is matched with its halo, so only that step differs. The check
has to find such a run not correct.

    python3 -m perfbench.control --workload NAME --seeds A,B,C --seconds S

runs the cell's feed and window with the control in the session's place,
once a seed, on the card, and prints each run's numbers beside their
limits (one JSON line a seed). The benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

from perfbench.reference.matcher import Matcher

NARROW = 255  # the largest symbol of 8 bits


def narrow(symbols: np.ndarray) -> np.ndarray:
    return np.minimum(symbols, NARROW).astype(np.uint8)


class Narrow:
    """Stands in for ``MatchSession`` in the CLI loop: ``scan`` keeps the
    batch, ``decode`` matches each lane (halo and own symbols) with the
    reference at 8 bits and reports the events that end in the lane's own
    symbols."""

    def __init__(self, sess, inputs):
        self._mesh_ctx, self._grid = sess._mesh_ctx, sess._grid
        self.global_totals = False
        self.device = sess.device
        self.m = Matcher([narrow(s) for s in inputs.ref_sigs], 8,
                         sess.device)

    def scan(self, batch):
        return batch

    def decode(self, batch, _comp):
        n, h = batch.chunks, batch.halo
        events = []
        if n:
            rows = torch.from_numpy(narrow(batch.data[:n]))
            r, e, p = self.m.match(
                rows, torch.from_numpy(batch.start_t[:n].astype(np.int64)),
                torch.from_numpy(batch.end_t[:n].astype(np.int64)))
            own = e >= h
            events = self.events(batch, r[own], e[own] - h, p[own])
        total = sum(len(ev.pattern_indices) for ev in events)
        return SimpleNamespace(events=events, total=total, reported=total,
                               overflowed=False)

    @staticmethod
    def events(batch, r, e, p) -> list:
        """One event a (lane, end), with every pattern ending there, as the
        session reports them (``r``, ``e`` sorted)."""
        if not len(r):
            return []
        cut = np.flatnonzero((np.diff(r) != 0) | (np.diff(e) != 0)) + 1
        first = np.concatenate([[0], cut])
        fid = batch.file_ids[r[first]]
        end = batch.base_off[r[first]] + e[first]
        return [SimpleNamespace(file_id=int(f), end_offset=int(x),
                                pattern_indices=q.tolist())
                for f, x, q in zip(fid, end, np.split(p, cut))]


class Short(Narrow):
    """:class:`Narrow` at 8 bits (the byte data pass through unchanged),
    with the signatures one byte shorter than the configuration's
    length."""

    def __init__(self, sess, inputs):
        self._mesh_ctx, self._grid = sess._mesh_ctx, sess._grid
        self.global_totals = False
        self.device = sess.device
        cut = max(len(s) for s in inputs.ref_sigs) - 1
        self.m = Matcher([s[:cut] for s in inputs.ref_sigs], 8, sess.device)


def narrow_tokens(sess, inputs):
    return Narrow(sess, inputs), np.arange(len(inputs.sigs))


def short_signatures(sess, inputs):
    return Short(sess, inputs), np.arange(len(inputs.sigs))


STAND_INS = {"tokens": narrow_tokens, "bytes": short_signatures}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    os.environ["TPM_COST_CONSTANTS"] = os.path.join(here, "no-cost-constants")

    from perfbench import spec
    from perfbench.harness import run_cell

    cell = spec.load(a.workload)
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA card", file=sys.stderr)
        return 2
    stand_in = STAND_INS[cell.config["unit"]]
    for seed in (int(s) for s in a.seeds.split(",")):
        line, numbers = run_cell(cell, seed, a.seconds, False, "cuda",
                                 stand_in=stand_in)
        print(json.dumps({"control": stand_in.__name__,
                          "workload": a.workload,
                          "seed": seed, "correct": line["correct"],
                          "attempted": line["attempted"],
                          "numbers": {k: v[0] for k, v in numbers.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
