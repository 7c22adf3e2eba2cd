"""The check fails what it should: the control (the reference in the
program's place, at 8 bits where the configuration states 11) and the
timed path broken underneath in each way a cell can be broken. The runs take the
plain versions of the kernels on the CPU at the tiny cells' sizes; the
look for a card is skipped (``run_cell`` is called directly)."""

from __future__ import annotations

import copy

import numpy as np
import pytest

from perfbench.harness import run_cell
from perfbench.tests.conftest import tiny_cell

from perfbench.control import narrow_tokens

SEED = 2**31 + 4242
CELLS = ["tinyu.fl"]


class Wrap:
    """The session, with ``scan`` and ``decode`` passed through a fault."""

    def __init__(self, sess):
        self.sess = sess
        self._mesh_ctx, self._grid = sess._mesh_ctx, sess._grid
        self.global_totals = sess.global_totals
        self.prev = None

    def scan(self, batch):
        return self.sess.scan(batch)

    def decode(self, batch, comp):
        return self.sess.decode(batch, comp)


class Stale(Wrap):
    """A step that returns its state unchanged: decode hands back the
    batch before's answer."""

    def decode(self, batch, comp):
        bm = self.sess.decode(batch, comp)
        out, self.prev = (self.prev or bm), bm
        return out


class HalfBatch(Wrap):
    """Half of the batch left out: the second half of its lanes are
    emptied before the scan."""

    def scan(self, batch):
        b = copy.copy(batch)
        b.end_t = batch.end_t.copy()
        h = batch.chunks // 2
        b.end_t[h:batch.chunks] = b.start_t[h:batch.chunks] = batch.halo
        b.start_t = batch.start_t.copy()
        b.start_t[h:batch.chunks] = batch.halo
        return self.sess.scan(b)


class Altered(Wrap):
    """An answer altered where it is produced: every fourth event's
    offset moves by one."""

    def decode(self, batch, comp):
        bm = self.sess.decode(batch, comp)
        for e in bm.events[::4]:
            e.end_offset += 1
        return bm


def fault(cls):
    def stand_in(sess, _inputs):
        iid_of = np.array([p.iid for p in sess.table.patterns], np.int64)
        return cls(sess), iid_of
    return stand_in


FAULTS = {"stale": fault(Stale), "half_batch": fault(HalfBatch),
          "altered": fault(Altered)}


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny_root, workload):
    line, numbers = run_cell(tiny_cell(tiny_root, workload), SEED, 1.0,
                             False, "cpu")
    assert line["correct"], numbers
    assert numbers["window_events"][0] > 0


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("broken", ["stale", "half_batch", "altered"])
def test_broken_path_is_not_correct(tiny_root, workload, broken):
    line, numbers = run_cell(tiny_cell(tiny_root, workload), SEED, 1.0,
                             False, "cpu", stand_in=FAULTS[broken])
    assert not line["correct"], numbers
    assert line["failed"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny_root, workload):
    line, numbers = run_cell(tiny_cell(tiny_root, workload), SEED, 1.0,
                             False, "cpu", stand_in=narrow_tokens)
    assert not line["correct"], numbers
    assert numbers["extra_events"][0] > 0
