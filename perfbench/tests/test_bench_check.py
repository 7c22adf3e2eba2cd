"""The check's comparison of events where files pass 4 MiB, as the screen
cell's files of 32 MiB do: a sound event reads as found wherever it ends,
and an event reported a symbol off is missing and extra."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench.check import compare


def one_batch(ref_key, got_row, length=1 << 26):
    """``compare`` of one batch that read file 0 (of two, ``length``
    symbols each) whole and reported ``got_row``, where the reference has
    pattern 0 ending at ``ref_key``."""
    lanes = [np.array([[0, 0, length]], np.int64)]
    starts = np.array([0, length, 2 * length])
    ref = (np.array([ref_key]), np.array([0]))
    return compare(lanes, [1], {0: np.array([got_row], np.int64)}, ref,
                   starts, 1)[0]


@pytest.mark.parametrize("end", [0, 5, 1 << 22, (1 << 25) + 3,
                                 (1 << 26) - 1])
def test_sound_event_is_found_past_4_mib(end):
    numbers = one_batch(end, [0, end, 0])
    assert numbers["missing_events"][0] == numbers["extra_events"][0] == 0


@pytest.mark.parametrize("end", [7, (1 << 22) + 1, (1 << 25) + 3])
def test_event_a_symbol_off_is_caught_past_4_mib(end):
    numbers = one_batch(end, [0, end - 1, 0])
    assert numbers["missing_events"][0] == 1
    assert numbers["extra_events"][0] == 1
