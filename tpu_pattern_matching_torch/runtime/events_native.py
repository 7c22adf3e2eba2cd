"""ctypes binding of the native event builder (``csrc/events.cpp``).

``EventBuilder(MatchEvent, fields)`` builds the library with g++ on first
use (``ops.kernels.python_library``: cached in ``_build/`` and rebuilt
when stale), reads the slot offsets of the type's fields once, and then
makes a batch's events from its verified columns in one call
(``MatchSession._events_from_arrays``). The events leave the cyclic
collector as they are made; ``track`` puts one back. Raises
``EventsUnavailable`` where the library cannot be built or the type has
no such slots: the session then builds the events in Python.
"""

from __future__ import annotations

import ctypes

import numpy as np

P, O = ctypes.c_void_p, ctypes.py_object


class EventsUnavailable(RuntimeError):
    pass


def _bind(lib) -> None:
    lib.tpm_event_offsets.argtypes = [O, O, P]
    lib.tpm_event_offsets.restype = ctypes.c_int
    lib.tpm_build_events.argtypes = ([O, P, ctypes.c_ssize_t] + [P] * 4
                                     + [O] * 3)
    lib.tpm_build_events.restype = O
    lib.tpm_track.argtypes = [O]
    lib.tpm_track.restype = None


class EventBuilder:
    """Events of ``event_type``, whose ``fields`` are, in order, the file
    id, absolute end, pattern list, representative, lane and gid slots."""

    def __init__(self, event_type: type, fields: tuple[str, ...]):
        from tpu_pattern_matching_torch.ops import kernels

        try:
            lib = kernels.python_library(kernels.EVENTS_LIBRARY, _bind)
            self._offsets = np.zeros(len(fields), np.int64)
            lib.tpm_event_offsets(event_type, tuple(fields),
                                  self._offsets.ctypes.data)
        except (RuntimeError, OSError, TypeError) as e:
            raise EventsUnavailable(f"no native event builder: {e}") from e
        self._type = event_type
        self._build = lib.tpm_build_events
        self.track = lib.tpm_track

    def __call__(self, file_a, end_a, ln_a, gid_a, groups: list,
                 reps: list, pids: list | None = None) -> list:
        """The events of the rows: ``groups[gid]`` and ``reps[gid]`` an
        event's pattern list and representative, or ``pids[i]`` and its
        first item where ``pids`` is given."""
        cols = [np.ascontiguousarray(c, np.int64)
                for c in (file_a, end_a, ln_a, gid_a)]
        n = len(cols[0])
        if any(c.shape != (n,) for c in cols):
            raise ValueError(f"columns of unequal shapes "
                             f"{[c.shape for c in cols]}")
        return self._build(self._type, self._offsets.ctypes.data, n,
                           *(c.ctypes.data for c in cols), groups, reps,
                           pids)
