"""CPU oracle matchers — conformance ground truth.

The reference has no oracle (correctness was eyeballed against ``-v`` output,
SURVEY.md section 4); BASELINE.json demands exact ``(offset, pattern_id)``
parity against a CPU Aho-Corasick oracle, so we provide two independent
implementations:

- :func:`match_naive` — patterns checked at every position by slicing.
  O(n * patterns) — the simplest possible ground truth for small tests.
- :func:`match_python` — a dict-based Aho-Corasick walk, independent of the
  dense-table compiler in ``core.dfa`` (different data structures, same math).
- ``core.oracle_native`` wraps a third, C++ implementation for large corpora.

Match semantics (the framework-wide contract): a match event is
``(end_offset, pattern_index)`` where ``end_offset`` is the index of the LAST
byte of the occurrence, and every pattern ending at that position is reported
(the reference reports only the head of the per-state match list,
acsmx.c:645-651 / databuf.c:769; we report the full set — a strict superset).
"""

from __future__ import annotations

from typing import Sequence


def match_naive(
    patterns: Sequence[bytes | Sequence[int]],
    data: bytes | Sequence[int],
) -> list[tuple[int, int]]:
    """All (end_offset, pattern_index) events, by brute force."""
    events: list[tuple[int, int]] = []
    data = list(data)
    pats = [list(p) for p in patterns]
    for end in range(len(data)):
        for pi, p in enumerate(pats):
            start = end - len(p) + 1
            if start >= 0 and data[start : end + 1] == p:
                events.append((end, pi))
    return events


class PyAhoCorasick:
    """Dict-based Aho-Corasick (goto/fail walk, no dense table)."""

    def __init__(self, patterns: Sequence[bytes | Sequence[int]]):
        self.children: list[dict[int, int]] = [{}]
        self.out: list[list[int]] = [[]]
        self.fail: list[int] = [0]
        for pi, pat in enumerate(patterns):
            s = 0
            for c in pat:
                c = int(c)
                if c not in self.children[s]:
                    self.children.append({})
                    self.out.append([])
                    self.fail.append(0)
                    self.children[s][c] = len(self.children) - 1
                s = self.children[s][c]
            self.out[s].append(pi)
        # BFS fail links + output closure
        queue = list(self.children[0].values())
        head = 0
        while head < len(queue):
            s = queue[head]
            head += 1
            for c, t in self.children[s].items():
                f = self.fail[s]
                while c not in self.children[f] and f != 0:
                    f = self.fail[f]
                self.fail[t] = self.children[f].get(c, 0)
                if self.fail[t] == t:
                    self.fail[t] = 0
                self.out[t] = sorted(set(self.out[t]) | set(self.out[self.fail[t]]))
                queue.append(t)

    def step(self, state: int, c: int) -> int:
        while c not in self.children[state] and state != 0:
            state = self.fail[state]
        return self.children[state].get(c, 0)

    def match(
        self, data: bytes | Sequence[int], state: int = 0
    ) -> tuple[list[tuple[int, int]], int]:
        """Scan ``data`` from ``state``; return (events, final_state)."""
        events: list[tuple[int, int]] = []
        for i, c in enumerate(data):
            state = self.step(state, int(c))
            for pi in self.out[state]:
                events.append((i, pi))
        return events, state


def match_python(
    patterns: Sequence[bytes | Sequence[int]],
    data: bytes | Sequence[int],
) -> list[tuple[int, int]]:
    events, _ = PyAhoCorasick(patterns).match(data)
    return events
