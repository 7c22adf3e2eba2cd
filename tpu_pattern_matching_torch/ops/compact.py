"""Match compaction and sorting for the dense engine (torch port of the
reference's ``ops/compact.py``).

The per-lane result slots of the dense walk become dense match tuples: an
exclusive prefix sum over the reported per-lane counts, one scatter into a
fixed capacity, and an optional sort by within-batch position. These are
torch ops, not kernels (a kernel comes only where a measurement shows it
pays). All shapes are fixed by ``capacity``, so nothing syncs with the
host; ``reported`` says how many leading slots are live.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_pattern_matching_torch.ops.match_xla import ScanResult, dense_walk
from tpu_pattern_matching_torch.ops.table import DeviceTable

INT32_MAX = 0x7FFFFFFF


@dataclasses.dataclass
class CompactMatches:
    """Dense (lane, pos, state, gid, rep_pid) tuples for one batch.

    ``meta = [total, reported]``: total is the exact event count (slot
    overflow included); reported the number of live entries (<= capacity).
    ``packed`` stacks the five tuple arrays as [5, K] so the host fetches
    results in one transfer. ``pos`` is the match END offset within the
    lane's own span. ``gcounts`` are the in-walk exact per-group counts,
    exact even when result slots overflow."""

    meta: torch.Tensor  # [2] int32: total, reported
    packed: torch.Tensor  # [5, K] int32: lane, pos, state, gid, rep_pid
    gcounts: torch.Tensor | None = None  # [G] int32

    @property
    def total(self) -> torch.Tensor:
        return self.meta[0]

    @property
    def reported(self) -> torch.Tensor:
        return self.meta[1]

    @property
    def lane(self) -> torch.Tensor:
        return self.packed[0]

    @property
    def pos(self) -> torch.Tensor:
        return self.packed[1]

    @property
    def state(self) -> torch.Tensor:
        return self.packed[2]

    @property
    def gid(self) -> torch.Tensor:
        return self.packed[3]

    @property
    def rep_pid(self) -> torch.Tensor:
        return self.packed[4]


def _compact(counts, slot_state, slot_pos, state_gid, group_rep,
             capacity: int):
    C, R = slot_state.shape
    dev = slot_state.device
    rep = counts.to(torch.int64).clamp(max=R)
    starts = torch.cumsum(rep, 0) - rep  # exclusive prefix sum
    r_iota = torch.arange(R, device=dev)[None, :]
    dst = starts[:, None] + r_iota
    live = r_iota < rep[:, None]
    dst = torch.where(live & (dst < capacity), dst, capacity).reshape(-1)
    lane_ids = torch.arange(C, device=dev)[:, None].expand(C, R).reshape(-1)

    def scatter(values):
        out = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
        return out.scatter_(0, dst, values.to(torch.int32))[:capacity]

    out_lane = scatter(lane_ids)
    out_pos = scatter(slot_pos.reshape(-1))
    out_state = scatter(slot_state.reshape(-1))
    reported = rep.sum().clamp(max=capacity)
    total = counts.to(torch.int64).sum()
    S = state_gid.shape[0]
    gid = torch.where(out_state > 0,
                      state_gid[out_state.to(torch.int64).clamp(0, S - 1)],
                      -1)
    G = group_rep.shape[0]
    rep_pid = torch.where(gid >= 0,
                          group_rep[gid.to(torch.int64).clamp(0, G - 1)], -1)
    meta = torch.stack([total, reported]).to(torch.int32)
    packed = torch.stack([out_lane, out_pos, out_state, gid.to(torch.int32),
                          rep_pid.to(torch.int32)])
    return meta, packed


def compact_matches(table: DeviceTable, result: ScanResult,
                    capacity: int | None = None) -> CompactMatches:
    """Compact per-lane slots into dense match tuples (on the device).

    ``capacity`` bounds the dense result (and the one transfer that
    fetches it); totals stay exact past it."""
    C, R = result.slot_state.shape
    if capacity is None:
        capacity = min(C * R, 8192)
    meta, packed = _compact(result.counts, result.slot_state,
                            result.slot_pos, table.state_gid,
                            table.group_rep, capacity)
    return CompactMatches(meta=meta, packed=packed)


def _sort(meta, packed, chunk_len: int):
    lane, pos = packed[0].to(torch.int64), packed[1].to(torch.int64)
    K = packed.shape[1]
    key = lane * chunk_len + pos
    live = torch.arange(K, device=packed.device) < meta[1].to(torch.int64)
    # dead slots sort last; all of them hold the same (0, 0, 0, -1, -1)
    key = torch.where(live, key, INT32_MAX)
    order = torch.sort(key, stable=True).indices
    return packed[:, order]


def sort_matches(m: CompactMatches, chunk_len: int) -> CompactMatches:
    """Order compacted matches by within-batch position."""
    return CompactMatches(meta=m.meta, packed=_sort(m.meta, m.packed,
                                                    chunk_len),
                          gcounts=m.gcounts)


def scan_and_compact(table: DeviceTable, data, bounds, *, halo: int,
                     max_results: int = 16, capacity: int | None = None,
                     sort: bool = False,
                     chunk_len: int = 0) -> CompactMatches:
    """Walk + compact (+ optional sort) of one lane-major batch ``data
    [C, T]`` with ``bounds [2, C]``, with the in-walk exact ``gcounts``.
    Everything stays on the device; the session fetches ``meta`` first."""
    C = data.shape[0]
    if capacity is None:
        capacity = min(C * max_results, 8192)
    counts, slot_state, slot_pos, gcounts = dense_walk(
        table.table_flat, data.t().contiguous(), bounds,
        alphabet_size=table.alphabet_size, halo=halo,
        max_results=max_results, max_pat_len=table.max_pat_len,
        state_gid=table.state_gid,
        num_groups=table.num_groups,
    )
    meta, packed = _compact(counts, slot_state, slot_pos, table.state_gid,
                            table.group_rep, capacity)
    if sort:
        packed = _sort(meta, packed, chunk_len)
    return CompactMatches(meta=meta, packed=packed, gcounts=gcounts)


def per_group_counts(table: DeviceTable, m: CompactMatches) -> torch.Tensor:
    """Per-match-group event counts [G] (on the device).

    Prefers the in-walk ``m.gcounts`` (exact regardless of slot overflow);
    the slot-derived reduction is the fallback for CompactMatches built
    without them and is exact only when no lane overflowed its R slots."""
    if m.gcounts is not None:
        return m.gcounts
    G = table.num_groups
    gid = m.gid.to(torch.int64)
    live = ((torch.arange(gid.shape[0], device=gid.device)
             < m.reported.to(torch.int64)) & (gid >= 0))
    return torch.zeros(G + 1, dtype=torch.int32, device=gid.device).index_add_(
        0, torch.where(live, gid, G), live.to(torch.int32))[:G]
