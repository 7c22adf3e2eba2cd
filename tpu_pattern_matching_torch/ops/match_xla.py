"""The dense DFA-walk scan engine (torch port of the reference's
``ops/match_xla.py``).

Chunk lanes are walked independently through the signed dense table: a
lane starts in the root state at the start of its prefix halo, advances
only inside its valid span ``[start_t, end_t)``, and reports the matches
that END inside its own span (``t >= halo``). A halo of ``max_pat_len - 1``
bytes is exactly enough: no straddling match is lost, none is reported
twice (MATCHING.md).

The reference walks all lanes in one XLA ``lax.scan`` over time steps;
torch has no scan, so the walk is a CUDA kernel (``csrc/dfa_walk.cu``) for
a CUDA tensor and a plain PyTorch loop over time steps for a CPU tensor.
The kernel cuts each lane into sub-spans walked from the root after a
warm-up of ``max_pat_len - 1`` symbols, the halo argument above applied
inside a lane: the same states, reports and counts.
The module keeps the reference's name so that each module's counterpart is
easy to find.

Match capacity: ``max_results`` slots per lane; the per-lane count is
always exact even when the slots overflow.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_pattern_matching_torch.ops.table import DeviceTable


@dataclasses.dataclass
class ScanResult:
    """Per-lane match outputs.

    ``counts[c]`` — exact number of match events in lane c's own span.
    ``slot_state[c, r]`` — DFA state of the r-th match (r < min(count, R)).
    ``slot_pos[c, r]`` — offset of the match END within the lane's own span
    (halo excluded). Unfilled slots hold 0.
    ``gcounts[G]`` — exact per-match-group event counts from every report
    (not from the capped slots); None unless asked for (``state_gid``)."""

    counts: torch.Tensor  # [C] int32
    slot_state: torch.Tensor  # [C, R] int32
    slot_pos: torch.Tensor  # [C, R] int32
    gcounts: torch.Tensor | None = None  # [G] int32 when requested

    @property
    def total(self) -> torch.Tensor:
        return self.counts.sum()


def dense_walk(table_flat, data_tm, bounds, *, alphabet_size: int,
               halo: int, max_results: int, max_pat_len: int,
               state_gid=None, num_groups: int = 0):
    """Walk every lane of the time-major batch ``data_tm [T, C]`` of uint8
    or uint16 symbols (the ushort alphabet; a symbol past the alphabet
    reads as ``A - 1``).

    ``table_flat``: ``[S*A]`` int16 or int32 signed table; ``bounds``:
    ``[2, C]`` int32 (start_t, end_t). Lane c starts in state 0 at t = 0;
    at each t in ``[start_t, end_t)`` it moves to ``|raw|``, ``raw =
    table[state*A + sym]``, and reports when ``raw < 0`` and ``t >= halo``.
    Returns ``(counts [C], slot_state [C, R], slot_pos [C, R], gcounts [G]
    or None)``, all int32; the first R reports fill the slots with
    ``(state, t - halo)``, and with ``state_gid`` every report adds one to
    ``gcounts[state_gid[state]]``. ``max_pat_len`` is the table's longest
    pattern (the kernel's warm-up; the plain version walks whole lanes).

    A CUDA tensor goes to the kernel of ``csrc/dfa_walk.cu`` (or raises),
    a CPU tensor to :func:`dense_walk_plain`."""
    kw = dict(alphabet_size=alphabet_size, halo=halo,
              max_results=max_results, max_pat_len=max_pat_len,
              state_gid=state_gid, num_groups=num_groups)
    if table_flat.is_cuda:
        from tpu_pattern_matching_torch.ops import kernels

        return kernels.launch_dense_walk(table_flat, data_tm, bounds, **kw)
    if table_flat.device.type != "cpu":
        raise ValueError(f"no dense walk for device {table_flat.device}")
    return dense_walk_plain(table_flat, data_tm, bounds, **kw)


def dense_walk_plain(table_flat, data_tm, bounds, *, alphabet_size: int,
                     halo: int, max_results: int, max_pat_len: int,
                     state_gid=None, num_groups: int = 0):
    """Plain PyTorch version of the dense-walk kernel: one vectorised step
    over all lanes per time step, each lane walked whole (``max_pat_len``
    is not needed). Same contract as :func:`dense_walk`; the CPU path, and
    what the kernel is held to on the card."""
    T, C = data_tm.shape
    R = max_results
    G = num_groups
    dev = data_tm.device
    start = bounds[0].to(torch.int64)
    end = bounds[1].to(torch.int64)
    lanes = torch.arange(C, device=dev)
    state = torch.zeros(C, dtype=torch.int64, device=dev)
    count = torch.zeros(C, dtype=torch.int64, device=dev)
    # slot stores land in a dump slot past the end when not taken
    sl_state = torch.zeros(C * R + 1, dtype=torch.int64, device=dev)
    sl_pos = torch.zeros(C * R + 1, dtype=torch.int64, device=dev)
    gc = torch.zeros(G + 1, dtype=torch.int64, device=dev)
    for t in range(T):
        sym = data_tm[t].to(torch.int64).clamp(max=alphabet_size - 1)
        raw = table_flat[state * alphabet_size + sym].to(torch.int64)
        valid = (t >= start) & (t < end)
        state = torch.where(valid, raw.abs(), state)
        rep = (raw < 0) & valid & (t >= halo)
        dst = torch.where(rep & (count < R), lanes * R + count, C * R)
        sl_state.scatter_(0, dst, state)
        sl_pos.scatter_(0, dst, torch.full_like(state, t - halo))
        count = count + rep.to(torch.int64)
        if state_gid is not None:
            gid = state_gid[state].to(torch.int64)
            gc.index_add_(0, torch.where(rep & (gid >= 0), gid, G),
                          rep.to(torch.int64))
    i32 = torch.int32
    return (count.to(i32), sl_state[: C * R].reshape(C, R).to(i32),
            sl_pos[: C * R].reshape(C, R).to(i32),
            None if state_gid is None else gc[:G].to(i32))


def scan_batch(table: DeviceTable, data, start_t, end_t, halo: int,
               max_results: int = 16) -> ScanResult:
    """Scan one batch of chunk lanes against the DFA.

    ``data[c]`` (lane-major ``[C, halo + B]`` uint8 or uint16) holds
    ``halo`` symbols of stream history followed by the lane's own chunk;
    ``end_t[c] = halo + size[c]``. The batch is transposed once to
    time-major, so a warp of the kernel reads 32 adjacent symbols per
    step."""
    counts, slot_state, slot_pos, _ = dense_walk(
        table.table_flat, data.t().contiguous(),
        torch.stack([start_t, end_t]).to(torch.int32),
        alphabet_size=table.alphabet_size, halo=halo,
        max_results=max_results, max_pat_len=table.max_pat_len,
    )
    return ScanResult(counts=counts, slot_state=slot_state,
                      slot_pos=slot_pos)
