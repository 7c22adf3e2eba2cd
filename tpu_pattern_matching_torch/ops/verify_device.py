"""Candidate compaction for the device refinement (torch port of the
reference's ``ops/verify_device.py``: ``next_cap``, ``MAX_DEVICE_CAND`` and
``bitmap_to_candidates``; the device verify walk is not ported yet).

The reference compacts with ``lax.top_k`` because a scatter is serialized
on XLA:TPU; on the GPU a cumsum plus one scatter into a fixed capacity is
the natural form. Shapes are fixed by the capacity, so nothing syncs with
the host.
"""

from __future__ import annotations

import torch

INT32_MAX = 0x7FFFFFFF

MAX_DEVICE_CAND = 1 << 17  # past this, host verify is the better tool


def next_cap(n: int, lo: int = 256) -> int:
    """Smallest capacity >= n on the {1, 1.5} x 2^k ladder."""
    k = lo
    while k < n:
        k15 = k + (k >> 1)
        if k15 >= n:
            return k15
        k *= 2
    return k


def _compact(flags, values, capacity: int):
    """Stream compaction: the set positions of ``flags`` [N] keep their
    order; each ``(array [N], fill)`` of ``values`` is gathered into
    ``capacity`` slots, unfilled slots hold ``fill``. Overflow keeps the
    first ``capacity`` set positions. Returns ``(n_set, outs, n_set >
    capacity)`` with ``n_set`` a 0-dim tensor."""
    N = flags.shape[0]
    dev = flags.device
    pos = torch.cumsum(flags, 0, dtype=torch.int64) - 1
    n = pos[-1] + 1
    # positions that are not kept land in a dump region past the
    # capacity, spread over 1024 slots so their stores do not pile onto
    # one address
    dump = capacity + (torch.arange(N, device=dev) & 1023)
    dest = torch.where(flags & (pos < capacity), pos, dump)
    outs = []
    for v, fill in values:
        o = torch.full((capacity + 1024,), fill, dtype=v.dtype, device=dev)
        o.scatter_(0, dest, v)
        outs.append(o[:capacity])
    return n, outs, n > capacity


def bitmap_to_candidates(bits, stride: int, k_cand: int):
    """Survivor bitmap ``[W, Cb]`` -> compacted candidates sorted by
    (lane, row).

    Two stages: nonzero WORDS compact first (each holds >= 1 candidate,
    so ``k_cand`` bounds the word count too), then their bits expand and
    compact. Returns ``(n_cand, lane [k_cand] int32, row [k_cand] int32,
    overflowed)``; sentinel slots hold ``(Cb, INT32_MAX)``, and on
    overflow the first ``k_cand`` candidates are kept.

    ``overflowed`` is also set when the WORDS overflow. The reference
    flags only the bit stage, so when more than ``k_cand`` nonzero words
    each hold one bit its count stops at exactly ``k_cand``, no overflow
    is flagged, and the refined bitmap drops the candidates of the words
    past the capacity. Here that batch passes through unrefined."""
    W, Cb = bits.shape
    dev = bits.device
    words_t = bits.t().reshape(-1)  # [Cb*W]: lane-major, so rows sort by lane
    _n_words, (widx, wval), word_over = _compact(
        words_t != 0,
        [(torch.arange(Cb * W, device=dev), Cb * W), (words_t, 0)],
        k_cand,
    )
    bit_iota = torch.arange(32, device=dev)
    has_bit = ((wval[:, None] >> bit_iota) & 1) != 0  # sentinels: wval 0
    lane_w = widx // W  # sentinel words -> lane Cb
    row_w = (widx % W) * 32
    rows32 = (row_w[:, None] + bit_iota) * stride
    lanes32 = lane_w[:, None].expand(k_cand, 32)
    n_cand, (lane, row), cand_over = _compact(
        has_bit.reshape(-1),
        [(lanes32.reshape(-1), Cb), (rows32.reshape(-1), INT32_MAX)],
        k_cand,
    )
    return (n_cand, lane.to(torch.int32), row.to(torch.int32),
            word_over | cand_over)
