"""Device-side exact verify for the bloom engine (torch port of the
reference's ``ops/verify_device.py``).

Candidates of the probe's survivor bitmap are verified on the device and
come back as exact ``(lane, end_row, state)`` events plus per-group
counts, with no host CPU in the loop. One dispatch (``verify_candidates``)
runs the reference's ``_verify_kernel`` stage by stage:

1-2. ``bitmap_to_candidates``: nonzero words, then their bits, compact to
     ``(lane, row)`` candidates sorted by (lane, row);
2.5. exact-gram refinement (``ops/exact_gram.exact_member``) erases the
     bloom false positives and compacts the rest to ``k_walk`` slots;
3-5. ``walk_and_emit``: each candidate's window ``[row-(lmax-q),
     row+lmax)`` is walked from the root with the signed dense table; match
     end ``e`` is reported by the candidate ``i`` with ``r_i + q - 1 <= e <
     r_next + q - 1`` (the next candidate of the same lane), so each match
     end has exactly one owner; the reports compact to events in
     (candidate, t) = (lane, end) order, and ``gcounts`` counts the events
     kept. For a CUDA tensor this is one kernel of ``csrc/dfa_walk.cu``
     (each slot counts its reports, a chained scan gives it its first
     event, it walks again and writes them); for a CPU tensor a plain
     PyTorch loop over the window's steps, then a compaction.

``DeviceVerifier`` holds the table on the device and buckets the
capacities from the probe's exact total, retrying the refined-candidate
and event capacities on the exact counts the pipeline reports. A batch of
more than ``MAX_DEVICE_CAND`` candidates is verified in several passes,
each over a range of whole lanes, so every batch stays on the device. On
a data-parallel mesh (``mesh=``, ``parallel/mesh.py``) each rank verifies
its own lanes, and every dispatch's counts and flags are reduced over the
ranks before the retry ladder reads them, so every rank retries together.

The reference compacts with ``lax.top_k`` because a scatter is serialized
on XLA:TPU; on the GPU a cumsum plus one scatter into a fixed capacity is
the natural form of stages 1-2.5, and stages 3-5 are one kernel. Shapes
are fixed by the capacities, so no stage syncs with the host. Not ported: ``prefetch_windows`` (a workaround for the
XLA:TPU gather cost) and the ``stages`` bench hook.
"""

from __future__ import annotations

import numpy as np
import torch

INT32_MAX = 0x7FFFFFFF

MAX_DEVICE_CAND = 1 << 17  # candidates of one verify pass


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


# ------------------------------------------------------------ device verify


def walk_steps(lmax: int, q: int) -> int:
    """Steps of every candidate window: ``2*lmax - q`` rounded up to a
    multiple of 4 (the reference's unroll; the extra steps walk past the
    window and report nothing it would not)."""
    return -(-(2 * lmax - q) // 4) * 4


def walk_and_emit(table_flat, state_gid, data_flat, bounds, lane, row,
                  n_exact, n_cand, base_flags, *, C: int, T: int,
                  alphabet_size: int, q: int, lmax: int, halo: int,
                  k_ev: int, num_groups: int):
    """Stages 3-5: walk every candidate slot's window from the root, keep
    its reports as ``(lane, end, state)`` events in slot order, and count
    the kept events per group.

    ``table_flat``: ``[S*A]`` int16 or int32 signed table; ``state_gid``:
    ``[S]`` int32 group of each state (-1: none); ``data_flat``: the
    lane-major batch ``[C*T]`` uint8 or uint16 (symbols past the alphabet
    read as ``A - 1``); ``bounds``: ``[2, C]`` int32; ``lane``/``row``:
    ``[kw]`` int32 candidates sorted by (lane, row), the slots at or past
    ``n_exact`` (one int64) being sentinels; ``n_cand`` (one int64) and
    ``base_flags`` (one int32) go into meta. Slot i walks
    ``walk_steps(lmax, q)`` steps from ``w0 = row - (lmax - q)``, reading
    ``data_flat[clip(lane*T + w0 + t)]``; the state advances only inside
    the lane's ``[start_t, end_t)``, and step t reports iff its entry is
    final and ``w0 + t`` lies in ``[max(row + q - 1, halo), min(r_next +
    q - 1, end_t))``, ``r_next`` being the next slot's row when it has the
    same lane. Returns ``(meta [5], packed [3, k_ev], gcounts [G])`` int32
    as :func:`verify_candidates` does: events in (slot, t) = (lane, end)
    order, the first ``k_ev`` kept, fill (-1, -1, 0); ``n_events`` exact
    past ``k_ev`` (flag bit 1); gcounts over the kept events whose group
    is >= 0.

    A CUDA tensor goes to the kernel of ``csrc/dfa_walk.cu`` (or raises),
    a CPU tensor to :func:`walk_and_emit_plain`."""
    kw = dict(C=C, T=T, alphabet_size=alphabet_size, q=q, lmax=lmax,
              halo=halo, k_ev=k_ev, num_groups=num_groups,
              steps=walk_steps(lmax, q))
    args = (table_flat, state_gid, data_flat, bounds, lane, row,
            n_exact.reshape(1), n_cand.reshape(1), base_flags.reshape(1))
    if table_flat.is_cuda:
        from tpu_pattern_matching_torch.ops import kernels

        return kernels.launch_walk_and_emit(*args, **kw)
    if table_flat.device.type != "cpu":
        raise ValueError(f"no walk and emit for device {table_flat.device}")
    return walk_and_emit_plain(*args, **kw)


def walk_and_emit_plain(table_flat, state_gid, data_flat, bounds, lane, row,
                        n_exact, n_cand, base_flags, *, C: int, T: int,
                        alphabet_size: int, q: int, lmax: int, halo: int,
                        k_ev: int, num_groups: int, steps: int):
    """Plain PyTorch version of the walk-and-emit kernel: the window walk
    as one vectorised step over all slots per window step, in int64 (no
    wraparound), into report flags and states ``[kw, steps]``, then their
    compaction and the group counts. Same contract as
    :func:`walk_and_emit`; the CPU path, and what the kernel is held to on
    the card."""
    from .exact_gram import gather_symbols

    kw = lane.shape[0]
    G = num_groups
    dev = lane.device
    n_valid = n_exact.reshape(())
    cand_valid = torch.arange(kw, device=dev) < n_valid
    lane64 = lane.to(torch.int64)
    r = row.to(torch.int64)
    lane_c = lane64.clamp(max=C - 1)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    st = torch.where(cand_valid, bounds[0].to(torch.int64)[lane_c], zero)
    en = torch.where(cand_valid, bounds[1].to(torch.int64)[lane_c], zero)
    w0 = r - (lmax - q)
    base = lane_c * T + w0
    keep_lo = (r + q - 1).clamp(min=halo)
    big = torch.full((1,), INT32_MAX, dtype=torch.int64, device=dev)
    rnext = torch.cat([torch.where(lane64[1:] == lane64[:-1], r[1:], big),
                       big])
    keep_hi = torch.minimum(
        torch.where(rnext >= INT32_MAX - q, big, rnext + q - 1), en)
    state = torch.zeros(kw, dtype=torch.int64, device=dev)
    reps, states = [], []
    for t in range(steps):
        pos = w0 + t
        sym = gather_symbols(data_flat, (base + t).clamp(0, C * T - 1))
        sym = sym.clamp(max=alphabet_size - 1)
        raw = table_flat[state * alphabet_size + sym].to(torch.int64)
        valid = (pos >= st) & (pos < en)
        state = torch.where(valid, raw.abs(), state)
        reps.append((raw < 0) & valid & (pos >= keep_lo) & (pos < keep_hi))
        states.append(state)
    rep = torch.stack(reps, 1)
    st_all = torch.stack(states, 1).to(torch.int32)
    # events in (candidate, t) order, which is (lane, end) order: the keep
    # intervals are disjoint and ascend
    t_of = torch.arange(steps, dtype=torch.int64, device=dev)
    e_cm = w0[:, None] + t_of[None, :]
    n_ev, (ev_lane, ev_end, ev_state), ev_over = _compact(
        rep.reshape(-1),
        [(lane[:, None].expand(kw, steps).reshape(-1), -1),
         (e_cm.reshape(-1).clamp(-1, INT32_MAX).to(torch.int32), -1),
         (st_all.reshape(-1), 0)],
        k_ev,
    )
    # per-group counts from the compacted events
    reported = n_ev.clamp(max=k_ev)
    live = torch.arange(k_ev, device=dev) < reported
    gid = state_gid[ev_state.to(torch.int64).clamp(0, state_gid.shape[0] - 1)]
    gidx = torch.where(live & (gid >= 0), gid.to(torch.int64), G)
    gcounts = torch.zeros(G + 1, dtype=torch.int32, device=dev).index_add_(
        0, gidx, live.to(torch.int32))[:G]
    flags = base_flags.reshape(()) | (ev_over.to(torch.int32) << 1)
    meta = torch.stack([
        n_ev, reported, n_cand.reshape(()).clamp(max=INT32_MAX),
        flags.to(torch.int64), n_valid.clamp(max=INT32_MAX),
    ]).to(torch.int32)
    return meta, torch.stack([ev_lane, ev_end, ev_state]), gcounts


def verify_candidates(table_flat, state_gid, data, bounds, bits, dx=None, *,
                      alphabet_size: int, stride: int, q: int, lmax: int,
                      halo: int, k_cand: int, k_ev: int, num_groups: int,
                      k_walk: int | None = None):
    """The reference's ``_verify_kernel`` (stages 1-5) on one batch.

    ``data [C, T]`` (uint8, or uint16 for the ushort alphabet) and
    ``bounds [2, C]`` are the batch the probe
    scanned, ``bits [W, Cb]`` its survivor bitmap; ``dx`` the exact-gram
    table (``ops/exact_gram.DeviceExact``) or None for no refinement.
    Returns device tensors ``(meta [5], packed [3, k_ev], gcounts [G])``:
    ``meta = [n_events, reported, n_cand, flags, n_exact]`` with flags bit
    0 = candidate overflow, bit 1 = event overflow (``n_events`` stays
    exact), bit 2 = refined-candidate (``k_walk``) overflow (``n_exact``
    stays exact); ``packed`` = (lane, end_row, state) in (lane, end_row)
    order, fill (-1, -1, 0)."""
    C, T = data.shape
    Cb = bits.shape[1]
    dev = bits.device
    # ---- stages 1+2: bitmap -> compacted (lane, row) candidates
    n_cand, lane, row, cand_over = bitmap_to_candidates(bits, stride, k_cand)
    data_flat = data.reshape(-1)
    # ---- stage 2.5: exact-gram refinement (erase bloom false positives)
    if dx is not None:
        from .exact_gram import exact_member

        slotv = torch.arange(k_cand, device=dev) < n_cand
        base = (lane.to(torch.int64).clamp(max=C - 1) * T
                + row.to(torch.int64).clamp(max=T - 1))
        keep = exact_member(dx, data_flat, base, slotv)
        kw = k_walk if k_walk is not None else k_cand
        n_exact, (lane, row), refine_over = _compact(
            keep, [(lane, Cb), (row, INT32_MAX)], kw)
    else:
        n_exact = n_cand
        refine_over = torch.zeros((), dtype=torch.bool, device=dev)
    base_flags = (cand_over.to(torch.int32)
                  | (refine_over.to(torch.int32) << 2))
    # ---- stages 3-5: windowed walk, event compaction, group counts (one
    # kernel on the card)
    return walk_and_emit(table_flat, state_gid, data_flat, bounds, lane, row,
                         n_exact, n_cand, base_flags, C=C, T=T,
                         alphabet_size=alphabet_size, q=q, lmax=lmax,
                         halo=halo, k_ev=k_ev, num_groups=num_groups)


def lane_passes(bits, cap: int) -> list[tuple[int, int, int]]:
    """Split the bitmap ``[W, Cb]`` into ranges of whole lanes holding at
    most ``cap`` candidates each: ``[(l0, l1, n_cand)]``, empty ranges
    left out. Candidates attribute match ends only within their lane, so
    every range verifies exactly as the whole batch would. Raises when a
    single lane holds more than ``cap`` candidates. One host sync."""
    bit_iota = torch.arange(32, dtype=torch.int32, device=bits.device)
    per_lane = ((bits[:, :, None] >> bit_iota) & 1).sum((0, 2))
    cum = np.concatenate([[0], np.cumsum(per_lane.cpu().numpy())])
    out, l0 = [], 0
    while l0 < len(per_lane):
        l1 = int(np.searchsorted(cum, cum[l0] + cap, side="right")) - 1
        if l1 <= l0:
            raise RuntimeError(
                f"lane {l0} alone holds {int(cum[l0 + 1] - cum[l0])} "
                f"candidates, over the device-verify cap {cap}")
        if cum[l1] > cum[l0]:
            out.append((l0, l1, int(cum[l1] - cum[l0])))
        l0 = l1
    return out


def exact_table(gram_keys, cfg, table, device):
    """The exact-gram table of ``gram_keys`` (``ops/exact_gram``) on
    ``device``, or None (no refinement) when there are none."""
    if gram_keys is None or not len(gram_keys):
        return None
    from .exact_gram import DeviceExact, table_from_keys

    xt = table_from_keys(gram_keys, cfg.q,
                         bits=(table.alphabet_size - 1).bit_length())
    return DeviceExact.put(xt, cfg.fold_case, device)


class DeviceVerifier:
    """Session-side wrapper: ships the dense table once, buckets capacities.

    ``verify(data, bounds, bits, total)`` dispatches with the next bucketed
    candidate capacity >= the probe's exact survivor total (so candidate
    overflow cannot happen), and retries the refined-candidate and event
    capacities on the exact counts reported back. The int16 table stays
    int16 on the device.

    ``mesh`` (a ``parallel.mesh.MeshContext``) verifies this rank's lanes
    of a data-parallel mesh: every rank calls ``verify`` together with
    the same ``total``, the probe's largest per-rank total, and each
    dispatch is reduced (``_reduce``: ``parallel.mesh.reduce_verify``)
    before any retry decision; lane passes reduce once, after them
    (``_reduce_counts``). The grid's verifier
    (``parallel.pshard.PshardDeviceVerifier``) overrides the two."""

    def __init__(self, table, cfg, halo: int, device, gram_keys=None,
                 mesh=None):
        self.table_flat = torch.from_numpy(
            np.ascontiguousarray(table.goto_signed).reshape(-1)).to(device)
        self.state_gid = torch.from_numpy(
            table.state_gid.astype(np.int32)).to(device)
        self.alphabet_size = table.alphabet_size
        self.lmax = table.max_pat_len
        self.num_groups = table.num_groups
        self.stride = cfg.stride
        self.q = cfg.q
        self.halo = halo
        self.mesh = mesh
        # exact-gram refinement: the filter's inserted gram set erases the
        # bloom false positives before the walk; None runs unrefined
        self.exact = exact_table(gram_keys, cfg, table, device)
        self._k_walk = 256  # sticky refined-capacity bucket

    def _dispatch(self, data, bounds, bits, k_cand: int, k_ev: int,
                  k_walk: int):
        """One pipeline run; ``meta`` comes back to the host (the one
        sync of the dispatch), the rest stays on the device. ``meta =
        [n_events, reported, n_cand, flags, n_exact, event need]``, the
        need being the events of the rank that had the most. On a mesh
        ``n_events`` and ``gcounts`` are summed over the ranks, ``n_cand`` and ``n_exact`` are the largest per rank and
        ``flags`` their OR (``_reduce``); ``reported`` and ``packed`` stay
        this rank's."""
        meta, packed, gcounts = verify_candidates(
            self.table_flat, self.state_gid, data, bounds, bits, self.exact,
            alphabet_size=self.alphabet_size, stride=self.stride, q=self.q,
            lmax=self.lmax, halo=self.halo, k_cand=k_cand, k_ev=k_ev,
            num_groups=self.num_groups, k_walk=k_walk,
        )
        if self.mesh is not None:
            meta, gcounts = self._reduce(meta, gcounts)
        else:
            meta = torch.cat([meta, meta[:1]])
        return meta.cpu().numpy(), packed, gcounts

    def _reduce(self, meta, gcounts):
        """A dispatch's reductions over the mesh (``reduce_verify``)."""
        from tpu_pattern_matching_torch.parallel.mesh import reduce_verify

        return reduce_verify(self.mesh, meta, gcounts)

    def _reduce_counts(self, n_events: int, gcounts):
        """Sum the event total and the counts of a rank's lane passes over
        the mesh (one ``all_reduce``)."""
        from tpu_pattern_matching_torch.parallel.mesh import (
            allreduce_host_counts,
        )

        sums = allreduce_host_counts(
            np.concatenate([[n_events], gcounts]).astype(np.int64),
            self.mesh)
        return sums[0], sums[1:]

    def verify(self, data, bounds, bits, total: int):
        """(meta, packed[:, :reported], gcounts) as host arrays. Past
        ``MAX_DEVICE_CAND`` candidates the batch is verified in passes
        over ranges of whole lanes (``lane_passes``) and their results
        are joined: the same arrays as one pass. Raises RuntimeError if a
        bucketed candidate capacity still overflowed."""
        if total <= MAX_DEVICE_CAND:
            return self._verify_pass(data, bounds, bits, total)
        # a rank's passes are its own (their number differs between
        # ranks), so no collective runs inside one: the event total and
        # the counts are reduced once, after them
        mesh, self.mesh = self.mesh, None
        try:
            meta, packed, gc = self._lane_passes(data, bounds, bits)
        finally:
            self.mesh = mesh
        if mesh is not None:
            meta[0], gc_sum = self._reduce_counts(int(meta[0]), gc)
            gc = gc_sum.astype(gc.dtype)
        return meta, packed, gc

    def _lane_passes(self, data, bounds, bits):
        """``verify`` of this rank's batch in passes of whole lanes."""
        C = data.shape[0]
        passes = lane_passes(bits, MAX_DEVICE_CAND)
        if not passes:  # no candidate here (a mesh rank's lanes may hold
            # none while another rank's pass the cap)
            return (np.zeros(6, np.int32), np.zeros((3, 0), np.int32),
                    np.zeros(self.num_groups, np.int32))
        metas, packs, gcs = [], [], []
        for l0, l1, n in passes:
            meta, packed, gc = self._verify_pass(
                data[l0:min(l1, C)], bounds[:, l0:min(l1, C)].contiguous(),
                bits[:, l0:l1], n)
            packed[0] += l0  # lanes of the pass -> lanes of the batch
            metas.append(meta)
            packs.append(packed)
            gcs.append(gc)
        meta = np.sum(metas, axis=0, dtype=np.int64)
        meta[3] = np.bitwise_or.reduce([m[3] for m in metas])
        return (meta.astype(np.int32), np.concatenate(packs, axis=1),
                np.sum(gcs, axis=0, dtype=gcs[0].dtype))

    def _verify_pass(self, data, bounds, bits, total: int):
        """One pass of at most ``MAX_DEVICE_CAND`` candidates, with the
        refine and event retries."""
        k_cand = next_cap(total)
        if self.exact is None:
            k_walk = k_ev = k_cand
        else:
            k_walk = k_ev = min(k_cand, self._k_walk)
        meta, packed, gc = self._dispatch(data, bounds, bits, k_cand, k_ev,
                                          k_walk)
        if meta[3] & 4:  # refine overflow: retry with the exact need
            k_walk = k_ev = min(k_cand, next_cap(int(meta[4])))
            meta, packed, gc = self._dispatch(data, bounds, bits, k_cand,
                                              k_ev, k_walk)
        if meta[3] & 2:  # event overflow: retry with the exact need
            k_ev = next_cap(int(meta[5]))
            meta, packed, gc = self._dispatch(data, bounds, bits, k_cand,
                                              k_ev, k_walk)
        if self.exact is not None:
            # adapt the sticky refined bucket to what this batch needed
            self._k_walk = next_cap(int(meta[4]))
        if meta[3] & 1:
            raise RuntimeError(
                "device verify candidate overflow with a bucketed "
                "capacity: probe total and bitmap disagree")
        reported = int(meta[1])
        return meta, packed[:, :reported].cpu().numpy(), gc.cpu().numpy()
