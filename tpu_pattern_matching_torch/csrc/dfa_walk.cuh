// The signed-table DFA step and the per-thread bodies of both walk
// kernels (dfa_walk.cu). Every function but the launch plans and layouts
// is __host__ __device__:
// dfa_walk_host.cpp runs the same code on the CPU, so the tests can hold
// the kernels' arithmetic to the reference without a GPU.
//
// Table layout (core/dfa.py DfaTable.goto_signed, flattened):
// table[state * A + sym] is the next state, negated iff that state is
// final. It is int16 when the automaton has fewer than 2^15 states, int32
// otherwise; an entry is widened to int32 before its sign is dropped.
// Symbols are uint8 (A = 256) or uint16 (the ushort alphabet, A = 2048):
// both walks are templates on the table type TT and the symbol type Sym.
// The row offset state * A is 64-bit (a 2048-wide table of 2^20 states
// has 2^31 entries).
#pragma once

#include <stdint.h>

#ifndef TPM_HD
#ifdef __CUDACC__
#define TPM_HD __host__ __device__ __forceinline__
#else
#define TPM_HD inline
#endif
#endif
#ifndef TPM_UNROLL
#ifdef __CUDACC__
#define TPM_UNROLL _Pragma("unroll")
#else
#define TPM_UNROLL
#endif
#endif

namespace tpm {

constexpr int64_t kI32Max = 0x7FFFFFFF;
constexpr int kWalkBadArgs = -1;  // entry-point code for rejected arguments

// One step from `state` on `sym`: the state advances to |raw| only when
// `valid`; the raw entry is returned, and raw < 0 means a match ends at
// this symbol (the next state is final). A symbol past the alphabet reads
// as A - 1 (the ushort parser's clamp), so no read leaves the table.
template <typename TT>
TPM_HD int32_t dfa_step(const TT* table, int A, int32_t& state, int32_t sym,
                        bool valid) {
  if (sym >= A) sym = A - 1;
  const int32_t raw = (int32_t)table[(int64_t)state * A + sym];
  if (valid) state = raw < 0 ? -raw : raw;
  return raw;
}

TPM_HD void add_one(int32_t* counter) {
#ifdef __CUDA_ARCH__
  atomicAdd(counter, 1);
#else
  *counter += 1;
#endif
}

struct WindowParams {
  int C;     // lanes of the lane-major batch data [C, T]
  int T;     // symbols per lane
  int A;     // alphabet size (table row length)
  int q;     // gram length of the filter
  int lmax;  // longest pattern
  int halo;  // prefix halo of every lane
  int kw;    // candidate slots
  int WLp;   // steps per window: 2*lmax - q rounded up to a multiple of 4
  int k_ev;  // event capacity of the packed output
  int G;     // match groups (gcounts length)
};

// Stages 3-5 of the reference's device verify (ops/verify_device.py
// _verify_kernel): each candidate slot's window walk (stage 3), its
// reports compacted to (lane, end, state) events in slot order (stage 4)
// and the group counts of the events kept (stage 5), in two steps per
// slot that the kernel and the CPU harness share: window_count counts the
// slot's reports and keeps the first kKeep of them, an exclusive scan of
// the counts gives each slot its first event, and window_emit writes its
// events there, up to the capacity k_ev: the kept ones, or, for a slot
// of more reports, all of them from a second walk of its window.
//
// Slot i walks the window of the gram at `row` of `lane` from the root
// for WLp steps from w0 = row - (lmax - q); step t reads
// data[clip(lane*T + w0 + t)] and advances only inside the lane's span
// [start_t, end_t); it reports iff the entry is final and the end pos =
// w0 + t lies in [keep_lo, keep_hi): keep_lo = max(row + q - 1, halo),
// keep_hi = min(next candidate row of the same lane + q - 1, end_t).
// That interval gives every match end to exactly one candidate, and the
// intervals ascend with the slots, so slot order is (lane, end) order.
// Slots at i >= n_valid (the sentinels of the compaction) walk an empty
// span and report nothing. The state stays 0 before start_t and nothing
// is reported from keep_hi on, so a slot walks only steps [t0, t1).
struct WindowSlot {
  int64_t w0;       // data position of step 0
  int64_t base;     // flat index of step 0: lane * T + w0
  int64_t keep_lo;  // reports only at positions >= keep_lo
  int t0, t1;       // the steps that can advance the state and report
  int32_t lane;     // the slot's lane as compacted (the event's lane)
};

TPM_HD WindowSlot window_slot(const int32_t* bounds, const int32_t* lane,
                              const int32_t* row, int64_t n_valid,
                              const WindowParams& p, int i) {
  const bool cand_valid = i < n_valid;
  const int64_t r = row[i];
  const int lane_c = lane[i] < p.C - 1 ? lane[i] : p.C - 1;
  const int64_t st = cand_valid ? bounds[lane_c] : 0;
  const int64_t en = cand_valid ? bounds[p.C + lane_c] : 0;
  const int64_t rnext =
      (i + 1 < p.kw && lane[i + 1] == lane[i]) ? row[i + 1] : kI32Max;
  int64_t keep_hi = rnext >= kI32Max - p.q ? kI32Max : rnext + p.q - 1;
  if (en < keep_hi) keep_hi = en;
  WindowSlot s;
  s.w0 = r - (p.lmax - p.q);
  s.base = (int64_t)lane_c * p.T + s.w0;
  s.keep_lo = r + p.q - 1 > p.halo ? r + p.q - 1 : p.halo;
  s.lane = lane[i];
  const int64_t hi = keep_hi - s.w0, lo = st - s.w0;
  s.t1 = hi < 0 ? 0 : (hi > p.WLp ? p.WLp : (int)hi);
  s.t0 = lo < 0 ? 0 : (lo > s.t1 ? s.t1 : (int)lo);
  return s;
}

// A slot's report count and its first kKeep reports (step, state): most
// slots of a refined batch report once or twice, so their events need no
// second walk. Indexed only by constants, so they stay in registers.
constexpr int kKeep = 4;

struct WindowReports {
  int32_t n;
  int32_t t[kKeep];
  int32_t state[kKeep];
};

template <typename TT, typename Sym>
TPM_HD WindowReports window_count(const TT* table, const Sym* data,
                                  const WindowSlot& s,
                                  const WindowParams& p) {
  const int64_t last = (int64_t)p.C * p.T - 1;
  WindowReports r;
  r.n = 0;
  TPM_UNROLL
  for (int k = 0; k < kKeep; ++k) r.t[k] = r.state[k] = 0;
  int32_t state = 0;
  for (int t = s.t0; t < s.t1; ++t) {
    int64_t idx = s.base + t;
    idx = idx < 0 ? 0 : (idx > last ? last : idx);
    const int32_t raw = dfa_step(table, p.A, state, (int32_t)data[idx], true);
    if (raw < 0 && s.w0 + t >= s.keep_lo) {
      TPM_UNROLL
      for (int k = 0; k < kKeep; ++k)
        if (k == r.n) {
          r.t[k] = t;
          r.state[k] = state;
        }
      ++r.n;
    }
  }
  return r;
}

// Event e of packed [3, k_ev] (lane, end, state), and its group count.
TPM_HD void emit_event(const int32_t* state_gid, const WindowSlot& s,
                       const WindowParams& p, int64_t e, int t,
                       int32_t state, int32_t* packed, int32_t* gcounts) {
  packed[e] = s.lane;
  packed[p.k_ev + e] = (int32_t)(s.w0 + t);  // in [halo, end_t)
  packed[2 * (int64_t)p.k_ev + e] = state;
  const int32_t gid = state_gid[state];
  if (gid >= 0 && gid < p.G) add_one(gcounts + gid);
}

// Writes the slot's events at `first`, first + 1, ... below k_ev, each
// adding one to gcounts[state_gid[state]] when that group is >= 0: the
// kept reports, or (more than kKeep) all, from a second walk.
template <typename TT, typename Sym>
TPM_HD void window_emit(const TT* table, const Sym* data,
                        const int32_t* state_gid, const WindowSlot& s,
                        const WindowReports& r, const WindowParams& p,
                        int64_t first, int32_t* packed, int32_t* gcounts) {
  if (r.n <= kKeep) {
    TPM_UNROLL
    for (int k = 0; k < kKeep; ++k)
      if (k < r.n && first + k < p.k_ev)
        emit_event(state_gid, s, p, first + k, r.t[k], r.state[k], packed,
                   gcounts);
    return;
  }
  const int64_t last = (int64_t)p.C * p.T - 1;
  int64_t e = first;
  int32_t state = 0;
  for (int t = s.t0; t < s.t1 && e < p.k_ev; ++t) {
    int64_t idx = s.base + t;
    idx = idx < 0 ? 0 : (idx > last ? last : idx);
    const int32_t raw = dfa_step(table, p.A, state, (int32_t)data[idx], true);
    if (raw < 0 && s.w0 + t >= s.keep_lo)
      emit_event(state_gid, s, p, e++, t, state, packed, gcounts);
  }
}

// meta = [n_events, reported, n_cand, flags, n_exact]: n_events exact (as
// int32), reported = min(n_events, k_ev), the counts clipped to int32,
// flags = base_flags | bit 1 when the events overflowed k_ev.
TPM_HD void window_meta(int64_t n_events, int64_t n_cand, int64_t n_exact,
                        int32_t base_flags, const WindowParams& p,
                        int32_t* meta) {
  meta[0] = (int32_t)n_events;
  meta[1] = (int32_t)(n_events < p.k_ev ? n_events : p.k_ev);
  meta[2] = (int32_t)(n_cand < kI32Max ? n_cand : kI32Max);
  meta[3] = base_flags | ((n_events > p.k_ev ? 1 : 0) << 1);
  meta[4] = (int32_t)(n_exact < kI32Max ? n_exact : kI32Max);
}

// One int32 buffer holds the outputs and the scratch of a launch, so that
// two fills prepare it: packed [3, k_ev] (rows 0-1 filled with -1, row 2
// with 0), gcounts [G], meta [5], then (8-byte aligned) the blocks'
// ticket counter and a pad word, and one 64-bit look-back word per block
// of kEmitBlock slots, all zeroed. Offsets in int32 words.
constexpr int kEmitBlock = 128;  // slots per block of the walk-and-emit kernel

struct EmitLayout {
  int64_t gcounts, meta, counters, look, total;
  int blocks;
};

inline EmitLayout emit_layout(const WindowParams& p) {
  EmitLayout l;
  l.blocks = p.kw > 0 ? (p.kw + kEmitBlock - 1) / kEmitBlock : 1;
  l.gcounts = 3 * (int64_t)p.k_ev;
  l.meta = l.gcounts + p.G;
  l.counters = (l.meta + 5 + 1) & ~(int64_t)1;
  l.look = l.counters + 2;
  l.total = l.look + 2 * (int64_t)l.blocks;
  return l;
}

// The layout as the entry points tpm_emit_layout[_host] give it to the
// caller, which splits its one buffer by these offsets: out = [gcounts,
// meta, total, blocks, kEmitBlock].
inline int emit_layout_out(int kw, int k_ev, int G, long long* out) {
  if (kw < 0 || k_ev < 0 || G < 0) return kWalkBadArgs;
  WindowParams p{};
  p.kw = kw;
  p.k_ev = k_ev;
  p.G = G;
  const EmitLayout l = emit_layout(p);
  out[0] = l.gcounts;
  out[1] = l.meta;
  out[2] = l.total;
  out[3] = l.blocks;
  out[4] = kEmitBlock;
  return 0;
}

struct DenseParams {
  int T;     // time rows of data_tm [T, C]
  int C;     // lanes
  int A;     // alphabet size
  int halo;  // reports only at t >= halo
  int R;     // result slots per lane
  int G;     // match groups (gcounts length)
  int warm;  // warm-up rows of a sub-span: max_pat_len - 1
  int S;     // sub-spans per lane
};

// The reference's dense lane walk (ops/match_xla.py _scan_kernel), lane c
// of the time-major batch: state 0 at t = 0, advancing only inside
// [start_t, end_t). A report is a final entry at t >= halo: counts[c]
// counts them all, the first R fill slot_state/slot_pos[c, :] with
// (state, t - halo) in time order, and, when state_gid is given, every
// report adds one to gcounts[state_gid[state]].
//
// The lane is cut into S sub-spans. An Aho-Corasick state is the longest
// suffix of the input read so far that is a prefix of a pattern, so its
// depth is at most max_pat_len: a walk from the root that starts
// warm = max_pat_len - 1 rows before a row p is in the lane walk's state
// from p on (the argument of the lanes' halo, MATCHING.md). Sub-span j
// reports on the rows [halo + j*P, halo + (j+1)*P) of the batch, P =
// dense_piece(p), inside the lane's span; it walks from the root from
// `warm` rows before its first such row, clipped at start_t (where the
// lane walk starts from the root too). Its first R reports are kept in
// `keep` (keep_index); dense_merge_piece then moves the ones among the
// lane's first R to their slots.

TPM_HD int dense_piece(const DenseParams& p) {
  const int span = p.T > p.halo ? p.T - p.halo : 0;
  return (int)(((int64_t)span + p.S - 1) / p.S);
}

// keep holds S * R * C (state, position) pairs: states first, then
// positions; entry m of sub-span j of lane c at [(j * R + m) * C + c].
TPM_HD int64_t keep_index(const DenseParams& p, int c, int j, int m) {
  return ((int64_t)j * p.R + m) * p.C + c;
}

// Walks sub-span j of lane c; returns its reports.
template <typename TT, typename Sym>
TPM_HD int32_t dense_walk_piece(const TT* table, const Sym* data_tm,
                                const int32_t* bounds,
                                const int32_t* state_gid,
                                const DenseParams& p, int c, int j,
                                int32_t* keep, int32_t* gcounts) {
  const int start = bounds[c] > 0 ? bounds[c] : 0;
  const int end = bounds[p.C + c] < p.T ? bounds[p.C + c] : p.T;
  const int64_t piece = dense_piece(p);
  const int64_t lo64 = p.halo + j * piece;
  const int lo = lo64 < start ? start : (int)(lo64 < p.T ? lo64 : p.T);
  const int hi = lo64 + piece < end ? (int)(lo64 + piece) : end;
  if (lo >= hi) return 0;
  int t = lo - p.warm > start ? lo - p.warm : start;
  const int64_t pos_base = (int64_t)p.S * p.R * p.C;
  int32_t state = 0;
  int32_t n = 0;
  // the next row's symbol is loaded before this row's table entry, so its
  // latency is off the chain of dependent table loads
  int32_t next = data_tm[(int64_t)t * p.C + c];
  for (; t < hi; ++t) {
    const int32_t sym = next;
    if (t + 1 < hi) next = data_tm[(int64_t)(t + 1) * p.C + c];
    const int32_t raw = dfa_step(table, p.A, state, sym, true);
    if (raw < 0 && t >= lo) {
      if (n < p.R) {
        keep[keep_index(p, c, j, n)] = state;
        keep[pos_base + keep_index(p, c, j, n)] = t - p.halo;
      }
      ++n;
      if (gcounts) {
        const int32_t gid = state_gid[state];
        if (gid >= 0 && gid < p.G) add_one(gcounts + gid);
      }
    }
  }
  return n;
}

// Sub-span j of lane c, with n reports and `prefix` reports in the lane's
// sub-spans before it: its reports that are among the lane's first R go
// to slots prefix, prefix + 1, ...
TPM_HD void dense_merge_piece(const DenseParams& p, int c, int j,
                              int32_t prefix, int32_t n, const int32_t* keep,
                              int32_t* slot_state, int32_t* slot_pos) {
  const int64_t pos_base = (int64_t)p.S * p.R * p.C;
  for (int32_t m = 0; m < n && prefix + m < p.R; ++m) {
    slot_state[(int64_t)c * p.R + prefix + m] = keep[keep_index(p, c, j, m)];
    slot_pos[(int64_t)c * p.R + prefix + m] =
        keep[pos_base + keep_index(p, c, j, m)];
  }
}

// The launch of the dense walk: a block is 32 adjacent lanes x S sub-spans,
// warp j taking sub-span j of its 32 lanes (a step of a warp reads 32
// adjacent symbols of one row), so a lane's merge is a scan over the
// block's warps in shared memory.
constexpr int kMaxSubspans = 32;  // warps of a block of 1024 threads
constexpr int kWarpsPerSM = 32;   // the warps per SM the plan aims for

struct DensePlan {
  int S;        // sub-spans per lane
  int steps;    // the most steps of a thread: its piece and the warm-up
  int threads;  // threads per block: 32 * S
  int blocks;   // ceil(C / 32)
};

// S, a power of two: the fewest sub-spans that put kWarpsPerSM warps on
// each of n_sm SMs, at most kMaxSubspans, and no more than keep the
// warm-up within a quarter of a piece. A lane shorter than its S pieces
// has empty ones.
inline DensePlan dense_plan(int T, int C, int halo, int warm, int n_sm) {
  const int64_t span = T > halo ? T - halo : 0;
  const int64_t lane_warps = (C + 31) / 32;
  int S = 1;
  while (S < kMaxSubspans && lane_warps * S < (int64_t)kWarpsPerSM * n_sm) {
    const int64_t piece = (span + 2 * S - 1) / (2 * S);
    if (4 * (int64_t)warm > piece) break;
    S *= 2;
  }
  DensePlan d;
  d.S = S;
  d.steps = (int)((span + S - 1) / S) + warm;
  d.threads = 32 * S;
  d.blocks = (int)lane_warps;
  return d;
}

inline bool window_params_ok(const WindowParams& p) {
  return p.C > 0 && p.T > 0 && p.A > 0 && p.q >= 1 && p.lmax >= p.q &&
         p.halo >= 0 && p.kw >= 0 && p.WLp >= 2 * p.lmax - p.q &&
         p.WLp % 4 == 0 && (int64_t)p.kw * p.WLp < ((int64_t)1 << 40) &&
         p.k_ev >= 0 && p.G >= 0;
}

inline bool dense_params_ok(const DenseParams& p) {
  return p.T >= 0 && p.C > 0 && p.A > 0 && p.halo >= 0 && p.R >= 0 &&
         p.G >= 0 && p.warm >= 0 && p.S >= 1 &&
         (int64_t)p.S * p.R * p.C < ((int64_t)1 << 40);
}

}  // namespace tpm
