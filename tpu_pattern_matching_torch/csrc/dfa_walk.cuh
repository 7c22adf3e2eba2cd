// The signed-table DFA step and the per-thread bodies of both walk
// kernels (dfa_walk.cu). Every function is __host__ __device__:
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
};

// Stage 3 of the reference's device verify (ops/verify_device.py
// _verify_kernel) for candidate slot i: the window of the gram at `row`
// of `lane` is walked from the root for exactly WLp steps, starting at
// w0 = row - (lmax - q). Step t reads data[clip(lane*T + w0 + t)] and
// advances only inside the lane's span [start_t, end_t); it reports iff
// the entry is final and the end pos = w0 + t lies in [keep_lo, keep_hi):
// keep_lo = max(row + q - 1, halo), keep_hi = min(next candidate row of
// the same lane + q - 1, end_t). That interval gives every match end to
// exactly one candidate. Slots at i >= n_valid (the sentinels of the
// compaction) walk an empty span: no reports, state 0.
// Writes rep[i, t] (0/1) and state[i, t] (after the step), row-major.
template <typename TT, typename Sym>
TPM_HD void window_walk(const TT* table, const Sym* data,
                        const int32_t* bounds, const int32_t* lane,
                        const int32_t* row, int64_t n_valid,
                        const WindowParams& p, int i, uint8_t* rep,
                        int32_t* state_out) {
  const bool cand_valid = i < n_valid;
  const int64_t r = row[i];
  const int lane_c = lane[i] < p.C - 1 ? lane[i] : p.C - 1;
  const int64_t st = cand_valid ? bounds[lane_c] : 0;
  const int64_t en = cand_valid ? bounds[p.C + lane_c] : 0;
  const int64_t w0 = r - (p.lmax - p.q);
  const int64_t base = (int64_t)lane_c * p.T + w0;
  const int64_t last = (int64_t)p.C * p.T - 1;
  const int64_t keep_lo = r + p.q - 1 > p.halo ? r + p.q - 1 : p.halo;
  const int64_t rnext =
      (i + 1 < p.kw && lane[i + 1] == lane[i]) ? row[i + 1] : kI32Max;
  int64_t keep_hi = rnext >= kI32Max - p.q ? kI32Max : rnext + p.q - 1;
  if (en < keep_hi) keep_hi = en;
  uint8_t* rep_i = rep + (int64_t)i * p.WLp;
  int32_t* st_i = state_out + (int64_t)i * p.WLp;
  int32_t state = 0;
  for (int t = 0; t < p.WLp; ++t) {
    const int64_t pos = w0 + t;
    int64_t idx = base + t;
    idx = idx < 0 ? 0 : (idx > last ? last : idx);
    const bool valid = pos >= st && pos < en;
    const int32_t raw = dfa_step(table, p.A, state, (int32_t)data[idx], valid);
    rep_i[t] = (uint8_t)(raw < 0 && valid && pos >= keep_lo && pos < keep_hi);
    st_i[t] = state;
  }
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
         p.halo >= 0 && p.kw > 0 && p.WLp >= 2 * p.lmax - p.q &&
         p.WLp % 4 == 0 && (int64_t)p.kw * p.WLp < ((int64_t)1 << 40);
}

inline bool dense_params_ok(const DenseParams& p) {
  return p.T >= 0 && p.C > 0 && p.A > 0 && p.halo >= 0 && p.R >= 0 &&
         p.G >= 0 && p.warm >= 0 && p.S >= 1 &&
         (int64_t)p.S * p.R * p.C < ((int64_t)1 << 40);
}

}  // namespace tpm
