// Arithmetic of the bloom probe kernels (bloom_probe.cu): the hashes, the
// bank probe, the lane masks, and the tile steps of the sampled and
// strided kernels. Every function is __host__ __device__ (or plain host
// code for the launch plan): bloom_probe_host.cpp runs the same code on
// the CPU, tile by tile, so the tests can hold the kernels' arithmetic to
// the reference without a GPU.
//
// All hash arithmetic is uint32_t: the reference (JAX, int32 with
// shift_right_logical) wraps on + and * and shifts logically, which is
// exactly unsigned 32-bit C++ arithmetic.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define TPM_HD __host__ __device__ __forceinline__
#define TPM_UNROLL _Pragma("unroll")
#else
#define TPM_HD inline
#define TPM_UNROLL
#endif

namespace tpm {

constexpr int kMaxQ = 8;                 // the chooser's q never exceeds 8
constexpr uint32_t kSelSentinel = 0x7FFFFFFFu;  // selection hash of rows
                                                // outside the lane's span
constexpr int kBadArgs = -1;  // entry-point code for rejected arguments
constexpr int kMaxContext = 128;  // w-1 and w+q-2 context rows (sampled):
                                  // the reference kernel's bound (gt=128)
constexpr int kWordRows = 32;     // rows per output word (one bit each)

struct ProbeParams {
  int T;       // time rows of data_tm (a multiple of 32 * stride)
  int C;       // lanes (a multiple of 128)
  int q;       // gram length
  int stride;  // tested-row stride (1 when sampled)
  int kbanks;  // banks; a row survives only if all of them hit
  int v;       // 4096-bit units per bank (a power of two)
  int w;       // winnowing window (sampled only)
  int fold;    // ASCII-fold symbols before hashing
  // The pattern-shard sequence (one launch per shard filter into one
  // bitmap): or_into ORs the word already in the bitmap into each word
  // written; count adds the written words' popcount to *total.
  int or_into;
  int count;
  uint32_t mix1[kMaxQ];
  uint32_t mix2[kMaxQ];
};

TPM_HD uint32_t fold_ascii(uint32_t c) {
  return (c >= 65u && c <= 90u) ? c + 32u : c;
}

// 31-bit selection hash, so the sentinel is a clean +infinity.
TPM_HD uint32_t sel_hash(uint32_t m1) {
  return (m1 ^ (m1 >> 13)) & 0x7FFFFFFFu;
}

// True iff banks [b0, b1) all have the gram's bit set. words: [k, v, 128]
// uint32. Bank b hashes h = m1 + b*m2, h ^= h >> 13, then unit
// (h>>17)&(v-1), word (h>>10)&127, bit (h>>5)&31 — the reference's bank
// layout.
TPM_HD bool probe_bank_range(const uint32_t* words, const ProbeParams& p,
                             uint32_t m1, uint32_t m2, int b0, int b1) {
  for (int b = b0; b < b1; ++b) {
    uint32_t h = m1 + (uint32_t)b * m2;
    h ^= h >> 13;
    const uint32_t unit = (h >> 17) & (uint32_t)(p.v - 1);
    const uint32_t word = (h >> 10) & 127u;
    const uint32_t bit = (h >> 5) & 31u;
    if (!((words[((uint32_t)b * p.v + unit) * 128u + word] >> bit) & 1u))
      return false;
  }
  return true;
}

// The lane masks of the two reference kernels. Sampled rows must lie in
// [start_t, end_t - q]: [lo, hi) of sampled_span; strided rows only need
// row + q <= end_t (halo rows below start_t ARE probed — the reference's
// asymmetry, kept for bitmap parity). row + q <= T keeps every read
// inside the array.
TPM_HD void sampled_span(int start, int end, const ProbeParams& p, int& lo,
                         int& hi) {
  lo = start > 0 ? start : 0;
  hi = end <= start ? lo : (end < p.T ? end : p.T) - p.q + 1;
}

TPM_HD bool strided_row_valid(int row, int start, int end, const ProbeParams& p) {
  return row + p.q <= end && end > start && row + p.q <= p.T;
}

// ------------------------------------------------- the tiles of the probes
//
// The kernels cut the bitmap into tiles of TW output words (32 rows each)
// by L adjacent lanes. A tile's symbol rows, with their context, are
// staged in shared memory once ([rows][L], 16-byte copies), with the
// tile's lane bounds. The packed strided kernel (bytes in [T/4, C] words
// of 4 little-endian bytes, stride % 4 == 0) stages the tile's word rows
// as they are ([ceil(rows / 4)][L] words; its tiles start on a word row,
// at 32 * word0 * stride) and reads byte r % 4 of word row r / 4 for
// symbol row r (tile_gram): the strided steps are the same.
//
// The sampled kernel first marks the rows the winnowing rule tests, for
// the whole tile, van Herk / Gil-Werman style (O(1) per row whatever w):
// per block of w staged rows of a lane, each row's selection hash,
// computed once, and the rightmost argmin of every prefix and suffix of
// the block (tile_block_hash); then the rightmost argmin of every
// w-window, from one suffix and one prefix, is marked
// (tile_window_argmin). Then, with queues for the whole tile:
//   A. the marked rows inside each lane's span (tile_tested_mask) go to
//      queue 1;
//   B. each queued gram is hashed from the staged rows and probed against
//      bank 0; the survivors go to queue 2 (tile_probe);
//   C. queue 2 is probed against banks 1..k-1; a gram that hits them all
//      sets its bit of the tile's output word (tile_probe).
// The strided kernel runs B and C per output word and per warp, on the
// valid tested rows of the warp's share of the word (tile_strided_valid).
// A queue entry is ((t * 32 + j) << log2 L) + lane: row j of output word
// t of the tile. Each step is a loop over an index range split across
// the block's threads; the functions below are one iteration of it,
// shared with the CPU harness.

struct TilePlan {
  int L;        // lanes per tile: 128, 64 or 32 (lshift = log2 L)
  int lshift;
  int TW;       // output words per tile
  int rows;     // staged symbol rows per tile
  int hrows;    // selection hashes per lane and tile (sampled), else 0
  int n_blocks; // blocks of w selection hashes per lane (sampled)
  int words_in_smem;  // bank words staged in shared memory (else global)
  int lane_tiles;     // C / L
  int n_tiles;        // lane_tiles * ceil(output words / TW)
  int threads;        // threads per block
  // byte offsets into the block's dynamic shared memory
  int off_buf[2];     // staged symbols, double-buffered
  int off_bounds[2];  // [2][L] int32 lane bounds of the staged tile
  int off_sel;        // [hrows][L] uint32 selection hashes
  int off_pre, off_suf;  // [hrows][L] uint8 block prefix / suffix argmins
  int off_mark;       // [TW][L] uint32 rows the winnowing rule tests
  int off_q1, off_q2; // uint16 queues: sampled, [TW * 32 * L] each over
                      // pre/suf and sel (dead by then); strided, [32 * L]
                      // (q2 only), a share per warp
  int off_cnt;        // two int32 queue lengths (sampled)
  int off_out;        // [TW][L] uint32 output words
  int smem;           // bytes in all (bank words first, at offset 0)
};

constexpr long kSmemPerBlock = 232448;  // Hopper's opt-in maximum (227 KB)
constexpr long kSmemPerSM = 233472;     // of which 1 KB per block reserved
// Threads per block: 512, or 1024 when the plan's shared memory leaves
// room for one block per SM (measured on the H100: 1024 threads gain
// 7-11% there and lose 3-15% where two blocks fit). Either way the 32 * L
// pairs of a word split evenly over the warps.

inline long align16(long x) { return (x + 15) & ~15L; }

// Bytes of one staged buffer of `rows` symbol rows x L lanes of
// `sym_bytes` each; sym_bytes 4 is the packed layout (a word per 4 rows).
inline long staged_bytes(int rows, int L, int sym_bytes) {
  return sym_bytes == 4 ? (long)((rows + 3) / 4) * L * 4
                        : (long)rows * L * sym_bytes;
}

// The tiling of one launch under a shared-memory budget of `budget` bytes
// per block, for symbols of `sym_bytes` (1, 2, or 4: packed bytes, strided
// only). In order of preference: bank words in shared memory, two
// blocks per SM, then (sampled) the tallest tile, TW 2 before 1 (less
// context per output row), then the widest lane tile; else the same with
// the words read from global memory (through L2). Returns kBadArgs if
// nothing fits.
inline int plan_tiles(const ProbeParams& p, int sampled, int sym_bytes,
                      long budget, TilePlan& t) {
  const int ctx = sampled ? p.w - 1 : 0;
  const int n_words = p.T / (kWordRows * p.stride);
  const long words_bytes = (long)p.kbanks * p.v * 128 * 4;
  const long half = kSmemPerSM / 2 - 1024;
  for (int in_smem = 1; in_smem >= 0; --in_smem) {
    for (int two = 1; two >= 0; --two) {
      const long cap = two && half < budget ? half : budget;
      for (int TW = sampled ? 2 : 1; TW >= 1; --TW) {
        for (int L = 128, ls = 7; L >= 32; L /= 2, --ls) {
          if (p.C % L) continue;
          const int rows = sampled ? kWordRows * TW + 2 * ctx + p.q - 1
                                   : kWordRows * p.stride * TW + p.q - 1;
          const int hrows = sampled ? kWordRows * TW + 2 * ctx : 0;
          long off = in_smem ? align16(words_bytes) : 0;
          for (int b = 0; b < 2; ++b) {
            t.off_buf[b] = (int)off;
            off += align16(staged_bytes(rows, L, sym_bytes));
            t.off_bounds[b] = (int)off;
            off += 8L * L;
          }
          t.off_sel = t.off_q2 = (int)off;
          off += 4L * hrows * L;
          t.off_pre = t.off_q1 = (int)off;
          off += align16((long)hrows * L);
          t.off_suf = (int)off;
          off += align16((long)hrows * L);
          t.off_mark = (int)off;
          off += 4L * TW * L;
          t.off_cnt = (int)off;
          off += 16;
          if (!sampled) {
            t.off_q2 = (int)off;
            off += align16(2L * kWordRows * L);
          }
          t.off_out = (int)off;
          off += 4L * TW * L;
          if (off > cap) continue;
          t.L = L;
          t.lshift = ls;
          t.TW = TW;
          t.rows = rows;
          t.hrows = hrows;
          t.n_blocks = sampled ? (hrows + p.w - 1) / p.w : 0;
          t.words_in_smem = in_smem;
          t.lane_tiles = p.C / L;
          t.n_tiles = t.lane_tiles * ((n_words + TW - 1) / TW);
          t.smem = (int)off;
          t.threads = 2 * (off + 1024) > kSmemPerSM ? 1024 : 512;
          return 0;
        }
      }
    }
  }
  return kBadArgs;
}

// One staged tile, as the steps see it. Sym is uint8_t or uint16_t, or
// uint32_t for the packed layout of bytes.
template <typename Sym>
struct TileView {
  const Sym* buf;        // [rows][L] staged symbols ([rows / 4][L] words)
  const int32_t* start;  // [L] span starts of the tile's lanes
  const int32_t* end;    // [L] span ends
  uint32_t* sel;         // [hrows][L] selection hashes (sampled)
  uint8_t* pre;          // [hrows][L] i - argmin of its block's prefix
  uint8_t* suf;          // [hrows][L] argmin of its block's suffix - i
  uint32_t* mark;        // [TW][L] rows the winnowing rule tests
  int L, lshift;
  int hrows;   // selection hashes per lane
  int base;    // data row of staged row 0 (below 0 at the top, sampled)
  int word0;   // first output word of the tile
  int nwords;  // output words of the tile (TW, or fewer at the bottom)
  int lane0;   // first lane of the tile
};

// The tile's position: word rows [word0, word0 + nwords), lanes
// [lane0, lane0 + L), staged rows from `base`.
TPM_HD void tile_place(const ProbeParams& p, const TilePlan& t, int sampled,
                       int tile, int& word0, int& nwords, int& lane0,
                       int& base) {
  const int n_words = p.T / (kWordRows * p.stride);
  word0 = (tile / t.lane_tiles) * t.TW;
  nwords = n_words - word0 < t.TW ? n_words - word0 : t.TW;
  lane0 = (tile % t.lane_tiles) * t.L;
  base = sampled ? kWordRows * word0 - (p.w - 1)
                 : kWordRows * word0 * p.stride;
}

// Is staged row i read by any gram? (The strided probe with q < stride
// skips the rows between grams.)
TPM_HD bool tile_row_needed(const ProbeParams& p, int sampled, int i) {
  return sampled || p.q >= p.stride || i % p.stride < p.q;
}

// Staged rows of a buffer: one per symbol row, or (Sym = uint32_t, the
// packed layout) one per 4 symbol rows.
template <typename Sym>
TPM_HD int rows_per_staged_row() {
  return sizeof(Sym) == 4 ? 4 : 1;
}

// m1 and m2 of the gram at staged row i of the tile's lane `lane`: each
// symbol (packed: each word) is read from shared memory once per gram.
// A packed gram starts a word (i is a multiple of the stride).
template <typename Sym>
TPM_HD void tile_gram(const TileView<Sym>& v, const ProbeParams& p, int i,
                      int lane, uint32_t& m1, uint32_t& m2) {
  const int per = rows_per_staged_row<Sym>();
  const Sym* col = v.buf + ((i / per) << v.lshift) + lane;
  uint32_t word = 0u;
  m1 = 0u;
  m2 = 0u;
  TPM_UNROLL
  for (int k = 0; k < kMaxQ; ++k) {
    if (k < p.q) {
      uint32_t s;
      if (per == 4) {
        if ((k & 3) == 0) word = col[(k >> 2) << v.lshift];
        s = (word >> (8 * (k & 3))) & 255u;
      } else {
        s = col[k << v.lshift];
      }
      if (p.fold) s = fold_ascii(s);
      m1 += s * p.mix1[k];
      m2 += s * p.mix2[k];
    }
  }
}

// The selection hash of staged row i of lane `lane`, or the sentinel
// outside the lane's sampled span [lo, hi) (the reference pads with it,
// so what padding rows hold never matters).
template <typename Sym>
TPM_HD uint32_t tile_sel_hash(const TileView<Sym>& v, const ProbeParams& p,
                              int i, int lane, int lo, int hi) {
  if (v.base + i < lo || v.base + i >= hi) return kSelSentinel;
  const Sym* col = v.buf + (i << v.lshift) + lane;
  uint32_t m1 = 0u;
  TPM_UNROLL
  for (int k = 0; k < kMaxQ; ++k) {
    if (k < p.q) {
      uint32_t s = col[k << v.lshift];
      if (p.fold) s = fold_ascii(s);
      m1 += s * p.mix1[k];
    }
  }
  return sel_hash(m1);
}

// Winnowing, step 1 (sampled): block k = item / L of lane item % L holds
// staged rows [k*w, k*w + w) (the last block fewer). Each row's selection
// hash, computed once, goes to sel; then for each row i of the block,
// the rightmost argmin of the hashes over the block's prefix ending at i
// (pre[i] = i - argmin) and over its suffix starting at i (suf[i] =
// argmin - i); both offsets are below w <= 129.
template <typename Sym>
TPM_HD void tile_block_hash(const TileView<Sym>& v, const ProbeParams& p,
                            int item) {
  const int k = item >> v.lshift, lane = item & (v.L - 1);
  int lo, hi;
  sampled_span(v.start[lane], v.end[lane], p, lo, hi);
  const int i0 = k * p.w;
  const int i1 = (i0 + p.w < v.hrows ? i0 + p.w : v.hrows) - 1;
  uint32_t* s = v.sel + lane;
  int best = i0;
  uint32_t bv = kSelSentinel;
  for (int i = i0; i <= i1; ++i) {  // ties: the later row wins
    const uint32_t x = tile_sel_hash(v, p, i, lane, lo, hi);
    s[i << v.lshift] = x;
    const bool take = x <= bv;
    best = take ? i : best;
    bv = take ? x : bv;
    v.pre[(i << v.lshift) + lane] = (uint8_t)(i - best);
  }
  best = i1;
  bv = s[i1 << v.lshift];
  for (int i = i1; i >= i0; --i) {  // ties: the later row stays
    const uint32_t x = s[i << v.lshift];
    const bool take = x < bv;
    best = take ? i : best;
    bv = take ? x : bv;
    v.suf[(i << v.lshift) + lane] = (uint8_t)(best - i);
  }
}

// Winnowing, step 2 (sampled): the w-window of staged rows [i, i + w-1],
// i = item / L, of lane item % L spans at most two blocks, so its
// rightmost argmin is that of the suffix from i or of the prefix to
// i + w-1, the later on a tie. Returns the output row of the tile it
// marks (0 .. 32*nwords - 1), or -1 if it lies in the context. A row is
// tested iff it is the rightmost argmin of some w-window: exactly the
// reference's rule, (run of predecessors >=) + (run of successors >) >=
// w-1, and the builder's (_winnow_grams).
template <typename Sym>
TPM_HD int tile_window_argmin(const TileView<Sym>& v, const ProbeParams& p,
                              int item) {
  const int i = item >> v.lshift, lane = item & (v.L - 1);
  const int ctx = p.w - 1;
  const int a = i + v.suf[(i << v.lshift) + lane];
  const int c = i + ctx - v.pre[((i + ctx) << v.lshift) + lane];
  const int m = v.sel[(c << v.lshift) + lane] <= v.sel[(a << v.lshift) + lane]
                    ? c : a;
  const int r = m - ctx;
  return r >= 0 && r < kWordRows * v.nwords ? r : -1;
}

TPM_HD uint32_t bits_below(int n) {  // n in [0, 32]
  return n >= 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
}

// Step A (sampled): the tested rows of output word t = item / L of lane
// item % L, as a mask of its 32 rows: the marked rows inside the lane's
// sampled span.
template <typename Sym>
TPM_HD uint32_t tile_tested_mask(const TileView<Sym>& v, const ProbeParams& p,
                                 int item) {
  const int t = item >> v.lshift, lane = item & (v.L - 1);
  int lo, hi;
  sampled_span(v.start[lane], v.end[lane], p, lo, hi);
  const int r0 = kWordRows * (v.word0 + t);
  lo -= r0;
  hi -= r0;
  const int a = lo < 0 ? 0 : lo > 32 ? 32 : lo;
  const int b = hi < a ? a : hi > 32 ? 32 : hi;
  return v.mark[item] & bits_below(b) & ~bits_below(a);
}

// Step B (strided): is row j = idx / L of output word t, lane idx % L,
// a tested row inside its lane's mask?
template <typename Sym>
TPM_HD bool tile_strided_valid(const TileView<Sym>& v, const ProbeParams& p,
                               int t, int idx) {
  const int j = idx >> v.lshift, lane = idx & (v.L - 1);
  const int row = (kWordRows * (v.word0 + t) + j) * p.stride;
  return strided_row_valid(row, v.start[lane], v.end[lane], p);
}

// Steps B and C: the gram of queue entry `e` (row j of output word t of
// lane l, e = ((t * 32 + j) << log2 L) + l) hits banks [b0, b1).
template <typename Sym>
TPM_HD bool tile_probe(const TileView<Sym>& v, const uint32_t* words,
                       const ProbeParams& p, int sampled, int e, int b0,
                       int b1) {
  const int tj = e >> v.lshift, lane = e & (v.L - 1);
  const int i = sampled ? p.w - 1 + tj : tj * p.stride;
  uint32_t m1, m2;
  tile_gram(v, p, i, lane, m1, m2);
  return probe_bank_range(words, p, m1, m2, b0, b1);
}

// Validates the launch arguments (C a multiple of 128, T of 32*stride,
// v a power of two, w = 0 for strided) and fills `p` (no OR, count on);
// returns kBadArgs on arguments the kernels do not take.
inline int fill_params(ProbeParams& p, int T, int C, int q, int stride,
                       int kbanks, int v, int w, int fold,
                       const int64_t* mix1, const int64_t* mix2) {
  if (q < 1 || q > kMaxQ || stride < 1 || kbanks < 1 || v < 1 ||
      (v & (v - 1)) || C <= 0 || C % 128 ||
      C / 128 > 65535 || T <= 0 || T % (32 * stride) || w < 0 ||
      w - 1 > kMaxContext || w + q - 2 > kMaxContext)
    return kBadArgs;
  p.T = T;
  p.C = C;
  p.q = q;
  p.stride = stride;
  p.kbanks = kbanks;
  p.v = v;
  p.w = w;
  p.fold = fold;
  p.or_into = 0;
  p.count = 1;
  for (int i = 0; i < kMaxQ; ++i) {
    p.mix1[i] = i < q ? (uint32_t)mix1[i] : 0u;
    p.mix2[i] = i < q ? (uint32_t)mix2[i] : 0u;
  }
  return 0;
}

}  // namespace tpm
