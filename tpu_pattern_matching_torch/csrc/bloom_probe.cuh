// Per-position math of the bloom probe and the per-thread body of both
// CUDA kernels (bloom_probe.cu). Every function is __host__ __device__:
// bloom_probe_host.cpp runs the same code on the CPU, so the tests can
// hold the kernels' arithmetic to the reference without a GPU.
//
// All hash arithmetic is uint32_t: the reference (JAX, int32 with
// shift_right_logical) wraps on + and * and shifts logically, which is
// exactly unsigned 32-bit C++ arithmetic.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define TPM_HD __host__ __device__ __forceinline__
#else
#define TPM_HD inline
#endif

namespace tpm {

constexpr int kMaxQ = 8;                 // the chooser's q never exceeds 8
constexpr uint32_t kSelSentinel = 0x7FFFFFFFu;  // selection hash of rows
                                                // outside the lane's span
constexpr int kBadArgs = -1;  // entry-point code for rejected arguments
constexpr int kMaxContext = 128;  // w-1 and w+q-2 context rows (sampled):
                                  // the reference kernel's bound (gt=128)

struct ProbeParams {
  int T;       // time rows of data_tm (a multiple of the tile height)
  int C;       // lanes (a multiple of 128)
  int q;       // gram length
  int stride;  // tested-row stride (1 when sampled)
  int kbanks;  // banks; a row survives only if all of them hit
  int v;       // 4096-bit units per bank (a power of two)
  int w;       // winnowing window (sampled only)
  int fold;    // ASCII-fold symbols before hashing
  uint32_t mix1[kMaxQ];
  uint32_t mix2[kMaxQ];
};

TPM_HD uint32_t fold_ascii(uint32_t c) {
  return (c >= 65u && c <= 90u) ? c + 32u : c;
}

// m1/m2 = sum_i sym[row+i] * mix{1,2}[i] (mod 2^32) over the gram starting
// at `row` of `lane` in the time-major [T, C] symbol array. Sym is uint8_t
// (bytes) or uint16_t (the ushort alphabet, symbols < 2048): a symbol is
// widened to uint32_t, so the mixes are the same for both widths.
template <typename Sym>
TPM_HD void gram_hashes(const Sym* data, const ProbeParams& p, int row,
                        int lane, uint32_t& m1, uint32_t& m2) {
  m1 = 0u;
  m2 = 0u;
  const Sym* col = data + (int64_t)row * p.C + lane;
  for (int i = 0; i < p.q; ++i) {
    uint32_t s = col[(int64_t)i * p.C];
    if (p.fold) s = fold_ascii(s);
    m1 += s * p.mix1[i];
    m2 += s * p.mix2[i];
  }
}

// 31-bit selection hash, so the sentinel is a clean +infinity.
TPM_HD uint32_t sel_hash(uint32_t m1) {
  return (m1 ^ (m1 >> 13)) & 0x7FFFFFFFu;
}

// True iff every bank has the gram's bit set. words: [k, v, 128] uint32.
// Bank b hashes h = m1 + b*m2, h ^= h >> 13, then unit (h>>17)&(v-1),
// word (h>>10)&127, bit (h>>5)&31 — the reference's bank layout.
TPM_HD bool probe_banks(const uint32_t* words, const ProbeParams& p,
                        uint32_t m1, uint32_t m2) {
  for (int b = 0; b < p.kbanks; ++b) {
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
// [start_t, end_t - q]; strided rows only need row + q <= end_t (halo rows
// below start_t ARE probed — the reference's asymmetry, kept for bitmap
// parity). row + q <= T keeps every read inside the array.
TPM_HD bool sampled_row_valid(int row, int start, int end, const ProbeParams& p) {
  return row >= start && row + p.q <= end && end > start && row + p.q <= p.T;
}

TPM_HD bool strided_row_valid(int row, int start, int end, const ProbeParams& p) {
  return row + p.q <= end && end > start && row + p.q <= p.T;
}

TPM_HD uint32_t pack_bit(uint32_t acc, bool hit, int b) {
  return acc | ((uint32_t)hit << b);
}

// One output word of the winnowing-sampled probe: rows [32*wrow, +32) of
// `lane`. A row is tested iff it is the rightmost argmin of some w-window
// of the selection hash: (run of predecessors >=) + (run of successors >)
// >= w-1, the builder's rightmost-argmin rule (_winnow_grams). Rows
// outside the lane's span hash to the sentinel, so padding contents never
// matter. `hm` holds 32 + 2*(w-1) selection hashes (the caller sizes it).
template <typename Sym>
TPM_HD uint32_t sampled_word(const Sym* data, const uint32_t* words,
                             const ProbeParams& p, int wrow, int lane,
                             int start, int end, uint32_t* hm) {
  const int ctx = p.w - 1;
  const int r0 = wrow * 32;
  for (int i = 0; i < 32 + 2 * ctx; ++i) {
    const int row = r0 - ctx + i;
    uint32_t hv = kSelSentinel;
    if (sampled_row_valid(row, start, end, p)) {
      uint32_t m1, m2;
      gram_hashes(data, p, row, lane, m1, m2);
      hv = sel_hash(m1);
    }
    hm[i] = hv;
  }
  uint32_t acc = 0u;
  for (int j = 0; j < 32; ++j) {
    const int row = r0 + j;
    if (!sampled_row_valid(row, start, end, p)) continue;
    const uint32_t h = hm[ctx + j];
    int b = 0;
    while (b < ctx && hm[ctx + j + 1 + b] > h) ++b;
    int a = 0;
    while (a < ctx - b && hm[ctx + j - 1 - a] >= h) ++a;
    if (a + b < ctx) continue;
    uint32_t m1, m2;
    gram_hashes(data, p, row, lane, m1, m2);
    acc = pack_bit(acc, probe_banks(words, p, m1, m2), j);
  }
  return acc;
}

// One output word of the strided probe: the grams at rows
// (32*wrow + j) * stride, j < 32, of `lane`.
template <typename Sym>
TPM_HD uint32_t strided_word(const Sym* data, const uint32_t* words,
                             const ProbeParams& p, int wrow, int lane,
                             int start, int end) {
  uint32_t acc = 0u;
  for (int j = 0; j < 32; ++j) {
    const int row = (wrow * 32 + j) * p.stride;
    if (!strided_row_valid(row, start, end, p)) continue;
    uint32_t m1, m2;
    gram_hashes(data, p, row, lane, m1, m2);
    acc = pack_bit(acc, probe_banks(words, p, m1, m2), j);
  }
  return acc;
}

// m1/m2 of the gram at symbol row `row` (a multiple of 4) of the PACKED
// layout: [T/4, C] uint32 words of 4 little-endian symbols, so symbol
// row r is byte r % 4 of word row r / 4. Each word is loaded once and its
// bytes are taken with logical shifts.
TPM_HD void gram_hashes_packed(const uint32_t* data, const ProbeParams& p,
                               int row, int lane, uint32_t& m1,
                               uint32_t& m2) {
  m1 = 0u;
  m2 = 0u;
  const uint32_t* col = data + (int64_t)(row >> 2) * p.C + lane;
  uint32_t word = 0u;
  for (int i = 0; i < p.q; ++i) {
    if ((i & 3) == 0) word = col[(int64_t)(i >> 2) * p.C];
    uint32_t s = (word >> (8 * (i & 3))) & 255u;
    if (p.fold) s = fold_ascii(s);
    m1 += s * p.mix1[i];
    m2 += s * p.mix2[i];
  }
}

// One output word of the packed strided probe (stride % 4 == 0, so every
// tested row starts a word): the same bits as strided_word on the byte
// layout of the same batch. p.T counts symbol rows, not word rows.
TPM_HD uint32_t strided_word_packed(const uint32_t* data,
                                    const uint32_t* words,
                                    const ProbeParams& p, int wrow, int lane,
                                    int start, int end) {
  uint32_t acc = 0u;
  for (int j = 0; j < 32; ++j) {
    const int row = (wrow * 32 + j) * p.stride;
    if (!strided_row_valid(row, start, end, p)) continue;
    uint32_t m1, m2;
    gram_hashes_packed(data, p, row, lane, m1, m2);
    acc = pack_bit(acc, probe_banks(words, p, m1, m2), j);
  }
  return acc;
}

// Validates the launch arguments (C a multiple of 128, T of 32*stride,
// v a power of two, w = 0 for strided) and fills `p`; returns kBadArgs on arguments the
// kernels do not take.
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
  for (int i = 0; i < kMaxQ; ++i) {
    p.mix1[i] = i < q ? (uint32_t)mix1[i] : 0u;
    p.mix2[i] = i < q ? (uint32_t)mix2[i] : 0u;
  }
  return 0;
}

}  // namespace tpm
