// Arithmetic of the prototype bloom probe kernel (proto_probe.cu), shared
// with its CPU harness (proto_probe_host.cpp): the per-row gram fold and
// the four lanes of one thread. The bank probe is bloom_probe.cuh's
// probe_bank_range, the same hash and bank layout as the product's
// probes.
//
// Layout: data [tiles * pitch, C] uint8 read as [tiles * pitch, C / 4]
// uint32 words (4 adjacent lanes, little-endian); tile t's strided row g
// folds rows t * pitch + g * stride + k, k < q. Output [tiles, rows, C]
// int8, 1 where every bank hits, written as [tiles * rows, C / 4] words.
#pragma once

#include <stdint.h>

#include "bloom_probe.cuh"

namespace tpm {

// The launch's geometry; items = tiles * rows * c4, one per thread.
struct ProtoGeom {
  int tiles;   // tiles, `pitch` rows apart
  int rows;    // strided rows per tile
  int stride;  // rows between strided rows
  int pitch;   // rows per tile in data (only the first (rows-1)*stride + q
               // are read)
  int c4;      // lanes / 4
  int items;   // tiles * rows * c4
};

// Fold symbol k of the grams of 4 adjacent lanes (the bytes of `word`)
// into their m1 and m2, in uint32 arithmetic.
TPM_HD void proto_fold(uint32_t word, int k, const ProbeParams& p,
                       uint32_t m1[4], uint32_t m2[4]) {
  TPM_UNROLL
  for (int j = 0; j < 4; ++j) {
    const uint32_t s = (word >> (8 * j)) & 255u;
    m1[j] += s * p.mix1[k];
    m2[j] += s * p.mix2[k];
  }
}

// The output word of `item` (tile, strided row, 4 adjacent lanes): byte j
// is 1 iff lane 4 * (item % c4) + j hits every bank. Each lane stops at
// its first missing bank.
TPM_HD uint32_t proto_item(const uint32_t* data, const uint32_t* words,
                           const ProbeParams& p, const ProtoGeom& g,
                           int item) {
  const int lane4 = item % g.c4;
  const int tg = item / g.c4;
  const int row = tg % g.rows, tile = tg / g.rows;
  const uint32_t* col =
      data + ((int64_t)tile * g.pitch + (int64_t)row * g.stride) * g.c4 +
      lane4;
  uint32_t m1[4] = {0u, 0u, 0u, 0u}, m2[4] = {0u, 0u, 0u, 0u};
  TPM_UNROLL
  for (int k = 0; k < kMaxQ; ++k)
    if (k < p.q) proto_fold(col[(int64_t)k * g.c4], k, p, m1, m2);
  uint32_t out = 0u;
  TPM_UNROLL
  for (int j = 0; j < 4; ++j)
    out |= (uint32_t)probe_bank_range(words, p, m1[j], m2[j], 0, p.kbanks)
           << (8 * j);
  return out;
}

constexpr int kProtoMaxWords = 48 * 1024 / 4;  // the table in static-limit
                                               // shared memory (48 KB)

// Validates the arguments and fills `p` and `g`; returns kBadArgs on
// arguments the kernel does not take (lanes not a multiple of 4, a tile
// shorter than its grams, a table over 48 KB, more than 2^30 data words,
// so that no item index of the grid-stride loop overflows).
inline int fill_proto(ProbeParams& p, ProtoGeom& g, int tiles, int rows,
                      int stride, int q, int pitch, int C, int kbanks, int v,
                      const int64_t* mix1, const int64_t* mix2) {
  if (tiles < 1 || rows < 1 || stride < 1 || q < 1 || q > kMaxQ ||
      pitch < (int64_t)(rows - 1) * stride + q || C < 4 || C % 4 ||
      kbanks < 1 || v < 1 || (v & (v - 1)) ||
      (int64_t)kbanks * v * 128 > kProtoMaxWords ||
      (int64_t)tiles * pitch * (C / 4) > (1 << 30))
    return kBadArgs;
  p.T = tiles * pitch;
  p.C = C;
  p.q = q;
  p.stride = stride;
  p.kbanks = kbanks;
  p.v = v;
  p.w = 0;
  p.fold = 0;
  for (int i = 0; i < kMaxQ; ++i) {
    p.mix1[i] = i < q ? (uint32_t)mix1[i] : 0u;
    p.mix2[i] = i < q ? (uint32_t)mix2[i] : 0u;
  }
  g.tiles = tiles;
  g.rows = rows;
  g.stride = stride;
  g.pitch = pitch;
  g.c4 = C / 4;
  g.items = tiles * rows * (C / 4);
  return 0;
}

}  // namespace tpm
