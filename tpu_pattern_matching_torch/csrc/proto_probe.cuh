// Arithmetic of the prototype bloom probe kernel (proto_probe.cu), shared
// with its CPU harness (proto_probe_host.cpp): the placement of an item
// (a group of 16 adjacent lanes of one strided row, or 4 in a launch too
// small to fill the card with such groups), the gram fold of 4 lanes at a
// time, and the whole probe of an item as the harness runs it.
// The bank probe is bloom_probe.cuh's probe_bank_range, the same hash and
// bank layout as the product's probes.
//
// Layout: data [tiles * pitch, C] uint8 read as [tiles * pitch, C / 4]
// uint32 words (4 adjacent lanes, little-endian); tile t's strided row g
// folds rows t * pitch + g * stride + k, k < q. Output [tiles, rows, C]
// int8, 1 where every bank hits, written as [tiles * rows, C / 4] words.
// An item is `wpi` adjacent words of a row, 1 or 4 (the last of a row
// fewer when C is not a multiple of 4 * wpi).
#pragma once

#include <stdint.h>

#include "bloom_probe.cuh"

namespace tpm {

constexpr int kProtoWords = 4;  // the most words (of 4 lanes) per item

// The launch's geometry; items = tiles * rows * groups.
struct ProtoGeom {
  int tiles;   // tiles, `pitch` rows apart
  int rows;    // strided rows per tile
  int stride;  // rows between strided rows
  int pitch;   // rows per tile in data (only the first (rows-1)*stride + q
               // are read)
  int c4;      // lanes / 4: words per row
  int wpi;     // words per item: 1 or kProtoWords
  int groups;  // items per strided row: ceil(c4 / wpi)
  int items;   // tiles * rows * groups
};

// Where an item lies: the data word of its first lane in gram row 0 (row
// k is k * c4 words on), its first output word, and its words.
struct ProtoItem {
  int64_t in, out;
  int nw;
};

TPM_HD ProtoItem proto_place(const ProtoGeom& g, int item) {
  const int grp = item % g.groups;
  const int tg = item / g.groups;  // tile * rows + strided row
  const int row = tg % g.rows, tile = tg / g.rows;
  ProtoItem it;
  it.in = ((int64_t)tile * g.pitch + (int64_t)row * g.stride) * g.c4 +
          g.wpi * grp;
  it.out = (int64_t)tg * g.c4 + g.wpi * grp;
  const int left = g.c4 - g.wpi * grp;
  it.nw = left < g.wpi ? left : g.wpi;
  return it;
}

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

// m1 and m2 of the 4 lanes of word w of an item, from its gram rows'
// words raw[k][w], k < q <= NQ.
template <int NQ>
TPM_HD void proto_hash(const uint32_t (&raw)[NQ][kProtoWords], int w,
                       const ProbeParams& p, uint32_t m1[4], uint32_t m2[4]) {
  TPM_UNROLL
  for (int j = 0; j < 4; ++j) m1[j] = m2[j] = 0u;
  TPM_UNROLL
  for (int k = 0; k < NQ; ++k)
    if (k < p.q) proto_fold(raw[k][w], k, p, m1, m2);
}

// The item's output words as the plain version has them (the CPU
// harness): byte j of word w is 1 iff that lane hits every bank.
TPM_HD void proto_item(const uint32_t* data, const uint32_t* words,
                       const ProbeParams& p, const ProtoGeom& g, int item,
                       uint32_t* out) {
  const ProtoItem it = proto_place(g, item);
  uint32_t raw[kMaxQ][kProtoWords];
  for (int k = 0; k < kMaxQ; ++k)
    for (int w = 0; w < kProtoWords; ++w)
      raw[k][w] = k < p.q && w < it.nw ? data[it.in + (int64_t)k * g.c4 + w]
                                       : 0u;
  for (int w = 0; w < it.nw; ++w) {
    uint32_t m1[4], m2[4], o = 0u;
    proto_hash(raw, w, p, m1, m2);
    for (int j = 0; j < 4; ++j)
      o |= (uint32_t)probe_bank_range(words, p, m1[j], m2[j], 0, p.kbanks)
           << (8 * j);
    out[it.out + w] = o;
  }
}

constexpr int kProtoMaxWords = 48 * 1024 / 4;  // the table's largest size
                                               // in shared memory (48 KB)

// Validates the arguments and fills `p` and `g`; returns kBadArgs on
// arguments the kernel does not take (lanes not a multiple of 4, a tile
// shorter than its grams, a table over 48 KB, more than 2^30 data words,
// so that no item or word index overflows, wpi not 1 or kProtoWords).
inline int fill_proto(ProbeParams& p, ProtoGeom& g, int tiles, int rows,
                      int stride, int q, int pitch, int C, int kbanks, int v,
                      int wpi, const int64_t* mix1, const int64_t* mix2) {
  if (tiles < 1 || rows < 1 || stride < 1 || q < 1 || q > kMaxQ ||
      (wpi != 1 && wpi != kProtoWords) ||
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
  g.wpi = wpi;
  g.groups = (g.c4 + wpi - 1) / wpi;
  g.items = tiles * rows * g.groups;
  return 0;
}

}  // namespace tpm
