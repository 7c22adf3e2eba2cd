// The probe kernels' tile code (bloom_probe.cuh) run on the CPU over a
// whole batch, tile by tile: each step's thread loop becomes one loop, and
// the queues fill in index order instead of warp order (the bitmap does
// not depend on the order). Built with g++ (no CUDA needed), it lets the
// tests hold the kernels' arithmetic to the reference on a machine without
// a GPU. Same arguments and outputs as the kernels' entry points (the
// pattern-shard flags or_into and count included), minus the stream, plus
// `mode`: 0 strided, 1 sampled, 2 packed strided (data is
// then [T/4, C] uint32, staged as word rows, and T counts symbol rows),
// and `budget`, the shared-memory bytes per block the tiling may plan for
// (0: Hopper's 227 KB; smaller budgets give narrower tiles). `sym16`
// selects uint16 symbols (modes 0 and 1). Returns 0 or tpm::kBadArgs.
#include <stdint.h>
#include <string.h>

#include <vector>

#include "bloom_probe.cuh"

namespace {

using tpm::ProbeParams;
using tpm::TilePlan;
using tpm::TileView;

// The kernels' loop over tiles, for one block that takes every tile
// (Sym = uint32_t: the packed layout, staged as word rows). Staged rows
// that no step reads are left holding the previous tile's symbols (or the
// fill byte), as in shared memory.
template <typename Sym>
int64_t probe_tiles(int sampled, const Sym* data, const int32_t* bd,
                    const uint32_t* wd, int32_t* out, const ProbeParams& p,
                    const TilePlan& t) {
  const int per = tpm::rows_per_staged_row<Sym>();
  const int rows = (t.rows + per - 1) / per;
  std::vector<Sym> buf((size_t)rows * t.L, (Sym)0xA5A5A5A5u);
  std::vector<int32_t> bounds(2 * t.L);
  std::vector<uint32_t> sel((size_t)t.hrows * t.L);
  std::vector<uint8_t> pre(sel.size()), suf(sel.size());
  std::vector<uint32_t> mark(t.TW * t.L);
  std::vector<uint16_t> q1(t.TW * tpm::kWordRows * t.L), q2(q1.size());
  std::vector<uint32_t> words(t.TW * t.L);
  const int pairs = tpm::kWordRows * t.L;
  int64_t ones = 0;
  for (int tile = 0; tile < t.n_tiles; ++tile) {
    TileView<Sym> v;
    tpm::tile_place(p, t, sampled, tile, v.word0, v.nwords, v.lane0, v.base);
    for (int i = 0; i < rows; ++i) {  // stage
      const int r = v.base / per + i;
      if (r < 0 || r >= p.T / per ||
          !tpm::tile_row_needed(p, sampled, i * per))
        continue;
      memcpy(&buf[(size_t)i * t.L], data + (int64_t)r * p.C + v.lane0,
             t.L * sizeof(Sym));
    }
    for (int r = 0; r < 2; ++r)
      memcpy(&bounds[r * t.L], bd + (int64_t)r * p.C + v.lane0,
             t.L * sizeof(int32_t));
    v.buf = buf.data();
    v.start = bounds.data();
    v.end = bounds.data() + t.L;
    v.sel = sel.data();
    v.pre = pre.data();
    v.suf = suf.data();
    v.mark = mark.data();
    v.L = t.L;
    v.lshift = t.lshift;
    v.hrows = t.hrows;
    for (auto& x : words) x = 0u;
    int n1 = 0, n2 = 0;
    if (sampled) {
      for (auto& x : mark) x = 0u;
      for (int i = 0; i < t.n_blocks * t.L; ++i)  // hashes, argmins
        tpm::tile_block_hash(v, p, i);
      const int windows = (tpm::kWordRows * t.TW + p.w - 1) * t.L;
      for (int i = 0; i < windows; ++i) {  // marks
        const int r = tpm::tile_window_argmin(v, p, i);
        if (r >= 0)
          mark[((r >> 5) << t.lshift) + (i & (t.L - 1))] |= 1u << (r & 31);
      }
      for (int i = 0; i < v.nwords * t.L; ++i) {  // A
        const int tw = (i >> t.lshift) * tpm::kWordRows, ln = i & (t.L - 1);
        for (uint32_t m = tpm::tile_tested_mask(v, p, i); m; m &= m - 1u)
          q1[n1++] = (uint16_t)(((tw + __builtin_ctz(m)) << t.lshift) + ln);
      }
      for (int i = 0; i < n1; ++i)  // B
        if (tpm::tile_probe(v, wd, p, 1, q1[i], 0, 1)) q2[n2++] = q1[i];
    } else {
      for (int i = 0; i < pairs; ++i)  // B
        if (tpm::tile_strided_valid(v, p, 0, i) &&
            tpm::tile_probe(v, wd, p, 0, i, 0, 1))
          q2[n2++] = (uint16_t)i;
    }
    for (int i = 0; i < n2; ++i) {  // C
      const int e = q2[i], tj = e >> t.lshift;
      if (tpm::tile_probe(v, wd, p, sampled, e, 1, p.kbanks))
        words[((tj >> 5) << t.lshift) + (e & (t.L - 1))] |= 1u << (tj & 31);
    }
    for (int i = 0; i < v.nwords * t.L; ++i) {
      const int w = i >> t.lshift, lane = i & (t.L - 1);
      int32_t* at = out + (int64_t)(v.word0 + w) * p.C + v.lane0 + lane;
      const uint32_t acc = p.or_into ? words[i] | (uint32_t)*at : words[i];
      *at = (int32_t)acc;
      ones += __builtin_popcount(acc);
    }
  }
  return ones;
}

int params_for(int mode, ProbeParams& p, int T, int C, int q, int stride,
               int kbanks, int v, int w, int fold, int sym16,
               const void* mix1, const void* mix2) {
  const bool sampled = mode == 1;
  if (mode < 0 || mode > 2) return tpm::kBadArgs;
  if (sampled && (stride != 1 || w < 1)) return tpm::kBadArgs;
  if (mode == 2 && (stride % 4 || q > stride || sym16)) return tpm::kBadArgs;
  return tpm::fill_params(p, T, C, q, stride, kbanks, v, sampled ? w : 0,
                          fold, static_cast<const int64_t*>(mix1),
                          static_cast<const int64_t*>(mix2));
}

}  // namespace

extern "C" int tpm_probe_host(int mode, const void* data,
                              const void* bounds, const void* words,
                              void* bits, void* total, int T, int C, int q,
                              int stride, int kbanks, int v, int w, int fold,
                              int sym16, int or_into, int count,
                              const void* mix1, const void* mix2,
                              long budget) {
  ProbeParams p;
  TilePlan t;
  if (params_for(mode, p, T, C, q, stride, kbanks, v, w, fold, sym16, mix1,
                 mix2))
    return tpm::kBadArgs;
  p.or_into = or_into;
  p.count = count;
  const auto* bd = static_cast<const int32_t*>(bounds);
  const auto* wd = static_cast<const uint32_t*>(words);
  auto* out = static_cast<int32_t*>(bits);
  if (tpm::plan_tiles(p, mode == 1, mode == 2 ? 4 : sym16 ? 2 : 1,
                      budget > 0 ? budget : tpm::kSmemPerBlock, t))
    return tpm::kBadArgs;
  int64_t n;
  if (mode == 2)
    n = probe_tiles(0, static_cast<const uint32_t*>(data), bd, wd, out, p, t);
  else if (sym16)
    n = probe_tiles(mode, static_cast<const uint16_t*>(data), bd, wd, out, p,
                    t);
  else
    n = probe_tiles(mode, static_cast<const uint8_t*>(data), bd, wd, out, p,
                    t);
  if (p.count) *static_cast<int32_t*>(total) += (int32_t)n;
  return 0;
}

// The tiling the kernels would take under `budget` (0: 227 KB): out[0..5]
// = lanes per tile, output words per tile, tiles, bank words in shared
// memory (1/0), shared-memory bytes, threads per block. layout: 0 uint8,
// 1 uint16 symbols, 2 the packed layout of bytes (strided).
extern "C" int tpm_probe_plan_host(int sampled, int T, int C, int q,
                                   int stride, int kbanks, int v, int w,
                                   int layout, long budget, void* out) {
  ProbeParams p;
  TilePlan t;
  const int64_t zeros[tpm::kMaxQ] = {0};
  const int mode = layout == 2 ? 2 : sampled ? 1 : 0;
  if (layout < 0 || layout > 2 || (layout == 2 && sampled) ||
      params_for(mode, p, T, C, q, sampled ? 1 : stride, kbanks, v, w, 0,
                 layout == 1, zeros, zeros) ||
      tpm::plan_tiles(p, sampled, layout == 2 ? 4 : layout + 1,
                      budget > 0 ? budget : tpm::kSmemPerBlock, t))
    return tpm::kBadArgs;
  int* o = static_cast<int*>(out);
  o[0] = t.L;
  o[1] = t.TW;
  o[2] = t.n_tiles;
  o[3] = t.words_in_smem;
  o[4] = t.smem;
  o[5] = t.threads;
  return 0;
}
