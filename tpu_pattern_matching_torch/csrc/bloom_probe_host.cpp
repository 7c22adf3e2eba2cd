// The CUDA kernels' per-thread bodies (bloom_probe.cuh), run on the CPU
// over a whole batch: thread (lane, word) of the kernel grid becomes one
// loop iteration. Built with g++ (no CUDA needed), it lets the tests hold
// the kernels' arithmetic to the reference on a machine without a GPU.
// Same arguments and outputs as the kernels' entry points, minus the
// stream, plus `mode`: 0 strided, 1 sampled, 2 packed strided (data is
// then [T/4, C] uint32 and T counts symbol rows). `sym16` selects uint16
// symbols (modes 0 and 1). Returns 0 or tpm::kBadArgs.
#include <stdint.h>

#include <vector>

#include "bloom_probe.cuh"

namespace {

template <typename Sym>
int64_t probe_all(int mode, const void* data, const int32_t* bd,
                  const uint32_t* wd, int32_t* out, const tpm::ProbeParams& p,
                  uint32_t* hm) {
  const auto* d = static_cast<const Sym*>(data);
  const auto* dw = static_cast<const uint32_t*>(data);
  int64_t n = 0;
  const int n_words = p.T / (32 * p.stride);
  for (int wrow = 0; wrow < n_words; ++wrow) {
    for (int lane = 0; lane < p.C; ++lane) {
      const int start = bd[lane], end = bd[p.C + lane];
      uint32_t acc;
      if (mode == 1)
        acc = tpm::sampled_word(d, wd, p, wrow, lane, start, end, hm);
      else if (mode == 2)
        acc = tpm::strided_word_packed(dw, wd, p, wrow, lane, start, end);
      else
        acc = tpm::strided_word(d, wd, p, wrow, lane, start, end);
      out[(int64_t)wrow * p.C + lane] = (int32_t)acc;
      n += __builtin_popcount(acc);
    }
  }
  return n;
}

}  // namespace

extern "C" int tpm_probe_host(int mode, const void* data,
                              const void* bounds, const void* words,
                              void* bits, void* total, int T, int C, int q,
                              int stride, int kbanks, int v, int w, int fold,
                              int sym16, const void* mix1, const void* mix2) {
  tpm::ProbeParams p;
  const bool sampled = mode == 1;
  if (mode < 0 || mode > 2) return tpm::kBadArgs;
  if (sampled && (stride != 1 || w < 1)) return tpm::kBadArgs;
  if (mode == 2 && (stride % 4 || q > stride || sym16)) return tpm::kBadArgs;
  if (tpm::fill_params(p, T, C, q, stride, kbanks, v, sampled ? w : 0, fold,
                       static_cast<const int64_t*>(mix1),
                       static_cast<const int64_t*>(mix2)))
    return tpm::kBadArgs;
  const auto* bd = static_cast<const int32_t*>(bounds);
  const auto* wd = static_cast<const uint32_t*>(words);
  auto* out = static_cast<int32_t*>(bits);
  std::vector<uint32_t> hm(32 + 2 * (sampled ? w - 1 : 0));
  const int64_t n =
      sym16 ? probe_all<uint16_t>(mode, data, bd, wd, out, p, hm.data())
            : probe_all<uint8_t>(mode, data, bd, wd, out, p, hm.data());
  *static_cast<int32_t*>(total) = (int32_t)n;
  return 0;
}
