// The CUDA kernels' per-thread bodies (bloom_probe.cuh), run on the CPU
// over a whole batch: thread (lane, word) of the kernel grid becomes one
// loop iteration. Built with g++ (no CUDA needed), it lets the tests hold
// the kernels' arithmetic to the reference on a machine without a GPU.
// Same arguments and outputs as the kernels' entry points, minus the
// stream, plus `mode`: 0 strided, 1 sampled, 2 packed strided (data is
// then [T/4, C] uint32 and T counts symbol rows). Returns 0 or
// tpm::kBadArgs.
#include <stdint.h>

#include <vector>

#include "bloom_probe.cuh"

extern "C" int tpm_probe_host(int mode, const void* data,
                              const void* bounds, const void* words,
                              void* bits, void* total, int T, int C, int q,
                              int stride, int kbanks, int v, int w, int fold,
                              const void* mix1, const void* mix2) {
  tpm::ProbeParams p;
  const bool sampled = mode == 1;
  if (mode < 0 || mode > 2) return tpm::kBadArgs;
  if (sampled && (stride != 1 || w < 1)) return tpm::kBadArgs;
  if (mode == 2 && (stride % 4 || q > stride)) return tpm::kBadArgs;
  if (tpm::fill_params(p, T, C, q, stride, kbanks, v, sampled ? w : 0, fold,
                       static_cast<const int64_t*>(mix1),
                       static_cast<const int64_t*>(mix2)))
    return tpm::kBadArgs;
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* dw = static_cast<const uint32_t*>(data);
  const auto* bd = static_cast<const int32_t*>(bounds);
  const auto* wd = static_cast<const uint32_t*>(words);
  auto* out = static_cast<int32_t*>(bits);
  std::vector<uint32_t> hm(32 + 2 * (sampled ? w - 1 : 0));
  int64_t n = 0;
  const int n_words = T / (32 * stride);
  for (int wrow = 0; wrow < n_words; ++wrow) {
    for (int lane = 0; lane < C; ++lane) {
      const int start = bd[lane], end = bd[C + lane];
      uint32_t acc;
      if (mode == 1)
        acc = tpm::sampled_word(d, wd, p, wrow, lane, start, end, hm.data());
      else if (mode == 2)
        acc = tpm::strided_word_packed(dw, wd, p, wrow, lane, start, end);
      else
        acc = tpm::strided_word(d, wd, p, wrow, lane, start, end);
      out[(int64_t)wrow * C + lane] = (int32_t)acc;
      n += __builtin_popcount(acc);
    }
  }
  *static_cast<int32_t*>(total) = (int32_t)n;
  return 0;
}
