// Bloom probe kernels for Hopper (sm_90a): the survivor bitmap of one
// time-major batch.
//
// Replace the Pallas kernels of tpu_pattern_matching/ops/bloom.py:
//   probe_sampled_kernel  <- _make_sampled_kernel (winnowing-sampled probe)
//   probe_strided_kernel  <- _make_probe_kernel, packed=False (strided)
// both launched by _probe_bits_jit. The reference ANDs one Pallas call per
// group of 8 banks; these kernels probe all k banks in one pass.
//
// Layout: data_tm [T, C] uint8 time-major, bounds [2, C] int32 (start_t,
// end_t), words [k, v, 128] uint32. Output bits [T/(32*stride), C] int32:
// bit b of bits[w, c] is the gram starting at row (w*32 + b)*stride of
// lane c; *total += popcount of the whole bitmap (zeroed by the caller).
//
// Mapping: one thread per lane, 128 lanes per block, so a warp reads 32
// adjacent bytes of each row; each thread writes kWordsPerThread output
// words (32 rows each) of its lane. What bounds it on this card: the
// per-row hashing (q loads and multiply-adds per hashed row) and the
// random bank-word gathers. The bank words are staged in shared memory
// when they fit (k*v*512 B <= 48 KB: 24 KB at the k6 v8 bench pick), so a
// gather costs a shared-memory access instead of an L1 line; larger
// filters (up to k16 v256 = 8 MB) are read from global memory, where they
// stay resident in the 50 MB L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bloom_probe.cuh"

namespace {

using tpm::ProbeParams;

constexpr int kBlockLanes = 128;
constexpr int kWordsPerThread = 4;  // 128 rows of one lane per thread
constexpr size_t kSmemWordsBytes = 48 * 1024;  // no opt-in attribute needed

__device__ __forceinline__ const uint32_t* stage_words(
    const uint32_t* __restrict__ words, uint32_t* smem, const ProbeParams& p,
    int in_smem) {
  if (!in_smem) return words;  // uniform across the block
  const int n = p.kbanks * p.v * 128;
  for (int i = threadIdx.x; i < n; i += blockDim.x) smem[i] = words[i];
  __syncthreads();
  return smem;
}

__device__ __forceinline__ void add_total(int32_t* total, uint32_t acc) {
  const unsigned n = __reduce_add_sync(0xffffffffu, (unsigned)__popc(acc));
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(total, (int32_t)n);
}

// Winnowing-sampled probe (tpm::sampled_word). MAXCTX bounds w-1: it sizes
// the per-thread array of selection hashes.
template <int MAXCTX>
__global__ void __launch_bounds__(kBlockLanes) probe_sampled_kernel(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ bounds,
    const uint32_t* __restrict__ words, int32_t* __restrict__ bits,
    int32_t* __restrict__ total, const ProbeParams p, int words_in_smem) {
  extern __shared__ uint32_t smem_words[];
  const uint32_t* wp = stage_words(words, smem_words, p, words_in_smem);
  const int lane = blockIdx.y * kBlockLanes + threadIdx.x;
  const int start = bounds[lane];
  const int end = bounds[p.C + lane];
  const int n_words = p.T / 32;
  uint32_t hm[32 + 2 * MAXCTX];
  for (int k = 0; k < kWordsPerThread; ++k) {
    const int wrow = blockIdx.x * kWordsPerThread + k;
    if (wrow >= n_words) break;  // uniform across the block
    const uint32_t acc =
        tpm::sampled_word(data, wp, p, wrow, lane, start, end, hm);
    bits[(int64_t)wrow * p.C + lane] = (int32_t)acc;
    add_total(total, acc);
  }
}

// Strided probe (tpm::strided_word).
__global__ void __launch_bounds__(kBlockLanes) probe_strided_kernel(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ bounds,
    const uint32_t* __restrict__ words, int32_t* __restrict__ bits,
    int32_t* __restrict__ total, const ProbeParams p, int words_in_smem) {
  extern __shared__ uint32_t smem_words[];
  const uint32_t* wp = stage_words(words, smem_words, p, words_in_smem);
  const int lane = blockIdx.y * kBlockLanes + threadIdx.x;
  const int start = bounds[lane];
  const int end = bounds[p.C + lane];
  const int n_words = p.T / (32 * p.stride);
  for (int k = 0; k < kWordsPerThread; ++k) {
    const int wrow = blockIdx.x * kWordsPerThread + k;
    if (wrow >= n_words) break;  // uniform across the block
    const uint32_t acc =
        tpm::strided_word(data, wp, p, wrow, lane, start, end);
    bits[(int64_t)wrow * p.C + lane] = (int32_t)acc;
    add_total(total, acc);
  }
}

size_t smem_bytes(const ProbeParams& p) {
  const size_t bytes = (size_t)p.kbanks * p.v * 128 * sizeof(uint32_t);
  return bytes <= kSmemWordsBytes ? bytes : 0;
}

dim3 grid_for(const ProbeParams& p) {
  const int n_words = p.T / (32 * p.stride);
  return dim3((n_words + kWordsPerThread - 1) / kWordsPerThread,
              p.C / kBlockLanes);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError()
// (or -1 for arguments the kernels do not take); it never synchronises.
int tpm_probe_sampled(const void* data, const void* bounds, const void* words,
                      void* bits, void* total, int T, int C, int q,
                      int kbanks, int v, int w, int fold, const void* mix1,
                      const void* mix2, void* stream) {
  ProbeParams p;
  if (tpm::fill_params(p, T, C, q, 1, kbanks, v, w, fold,
                       static_cast<const int64_t*>(mix1),
                       static_cast<const int64_t*>(mix2)) ||
      w < 1)
    return tpm::kBadArgs;
  const size_t smem = smem_bytes(p);
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* bd = static_cast<const int32_t*>(bounds);
  const auto* wd = static_cast<const uint32_t*>(words);
  auto* out = static_cast<int32_t*>(bits);
  auto* tot = static_cast<int32_t*>(total);
  auto s = static_cast<cudaStream_t>(stream);
  if (w - 1 <= 16)
    probe_sampled_kernel<16><<<grid_for(p), kBlockLanes, smem, s>>>(
        d, bd, wd, out, tot, p, smem > 0);
  else
    probe_sampled_kernel<128><<<grid_for(p), kBlockLanes, smem, s>>>(
        d, bd, wd, out, tot, p, smem > 0);
  return (int)cudaGetLastError();
}

int tpm_probe_strided(const void* data, const void* bounds, const void* words,
                      void* bits, void* total, int T, int C, int q,
                      int stride, int kbanks, int v, int fold,
                      const void* mix1, const void* mix2, void* stream) {
  ProbeParams p;
  if (tpm::fill_params(p, T, C, q, stride, kbanks, v, 0, fold,
                       static_cast<const int64_t*>(mix1),
                       static_cast<const int64_t*>(mix2)))
    return tpm::kBadArgs;
  const size_t smem = smem_bytes(p);
  probe_strided_kernel<<<grid_for(p), kBlockLanes, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(bounds),
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(bits),
      static_cast<int32_t*>(total), p, smem > 0);
  return (int)cudaGetLastError();
}

}  // extern "C"

extern "C" const char* tpm_error_string(int code) {
  return code == tpm::kBadArgs ? "arguments rejected by the probe kernel"
                               : cudaGetErrorString((cudaError_t)code);
}
