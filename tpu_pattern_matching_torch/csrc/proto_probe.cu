// The prototype bloom probe for Hopper (sm_90a): one kernel for the two
// Pallas prototypes of benchmarks/exp_bloom.py,
//   proto_probe_kernel <- kernel (run_probe: one tile, [G*S + Q, C] u8)
//                      <- big_kernel (big: a grid of disjoint tiles, each
//                         [TT + PADR, CT] u8, the pad rows never read)
// Each strided row g of a tile folds bytes g*stride + k, k < q, into m1
// and m2 and tests them against k banks of [v, 128] words; the output is
// 1 where every bank hits (int8 [tiles, rows, C]). Layout and per-thread
// code: proto_probe.cuh.
//
// What bounds it on this card: the read of the q rows of each strided row
// (bytes, at the grid's size: 50 MB of the 59 MB it moves) and the
// integer work per lane (2q multiply-adds, then ~9 operations per bank
// probed before the first miss, ~2 of 6 on random words). The design, a
// simple first one:
//   - the bank words (6 x 4 x 128 = 12 KB here) are copied into shared
//     memory once per block; a grid of at most 8 blocks per SM walks the
//     items in a grid-stride loop, so the table is read once per block;
//   - a thread takes 4 adjacent lanes of one strided row and reads each
//     of its q rows as one 32-bit word: a warp reads 128 contiguous bytes
//     a row;
//   - each lane stops at its first missing bank (probe_bank_range), and
//     the 4 int8 results are stored as one 32-bit word.
// The bank words are random gathers in shared memory (bank conflicts).
#include <cuda_runtime.h>
#include <stdint.h>

#include "proto_probe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

__global__ void __launch_bounds__(kThreads) proto_probe_kernel(
    const uint32_t* __restrict__ data, const uint32_t* __restrict__ words,
    uint32_t* __restrict__ out, const tpm::ProbeParams p,
    const tpm::ProtoGeom g) {
  extern __shared__ uint32_t table[];
  const int n = p.kbanks * p.v * 128;
  for (int i = threadIdx.x; i < n; i += blockDim.x) table[i] = words[i];
  __syncthreads();
  for (int item = blockIdx.x * blockDim.x + threadIdx.x; item < g.items;
       item += gridDim.x * blockDim.x)
    out[item] = tpm::proto_item(data, table, p, g, item);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code (or -1 for arguments
// the kernel does not take); it never synchronises. data [tiles * pitch,
// C] uint8, words [kbanks, v, 128] int32, out [tiles, rows, C] int8, all
// 4-byte aligned; mix1, mix2: q int64 multipliers.
int tpm_proto_probe(const void* data, const void* words, void* out,
                    int tiles, int rows, int stride, int q, int pitch, int C,
                    int kbanks, int v, const void* mix1, const void* mix2,
                    void* stream) {
  tpm::ProbeParams p;
  tpm::ProtoGeom g;
  if (tpm::fill_proto(p, g, tiles, rows, stride, q, pitch, C, kbanks, v,
                      static_cast<const int64_t*>(mix1),
                      static_cast<const int64_t*>(mix2)) ||
      (((uintptr_t)data | (uintptr_t)words | (uintptr_t)out) & 3u))
    return tpm::kBadArgs;
  int dev = 0, n_sm = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (!rc)
    rc = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (rc) return rc;
  const int need = (g.items + kThreads - 1) / kThreads;
  const int grid = need < n_sm * kBlocksPerSM ? need : n_sm * kBlocksPerSM;
  const size_t smem = (size_t)p.kbanks * p.v * 128 * 4;
  proto_probe_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(data), static_cast<const uint32_t*>(words),
      static_cast<uint32_t*>(out), p, g);
  return (int)cudaGetLastError();
}

const char* tpm_proto_error_string(int code) {
  return code == tpm::kBadArgs ? "arguments rejected by the proto probe"
                               : cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
