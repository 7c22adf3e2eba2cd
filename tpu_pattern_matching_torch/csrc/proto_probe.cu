// The prototype bloom probe for Hopper (sm_90a): one kernel for the two
// Pallas prototypes of benchmarks/exp_bloom.py,
//   proto_probe_kernel <- kernel (run_probe: one tile, [G*S + Q, C] u8)
//                      <- big_kernel (big: a grid of disjoint tiles, each
//                         [TT + PADR, CT] u8, the pad rows never read)
// Each strided row g of a tile folds bytes g*stride + k, k < q, into m1
// and m2 and tests them against k banks of [v, 128] words; the output is
// 1 where every bank hits (int8 [tiles, rows, C]). Layout and per-item
// code: proto_probe.cuh.
//
// What bounds it on this card: the read of the q rows of each strided row
// (bytes, at the grid's size: 50 MB of the 59 MB it moves) and, nearly as
// much, the integer work per lane (2q multiply-adds, then ~9 operations
// per bank probed before the first miss, ~1.9 of 6 on random words), so
// loads and probes have to overlap. The design:
//   - persistent blocks of 8 warps (as many as the SMs hold) stage the
//     bank words (6 x 4 x 128 = 12 KB here) in shared memory once;
//   - a thread takes an item of 16 adjacent lanes of one strided row and
//     reads each of its q gram rows as one 16-byte load (4-byte loads
//     when C is not a multiple of 16), so a warp reads 512 contiguous
//     bytes a row; a warp walks its items in a grid-stride loop, and the
//     next item's rows are loaded into registers before the current
//     item's probes start, so their latency hides under the probes (the
//     first item's under the table's copy). The kernel is instantiated
//     per gram length q, so that only q rows take registers. A launch too
//     small to give every SM a block of 16-lane items (K4, one tile)
//     takes 4 lanes an item, for 4x the warps, each 4x shorter;
//   - every lane is hashed and probed against bank 0 without a branch;
//     the survivors (about half) go to the warp's queue in shared memory
//     (__ballot_sync / __popc), with their m1 and m2, and each later bank
//     is probed over the queue, compacting it in place, so every thread
//     of the warp probes in every round and a warp no longer waits for
//     its slowest lane's banks. A lane hits iff it survives all banks
//     (an AND, so the order of probing changes nothing);
//   - the survivors of the last bank set their bits in a word per thread
//     (shared-memory atomics), and each thread writes its 16 results as
//     one 16-byte store.
// The bank words are random gathers in shared memory (bank conflicts).
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "proto_probe.cuh"

namespace {

using tpm::kMaxQ;
using tpm::kProtoWords;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kQueue = 32 * kProtoWords * 4;  // a warp's lanes per round

// Shared memory of a block: the bank words, then per warp its queue (m1,
// m2, the lane's index in the warp's 512) and a hit word per thread.
constexpr size_t kWarpBytes = kQueue * (4 + 4 + 2) + 32 * 4;

size_t smem_bytes(const tpm::ProbeParams& p) {
  return (size_t)p.kbanks * p.v * 128 * 4 + kWarps * kWarpBytes;
}

// The gram rows' words of `item` (zeros past the row's last word, and
// for an item past the launch); wide: one 16-byte load a row.
template <int Q>
__device__ __forceinline__ void load_item(
    const uint32_t* __restrict__ data, const tpm::ProtoGeom& g, int item,
    bool wide, uint32_t (&raw)[Q][kProtoWords]) {
  const bool active = item < g.items;
  const tpm::ProtoItem it = tpm::proto_place(g, active ? item : 0);
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const uint32_t* row = data + it.in + (int64_t)k * g.c4;
    if (active && wide) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row));
      raw[k][0] = v.x;
      raw[k][1] = v.y;
      raw[k][2] = v.z;
      raw[k][3] = v.w;
    } else {
#pragma unroll
      for (int w = 0; w < kProtoWords; ++w)
        raw[k][w] = active && w < it.nw ? __ldg(row + w) : 0u;
    }
  }
}

// Append (m1, m2, idx) to the warp's queue of length n when `pred`.
// Every lane of the warp calls it.
__device__ __forceinline__ void push(uint32_t* qm1, uint32_t* qm2,
                                     uint16_t* qi, int& n, bool pred,
                                     uint32_t m1, uint32_t m2, int idx) {
  const unsigned m = __ballot_sync(0xffffffffu, pred);
  if (pred) {
    const int at = n + __popc(m & ((1u << (threadIdx.x & 31)) - 1u));
    qm1[at] = m1;
    qm2[at] = m2;
    qi[at] = (uint16_t)idx;
  }
  n += __popc(m);
}

// Q = p.q (one instance per gram length, so that only Q rows take
// registers), at most 85 registers so that 3 blocks fit an SM; wide: wpi
// 4, C % 16 == 0 and data, out 16-byte aligned.
template <int Q>
__global__ void __launch_bounds__(kThreads, 3) proto_probe_kernel(
    const uint32_t* __restrict__ data, const uint32_t* __restrict__ words,
    uint32_t* __restrict__ out, const tpm::ProbeParams p,
    const tpm::ProtoGeom g, const int wide) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_witems = (g.items + 31) / 32;
  const int step = gridDim.x * kWarps;
  int wi = blockIdx.x * kWarps + warp;
  uint32_t next[Q][kProtoWords];  // the first item's rows, under the copy
  if (wi < n_witems) load_item<Q>(data, g, wi * 32 + lane, wide, next);
  const int nw4 = p.kbanks * p.v * 128 / 4;
  uint4* table4 = reinterpret_cast<uint4*>(smem);
  for (int i = tid; i < nw4; i += kThreads)
    table4[i] = reinterpret_cast<const uint4*>(words)[i];
  const uint32_t* table = reinterpret_cast<const uint32_t*>(smem);
  unsigned char* mine = smem + (size_t)nw4 * 16 + warp * kWarpBytes;
  uint32_t* qm1 = reinterpret_cast<uint32_t*>(mine);
  uint32_t* qm2 = qm1 + kQueue;
  uint32_t* hit = qm2 + kQueue;
  uint16_t* qi = reinterpret_cast<uint16_t*>(hit + 32);
  hit[lane] = 0u;
  __syncthreads();
  for (; wi < n_witems; wi += step) {
    const int item = wi * 32 + lane;
    const bool active = item < g.items;
    const tpm::ProtoItem it = tpm::proto_place(g, active ? item : 0);
    uint32_t raw[Q][kProtoWords];
#pragma unroll
    for (int k = 0; k < Q; ++k)
#pragma unroll
      for (int w = 0; w < kProtoWords; ++w) raw[k][w] = next[k][w];
    if (wi + step < n_witems)  // in flight under this item's probes
      load_item<Q>(data, g, (wi + step) * 32 + lane, wide, next);
    int n = 0;  // bank 0, every lane: the survivors to the queue
#pragma unroll
    for (int w = 0; w < kProtoWords; ++w) {
      if (w >= g.wpi) break;  // the same for the whole warp
      uint32_t m1[4], m2[4];
      tpm::proto_hash(raw, w, p, m1, m2);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        push(qm1, qm2, qi, n,
             active && w < it.nw &&
                 tpm::probe_bank_range(table, p, m1[j], m2[j], 0, 1),
             m1[j], m2[j], lane * 16 + 4 * w + j);
    }
    for (int b = 1; b < p.kbanks && n; ++b) {  // banks 1..k-1, the queue
      int kept = 0;
      for (int i0 = 0; i0 < n; i0 += 32) {
        const int i = i0 + lane;
        __syncwarp();  // the last round's (or chunk's) stores are seen
        const bool ok = i < n;
        const uint32_t m1 = ok ? qm1[i] : 0u, m2 = ok ? qm2[i] : 0u;
        const int idx = ok ? qi[i] : 0;
        __syncwarp();  // read before any lane overwrites (kept <= i0)
        push(qm1, qm2, qi, kept,
             ok && tpm::probe_bank_range(table, p, m1, m2, b, b + 1), m1,
             m2, idx);
      }
      n = kept;
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32)
      atomicOr(&hit[qi[i] >> 4], 1u << (qi[i] & 15));
    __syncwarp();
    const uint32_t h = hit[lane];
    hit[lane] = 0u;
    if (active) {
      uint32_t o[kProtoWords];
#pragma unroll
      for (int w = 0; w < kProtoWords; ++w)
        o[w] = ((h >> (4 * w)) & 1u) | ((h >> (4 * w + 1)) & 1u) << 8 |
               ((h >> (4 * w + 2)) & 1u) << 16 |
               ((h >> (4 * w + 3)) & 1u) << 24;
      if (wide) {
        *reinterpret_cast<uint4*>(out + it.out) =
            make_uint4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int w = 0; w < kProtoWords; ++w)
          if (w < it.nw) out[it.out + w] = o[w];
      }
    }
  }
}

using Kernel = void (*)(const uint32_t*, const uint32_t*, uint32_t*,
                        const tpm::ProbeParams, const tpm::ProtoGeom,
                        const int);
const Kernel kKernels[kMaxQ] = {
    proto_probe_kernel<1>, proto_probe_kernel<2>, proto_probe_kernel<3>,
    proto_probe_kernel<4>, proto_probe_kernel<5>, proto_probe_kernel<6>,
    proto_probe_kernel<7>, proto_probe_kernel<8>};

// Per device, kernel and shared memory size: the blocks an SM holds,
// asked once (the kernel has opted into that much dynamic shared memory).
std::mutex g_mu;
std::map<std::tuple<int, const void*, size_t>, int> g_per_sm;

int blocks_per_sm(int dev, Kernel kernel, size_t smem, int& per_sm) {
  std::lock_guard<std::mutex> lock(g_mu);
  const auto key = std::make_tuple(dev, (const void*)kernel, smem);
  auto it = g_per_sm.find(key);
  if (it == g_per_sm.end()) {
    int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (!rc)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, smem);
    if (rc) return rc;
    it = g_per_sm.emplace(key, per_sm).first;
  }
  per_sm = it->second;
  return per_sm < 1 ? tpm::kBadArgs : 0;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code (or -1 for arguments
// the kernel does not take); it never synchronises. data [tiles * pitch,
// C] uint8, words [kbanks, v, 128] int32 (16-byte aligned), out [tiles,
// rows, C] int8, data and out 4-byte aligned; mix1, mix2: q int64
// multipliers. An item is 16 lanes when that gives at least a block of
// warps per SM, else 4 lanes (a small launch: more warps, each shorter).
int tpm_proto_probe(const void* data, const void* words, void* out,
                    int tiles, int rows, int stride, int q, int pitch, int C,
                    int kbanks, int v, const void* mix1, const void* mix2,
                    void* stream) {
  int dev = 0, n_sm = 0, per_sm = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (!rc)
    rc = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (rc) return rc;
  const int64_t groups4 = (C / 4 + kProtoWords - 1) / kProtoWords;
  const int wpi =
      ((int64_t)tiles * rows * groups4 + 31) / 32 >= (int64_t)n_sm * kWarps
          ? kProtoWords
          : 1;
  tpm::ProbeParams p;
  tpm::ProtoGeom g;
  if (tpm::fill_proto(p, g, tiles, rows, stride, q, pitch, C, kbanks, v, wpi,
                      static_cast<const int64_t*>(mix1),
                      static_cast<const int64_t*>(mix2)) ||
      (((uintptr_t)data | (uintptr_t)out) & 3u) || ((uintptr_t)words & 15u))
    return tpm::kBadArgs;
  const int wide = wpi == kProtoWords && C % 16 == 0 &&
                   !(((uintptr_t)data | (uintptr_t)out) & 15u);
  const Kernel kernel = kKernels[q - 1];
  const size_t smem = smem_bytes(p);
  rc = blocks_per_sm(dev, kernel, smem, per_sm);
  if (rc) return rc;
  const int need = ((g.items + 31) / 32 + kWarps - 1) / kWarps;
  const int grid = need < n_sm * per_sm ? need : n_sm * per_sm;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(data), static_cast<const uint32_t*>(words),
      static_cast<uint32_t*>(out), p, g, wide);
  return (int)cudaGetLastError();
}

const char* tpm_proto_error_string(int code) {
  return code == tpm::kBadArgs ? "arguments rejected by the proto probe"
                               : cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
