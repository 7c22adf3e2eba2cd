// Bloom probe kernels for Hopper (sm_90a): the survivor bitmap of one
// time-major batch.
//
// Replace the Pallas kernels of tpu_pattern_matching/ops/bloom.py:
//   probe_sampled_kernel  <- _make_sampled_kernel (winnowing-sampled probe)
//   probe_strided_kernel  <- _make_probe_kernel, packed=False (strided)
//   probe_strided_packed_kernel <- _make_probe_kernel, packed=True
// all launched by _probe_bits_jit. The reference ANDs one Pallas call per
// group of 8 banks; these kernels probe all k banks in one pass.
//
// Layout: data_tm [T, C] time-major symbols, uint8 or uint16 (the ushort
// alphabet of 2048; the sampled and strided kernels are instantiated for
// both widths, the packed kernel exists for bytes only, as in the
// reference), or for the packed kernel [T/4, C] uint32 words of 4
// little-endian bytes (stride % 4 == 0); bounds [2, C] int32 (start_t,
// end_t), words [k, v, 128] uint32. Output bits [T/(32*stride), C] int32:
// bit b of bits[w, c] is the gram starting at row (w*32 + b)*stride of
// lane c; *total += popcount of the whole bitmap (zeroed by the caller).
//
// Pattern shards (the single-device half of the reference's
// parallel/pshard.py, _sharded_hits_jit): S filters under one config probe
// one batch in S launches into one bitmap. Two flags of the entry points
// make the union on the card: or_into ORs the word already in `bits` into
// each word written (the thread that writes a word is its only reader),
// and count gates the popcount into *total. Shard 0 writes (no OR, no
// count), shards 1..S-2 OR, shard S-1 ORs and counts the union's words;
// for S = 1 the launch is the flat filter's (no OR, count).
//
// What bounds the kernels on this card is the read of the batch (each
// symbol once) and the integer work per row (the selection hash of every
// row, the window rule, the bank hashes of the tested rows); the bank
// words are random gathers. The design does about it (tile steps in
// bloom_probe.cuh):
//   - persistent blocks, a few per SM, loop over tiles of TW output words
//     x L lanes; each block stages the bank words in shared memory once
//     (opting into up to 227 KB: k8 v32 = 128 KB fits), not once per tile;
//     larger filters (up to k16 v256 = 8 MB) are read through L2;
//   - a tile's rows and their context are copied into shared memory with
//     16-byte cp.async copies, double-buffered: the next tile's copy runs
//     under this tile's work;
//   - each staged row is hashed once (sampled: its selection hash, kept
//     in shared memory); the window rule is a van Herk / Gil-Werman
//     sliding argmin, O(1) per row whatever w, with no early exits;
//   - the tested rows, then the survivors of bank 0, are compacted into
//     queues (__ballot_sync / __popc; sampled: per block, from bit masks
//     of each lane's word; strided: per warp, with no block barrier), so
//     that every lane of a warp probes; hits are set with atomicOr in a
//     shared output tile, written once, coalesced, with its popcount.
// The packed strided kernel is the strided kernel on words: its copy-in
// stages the tile's word rows (a quarter as many rows, 4 bytes a lane,
// the same 16-byte cp.async copies, skipping the word rows no gram reads)
// and its grams take their bytes out of the staged words (tile_gram), so
// it fills the card and stages the bank words once per block as the
// strided kernel does.
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "bloom_probe.cuh"

namespace {

using tpm::ProbeParams;
using tpm::TilePlan;
using tpm::TileView;

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy the tile's needed rows (packed: word rows) and its lane bounds into
// buffer b (the offsets are selected, not indexed, so the plan stays in
// registers).
template <typename Sym>
__device__ __forceinline__ void stage_tile(
    const Sym* __restrict__ data, const int32_t* __restrict__ bounds,
    const ProbeParams& p, const TilePlan& t, int sampled, int tile,
    unsigned char* smem, int b) {
  int word0, nwords, lane0, base;
  tpm::tile_place(p, t, sampled, tile, word0, nwords, lane0, base);
  const int per = tpm::rows_per_staged_row<Sym>();
  const int rows = (t.rows + per - 1) / per;
  const int cpr = t.L * (int)sizeof(Sym) / 16;  // 16-byte chunks per row
  unsigned char* buf = smem + (b ? t.off_buf[1] : t.off_buf[0]);
  for (int c = threadIdx.x; c < rows * cpr; c += blockDim.x) {
    const int i = c / cpr, k = c - i * cpr;
    const int r = base / per + i;
    if (r < 0 || r >= p.T / per ||
        !tpm::tile_row_needed(p, sampled, i * per))
      continue;
    cp_async16(buf + ((size_t)i * cpr + k) * 16,
               reinterpret_cast<const unsigned char*>(
                   data + (int64_t)r * p.C + lane0) + k * 16);
  }
  const int bc = t.L / 4;  // 16-byte chunks of L int32
  unsigned char* bd = smem + (b ? t.off_bounds[1] : t.off_bounds[0]);
  for (int c = threadIdx.x; c < 2 * bc; c += blockDim.x) {
    const int r = c / bc, k = c - r * bc;
    cp_async16(bd + c * 16, reinterpret_cast<const unsigned char*>(
                                bounds + (int64_t)r * p.C + lane0) + k * 16);
  }
  cp_async_commit();
}

// Append `entry` to the warp's own queue `q` of length `n` (the same in
// every lane) when `pred`. Every lane of the warp must call it (the loops
// that do have trip counts that are the same for the whole warp).
__device__ __forceinline__ void push_warp(uint16_t* q, int& n, bool pred,
                                          int entry) {
  const unsigned m = __ballot_sync(0xffffffffu, pred);
  const unsigned below = m & ((1u << (threadIdx.x & 31)) - 1u);
  if (pred) q[n + __popc(below)] = (uint16_t)entry;
  n += __popc(m);
}

// Append `entry` to the block's queue `q` of length *n when `pred`: one
// shared-memory atomic per warp. Every lane of the warp must call it.
__device__ __forceinline__ void push_block(uint16_t* q, int* n, bool pred,
                                           int entry) {
  const unsigned m = __ballot_sync(0xffffffffu, pred);
  if (!m) return;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0) base = atomicAdd(n, __popc(m));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (pred) q[base + __popc(m & ((1u << lane) - 1u))] = (uint16_t)entry;
}

// The sampled probe of one staged tile: the winnowing marks, then steps A,
// B and C with block-wide queues (queue 1 over the dead prefix/suffix
// arrays, queue 2 over the dead selection hashes).
template <typename Sym>
__device__ __forceinline__ void sampled_tile(const TileView<Sym>& v,
                                             const uint32_t* wp,
                                             const ProbeParams& p,
                                             const TilePlan& t,
                                             unsigned char* smem,
                                             uint32_t* out) {
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31;
  int* cnt = reinterpret_cast<int*>(smem + t.off_cnt);
  for (int i = tid; i < t.n_blocks * t.L; i += nthr)
    tpm::tile_block_hash(v, p, i);
  __syncthreads();
  const int windows = (tpm::kWordRows * t.TW + p.w - 1) * t.L;
  for (int i = tid; i < windows; i += nthr) {
    const int r = tpm::tile_window_argmin(v, p, i);
    if (r >= 0)
      atomicOr(&v.mark[((r >> 5) << t.lshift) + (i & (t.L - 1))],
               1u << (r & 31));
  }
  __syncthreads();
  uint16_t* q1 = reinterpret_cast<uint16_t*>(smem + t.off_q1);
  uint16_t* q2 = reinterpret_cast<uint16_t*>(smem + t.off_q2);
  const int items = v.nwords * t.L;
  for (int i0 = 0; i0 < items; i0 += nthr) {  // A: masks -> queue 1
    const int i = i0 + tid;
    uint32_t m = i < items ? tpm::tile_tested_mask(v, p, i) : 0u;
    const int n = __popc(m);
    int incl = n;  // the warp's inclusive scan of the counts
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    int base = 0;
    if (lane == 31 && incl) base = atomicAdd(&cnt[0], incl);
    base = __shfl_sync(0xffffffffu, base, 31) + incl - n;
    const int tw = (i >> t.lshift) * tpm::kWordRows, ln = i & (t.L - 1);
    for (; m; m &= m - 1u)
      q1[base++] = (uint16_t)(((tw + __ffs(m) - 1) << t.lshift) + ln);
  }
  __syncthreads();
  const int n1 = cnt[0];  // B: bank 0 -> queue 2
  for (int i0 = 0; i0 < n1; i0 += nthr) {
    const int i = i0 + tid;
    const int e = i < n1 ? q1[i] : 0;
    push_block(q2, &cnt[1], i < n1 && tpm::tile_probe(v, wp, p, 1, e, 0, 1),
               e);
  }
  __syncthreads();
  const int n2 = cnt[1];  // C: banks 1..k-1 -> the output words
  for (int i = tid; i < n2; i += nthr) {
    const int e = q2[i];
    if (tpm::tile_probe(v, wp, p, 1, e, 1, p.kbanks))
      atomicOr(&out[((e >> t.lshift >> 5) << t.lshift) + (e & (t.L - 1))],
               1u << ((e >> t.lshift) & 31));
  }
}

// The strided probe of one staged tile (one output word): each warp takes
// a fixed share of the word's (row, lane) pairs and runs steps B and C on
// them with a queue of its own, with no block barrier.
template <typename Sym>
__device__ __forceinline__ void strided_tile(const TileView<Sym>& v,
                                             const uint32_t* wp,
                                             const ProbeParams& p,
                                             const TilePlan& t,
                                             unsigned char* smem,
                                             uint32_t* out) {
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31;
  const int pairs = tpm::kWordRows * t.L;  // a multiple of the block size
  uint16_t* q2 = reinterpret_cast<uint16_t*>(smem + t.off_q2) +
                 (tid >> 5) * (pairs / nthr * 32);
  int n2 = 0;
  for (int i = tid; i < pairs; i += nthr)  // B: bank 0 -> queue 2
    push_warp(q2, n2,
              tpm::tile_strided_valid(v, p, 0, i) &&
                  tpm::tile_probe(v, wp, p, 0, i, 0, 1),
              i);
  __syncwarp();
  for (int i = lane; i < n2; i += 32) {  // C: banks 1..k-1 -> out
    const int e = q2[i];
    if (tpm::tile_probe(v, wp, p, 0, e, 1, p.kbanks))
      atomicOr(&out[e & (t.L - 1)], 1u << (e >> t.lshift));
  }
}

// The sampled (SAMPLED) or strided probe over all tiles of the launch
// (Sym = uint32_t: the packed layout of bytes, strided); the barriers
// around a tile: staged; marks and output zeroed; output complete.
template <bool SAMPLED, typename Sym>
__device__ __forceinline__ void probe_tiles(
    const Sym* __restrict__ data, const int32_t* __restrict__ bounds,
    const uint32_t* __restrict__ words, int32_t* __restrict__ bits,
    int32_t* __restrict__ total, const ProbeParams& p, const TilePlan& t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const uint32_t* wp = words;
  if (t.words_in_smem) {
    const int n4 = p.kbanks * p.v * 128 / 4;
    uint4* dst = reinterpret_cast<uint4*>(smem);
    const uint4* src = reinterpret_cast<const uint4*>(words);
    for (int i = tid; i < n4; i += nthr) dst[i] = src[i];
    wp = reinterpret_cast<const uint32_t*>(smem);
  }
  uint32_t* out = reinterpret_cast<uint32_t*>(smem + t.off_out);
  unsigned ones = 0;
  int tile = blockIdx.x;
  if (tile < t.n_tiles) stage_tile(data, bounds, p, t, SAMPLED, tile, smem, 0);
  for (int it = 0; tile < t.n_tiles; ++it, tile += gridDim.x) {
    const int b = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile staged; the other buffer's readers are done
    if (tile + (int)gridDim.x < t.n_tiles)
      stage_tile(data, bounds, p, t, SAMPLED, tile + gridDim.x, smem, b ^ 1);
    TileView<Sym> v;
    v.buf = reinterpret_cast<const Sym*>(
        smem + (b ? t.off_buf[1] : t.off_buf[0]));
    v.start = reinterpret_cast<const int32_t*>(
        smem + (b ? t.off_bounds[1] : t.off_bounds[0]));
    v.end = v.start + t.L;
    v.sel = reinterpret_cast<uint32_t*>(smem + t.off_sel);
    v.pre = smem + t.off_pre;
    v.suf = smem + t.off_suf;
    v.mark = reinterpret_cast<uint32_t*>(smem + t.off_mark);
    v.L = t.L;
    v.lshift = t.lshift;
    v.hrows = t.hrows;
    tpm::tile_place(p, t, SAMPLED, tile, v.word0, v.nwords, v.lane0, v.base);
    for (int i = tid; i < t.TW * t.L; i += nthr) out[i] = 0u;
    if constexpr (SAMPLED) {
      for (int i = tid; i < t.TW * t.L; i += nthr) v.mark[i] = 0u;
      if (tid == 0) {
        reinterpret_cast<int*>(smem + t.off_cnt)[0] = 0;
        reinterpret_cast<int*>(smem + t.off_cnt)[1] = 0;
      }
    }
    __syncthreads();
    if constexpr (SAMPLED)
      sampled_tile(v, wp, p, t, smem, out);
    else
      strided_tile(v, wp, p, t, smem, out);
    __syncthreads();
    // the OR reads the word it writes (one thread owns each word: no
    // race); a loop of its own, so the flat launch's loop tests no flag
    if (p.or_into) {
      for (int i = tid; i < v.nwords * t.L; i += nthr) {
        const int w = i >> t.lshift, ln = i & (t.L - 1);
        int32_t* at = bits + (int64_t)(v.word0 + w) * p.C + v.lane0 + ln;
        const uint32_t acc = out[i] | (uint32_t)*at;
        *at = (int32_t)acc;
        ones += __popc(acc);
      }
    } else {
      for (int i = tid; i < v.nwords * t.L; i += nthr) {
        const int w = i >> t.lshift, ln = i & (t.L - 1);
        const uint32_t acc = out[i];
        bits[(int64_t)(v.word0 + w) * p.C + v.lane0 + ln] = (int32_t)acc;
        ones += __popc(acc);
      }
    }
  }
  ones = __reduce_add_sync(0xffffffffu, ones);
  if ((tid & 31) == 0 && ones && p.count) atomicAdd(total, (int32_t)ones);
}

template <typename Sym>
__global__ void __launch_bounds__(kMaxThreads) probe_sampled_kernel(
    const Sym* __restrict__ data, const int32_t* __restrict__ bounds,
    const uint32_t* __restrict__ words, int32_t* __restrict__ bits,
    int32_t* __restrict__ total, const ProbeParams p, const TilePlan t) {
  probe_tiles<true, Sym>(data, bounds, words, bits, total, p, t);
}

template <typename Sym>
__global__ void __launch_bounds__(kMaxThreads) probe_strided_kernel(
    const Sym* __restrict__ data, const int32_t* __restrict__ bounds,
    const uint32_t* __restrict__ words, int32_t* __restrict__ bits,
    int32_t* __restrict__ total, const ProbeParams p, const TilePlan t) {
  probe_tiles<false, Sym>(data, bounds, words, bits, total, p, t);
}

__global__ void __launch_bounds__(kMaxThreads) probe_strided_packed_kernel(
    const uint32_t* __restrict__ data, const int32_t* __restrict__ bounds,
    const uint32_t* __restrict__ words, int32_t* __restrict__ bits,
    int32_t* __restrict__ total, const ProbeParams p, const TilePlan t) {
  probe_tiles<false, uint32_t>(data, bounds, words, bits, total, p, t);
}

// What a launch asks of the runtime, asked once and kept (the host's
// launch cost): per device, its opt-in shared memory per block and its SM
// count; per device and kernel, the dynamic shared memory it has opted
// into; per device, kernel, shared memory and block size, the blocks an SM
// holds. Callers may launch from several threads.
struct Device {
  int dev, optin, n_sm;
};
std::mutex g_mu;
std::map<int, Device> g_devices;
std::map<std::pair<int, const void*>, int> g_opted;
std::map<std::tuple<int, const void*, int, int>, int> g_per_sm;

int current_device(Device& d) {
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc) return rc;
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_devices.find(dev);
  if (it == g_devices.end()) {
    Device n{dev, 0, 0};
    rc = (int)cudaDeviceGetAttribute(
        &n.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (!rc)
      rc = (int)cudaDeviceGetAttribute(&n.n_sm,
                                       cudaDevAttrMultiProcessorCount, dev);
    if (rc) return rc;
    it = g_devices.emplace(dev, n).first;
  }
  d = it->second;
  return 0;
}

// sym_bytes: 1 or 2, or 4 for the packed layout of bytes
int plan_for(const ProbeParams& p, int sampled, int sym_bytes,
             const Device& d, TilePlan& t) {
  const long budget =
      d.optin < tpm::kSmemPerBlock ? d.optin : tpm::kSmemPerBlock;
  return tpm::plan_tiles(p, sampled, sym_bytes, budget, t);
}

template <typename Sym>
using TiledKernel = void (*)(const Sym*, const int32_t*, const uint32_t*,
                             int32_t*, int32_t*, const ProbeParams,
                             const TilePlan);

// Opt into the plan's shared memory (checked like the launch; the kernel
// keeps the most it has opted into) and size a grid of the blocks the card
// holds at once, at most one per tile.
int grid_for(const void* kernel, const TilePlan& t, const Device& d,
             int& grid) {
  std::lock_guard<std::mutex> lock(g_mu);
  int& opted = g_opted[{d.dev, kernel}];
  if (t.smem > opted) {
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, t.smem);
    if (rc) return rc;
    opted = t.smem;
  }
  const auto key = std::make_tuple(d.dev, kernel, t.smem, t.threads);
  auto it = g_per_sm.find(key);
  if (it == g_per_sm.end()) {
    int per_sm = 0;
    const int rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, t.threads, t.smem);
    if (rc) return rc;
    it = g_per_sm.emplace(key, per_sm).first;
  }
  const int per_sm = it->second;
  if (per_sm < 1) return tpm::kBadArgs;
  grid = t.n_tiles < per_sm * d.n_sm ? t.n_tiles : per_sm * d.n_sm;
  return 0;
}

template <typename Sym>
int launch_tiled(TiledKernel<Sym> kernel, const void* data,
                 const int32_t* bd, const uint32_t* wd, int32_t* out,
                 int32_t* tot, const ProbeParams& p, const TilePlan& t,
                 const Device& d, cudaStream_t s) {
  int grid = 0;
  const int rc = grid_for((const void*)kernel, t, d, grid);
  if (rc) return rc;
  kernel<<<grid, t.threads, t.smem, s>>>(static_cast<const Sym*>(data), bd,
                                          wd, out, tot, p, t);
  return (int)cudaGetLastError();
}

bool aligned16(const void* a, const void* b, const void* c) {
  return !(((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) & 15u);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns a CUDA error code
// (or -1 for arguments the kernels do not take); it never synchronises.
// `sym16` selects uint16 symbols (else uint8); the packed kernel takes
// bytes only. `or_into` and `count` are the pattern-shard flags (top of
// the file); 0 and 1 for a flat filter.
int tpm_probe_sampled(const void* data, const void* bounds, const void* words,
                      void* bits, void* total, int T, int C, int q,
                      int kbanks, int v, int w, int fold, int sym16,
                      int or_into, int count, const void* mix1,
                      const void* mix2, void* stream) {
  ProbeParams p;
  TilePlan t;
  if (tpm::fill_params(p, T, C, q, 1, kbanks, v, w, fold,
                       static_cast<const int64_t*>(mix1),
                       static_cast<const int64_t*>(mix2)) ||
      w < 1 || !aligned16(data, bounds, words))
    return tpm::kBadArgs;
  p.or_into = or_into;
  p.count = count;
  Device d;
  int rc = current_device(d);
  if (!rc) rc = plan_for(p, 1, sym16 ? 2 : 1, d, t);
  if (rc) return rc;
  const auto* bd = static_cast<const int32_t*>(bounds);
  const auto* wd = static_cast<const uint32_t*>(words);
  auto* out = static_cast<int32_t*>(bits);
  auto* tot = static_cast<int32_t*>(total);
  auto s = static_cast<cudaStream_t>(stream);
  if (sym16)
    return launch_tiled<uint16_t>(probe_sampled_kernel<uint16_t>, data, bd,
                                  wd, out, tot, p, t, d, s);
  return launch_tiled<uint8_t>(probe_sampled_kernel<uint8_t>, data, bd, wd,
                               out, tot, p, t, d, s);
}

int tpm_probe_strided(const void* data, const void* bounds, const void* words,
                      void* bits, void* total, int T, int C, int q,
                      int stride, int kbanks, int v, int fold, int sym16,
                      int or_into, int count, const void* mix1,
                      const void* mix2, void* stream) {
  ProbeParams p;
  TilePlan t;
  if (tpm::fill_params(p, T, C, q, stride, kbanks, v, 0, fold,
                       static_cast<const int64_t*>(mix1),
                       static_cast<const int64_t*>(mix2)) ||
      !aligned16(data, bounds, words))
    return tpm::kBadArgs;
  p.or_into = or_into;
  p.count = count;
  Device d;
  int rc = current_device(d);
  if (!rc) rc = plan_for(p, 0, sym16 ? 2 : 1, d, t);
  if (rc) return rc;
  const auto* bd = static_cast<const int32_t*>(bounds);
  const auto* wd = static_cast<const uint32_t*>(words);
  auto* out = static_cast<int32_t*>(bits);
  auto* tot = static_cast<int32_t*>(total);
  auto s = static_cast<cudaStream_t>(stream);
  if (sym16)
    return launch_tiled<uint16_t>(probe_strided_kernel<uint16_t>, data, bd,
                                  wd, out, tot, p, t, d, s);
  return launch_tiled<uint8_t>(probe_strided_kernel<uint8_t>, data, bd, wd,
                               out, tot, p, t, d, s);
}

// T counts symbol rows (4 per row of the packed data).
int tpm_probe_strided_packed(const void* data, const void* bounds,
                             const void* words, void* bits, void* total,
                             int T, int C, int q, int stride, int kbanks,
                             int v, int fold, int sym16, int or_into,
                             int count, const void* mix1, const void* mix2,
                             void* stream) {
  ProbeParams p;
  TilePlan t;
  if (tpm::fill_params(p, T, C, q, stride, kbanks, v, 0, fold,
                       static_cast<const int64_t*>(mix1),
                       static_cast<const int64_t*>(mix2)) ||
      stride % 4 || q > stride || sym16 || !aligned16(data, bounds, words))
    return tpm::kBadArgs;
  p.or_into = or_into;
  p.count = count;
  Device d;
  int rc = current_device(d);
  if (!rc) rc = plan_for(p, 0, 4, d, t);
  if (rc) return rc;
  return launch_tiled<uint32_t>(
      probe_strided_packed_kernel, data, static_cast<const int32_t*>(bounds),
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(bits),
      static_cast<int32_t*>(total), p, t, d,
      static_cast<cudaStream_t>(stream));
}

// The launch plan of the sampled (sampled=1) or strided kernel on this
// device: out[0..6] = lanes per tile, output words per tile, tiles, bank
// words in shared memory (1/0), dynamic shared memory bytes, threads per
// block, blocks (the grid). layout: 0 uint8, 1 uint16 symbols, 2 the
// packed layout of bytes (strided, stride % 4 == 0). Returns a CUDA error
// code or -1.
int tpm_probe_plan(int sampled, int T, int C, int q, int stride, int kbanks,
                   int v, int w, int layout, void* out) {
  ProbeParams p;
  TilePlan t;
  int64_t zeros[tpm::kMaxQ] = {0};
  if (tpm::fill_params(p, T, C, q, sampled ? 1 : stride, kbanks, v,
                       sampled ? w : 0, 0, zeros, zeros) ||
      (sampled && w < 1) || layout < 0 || layout > 2 ||
      (layout == 2 && (sampled || stride % 4 || q > stride)))
    return tpm::kBadArgs;
  int grid = 0;
  Device d;
  int rc = current_device(d);
  if (!rc) rc = plan_for(p, sampled, layout == 2 ? 4 : layout + 1, d, t);
  const void* kernel =
      layout == 2 ? (const void*)probe_strided_packed_kernel
      : sampled   ? (layout ? (const void*)probe_sampled_kernel<uint16_t>
                            : (const void*)probe_sampled_kernel<uint8_t>)
                  : (layout ? (const void*)probe_strided_kernel<uint16_t>
                            : (const void*)probe_strided_kernel<uint8_t>);
  if (!rc) rc = grid_for(kernel, t, d, grid);
  if (rc) return rc;
  int* o = static_cast<int*>(out);
  o[0] = t.L;
  o[1] = t.TW;
  o[2] = t.n_tiles;
  o[3] = t.words_in_smem;
  o[4] = t.smem;
  o[5] = t.threads;
  o[6] = grid;
  return 0;
}

}  // extern "C"

extern "C" const char* tpm_error_string(int code) {
  return code == tpm::kBadArgs ? "arguments rejected by the probe kernel"
                               : cudaGetErrorString((cudaError_t)code);
}
