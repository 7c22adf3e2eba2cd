// DFA walk kernels for Hopper (sm_90a). They replace two XLA lax.scan
// loops of the reference, which torch has no counterpart for:
//   walk_emit_kernel  <- ops/verify_device.py _verify_kernel, stages 3-5
//                        (the windowed candidate walk of device verify, the
//                        compaction of its reports to events, the group
//                        counts)
//   dense_walk_kernel <- ops/match_xla.py _scan_kernel (the dense engine's
//                        lane walk, the design of the original ahomatch.cl)
// Both take their step from tpm::dfa_step (dfa_walk.cuh), over an int16 or
// int32 signed table and uint8 or uint16 symbols (template parameters: four
// instantiations of each kernel; a ushort table has 2048 entries a state,
// so its rows are 8x as wide and a random walk touches more of it).
//
// What bounds both on this card: each step is a load from the transition
// table whose address depends on the previous step's load, so a thread is
// one chain of dependent memory accesses. The table of a 10k-pattern set
// is about 110 MB (int32, over 2^15 states) and does not fit the 50 MB L2;
// the states near the root, which random text visits most, stay cached.
//
// Walk and emit: a device-verify batch has a few thousand slots of 20-32
// steps, so the walk itself is a few microseconds of device time; what
// costs is launching. Writing every slot-step's report flag and state
// ([kw, steps], 5 B each) and compacting them, as the reference does,
// takes ~50 further launches. Here one launch does stages 3-5 with a
// single-pass chained scan:
//   - thread i walks slot i and counts its reports (window_count);
//   - a block-wide exclusive scan of the counts (warp shuffles, then the
//     warps' sums in shared memory) gives each slot its offset in the
//     block;
//   - a block publishes its aggregate, then its inclusive prefix, as one
//     64-bit word (2 flag bits, 62 value bits). Blocks take their index
//     from an atomic ticket, not blockIdx, so a block waits only on
//     blocks that already run and the look-back cannot deadlock;
//   - the block's base comes from a decoupled look-back over the blocks
//     before it, by one warp: each lane reads one predecessor's word, so
//     32 blocks cost one round trip to the L2;
//   - each thread writes its events at base + offset + j below k_ev from
//     the first kKeep reports its count walk kept in registers (a slot
//     of more reports walks its window again), adding each event's group
//     with an atomic (integer adds commute: the counts do not depend on
//     their order);
//   - the block of the last ticket knows n_events (its inclusive prefix)
//     and writes meta.
// The launch is two fills of one buffer (packed's fill and the zeroed
// counts and scratch) and this kernel.
//
// Dense walk: a lane is a chain of T dependent loads (4112 at the bench
// batch), and one thread per lane puts 4096 lanes on 32 warps. The lanes
// are cut into sub-spans, each walked from the root after a warm-up of
// max_pat_len - 1 rows (dfa_walk.cuh, dense_walk_piece): the same states,
// reports and counts. dense_plan picks the sub-spans per lane, up to 32,
// so that a launch fills the card (about 32 warps per SM at the bench
// batch, 139 steps a thread) with the warm-up under a quarter of a piece.
// A block is 32 adjacent lanes x S sub-spans, warp j on sub-span j, so a
// warp's symbol loads are 32 adjacent symbols of one row; the next row's
// symbol is loaded ahead of the table entry. Each thread keeps its
// sub-span's first R reports in a scratch buffer in device memory
// (written only on a report, which is rare on this engine's traffic;
// shared memory would cap the threads per SM at large R); after a block
// barrier a scan over the warps' counts in shared memory gives each
// sub-span its first slot, and it copies its reports that are among the
// lane's first R there. What bounds it then: each load of a warp touches
// 32 table rows, one 32-byte sector each, and the hot rows exceed the L1,
// so the L2's sector throughput (the same loads per second at both
// symbol widths on the H100).
// Group counts are added with atomics in global memory: reports are rare
// on the traffic this engine serves, and integer adds commute, so the
// result does not depend on their order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dfa_walk.cuh"

namespace {

constexpr int kBlock = tpm::kEmitBlock;  // the walk and emit
constexpr int kMaxThreads = 32 * tpm::kMaxSubspans;  // the dense walk

// A look-back word: flag in the top 2 bits, value in the low 62.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kValue = (1ull << 62) - 1;

// The events of the blocks before block b (b > 0), by warp 0 of block b
// (every lane calls it): each lane waits for the word of one of the 32
// blocks below the window's top, and the window's words are summed from
// the top down to the nearest inclusive prefix, or the next window is
// taken. The ticket order means those blocks already run, so every wait
// ends.
__device__ __forceinline__ unsigned long long look_back(
    unsigned long long* look, int b) {
  const int ln = threadIdx.x & 31;
  unsigned long long base = 0;
  for (int top = b - 1;; top -= 32) {
    const int j = top - ln;
    unsigned long long v = kInclusive;  // below block 0: an empty prefix
    if (j >= 0) {
      do {
        v = atomicAdd(&look[j], 0ull);  // a coherent read at the L2
      } while (!(v >> 62));
    }
    const unsigned incl = __ballot_sync(0xffffffffu, (v & kInclusive) != 0);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    unsigned long long x = ln <= stop ? v & kValue : 0ull;
    for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    base += x;
    if (incl) return base;
  }
}

// Thread threadIdx.x of the block with ticket b takes slot b * kBlock +
// threadIdx.x. ticket: the blocks' counter (zeroed); look: a word per
// block (zeroed).
template <typename TT, typename Sym>
__global__ void __launch_bounds__(kBlock) walk_emit_kernel(
    const TT* __restrict__ table, const Sym* __restrict__ data,
    const int32_t* __restrict__ bounds, const int32_t* __restrict__ lane,
    const int32_t* __restrict__ row, const int32_t* __restrict__ state_gid,
    const int64_t* __restrict__ n_valid, const int64_t* __restrict__ n_cand,
    const int32_t* __restrict__ base_flags, const tpm::WindowParams p,
    int32_t* __restrict__ packed, int32_t* __restrict__ gcounts,
    int32_t* __restrict__ meta, unsigned* __restrict__ ticket,
    unsigned long long* __restrict__ look) {
  __shared__ int32_t warp_sum[kBlock / 32];
  __shared__ int block_ticket;
  __shared__ long long block_base;
  const int tid = threadIdx.x, ln = tid & 31, warp = tid >> 5;
  if (tid == 0) block_ticket = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int b = block_ticket;
  const int i = b * kBlock + tid;
  const int64_t nv = *n_valid;
  tpm::WindowSlot s;
  tpm::WindowReports r;
  r.n = 0;
  if (i < p.kw) {
    s = tpm::window_slot(bounds, lane, row, nv, p, i);
    r = tpm::window_count(table, data, s, p);
  }
  int32_t incl = r.n;  // the warp's inclusive scan of the counts
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (ln >= o) incl += y;
  }
  if (ln == 31) warp_sum[warp] = incl;
  __syncthreads();
  int32_t before = 0, agg = 0;
  for (int w = 0; w < kBlock / 32; ++w) {
    const int32_t x = warp_sum[w];
    before += w < warp ? x : 0;
    agg += x;
  }
  if (warp == 0) {
    unsigned long long base = 0;
    if (b > 0) {
      if (ln == 0) atomicExch(&look[b], kAggregate | (unsigned long long)agg);
      base = look_back(look, b);
    }
    if (ln == 0) {
      const unsigned long long total = base + (unsigned long long)agg;
      atomicExch(&look[b], kInclusive | total);
      block_base = (long long)base;
      if (b == (int)gridDim.x - 1)  // the last block knows n_events
        tpm::window_meta((long long)total, *n_cand, nv, *base_flags, p,
                         meta);
    }
  }
  __syncthreads();
  if (r.n > 0)
    tpm::window_emit(table, data, state_gid, s, r, p,
                     block_base + before + incl - r.n, packed, gcounts);
}

// Thread (lane blockIdx.x * 32 + threadIdx.x % 32, sub-span threadIdx.x
// / 32) of a block of 32 * S threads.
template <typename TT, typename Sym>
__global__ void __launch_bounds__(kMaxThreads) dense_walk_kernel(
    const TT* __restrict__ table, const Sym* __restrict__ data_tm,
    const int32_t* __restrict__ bounds, const int32_t* __restrict__ state_gid,
    const tpm::DenseParams p, int32_t* __restrict__ counts,
    int32_t* __restrict__ slot_state, int32_t* __restrict__ slot_pos,
    int32_t* __restrict__ gcounts, int32_t* __restrict__ keep) {
  __shared__ int32_t n_of[tpm::kMaxSubspans][32];
  const int ln = threadIdx.x & 31, j = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + ln;
  const int32_t n =
      c < p.C ? tpm::dense_walk_piece(table, data_tm, bounds, state_gid, p,
                                      c, j, keep, gcounts)
              : 0;
  n_of[j][ln] = n;
  __syncthreads();
  if (c >= p.C) return;
  int32_t prefix = 0, total = 0;
  for (int i = 0; i < p.S; ++i) {
    const int32_t x = n_of[i][ln];
    prefix += i < j ? x : 0;
    total += x;
  }
  tpm::dense_merge_piece(p, c, j, prefix, n, keep, slot_state, slot_pos);
  if (j == 0) counts[c] = total;
}

struct EmitArgs {
  const int32_t *bounds, *lane, *row, *state_gid;
  const int64_t *n_valid, *n_cand;
  const int32_t* base_flags;
};

template <typename TT, typename Sym>
void launch_emit(const void* table, const void* data, const EmitArgs& a,
                 const tpm::WindowParams& p, const tpm::EmitLayout& l,
                 int32_t* buf, cudaStream_t s) {
  walk_emit_kernel<TT, Sym><<<l.blocks, kBlock, 0, s>>>(
      static_cast<const TT*>(table), static_cast<const Sym*>(data), a.bounds,
      a.lane, a.row, a.state_gid, a.n_valid, a.n_cand, a.base_flags, p, buf,
      buf + l.gcounts, buf + l.meta,
      reinterpret_cast<unsigned*>(buf + l.counters),
      reinterpret_cast<unsigned long long*>(buf + l.look));
}

template <typename TT, typename Sym>
void launch_dense(const void* table, const void* data_tm, const int32_t* bd,
                  const int32_t* sg, const tpm::DenseParams& p, int32_t* cn,
                  int32_t* ss, int32_t* sp, int32_t* gc, int32_t* kp,
                  cudaStream_t s) {
  dense_walk_kernel<TT, Sym><<<(p.C + 31) / 32, 32 * p.S, 0, s>>>(
      static_cast<const TT*>(table), static_cast<const Sym*>(data_tm), bd,
      sg, p, cn, ss, sp, gc, kp);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns a CUDA error code (or
// -1 for arguments the kernels do not take); it never synchronises.
// `table16` selects the int16 table, `sym16` uint16 symbols (else uint8).
//
// The one buffer of a walk-and-emit launch: tpm::emit_layout_out.
int tpm_emit_layout(int kw, int k_ev, int G, long long* out) {
  return tpm::emit_layout_out(kw, k_ev, G, out);
}

// Stages 3-5 of device verify: n_valid (the slots' count), n_cand (int64)
// and base_flags (int32) are device scalars, read by the kernel; buf
// holds tpm_emit_layout's `total` int32 words (8-byte aligned): packed
// [3, k_ev], gcounts [G], meta [5], then the scratch. Two fills and one
// kernel.
int tpm_walk_emit(const void* table, int table16, const void* data,
                  int sym16, const void* bounds, const void* lane,
                  const void* row, const void* state_gid,
                  const void* n_valid, const void* n_cand,
                  const void* base_flags, int C, int T, int A, int q,
                  int lmax, int halo, int kw, int WLp, int k_ev, int G,
                  void* buf, long long buf_words, void* stream) {
  const tpm::WindowParams p{C, T, A, q, lmax, halo, kw, WLp, k_ev, G};
  if (!tpm::window_params_ok(p)) return tpm::kWalkBadArgs;
  const tpm::EmitLayout l = tpm::emit_layout(p);
  if (buf_words != l.total || ((uintptr_t)buf & 7u)) return tpm::kWalkBadArgs;
  auto s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<int32_t*>(buf);
  int rc = (int)cudaMemsetAsync(out, 0xFF, 2 * (size_t)k_ev * 4, s);
  if (!rc)
    rc = (int)cudaMemsetAsync(out + 2 * (int64_t)k_ev, 0,
                              (size_t)(l.total - 2 * (int64_t)k_ev) * 4, s);
  if (rc) return rc;
  const EmitArgs a{static_cast<const int32_t*>(bounds),
                   static_cast<const int32_t*>(lane),
                   static_cast<const int32_t*>(row),
                   static_cast<const int32_t*>(state_gid),
                   static_cast<const int64_t*>(n_valid),
                   static_cast<const int64_t*>(n_cand),
                   static_cast<const int32_t*>(base_flags)};
  if (table16 && sym16)
    launch_emit<int16_t, uint16_t>(table, data, a, p, l, out, s);
  else if (table16)
    launch_emit<int16_t, uint8_t>(table, data, a, p, l, out, s);
  else if (sym16)
    launch_emit<int32_t, uint16_t>(table, data, a, p, l, out, s);
  else
    launch_emit<int32_t, uint8_t>(table, data, a, p, l, out, s);
  return (int)cudaGetLastError();
}

// state_gid and gcounts may be null (no group counts). S sub-spans per
// lane (tpm_dense_plan's), 1 to 32; keep: scratch of 2 * S * R * C int32.
int tpm_dense_walk(const void* table, int table16, const void* data_tm,
                   int sym16, const void* bounds, const void* state_gid,
                   int T, int C, int A, int halo, int R, int G,
                   int max_pat_len, int S, void* counts, void* slot_state,
                   void* slot_pos, void* gcounts, void* keep, void* stream) {
  const tpm::DenseParams p{T, C, A, halo, R, G, max_pat_len - 1, S};
  if (!tpm::dense_params_ok(p) || S > tpm::kMaxSubspans ||
      (gcounts && !state_gid))
    return tpm::kWalkBadArgs;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* bd = static_cast<const int32_t*>(bounds);
  const auto* sg = static_cast<const int32_t*>(state_gid);
  auto* cn = static_cast<int32_t*>(counts);
  auto* ss = static_cast<int32_t*>(slot_state);
  auto* sp = static_cast<int32_t*>(slot_pos);
  auto* gc = static_cast<int32_t*>(gcounts);
  auto* kp = static_cast<int32_t*>(keep);
  if (table16 && sym16)
    launch_dense<int16_t, uint16_t>(
        table, data_tm, bd, sg, p, cn, ss, sp, gc, kp, s);
  else if (table16)
    launch_dense<int16_t, uint8_t>(
        table, data_tm, bd, sg, p, cn, ss, sp, gc, kp, s);
  else if (sym16)
    launch_dense<int32_t, uint16_t>(
        table, data_tm, bd, sg, p, cn, ss, sp, gc, kp, s);
  else
    launch_dense<int32_t, uint8_t>(
        table, data_tm, bd, sg, p, cn, ss, sp, gc, kp, s);
  return (int)cudaGetLastError();
}

// The dense walk's plan on the current device (tpm::dense_plan with its
// SM count): out[0..3] = sub-spans per lane, steps per thread with the
// warm-up, threads per block, blocks. Returns a CUDA error code or -1.
int tpm_dense_plan(int T, int C, int halo, int max_pat_len, void* out) {
  if (T < 0 || C <= 0 || halo < 0 || max_pat_len < 1)
    return tpm::kWalkBadArgs;
  int dev = 0, n_sm = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (!rc)
    rc = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (rc) return rc;
  const tpm::DensePlan d = tpm::dense_plan(T, C, halo, max_pat_len - 1, n_sm);
  int* o = static_cast<int*>(out);
  o[0] = d.S;
  o[1] = d.steps;
  o[2] = d.threads;
  o[3] = d.blocks;
  return 0;
}

const char* tpm_walk_error_string(int code) {
  return code == tpm::kWalkBadArgs ? "arguments rejected by the walk kernel"
                                   : cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
