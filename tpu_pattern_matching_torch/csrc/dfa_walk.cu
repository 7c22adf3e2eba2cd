// DFA walk kernels for Hopper (sm_90a). They replace two XLA lax.scan
// loops of the reference, which torch has no counterpart for:
//   window_walk_kernel <- ops/verify_device.py _verify_kernel, stage 3
//                         (the windowed candidate walk of device verify)
//   dense_walk_kernel  <- ops/match_xla.py _scan_kernel (the dense engine's
//                         lane walk, the design of the original ahomatch.cl)
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
// Window walk: one thread per candidate slot, 128 threads per block; a
// launch is short (tens of steps a slot) and launch-bound.
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

constexpr int kBlock = 128;  // the window walk
constexpr int kMaxThreads = 32 * tpm::kMaxSubspans;  // the dense walk

template <typename TT, typename Sym>
__global__ void __launch_bounds__(kBlock) window_walk_kernel(
    const TT* __restrict__ table, const Sym* __restrict__ data,
    const int32_t* __restrict__ bounds, const int32_t* __restrict__ lane,
    const int32_t* __restrict__ row, const int64_t* __restrict__ n_valid,
    const tpm::WindowParams p, uint8_t* __restrict__ rep,
    int32_t* __restrict__ state) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= p.kw) return;
  tpm::window_walk(table, data, bounds, lane, row, *n_valid, p, i, rep,
                   state);
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

int blocks(int n) { return (n + kBlock - 1) / kBlock; }

template <typename TT, typename Sym>
void launch_window(const void* table, const void* data, const int32_t* bd,
                   const int32_t* ln, const int32_t* rw, const int64_t* nv,
                   const tpm::WindowParams& p, uint8_t* rp, int32_t* st,
                   cudaStream_t s) {
  window_walk_kernel<TT, Sym><<<blocks(p.kw), kBlock, 0, s>>>(
      static_cast<const TT*>(table), static_cast<const Sym*>(data), bd, ln,
      rw, nv, p, rp, st);
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

// Each entry point launches on `stream` and returns cudaGetLastError()
// (or -1 for arguments the kernels do not take); it never synchronises.
// `table16` selects the int16 table, `sym16` uint16 symbols (else uint8);
// n_valid points to an int64 on the device (the compaction's count, read
// by every thread).
int tpm_window_walk(const void* table, int table16, const void* data,
                    int sym16, const void* bounds, const void* lane,
                    const void* row, const void* n_valid, int C, int T,
                    int A, int q, int lmax, int halo, int kw, int WLp,
                    void* rep, void* state, void* stream) {
  const tpm::WindowParams p{C, T, A, q, lmax, halo, kw, WLp};
  if (!tpm::window_params_ok(p)) return tpm::kWalkBadArgs;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* bd = static_cast<const int32_t*>(bounds);
  const auto* ln = static_cast<const int32_t*>(lane);
  const auto* rw = static_cast<const int32_t*>(row);
  const auto* nv = static_cast<const int64_t*>(n_valid);
  auto* rp = static_cast<uint8_t*>(rep);
  auto* st = static_cast<int32_t*>(state);
  if (table16 && sym16)
    launch_window<int16_t, uint16_t>(
        table, data, bd, ln, rw, nv, p, rp, st, s);
  else if (table16)
    launch_window<int16_t, uint8_t>(
        table, data, bd, ln, rw, nv, p, rp, st, s);
  else if (sym16)
    launch_window<int32_t, uint16_t>(
        table, data, bd, ln, rw, nv, p, rp, st, s);
  else
    launch_window<int32_t, uint8_t>(
        table, data, bd, ln, rw, nv, p, rp, st, s);
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
