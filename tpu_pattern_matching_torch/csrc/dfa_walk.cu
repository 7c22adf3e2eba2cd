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
// Mapping: one thread per candidate slot (window walk) or per lane (dense
// walk), 128 threads per block. What bounds both on this card: each step
// is a load from the transition table whose address depends on the
// previous step's load, so a thread is one chain of dependent memory
// accesses (latency, not bandwidth). The table of a 10k-pattern set is
// about 110 MB (int32, over 2^15 states) and does not fit the 50 MB L2;
// states near the root, which random text visits most, stay cached. The
// design leans on many threads in flight to hide that latency; at 4096
// lanes the dense walk has about one warp per SM and stays latency-bound.
// Group counts are added with atomics in global memory: reports are rare
// on the traffic this engine serves, and integer adds commute, so the
// result does not depend on their order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dfa_walk.cuh"

namespace {

constexpr int kBlock = 128;

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

template <typename TT, typename Sym>
__global__ void __launch_bounds__(kBlock) dense_walk_kernel(
    const TT* __restrict__ table, const Sym* __restrict__ data_tm,
    const int32_t* __restrict__ bounds, const int32_t* __restrict__ state_gid,
    const tpm::DenseParams p, int32_t* __restrict__ counts,
    int32_t* __restrict__ slot_state, int32_t* __restrict__ slot_pos,
    int32_t* __restrict__ gcounts) {
  const int c = blockIdx.x * kBlock + threadIdx.x;
  if (c >= p.C) return;
  tpm::dense_walk_lane(table, data_tm, bounds, state_gid, p, c, counts,
                       slot_state, slot_pos, gcounts);
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
                  int32_t* ss, int32_t* sp, int32_t* gc, cudaStream_t s) {
  dense_walk_kernel<TT, Sym><<<blocks(p.C), kBlock, 0, s>>>(
      static_cast<const TT*>(table), static_cast<const Sym*>(data_tm), bd,
      sg, p, cn, ss, sp, gc);
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

// state_gid and gcounts may be null (no group counts).
int tpm_dense_walk(const void* table, int table16, const void* data_tm,
                   int sym16, const void* bounds, const void* state_gid,
                   int T, int C, int A, int halo, int R, int G, void* counts,
                   void* slot_state, void* slot_pos, void* gcounts,
                   void* stream) {
  const tpm::DenseParams p{T, C, A, halo, R, G};
  if (!tpm::dense_params_ok(p) || (gcounts && !state_gid))
    return tpm::kWalkBadArgs;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* bd = static_cast<const int32_t*>(bounds);
  const auto* sg = static_cast<const int32_t*>(state_gid);
  auto* cn = static_cast<int32_t*>(counts);
  auto* ss = static_cast<int32_t*>(slot_state);
  auto* sp = static_cast<int32_t*>(slot_pos);
  auto* gc = static_cast<int32_t*>(gcounts);
  if (table16 && sym16)
    launch_dense<int16_t, uint16_t>(
        table, data_tm, bd, sg, p, cn, ss, sp, gc, s);
  else if (table16)
    launch_dense<int16_t, uint8_t>(
        table, data_tm, bd, sg, p, cn, ss, sp, gc, s);
  else if (sym16)
    launch_dense<int32_t, uint16_t>(
        table, data_tm, bd, sg, p, cn, ss, sp, gc, s);
  else
    launch_dense<int32_t, uint8_t>(
        table, data_tm, bd, sg, p, cn, ss, sp, gc, s);
  return (int)cudaGetLastError();
}

const char* tpm_walk_error_string(int code) {
  return code == tpm::kWalkBadArgs ? "arguments rejected by the walk kernel"
                                   : cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
