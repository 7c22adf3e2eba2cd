// The walk kernels' per-thread bodies (dfa_walk.cuh), run on the CPU over
// the whole launch: thread i of the kernel grid becomes loop iteration i.
// Built with g++ (no CUDA needed), so the tests can hold the kernels'
// arithmetic to the reference without a GPU. Same arguments and outputs as
// the entry points of dfa_walk.cu, minus the stream (n_valid points to a
// host int64 here); returns 0 or tpm::kWalkBadArgs.
#include <stdint.h>

#include "dfa_walk.cuh"

namespace {

template <typename TT, typename Sym>
void window_all(const void* table, const void* data, const void* bounds,
                const void* lane, const void* row, int64_t n_valid,
                const tpm::WindowParams& p, void* rep, void* state) {
  for (int i = 0; i < p.kw; ++i)
    tpm::window_walk(static_cast<const TT*>(table),
                     static_cast<const Sym*>(data),
                     static_cast<const int32_t*>(bounds),
                     static_cast<const int32_t*>(lane),
                     static_cast<const int32_t*>(row), n_valid, p, i,
                     static_cast<uint8_t*>(rep), static_cast<int32_t*>(state));
}

template <typename TT, typename Sym>
void dense_all(const void* table, const void* data_tm, const void* bounds,
               const void* state_gid, const tpm::DenseParams& p, void* counts,
               void* slot_state, void* slot_pos, void* gcounts) {
  for (int c = 0; c < p.C; ++c)
    tpm::dense_walk_lane(static_cast<const TT*>(table),
                         static_cast<const Sym*>(data_tm),
                         static_cast<const int32_t*>(bounds),
                         static_cast<const int32_t*>(state_gid), p, c,
                         static_cast<int32_t*>(counts),
                         static_cast<int32_t*>(slot_state),
                         static_cast<int32_t*>(slot_pos),
                         static_cast<int32_t*>(gcounts));
}

template <typename TT>
void window_any(int sym16, const void* table, const void* data,
                const void* bounds, const void* lane, const void* row,
                int64_t nv, const tpm::WindowParams& p, void* rep,
                void* state) {
  if (sym16)
    window_all<TT, uint16_t>(table, data, bounds, lane, row, nv, p, rep,
                             state);
  else
    window_all<TT, uint8_t>(table, data, bounds, lane, row, nv, p, rep,
                            state);
}

template <typename TT>
void dense_any(int sym16, const void* table, const void* data_tm,
               const void* bounds, const void* state_gid,
               const tpm::DenseParams& p, void* counts, void* slot_state,
               void* slot_pos, void* gcounts) {
  if (sym16)
    dense_all<TT, uint16_t>(table, data_tm, bounds, state_gid, p, counts,
                            slot_state, slot_pos, gcounts);
  else
    dense_all<TT, uint8_t>(table, data_tm, bounds, state_gid, p, counts,
                           slot_state, slot_pos, gcounts);
}

}  // namespace

extern "C" {

int tpm_window_walk_host(const void* table, int table16, const void* data,
                         int sym16, const void* bounds, const void* lane,
                         const void* row, const void* n_valid, int C, int T,
                         int A, int q, int lmax, int halo, int kw, int WLp,
                         void* rep, void* state) {
  const tpm::WindowParams p{C, T, A, q, lmax, halo, kw, WLp};
  if (!tpm::window_params_ok(p)) return tpm::kWalkBadArgs;
  const int64_t nv = *static_cast<const int64_t*>(n_valid);
  if (table16)
    window_any<int16_t>(sym16, table, data, bounds, lane, row, nv, p, rep,
                        state);
  else
    window_any<int32_t>(sym16, table, data, bounds, lane, row, nv, p, rep,
                        state);
  return 0;
}

int tpm_dense_walk_host(const void* table, int table16, const void* data_tm,
                        int sym16, const void* bounds, const void* state_gid,
                        int T, int C, int A, int halo, int R, int G,
                        void* counts, void* slot_state, void* slot_pos,
                        void* gcounts) {
  const tpm::DenseParams p{T, C, A, halo, R, G};
  if (!tpm::dense_params_ok(p) || (gcounts && !state_gid))
    return tpm::kWalkBadArgs;
  if (table16)
    dense_any<int16_t>(sym16, table, data_tm, bounds, state_gid, p, counts,
                       slot_state, slot_pos, gcounts);
  else
    dense_any<int32_t>(sym16, table, data_tm, bounds, state_gid, p, counts,
                       slot_state, slot_pos, gcounts);
  return 0;
}

}  // extern "C"
