// The walk kernels' per-thread bodies (dfa_walk.cuh), run on the CPU over
// the whole launch: thread i of the kernel grid becomes loop iteration i
// (the dense walk: a lane's sub-spans in turn, then its merge). Built with
// g++ (no CUDA needed), so the tests can hold the kernels' arithmetic to
// the reference without a GPU. Same arguments and outputs as the entry
// points of dfa_walk.cu, minus the stream (n_valid points to a host int64
// here), and S may pass the kernel's 32; returns 0 or tpm::kWalkBadArgs.
#include <vector>

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
               void* slot_state, void* slot_pos, void* gcounts, void* keep) {
  auto* kp = static_cast<int32_t*>(keep);
  std::vector<int32_t> n(p.S);
  for (int c = 0; c < p.C; ++c) {
    for (int j = 0; j < p.S; ++j)
      n[j] = tpm::dense_walk_piece(static_cast<const TT*>(table),
                                   static_cast<const Sym*>(data_tm),
                                   static_cast<const int32_t*>(bounds),
                                   static_cast<const int32_t*>(state_gid), p,
                                   c, j, kp, static_cast<int32_t*>(gcounts));
    int32_t prefix = 0;
    for (int j = 0; j < p.S; ++j) {
      tpm::dense_merge_piece(p, c, j, prefix, n[j], kp,
                             static_cast<int32_t*>(slot_state),
                             static_cast<int32_t*>(slot_pos));
      prefix += n[j];
    }
    static_cast<int32_t*>(counts)[c] = prefix;
  }
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
               void* slot_pos, void* gcounts, void* keep) {
  if (sym16)
    dense_all<TT, uint16_t>(table, data_tm, bounds, state_gid, p, counts,
                            slot_state, slot_pos, gcounts, keep);
  else
    dense_all<TT, uint8_t>(table, data_tm, bounds, state_gid, p, counts,
                           slot_state, slot_pos, gcounts, keep);
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
                        int max_pat_len, int S, void* counts,
                        void* slot_state, void* slot_pos, void* gcounts,
                        void* keep) {
  const tpm::DenseParams p{T, C, A, halo, R, G, max_pat_len - 1, S};
  if (!tpm::dense_params_ok(p) || (gcounts && !state_gid))
    return tpm::kWalkBadArgs;
  if (table16)
    dense_any<int16_t>(sym16, table, data_tm, bounds, state_gid, p, counts,
                       slot_state, slot_pos, gcounts, keep);
  else
    dense_any<int32_t>(sym16, table, data_tm, bounds, state_gid, p, counts,
                       slot_state, slot_pos, gcounts, keep);
  return 0;
}

// tpm::dense_plan for a card of n_sm SMs: out[0..3] as tpm_dense_plan's.
int tpm_dense_plan_host(int T, int C, int halo, int max_pat_len, int n_sm,
                        void* out) {
  if (T < 0 || C <= 0 || halo < 0 || max_pat_len < 1 || n_sm < 1)
    return tpm::kWalkBadArgs;
  const tpm::DensePlan d = tpm::dense_plan(T, C, halo, max_pat_len - 1, n_sm);
  int* o = static_cast<int*>(out);
  o[0] = d.S;
  o[1] = d.steps;
  o[2] = d.threads;
  o[3] = d.blocks;
  return 0;
}

}  // extern "C"
