// The walk kernels' per-thread bodies (dfa_walk.cuh), run on the CPU over
// the whole launch: thread i of the kernel grid becomes loop iteration i
// (the walk and emit: every slot's count, a sequential exclusive scan in
// place of the kernel's block scan and look-back, then every slot's
// events and meta; the dense walk: a lane's sub-spans in turn, then its
// merge). Built with g++ (no CUDA needed), so the tests can hold the
// kernels' arithmetic to the reference without a GPU. Same arguments and
// outputs as the entry points of dfa_walk.cu, minus the stream (the
// device scalars point to host values here), and S may pass the kernel's
// 32; returns 0 or tpm::kWalkBadArgs.
#include <vector>

#include <stdint.h>

#include "dfa_walk.cuh"

namespace {

template <typename TT, typename Sym>
void emit_all(const void* table, const void* data, const void* bounds,
              const void* lane, const void* row, const void* state_gid,
              int64_t n_valid, int64_t n_cand, int32_t base_flags,
              const tpm::WindowParams& p, int32_t* buf) {
  const tpm::EmitLayout l = tpm::emit_layout(p);
  for (int64_t e = 0; e < 2 * (int64_t)p.k_ev; ++e) buf[e] = -1;
  for (int64_t e = 2 * (int64_t)p.k_ev; e < l.total; ++e) buf[e] = 0;
  const auto* tb = static_cast<const TT*>(table);
  const auto* dt = static_cast<const Sym*>(data);
  std::vector<tpm::WindowSlot> slots(p.kw);
  std::vector<tpm::WindowReports> reports(p.kw);
  for (int i = 0; i < p.kw; ++i) {
    slots[i] = tpm::window_slot(static_cast<const int32_t*>(bounds),
                                static_cast<const int32_t*>(lane),
                                static_cast<const int32_t*>(row), n_valid, p,
                                i);
    reports[i] = tpm::window_count(tb, dt, slots[i], p);
  }
  int64_t first = 0;  // the exclusive scan of the counts
  for (int i = 0; i < p.kw; ++i) {
    if (reports[i].n)
      tpm::window_emit(tb, dt, static_cast<const int32_t*>(state_gid),
                       slots[i], reports[i], p, first, buf, buf + l.gcounts);
    first += reports[i].n;
  }
  tpm::window_meta(first, n_cand, n_valid, base_flags, p, buf + l.meta);
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
void emit_any(int sym16, const void* table, const void* data,
              const void* bounds, const void* lane, const void* row,
              const void* state_gid, int64_t nv, int64_t nc, int32_t flags,
              const tpm::WindowParams& p, int32_t* buf) {
  if (sym16)
    emit_all<TT, uint16_t>(table, data, bounds, lane, row, state_gid, nv, nc,
                           flags, p, buf);
  else
    emit_all<TT, uint8_t>(table, data, bounds, lane, row, state_gid, nv, nc,
                          flags, p, buf);
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

int tpm_emit_layout_host(int kw, int k_ev, int G, long long* out) {
  return tpm::emit_layout_out(kw, k_ev, G, out);
}

int tpm_walk_emit_host(const void* table, int table16, const void* data,
                       int sym16, const void* bounds, const void* lane,
                       const void* row, const void* state_gid,
                       const void* n_valid, const void* n_cand,
                       const void* base_flags, int C, int T, int A, int q,
                       int lmax, int halo, int kw, int WLp, int k_ev, int G,
                       void* buf, long long buf_words) {
  const tpm::WindowParams p{C, T, A, q, lmax, halo, kw, WLp, k_ev, G};
  if (!tpm::window_params_ok(p) || buf_words != tpm::emit_layout(p).total)
    return tpm::kWalkBadArgs;
  const int64_t nv = *static_cast<const int64_t*>(n_valid);
  const int64_t nc = *static_cast<const int64_t*>(n_cand);
  const int32_t fl = *static_cast<const int32_t*>(base_flags);
  auto* out = static_cast<int32_t*>(buf);
  if (table16)
    emit_any<int16_t>(sym16, table, data, bounds, lane, row, state_gid, nv,
                      nc, fl, p, out);
  else
    emit_any<int32_t>(sym16, table, data, bounds, lane, row, state_gid, nv,
                      nc, fl, p, out);
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
