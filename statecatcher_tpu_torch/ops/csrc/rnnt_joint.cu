// Fused RNN-T joint -> (blank, emit) log-probs for Hopper (sm_90a), the exact
// joint over every (t, u) of the lattice: the entry points of K6.  The
// kernels are in rnnt_joint_core.cuh, which also holds the contract, the
// bound and the design.
//
// Replaces the TPU kernels of statecatcher_tpu/ops/rnnt_pallas.py:
//   K6a  joint_fwd_kernel      <- _fwd_kernel (:72), launched by _core_fwd_impl (:155)
//   K6b  joint_bwd_rows_kernel <- _bwd_kernel (:92), launched by _core_bwd (:196):
//        joint_bwd_dk_kernel      d_enc and d_pred there, d_K and d_bias here
//
// Rows r = (b*T + t)*U1 + u; blank and lse (B, T, U1), emit (B, T, U).  The
// backward's rows kernel owns patches of 16 frames x 8 label positions:
// d_enc_part (B, T, ceil(U1/8), J), d_pred_part (B, ceil(T/16), U1, J).

#include "rnnt_joint_core.cuh"

namespace {

constexpr int kPatchFrames = 16;     // bwd rows patch: 16 frames x 8 label positions

Geo exact_geo(int B, int T, int U1, int J, int V) {
  return make_geo(B, T, T, U1, U1, J, V, nullptr, 1, kPatchFrames);
}

}  // namespace

// Each returns the first cudaError_t of its launches (0 on success).  J must
// be at most 128 and blank_id in [0, V) (the wrapper checks).
extern "C" int rnnt_joint_fwd(const float* enc, const float* pred, const float* K,
                              const float* bias, const int* labels, float* blank, float* emit,
                              float* lse, int B, int T, int U1, int J, int V, int blank_id,
                              int bf, void* stream) {
  const Geo g = exact_geo(B, T, U1, J, V);
  auto s = static_cast<cudaStream_t>(stream);
  if (J <= 64)
    return launch_fwd<64>(enc, pred, K, bias, labels, g, blank_id, bf, blank, emit, lse, s);
  if (J <= 128)
    return launch_fwd<128>(enc, pred, K, bias, labels, g, blank_id, bf, blank, emit, lse, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rnnt_joint_bwd(const float* enc, const float* pred, const float* K,
                              const float* bias, const int* labels, const float* lse,
                              const float* g_blank, const float* g_emit, float* d_enc_part,
                              float* d_pred_part, float* dk_part, float* db_part, int B, int T,
                              int U1, int J, int V,
                              int blank_id, int bf, int nsplit, void* stream) {
  const Geo g = exact_geo(B, T, U1, J, V);
  auto s = static_cast<cudaStream_t>(stream);
  if (J <= 64)
    return launch_bwd<64>(enc, pred, K, bias, labels, lse, g_blank, g_emit, g, blank_id, bf,
                          nsplit, d_enc_part, d_pred_part, dk_part, db_part, s);
  if (J <= 128)
    return launch_bwd<128>(enc, pred, K, bias, labels, lse, g_blank, g_emit, g, blank_id, bf,
                           nsplit, d_enc_part, d_pred_part, dk_part, db_part, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
