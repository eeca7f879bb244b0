// Fused RNN-T joint -> (blank, emit) log-probs for Hopper (sm_90a), the exact
// joint over every (t, u) of the lattice: the entry points of K6.  The
// kernels are in rnnt_joint_core.cuh, which also holds the contract, the
// bound and the design.
//
// Replaces the TPU kernels of statecatcher_tpu/ops/rnnt_pallas.py:
//   K6a  joint_kprep_kernel, joint_fwd_mma_kernel
//        <- _fwd_kernel (:72), launched by _core_fwd_impl (:155)
//   K6b  joint_kprep_kernel, joint_bwd_rows_mma_kernel (d_enc, d_pred),
//        joint_bwd_rowrec_kernel, joint_bwd_dk_mma_kernel (d_K, d_bias)
//        <- _bwd_kernel (:92), launched by _core_bwd (:196)
//
//   (J > 128, the tiled products: joint_wide_prep_kernel, joint_wide_joint_kernel,
//   joint_wide_gemm_kernel, then joint_wide_lse_kernel in K6a, joint_wide_denc_kernel
//   and joint_wide_dpred_kernel in K6b)
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

// Each returns the first cudaError_t of its launches (0 on success).
// blank_id lies in [0, V) (the wrapper checks).  Above J = 128 kop is the
// tiled products' scratch (rnnt_joint_core.cuh's WideScratch) and rec unused.
extern "C" int rnnt_joint_fwd(const float* enc, const float* pred, const float* K,
                              const float* bias, const float* ke, const float* be, void* kop,
                              float* blank, float* emit, float* lse, int B, int T, int U1, int J,
                              int V, int blank_id, int bf, void* stream) {
  return launch_fwd(enc, pred, K, bias, ke, be, exact_geo(B, T, U1, J, V), blank_id, bf, kop,
                    blank, emit, lse, static_cast<cudaStream_t>(stream));
}

extern "C" int rnnt_joint_bwd(const float* enc, const float* pred, const float* K,
                              const float* bias, const int* labels, const float* lse,
                              const float* g_blank, const float* g_emit, float* d_enc_part,
                              float* d_pred_part, float* dk_part, float* db_part, int* rec,
                              void* kop, int B, int T, int U1, int J, int V, int blank_id, int bf,
                              int nsplit, void* stream) {
  return launch_bwd(enc, pred, K, bias, labels, lse, g_blank, g_emit, exact_geo(B, T, U1, J, V),
                    blank_id, bf, nsplit, rec, kop, d_enc_part, d_pred_part, dk_part, db_part,
                    static_cast<cudaStream_t>(stream));
}

// The sizes at this J, V and dtype (rnnt_joint_core.cuh's joint_sizes):
// out[0] d_K blocks per SM, out[1] words of K's operand form
extern "C" int rnnt_joint_sizes(int J, int V, int bf, int* out) {
  return joint_sizes(J, V, bf, out);
}
