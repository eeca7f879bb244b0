// Banded RNN-T joint -> (blank, emit) log-probs for Hopper (sm_90a): K6's
// joint restricted to a width-Wp window of label positions per (b, time
// block).  The forward and backward kernels are rnnt_joint_core.cuh's (with
// the contract, the bound and the design); this file adds the band's row
// geometry and the d_pred reduction over overlapping windows.
//
// Replaces the TPU kernels of statecatcher_tpu/ops/rnnt_band.py:
//   K8a  joint_kprep_kernel, joint_fwd_mma_kernel
//        <- _fwd_kernel (:80), launched by _banded_fwd_impl (:157)
//   K8b  joint_kprep_kernel, joint_bwd_rows_mma_kernel, joint_bwd_rowrec_kernel,
//        joint_bwd_dk_mma_kernel, band_dpred_kernel
//        <- _bwd_kernel (:100), launched by _banded_core_bwd (:206)
//
//   o      (B, nblk) int32 band starts, nblk = Tp/Tb: 8-aligned, >= 0,
//          non-decreasing along the blocks, o + Wp <= round_up(max(U1, Wp), 8)
//   rows   r = (b*Tp + t)*Wp + w at label position u = o[b, t/Tb] + w;
//          frames t >= T read enc as 0, positions u >= U1 read pred as 0,
//          positions u >= U select no label column (emit = -lse there)
//   fwd:   blank, emit, lse (B, Tp, Wp) f32
//   bwd:   g_blank, g_emit (B, Tp, Wp) -> d_enc_part (B, Tp, 2*ceil(Wp/16), J),
//          d_pred (B, U1, J), dk_part (nsplit, J, V), db_part (nsplit, V).
//          The rows kernel owns patches of 8 frames x 16 positions; with Tb a
//          multiple of 8 a patch lies in one time block and shares its band
//          start, so its d_pred partial (B, Tp/8, Wp, J) is in that window's
//          coordinates.  Windows of neighbouring blocks overlap (o does not
//          decrease by less than Wp), so band_dpred_kernel sums, per
//          (b, u, j), the partials of the patches whose window holds u, in
//          patch order: deterministic, no atomics (the TPU kernel added each
//          block's rows into its resident d_pred block in grid order).
//
// Bound on the card: operations, as K6 at R = B*Tp*Wp rows.  The d_pred
// reduction reads the partial once, 79 MB at B=32, Tp=1600, Wp=48, J=64:
// ~0.02 ms.

#include "rnnt_joint_core.cuh"

namespace {

constexpr int kBandPatchFrames = 8;  // bwd rows patch: 8 frames x 16 positions

Geo band_geo(int B, int T, int U1, int J, int V, const int* o, int Tp, int Wp, int Tb) {
  return make_geo(B, T, Tp, Wp, U1, J, V, o, Tb, kBandPatchFrames);
}

bool band_ok(int Tp, int Wp, int Tb) {
  return Tb > 0 && Tb % kBandPatchFrames == 0 && Tp % Tb == 0 && Wp > 0 && Wp % 8 == 0;
}

// d_pred[b, u, j] = sum over the patches p whose window holds u of
// d_pred_part[b, p, u - o_p, j], o_p the band start of patch p's block
__global__ void band_dpred_kernel(const float* __restrict__ part, const int* __restrict__ o,
                                  float* __restrict__ d_pred, int U1, int J, int W, int nP,
                                  int Tb, int nblk) {
  const int b = blockIdx.y;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(U1) * J) return;
  const int u = static_cast<int>(e / J), j = static_cast<int>(e % J);
  const int* ob = o + static_cast<size_t>(b) * nblk;
  float s = 0.0f;
  for (int p = 0; p < nP; ++p) {
    const int w = u - ob[(p * kBandPatchFrames) / Tb];
    if (w < 0) break;  // o does not decrease: the later windows start later still
    if (w < W) s += part[((static_cast<size_t>(b) * nP + p) * W + w) * J + j];
  }
  d_pred[(static_cast<size_t>(b) * U1 + u) * J + j] = s;
}

}  // namespace

// Each returns the first cudaError_t of its launches (0 on success).  J must
// be at most 128, blank_id in [0, V), Tb a multiple of 8 dividing Tp, Wp a
// multiple of 8 (the wrapper checks).
extern "C" int rnnt_band_fwd(const float* enc, const float* pred, const float* K,
                             const float* bias, const float* ke, const float* be, void* kop,
                             const int* o, float* blank, float* emit, float* lse, int B, int T,
                             int U1, int J, int V, int Tp, int Wp, int Tb, int blank_id, int bf,
                             void* stream) {
  if (!band_ok(Tp, Wp, Tb)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd(enc, pred, K, bias, ke, be, band_geo(B, T, U1, J, V, o, Tp, Wp, Tb), blank_id,
                    bf, kop, blank, emit, lse, static_cast<cudaStream_t>(stream));
}

extern "C" int rnnt_band_bwd(const float* enc, const float* pred, const float* K,
                             const float* bias, const int* labels, const int* o, const float* lse,
                             const float* g_blank, const float* g_emit, float* d_enc_part,
                             float* d_pred_part, float* dk_part, float* db_part, float* d_pred,
                             int* rec, void* kop, int B, int T, int U1, int J, int V, int Tp,
                             int Wp, int Tb, int blank_id, int bf, int nsplit, void* stream) {
  if (!band_ok(Tp, Wp, Tb)) return static_cast<int>(cudaErrorInvalidValue);
  const Geo g = band_geo(B, T, U1, J, V, o, Tp, Wp, Tb);
  auto s = static_cast<cudaStream_t>(stream);
  const int err = launch_bwd(enc, pred, K, bias, labels, lse, g_blank, g_emit, g, blank_id, bf,
                             nsplit, rec, kop, d_enc_part, d_pred_part, dk_part, db_part, s);
  if (err != 0) return err;
  const long long n = static_cast<long long>(U1) * J;
  const dim3 grid(static_cast<unsigned>((n + 255) / 256), B);
  band_dpred_kernel<<<grid, 256, 0, s>>>(d_pred_part, o, d_pred, U1, J, Wp, Tp / kBandPatchFrames,
                                         Tb, g.nblk);
  return static_cast<int>(cudaGetLastError());
}

// The sizes at this J, V and dtype (rnnt_joint_core.cuh's joint_sizes):
// out[0] d_K blocks per SM, out[1] words of K's operand form
extern "C" int rnnt_band_sizes(int J, int V, int bf, int* out) {
  return joint_sizes(J, V, bf, out);
}
