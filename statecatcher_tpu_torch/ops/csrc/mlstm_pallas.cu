// The chunkwise mLSTM forward in the head-major layout for Hopper (sm_90a):
// K10.  The chunk math, its contract, bound and design are in mlstm_chunk.cuh
// (mlstm_fwd_kernel, as K9a runs it).
//
// Replaces the TPU kernel of statecatcher_tpu/ops/mlstm_pallas.py:
//   K10  mlstm_fwd_kernel <- _mlstm_kernel (:30), launched by _pallas_forward (:110)
//
// Layout: q, k (B*H, Tp, dqk), v and h (B*H, Tp, dv) float32, q already scaled
// by dqk^-1/2; the soft-capped input gate and the log-forget (B*H, Tp) f32;
// states (B*H, dqk, dv), (B*H, dqk), (B*H) f32.  The wrapper pads T with
// gate values that keep the state (ops/mlstm_pallas.py), so no row is masked.

#include "mlstm_chunk.cuh"

using namespace mlstm;

// Returns the cudaError_t of the launch (0 on success).  L must divide Tp, and
// L and dqk be at most 256 (the wrapper checks).
extern "C" int mlstm_pallas_fwd(const float* q, const float* k, const float* v, const float* ic,
                                const float* lf, const float* C0, const float* n0,
                                const float* m0, float* h, float* CT, float* nT, float* mT, int BH,
                                int Tp, int dqk, int dv, int L, void* stream) {
  const long long sq = static_cast<long long>(Tp) * dqk, sv = static_cast<long long>(Tp) * dv;
  const Layout lay{sq, 0, dqk, sv, 0, dv};
  FwdParams p{q, k, v, ic, lf, C0, n0, m0, h, CT, nT, mT, nullptr, 0, lay, 1, Tp, Tp, dqk, dv, L,
              1.0f};
  return launch_fwd<float, float>(p, BH, static_cast<cudaStream_t>(stream));
}
