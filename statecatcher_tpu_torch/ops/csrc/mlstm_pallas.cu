// The chunkwise mLSTM forward in the head-major layout for Hopper (sm_90a):
// K10.  The chunk math, its contract, bound and design are in mlstm_chunk.cuh
// (launch_fwd, the chunk-parallel passes K9a runs too).
//
// Replaces the TPU kernel of statecatcher_tpu/ops/mlstm_pallas.py:
//   K10  launch_fwd's passes <- _mlstm_kernel (:30), launched by _pallas_forward (:110)
//
// Layout: q, k (B*H, T, dqk), v and h (B*H, T, dv) float32, q already scaled
// by dqk^-1/2 (so inv = 1); the soft-capped input gate and the log-forget
// (B*H, Tp) f32, padded by the wrapper to the chunk multiple Tp with the
// values the JAX package pads with (ops/mlstm_pallas.py); states (B*H, dqk,
// dv), (B*H, dqk), (B*H) f32.  Each (b, head) is one head of the launcher's
// layout (H = 1).  Rows t >= T read q, k, v as 0 (as the JAX package's zero
// padding) and h is stored for rows t < T.

#include "mlstm_chunk.cuh"

using namespace mlstm;

// The floats of the workspace (mlstm_pallas_fwd's work) for these shapes.
extern "C" long long mlstm_pallas_fwd_work(int BH, int Tp, int dqk, int dv, int L) {
  return static_cast<long long>(BH) * work_layout(Tp, dqk, dv, L, false).stride;
}

// Returns the first cudaError_t of its launches (0 on success).  L must
// divide Tp, Tp - L < T <= Tp, BH and Tp/L be at most 65535, the grids' y
// and z limit, and L small enough for the forward's shared memory (the
// wrapper checks both).
extern "C" int mlstm_pallas_fwd(const float* q, const float* k, const float* v, const float* ic,
                                const float* lf, const float* C0, const float* n0,
                                const float* m0, float* h, float* CT, float* nT, float* mT,
                                float* work, int BH, int T, int Tp, int dqk, int dv, int L,
                                void* stream) {
  Params p{};
  p.q = q, p.k = k, p.v = v, p.ic = ic, p.lf = lf, p.C0 = C0, p.n0 = n0, p.m0 = m0;
  p.h = h, p.CT = CT, p.nT = nT, p.mT = mT, p.work = work;
  p.wk = work_layout(Tp, dqk, dv, L, false);
  const long long sq = static_cast<long long>(T) * dqk, sv = static_cast<long long>(T) * dv;
  p.lay = Layout{sq, 0, dqk, sv, 0, dv};
  p.H = 1, p.Tp = Tp, p.T = T, p.Tg = Tp, p.Th = T, p.dqk = dqk, p.dv_ = dv, p.L = L;
  p.inv = 1.0f;
  return launch_fwd_for<float>(p, BH, static_cast<cudaStream_t>(stream));
}
