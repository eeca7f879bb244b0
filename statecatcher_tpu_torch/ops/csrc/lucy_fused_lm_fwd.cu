// Fused LucyRNN cell, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel statecatcher_tpu/ops/lucy_fused_lm.py:156
// _fwd_kernel, launched by _fused_lm_fwd_impl (:196): bias add + grouped-RMS
// gate chain + s-scan -> tanh -> h-scan in one pass over the gates.
//
//   gates (B, T, 7D) f32 or bf16, lane-major: gate i of (b, t) starts at
//         ((b*T + t)*7 + i)*D, order r, z, k, v, h_pre, decay, alpha
//   bias  (7D) f32, unapplied;  h0, s0 (B, D) f32
//   ->    h_all, s_all (B, T, D) in the gates' dtype; all math in f32
//
// Gate chain in the sqrt/divide form of ops/lucy_gates.py (the plain
// version), eps 1e-6:
//   z_n = sigmoid(z / sqrt((r^2+z^2)/2+eps))       decay_n, alpha_n likewise
//   kv  = (k/rms_kv)(v/rms_kv) / (rms_kv^2 + eps)   h_pre_n = h_pre/sqrt(h_pre^2+eps)
//   s_t = decay_n*s_{t-1} + alpha_n*kv;  c = tanh(h_pre_n + s_t)
//   h_t = z_n*h_{t-1} + (1 - z_n)*c
//
// Bound on the card: bytes.  7 planes read and 2 written against ~58
// operations per element (sqrt, divide, exp and tanh counted as one each):
// at B=32, T=1598, D=512 that is 942.5 MB in f32 (0.281 ms at 3.35 TB/s)
// against 1.52 G operations (0.023 ms at 67 TFLOP/s f32).
//
// Design: the cell forward of lucy_tile.cuh (`cell_fwd_kernel`: a block per
// batch row and 64 columns walks time in tiles of 12 steps through a cp.async
// ring; 12 chain warps turn a whole tile's gates into coefficients while 2
// serial warps, one thread per column, walk the tile before it) with the
// chain below: the bias added in the chain, and the arithmetic as written,
// which nvcc contracts into fused multiply-adds.  What bounds it:
// instructions, not bytes.  The chain's IEEE sqrt and divides (five and ten
// an element, kept so that each element's expressions, the same operations
// in the same order as the one-thread-per-column kernel this replaced, give
// the same bits) are ~250 instructions an element; without them the kernel
// takes 0.32 ms f32, 0.17 bf16 at B=32 (tools/lucy_cell_variants.py, which
// also builds and times other tile sizes).

#include "lucy_tile.cuh"

namespace {

using namespace lucy_tile;

struct Chain {
  static constexpr bool kBias = true;
  static constexpr bool kMasked = false;

  // (decay_n, alpha_n*kv, z_n, h_pre_n)
  __device__ static __forceinline__ void coefs(const float (&x)[7], float, float (&c)[4]) {
    const float r = x[0], z = x[1], kk = x[2], v = x[3];
    const float h_pre = x[4], decay = x[5], alpha = x[6];
    const float rms_rz = sqrtf((r * r + z * z) / 2.0f + kEps);
    const float rms_kv2 = (kk * kk + v * v) / 2.0f + kEps;
    const float rms_kv = sqrtf(rms_kv2);
    const float z_n = sigmoid_f32(z / rms_rz);
    const float decay_n = sigmoid_f32(decay / sqrtf(decay * decay + kEps));
    const float alpha_n = sigmoid_f32(alpha / sqrtf(alpha * alpha + kEps));
    const float h_pre_n = h_pre / sqrtf(h_pre * h_pre + kEps);
    const float kv = (kk / rms_kv) * (v / rms_kv) / (rms_kv2 + kEps);
    c[0] = decay_n;
    c[1] = alpha_n * kv;
    c[2] = z_n;
    c[3] = h_pre_n;
  }

  __device__ static __forceinline__ void step(float decay_n, float alpha_kv, float z_n,
                                              float h_pre_n, float& s, float& h) {
    s = decay_n * s + alpha_kv;
    const float c = tanhf(h_pre_n + s);
    h = z_n * h + (1.0f - z_n) * c;
  }
};

}  // namespace

// dtype: 0 = float32 gates and outputs, 1 = bfloat16.  Returns the
// cudaError_t of the launch (0 on success); the caller raises on non-zero.
extern "C" int lucy_fused_lm_fwd(int dtype, const void* gates, const float* bias,
                                 const float* h0, const float* s0, void* h_all,
                                 void* s_all, int B, int T, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lucy_tile::launch_cell_fwd<Chain, float>(gates, bias, nullptr, h0, s0, h_all, s_all, B,
                                                    T, D, st);
  if (dtype == 1)
    return lucy_tile::launch_cell_fwd<Chain, __nv_bfloat16>(gates, bias, nullptr, h0, s0, h_all,
                                                            s_all, B, T, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
