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
// Bound on the card: bytes.  7 planes read and 2 written against ~56
// operations per element (sqrt, divide, exp and tanh counted as one each):
// at B=32, T=1598, D=512 that is 942.5 MB in f32 (0.281 ms at 3.35 TB/s)
// against 1.47 G operations (0.022 ms at 67 TFLOP/s f32).
//
// Design: one thread per (b, d) column walks t in registers, so the two
// recurrences need no cross-thread communication and nothing but h_all and
// s_all is written.  Each gate read is coalesced across d (neighbouring
// threads, neighbouring addresses).  The next step's 7 gates do not depend
// on the state, so they are loaded while the current step computes.  Not
// done yet: B*D = 16,384 threads at the batched shape are ~4 warps per SM,
// too few to cover memory latency, so this kernel sits far from its bound; a
// time-split (chunked scan with a carry fix-up pass) or deeper prefetch is
// the next step.  No TPU tiling is carried over: no time chunk, no ragged
// tail masking, no (8, D) broadcast of h0/s0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kEps = 1e-6f;
constexpr int kThreads = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

template <typename G>
__global__ void __launch_bounds__(kThreads)
lucy_fused_lm_fwd_kernel(const G* __restrict__ gates, const float* __restrict__ bias,
                         const float* __restrict__ h0, const float* __restrict__ s0,
                         G* __restrict__ h_all, G* __restrict__ s_all, int T, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;

  float bi[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) bi[i] = bias[i * D + d];
  float h = h0[static_cast<size_t>(b) * D + d];
  float s = s0[static_cast<size_t>(b) * D + d];

  const size_t row = static_cast<size_t>(7) * D;
  const G* g = gates + static_cast<size_t>(b) * T * row + d;
  G* ho = h_all + static_cast<size_t>(b) * T * D + d;
  G* so = s_all + static_cast<size_t>(b) * T * D + d;

  float cur[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) cur[i] = to_f32(g[static_cast<size_t>(i) * D]);

  for (int t = 0; t < T; ++t) {
    float nxt[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (t + 1 < T) {
      const G* gn = g + static_cast<size_t>(t + 1) * row;
#pragma unroll
      for (int i = 0; i < 7; ++i) nxt[i] = to_f32(gn[static_cast<size_t>(i) * D]);
    }

    const float r = cur[0] + bi[0];
    const float z = cur[1] + bi[1];
    const float k = cur[2] + bi[2];
    const float v = cur[3] + bi[3];
    const float h_pre = cur[4] + bi[4];
    const float decay = cur[5] + bi[5];
    const float alpha = cur[6] + bi[6];

    const float rms_rz = sqrtf((r * r + z * z) / 2.0f + kEps);
    const float rms_kv2 = (k * k + v * v) / 2.0f + kEps;
    const float rms_kv = sqrtf(rms_kv2);
    const float z_n = sigmoid_f32(z / rms_rz);
    const float decay_n = sigmoid_f32(decay / sqrtf(decay * decay + kEps));
    const float alpha_n = sigmoid_f32(alpha / sqrtf(alpha * alpha + kEps));
    const float h_pre_n = h_pre / sqrtf(h_pre * h_pre + kEps);
    const float kv = (k / rms_kv) * (v / rms_kv) / (rms_kv2 + kEps);

    s = decay_n * s + alpha_n * kv;
    const float c = tanhf(h_pre_n + s);
    h = z_n * h + (1.0f - z_n) * c;

    store(ho + static_cast<size_t>(t) * D, h);
    store(so + static_cast<size_t>(t) * D, s);

#pragma unroll
    for (int i = 0; i < 7; ++i) cur[i] = nxt[i];
  }
}

template <typename G>
int launch(const void* gates, const float* bias, const float* h0, const float* s0,
           void* h_all, void* s_all, int B, int T, int D, cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  lucy_fused_lm_fwd_kernel<G><<<grid, kThreads, 0, stream>>>(
      static_cast<const G*>(gates), bias, h0, s0, static_cast<G*>(h_all),
      static_cast<G*>(s_all), T, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 gates and outputs, 1 = bfloat16.  Returns the
// cudaError_t of the launch (0 on success); the caller raises on non-zero.
extern "C" int lucy_fused_lm_fwd(int dtype, const void* gates, const float* bias,
                                 const float* h0, const float* s0, void* h_all,
                                 void* s_all, int B, int T, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(gates, bias, h0, s0, h_all, s_all, B, T, D, st);
  if (dtype == 1) return launch<__nv_bfloat16>(gates, bias, h0, s0, h_all, s_all, B, T, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
