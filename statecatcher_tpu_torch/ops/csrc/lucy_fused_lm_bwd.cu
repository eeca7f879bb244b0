// Fused LucyRNN cell, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel statecatcher_tpu/ops/lucy_fused_lm.py:248
// _bwd_kernel, launched by _fused_lm_bwd_impl (:364): the reverse adjoints of
// both recurrences plus the closed-form adjoint of the gate chain, emitting
// d_gates directly.
//
//   gates  (B, T, 7D) f32 or bf16, lane-major (order r, z, k, v, h_pre,
//          decay, alpha), bias unapplied;  bias (7D) f32;  h0, s0 (B, D) f32
//   h_all, s_all (B, T, D) forward outputs, g_h, g_s (B, T, D) their
//          cotangents, all in the gates' dtype; g_s may be null (zero)
//   ->     d_gates (B, T, 7D) in the gates' dtype; dh0, ds0 (B, D) f32;
//          dbias_part (B, 7D) f32, the sum over t of d_gates for each b (the
//          wrapper sums it over b: deterministic, no atomics)
//
// Per step t, walking t = T-1 .. 0 (as ops/lucy_fused_lm.py's plain version):
//   recompute the gate chain in its rsqrt form (a_s = decay_n, b_s =
//   alpha_n*kv, a_h = z_n, bh_c = 1 - z_n, h_pre_n);
//   lam_h = g_h[t] + a_h[t+1]*lam_h;   c = tanh(h_pre_n + s[t])
//   d_pre = lam_h*(bh_c*(1 - c^2));   lam_s = (g_s[t] + d_pre) + a_s[t+1]*lam_s
//   chain adjoint of (lam_s*s[t-1], lam_s, lam_h*h[t-1], lam_h*c, d_pre)
//   -> the 7 d_gates of step t, also added into the thread's d_bias sums.
// At the end dh0 = lam_h*a_h[0] and ds0 = lam_s*a_s[0].
//
// Bound on the card: bytes.  18 planes of B*T*D (7 gate planes, h_all,
// s_all, g_h and g_s read; 7 d_gates planes written): at B=32, T=1598,
// D=512 that is 1.885 GB in f32, 0.563 ms at 3.35 TB/s (0.281 ms in bf16),
// against ~130 operations per element (0.10 ms at 67 TFLOP/s f32).
//
// Design: one thread per (b, d) column walks t backwards with lam_h, lam_s,
// a_h[t+1] and a_s[t+1] in registers, so neither recurrence needs another
// thread and no lambda or coefficient plane touches device memory.  Every
// read and write is coalesced across d.  The next step's inputs (7 gates,
// g_h, g_s, h[t-2], s[t-2]) are loaded while the current step computes, and
// s[t-1], loaded as this step's s_prev, is the next step's s.  As in K1,
// B*D = 16,384 threads at the batched shape are too few to hide one memory
// round trip per step; a time split with a carry fix-up is the next step.

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

// Everything one step reads: the 7 raw gates, g_h[t], g_s[t], h[t-1], s[t-1].
struct StepIn {
  float g[7];
  float gh, gs, h_prev, s_prev;
};

template <typename G>
__device__ __forceinline__ void load_step(StepIn& in, const G* g, const G* ha, const G* sa,
                                          const G* gh, const G* gs, float h0, float s0,
                                          int t, int D) {
  const size_t row = static_cast<size_t>(7) * D;
  const G* gt = g + static_cast<size_t>(t) * row;
#pragma unroll
  for (int i = 0; i < 7; ++i) in.g[i] = to_f32(gt[static_cast<size_t>(i) * D]);
  const size_t o = static_cast<size_t>(t) * D;
  in.gh = to_f32(gh[o]);
  in.gs = gs ? to_f32(gs[o]) : 0.0f;
  in.h_prev = t > 0 ? to_f32(ha[o - D]) : h0;
  in.s_prev = t > 0 ? to_f32(sa[o - D]) : s0;
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
lucy_fused_lm_bwd_kernel(const G* __restrict__ gates, const float* __restrict__ bias,
                         const float* __restrict__ h0, const float* __restrict__ s0,
                         const G* __restrict__ h_all, const G* __restrict__ s_all,
                         const G* __restrict__ g_h, const G* __restrict__ g_s,
                         G* __restrict__ d_gates, float* __restrict__ dh0,
                         float* __restrict__ ds0, float* __restrict__ dbias_part,
                         int T, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;

  float bi[7], db[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    bi[i] = bias[i * D + d];
    db[i] = 0.0f;
  }
  const float h_init = h0[static_cast<size_t>(b) * D + d];
  const float s_init = s0[static_cast<size_t>(b) * D + d];

  const size_t row = static_cast<size_t>(7) * D;
  const G* g = gates + static_cast<size_t>(b) * T * row + d;
  G* dg = d_gates + static_cast<size_t>(b) * T * row + d;
  const size_t plane = static_cast<size_t>(b) * T * D + d;
  const G* ha = h_all + plane;
  const G* sa = s_all + plane;
  const G* gh = g_h + plane;
  const G* gs = g_s ? g_s + plane : nullptr;

  float lam_h = 0.0f, lam_s = 0.0f;
  float a_h_next = 1.0f, a_s_next = 1.0f;
  float s_cur = to_f32(sa[static_cast<size_t>(T - 1) * D]);

  StepIn cur;
  load_step(cur, g, ha, sa, gh, gs, h_init, s_init, T - 1, D);

  for (int t = T - 1; t >= 0; --t) {
    StepIn nxt;
    if (t > 0) load_step(nxt, g, ha, sa, gh, gs, h_init, s_init, t - 1, D);

    const float r = cur.g[0] + bi[0];
    const float z = cur.g[1] + bi[1];
    const float k = cur.g[2] + bi[2];
    const float v = cur.g[3] + bi[3];
    const float h_pre = cur.g[4] + bi[4];
    const float decay = cur.g[5] + bi[5];
    const float alpha = cur.g[6] + bi[6];

    // gate chain, rsqrt form (ops/lucy_fused_lm.py:_gate_chain_res)
    const float i_rz = rsqrtf((r * r + z * z) * 0.5f + kEps);
    const float q_kv = (k * k + v * v) * 0.5f + kEps;
    const float i_kv = rsqrtf(q_kv);
    const float inv_qe = 1.0f / (q_kv + kEps);
    const float i_d = rsqrtf(decay * decay + kEps);
    const float i_a = rsqrtf(alpha * alpha + kEps);
    const float i_p = rsqrtf(h_pre * h_pre + kEps);
    const float z_n = sigmoid_f32(z * i_rz);
    const float d_n = sigmoid_f32(decay * i_d);
    const float a_n = sigmoid_f32(alpha * i_a);
    const float F = (i_kv * i_kv) * inv_qe;
    const float kv = (k * v) * F;
    const float bh_c = 1.0f - z_n;
    const float h_pre_n = h_pre * i_p;

    // the two adjoint recurrences
    lam_h = cur.gh + a_h_next * lam_h;
    const float c = tanhf(h_pre_n + s_cur);
    const float d_pre = lam_h * (bh_c * (1.0f - c * c));
    lam_s = (cur.gs + d_pre) + a_s_next * lam_s;

    // cotangents of (a_s, b_s, a_h, bh_c, h_pre_n)
    const float ca = lam_s * cur.s_prev;
    const float cb = lam_s;
    const float cah = lam_h * cur.h_prev;
    const float cbh = lam_h * c;
    const float cp = d_pre;

    // closed-form chain adjoint (ops/lucy_fused_lm.py:_gate_chain_bwd)
    float out[7];
    out[5] = ca * (d_n * (1.0f - d_n)) * (kEps * i_d * i_d * i_d);
    const float c_kv = cb * a_n;
    out[6] = (cb * kv) * (a_n * (1.0f - a_n)) * (kEps * i_a * i_a * i_a);
    const float gz = (cah - cbh) * (z_n * (1.0f - z_n));
    const float i_rz3 = (i_rz * i_rz) * i_rz;
    out[1] = gz * (i_rz - (0.5f * (z * z)) * i_rz3);
    out[0] = gz * ((-0.5f) * (z * r) * i_rz3);
    out[4] = cp * (kEps * i_p * i_p * i_p);
    const float tF = (2.0f * q_kv + kEps) * F;
    out[2] = (c_kv * v) * F * (1.0f - (k * k) * tF);
    out[3] = (c_kv * k) * F * (1.0f - (v * v) * tF);

    G* dgt = dg + static_cast<size_t>(t) * row;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      store(dgt + static_cast<size_t>(i) * D, out[i]);
      db[i] += out[i];
    }

    a_h_next = z_n;
    a_s_next = d_n;
    s_cur = cur.s_prev;
    if (t > 0) cur = nxt;
  }

  dh0[static_cast<size_t>(b) * D + d] = lam_h * a_h_next;
  ds0[static_cast<size_t>(b) * D + d] = lam_s * a_s_next;
  float* dbp = dbias_part + static_cast<size_t>(b) * row + d;
#pragma unroll
  for (int i = 0; i < 7; ++i) dbp[static_cast<size_t>(i) * D] = db[i];
}

template <typename G>
int launch(const void* gates, const float* bias, const float* h0, const float* s0,
           const void* h_all, const void* s_all, const void* g_h, const void* g_s,
           void* d_gates, float* dh0, float* ds0, float* dbias_part, int B, int T, int D,
           cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  lucy_fused_lm_bwd_kernel<G><<<grid, kThreads, 0, stream>>>(
      static_cast<const G*>(gates), bias, h0, s0, static_cast<const G*>(h_all),
      static_cast<const G*>(s_all), static_cast<const G*>(g_h), static_cast<const G*>(g_s),
      static_cast<G*>(d_gates), dh0, ds0, dbias_part, T, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 gates, activations and cotangents, 1 = bfloat16.
// g_s may be null.  Returns the cudaError_t of the launch (0 on success).
extern "C" int lucy_fused_lm_bwd(int dtype, const void* gates, const float* bias,
                                 const float* h0, const float* s0, const void* h_all,
                                 const void* s_all, const void* g_h, const void* g_s,
                                 void* d_gates, float* dh0, float* ds0, float* dbias_part,
                                 int B, int T, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(gates, bias, h0, s0, h_all, s_all, g_h, g_s, d_gates, dh0, ds0,
                         dbias_part, B, T, D, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(gates, bias, h0, s0, h_all, s_all, g_h, g_s, d_gates, dh0,
                                 ds0, dbias_part, B, T, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
