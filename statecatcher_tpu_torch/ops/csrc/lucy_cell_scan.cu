// LucyRNN cell forwards for Hopper (sm_90a): the fused masked cell (K12) and
// the dual scan (K11).
//
// Replaces two TPU kernels of statecatcher_tpu/ops/lucy_pallas.py:
//   K12  lucy_fused_cell_kernel <- _fused_cell_kernel (:319), launched by
//                                  _fused_cell_fwd_impl (:390)
//   K11  lucy_dual_scan_kernel  <- _dual_scan_kernel (:527), launched by
//                                  _dual_scan_fwd_impl (:568)
//
//   K12:  gates (B, T, 7, D) f32 or bf16, the bias already added by the
//         caller (in the gates' dtype), order r, z, k, v, h_pre, decay,
//         alpha; h0, s0 (B, D) f32 (the wrapper casts); an optional frame
//         mask (B, T) of bytes, 0 or 1  ->  h_all, s_all (B, T, D) in the
//         gates' dtype.  The gate chain in f32, in the sqrt/divide form of
//         ops/lucy_gates.py (the plain version), eps 1e-6:
//           z_n = sigmoid(z / sqrt((r^2+z^2)/2+eps))   decay_n, alpha_n likewise
//           kv  = (k/rms_kv)(v/rms_kv) / (rms_kv^2+eps)  h_pre_n = h_pre/sqrt(h_pre^2+eps)
//           a_s = decay_n, b_s = alpha_n*kv, a_h = z_n, bh_c = 1 - z_n
//         A mask value m turns them into m*a + (1-m) and m*b (the identity
//         map where m = 0), written as that arithmetic so that a NaN gate
//         propagates as in the plain version.  Then
//           s_t = a_s*s_{t-1} + b_s;  c = tanh(h_pre_n + s_t);
//           h_t = a_h*h_{t-1} + bh_c*c
//   K11:  a_s, b_s, a_h, h_pre_n (B, T, D) in one dtype, f32 or bf16; h0, s0
//         (B, D) f32  ->  h_all, s_all (B, T, D) in that dtype:
//           s_t = a_s*s_{t-1} + b_s;  c = tanh(h_pre_n + s_t);
//           h_t = a_h*h_{t-1} + (1 - a_h)*c
//         (the mask, if any, is already in the coefficients: a masked step
//         has a_h = 1, so its offset (1 - a_h)*c is 0.)
// Both carry s and h in f32 and round only what they write.  Every product,
// sum and quotient is rounded on its own (no fused multiply-add), in the
// order of the plain versions (ops/lucy_gates.py, ops/scan.py:
// linear_scan_seq), and sqrt, exp and tanh are the library's, as PyTorch's
// CUDA kernels call them: on the card the kernels and the plain versions
// agree bit for bit in f32.
//
// Bound on the card: bytes.  K12 reads 7 planes and writes 2 (the mask is
// B*T bytes): 9*B*T*D elements, 942.5 MB at B=32, T=1598, D=512 in f32,
// 0.281 ms at 3.35 TB/s (0.141 ms bf16), against ~51 operations per element
// (0.020 ms at 67 TFLOP/s).  K11 reads 4 planes and writes 2: 628.3 MB, 0.188
// ms f32 (0.094 ms bf16), against ~8 operations per element.
//
// Design: one thread per (b, d) column walks T (neighbouring threads read
// neighbouring d, so every gate and plane load coalesces).  Each thread
// loads kChunk steps of its inputs into registers before it runs them, so a
// chunk's loads are in flight together instead of each step waiting on its
// own; the gate chain of a step does not depend on the carry, so only the
// two scan updates are serial.  The TPU kernel's time chunks of 256 rows,
// its Hillis-Steele composition of each chunk, its 128-lane padding of D
// and the identity rows of its ragged tail are TPU tiling and are not
// carried over: rows >= T do not exist here.  Not done yet: at B=32 the
// grid is 128 blocks of 128 threads, one per SM, too few warps to cover the
// memory latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kEps = 1e-6f;
constexpr int kThreads = 128;
constexpr int kChunk = 8;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sigmoid_f32(float x) { return div(1.0f, add(1.0f, expf(-x))); }

// s <- a*s + b, the product and the sum each rounded once
__device__ __forceinline__ float step(float a, float s, float b) { return add(mul(a, s), b); }

template <typename G, bool kMasked>
__global__ void __launch_bounds__(kThreads)
lucy_fused_cell_kernel(const G* __restrict__ gates, const unsigned char* __restrict__ mask,
                       const float* __restrict__ h0, const float* __restrict__ s0,
                       G* __restrict__ h_all, G* __restrict__ s_all, int B, int T, int D) {
  const long long col = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= static_cast<long long>(B) * D) return;
  const long long b = col / D;
  const size_t d = static_cast<size_t>(col - b * D);
  const size_t row = static_cast<size_t>(7) * D;
  const G* g = gates + static_cast<size_t>(b) * T * row + d;
  const unsigned char* mk = kMasked ? mask + static_cast<size_t>(b) * T : nullptr;
  const size_t out0 = static_cast<size_t>(b) * T * D + d;
  float h = h0[col], s = s0[col];

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    float x[kChunk][7];
    float m[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int t = t0 + k;
      const G* gt = g + static_cast<size_t>(t) * row;
#pragma unroll
      for (int i = 0; i < 7; ++i) x[k][i] = t < T ? ld(gt + static_cast<size_t>(i) * D) : 0.0f;
      m[k] = (kMasked && t < T) ? static_cast<float>(mk[t]) : 1.0f;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int t = t0 + k;
      if (t >= T) break;
      const float r = x[k][0], z = x[k][1], kk = x[k][2], v = x[k][3];
      const float h_pre = x[k][4], decay = x[k][5], alpha = x[k][6];
      const float rms_rz = sqrtf(add(div(add(mul(r, r), mul(z, z)), 2.0f), kEps));
      const float rms_kv2 = add(div(add(mul(kk, kk), mul(v, v)), 2.0f), kEps);
      const float rms_kv = sqrtf(rms_kv2);
      const float z_n = sigmoid_f32(div(z, rms_rz));
      const float decay_n = sigmoid_f32(div(decay, sqrtf(add(mul(decay, decay), kEps))));
      const float alpha_n = sigmoid_f32(div(alpha, sqrtf(add(mul(alpha, alpha), kEps))));
      const float h_pre_n = div(h_pre, sqrtf(add(mul(h_pre, h_pre), kEps)));
      const float kv = div(mul(div(kk, rms_kv), div(v, rms_kv)), add(rms_kv2, kEps));
      float a_s = decay_n, b_s = mul(alpha_n, kv), a_h = z_n, bh_c = 1.0f - z_n;
      if (kMasked) {
        const float mm = m[k];
        a_s = add(mul(mm, a_s), 1.0f - mm);
        b_s = mul(mm, b_s);
        a_h = add(mul(mm, a_h), 1.0f - mm);
        bh_c = mul(mm, bh_c);
      }
      s = step(a_s, s, b_s);
      const float c = tanhf(h_pre_n + s);
      h = step(a_h, h, mul(bh_c, c));
      const size_t o = out0 + static_cast<size_t>(t) * D;
      st(h_all + o, h);
      st(s_all + o, s);
    }
  }
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
lucy_dual_scan_kernel(const P* __restrict__ a_s, const P* __restrict__ b_s,
                      const P* __restrict__ a_h, const P* __restrict__ h_pre,
                      const float* __restrict__ h0, const float* __restrict__ s0,
                      P* __restrict__ h_all, P* __restrict__ s_all, int B, int T, int D) {
  const long long col = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= static_cast<long long>(B) * D) return;
  const long long b = col / D;
  const size_t base = static_cast<size_t>(b) * T * D + static_cast<size_t>(col - b * D);
  float h = h0[col], s = s0[col];

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    float as[kChunk], bs[kChunk], ah[kChunk], hp[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int t = t0 + k;
      const size_t i = base + static_cast<size_t>(t) * D;
      as[k] = t < T ? ld(a_s + i) : 1.0f;
      bs[k] = t < T ? ld(b_s + i) : 0.0f;
      ah[k] = t < T ? ld(a_h + i) : 1.0f;
      hp[k] = t < T ? ld(h_pre + i) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int t = t0 + k;
      if (t >= T) break;
      s = step(as[k], s, bs[k]);
      const float c = tanhf(hp[k] + s);
      h = step(ah[k], h, mul(1.0f - ah[k], c));
      const size_t i = base + static_cast<size_t>(t) * D;
      st(h_all + i, h);
      st(s_all + i, s);
    }
  }
}

unsigned blocks_for(int B, int D) {
  return static_cast<unsigned>((static_cast<long long>(B) * D + kThreads - 1) / kThreads);
}

template <typename G>
void launch_cell(const void* gates, const unsigned char* mask, const float* h0, const float* s0,
                 void* h_all, void* s_all, int B, int T, int D, cudaStream_t st) {
  const G* g = static_cast<const G*>(gates);
  G* ho = static_cast<G*>(h_all);
  G* so = static_cast<G*>(s_all);
  if (mask != nullptr)
    lucy_fused_cell_kernel<G, true><<<blocks_for(B, D), kThreads, 0, st>>>(g, mask, h0, s0, ho,
                                                                           so, B, T, D);
  else
    lucy_fused_cell_kernel<G, false><<<blocks_for(B, D), kThreads, 0, st>>>(g, mask, h0, s0, ho,
                                                                            so, B, T, D);
}

template <typename P>
void launch_dual(const void* a_s, const void* b_s, const void* a_h, const void* h_pre,
                 const float* h0, const float* s0, void* h_all, void* s_all, int B, int T, int D,
                 cudaStream_t st) {
  lucy_dual_scan_kernel<P><<<blocks_for(B, D), kThreads, 0, st>>>(
      static_cast<const P*>(a_s), static_cast<const P*>(b_s), static_cast<const P*>(a_h),
      static_cast<const P*>(h_pre), h0, s0, static_cast<P*>(h_all), static_cast<P*>(s_all), B, T,
      D);
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success); the caller
// raises on non-zero.  dtype 0 is float32, 1 bfloat16 (the gates or planes
// and the outputs).  ``mask`` may be null (no frame mask).  B*D/128 blocks
// must fit the grid (the wrapper checks).
extern "C" int lucy_fused_cell_fwd(int dtype, const void* gates, const unsigned char* mask,
                                   const float* h0, const float* s0, void* h_all, void* s_all,
                                   int B, int T, int D, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_cell<float>(gates, mask, h0, s0, h_all, s_all, B, T, D, st);
  else if (dtype == 1)
    launch_cell<__nv_bfloat16>(gates, mask, h0, s0, h_all, s_all, B, T, D, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lucy_dual_scan_fwd(int dtype, const void* a_s, const void* b_s, const void* a_h,
                                  const void* h_pre, const float* h0, const float* s0,
                                  void* h_all, void* s_all, int B, int T, int D, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_dual<float>(a_s, b_s, a_h, h_pre, h0, s0, h_all, s_all, B, T, D, st);
  else if (dtype == 1)
    launch_dual<__nv_bfloat16>(a_s, b_s, a_h, h_pre, h0, s0, h_all, s_all, B, T, D, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
