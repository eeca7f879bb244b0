// First-order linear scan for Hopper (sm_90a): forward and reverse adjoint.
//
// Replaces the TPU kernels of statecatcher_tpu/ops/lucy_pallas.py:
//   K5a  linear_scan_fwd_kernel <- _scan_kernel (:35), launched by
//                                  _linear_scan_pallas_fwd_impl (:79)
//   K5b  linear_scan_rev_kernel <- _rev_scan_kernel (:118), launched by
//                                  _linear_scan_pallas_rev_impl (:174)
//
//   K5a:  a, b (B, T, D) f32 or bf16, s0 (B, D) f32 (the wrapper casts) ->
//         s (B, T, D) in a's dtype, s_t = a_t * s_{t-1} + b_t from s_{-1} = s0
//   K5b:  a, g (B, T, D) -> lam (B, T, D) in a's dtype,
//         lam_t = g_t + a_{t+1} * lam_{t+1}, lam_{T-1} = g_{T-1}
// Both carry the state in f32 whatever the inputs' dtype and round only what
// they write, as the TPU kernels' f32 scratch carry does.  The product and
// the sum are rounded separately (no fused multiply-add), in the order of the
// plain sequential versions (ops/scan.py), so f32 results equal theirs.
//
// Bound on the card: bytes, two planes read and one written: 3*B*T*D*4 bytes,
// 314 MB at B=32, T=1598, D=512 f32, 0.094 ms at 3.35 TB/s.  The T steps of
// each (b, d) column are a dependent chain, so the time is set by how many
// loads each thread keeps in flight.
//
// Design: one thread per (b, d) column walks T (neighbouring threads read
// neighbouring d, so each step's loads coalesce), loading kChunk steps of a
// and b (or g) into registers before it runs them, so that the loads of a
// chunk overlap one another instead of each waiting on the last step.  (The
// TPU kernel scanned each time chunk as a Hillis-Steele composition; on this
// card the sequential walk already does the least work.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename Tx>
__global__ void __launch_bounds__(kThreads)
linear_scan_fwd_kernel(const Tx* __restrict__ a, const Tx* __restrict__ b,
                       const float* __restrict__ s0, Tx* __restrict__ out, int B, int T, int D) {
  const long long col = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= static_cast<long long>(B) * D) return;
  const long long bi = col / D;
  const size_t base = static_cast<size_t>(bi) * T * D + (col - bi * D);
  float s = s0[col];
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    float ac[kChunk], bc[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const size_t i = base + static_cast<size_t>(t0 + k) * D;
      ac[k] = t0 + k < T ? ld(a + i) : 1.0f;
      bc[k] = t0 + k < T ? ld(b + i) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      s = __fadd_rn(__fmul_rn(ac[k], s), bc[k]);
      if (t0 + k < T) st(out + base + static_cast<size_t>(t0 + k) * D, s);
    }
  }
}

template <typename Tx>
__global__ void __launch_bounds__(kThreads)
linear_scan_rev_kernel(const Tx* __restrict__ a, const Tx* __restrict__ g, Tx* __restrict__ out,
                       int B, int T, int D) {
  const long long col = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= static_cast<long long>(B) * D) return;
  const long long bi = col / D;
  const size_t base = static_cast<size_t>(bi) * T * D + (col - bi * D);
  float lam = 0.0f, a_next = 0.0f;  // a_T is never used: lam_T = 0
  for (int t1 = T - 1; t1 >= 0; t1 -= kChunk) {
    float ac[kChunk], gc[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int t = t1 - k;
      const size_t i = base + static_cast<size_t>(t) * D;
      ac[k] = t >= 0 ? ld(a + i) : 1.0f;
      gc[k] = t >= 0 ? ld(g + i) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int t = t1 - k;
      lam = __fadd_rn(gc[k], __fmul_rn(a_next, lam));
      a_next = ac[k];
      if (t >= 0) st(out + base + static_cast<size_t>(t) * D, lam);
    }
  }
}

unsigned blocks_for(int B, int D) {
  return static_cast<unsigned>((static_cast<long long>(B) * D + kThreads - 1) / kThreads);
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success).  dtype 0 is
// float32, 1 bfloat16 (a, b, g and the output); B*D/128 blocks must fit the
// grid (the wrapper checks).
extern "C" int linear_scan_fwd(int dtype, const void* a, const void* b, const float* s0,
                               void* out, int B, int T, int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    linear_scan_fwd_kernel<float><<<blocks_for(B, D), kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), s0, static_cast<float*>(out),
        B, T, D);
  else if (dtype == 1)
    linear_scan_fwd_kernel<__nv_bfloat16><<<blocks_for(B, D), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), s0,
        static_cast<__nv_bfloat16*>(out), B, T, D);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int linear_scan_rev(int dtype, const void* a, const void* g, void* out, int B, int T,
                               int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    linear_scan_rev_kernel<float><<<blocks_for(B, D), kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(g), static_cast<float*>(out), B,
        T, D);
  else if (dtype == 1)
    linear_scan_rev_kernel<__nv_bfloat16><<<blocks_for(B, D), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(out), B, T, D);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
