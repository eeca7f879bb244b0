// CTC alpha/beta lattice for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels of statecatcher_tpu/ops/ctc_pallas.py:
//   K3  ctc_alpha_kernel  <- _alpha_kernel (:58), launched by _alpha_all (:179)
//   K4  ctc_beta_kernel   <- _beta_kernel (:92), launched by _beta_all (:218)
//
//   emit        (B, T, S) f32, S = 2U+1 extended-label states, the log-prob of
//               each state's label at each frame
//   allow_skip  (B, S) uint8, 1 where the s-2 -> s skip is allowed
//   in_lens     (B) int32;  label_lens (B) int32 (beta only)
//   ->          alpha or beta (B, T, S) f32
//
// Rules, as the TPU kernels (ops/ctc_lattice.py holds the plain versions):
//   alpha: t = 0 reaches states s <= 1 (alpha = emit there, -1e30 elsewhere);
//          t > 0: alpha_t(s) = lse3(alpha(s), alpha(s-1), alpha(s-2) if skip)
//          + emit;  rows are frozen (copied) for t >= in_len.
//   beta:  t >= in_len: -1e30 (dead);  t = in_len-1: emit + (0 at the
//          terminal states 2L and 2L-1 (L > 0), -1e30 elsewhere);  t below:
//          beta_t(s) = emit + lse3(beta(s), beta(s+1), beta(s+2) if skip
//          into s+2).  Time is walked backwards in place: no flipped copy.
//   lse3 is _logaddexp3 with its -1e30 floor: -1e30 when the max is below
//   -5e29.
//
// Bound on the card: bytes, emit read and alpha (or beta) written once:
// 2*B*T*S*4 bytes, 105 MB at B=32, T=1598, U=128 (S=257), 0.031 ms at
// 3.35 TB/s each.  But the T-long chain of dependent steps sets the time:
// each step needs the whole previous row.
//
// Design: one block per batch row; its threads stride over the S states
// (up to 4 states each, so S <= 4096 with 1024 threads, past the S = 1025
// case that broke the TPU compile).  The row lives in shared memory, double
// buffered, so one __syncthreads() per time step suffices: step t reads
// buffer t&1 and writes the other.  emit is read coalesced over s, one step
// ahead of its use; alpha (beta) is written coalesced over s.  Frames past
// in_len need no recursion: alpha's frozen rows and beta's dead rows are
// written from registers without synchronising.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxPer = 4;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, kNeg);
  const float out = ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
  return m <= kNeg * 0.5f ? kNeg : out;
}

__global__ void ctc_alpha_kernel(const float* __restrict__ emit,
                                 const uint8_t* __restrict__ allow_skip,
                                 const int* __restrict__ in_lens, float* __restrict__ alpha,
                                 int T, int S) {
  extern __shared__ float smem[];
  float* buf0 = smem;
  float* buf1 = smem + S;
  const int b = blockIdx.x;
  const int nt = blockDim.x;
  const int L = in_lens[b];
  const int t_run = L < T ? (L > 0 ? L : 0) : T;   // steps that recurse
  const float* e = emit + static_cast<size_t>(b) * T * S;
  float* out = alpha + static_cast<size_t>(b) * T * S;

  bool skip[kMaxPer];
  float val[kMaxPer], ecur[kMaxPer];
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    const int s = threadIdx.x + i * nt;
    skip[i] = s < S && s >= 2 && allow_skip[static_cast<size_t>(b) * S + s] != 0;
    val[i] = kNeg;
    ecur[i] = (s < S && t_run > 0) ? e[s] : 0.0f;
    if (s < S) buf0[s] = kNeg;
  }
  __syncthreads();

  for (int t = 0; t < t_run; ++t) {
    const float* prev = (t & 1) ? buf1 : buf0;
    float* next = (t & 1) ? buf0 : buf1;
    float enxt[kMaxPer];
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      const int s = threadIdx.x + i * nt;
      enxt[i] = (s < S && t + 1 < t_run) ? e[static_cast<size_t>(t + 1) * S + s] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      const int s = threadIdx.x + i * nt;
      if (s >= S) continue;
      float nv;
      if (t == 0) {
        nv = s <= 1 ? ecur[i] : kNeg;
      } else {
        const float a1 = s >= 1 ? prev[s - 1] : kNeg;
        const float a2 = skip[i] ? prev[s - 2] : kNeg;
        nv = lse3(prev[s], a1, a2) + ecur[i];
      }
      next[s] = nv;
      out[static_cast<size_t>(t) * S + s] = nv;
      val[i] = nv;
      ecur[i] = enxt[i];
    }
    __syncthreads();
  }
  // frozen past in_len: every later row repeats the last one
  for (int t = t_run; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      const int s = threadIdx.x + i * nt;
      if (s < S) out[static_cast<size_t>(t) * S + s] = val[i];
    }
  }
}

__global__ void ctc_beta_kernel(const float* __restrict__ emit,
                                const uint8_t* __restrict__ allow_skip,
                                const int* __restrict__ in_lens,
                                const int* __restrict__ label_lens, float* __restrict__ beta,
                                int T, int S) {
  extern __shared__ float smem[];
  float* buf0 = smem;
  float* buf1 = smem + S;
  const int b = blockIdx.x;
  const int nt = blockDim.x;
  const int L = in_lens[b];
  const int ll = label_lens[b];
  const int t_top = L < T ? L : T;                 // rows t < t_top recurse
  const float* e = emit + static_cast<size_t>(b) * T * S;
  float* out = beta + static_cast<size_t>(b) * T * S;

  bool skip2[kMaxPer];
  float term[kMaxPer], ecur[kMaxPer];
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    const int s = threadIdx.x + i * nt;
    skip2[i] = s + 2 < S && allow_skip[static_cast<size_t>(b) * S + s + 2] != 0;
    term[i] = (s == 2 * ll || (ll > 0 && s == 2 * ll - 1)) ? 0.0f : kNeg;
    ecur[i] = (s < S && t_top > 0) ? e[static_cast<size_t>(t_top - 1) * S + s] : 0.0f;
    if (s < S) buf0[s] = kNeg;
  }
  // dead frames t >= in_len
  for (int t = t_top > 0 ? t_top : 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      const int s = threadIdx.x + i * nt;
      if (s < S) out[static_cast<size_t>(t) * S + s] = kNeg;
    }
  }
  __syncthreads();

  int k = 0;
  for (int t = t_top - 1; t >= 0; --t, ++k) {
    const float* prev = (k & 1) ? buf1 : buf0;
    float* next = (k & 1) ? buf0 : buf1;
    float enxt[kMaxPer];
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      const int s = threadIdx.x + i * nt;
      enxt[i] = (s < S && t > 0) ? e[static_cast<size_t>(t - 1) * S + s] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      const int s = threadIdx.x + i * nt;
      if (s >= S) continue;
      float nv;
      if (t == L - 1) {
        nv = ecur[i] + term[i];
      } else {
        const float b1 = s + 1 < S ? prev[s + 1] : kNeg;
        const float b2 = skip2[i] ? prev[s + 2] : kNeg;
        nv = ecur[i] + lse3(prev[s], b1, b2);
      }
      next[s] = nv;
      out[static_cast<size_t>(t) * S + s] = nv;
      ecur[i] = enxt[i];
    }
    __syncthreads();
  }
}

int block_threads(int S) {
  int nt = ((S + 31) / 32) * 32;
  return nt > 1024 ? 1024 : nt;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); S must be at most
// 4 * 1024 (the wrapper checks).
extern "C" int ctc_alpha(const float* emit, const uint8_t* allow_skip, const int* in_lens,
                         float* alpha, int B, int T, int S, void* stream) {
  const int nt = block_threads(S);
  if (S > kMaxPer * nt) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(S) * sizeof(float);
  ctc_alpha_kernel<<<B, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      emit, allow_skip, in_lens, alpha, T, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ctc_beta(const float* emit, const uint8_t* allow_skip, const int* in_lens,
                        const int* label_lens, float* beta, int B, int T, int S,
                        void* stream) {
  const int nt = block_threads(S);
  if (S > kMaxPer * nt) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(S) * sizeof(float);
  ctc_beta_kernel<<<B, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      emit, allow_skip, in_lens, label_lens, beta, T, S);
  return static_cast<int>(cudaGetLastError());
}
