// RNN-T (transducer) alpha/beta lattice for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels of statecatcher_tpu/ops/rnnt_dp_pallas.py:
//   K7a  rnnt_alpha_kernel  <- _alpha_kernel (:69), launched by _alpha_all (:143)
//   K7b  rnnt_beta_kernel   <- _beta_kernel (:93), launched by _beta_all (:182)
// and holds the banded lattice of K8's tables (rnnt_band_alpha_kernel,
// rnnt_band_beta_kernel; described at band_lattice below).
//
//   blank    (B, T, U1) f32, U1 = U+1: log P(blank | t, u)
//   emit     (B, T, U) f32: log P(label_u | t, u)
//   t_lens   (B) int32;  u_lens (B) int32 (beta only)
//   ->       alpha or beta (B, T, U1) f32, every row
//
// Rules, as the TPU kernels (ops/rnnt_lattice.py holds the plain versions):
//   alpha: start state (0, -1e30, ...); frame t solves the chain
//          x_u = logaddexp(base_u, x_{u-1} + a_u) with base_u = alpha(t-1, u)
//          + blank(t-1, u) (the start state at t = 0) and a_u = emit(t, u-1);
//          rows t >= t_len repeat the last row.
//   beta:  start (virtual base) 0 at u = u_len, -1e30 elsewhere, which rows
//          t >= t_len keep; frame t (walked downwards) solves
//          x_u = logaddexp(base_u, x_{u+1} + a_u) with base_u = blank(t, u) +
//          beta(t+1, u) and a_u = emit(t, u) (-1e30 at u = U).
//
// Bound on the card: bytes, blank and emit read and alpha (or beta) written
// once: about 3*B*T*U1*4 bytes, 30 MB at B=32, T=1598, U=48, 0.009 ms at
// 3.35 TB/s.  But the T-long chain of dependent frames sets the time, and
// within a frame the u-chain is a scan.
//
// Design: one block per batch row; its threads stride over the U1 lattice
// columns (up to 4 columns each, so U1 <= 4096 with 1024 threads).  A frame's
// chain is a prefix scan of affine maps s -> logaddexp(b, s + a) in the
// (logaddexp, +) semiring: a log-step (Hillis-Steele) scan within each warp
// by register shuffles, then each warp applies the aggregates of the warps
// before it (and of the earlier 1024-column chunks) in order.  Only the
// state matters across warps (the chain starts from s = -inf), so a warp's
// aggregate is applied as s <- logaddexp(b_w, s + a_w).  One
// __syncthreads() per frame and chunk, with the aggregates double
// buffered; none at all when U1 <= 32.  Each column's state stays in its
// thread's registers from frame to frame; blank and emit of the next frame
// are loaded before the current frame's scan.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxPer = 4;
constexpr int kMaxWarps = 32;

// torch.logaddexp for finite arguments
__device__ __forceinline__ float lae(float x, float y) {
  const float m = fmaxf(x, y);
  return m + log1pf(expf(-fabsf(x - y)));
}

// Inclusive scan of the affine maps (A, Bv) within the warp: (a1, b1) then
// (a2, b2) compose to (a1 + a2, logaddexp(b1 + a2, b2))
__device__ __forceinline__ void warp_chain(float& A, float& Bv, int lane) {
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const float a_sh = __shfl_up_sync(0xffffffffu, A, k);
    const float b_sh = __shfl_up_sync(0xffffffffu, Bv, k);
    if (lane >= k) {
      Bv = lae(b_sh + A, Bv);
      A = a_sh + A;
    }
  }
}

template <bool kRev>
__device__ __forceinline__ void load_frame(const float* __restrict__ bl,
                                           const float* __restrict__ em, int t, int T,
                                           int U1, int nt, int nch, float a[kMaxPer],
                                           float bb[kMaxPer]) {
  const int U = U1 - 1;
#pragma unroll
  for (int c = 0; c < kMaxPer; ++c) {
    a[c] = 0.0f;
    bb[c] = 0.0f;
    const int v = c * nt + threadIdx.x;
    if (c >= nch || v >= U1 || t < 0 || t >= T) continue;
    if (kRev) {
      const int u = U1 - 1 - v;
      a[c] = u < U ? em[static_cast<size_t>(t) * U + u] : kNeg;
      bb[c] = bl[static_cast<size_t>(t) * U1 + u];
    } else {
      const int u = v;
      a[c] = u > 0 ? em[static_cast<size_t>(t) * U + u - 1] : kNeg;
      bb[c] = t > 0 ? bl[static_cast<size_t>(t - 1) * U1 + u] : 0.0f;
    }
  }
}

template <bool kRev>
__device__ void lattice(const float* __restrict__ blank, const float* __restrict__ emit,
                        const int* __restrict__ t_lens, const int* __restrict__ u_lens,
                        float* __restrict__ out, int T, int U1) {
  __shared__ float agg_a[2][kMaxWarps];
  __shared__ float agg_b[2][kMaxWarps];
  const int b = blockIdx.x;
  const int nt = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = (nt + 31) >> 5;
  const int nch = (U1 + nt - 1) / nt;
  const bool cross = nw > 1 || nch > 1;
  const int U = U1 - 1;
  int tl = t_lens[b];
  tl = tl < 0 ? 0 : (tl > T ? T : tl);
  const float* bl = blank + static_cast<size_t>(b) * T * U1;
  const float* em = emit + static_cast<size_t>(b) * T * U;
  float* o = out + static_cast<size_t>(b) * T * U1;

  // column state (scan position v = c * nt + threadIdx.x; u = v, or U1-1-v
  // when reversed)
  float st[kMaxPer];
  const int ul = kRev ? u_lens[b] : 0;
#pragma unroll
  for (int c = 0; c < kMaxPer; ++c) {
    const int v = c * nt + threadIdx.x;
    const int u = kRev ? U1 - 1 - v : v;
    st[c] = (u == ul) ? 0.0f : kNeg;
  }
  if (kRev) {
    // rows t >= t_len hold the virtual base
    for (int t = tl; t < T; ++t) {
#pragma unroll
      for (int c = 0; c < kMaxPer; ++c) {
        const int v = c * nt + threadIdx.x;
        if (c < nch && v < U1) o[static_cast<size_t>(t) * U1 + (U1 - 1 - v)] = st[c];
      }
    }
  }

  float a_cur[kMaxPer], b_cur[kMaxPer];
  load_frame<kRev>(bl, em, kRev ? tl - 1 : 0, T, U1, nt, nch, a_cur, b_cur);
  int it = 0;
  for (int s = 0; s < tl; ++s) {
    const int t = kRev ? tl - 1 - s : s;
    float a_nxt[kMaxPer], b_nxt[kMaxPer];
    load_frame<kRev>(bl, em, kRev ? t - 1 : (t + 1 < tl ? t + 1 : -1), T, U1, nt, nch,
                     a_nxt, b_nxt);
    float run = kNeg;  // the chain's state after the earlier chunks
#pragma unroll
    for (int c = 0; c < kMaxPer; ++c) {
      if (c >= nch) break;
      const int v = c * nt + threadIdx.x;
      const bool live = v < U1;
      float A = live ? a_cur[c] : 0.0f;
      float Bv = live ? (kRev ? b_cur[c] + st[c] : st[c] + b_cur[c]) : kNeg;
      warp_chain(A, Bv, lane);
      float x;
      if (cross) {
        const int p = it & 1;
        if (lane == 31) {
          agg_a[p][warp] = A;
          agg_b[p][warp] = Bv;
        }
        __syncthreads();
        float s_in = run;
        for (int w = 0; w < warp; ++w) s_in = lae(agg_b[p][w], s_in + agg_a[p][w]);
        x = lae(Bv, s_in + A);
        if (c + 1 < nch) {
          for (int w = 0; w < nw; ++w) run = lae(agg_b[p][w], run + agg_a[p][w]);
        }
        ++it;
      } else {
        x = lae(Bv, run + A);
      }
      if (live) {
        st[c] = x;
        const int u = kRev ? U1 - 1 - v : v;
        o[static_cast<size_t>(t) * U1 + u] = x;
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxPer; ++c) {
      a_cur[c] = a_nxt[c];
      b_cur[c] = b_nxt[c];
    }
  }
  if (!kRev) {
    // rows t >= t_len repeat the last one
    for (int t = tl; t < T; ++t) {
#pragma unroll
      for (int c = 0; c < kMaxPer; ++c) {
        const int v = c * nt + threadIdx.x;
        if (c < nch && v < U1) o[static_cast<size_t>(t) * U1 + v] = st[c];
      }
    }
  }
}

__global__ void rnnt_alpha_kernel(const float* __restrict__ blank,
                                  const float* __restrict__ emit,
                                  const int* __restrict__ t_lens, float* __restrict__ alpha,
                                  int T, int U1) {
  lattice<false>(blank, emit, t_lens, nullptr, alpha, T, U1);
}

__global__ void rnnt_beta_kernel(const float* __restrict__ blank,
                                 const float* __restrict__ emit,
                                 const int* __restrict__ t_lens,
                                 const int* __restrict__ u_lens, float* __restrict__ beta,
                                 int T, int U1) {
  lattice<true>(blank, emit, t_lens, u_lens, beta, T, U1);
}

// The banded lattice over K8's tables (the port's own kernels; the JAX
// package runs them as an XLA scan, statecatcher_tpu/ops/rnnt_band.py:
// rnnt_nll_banded, :319).  Column w of frame t is label position
// u = o(t) + w, o(t) = o[b, t / Tb], so the state moves between windows
// where the band start steps by δ (a multiple of 8, >= 0):
//   alpha: frame 0 from the start state (0, -1e30, ...); frame t >= 1 from
//          base_w = (alpha(t-1) + blank(t-1))[w + δ] (-1e30 past the window),
//          δ = o(t) - o(t-1), then the chain x_w = logaddexp(base_w,
//          x_{w-1} + emit(t, w-1)); frames t >= max(t_len, 1) repeat the last.
//   beta:  the virtual base 0 at the corner column w* = u_len - o(t_last),
//          t_last = max(t_len, 1) - 1 (-1e30 everywhere when w* is outside the
//          window), which frames t > t_last hold; frame t <= t_last from
//          base_w = blank(t, w) + beta(t+1)[w - δ], δ = o(t+1) - o(t), then
//          x_w = logaddexp(base_w, x_{w+1} + emit(t, w)), emit(t, Wp-1) unused.
// One block of round_up(Wp, 32) threads per batch row, one column each
// (Wp <= 1024): the chain is K7's scan; a window shift goes through shared
// memory (double buffered), one barrier per shift, once per time block.
template <bool kRev>
__device__ void band_lattice(const float* __restrict__ blank, const float* __restrict__ emit,
                             const int* __restrict__ o, const int* __restrict__ t_lens,
                             const int* __restrict__ u_lens, float* __restrict__ out, int Tp,
                             int Wp, int Tb) {
  __shared__ float agg_a[2][kMaxWarps];
  __shared__ float agg_b[2][kMaxWarps];
  __shared__ float win[2][1024];
  const int b = blockIdx.x;
  const int v = threadIdx.x;  // scan position
  const int lane = v & 31, warp = v >> 5, nw = (blockDim.x + 31) >> 5;
  const bool live = v < Wp;
  const int w = kRev ? Wp - 1 - v : v;  // window column
  const int* ob = o + static_cast<size_t>(b) * (Tp / Tb);
  int tl = t_lens[b];
  tl = tl < 1 ? 1 : (tl > Tp ? Tp : tl);
  const size_t off = static_cast<size_t>(b) * Tp * Wp;
  const float* bl = blank + off;
  const float* em = emit + off;
  float* ob_out = out + off;

  float st;
  if (kRev) {
    const int ws = u_lens[b] - ob[(tl - 1) / Tb];
    st = (live && w == ws) ? 0.0f : kNeg;
    for (int t = tl; t < Tp; ++t)
      if (live) ob_out[static_cast<size_t>(t) * Wp + w] = st;
  } else {
    st = w == 0 ? 0.0f : kNeg;
  }
  int it = 0, iw = 0;
  for (int s = 0; s < tl; ++s) {
    const int t = kRev ? tl - 1 - s : s;
    float nb = st;
    int delta = 0;
    if (kRev) {
      delta = (t + 1 < Tp ? ob[(t + 1) / Tb] : ob[t / Tb]) - ob[t / Tb];
    } else if (t > 0) {
      if (live) nb = st + bl[static_cast<size_t>(t - 1) * Wp + w];
      delta = ob[t / Tb] - ob[(t - 1) / Tb];
    }
    if (delta != 0) {  // the same for the whole block
      float* buf = win[iw & 1];
      if (live) buf[w] = nb;
      __syncthreads();
      const int src = kRev ? w - delta : w + delta;
      nb = (live && src >= 0 && src < Wp) ? buf[src] : kNeg;
      ++iw;
    }
    float A = 0.0f, Bv = kNeg;
    if (live) {
      if (kRev) {
        A = w < Wp - 1 ? em[static_cast<size_t>(t) * Wp + w] : kNeg;
        Bv = bl[static_cast<size_t>(t) * Wp + w] + nb;
      } else {
        A = w > 0 ? em[static_cast<size_t>(t) * Wp + w - 1] : kNeg;
        Bv = nb;
      }
    }
    warp_chain(A, Bv, lane);
    float x;
    if (nw > 1) {
      const int p = it & 1;
      if (lane == 31) {
        agg_a[p][warp] = A;
        agg_b[p][warp] = Bv;
      }
      __syncthreads();
      float s_in = kNeg;
      for (int q = 0; q < warp; ++q) s_in = lae(agg_b[p][q], s_in + agg_a[p][q]);
      x = lae(Bv, s_in + A);
      ++it;
    } else {
      x = lae(Bv, kNeg + A);
    }
    if (live) {
      st = x;
      ob_out[static_cast<size_t>(t) * Wp + w] = x;
    }
  }
  if (!kRev) {
    for (int t = tl; t < Tp; ++t)
      if (live) ob_out[static_cast<size_t>(t) * Wp + w] = st;
  }
}

__global__ void rnnt_band_alpha_kernel(const float* __restrict__ blank,
                                       const float* __restrict__ emit,
                                       const int* __restrict__ o,
                                       const int* __restrict__ t_lens,
                                       float* __restrict__ alpha, int Tp, int Wp, int Tb) {
  band_lattice<false>(blank, emit, o, t_lens, nullptr, alpha, Tp, Wp, Tb);
}

__global__ void rnnt_band_beta_kernel(const float* __restrict__ blank,
                                      const float* __restrict__ emit, const int* __restrict__ o,
                                      const int* __restrict__ t_lens,
                                      const int* __restrict__ u_lens, float* __restrict__ beta,
                                      int Tp, int Wp, int Tb) {
  band_lattice<true>(blank, emit, o, t_lens, u_lens, beta, Tp, Wp, Tb);
}

int block_threads(int U1) {
  int nt = ((U1 + 31) / 32) * 32;
  return nt > 1024 ? 1024 : nt;
}

bool band_ok(int Tp, int Wp, int Tb) {
  return Wp > 0 && Wp <= 1024 && Tb > 0 && Tp % Tb == 0;
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success); U1 must be at
// most 4 * 1024 (the wrapper checks).
extern "C" int rnnt_alpha(const float* blank, const float* emit, const int* t_lens,
                          float* alpha, int B, int T, int U1, void* stream) {
  const int nt = block_threads(U1);
  if (U1 > kMaxPer * nt) return static_cast<int>(cudaErrorInvalidValue);
  rnnt_alpha_kernel<<<B, nt, 0, static_cast<cudaStream_t>(stream)>>>(blank, emit, t_lens,
                                                                     alpha, T, U1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rnnt_beta(const float* blank, const float* emit, const int* t_lens,
                         const int* u_lens, float* beta, int B, int T, int U1, void* stream) {
  const int nt = block_threads(U1);
  if (U1 > kMaxPer * nt) return static_cast<int>(cudaErrorInvalidValue);
  rnnt_beta_kernel<<<B, nt, 0, static_cast<cudaStream_t>(stream)>>>(blank, emit, t_lens,
                                                                    u_lens, beta, T, U1);
  return static_cast<int>(cudaGetLastError());
}

// The banded lattice: blank, emit (B, Tp, Wp) f32, o (B, Tp/Tb) int32 band
// starts, t_lens (and u_lens) (B) int32 -> alpha or beta (B, Tp, Wp).  Wp at
// most 1024 and Tb dividing Tp (the wrapper checks).
extern "C" int rnnt_band_alpha(const float* blank, const float* emit, const int* o,
                               const int* t_lens, float* alpha, int B, int Tp, int Wp, int Tb,
                               void* stream) {
  if (!band_ok(Tp, Wp, Tb)) return static_cast<int>(cudaErrorInvalidValue);
  rnnt_band_alpha_kernel<<<B, block_threads(Wp), 0, static_cast<cudaStream_t>(stream)>>>(
      blank, emit, o, t_lens, alpha, Tp, Wp, Tb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rnnt_band_beta(const float* blank, const float* emit, const int* o,
                              const int* t_lens, const int* u_lens, float* beta, int B, int Tp,
                              int Wp, int Tb, void* stream) {
  if (!band_ok(Tp, Wp, Tb)) return static_cast<int>(cudaErrorInvalidValue);
  rnnt_band_beta_kernel<<<B, block_threads(Wp), 0, static_cast<cudaStream_t>(stream)>>>(
      blank, emit, o, t_lens, u_lens, beta, Tp, Wp, Tb);
  return static_cast<int>(cudaGetLastError());
}
