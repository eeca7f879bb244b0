// RNN-T (transducer) alpha/beta lattice for Hopper (sm_90a).
//
// Replaces the TPU kernels of statecatcher_tpu/ops/rnnt_dp_pallas.py:
//   K7a  rnnt_alpha  <- _alpha_kernel (:69), launched by _alpha_all (:143)
//   K7b  rnnt_beta   <- _beta_kernel (:93), launched by _beta_all (:182)
// and launches the banded lattice of K8's tables (rnnt_band_alpha,
// rnnt_band_beta).  Two routes; the caller picks one from the shape alone
// before launch (ops/rnnt_lattice.py wavefront_route) and passes it in, and
// a route that cannot take the shape fails the launch:
//
//   route       shapes                          kernels
//   wavefront   U1 <= 1024, T * U1 < 2^31       exact_wavefront_kernel<kRev, C, kRing>
//                                               (rnnt_wavefront.cuh; the banded lattice's
//                                               band_wavefront_kernel is the same walk)
//   scan        U1 > 1024 (up to 4096), or      rnnt_alpha_kernel, rnnt_beta_kernel (below)
//               T * U1 >= 2^31
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
//          rows t >= t_len repeat the last row (every row is the start state
//          when t_len <= 0).
//   beta:  start (virtual base) 0 at u = u_len, -1e30 elsewhere, which rows
//          t >= t_len keep; frame t (walked downwards) solves
//          x_u = logaddexp(base_u, x_{u+1} + a_u) with base_u = blank(t, u) +
//          beta(t+1, u) and a_u = emit(t, u) (-1e30 at u = U).
//
// Bound on the card: bytes, blank and emit read and alpha (or beta) written
// once: about 3*B*T*U1*4 bytes, 30 MB at B=32, T=1598, U=48, 0.009 ms at
// 3.35 TB/s.  But a row is one chain of dependent cells.
//
// The wavefront (rnnt_wavefront.cuh) walks the anti-diagonals d = t + u, a
// block of two warps a row: a producer warp builds each diagonal's cell
// records from a cp.async ring of frame rows (its own device loads where the
// ring does not fit in shared memory, U1 above ~140), a consumer warp walks
// the chain, one shuffle and one logaddexp a diagonal: T + U diagonals a
// row.  Its logaddexp is torch.logaddexp's own operations (the accurate
// expf/log1pf), and it keeps a row's values less a whole-number shift
// moved every 8 diagonals (so that its chain does not round values of
// ~1e4), so the plain versions (ops/rnnt_lattice.py, which walk the same
// diagonals with the same shift) give its bits.
//
// The scan: one block per batch row; its threads stride over the U1 lattice
// columns (up to 4 columns each, so U1 <= 4096 with 1024 threads).  A frame's
// chain is a prefix scan of affine maps s -> logaddexp(b, s + a) in the
// (logaddexp, +) semiring: a log-step (Hillis-Steele) scan within each warp
// by register shuffles, then each warp applies the aggregates of the warps
// before it (and of the earlier 1024-column chunks) in order.  Only the
// state matters across warps (the chain starts from s = -inf), so a warp's
// aggregate is applied as s <- logaddexp(b_w, s + a_w).  One
// __syncthreads() per frame and chunk, with the aggregates double
// buffered.  Each column's state stays in its thread's registers from frame
// to frame; blank and emit of the next frame are loaded before the current
// frame's scan.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "rnnt_wavefront.cuh"

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
// rnnt_nll_banded, :319): the anti-diagonal wavefront of rnnt_wavefront.cuh,
// a block of two warps a batch row.

int block_threads(int U1) {
  int nt = ((U1 + 31) / 32) * 32;
  return nt > 1024 ? 1024 : nt;
}

bool band_ok(const float* blank, const float* emit, int Tp, int Wp, int Tb) {
  const auto aligned = [](const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; };
  return Wp > 0 && Wp % 4 == 0 && Wp <= rnnt_wavefront::kMaxWp && Tb > 0 && Tp % Tb == 0 &&
         static_cast<long long>(Tp) * Tb < (1LL << 32) &&
         static_cast<long long>(Tp) * Wp < (1LL << 31) && aligned(blank) && aligned(emit);
}

// The wavefront's int offsets hold the tables (its launch refuses U1 > kMaxWp)
bool offsets_fit(int T, int U1) { return static_cast<long long>(T) * U1 < (1LL << 31); }

}  // namespace

// Each returns the cudaError_t of its launch (0 on success); `wavefront`
// picks the wavefront (1) or the scan (0).  U1 must be at most 4 * 1024 (the
// wrapper checks).
extern "C" int rnnt_alpha(const float* blank, const float* emit, const int* t_lens,
                          float* alpha, int B, int T, int U1, int wavefront, void* stream) {
  if (wavefront) {
    if (!offsets_fit(T, U1)) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(rnnt_wavefront::launch_exact<false>(
        blank, emit, t_lens, nullptr, alpha, B, T, U1, static_cast<cudaStream_t>(stream)));
  }
  const int nt = block_threads(U1);
  if (U1 > kMaxPer * nt) return static_cast<int>(cudaErrorInvalidValue);
  rnnt_alpha_kernel<<<B, nt, 0, static_cast<cudaStream_t>(stream)>>>(blank, emit, t_lens,
                                                                     alpha, T, U1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rnnt_beta(const float* blank, const float* emit, const int* t_lens,
                         const int* u_lens, float* beta, int B, int T, int U1, int wavefront,
                         void* stream) {
  if (wavefront) {
    if (!offsets_fit(T, U1)) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(rnnt_wavefront::launch_exact<true>(
        blank, emit, t_lens, u_lens, beta, B, T, U1, static_cast<cudaStream_t>(stream)));
  }
  const int nt = block_threads(U1);
  if (U1 > kMaxPer * nt) return static_cast<int>(cudaErrorInvalidValue);
  rnnt_beta_kernel<<<B, nt, 0, static_cast<cudaStream_t>(stream)>>>(blank, emit, t_lens,
                                                                    u_lens, beta, T, U1);
  return static_cast<int>(cudaGetLastError());
}

// The banded lattice: blank, emit (B, Tp, Wp) f32, 16-byte aligned; o (B,
// Tp/Tb) int32 band starts, t_lens (and u_lens) (B) int32 -> alpha or beta
// (B, Tp, Wp).  Wp a multiple of 4, at most 1024; Tb dividing Tp (the wrapper
// checks).
extern "C" int rnnt_band_alpha(const float* blank, const float* emit, const int* o,
                               const int* t_lens, float* alpha, int B, int Tp, int Wp, int Tb,
                               void* stream) {
  if (!band_ok(blank, emit, Tp, Wp, Tb)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(rnnt_wavefront::launch<false>(
      blank, emit, o, t_lens, nullptr, alpha, B, Tp, Wp, Tb, static_cast<cudaStream_t>(stream)));
}

extern "C" int rnnt_band_beta(const float* blank, const float* emit, const int* o,
                              const int* t_lens, const int* u_lens, float* beta, int B, int Tp,
                              int Wp, int Tb, void* stream) {
  if (!band_ok(blank, emit, Tp, Wp, Tb)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(rnnt_wavefront::launch<true>(
      blank, emit, o, t_lens, u_lens, beta, B, Tp, Wp, Tb, static_cast<cudaStream_t>(stream)));
}
