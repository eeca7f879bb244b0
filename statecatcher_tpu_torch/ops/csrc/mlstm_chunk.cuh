// The stabilised chunkwise mLSTM for Hopper (sm_90a): the chunk math of K9a,
// K9b (mlstm_fused.cu) and K10 (mlstm_pallas.cu).
//
// Per (b, head), chunk of L steps, entry state C (dqk x dv), n (dqk), m;
// inv = dqk^-1/2 (1 when q comes pre-scaled, as for K10):
//   b_t = sum_{j<=t} logf_j,  a_t = i_t - b_t,  R_t = max_{s<=t} a_s,
//   mu_t = b_t + max(m, R_t),  E[t,s] = exp(b_t + a_s - mu_t) (s <= t, else 0),
//   W[t,s] = inv (q_t . k_s) E[t,s],  sp_t = exp(b_t + m - mu_t),
//   qn_t = sum_s W[t,s] + sp_t inv (q_t . n),  den_t = max(|qn_t|, exp(-mu_t)),
//   h_t = (sum_s W[t,s] v_s + sp_t inv q_t C) / den_t,
//   m' = max(m + b_L, b_L + R_L),  g = exp(m + b_L - m'),  w_t = exp(b_L + a_t - m'),
//   C' = g C + sum_t w_t k_t v_t^T,  n' = g n + sum_t w_t k_t.
// (qn is the JAX package's q . (E k + sp n) / sqrt(dqk), summed in another
// order: the E k product is never formed.)  Every product is float32 whatever
// the inputs' type, as the TPU kernels upcast their tiles.  Rows t >= T of
// the padded time axis read q, k, v (and dh) as 0, the input gate as -1e30
// and the log-forget as 0, so they neither write nor decay the state.
//
// Bound on the card (operations; counted in chip_smoke.py): per (b, head)
// and chunk the products S = q k^T, (S.E) v, q C and (k w)^T v, ~34 MFLOP
// at L = 128, dqk = 128, dv = 256, against ~80 KB of inputs, at 3xTF32's rate
// (bf16's for q k^T of bf16 inputs): 0.12 ms at B=32, T=1598 in f32.
//
// Design.  A block of 256 threads works on 64 x 64 output tiles of every
// product (tile_mma: 16-deep slabs of both operands staged in shared memory,
// each thread a 4 x 4 register tile, float32 FMAs; no tensor cores yet).  The
// chunk's gate scalars (b, a, R, mu, sp, w) are worked out once per chunk into
// shared memory.
//   * forward (mlstm_fwd_kernel): grid (ceil(dv/64), B*H).  A block owns 64
//     columns of C and h and walks the chunks in order: per 64-row tile of the
//     chunk it forms W (rows x s <= the tile's end) in shared memory, each
//     row's denominator, then h = (W v + (q sp inv) C) / den; then it advances
//     its columns of C (and the whole n, m, which every block keeps).  Every
//     block recomputes W: dv/64 times the S work, for dv/64 times the blocks.
//   * backward (K9b, mlstm_fused.cu): the adjoint split along its data
//     dependencies into chunk-parallel passes on the tensor cores (the entry
//     states, the rows' terms and dq, the reverse scans of dC and dn, dk, dv,
//     the gate chain and its dm fix-up); its design is written there.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace mlstm {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // output tile 64 x 64: 256 threads x (4 x 4)
constexpr int kSlab = 16;            // contraction depth staged per step
constexpr int kPad = kTile + 1;      // staged row pitch (no bank conflicts on reads)
constexpr int kStage = 2 * kSlab * kPad;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// acc[i][j] += sum_{k0 <= k < k1} A(m, k) B(k, n) for the block's 64 x 64 tile,
// m = ty + 16 i, n = tx + 16 j (ty = tid / 16, tx = tid % 16).  fa(m, k) and
// fb(k, n) return an operand (0 outside the problem).  kAKFast / kBNFast pick
// which index neighbouring threads load along (k for A, n for B when true),
// so that the loads follow the operand's contiguous axis.
template <bool kAKFast, bool kBNFast, class FA, class FB>
__device__ __forceinline__ void tile_mma(int k0, int k1, FA fa, FB fb, float* stage,
                                         float (&acc)[4][4]) {
  float* As = stage;
  float* Bs = stage + kSlab * kPad;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int kb = k0; kb < k1; kb += kSlab) {
#pragma unroll
    for (int r = 0; r < kTile * kSlab / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int am = kAKFast ? e / kSlab : e % kTile;
      const int ak = kAKFast ? e % kSlab : e / kTile;
      As[ak * kPad + am] = kb + ak < k1 ? fa(am, kb + ak) : 0.f;
      const int bn = kBNFast ? e % kTile : e / kSlab;
      const int bk = kBNFast ? e / kTile : e % kSlab;
      Bs[bk * kPad + bn] = kb + bk < k1 ? fb(kb + bk, bn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * kPad + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Share of the gradient of max(x, y) that goes to x: 1, 1/2 on a tie, 0.
__device__ __forceinline__ float to_first(float x, float y) {
  return x > y ? 1.f : (x == y ? 0.5f : 0.f);
}

// The chunk's gate scalars in shared memory: gs = b[L] a[L] R[L] mu[L] sp[L]
// w[L] and bL, A = R_{L-1}, m', g.  ic, lf point at this (b, head)'s (Tp,)
// rows; t0 is the chunk's first step, m its entry max-state.
struct Gates {
  float *b, *a, *R, *mu, *sp, *w, *sc;
  __device__ Gates(float* gs, int L)
      : b(gs), a(gs + L), R(gs + 2 * L), mu(gs + 3 * L), sp(gs + 4 * L), w(gs + 5 * L),
        sc(gs + 6 * L) {}
};

__device__ void gate_prep(const float* ic, const float* lf, int t0, int T, int L, float m,
                          const Gates& G) {
  if (threadIdx.x == 0) {
    float run = 0.f, R = 0.f;
    for (int t = 0; t < L; ++t) {
      const bool valid = t0 + t < T;
      run += valid ? lf[t0 + t] : 0.f;
      const float a = (valid ? ic[t0 + t] : kNeg) - run;
      R = t == 0 ? a : fmaxf(R, a);
      const float mu = run + fmaxf(m, R);
      G.b[t] = run;
      G.a[t] = a;
      G.R[t] = R;
      G.mu[t] = mu;
      G.sp[t] = expf(run + m - mu);
    }
    const float bL = G.b[L - 1], A = G.R[L - 1], mn = fmaxf(m + bL, bL + A);
    G.sc[0] = bL;
    G.sc[1] = A;
    G.sc[2] = mn;
    G.sc[3] = expf(m + bL - mn);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < L; t += kThreads) G.w[t] = expf(G.sc[0] + G.a[t] - G.sc[2]);
  __syncthreads();
}

// Element strides of one (b, head)'s rows: q and k (qk_*), v, h and dh (v_*).
struct Layout {
  long long qk_b, qk_h, qk_r, v_b, v_h, v_r;
};

// Rows of one (b, head): q, k, v and the gates, masked past T.
template <typename Tin>
struct Rows {
  const Tin *q, *k, *v;
  long long qk_r, v_r;
  int t0, T, L;
  __device__ bool valid(int t) const { return t < L && t0 + t < T; }
  __device__ float Q(int t, int d) const {
    return valid(t) ? ld(q + static_cast<size_t>(t0 + t) * qk_r + d) : 0.f;
  }
  __device__ float K(int t, int d) const {
    return valid(t) ? ld(k + static_cast<size_t>(t0 + t) * qk_r + d) : 0.f;
  }
  __device__ float V(int t, int c) const {
    return valid(t) ? ld(v + static_cast<size_t>(t0 + t) * v_r + c) : 0.f;
  }
};

struct FwdParams {
  const void *q, *k, *v;
  const float *ic, *lf, *C0, *n0, *m0;
  void* h;
  float *CT, *nT, *mT;
  Layout lay;
  int H, Tp, T, dqk, dv, L;
  float inv;
};

inline size_t fwd_smem_bytes(int dqk, int L) {
  return sizeof(float) * (static_cast<size_t>(dqk) * kTile + dqk + kTile * L + 6 * L + 4 + kTile +
                          kStage);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads) mlstm_fwd_kernel(FwdParams p) {
  extern __shared__ float sm[];
  const int L = p.L, dqk = p.dqk, dv = p.dv, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y, b = bh / p.H, hh = bh % p.H;
  const int c0 = blockIdx.x * kTile;                     // this block's columns of C and h
  const int ncol = min(kTile, dv - c0);
  float* Cs = sm;                                        // dqk x 64
  float* ns = Cs + dqk * kTile;                          // dqk
  float* Wt = ns + dqk;                                  // 64 rows x L
  const Gates G(Wt + kTile * L, L);
  float* rden = G.sc + 4;                                // 64
  float* stage = rden + kTile;

  const Layout& y = p.lay;
  Rows<Tin> rows{static_cast<const Tin*>(p.q) + b * y.qk_b + hh * y.qk_h,
                 static_cast<const Tin*>(p.k) + b * y.qk_b + hh * y.qk_h,
                 static_cast<const Tin*>(p.v) + b * y.v_b + hh * y.v_h, y.qk_r, y.v_r, 0, p.T, L};
  Tout* h = static_cast<Tout*>(p.h) + b * y.v_b + hh * y.v_h;
  const float* ic = p.ic + static_cast<size_t>(bh) * p.Tp;
  const float* lf = p.lf + static_cast<size_t>(bh) * p.Tp;
  const size_t sC = static_cast<size_t>(bh) * dqk * dv;
  for (int e = tid; e < dqk * kTile; e += kThreads) {
    const int d = e / kTile, c = e % kTile;
    Cs[e] = c < ncol ? p.C0[sC + static_cast<size_t>(d) * dv + c0 + c] : 0.f;
  }
  for (int d = tid; d < dqk; d += kThreads) ns[d] = p.n0[static_cast<size_t>(bh) * dqk + d];
  float m = p.m0[bh];
  __syncthreads();

  const int NC = p.Tp / L;
  for (int c = 0; c < NC; ++c) {
    rows.t0 = c * L;
    gate_prep(ic, lf, rows.t0, p.T, L, m, G);
    const float g = G.sc[3], m_new = G.sc[2];

    for (int tt0 = 0; tt0 < L; tt0 += kTile) {
      const int s_end = min(L, tt0 + kTile);
      // W for the tile's rows, columns s < s_end (0 above the diagonal)
      for (int s0 = 0; s0 < s_end; s0 += kTile) {
        float acc[4][4] = {};
        tile_mma<true, false>(
            0, dqk, [&](int mm, int d) { return rows.Q(tt0 + mm, d); },
            [&](int d, int nn) { return rows.K(s0 + nn, d); }, stage, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = tt0 + ty + 16 * i, s = s0 + tx + 16 * j;
            if (t < L && s < s_end)
              Wt[(ty + 16 * i) * L + s] =
                  s <= t ? acc[i][j] * p.inv * expf(G.b[t] + G.a[s] - G.mu[t]) : 0.f;
          }
      }
      __syncthreads();
      // each row's denominator: one warp per row
      for (int r = tid >> 5; r < kTile; r += kThreads / 32) {
        const int t = tt0 + r, lane = tid & 31;
        if (t >= L) continue;
        float sw = 0.f, qn_ = 0.f;
        for (int s = lane; s <= t; s += 32) sw += Wt[r * L + s];
        for (int d = lane; d < dqk; d += 32) qn_ += rows.Q(t, d) * ns[d];
        sw = warp_sum(sw);
        qn_ = warp_sum(qn_);
        if (lane == 0) rden[r] = fmaxf(fabsf(sw + G.sp[t] * p.inv * qn_), expf(-G.mu[t]));
      }
      __syncthreads();
      float acc[4][4] = {};
      tile_mma<true, true>(
          0, s_end, [&](int mm, int s) { return tt0 + mm < L ? Wt[mm * L + s] : 0.f; },
          [&](int s, int nn) { return nn < ncol ? rows.V(s, c0 + nn) : 0.f; }, stage, acc);
      tile_mma<true, true>(
          0, dqk,
          [&](int mm, int d) {
            const int t = tt0 + mm;
            return t < L ? rows.Q(t, d) * (G.sp[t] * p.inv) : 0.f;
          },
          [&](int d, int nn) { return Cs[d * kTile + nn]; }, stage, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = tt0 + ty + 16 * i, col = tx + 16 * j;
          if (t < L && col < ncol)
            st(h + static_cast<size_t>(rows.t0 + t) * y.v_r + c0 + col,
               acc[i][j] / rden[ty + 16 * i]);
        }
      __syncthreads();
    }

    // the state advance: this block's columns of C, and all of n
    for (int d0 = 0; d0 < dqk; d0 += kTile) {
      float acc[4][4] = {};
      tile_mma<false, true>(
          0, L,
          [&](int mm, int s) { return d0 + mm < dqk ? rows.K(s, d0 + mm) * G.w[s] : 0.f; },
          [&](int s, int nn) { return nn < ncol ? rows.V(s, c0 + nn) : 0.f; }, stage, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = d0 + ty + 16 * i, col = tx + 16 * j;
          if (d < dqk) Cs[d * kTile + col] = g * Cs[d * kTile + col] + acc[i][j];
        }
    }
    for (int d = tid; d < dqk; d += kThreads) {
      float sum = 0.f;
      for (int t = 0; t < L; ++t) sum += rows.K(t, d) * G.w[t];
      ns[d] = g * ns[d] + sum;
    }
    m = m_new;
    __syncthreads();
  }

  for (int e = tid; e < dqk * kTile; e += kThreads) {
    const int d = e / kTile, col = e % kTile;
    if (col < ncol) p.CT[sC + static_cast<size_t>(d) * dv + c0 + col] = Cs[e];
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < dqk; d += kThreads) p.nT[static_cast<size_t>(bh) * dqk + d] = ns[d];
    if (tid == 0) p.mT[bh] = m;
  }
}

template <typename Tin, typename Tout>
int launch_fwd(const FwdParams& p, int B, cudaStream_t s) {
  const size_t smem = fwd_smem_bytes(p.dqk, p.L);
  cudaError_t err = cudaFuncSetAttribute(mlstm_fwd_kernel<Tin, Tout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.dv + kTile - 1) / kTile, B * p.H);
  mlstm_fwd_kernel<Tin, Tout><<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mlstm
