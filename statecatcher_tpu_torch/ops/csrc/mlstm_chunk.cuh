// The stabilised chunkwise mLSTM for Hopper (sm_90a): the math of K9a, K9b
// (mlstm_fused.cu) and K10 (mlstm_pallas.cu); the passes that the forward and
// K9b share, and the forward's own.
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
// Any chunk L and width dqk, dv: the gate passes take ceil(L/256) rows a
// thread and keep the chunk's rows in dynamic shared memory sized by L
// (rows_scan, rows_floats); every product contracts over dqk, dv or L in
// 32-deep slabs and tiles its outputs 64 wide, so neither width has a limit
// of its own.  At L <= 256 every pass takes the same operations in the same
// order as with one row a thread.
//
// Design of the forward (K9a and K10: one launcher, launch_fwd, over a Layout
// of row strides: lane-major for K9a; head-major with H = 1 and inv = 1 for
// K10).  The chunk step is split along its data dependencies, as K9b splits
// its adjoint (mlstm_fused.cu), into chunk-parallel passes in stream order
// (grids at B=32, H=2, T=1598, L=128, dqk=128, dv=256: NC = 13 chunks):
//   1. gates   (NC, B*H): b, a, R per row, bL and A per chunk (block scans);
//      gates_m (NC, B*H): m at each chunk's entry by a scalar walk over the
//      earlier chunks' (bL, A), then mu, sp, w per row, g per chunk, m_T;
//   2. state   (dqk/64 * dv/64, NC-1, B*H) and nterm (NC-1, B*H, dqk/64):
//      each chunk's sum_t w_t k_t v_t^T and sum_t w_t k_t;
//   3. scan_fwd (E/256, B*H): every chunk's entry (C, n) by the elementwise
//      carry C_c = g_{c-1} C_{c-1} + (2.);
//   4. fwd_exit (dqk/64 * dv/64, B*H): C_T = g C_{NC-1} + the last chunk's
//      term, and n_T likewise in the blocks of the first column tile;
//   5. fwd_out (L/64 * ceil(dv/NV), NC, B*H: 3328 blocks): 64 rows of one
//      chunk and NV = 128 columns of h (64 where dv <= 64; two blocks per SM,
//      S formed once per column tile): acc = (q C_c) sp inv, then for each
//      s-tile up to the diagonal
//      S = q k^T (64 x 64, never in global memory), W = inv S E from the
//      chunk's b, a and the rows' mu in shared memory, the row sums sw in a
//      fixed order, W staged as split pairs and acc += W v; then
//      den = max(|sw + sp inv q.n_c|, exp(-mu)) and h = acc / den.
// With one chunk (NC = 1, as streaming runs it) pass 1 runs as one block
// (gates_one) and passes 2 and 3 fall away (the entry state is C0, n0): three
// launches.  Every product runs on the tensor cores (mma.sync, mma_frag.cuh):
// q k^T in bf16 for bf16 inputs, the others in 3xTF32 (two products where
// one operand is a bf16 input taken as it is).  Sums over elements take fixed
// orders and there are no float atomics, so two calls give the same bits, and
// K9b, which recomputes the entry states through passes 1-3, gets the
// forward's.  The workspace (work_layout) holds per (b, head) NC x (dqk dv +
// dqk) floats of entry states and the row and chunk fields.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma_frag.cuh"

namespace mlstm {
namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // rows of an output tile (and its 64-wide slices)
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Share of the gradient of max(x, y) that goes to x: 1, 1/2 on a tie, 0.
__device__ __forceinline__ float to_first(float x, float y) {
  return x > y ? 1.f : (x == y ? 0.5f : 0.f);
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

// ---------------------------------------------------------------------------
// Tensor-core tiles: 256 threads as 8 warps, 2 (rows) x 4 (columns), over an
// output tile of 64 rows x N columns (N = 64, 128 or 256); each warp owns 32
// rows x N/4 columns, i.e. 2 x N/32 fragments of 16 x 8.  acc[i][j][e] sits at
// row 32*wm + 16*i + gq + 8*(e/2), column (N/4)*wn + 8*j + 2*tq + e%2.
// ---------------------------------------------------------------------------
constexpr int kKS = 32;              // contraction depth staged per step
constexpr int kPF = kKS + 4;         // row pitch (in pairs) of a [row][k] slab
constexpr int kPH = kKS + 8;         // bf16 row pitch of a [row][k] slab
constexpr int kQP = kTile + 4;       // pitch of a 64 x 64 f32 operand tile

template <int N>
using Acc = float[2][N / 32][4];

// floats of the staging area for tiles up to N columns: A and B slabs of
// (hi, lo) tf32 pairs, each [row][k] with pitch kPF or [k][row] with pitch
// rows + 4 (in pairs)
__host__ __device__ constexpr int slab_floats(int rows) {
  return 2 * (rows * kPF > kKS * (rows + 4) ? rows * kPF : kKS * (rows + 4));
}
__host__ __device__ constexpr int stage_floats(int N) {
  return slab_floats(kTile) + slab_floats(N);
}

struct WarpPos {
  int wm, wn, gq, tq;
  __device__ WarpPos()
      : wm((threadIdx.x >> 5) & 1), wn(threadIdx.x >> 6), gq((threadIdx.x & 31) >> 2),
        tq(threadIdx.x & 3) {}
};

// f(row, column, value&) for each element of the thread's fragments
template <int N, class F>
__device__ __forceinline__ void each(Acc<N>& acc, F f) {
  const WarpPos w;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < N / 32; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(32 * w.wm + 16 * i + w.gq + 8 * (e >> 1), (N / 4) * w.wn + 8 * j + 2 * w.tq + (e & 1),
          acc[i][j][e]);
}

template <int N>
__device__ __forceinline__ void zero(Acc<N>& acc) {
  each<N>(acc, [](int, int, float& x) { x = 0.f; });
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A row-major operand: element (row, col) at p[row * ld + col], read as 0 at
// row >= nrow or col >= ncol, times rs[row] when rs is given (not for the
// bf16 products, which take their operands as they are).
template <typename T>
struct Mat {
  const T* p;
  long long ld;
  int nrow, ncol;
  const float* rs;
};

template <typename T>
__device__ __forceinline__ Mat<T> mat(const T* p, long long ld, int nrow, int ncol,
                                      const float* rs = nullptr) {
  return Mat<T>{p, ld, nrow, ncol, rs};
}

// four consecutive elements of a row as floats (0 outside); vec: 4-wide loads
__device__ __forceinline__ float4 ld4v(const float* q) {
  return *reinterpret_cast<const float4*>(q);
}
__device__ __forceinline__ float4 ld4v(const __nv_bfloat16* q) {
  const uint2 u = *reinterpret_cast<const uint2*>(q);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ float4 ld4(const Mat<T>& X, int row, int col, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < X.nrow && col < X.ncol) {
    const T* q = X.p + row * X.ld + col;
    if (vec && col + 3 < X.ncol) {
      v = ld4v(q);
    } else {
      float* f = &v.x;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (col + u < X.ncol) f[u] = ld(q + u);
    }
    if (X.rs != nullptr) {
      const float sc = X.rs[row];
      v.x *= sc;
      v.y *= sc;
      v.z *= sc;
      v.w *= sc;
    }
  }
  return v;
}

// four consecutive bf16 elements of a row, as they are (0 outside)
__device__ __forceinline__ uint2 ld4h(const Mat<__nv_bfloat16>& X, int row, int col, bool vec) {
  if (row >= X.nrow || col >= X.ncol) return make_uint2(0u, 0u);
  const __nv_bfloat16* q = X.p + row * X.ld + col;
  if (vec && col + 3 < X.ncol) return *reinterpret_cast<const uint2*>(q);
  float f[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) f[u] = col + u < X.ncol ? __bfloat162float(q[u]) : 0.f;
  return make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}

template <typename T>
__device__ __forceinline__ bool aligned4(const Mat<T>& X) {
  return X.ld % 4 == 0 && reinterpret_cast<uintptr_t>(X.p) % (4 * sizeof(T)) == 0;
}

// four staged operands as (hi, lo) tf32 pairs at p (16-byte aligned)
__device__ __forceinline__ void st4_split(float* p, float4 v) {
  const Split a = split_tf32(v.x), b = split_tf32(v.y), c = split_tf32(v.z), d = split_tf32(v.w);
  reinterpret_cast<uint4*>(p)[0] = make_uint4(a.hi, a.lo, b.hi, b.lo);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(c.hi, c.lo, d.hi, d.lo);
}

__device__ __forceinline__ Split ld_split(const float* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return Split{v.x, v.y};
}

// c += a*b in 3xTF32 (mma_3xtf32), or with two products where one operand is
// a bf16 value (kXA, kXB), whose tf32 lo is 0
template <bool kXA, bool kXB>
__device__ __forceinline__ void mma_split(float c[4], const Split a[4], const Split b[2]) {
  if constexpr (!kXA && !kXB) {
    mma_3xtf32(c, a, b);
  } else {
    if (!kXA) mma_tf32(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
    if (!kXB) mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
    mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
  }
}

// acc(64 x N) += sum_{0 <= k < K} A(m, k) B(k, n).  A(m, k) is Am[m][k]
// (kAKFast) or Am[k][m]; B(k, n) is Bm[k][n] (kBNFast) or Bm[n][k]: each
// operand is read along its contiguous axis, four elements a load.  Slabs of
// kKS are staged in shared memory, kept in the operand's own orientation
// ([m][k] or [k][m], [n][k] or [k][n]) and padded so that the fragment loads
// meet no bank conflict.  kBf: both operands bf16 ([m][k] and [n][k]),
// staged as they are (m16n8k16); else 3xTF32, each operand split into its
// tf32 (hi, lo) pair once, as it is staged (splitting at each fragment load
// made the products wait on the conversions).
template <int N, bool kBf, bool kAKFast, bool kBNFast, bool kXA, bool kXB, typename TA,
          typename TB>
__device__ __forceinline__ void mma_tile_x(int K, Mat<TA> Am, Mat<TB> Bm, float* stage,
                                           Acc<N>& acc) {
  static_assert(!kBf || (kAKFast && !kBNFast), "bf16 slabs are [m][k] and [n][k]");
  constexpr int NT = N / 32;
  constexpr int PA = kAKFast ? kPF : kTile + 4;      // A: [m][k] pitch, or [k][m] pitch
  constexpr int PB = kBNFast ? N + 4 : kPF;          // B: [k][n] pitch, or [n][k] pitch
  if (kAKFast) Am.ncol = min(Am.ncol, K); else Am.nrow = min(Am.nrow, K);
  if (kBNFast) Bm.nrow = min(Bm.nrow, K); else Bm.ncol = min(Bm.ncol, K);
  const bool va = aligned4(Am), vb = aligned4(Bm);
  const int tid = threadIdx.x;
  const WarpPos w;
  float* As = stage;
  float* Bs = stage + slab_floats(kTile);
  auto* Ah = reinterpret_cast<__nv_bfloat16*>(As);
  auto* Bh = reinterpret_cast<__nv_bfloat16*>(Bs);
  for (int k0 = 0; k0 < K; k0 += kKS) {
#pragma unroll
    for (int r = 0; r < kTile * kKS / 4 / kThreads; ++r) {
      const int e = tid + r * kThreads;
      if constexpr (kBf) {
        const int m = e / (kKS / 4), k = (e % (kKS / 4)) * 4;
        *reinterpret_cast<uint2*>(Ah + m * kPH + k) = ld4h(Am, m, k0 + k, va);
      } else if constexpr (kAKFast) {
        const int m = e / (kKS / 4), k = (e % (kKS / 4)) * 4;
        st4_split(As + 2 * (m * PA + k), ld4(Am, m, k0 + k, va));
      } else {
        const int k = e / (kTile / 4), m = (e % (kTile / 4)) * 4;
        st4_split(As + 2 * (k * PA + m), ld4(Am, k0 + k, m, va));
      }
    }
#pragma unroll
    for (int r = 0; r < N * kKS / 4 / kThreads; ++r) {
      const int e = tid + r * kThreads;
      if constexpr (kBf) {
        const int n = e / (kKS / 4), k = (e % (kKS / 4)) * 4;
        *reinterpret_cast<uint2*>(Bh + n * kPH + k) = ld4h(Bm, n, k0 + k, vb);
      } else if constexpr (kBNFast) {
        const int k = e / (N / 4), n = (e % (N / 4)) * 4;
        st4_split(Bs + 2 * (k * PB + n), ld4(Bm, k0 + k, n, vb));
      } else {
        const int n = e / (kKS / 4), k = (e % (kKS / 4)) * 4;
        st4_split(Bs + 2 * (n * PB + k), ld4(Bm, n, k0 + k, vb));
      }
    }
    __syncthreads();
    Acc<N> part;
    zero<N>(part);
    if constexpr (kBf) {
#pragma unroll
      for (int kk = 0; kk < kKS; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const __nv_bfloat16* p = Ah + (32 * w.wm + 16 * i + w.gq) * kPH + kk + 2 * w.tq;
          a[i][0] = ld32(p);
          a[i][1] = ld32(p + 8 * kPH);
          a[i][2] = ld32(p + 8);
          a[i][3] = ld32(p + 8 * kPH + 8);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const __nv_bfloat16* p = Bh + ((N / 4) * w.wn + 8 * j + w.gq) * kPH + kk + 2 * w.tq;
          const uint32_t b[2] = {ld32(p), ld32(p + 8)};
          mma_bf16(part[0][j], a[0], b);
          mma_bf16(part[1][j], a[1], b);
        }
      }
    } else {
      auto A = [&](int m, int k) {
        return ld_split(As + 2 * (kAKFast ? m * PA + k : k * PA + m));
      };
      auto B = [&](int k, int n) {
        return ld_split(Bs + 2 * (kBNFast ? k * PB + n : n * PB + k));
      };
#pragma unroll
      for (int kk = 0; kk < kKS; kk += 8) {
        Split a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = 32 * w.wm + 16 * i + w.gq, k = kk + w.tq;
          a[i][0] = A(m, k);
          a[i][1] = A(m + 8, k);
          a[i][2] = A(m, k + 4);
          a[i][3] = A(m + 8, k + 4);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = (N / 4) * w.wn + 8 * j + w.gq, k = kk + w.tq;
          const Split b[2] = {B(k, n), B(k + 4, n)};
          mma_split<kXA, kXB>(part[0][j], a[0], b);
          mma_split<kXA, kXB>(part[1][j], a[1], b);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
}

// mma_tile_x with kXA / kXB set where an operand is a bf16 input taken as it
// is (no scale): exact in tf32, so 3xTF32 needs two products, not three.
template <int N, bool kBf, bool kAKFast, bool kBNFast, typename TA, typename TB>
__device__ __forceinline__ void mma_tile(int K, Mat<TA> Am, Mat<TB> Bm, float* stage,
                                         Acc<N>& acc) {
  constexpr bool ha = std::is_same<TA, __nv_bfloat16>::value;
  constexpr bool hb = std::is_same<TB, __nv_bfloat16>::value;
  if constexpr (!kBf && ha) {
    if (Am.rs == nullptr) {
      mma_tile_x<N, kBf, kAKFast, kBNFast, true, false>(K, Am, Bm, stage, acc);
      return;
    }
  }
  if constexpr (!kBf && hb) {
    if (Bm.rs == nullptr) {
      mma_tile_x<N, kBf, kAKFast, kBNFast, false, true>(K, Am, Bm, stage, acc);
      return;
    }
  }
  mma_tile_x<N, kBf, kAKFast, kBNFast, false, false>(K, Am, Bm, stage, acc);
}

// out[r] += sum over the tile's columns of x's row r (r < 64), for every row:
// the lanes of a row by shuffles, the four column warps through red (4 x 64)
// in a fixed order.
template <int N>
__device__ void row_sums(Acc<N>& x, float* red, float* out) {
  const WarpPos w;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < N / 32; ++j) s += x[i][j][2 * h] + x[i][j][2 * h + 1];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (w.tq == 0) red[w.wn * kTile + 32 * w.wm + 16 * i + 8 * h + w.gq] = s;
    }
  __syncthreads();
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x;
    out[r] += (red[r] + red[kTile + r]) + (red[2 * kTile + r] + red[3 * kTile + r]);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Block-wide scans and sums over 256 threads, in a fixed order
// ---------------------------------------------------------------------------
struct Add {
  __device__ float operator()(float x, float y) const { return x + y; }
};
struct Max {
  __device__ float operator()(float x, float y) const { return fmaxf(x, y); }
};

template <class Op>
__device__ float block_scan(float x, float* sh, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = op(y, x);
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp > 0) {
    float pre = sh[0];
    for (int i = 1; i < warp; ++i) pre = op(pre, sh[i]);
    x = op(pre, x);
  }
  __syncthreads();
  return x;
}

__device__ float block_sum(float x, float* sh) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) s += sh[i];
  __syncthreads();
  return s;
}

// Floats of shared memory for one field of a chunk's rows: L, and at least
// 256 so that at L <= 256 every layout holds 256 rows a field
__host__ __device__ constexpr int rows_floats(int L) { return L > kThreads ? L : kThreads; }

// The inclusive scan of a chunk's rows v[0, L) by op, in place and in a fixed
// order (id: op's identity).  Thread t takes the P = ceil(L/256) consecutive
// rows from t P and forms their prefix, the block scans the 256 partials, each
// row but a thread's last adds the partial of the threads before its own, and
// the last takes the block's scan (at L <= 256 each row is a last row:
// block_scan over one row a thread).  Syncs before (v may come from other
// threads) and after.
template <class Op>
__device__ void rows_scan(float* v, int L, float id, float* sh, Op op) {
  __shared__ float pre[kThreads];
  const int t = threadIdx.x, P = (L + kThreads - 1) / kThreads;
  const int r0 = min(L, t * P), r1 = min(L, r0 + P);
  __syncthreads();
  float x = id;
  for (int r = r0; r < r1; ++r) v[r] = x = r == r0 ? v[r] : op(x, v[r]);
  pre[t] = block_scan(x, sh, op);
  __syncthreads();
  if (t > 0)
    for (int r = r0; r < r1 - 1; ++r) v[r] = op(pre[t - 1], v[r]);
  if (r0 < r1) v[r1 - 1] = pre[t];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Parameters and the workspace
// ---------------------------------------------------------------------------
// Per-row fields (each Tp floats per (b, head)) and per-chunk fields (NC each)
enum RowField { RB, RA, RR, RMU, RSP, RW, RDEN, RDQN, RDMU, RDSP, RROWD, RCOLD, RDZ, kRowFields };
enum ChunkField { CM, CG, CBL, CA, CDMC, CTO1, CCNT, kChunkFields };

constexpr int kFwdRowFields = RW + 1;       // the forward's: b, a, R, mu, sp, w

// Floats per (b, head) in the workspace: each chunk's entry state (Cn: C then
// n), and for the backward each chunk's exit adjoints (Ln: first each chunk's
// own dC_c, dn_c), the row and chunk fields, and for the backward dg's
// partial sums (NC x scan blocks); a multiple of 4 (16-byte rows).
struct Work {
  long long C, n, lam, lamn, rows, chunks, dgp, stride;
  int nscan;
};

inline Work work_layout(int Tp, int dqk, int dv, int L, bool bwd) {
  const long long NC = Tp / L, S = static_cast<long long>(dqk) * dv;
  Work w{};
  w.nscan = static_cast<int>((S + dqk + kThreads - 1) / kThreads);
  w.C = 0;
  w.n = w.C + NC * S;
  w.lam = w.n + NC * dqk;
  w.lamn = w.lam + (bwd ? NC * S : 0);
  w.rows = w.lamn + (bwd ? NC * dqk : 0);
  w.chunks = w.rows + static_cast<long long>(bwd ? kRowFields : kFwdRowFields) * Tp;
  w.dgp = w.chunks + kChunkFields * NC;
  w.stride = (w.dgp + (bwd ? NC * w.nscan : 0) + 3) / 4 * 4;
  return w;
}

// The inputs of both directions; the forward's outputs (h, CT, nT, mT) or the
// backward's cotangents and gradients (the other direction's are null).  Rows
// t >= T read q, k, v (and dh) as 0, rows t >= Tg the gates as a kept state
// (Tg = T but for K10, whose wrapper pads the gates); the forward stores h's
// rows t < Th.
struct Params {
  const void *q, *k, *v, *dh;
  const float *ic, *lf, *C0, *n0, *m0, *dCT, *dnT, *dmT;
  void *h, *dq, *dk, *dv;
  float *CT, *nT, *mT, *dic, *dlf, *dC0, *dn0, *dm0;
  float* work;
  Work wk;
  Layout lay;
  int H, Tp, T, Tg, Th, dqk, dv_, L;
  float inv;
};

// One (b, head)'s view: its rows of the inputs, the workspace's parts
template <typename Tin>
struct Head {
  Rows<Tin> rows;
  const Tin* dh;
  float *C, *n, *lam, *lamn, *row, *chunk, *dgp;
  int bh, NC, dqk, dv;
  long long v_r;
  __device__ Head(const Params& p, int bh_, int c)
      : rows{static_cast<const Tin*>(p.q) + (bh_ / p.H) * p.lay.qk_b + (bh_ % p.H) * p.lay.qk_h,
             static_cast<const Tin*>(p.k) + (bh_ / p.H) * p.lay.qk_b + (bh_ % p.H) * p.lay.qk_h,
             static_cast<const Tin*>(p.v) + (bh_ / p.H) * p.lay.v_b + (bh_ % p.H) * p.lay.v_h,
             p.lay.qk_r,
             p.lay.v_r,
             c * p.L,
             p.T,
             p.L},
        dh(p.dh == nullptr ? nullptr
                           : static_cast<const Tin*>(p.dh) + (bh_ / p.H) * p.lay.v_b +
                                 (bh_ % p.H) * p.lay.v_h),
        bh(bh_),
        NC(p.Tp / p.L),
        dqk(p.dqk),
        dv(p.dv_),
        v_r(p.lay.v_r) {
    float* w = p.work + bh_ * p.wk.stride;
    C = w + p.wk.C;
    n = w + p.wk.n;
    lam = w + p.wk.lam;
    lamn = w + p.wk.lamn;
    row = w + p.wk.rows;
    chunk = w + p.wk.chunks;
    dgp = w + p.wk.dgp;
  }
  // the chunk's valid rows from row r0 on
  __device__ int nvalid(int r0) const { return max(0, min(rows.L, rows.T - rows.t0) - r0); }
  // the chunk's rows r0.. of q, k (dqk wide), v, dh (dv wide) as operands
  __device__ Mat<Tin> qm(int r0, const float* rs = nullptr) const {
    return mat(rows.q + (rows.t0 + r0) * rows.qk_r, rows.qk_r, nvalid(r0), dqk, rs);
  }
  __device__ Mat<Tin> km(int r0, const float* rs = nullptr) const {
    return mat(rows.k + (rows.t0 + r0) * rows.qk_r, rows.qk_r, nvalid(r0), dqk, rs);
  }
  __device__ Mat<Tin> vm(int r0, const float* rs = nullptr) const {
    return mat(rows.v + (rows.t0 + r0) * v_r, v_r, nvalid(r0), dv, rs);
  }
  __device__ Mat<Tin> dhm(int r0) const {
    return mat(dh + (rows.t0 + r0) * v_r, v_r, nvalid(r0), dv);
  }
  __device__ float* field(int f) const { return row + static_cast<size_t>(f) * rows.L * NC; }
  __device__ float* cfield(int f) const { return chunk + f * NC; }
};

// ---------------------------------------------------------------------------
// 1. Each chunk's own gate rows (one block per chunk): b (the cumulative log
// forget from the chunk's start), a = ic - b, R (the running max of a), and
// bL = b_{L-1}, A = R_{L-1}; the scans run over buf (2 L floats of dynamic
// shared memory)
// ---------------------------------------------------------------------------
__device__ void gate_rows(const Params& p, int c, int bh, float* buf) {
  __shared__ float sh[kThreads / 32];
  const int L = p.L, t = threadIdx.x;
  const Head<float> hd(p, bh, c);
  const size_t o = static_cast<size_t>(hd.bh) * p.Tp;
  float *b = buf, *R = buf + L;
  for (int r = t; r < L; r += kThreads) {
    const int g = c * L + r;
    b[r] = g < p.Tg ? p.lf[o + g] : 0.f;
  }
  rows_scan(b, L, 0.f, sh, Add());
  for (int r = t; r < L; r += kThreads) {
    const int g = c * L + r;
    const float a = (g < p.Tg ? p.ic[o + g] : kNeg) - b[r];
    R[r] = a;
    hd.field(RB)[g] = b[r];
    hd.field(RA)[g] = a;
  }
  rows_scan(R, L, -INFINITY, sh, Max());
  for (int r = t; r < L; r += kThreads) hd.field(RR)[c * L + r] = R[r];
  if (t == 0) {
    hd.cfield(CBL)[c] = b[L - 1];
    hd.cfield(CA)[c] = R[L - 1];
  }
}

// m at each chunk's entry, by a scalar walk over the earlier chunks' (bL, A)
// (m' = max(m + bL, bL + A)); then mu, sp, w per row and m, g per chunk (and
// the forward's m_T, the last chunk's m')
__device__ void gate_m(const Params& p, int c, int bh) {
  const int L = p.L, t = threadIdx.x;
  const Head<float> hd(p, bh, c);
  const float *cbl = hd.cfield(CBL), *ca = hd.cfield(CA);
  float m = p.m0[hd.bh];
  for (int cc = 0; cc < c; ++cc) m = fmaxf(m + cbl[cc], cbl[cc] + ca[cc]);
  const float bL = cbl[c], mn = fmaxf(m + bL, bL + ca[c]);
  for (int r = t; r < L; r += kThreads) {
    const int g = c * L + r;
    const float b = hd.field(RB)[g], mu = b + fmaxf(m, hd.field(RR)[g]);
    hd.field(RMU)[g] = mu;
    hd.field(RSP)[g] = expf(b + m - mu);
    hd.field(RW)[g] = expf(bL + hd.field(RA)[g] - mn);
  }
  if (t == 0) {
    hd.cfield(CM)[c] = m;
    hd.cfield(CG)[c] = expf(m + bL - mn);
    if (p.mT != nullptr && c == hd.NC - 1) p.mT[hd.bh] = mn;
  }
}

__global__ void __launch_bounds__(kThreads) gates_kernel(Params p) {
  extern __shared__ float sm[];
  gate_rows(p, blockIdx.x, blockIdx.y, sm);
}
__global__ void __launch_bounds__(kThreads) gates_m_kernel(Params p) {
  gate_m(p, blockIdx.x, blockIdx.y);
}
// Both in one block where there is one chunk (the block reads back its own rows)
__global__ void __launch_bounds__(kThreads) gates_one_kernel(Params p) {
  extern __shared__ float sm[];
  gate_rows(p, 0, blockIdx.y, sm);
  __syncthreads();
  gate_m(p, 0, blockIdx.y);
}

// ---------------------------------------------------------------------------
// 2./5. A chunk's state term, per 64 x 64 tile of (dqk, dv):
//   forward (kBwd false, chunks 0..NC-2): sum_t w_t k_t v_t^T and sum_t w_t k_t
//     into the entry-state slot of chunk c + 1;
//   backward: dC_c = inv sum_t (sp_t/den_t) q_t dh_t^T and dn_c = inv sum_t
//     sp_t dqn_t q_t into the exit-adjoint slot of chunk c - 1 (dC0, dn0 for
//     chunk 0).
// ---------------------------------------------------------------------------
template <typename Tin, bool kBwd>
__global__ void __launch_bounds__(kThreads, 3) state_kernel(Params p) {
  extern __shared__ float sm[];
  float* stage = sm;
  float* sc = stage + stage_floats(kTile);        // A's row scale (L)
  const int c = blockIdx.y, L = p.L, dqk = p.dqk, dv = p.dv_, tid = threadIdx.x;
  const Head<Tin> hd(p, blockIdx.z, c);
  const int ntv = (dv + kTile - 1) / kTile;
  const int d0 = (blockIdx.x / ntv) * kTile, v0 = (blockIdx.x % ntv) * kTile;
  for (int t = tid; t < L; t += kThreads) {
    const int g = c * L + t;
    sc[t] = kBwd ? p.inv * hd.field(RSP)[g] / hd.field(RDEN)[g] : hd.field(RW)[g];
  }
  __syncthreads();
  const Mat<Tin> X = kBwd ? hd.qm(0) : hd.km(0), Y = kBwd ? hd.dhm(0) : hd.vm(0);
  Acc<kTile> acc;
  zero<kTile>(acc);
  mma_tile<kTile, false, false, true>(L, mat(X.p + d0, X.ld, X.nrow, dqk - d0, sc),
                                   mat(Y.p + v0, Y.ld, Y.nrow, dv - v0), stage, acc);
  const size_t S = static_cast<size_t>(dqk) * dv;
  float* out = kBwd ? (c == 0 ? p.dC0 + hd.bh * S : hd.lam + (c - 1) * S) : hd.C + (c + 1) * S;
  each<kTile>(acc, [&](int r, int col, float& x) {
    if (d0 + r < dqk && v0 + col < dv) out[static_cast<size_t>(d0 + r) * dv + v0 + col] = x;
  });
}

// sum_t sn_t X(t, d0 + tid % 64) over the chunk's rows (X = q when kQ, else
// k), 64 of dqk per block; four threads per d take every fourth t, added in a
// fixed order.  The sum is the return value of threads tid < 64.
template <bool kQ, typename Tin>
__device__ float n_sum(const Rows<Tin>& rw, const float* sn, int d0, int dqk, float* red) {
  const int tid = threadIdx.x, d = d0 + tid % kTile, part = tid / kTile;
  float s = 0.f;
  if (d < dqk)
    for (int t = part; t < rw.L; t += kThreads / kTile) s += (kQ ? rw.Q(t, d) : rw.K(t, d)) * sn[t];
  red[tid] = s;
  __syncthreads();
  return (red[tid % kTile] + red[kTile + tid % kTile]) +
         (red[2 * kTile + tid % kTile] + red[3 * kTile + tid % kTile]);
}

// The n terms of (2./5.): sum_t w_t k_t (forward, into chunk c + 1's entry
// slot) or dn_c = inv sum_t sp_t dqn_t q_t (backward), 64 of dqk per block
template <typename Tin, bool kBwd>
__global__ void __launch_bounds__(kThreads) nterm_kernel(Params p) {
  extern __shared__ float sn[];                // the rows' scales (rows_floats(L))
  __shared__ float red[kThreads];
  const int c = blockIdx.x, L = p.L, dqk = p.dqk, tid = threadIdx.x;
  const int d0 = blockIdx.z * kTile, d = d0 + tid;
  const Head<Tin> hd(p, blockIdx.y, c);
  for (int t = tid; t < L; t += kThreads) {
    const int g = c * L + t;
    sn[t] = kBwd ? p.inv * hd.field(RSP)[g] * hd.field(RDQN)[g] : hd.field(RW)[g];
  }
  __syncthreads();
  const float s = n_sum<kBwd>(hd.rows, sn, d0, dqk, red);
  if (tid < kTile && d < dqk) {
    float* on = kBwd ? (c == 0 ? p.dn0 + static_cast<size_t>(hd.bh) * dqk
                               : hd.lamn + static_cast<size_t>(c - 1) * dqk)
                     : hd.n + static_cast<size_t>(c + 1) * dqk;
    on[d] = s;
  }
}

// ---------------------------------------------------------------------------
// 3. Every chunk's entry state: C_c = g_{c-1} C_{c-1} + (2.)'s term, from C0
// (one thread per element of C and n)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) scan_fwd_kernel(Params p) {
  const Head<float> hd(p, blockIdx.y, 0);
  const long long S = static_cast<long long>(p.dqk) * p.dv_;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= S + p.dqk) return;
  const bool isC = e < S;
  float* slot = isC ? hd.C + e : hd.n + (e - S);
  const long long step = isC ? S : p.dqk;
  float x = isC ? p.C0[hd.bh * S + e] : p.n0[static_cast<long long>(hd.bh) * p.dqk + e - S];
  slot[0] = x;
#pragma unroll 4
  for (int c = 1; c < hd.NC; ++c) {
    x = hd.cfield(CG)[c - 1] * x + slot[c * step];
    slot[c * step] = x;
  }
}

template <class K>
int launch(K kernel, dim3 grid, size_t smem, const Params& p, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
// ---------------------------------------------------------------------------
// 4. The forward's exit state, per 64 x 64 tile of (dqk, dv): C_T = g C_{NC-1}
// + sum_t w_t k_t v_t^T over the last chunk, and n_T likewise in the blocks of
// the first column tile (chunk 0's entry state is C0, n0)
// ---------------------------------------------------------------------------
template <typename Tin>
__global__ void __launch_bounds__(kThreads, 3) fwd_exit_kernel(Params p) {
  extern __shared__ float sm[];
  float* stage = sm;
  float* sc = stage + stage_floats(kTile);        // w of the last chunk's rows (L)
  float* red = sc + rows_floats(p.L);
  const int L = p.L, dqk = p.dqk, dv = p.dv_, tid = threadIdx.x, c = p.Tp / L - 1;
  const Head<Tin> hd(p, blockIdx.y, c);
  const int ntv = (dv + kTile - 1) / kTile;
  const int d0 = (blockIdx.x / ntv) * kTile, v0 = (blockIdx.x % ntv) * kTile;
  for (int t = tid; t < L; t += kThreads) sc[t] = hd.field(RW)[c * L + t];
  __syncthreads();
  const Mat<Tin> X = hd.km(0), Y = hd.vm(0);
  Acc<kTile> acc;
  zero<kTile>(acc);
  mma_tile<kTile, false, false, true>(L, mat(X.p + d0, X.ld, X.nrow, dqk - d0, sc),
                                      mat(Y.p + v0, Y.ld, Y.nrow, dv - v0), stage, acc);
  const size_t S = static_cast<size_t>(dqk) * dv;
  const float g = hd.cfield(CG)[c];
  const float* Cc = c == 0 ? p.C0 + hd.bh * S : hd.C + c * S;
  float* CT = p.CT + hd.bh * S;
  each<kTile>(acc, [&](int r, int col, float& x) {
    const size_t e = static_cast<size_t>(d0 + r) * dv + v0 + col;
    if (d0 + r < dqk && v0 + col < dv) CT[e] = g * Cc[e] + x;
  });
  if (v0 == 0) {
    const float s = n_sum<false>(hd.rows, sc, d0, dqk, red);
    const int d = d0 + tid;
    if (tid < kTile && d < dqk) {
      const float* nc = c == 0 ? p.n0 + static_cast<size_t>(hd.bh) * dqk : hd.n + c * dqk;
      p.nT[static_cast<size_t>(hd.bh) * dqk + d] = g * nc[d] + s;
    }
  }
}

// ---------------------------------------------------------------------------
// 5. The forward's outputs of a 64-row tile t0 of chunk c and NV columns of h
// from v0 (the design above)
// ---------------------------------------------------------------------------
inline size_t out_smem_bytes(int NV, int L) {
  return sizeof(float) * (stage_floats(NV) + kTile * kQP + 2 * rows_floats(L) + 9 * kTile);
}

template <typename Tin, int NV>
__global__ void __launch_bounds__(kThreads, 2) fwd_out_kernel(Params p) {
  extern __shared__ float sm[];
  constexpr bool kBf = std::is_same<Tin, __nv_bfloat16>::value;
  float* stage = sm;
  float* Ws = stage + stage_floats(NV);        // W of one s-tile (64 x 64)
  float* gb = Ws + kTile * kQP;                // the chunk's b and a (L each)
  float* ga = gb + rows_floats(p.L);
  float* mu = ga + rows_floats(p.L);           // 64 each: the tile's mu, sp inv, sw, q.n_c, den
  float* spi = mu + kTile;
  float* sw = spi + kTile;
  float* qn = sw + kTile;
  float* den = qn + kTile;
  float* red = den + kTile;                    // 4 x 64
  const int c = blockIdx.y, L = p.L, dqk = p.dqk, dv = p.dv_, tid = threadIdx.x;
  const int nrt = (L + kTile - 1) / kTile;
  const int t0 = (blockIdx.x % nrt) * kTile, v0 = (blockIdx.x / nrt) * NV;
  const Head<Tin> hd(p, blockIdx.z, c);
  const Rows<Tin>& rw = hd.rows;
  const size_t S = static_cast<size_t>(dqk) * dv;
  const float* Cc = c == 0 ? p.C0 + hd.bh * S : hd.C + c * S;
  const float* nc = c == 0 ? p.n0 + static_cast<size_t>(hd.bh) * dqk : hd.n + c * dqk;
  for (int t = tid; t < L; t += kThreads) {
    gb[t] = hd.field(RB)[c * L + t];
    ga[t] = hd.field(RA)[c * L + t];
  }
  if (tid < kTile) {
    const int g = c * L + min(t0 + tid, L - 1);  // rows past the chunk are not stored
    mu[tid] = hd.field(RMU)[g];
    spi[tid] = p.inv * hd.field(RSP)[g];
    sw[tid] = 0.f;
  }
  // q_t . n_c, one warp per row
  for (int r = tid >> 5; r < kTile; r += kThreads / 32) {
    float s = 0.f;
    for (int d = tid & 31; d < dqk; d += 32) s += rw.Q(t0 + r, d) * nc[d];
    s = warp_sum(s);
    if ((tid & 31) == 0) qn[r] = s;
  }
  __syncthreads();

  Acc<NV> acc;
  zero<NV>(acc);
  mma_tile<NV, false, true, true>(dqk, hd.qm(t0), mat(Cc + v0, dv, dqk, dv - v0), stage, acc);
  each<NV>(acc, [&](int r, int, float& x) { x *= spi[r]; });
  for (int s0 = 0; s0 <= t0 && s0 < L; s0 += kTile) {
    Acc<kTile> W;
    zero<kTile>(W);
    mma_tile<kTile, kBf, true, false>(dqk, hd.qm(t0), hd.km(s0), stage, W);
    each<kTile>(W, [&](int r, int j, float& x) {
      const int t = t0 + r, s = s0 + j;
      x = s <= t && t < L ? p.inv * x * expf(gb[t] + ga[s] - mu[r]) : 0.f;
      Ws[r * kQP + j] = x;
    });
    row_sums<kTile>(W, red, sw);               // (syncs: Ws is complete after it)
    const Mat<Tin> V = hd.vm(s0);
    mma_tile<NV, false, true, true>(min(kTile, L - s0), mat<float>(Ws, kQP, kTile, kTile),
                                    mat(V.p + v0, V.ld, V.nrow, dv - v0), stage, acc);
  }
  if (tid < kTile)
    den[tid] = t0 + tid < L ? fmaxf(fabsf(sw[tid] + spi[tid] * qn[tid]), expf(-mu[tid])) : 1.f;
  __syncthreads();
  Tin* h = static_cast<Tin*>(p.h) + (hd.bh / p.H) * p.lay.v_b + (hd.bh % p.H) * p.lay.v_h;
  each<NV>(acc, [&](int r, int col, float& x) {
    const int t = t0 + r;
    if (t < L && rw.t0 + t < p.Th && v0 + col < dv)
      st(h + static_cast<size_t>(rw.t0 + t) * p.lay.v_r + v0 + col, x / den[r]);
  });
}

// The forward's passes in stream order (Params: the inputs, h, CT, nT, mT and
// the workspace of work_layout(..., false)); the first cudaError_t, or 0
template <typename Tin, int NV>
int launch_fwd(const Params& p, int B, cudaStream_t s) {
  const int BH = B * p.H, NC = p.Tp / p.L, nrt = (p.L + kTile - 1) / kTile;
  const int ndt = (p.dqk + kTile - 1) / kTile;
  const int nst = ndt * ((p.dv_ + kTile - 1) / kTile);
  const size_t rows_smem = sizeof(float) * rows_floats(p.L), gate_smem = sizeof(float) * 2 * p.L;
  const size_t state_smem = sizeof(float) * (stage_floats(kTile) + kThreads) + rows_smem;
  int err = 0;
  if (NC == 1) {
    err = launch(gates_one_kernel, dim3(1, BH), gate_smem, p, s);
  } else {
    err = launch(gates_kernel, dim3(NC, BH), gate_smem, p, s);
    if (err == 0) err = launch(gates_m_kernel, dim3(NC, BH), 0, p, s);
    if (err == 0) err = launch(state_kernel<Tin, false>, dim3(nst, NC - 1, BH), state_smem, p, s);
    if (err == 0) err = launch(nterm_kernel<Tin, false>, dim3(NC - 1, BH, ndt), rows_smem, p, s);
    if (err == 0) err = launch(scan_fwd_kernel, dim3(p.wk.nscan, BH), 0, p, s);
  }
  if (err == 0) err = launch(fwd_exit_kernel<Tin>, dim3(nst, BH), state_smem, p, s);
  if (err == 0)
    err = launch(fwd_out_kernel<Tin, NV>, dim3(nrt * ((p.dv_ + NV - 1) / NV), NC, BH),
                 out_smem_bytes(NV, p.L), p, s);
  return err;
}

// fwd_out over 64 columns of h a block where dv <= 64, else 128: two blocks
// per SM.  Over 256 columns (S formed once at dv = 256, one block of 255
// registers per SM) it took 1.06 ms against 0.83 at B=32, T=1598, L=128,
// dqk = 128, dv = 256 in f32 on an H100 SXM at 700 W
// (tools/mlstm_fwd_variants.py, nv256): the staging's latency, not the
// products, bounds it, and a second block hides more of it.
template <typename Tin>
int launch_fwd_for(const Params& p, int B, cudaStream_t s) {
  if (p.dv_ <= 64) return launch_fwd<Tin, 64>(p, B, s);
  return launch_fwd<Tin, 128>(p, B, s);
}

}  // namespace
}  // namespace mlstm
