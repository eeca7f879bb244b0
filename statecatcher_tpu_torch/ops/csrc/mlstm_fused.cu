// The fused lane-major chunkwise mLSTM for Hopper (sm_90a): K9a and K9b.  The
// chunk math and its contract are in mlstm_chunk.cuh, with the forward's
// design.
//
// Replaces the TPU kernels of statecatcher_tpu/ops/mlstm_fused.py:
//   K9a  mlstm_fwd_kernel  <- _fwd_kernel (:158), launched by _fused_fwd_impl (:199)
//   K9b  the eleven bwd_*_kernel below
//                          <- _bwd_kernel (:251), launched by _fused_bwd_impl (:322)
//
// Layout: q, k (B, Tp, H*dqk), v, h, dh (B, Tp, H*dv) in the model dtype
// (float32 or bfloat16; head h is the column slice [h*d, (h+1)*d)); the
// gates ic, lf and their adjoints (B, H, Tp) f32; states (B, H, dqk, dv),
// (B, H, dqk), (B, H) f32.  q is scaled by dqk^-1/2 inside.
//
// K9b is the adjoint of the chunk step (ops/mlstm_fused.py:mlstm_chunk_bwd_ref),
// split along its data dependencies so that every product runs chunk-parallel
// and only elementwise or scalar work walks the chunks in order.  Per (b, head)
// and chunk c (entry state C, n, m; exit adjoints dC', dn', dm'):
//   local to the chunk (needs C, n, m and dh): E, S = inv q k^T, G = dh v^T,
//     U = C dh, den, dqn, dmu, dsp, Q = E (G/den + dqn), rowD = sum_s S Q
//     (= swg/den + dqn sw with sw = sum_s S E, swg = sum_s S E G), dq = inv Q k
//     + inv sp (dqn n + U/den), and the chunk's own entry adjoints
//     dC_c = inv sum_t (sp_t/den_t) q_t dh_t^T, dn_c = inv sum_t sp_t dqn_t q_t;
//   carried: dC = g dC' + dC_c and dn = g dn' + dn_c (elementwise, one scalar g
//     per chunk); dm = dmc + to1 dm' (scalar, affine in dm');
//   needing the carried adjoints: Y = dC' v, Z = dC'^T k, dw = k.(Y + dn'),
//     dk = inv Q^T q + w (Y + dn'), dv = (S E/den)^T dh + w Z, colD = sum_t S Q,
//     dg = <dC', C> + <dn', n>, and the gate chain's terms in dm'.
// The passes, in stream order (grids at B=32, H=2, T=1598, L=128, dqk=128,
// dv=256: NC = 13 chunks):
//   1. gates    (NC, B*H): b, a, R per row and bL, A = R_{L-1} per chunk,
//               block scans local to the chunk; gates_m (NC, B*H): m at the
//               chunk's entry by a scalar walk over the earlier chunks' (bL,
//               A), then mu, sp, w per row and m, g per chunk;
//   2. state    (dqk/64 * dv/64, NC-1, B*H = 6144 blocks) and nterm (NC-1,
//               B*H, dqk/64): each chunk's sum_t w_t k_t v_t^T and sum_t
//               w_t k_t (the forward's state advance without the carry);
//   3. scan_fwd (E/256, B*H): C_c = g C_{c-1} + (2.), n likewise, elementwise:
//               every chunk's entry state;
//   4. rows     (L/64, NC, B*H = 1664): per 64-row tile of a chunk: the row
//               sums sw, swg over S and G tiles (64 x 64, never in global
//               memory; G of the first two s-tiles kept in shared memory for
//               the second sweep), U, den, dqn, dmu, dsp, rowD; then Q tile by
//               tile into dq;
//   5. state, nterm (as 2., NC chunks): dC_c and dn_c;
//   6. scan_bwd (E/256, B*H): dC' and dn' of every chunk, dC0, dn0 and dg's
//               partial sums per block, elementwise in reverse;
//   7. dk       (L/64, NC, B*H): per 64-row tile s: w Y, dw, then S^T and G^T
//               tiles over t >= s: Q^T tile by tile into dk, colD;
//   8. dv       (L/64 * dv/128, NC, B*H): w Z, then S^T tiles into dv;
//   9. chain    (NC, B*H): the gate chain with dm' = 0 (block sums, tie counts
//               over each run of equal R), dic and dlf; dmc and to1 per chunk;
//  10. fixup    (NC, B*H): dm' of each chunk from the later chunks' (dmc, to1)
//               (a scalar walk), its terms added to dic and dlf; dm0.
// Every product runs on the tensor cores (mma.sync, mma_frag.cuh): q k^T and
// dh v^T in bf16 when the inputs are bf16 (exact products, f32 sums), every
// product with an f32 operand in 3xTF32.  A block of 256 threads owns a 64-row
// output tile; its operands are staged 32 deep in shared memory from 4-wide
// loads, each f32 operand split into its tf32 pair once as it is staged.  The
// product kernels run two blocks per SM (128 registers; one block of ~200
// registers hid less of the staging's latency and was slower), the state
// kernel three.  Each 32-deep slab is summed alone and added in
// f32 (the accumulator does not round to nearest).  Sums over elements go
// through fixed trees and fixed-order partials; no float atomics.
//
// Bound on the card (operations; counted in chip_smoke.py): per (b, head) and
// chunk the causal halves of q k^T, dh v^T, dq, dk, dv and the five L x dqk x
// dv products, ~57 MFLOP at L = 128, dqk = 128, dv = 256, at 3xTF32's rate
// for f32 inputs: 0.29 ms at B=32, T=1598; for bf16 inputs q k^T and dh v^T at
// bf16's rate and the rest as two TF32 products (every other product has a
// bf16 input for an operand, exact in tf32): 0.17 ms.
// This design forms S in three kernels (rows, dk, and dv once per 128 of its
// columns) and G in two (three past a row tile's second s-tile).
// dq, dk, dv, dic, dlf are 0 on rows t >= T.

#include <cmath>
#include <type_traits>

#include "mlstm_chunk.cuh"
#include "mma_frag.cuh"

namespace mlstm {
namespace {

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

// ---------------------------------------------------------------------------
// Parameters and the workspace
// ---------------------------------------------------------------------------
// Per-row fields (each Tp floats per (b, head)) and per-chunk fields (NC each)
enum RowField { RB, RA, RR, RMU, RSP, RW, RDEN, RDQN, RDMU, RDSP, RROWD, RCOLD, RDZ, kRowFields };
enum ChunkField { CM, CG, CBL, CA, CDMC, CTO1, CCNT, kChunkFields };

// Floats per (b, head) in the workspace: each chunk's entry state (Cn: C then
// n), each chunk's exit adjoints (Ln: first each chunk's own dC_c, dn_c),
// the row and chunk fields, and dg's partial sums (NC x scan blocks).
struct Work {
  long long C, n, lam, lamn, rows, chunks, dgp, stride;
  int nscan;
};

inline Work work_layout(int Tp, int dqk, int dv, int L) {
  const long long NC = Tp / L, S = static_cast<long long>(dqk) * dv;
  Work w{};
  w.nscan = static_cast<int>((S + dqk + kThreads - 1) / kThreads);
  w.C = 0;
  w.n = w.C + NC * S;
  w.lam = w.n + NC * dqk;
  w.lamn = w.lam + NC * S;
  w.rows = w.lamn + NC * dqk;
  w.chunks = w.rows + static_cast<long long>(kRowFields) * Tp;
  w.dgp = w.chunks + kChunkFields * NC;
  w.stride = w.dgp + NC * w.nscan;
  return w;
}

struct BwdParams {
  const void *q, *k, *v, *dh;
  const float *ic, *lf, *C0, *n0, *m0, *dCT, *dnT, *dmT;
  void *dq, *dk, *dv;
  float *dic, *dlf, *dC0, *dn0, *dm0;
  float* work;
  Work wk;
  Layout lay;
  int H, Tp, T, dqk, dv_, L;
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
  __device__ Head(const BwdParams& p, int bh_, int c)
      : rows{static_cast<const Tin*>(p.q) + (bh_ / p.H) * p.lay.qk_b + (bh_ % p.H) * p.lay.qk_h,
             static_cast<const Tin*>(p.k) + (bh_ / p.H) * p.lay.qk_b + (bh_ % p.H) * p.lay.qk_h,
             static_cast<const Tin*>(p.v) + (bh_ / p.H) * p.lay.v_b + (bh_ % p.H) * p.lay.v_h,
             p.lay.qk_r,
             p.lay.v_r,
             c * p.L,
             p.T,
             p.L},
        dh(static_cast<const Tin*>(p.dh) + (bh_ / p.H) * p.lay.v_b + (bh_ % p.H) * p.lay.v_h),
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
// bL = b_{L-1}, A = R_{L-1}
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) bwd_gates_kernel(BwdParams p) {
  __shared__ float sh[kThreads / 32];
  const int c = blockIdx.x, L = p.L, t = threadIdx.x;
  const Head<float> hd(p, blockIdx.y, c);
  const int g = c * L + t;
  const bool in = t < L, valid = in && g < p.T;
  const size_t o = static_cast<size_t>(hd.bh) * p.Tp;
  const float b = block_scan(valid ? p.lf[o + g] : 0.f, sh, Add());
  const float a = (valid ? p.ic[o + g] : kNeg) - b;
  const float R = block_scan(in ? a : -INFINITY, sh, Max());
  if (in) {
    hd.field(RB)[g] = b;
    hd.field(RA)[g] = a;
    hd.field(RR)[g] = R;
  }
  if (t == L - 1) {
    hd.cfield(CBL)[c] = b;
    hd.cfield(CA)[c] = R;
  }
}

// m at each chunk's entry, by a scalar walk over the earlier chunks' (bL, A)
// (m' = max(m + bL, bL + A)); then mu, sp, w per row and m, g per chunk
__global__ void __launch_bounds__(kThreads) bwd_gates_m_kernel(BwdParams p) {
  const int c = blockIdx.x, L = p.L, t = threadIdx.x;
  const Head<float> hd(p, blockIdx.y, c);
  const float *cbl = hd.cfield(CBL), *ca = hd.cfield(CA);
  float m = p.m0[hd.bh];
  for (int cc = 0; cc < c; ++cc) m = fmaxf(m + cbl[cc], cbl[cc] + ca[cc]);
  const float bL = cbl[c], mn = fmaxf(m + bL, bL + ca[c]);
  if (t < L) {
    const int g = c * L + t;
    const float b = hd.field(RB)[g], mu = b + fmaxf(m, hd.field(RR)[g]);
    hd.field(RMU)[g] = mu;
    hd.field(RSP)[g] = expf(b + m - mu);
    hd.field(RW)[g] = expf(bL + hd.field(RA)[g] - mn);
  }
  if (t == 0) {
    hd.cfield(CM)[c] = m;
    hd.cfield(CG)[c] = expf(m + bL - mn);
  }
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
__global__ void __launch_bounds__(kThreads, 3) bwd_state_kernel(BwdParams p) {
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

// The n terms of (2./5.): sum_t w_t k_t (forward, into chunk c + 1's entry
// slot) or dn_c = inv sum_t sp_t dqn_t q_t (backward), 64 of dqk per block;
// four threads per d take every fourth t, added in a fixed order.
template <typename Tin, bool kBwd>
__global__ void __launch_bounds__(kThreads) bwd_nterm_kernel(BwdParams p) {
  __shared__ float sn[256], red[kThreads];
  const int c = blockIdx.x, L = p.L, dqk = p.dqk, tid = threadIdx.x;
  const int d = blockIdx.z * kTile + tid % kTile, part = tid / kTile;
  const Head<Tin> hd(p, blockIdx.y, c);
  for (int t = tid; t < L; t += kThreads) {
    const int g = c * L + t;
    sn[t] = kBwd ? p.inv * hd.field(RSP)[g] * hd.field(RDQN)[g] : hd.field(RW)[g];
  }
  __syncthreads();
  const Rows<Tin>& rw = hd.rows;
  float s = 0.f;
  if (d < dqk)
    for (int t = part; t < L; t += kThreads / kTile) s += (kBwd ? rw.Q(t, d) : rw.K(t, d)) * sn[t];
  red[tid] = s;
  __syncthreads();
  if (tid < kTile && d < dqk) {
    float* on = kBwd ? (c == 0 ? p.dn0 + hd.bh * dqk : hd.lamn + (c - 1) * dqk)
                     : hd.n + (c + 1) * dqk;
    on[d] = (red[tid] + red[kTile + tid]) + (red[2 * kTile + tid] + red[3 * kTile + tid]);
  }
}

// ---------------------------------------------------------------------------
// 3. Every chunk's entry state: C_c = g_{c-1} C_{c-1} + (2.)'s term, from C0
// (one thread per element of C and n)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) bwd_scan_fwd_kernel(BwdParams p) {
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

// The chunk's gate rows in shared memory
struct ChunkGates {
  float *b, *a, *mu, *aux0, *aux1;
};

// ---------------------------------------------------------------------------
// 4. Rows of a chunk: den, dqn, dmu, dsp, rowD and dq, per 64-row tile
// ---------------------------------------------------------------------------
// floats of shared memory of the rows, dk and dv kernels: the staging area,
// one 64 x 64 tile per tile of the chunk, the chunk's gate rows (5 x 256) and
// the tile's row terms (12 x 64)
// The rows kernel keeps sweep 1's G of its first two s-tiles (all of them at
// L <= 128) and forms G again for the others: four kept tiles (L = 256)
// would leave room for one block per SM.
constexpr int kKeptG = 2;

inline size_t tiles_smem_bytes(int N, int L) {
  return sizeof(float) * (stage_floats(N) + static_cast<size_t>((L + kTile - 1) / kTile) *
                                                kTile * kQP + 5 * 256 + 12 * kTile);
}

template <typename Tin, int DQ>
__global__ void __launch_bounds__(kThreads, 2) bwd_rows_kernel(BwdParams p) {
  extern __shared__ float sm[];
  constexpr bool kBf = std::is_same<Tin, __nv_bfloat16>::value;
  float* stage = sm;
  const int t0 = blockIdx.x * kTile, L = p.L;
  float* Gs = stage + stage_floats(DQ);        // kKeptG tiles: G, then inv Q
  float* gr = Gs + kKeptG * kTile * kQP;
  const ChunkGates G{gr, gr + 256, gr + 512, gr + 768, gr + 1024};   // aux0 = sp
  float* sw = G.aux1 + 256;                    // 64 each: sw, swg, qU, qn, den, dqn, ...
  float* swg = sw + kTile;
  float* qU = swg + kTile;
  float* qnn = qU + kTile;
  float* den = qnn + kTile;
  float* dqn = den + kTile;
  float* red = dqn + 2 * kTile;                // 4 x 64
  const int c = blockIdx.y, dqk = p.dqk, dv = p.dv_, tid = threadIdx.x;
  const Head<Tin> hd(p, blockIdx.z, c);
  const Rows<Tin>& rw = hd.rows;
  const float* Cc = hd.C + static_cast<size_t>(c) * dqk * dv;
  const float* nc = hd.n + static_cast<size_t>(c) * dqk;
  for (int t = tid; t < L; t += kThreads) {
    const int g = c * L + t;
    G.b[t] = hd.field(RB)[g];
    G.a[t] = hd.field(RA)[g];
    G.mu[t] = hd.field(RMU)[g];
    G.aux0[t] = hd.field(RSP)[g];
  }
  if (tid < kTile) sw[tid] = swg[tid] = qU[tid] = 0.f;
  // q_t . n, one warp per row
  for (int r = tid >> 5; r < kTile; r += kThreads / 32) {
    float s = 0.f;
    for (int d = tid & 31; d < dqk; d += 32) s += rw.Q(t0 + r, d) * nc[d];
    s = warp_sum(s);
    if ((tid & 31) == 0) qnn[r] = s;
  }
  __syncthreads();

  // sweep 1: the row sums of W = S E and W G
  auto E = [&](int t, int s) {
    return s <= t && t < L ? expf(G.b[t] + G.a[s] - G.mu[t]) : 0.f;
  };
  for (int s0 = 0; s0 <= t0 && s0 < L; s0 += kTile) {
    Acc<kTile> S, Gt;
    zero<kTile>(S);
    zero<kTile>(Gt);
    mma_tile<kTile, kBf, true, false>(dqk, hd.qm(t0), hd.km(s0), stage, S);
    mma_tile<kTile, kBf, true, false>(dv, hd.dhm(t0), hd.vm(s0), stage, Gt);
    float* Gk = Gs + (s0 / kTile) * kTile * kQP;
    const WarpPos w;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 32 * w.wm + 16 * i + w.gq + 8 * (e >> 1);
          const int s = 16 * w.wn + 8 * j + 2 * w.tq + (e & 1);
          const float W = p.inv * S[i][j][e] * E(t0 + r, s0 + s);
          if (s0 < kKeptG * kTile) Gk[r * kQP + s] = Gt[i][j][e];
          S[i][j][e] = W;
          Gt[i][j][e] *= W;
        }
    row_sums<kTile>(S, red, sw);
    row_sums<kTile>(Gt, red, swg);
  }

  // U = dh C^T (64 x dqk), then q_t . U_t
  Acc<DQ> acc;
  zero<DQ>(acc);
  mma_tile<DQ, false, true, false>(dv, hd.dhm(t0), mat(Cc, dv, dqk, dv), stage, acc);
  {
    Acc<DQ> x;
    const WarpPos w;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < DQ / 32; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 32 * w.wm + 16 * i + w.gq + 8 * (e >> 1);
          const int d = (DQ / 4) * w.wn + 8 * j + 2 * w.tq + (e & 1);
          x[i][j][e] = d < dqk ? rw.Q(t0 + r, d) * acc[i][j][e] : 0.f;
        }
    row_sums<DQ>(x, red, qU);
  }

  // each row's denominator and its adjoints
  if (tid < kTile) {
    const int t = t0 + tid, g = c * L + t;
    if (t < L) {
      const float sp = G.aux0[t], emu = expf(-G.mu[t]);
      const float qn = sw[tid] + sp * p.inv * qnn[tid];
      const float dn_ = fmaxf(fabsf(qn), emu);
      const float dden = -(swg[tid] + sp * p.inv * qU[tid]) / (dn_ * dn_);
      const float toq = to_first(fabsf(qn), emu);
      const float dq_n = dden * toq * static_cast<float>((qn > 0.f) - (qn < 0.f));
      den[tid] = dn_;
      dqn[tid] = dq_n;
      hd.field(RDEN)[g] = dn_;
      hd.field(RDQN)[g] = dq_n;
      hd.field(RDMU)[g] = -dden * (1.f - toq) * emu;
      hd.field(RDSP)[g] = p.inv * qU[tid] / dn_ + p.inv * dq_n * qnn[tid];
      hd.field(RROWD)[g] = swg[tid] / dn_ + dq_n * sw[tid];
    } else {
      den[tid] = 1.f;
      dqn[tid] = 0.f;
    }
  }
  __syncthreads();

  // dq = inv sp (U/den + dqn n) + inv Q k
  each<DQ>(acc, [&](int r, int d, float& x) {
    const int t = t0 + r;
    const float sp = t < L ? G.aux0[t] : 0.f;
    x = d < dqk ? p.inv * sp * (x / den[r] + dqn[r] * nc[d]) : 0.f;
  });
  // sweep 2: inv Q = inv E (G/den + dqn), from sweep 1's G (or G again), tile by
  // tile into dq
  for (int s0 = 0; s0 <= t0 && s0 < L; s0 += kTile) {
    float* Qk = Gs + (s0 / kTile) % kKeptG * kTile * kQP;
    if (s0 < kKeptG * kTile) {
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int r = e / kTile, sc = e % kTile;
        Qk[r * kQP + sc] = p.inv * E(t0 + r, s0 + sc) * (Qk[r * kQP + sc] / den[r] + dqn[r]);
      }
    } else {
      Acc<kTile> Gt;
      zero<kTile>(Gt);
      mma_tile<kTile, kBf, true, false>(dv, hd.dhm(t0), hd.vm(s0), stage, Gt);
      each<kTile>(Gt, [&](int r, int sc, float& x) {
        Qk[r * kQP + sc] = p.inv * E(t0 + r, s0 + sc) * (x / den[r] + dqn[r]);
      });
    }
    __syncthreads();
    mma_tile<DQ, false, true, true>(min(kTile, L - s0), mat<float>(Qk, kQP, kTile, kTile),
                                    hd.km(s0), stage, acc);
  }
  Tin* dq = static_cast<Tin*>(p.dq) + (hd.bh / p.H) * p.lay.qk_b + (hd.bh % p.H) * p.lay.qk_h;
  each<DQ>(acc, [&](int r, int d, float& x) {
    const int t = t0 + r;
    if (t < L && d < dqk)
      st(dq + static_cast<size_t>(rw.t0 + t) * p.lay.qk_r + d, rw.valid(t) ? x : 0.f);
  });
}

// ---------------------------------------------------------------------------
// 6. The exit adjoints of every chunk, in reverse: dC'_{c-1} = g_c dC'_c +
// dC_c (one thread per element of C and n), and dg's partial sums per block
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) bwd_scan_bwd_kernel(BwdParams p) {
  __shared__ float sh[kThreads / 32];
  const Head<float> hd(p, blockIdx.y, 0);
  const long long S = static_cast<long long>(p.dqk) * p.dv_;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool in = e < S + p.dqk, isC = e < S;
  const long long off = isC ? e : e - S, step = isC ? S : p.dqk;
  const long long bq = static_cast<long long>(hd.bh) * (isC ? S : p.dqk);  // this head's C or n
  float* lam = (isC ? hd.lam : hd.lamn) + off;
  const float* ent = (isC ? hd.C : hd.n) + off;
  float* first = (isC ? p.dC0 : p.dn0) + bq + off;
  float x = in ? (isC ? p.dCT : p.dnT)[bq + off] : 0.f;
#pragma unroll 4
  for (int c = hd.NC - 1; c >= 0; --c) {
    const float part = block_sum(in ? x * ent[c * step] : 0.f, sh);
    if (threadIdx.x == 0) hd.dgp[c * p.wk.nscan + blockIdx.x] = part;
    if (!in) continue;
    const float delta = c > 0 ? lam[(c - 1) * step] : *first;
    lam[c * step] = x;
    x = hd.cfield(CG)[c] * x + delta;
  }
  if (in) *first = x;
}

// ---------------------------------------------------------------------------
// 7. dk of a 64-row tile s: w Y (Y_s = dC' v_s) and dw, then inv Q^T q over
// the t-tiles t >= s, and colD = sum_t S Q
// ---------------------------------------------------------------------------
template <typename Tin, int DQ>
__global__ void __launch_bounds__(kThreads, 2) bwd_dk_kernel(BwdParams p) {
  extern __shared__ float sm[];
  constexpr bool kBf = std::is_same<Tin, __nv_bfloat16>::value;
  float* stage = sm;
  float* Qs = stage + stage_floats(DQ);        // inv Q^T of one t-tile
  const ChunkGates G{Qs + kTile * kQP, Qs + kTile * kQP + 256, Qs + kTile * kQP + 512,
                     Qs + kTile * kQP + 768, Qs + kTile * kQP + 1024};   // den, dqn
  float* wv = G.aux1 + 256;                    // w of the tile's rows (64)
  float* colD = wv + kTile;
  float* dZ = colD + kTile;
  float* red = dZ + 2 * kTile;
  const int c = blockIdx.y, L = p.L, dqk = p.dqk, dv = p.dv_, tid = threadIdx.x;
  const int s0 = blockIdx.x * kTile;
  const Head<Tin> hd(p, blockIdx.z, c);
  const Rows<Tin>& rw = hd.rows;
  const float* lam = hd.lam + static_cast<size_t>(c) * dqk * dv;
  const float* lamn = hd.lamn + static_cast<size_t>(c) * dqk;
  for (int t = tid; t < L; t += kThreads) {
    const int g = c * L + t;
    G.b[t] = hd.field(RB)[g];
    G.a[t] = hd.field(RA)[g];
    G.mu[t] = hd.field(RMU)[g];
    G.aux0[t] = hd.field(RDEN)[g];
    G.aux1[t] = hd.field(RDQN)[g];
  }
  if (tid < kTile) {
    wv[tid] = s0 + tid < L ? hd.field(RW)[c * L + s0 + tid] : 0.f;
    colD[tid] = dZ[tid] = 0.f;
  }
  __syncthreads();

  Acc<DQ> acc;
  zero<DQ>(acc);
  mma_tile<DQ, false, true, false>(dv, hd.vm(s0, wv), mat(lam, dv, dqk, dv), stage, acc);
  {
    Acc<DQ> x;
    const WarpPos w;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < DQ / 32; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 32 * w.wm + 16 * i + w.gq + 8 * (e >> 1);
          const int d = (DQ / 4) * w.wn + 8 * j + 2 * w.tq + (e & 1);
          const float y = d < dqk ? acc[i][j][e] + wv[r] * lamn[d] : 0.f;
          acc[i][j][e] = y;
          x[i][j][e] = d < dqk ? rw.K(s0 + r, d) * y : 0.f;
        }
    row_sums<DQ>(x, red, dZ);
  }

  auto E = [&](int t, int s) {
    return s <= t && t < L ? expf(G.b[t] + G.a[s] - G.mu[t]) : 0.f;
  };
  for (int t0 = s0; t0 < L; t0 += kTile) {
    Acc<kTile> S, Gt;
    zero<kTile>(S);
    zero<kTile>(Gt);
    mma_tile<kTile, kBf, true, false>(dqk, hd.km(s0), hd.qm(t0), stage, S);
    mma_tile<kTile, kBf, true, false>(dv, hd.vm(s0), hd.dhm(t0), stage, Gt);
    const WarpPos w;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 32 * w.wm + 16 * i + w.gq + 8 * (e >> 1);
          const int cl = 16 * w.wn + 8 * j + 2 * w.tq + (e & 1);
          const int t = t0 + cl;
          const float q = t < L ? E(t, s0 + r) * (Gt[i][j][e] / G.aux0[t] + G.aux1[t]) : 0.f;
          Qs[r * kQP + cl] = p.inv * q;
          S[i][j][e] *= p.inv * q;
        }
    row_sums<kTile>(S, red, colD);             // (syncs: Qs is complete after it)
    mma_tile<DQ, false, true, true>(min(kTile, L - t0), mat<float>(Qs, kQP, kTile, kTile),
                                    hd.qm(t0), stage, acc);
  }
  Tin* dk = static_cast<Tin*>(p.dk) + (hd.bh / p.H) * p.lay.qk_b + (hd.bh % p.H) * p.lay.qk_h;
  each<DQ>(acc, [&](int r, int d, float& x) {
    const int s = s0 + r;
    if (s < L && d < dqk)
      st(dk + static_cast<size_t>(rw.t0 + s) * p.lay.qk_r + d, rw.valid(s) ? x : 0.f);
  });
  if (tid < kTile && s0 + tid < L) {
    hd.field(RCOLD)[c * L + s0 + tid] = colD[tid];
    hd.field(RDZ)[c * L + s0 + tid] = dZ[tid];
  }
}

// ---------------------------------------------------------------------------
// 8. dv of a 64-row tile s and NV columns: w Z (Z_s = dC'^T k_s), then
// (S E/den)^T dh over the t-tiles t >= s
// ---------------------------------------------------------------------------
template <typename Tin, int NV>
__global__ void __launch_bounds__(kThreads, 2) bwd_dv_kernel(BwdParams p) {
  extern __shared__ float sm[];
  constexpr bool kBf = std::is_same<Tin, __nv_bfloat16>::value;
  float* stage = sm;
  float* Ws = stage + stage_floats(NV);        // (S E/den)^T of one t-tile
  const ChunkGates G{Ws + kTile * kQP, Ws + kTile * kQP + 256, Ws + kTile * kQP + 512,
                     Ws + kTile * kQP + 768, nullptr};             // aux0 = den
  float* wv = G.aux0 + 256;
  const int c = blockIdx.y, L = p.L, dqk = p.dqk, dv = p.dv_, tid = threadIdx.x;
  const int nrt = (L + kTile - 1) / kTile;
  const int s0 = (blockIdx.x % nrt) * kTile, v0 = (blockIdx.x / nrt) * NV;
  const Head<Tin> hd(p, blockIdx.z, c);
  const Rows<Tin>& rw = hd.rows;
  const float* lam = hd.lam + static_cast<size_t>(c) * dqk * dv;
  for (int t = tid; t < L; t += kThreads) {
    const int g = c * L + t;
    G.b[t] = hd.field(RB)[g];
    G.a[t] = hd.field(RA)[g];
    G.mu[t] = hd.field(RMU)[g];
    G.aux0[t] = hd.field(RDEN)[g];
  }
  if (tid < kTile) wv[tid] = s0 + tid < L ? hd.field(RW)[c * L + s0 + tid] : 0.f;
  __syncthreads();

  Acc<NV> acc;
  zero<NV>(acc);
  mma_tile<NV, false, true, true>(dqk, hd.km(s0, wv), mat(lam + v0, dv, dqk, dv - v0), stage,
                                  acc);
  for (int t0 = s0; t0 < L; t0 += kTile) {
    Acc<kTile> S;
    zero<kTile>(S);
    mma_tile<kTile, kBf, true, false>(dqk, hd.km(s0), hd.qm(t0), stage, S);
    each<kTile>(S, [&](int r, int cl, float& x) {
      const int t = t0 + cl, s = s0 + r;
      Ws[r * kQP + cl] =
          s <= t && t < L ? p.inv * x * expf(G.b[t] + G.a[s] - G.mu[t]) / G.aux0[t] : 0.f;
    });
    __syncthreads();
    const Mat<Tin> D = hd.dhm(t0);
    mma_tile<NV, false, true, true>(min(kTile, L - t0), mat<float>(Ws, kQP, kTile, kTile),
                                    mat(D.p + v0, D.ld, D.nrow, dv - v0), stage, acc);
  }
  Tin* dvo = static_cast<Tin*>(p.dv) + (hd.bh / p.H) * p.lay.v_b + (hd.bh % p.H) * p.lay.v_h;
  each<NV>(acc, [&](int r, int col, float& x) {
    const int s = s0 + r;
    if (s < L && v0 + col < dv)
      st(dvo + static_cast<size_t>(rw.t0 + s) * p.lay.v_r + v0 + col, rw.valid(s) ? x : 0.f);
  });
}

// ---------------------------------------------------------------------------
// 9. The gate chain of each chunk with dm' = 0 (thread t = row t)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) bwd_chain_kernel(BwdParams p) {
  __shared__ float sh[kThreads / 32], sa[256], sR[256], sdR[256], scnt[256], sx[256];
  const int c = blockIdx.x, L = p.L, t = threadIdx.x;
  const Head<float> hd(p, blockIdx.y, c);
  const int g = c * L + t;
  const bool in = t < L;
  const float m = hd.cfield(CM)[c], gc = hd.cfield(CG)[c], bL = hd.cfield(CBL)[c],
              A = hd.cfield(CA)[c];
  float dg = 0.f;
  for (int i = 0; i < p.wk.nscan; ++i) dg += hd.dgp[c * p.wk.nscan + i];
  float db = 0.f, da = 0.f, dR = 0.f, dmc_t = 0.f, dz = 0.f;
  if (in) {
    const float sp = hd.field(RSP)[g], R = hd.field(RR)[g], rowD = hd.field(RROWD)[g];
    const float dX = hd.field(RDSP)[g] * sp;
    const float dmu = hd.field(RDMU)[g] - rowD - dX;
    const float tom = to_first(m, R);
    db = rowD + dX + dmu;
    dmc_t = dX + dmu * tom;
    dR = dmu * (1.f - tom);
    dz = hd.field(RDZ)[g];
    da = hd.field(RCOLD)[g] + dz;
    sa[t] = hd.field(RA)[g];
    sR[t] = R;
  }
  const float sum_dz = block_sum(dz, sh);
  const float dY = dg * gc;
  const float dm_tot = -sum_dz - dY;                 // dm' = 0 here; see the fixup
  const float to1 = to_first(m + bL, bL + A);
  const float dmc = block_sum(dmc_t, sh) + dY + dm_tot * to1;
  if (t == L - 1) {
    dR += dm_tot * (1.f - to1);
    db += sum_dz + dY + dm_tot;                      // dbL
  }
  if (in) sdR[t] = dR;
  __syncthreads();
  // R_t = max_{s<=t} a_s: a tie's share goes to every s <= t with a_s = R_t,
  // all of them in the run of equal R ending at t (R does not decrease)
  if (in) {
    float cnt = 0.f;
    for (int s = t; s >= 0 && sR[s] == sR[t]; --s) cnt += sa[s] == sR[t] ? 1.f : 0.f;
    scnt[t] = cnt;
  }
  __syncthreads();
  if (in && sa[t] == sR[t])
    for (int u = t; u < L && sR[u] == sa[t]; ++u) da += sdR[u] / scnt[u];
  if (in) sx[t] = db - da;
  __syncthreads();
  // dlogf_t = sum_{u >= t} (db_u - da_u): thread i scans row L-1-i
  const int r = L - 1 - t;
  const float run = block_scan(t < L ? sx[r] : 0.f, sh, Add());
  if (in) {
    p.dic[static_cast<size_t>(hd.bh) * p.Tp + g] = g < p.T ? da : 0.f;
    const int gr = c * L + r;
    p.dlf[static_cast<size_t>(hd.bh) * p.Tp + gr] = gr < p.T ? run : 0.f;
  }
  if (t == 0) {
    hd.cfield(CDMC)[c] = dmc;
    hd.cfield(CTO1)[c] = to1;
    hd.cfield(CCNT)[c] = scnt[L - 1];
  }
}

// ---------------------------------------------------------------------------
// 10. dm' of each chunk and its terms: dm of chunk c's entry is dmc + to1 dm',
// dm' enters db_{L-1} (every dlogf of the chunk) and, by (1 - to1), the tie
// share of R_{L-1}
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) bwd_fixup_kernel(BwdParams p) {
  __shared__ float sh[kThreads / 32], sx[256];
  const int c = blockIdx.x, L = p.L, t = threadIdx.x;
  const Head<float> hd(p, blockIdx.y, c);
  float x = p.dmT[hd.bh];
  for (int cc = hd.NC - 1; cc > c; --cc) x = hd.cfield(CDMC)[cc] + hd.cfield(CTO1)[cc] * x;
  if (c == 0 && t == 0) p.dm0[hd.bh] = hd.cfield(CDMC)[0] + hd.cfield(CTO1)[0] * x;
  const float share = x * (1.f - hd.cfield(CTO1)[c]) / hd.cfield(CCNT)[c];
  const float A = hd.cfield(CA)[c];
  const int g = c * L + t;
  const bool hit = t < L && hd.field(RA)[g] == A;
  if (t < L) sx[t] = hit ? 1.f : 0.f;
  __syncthreads();
  const int r = L - 1 - t;
  const float after = block_scan(t < L ? sx[r] : 0.f, sh, Add());     // hits at rows >= r
  if (t < L) {
    const size_t o = static_cast<size_t>(hd.bh) * p.Tp;
    if (g < p.T && hit) p.dic[o + g] += share;
    const int gr = c * L + r;
    if (gr < p.T) p.dlf[o + gr] += x - share * after;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
Layout lane_layout(int H, int Tp, int dqk, int dv) {
  const long long Gq = static_cast<long long>(H) * dqk, Gv = static_cast<long long>(H) * dv;
  return {Tp * Gq, dqk, Gq, Tp * Gv, dv, Gv};
}

float inv_sqrt(int d) { return static_cast<float>(1.0 / std::sqrt(static_cast<double>(d))); }

template <class K>
int launch(K kernel, dim3 grid, size_t smem, const BwdParams& p, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, int DQ, int NV>
int launch_bwd(const BwdParams& p, int B, cudaStream_t s) {
  const int BH = B * p.H, NC = p.Tp / p.L, nrt = (p.L + kTile - 1) / kTile;
  const int ndt = (p.dqk + kTile - 1) / kTile;
  const int nst = ndt * ((p.dv_ + kTile - 1) / kTile);
  const size_t state_smem = sizeof(float) * (stage_floats(kTile) + 256);
  const unsigned nscan = static_cast<unsigned>(p.wk.nscan);
  int err = launch(bwd_gates_kernel, dim3(NC, BH), 0, p, s);
  if (err == 0) err = launch(bwd_gates_m_kernel, dim3(NC, BH), 0, p, s);
  if (err == 0 && NC > 1)
    err = launch(bwd_state_kernel<Tin, false>, dim3(nst, NC - 1, BH), state_smem, p, s);
  if (err == 0 && NC > 1)
    err = launch(bwd_nterm_kernel<Tin, false>, dim3(NC - 1, BH, ndt), 0, p, s);
  if (err == 0) err = launch(bwd_scan_fwd_kernel, dim3(nscan, BH), 0, p, s);
  if (err == 0)
    err = launch(bwd_rows_kernel<Tin, DQ>, dim3(nrt, NC, BH),
                 tiles_smem_bytes(DQ, kKeptG * kTile), p, s);
  if (err == 0) err = launch(bwd_state_kernel<Tin, true>, dim3(nst, NC, BH), state_smem, p, s);
  if (err == 0) err = launch(bwd_nterm_kernel<Tin, true>, dim3(NC, BH, ndt), 0, p, s);
  if (err == 0) err = launch(bwd_scan_bwd_kernel, dim3(nscan, BH), 0, p, s);
  if (err == 0)
    err = launch(bwd_dk_kernel<Tin, DQ>, dim3(nrt, NC, BH), tiles_smem_bytes(DQ, kTile), p, s);
  if (err == 0)
    err = launch(bwd_dv_kernel<Tin, NV>, dim3(nrt * ((p.dv_ + NV - 1) / NV), NC, BH),
                 tiles_smem_bytes(NV, kTile), p, s);
  if (err == 0) err = launch(bwd_chain_kernel, dim3(NC, BH), 0, p, s);
  if (err == 0) err = launch(bwd_fixup_kernel, dim3(NC, BH), 0, p, s);
  return err;
}

template <typename Tin>
int launch_bwd_for(const BwdParams& p, int B, cudaStream_t s) {
  const bool wide_v = p.dv_ > kTile;
  if (p.dqk <= 64)
    return wide_v ? launch_bwd<Tin, 64, 128>(p, B, s) : launch_bwd<Tin, 64, 64>(p, B, s);
  if (p.dqk <= 128)
    return wide_v ? launch_bwd<Tin, 128, 128>(p, B, s) : launch_bwd<Tin, 128, 64>(p, B, s);
  return wide_v ? launch_bwd<Tin, 256, 128>(p, B, s) : launch_bwd<Tin, 256, 64>(p, B, s);
}

}  // namespace
}  // namespace mlstm

using namespace mlstm;

// Each returns the first cudaError_t of its launches (0 on success).  dtype 0
// is float32, 1 bfloat16 (q, k, v, h, dh, dq, dk, dv).  L must divide Tp,
// T > Tp - L, and L and dqk be at most 256 (the wrapper checks).
extern "C" int mlstm_fused_fwd(int dtype, const void* q, const void* k, const void* v,
                               const float* ic, const float* lf, const float* C0, const float* n0,
                               const float* m0, void* h, float* CT, float* nT, float* mT, int B,
                               int H, int Tp, int T, int dqk, int dv, int L, void* stream) {
  FwdParams p{q,  k,  v,  ic, lf, C0, n0, m0, h, CT, nT, mT, lane_layout(H, Tp, dqk, dv),
              H, Tp, T, dqk, dv, L,  inv_sqrt(dqk)};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float, float>(p, B, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16, __nv_bfloat16>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The floats of K9b's workspace (mlstm_fused_bwd's work) for these shapes.
extern "C" long long mlstm_fused_bwd_work(int B, int H, int Tp, int dqk, int dv, int L) {
  return static_cast<long long>(B) * H * work_layout(Tp, dqk, dv, L).stride;
}

extern "C" int mlstm_fused_bwd(int dtype, const void* q, const void* k, const void* v,
                               const float* ic, const float* lf, const float* C0, const float* n0,
                               const float* m0, const void* dh, const float* dCT,
                               const float* dnT, const float* dmT, void* dq, void* dk, void* dv,
                               float* dic, float* dlf, float* dC0, float* dn0, float* dm0,
                               float* work, int B, int H, int Tp, int T, int dqk, int dv_, int L,
                               void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{q,   k,    v,  dh,  ic,  lf,  C0,  n0,   m0,
              dCT, dnT,  dmT, dq, dk,  dv,  dic, dlf, dC0,
              dn0, dm0,  work, work_layout(Tp, dqk, dv_, L), lane_layout(H, Tp, dqk, dv_),
              H,   Tp,   T,   dqk, dv_, L,  inv_sqrt(dqk)};
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_bwd_for<float>(p, B, s) : launch_bwd_for<__nv_bfloat16>(p, B, s);
}
