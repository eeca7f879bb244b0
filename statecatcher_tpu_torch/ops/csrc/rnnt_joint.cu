// Fused RNN-T joint -> (blank, emit) log-probs for Hopper (sm_90a): the
// forward kernel and the two kernels of its backward.
//
// Replaces the TPU kernels of statecatcher_tpu/ops/rnnt_pallas.py:
//   K6a  rnnt_joint_fwd_kernel      <- _fwd_kernel (:72), launched by _core_fwd_impl (:155)
//   K6b  rnnt_joint_bwd_rows_kernel <- _bwd_kernel (:92), launched by _core_bwd (:196):
//        rnnt_joint_bwd_dk_kernel      d_enc and d_pred here, d_K and d_bias there
//
//   enc    (B, T, J) f32, pred (B, U1, J) f32, U1 = U+1 (the wrapper casts)
//   K      (J, V) f32 (the JAX layout), bias (V) f32, labels (B, U) int32
//   rows   r = (b*T + t)*U1 + u, R = B*T*U1 of them; a label outside [0, V)
//          selects no column (emit logit 0, no one-hot) rather than read
//          outside K
//   fwd:   joint = tanh(enc_t + pred_u); logits_v = joint.K[:, v] + bias_v;
//          lse = logsumexp_v(logits); blank = logits[blank_id] - lse;
//          emit (u < U) = joint.K[:, label_u] + bias[label_u] - lse;
//          lse (B, T, U1) is written as the backward's residual.
//   bwd:   d_logits = g_b*[v == blank] + g_e*[v == label_u] - (g_b + g_e)*softmax
//          (g_e = 0 at u = U); d_joint = (d_logits.K^T) * (1 - joint^2) per row,
//          summed in the kernel over u (d_enc) and over t (d_pred) within a
//          patch of 16 frames x 8 label positions and written as partial sums
//          per patch: (B, T, ceil(U1/8), J) and (B, ceil(T/16), U1, J);
//          d_K = sum over rows of joint^T d_logits, d_bias = sum of d_logits,
//          written as partial sums per row split.  The wrapper adds the
//          partials up; nothing row-sized leaves the kernels.
//   bf16:  with bf != 0 (bf16 enc/pred) the joint, K and d_logits entering a
//          product are rounded to bf16 first; the products are exact in f32
//          and the sums are f32, as _joint_tile's bf16 matmul with f32
//          accumulation.  The emit logit uses the f32 joint and K, the bias
//          is added in f32, as the TPU kernel's gathered emit column does.
//
// Bound on the card: operations.  Forward: R*V*(2J + ~8) flops (the
// contraction, and the exp and compares of the logsumexp), 3.3e11 + 2.6e9
// exps at B=32, T=1598, U=48, J=64, V=1024: ~5 ms at the 67 TFLOP/s of f32
// outside the tensor cores.  Backward: the function needs the logits once
// more (they are not saved), d_joint and d_K: three contractions, ~3x.  This
// design recomputes the logits in both of its kernels, a fourth contraction
// that the bound does not count.
//
// Design (a simple tiled kernel, f32 FMA, no tensor cores): a block of 256
// threads (16 x 16) owns tiles of 128 rows x 64 vocab columns; each thread a
// 8 x 4 register micro-tile.  The rows' joint values (tanh recomputed from
// enc and pred) and a 64-column tile of K sit in shared memory, read as
// float4 broadcasts.  The (B, T, U1, V) logits never leave registers:
//   fwd       walks V in tiles with an online max/sum per row, merged across
//             the 16 threads of a row by shuffles at the end;
//   bwd rows  owns a 16 x 8 patch of (t, u) of one batch row (a thread's 8
//             rows are the 8 u of one t), walks V in tiles, forms the d_logits
//             tile in shared memory and accumulates d_joint (rows x J) in
//             registers; then sums it over u in registers and over t through
//             shared memory.  U1 is padded to a multiple of 8 here (49 -> 56
//             rows at U = 48);
//   bwd d_K   fixes one V tile per block and walks a strided share of the
//             row tiles, accumulating d_K (J x 64) and d_bias in registers;
//             its partial sums go out per split (gridDim.y), so the result is
//             deterministic: no atomics, as the TPU kernel's sequential grid
//             did by accumulating in place.
// Only the per-row lse is saved by the forward; nothing joint-sized is kept.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRT = 128;             // rows per tile
constexpr int kVT = 64;              // vocab columns per tile
constexpr int kThreads = 256;        // 16 (ty, rows) x 16 (tx, columns)
constexpr int kRP = kRT + 4;         // padded stride of [j][row] and [v][row] arrays
constexpr int kVP = kVT + 4;         // padded stride of [row][v] arrays
constexpr int kRows = kRT / 16;      // 8 rows per thread
constexpr int kCols = kVT / 16;      // 4 columns per thread
constexpr int kPT = kRT / kRows;     // bwd rows patch: 16 frames ...
constexpr int kPU = kRows;           // ... x 8 label positions, row = tt * kPU + uu

struct Geo {
  long long R;
  int B, T, U1, U, J, V;
};

// The kRT rows a block owns: the linear rows r0 .. r0+kRT (b < 0), or the
// patch of frames t0 .. t0+kPT and label positions u0 .. u0+kPU of batch row b.
struct Tile {
  long long r0;
  int b, t0, u0;
};

// Global row of the tile's row `row`, or -1 outside the rows.
__device__ __forceinline__ long long tile_row(const Tile& tl, const Geo& g, int row) {
  if (tl.b < 0) {
    const long long r = tl.r0 + row;
    return r < g.R ? r : -1;
  }
  const int t = tl.t0 + row / kPU, u = tl.u0 + row % kPU;
  return (t < g.T && u < g.U1) ? (static_cast<long long>(tl.b) * g.T + t) * g.U1 + u : -1;
}

__device__ __forceinline__ Tile linear_tile(long long r0) { return Tile{r0, -1, 0, 0}; }

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// tanh(enc_t + pred_u)_j of row r (0 for r = -1 or past J)
__device__ __forceinline__ float joint_at(const float* __restrict__ enc,
                                          const float* __restrict__ pred, const Geo& g,
                                          long long r, int j) {
  if (r < 0 || j >= g.J) return 0.0f;
  const long long bt = r / g.U1;
  const int u = static_cast<int>(r - bt * g.U1);
  const long long b = bt / g.T;
  return tanhf(enc[bt * g.J + j] + pred[(b * g.U1 + u) * g.J + j]);
}

// The joint of the tile's rows into jT[j][row] (and jR[row][j] when given).
template <int JP>
__device__ void load_joint(const float* __restrict__ enc, const float* __restrict__ pred,
                           const Geo& g, const Tile& tl, bool round, float* jT, float* jR) {
  for (int e = threadIdx.x; e < kRT * JP; e += kThreads) {
    const int row = e / JP;
    const int j = e % JP;
    float v = joint_at(enc, pred, g, tile_row(tl, g, row), j);
    if (round) v = rbf(v);
    jT[j * kRP + row] = v;
    if (jR != nullptr) jR[row * (JP + 4) + j] = v;
  }
}

// Columns v0 .. v0+kVT of K into kT[j][v] (and kvT[v][j] when given).
template <int JP>
__device__ void load_k(const float* __restrict__ K, const Geo& g, int v0, bool round, float* kT,
                       float* kvT) {
  for (int e = threadIdx.x; e < JP * kVT; e += kThreads) {
    const int j = e / kVT;
    const int vv = e % kVT;
    const int v = v0 + vv;
    float x = (j < g.J && v < g.V) ? K[static_cast<size_t>(j) * g.V + v] : 0.0f;
    if (round) x = rbf(x);
    kT[e] = x;
    if (kvT != nullptr) kvT[vv * (JP + 4) + j] = x;
  }
}

// acc[i][c] = sum_j jT[j][ty*8+i] * kT[j][tx*4+c]
template <int JP>
__device__ __forceinline__ void logits_tile(const float* jT, const float* kT, int ty, int tx,
                                            float acc[kRows][kCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < JP; ++j) {
    const float4 a0 = ld4(jT + j * kRP + ty * kRows);
    const float4 a1 = ld4(jT + j * kRP + ty * kRows + 4);
    const float4 bk = ld4(kT + j * kVT + tx * kCols);
    const float a[kRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float k[kCols] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(a[i], k[c], acc[i][c]);
  }
}

// Per-row scalars of the backward: g_b, g_e, label (-1 at u = U or outside),
// lse; zeros outside the rows, so those rows give d_logits = 0.
__device__ void load_row_scalars(const Geo& g, const Tile& tl, const int* __restrict__ labels,
                                 const float* __restrict__ lse, const float* __restrict__ g_blank,
                                 const float* __restrict__ g_emit, float* s_gb, float* s_ge,
                                 int* s_lab, float* s_lse) {
  for (int row = threadIdx.x; row < kRT; row += kThreads) {
    const long long r = tile_row(tl, g, row);
    float gb = 0.0f, ge = 0.0f, ls = 0.0f;
    int lab = -1;
    if (r >= 0) {
      const long long bt = r / g.U1;
      const int u = static_cast<int>(r - bt * g.U1);
      const long long b = bt / g.T;
      gb = g_blank[r];
      ls = lse[r];
      if (u < g.U) {
        ge = g_emit[bt * g.U + u];
        lab = labels[b * g.U + u];
        if (lab < 0 || lab >= g.V) lab = -1;  // no column, as in the forward
      }
    }
    s_gb[row] = gb;
    s_ge[row] = ge;
    s_lab[row] = lab;
    s_lse[row] = ls;
  }
}

// d_logits of one element
__device__ __forceinline__ float dlogit(float l, float ls, float gb, float ge, int v, int blank_id,
                                        int lab, bool round) {
  float d = -(gb + ge) * expf(l - ls);
  if (v == blank_id) d += gb;
  if (v == lab) d += ge;
  return round ? rbf(d) : d;
}

// ---------------------------------------------------------------------------
// K6a: forward
// ---------------------------------------------------------------------------
template <int JP>
__global__ void __launch_bounds__(kThreads)
rnnt_joint_fwd_kernel(const float* __restrict__ enc, const float* __restrict__ pred,
                      const float* __restrict__ K, const float* __restrict__ bias,
                      const int* __restrict__ labels, Geo g, int blank_id, int bf,
                      float* __restrict__ blank_out, float* __restrict__ emit_out,
                      float* __restrict__ lse_out) {
  extern __shared__ float4 smem4[];
  float* jT = reinterpret_cast<float*>(smem4);  // [JP][kRP]
  float* kT = jT + JP * kRP;                     // [JP][kVT]
  float* s_blank = kT + JP * kVT;                // [kRT] blank logit
  float* s_emit = s_blank + kRT;                 // [kRT] emit logit
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRT;

  load_joint<JP>(enc, pred, g, linear_tile(r0), false, jT, nullptr);
  __syncthreads();
  // emit logit from the f32 joint and the f32 column of K at the label
  for (int row = tid; row < kRT; row += kThreads) {
    const long long r = r0 + row;
    float e = 0.0f;
    if (r < g.R) {
      const long long bt = r / g.U1;
      const int u = static_cast<int>(r - bt * g.U1);
      const int lab = u < g.U ? labels[(bt / g.T) * g.U + u] : -1;
      if (lab >= 0 && lab < g.V) {  // never read K outside its columns
        for (int j = 0; j < g.J; ++j)
          e = fmaf(jT[j * kRP + row], K[static_cast<size_t>(j) * g.V + lab], e);
        e += bias[lab];
      }
    }
    s_emit[row] = e;
  }
  if (bf) {
    __syncthreads();
    for (int e = tid; e < JP * kRT; e += kThreads) {
      const int j = e / kRT, row = e % kRT;
      jT[j * kRP + row] = rbf(jT[j * kRP + row]);
    }
  }

  float m[kRows], s[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    s[i] = 0.0f;
  }
  for (int v0 = 0; v0 < g.V; v0 += kVT) {
    __syncthreads();
    load_k<JP>(K, g, v0, bf != 0, kT, nullptr);
    __syncthreads();
    float acc[kRows][kCols];
    logits_tile<JP>(jT, kT, ty, tx, acc);
    float bv[kCols];
    bool ok[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int v = v0 + tx * kCols + c;
      ok[c] = v < g.V;
      bv[c] = ok[c] ? bias[v] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        acc[i][c] += bv[c];
        if (ok[c]) tmax = fmaxf(tmax, acc[i][c]);
        if (ok[c] && v0 + tx * kCols + c == blank_id) s_blank[ty * kRows + i] = acc[i][c];
      }
      if (tmax > -INFINITY) {
        const float mn = fmaxf(m[i], tmax);
        float add = 0.0f;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (ok[c]) add += expf(acc[i][c] - mn);
        s[i] = s[i] * expf(m[i] - mn) + add;
        m[i] = mn;
      }
    }
  }
  // merge each row's (max, sum) over its 16 threads (lanes tx of one half-warp)
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float so = __shfl_xor_sync(0xffffffffu, s[i], off);
      const float mn = fmaxf(m[i], mo);
      if (mn > -INFINITY) {
        s[i] = (m[i] > -INFINITY ? s[i] * expf(m[i] - mn) : 0.0f) +
               (mo > -INFINITY ? so * expf(mo - mn) : 0.0f);
        m[i] = mn;
      }
    }
  }
  __syncthreads();
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty * kRows + i;
      const long long r = r0 + row;
      if (r >= g.R) continue;
      const float ls = m[i] + logf(s[i]);
      lse_out[r] = ls;
      blank_out[r] = s_blank[row] - ls;
      const long long bt = r / g.U1;
      const int u = static_cast<int>(r - bt * g.U1);
      if (u < g.U) emit_out[bt * g.U + u] = s_emit[row] - ls;
    }
  }
}

// ---------------------------------------------------------------------------
// K6b, part 1: d_enc and d_pred, partial sums per (t, u) patch
// ---------------------------------------------------------------------------
// grid (ceil(U1/kPU), ceil(T/kPT), B); d_enc_part (B, T, gridDim.x, J),
// d_pred_part (B, gridDim.y, U1, J)
template <int JP>
__global__ void __launch_bounds__(kThreads)
rnnt_joint_bwd_rows_kernel(const float* __restrict__ enc, const float* __restrict__ pred,
                           const float* __restrict__ K, const float* __restrict__ bias,
                           const int* __restrict__ labels, const float* __restrict__ lse,
                           const float* __restrict__ g_blank, const float* __restrict__ g_emit,
                           Geo g, int blank_id, int bf, float* __restrict__ d_enc_part,
                           float* __restrict__ d_pred_part) {
  constexpr int kJ = JP / 16;                     // j per thread
  extern __shared__ float4 smem4[];
  float* jT = reinterpret_cast<float*>(smem4);   // [JP][kRP]
  float* kT = jT + JP * kRP;                      // [JP][kVT]
  float* kvT = kT + JP * kVT;                     // [kVT][JP+4]
  float* dT = kvT + kVT * (JP + 4);               // [kVT][kRP] d_logits
  float* s_gb = dT + kVT * kRP;
  float* s_ge = s_gb + kRT;
  float* s_lse = s_ge + kRT;
  int* s_lab = reinterpret_cast<int*>(s_lse + kRT);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const Tile tl{0, static_cast<int>(blockIdx.z), static_cast<int>(blockIdx.y) * kPT,
                static_cast<int>(blockIdx.x) * kPU};
  const bool round = bf != 0;

  load_joint<JP>(enc, pred, g, tl, round, jT, nullptr);
  load_row_scalars(g, tl, labels, lse, g_blank, g_emit, s_gb, s_ge, s_lab, s_lse);

  float dj[kRows][kJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int q = 0; q < kJ; ++q) dj[i][q] = 0.0f;

  for (int v0 = 0; v0 < g.V; v0 += kVT) {
    __syncthreads();
    load_k<JP>(K, g, v0, round, kT, kvT);
    __syncthreads();
    float acc[kRows][kCols];
    logits_tile<JP>(jT, kT, ty, tx, acc);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int v = v0 + tx * kCols + c;
      const float bv = v < g.V ? bias[v] : 0.0f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = ty * kRows + i;
        dT[(tx * kCols + c) * kRP + row] =
            v < g.V ? dlogit(acc[i][c] + bv, s_lse[row], s_gb[row], s_ge[row], v, blank_id,
                             s_lab[row], round)
                    : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int vv = 0; vv < kVT; ++vv) {
      const float4 a0 = ld4(dT + vv * kRP + ty * kRows);
      const float4 a1 = ld4(dT + vv * kRP + ty * kRows + 4);
      const float a[kRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float k[kJ];
#pragma unroll
      for (int q = 0; q < kJ; q += 4) {
        const float4 kk = ld4(kvT + vv * (JP + 4) + tx * kJ + q);
        k[q] = kk.x;
        k[q + 1] = kk.y;
        k[q + 2] = kk.z;
        k[q + 3] = kk.w;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int q = 0; q < kJ; ++q) dj[i][q] = fmaf(a[i], k[q], dj[i][q]);
    }
  }
  // d_joint = (d_logits . K^T) * tanh'(f32 joint), 0 outside the rows.  The
  // thread's 8 rows are the patch's 8 u of frame t0 + ty: their sum is its
  // d_enc partial.  d_joint goes to shared memory (over jT, read for the last
  // time above) for the sums over t.
  __syncthreads();
  float* dS = jT;                                 // [JP][kRP] d_joint
  const int t = tl.t0 + ty;
  const size_t n_u = gridDim.x;
#pragma unroll
  for (int q = 0; q < kJ; ++q) {
    const int j = tx * kJ + q;
    float se = 0.0f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long r = tile_row(tl, g, ty * kRows + i);
      const float x = joint_at(enc, pred, g, r, j);
      const float d = r >= 0 ? dj[i][q] * (1.0f - x * x) : 0.0f;
      dS[j * kRP + ty * kRows + i] = d;
      se += d;
    }
    if (t < g.T && j < g.J)
      d_enc_part[((static_cast<size_t>(tl.b) * g.T + t) * n_u + blockIdx.x) * g.J + j] = se;
  }
  __syncthreads();
  for (int e = tid; e < kPU * JP; e += kThreads) {
    const int uu = e % kPU, j = e / kPU;
    const int u = tl.u0 + uu;
    if (u >= g.U1 || j >= g.J) continue;
    float sp = 0.0f;
    for (int tt = 0; tt < kPT; ++tt) sp += dS[j * kRP + tt * kPU + uu];
    d_pred_part[((static_cast<size_t>(tl.b) * gridDim.y + blockIdx.y) * g.U1 + u) * g.J + j] = sp;
  }
}

// ---------------------------------------------------------------------------
// K6b, part 2: d_K and d_bias, partial sums per row split
// ---------------------------------------------------------------------------
template <int JP>
__global__ void __launch_bounds__(kThreads)
rnnt_joint_bwd_dk_kernel(const float* __restrict__ enc, const float* __restrict__ pred,
                         const float* __restrict__ K, const float* __restrict__ bias,
                         const int* __restrict__ labels, const float* __restrict__ lse,
                         const float* __restrict__ g_blank, const float* __restrict__ g_emit,
                         Geo g, int blank_id, int bf, float* __restrict__ dk_part,
                         float* __restrict__ db_part) {
  constexpr int kJ = JP / 16;                     // j per thread
  extern __shared__ float4 smem4[];
  float* kT = reinterpret_cast<float*>(smem4);   // [JP][kVT]
  float* jT = kT + JP * kVT;                      // [JP][kRP]
  float* jR = jT + JP * kRP;                      // [kRT][JP+4]
  float* dR = jR + kRT * (JP + 4);                // [kRT][kVP] d_logits
  float* s_gb = dR + kRT * kVP;
  float* s_ge = s_gb + kRT;
  float* s_lse = s_ge + kRT;
  int* s_lab = reinterpret_cast<int*>(s_lse + kRT);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int v0 = blockIdx.x * kVT;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const long long ntiles = (g.R + kRT - 1) / kRT;
  const bool round = bf != 0;

  load_k<JP>(K, g, v0, round, kT, nullptr);
  float bv[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int v = v0 + tx * kCols + c;
    bv[c] = v < g.V ? bias[v] : 0.0f;
  }
  float dk[kJ][kCols], cs[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    cs[c] = 0.0f;
#pragma unroll
    for (int q = 0; q < kJ; ++q) dk[q][c] = 0.0f;
  }

  for (long long tile = split; tile < ntiles; tile += nsplit) {
    const long long r0 = tile * kRT;
    __syncthreads();
    load_joint<JP>(enc, pred, g, linear_tile(r0), round, jT, jR);
    load_row_scalars(g, linear_tile(r0), labels, lse, g_blank, g_emit, s_gb, s_ge, s_lab, s_lse);
    __syncthreads();
    float acc[kRows][kCols];
    logits_tile<JP>(jT, kT, ty, tx, acc);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty * kRows + i;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int v = v0 + tx * kCols + c;
        const float d = v < g.V ? dlogit(acc[i][c] + bv[c], s_lse[row], s_gb[row], s_ge[row], v,
                                          blank_id, s_lab[row], round)
                                : 0.0f;
        dR[row * kVP + tx * kCols + c] = d;
        cs[c] += d;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int row = 0; row < kRT; ++row) {
      float a[kJ];
#pragma unroll
      for (int q = 0; q < kJ; q += 4) {
        const float4 aa = ld4(jR + row * (JP + 4) + ty * kJ + q);
        a[q] = aa.x;
        a[q + 1] = aa.y;
        a[q + 2] = aa.z;
        a[q + 3] = aa.w;
      }
      const float4 dd = ld4(dR + row * kVP + tx * kCols);
      const float d[kCols] = {dd.x, dd.y, dd.z, dd.w};
#pragma unroll
      for (int q = 0; q < kJ; ++q)
#pragma unroll
        for (int c = 0; c < kCols; ++c) dk[q][c] = fmaf(a[q], d[c], dk[q][c]);
    }
  }
  // column sums of d_logits over the 16 row groups (ty), through shared memory
  __syncthreads();
  float* red = dR;  // [16][kVT]
#pragma unroll
  for (int c = 0; c < kCols; ++c) red[ty * kVT + tx * kCols + c] = cs[c];
  __syncthreads();
  if (tid < kVT && v0 + tid < g.V) {
    float sum = 0.0f;
    for (int y = 0; y < 16; ++y) sum += red[y * kVT + tid];
    db_part[static_cast<size_t>(split) * g.V + v0 + tid] = sum;
  }
#pragma unroll
  for (int q = 0; q < kJ; ++q) {
    const int j = ty * kJ + q;
    if (j >= g.J) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int v = v0 + tx * kCols + c;
      if (v < g.V) dk_part[(static_cast<size_t>(split) * g.J + j) * g.V + v] = dk[q][c];
    }
  }
}

size_t fwd_smem(int jp) { return sizeof(float) * (jp * kRP + jp * kVT + 2 * kRT); }
size_t rows_smem(int jp) {
  return sizeof(float) * (jp * kRP + jp * kVT + kVT * (jp + 4) + kVT * kRP + 4 * kRT);
}
size_t dk_smem(int jp) {
  return sizeof(float) * (jp * kVT + jp * kRP + kRT * (jp + 4) + kRT * kVP + 4 * kRT);
}

template <int JP>
int launch_fwd(const float* enc, const float* pred, const float* K, const float* bias,
               const int* labels, const Geo& g, int blank_id, int bf, float* blank,
               float* emit, float* lse, cudaStream_t stream) {
  const size_t smem = fwd_smem(JP);
  cudaError_t err = cudaFuncSetAttribute(rnnt_joint_fwd_kernel<JP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (g.R + kRT - 1) / kRT;
  rnnt_joint_fwd_kernel<JP><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      enc, pred, K, bias, labels, g, blank_id, bf, blank, emit, lse);
  return static_cast<int>(cudaGetLastError());
}

template <int JP>
int launch_bwd(const float* enc, const float* pred, const float* K, const float* bias,
               const int* labels, const float* lse, const float* g_blank, const float* g_emit,
               const Geo& g, int blank_id, int bf, int nsplit, float* d_enc_part,
               float* d_pred_part, float* dk_part, float* db_part, cudaStream_t stream) {
  const size_t smem_rows = rows_smem(JP), smem_dk = dk_smem(JP);
  cudaError_t err = cudaFuncSetAttribute(rnnt_joint_bwd_rows_kernel<JP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_rows));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(rnnt_joint_bwd_dk_kernel<JP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dk));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 patches((g.U1 + kPU - 1) / kPU, (g.T + kPT - 1) / kPT, g.B);
  rnnt_joint_bwd_rows_kernel<JP><<<patches, kThreads, smem_rows, stream>>>(
      enc, pred, K, bias, labels, lse, g_blank, g_emit, g, blank_id, bf, d_enc_part, d_pred_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.V + kVT - 1) / kVT, nsplit);
  rnnt_joint_bwd_dk_kernel<JP><<<grid, kThreads, smem_dk, stream>>>(
      enc, pred, K, bias, labels, lse, g_blank, g_emit, g, blank_id, bf, dk_part, db_part);
  return static_cast<int>(cudaGetLastError());
}

Geo make_geo(int B, int T, int U1, int J, int V) {
  Geo g;
  g.R = static_cast<long long>(B) * T * U1;
  g.B = B;
  g.T = T;
  g.U1 = U1;
  g.U = U1 - 1;
  g.J = J;
  g.V = V;
  return g;
}

}  // namespace

// Each returns the first cudaError_t of its launches (0 on success).  J must
// be at most 128 and blank_id in [0, V) (the wrapper checks).
extern "C" int rnnt_joint_fwd(const float* enc, const float* pred, const float* K,
                              const float* bias, const int* labels, float* blank, float* emit,
                              float* lse, int B, int T, int U1, int J, int V, int blank_id,
                              int bf, void* stream) {
  const Geo g = make_geo(B, T, U1, J, V);
  auto s = static_cast<cudaStream_t>(stream);
  if (J <= 64)
    return launch_fwd<64>(enc, pred, K, bias, labels, g, blank_id, bf, blank, emit, lse, s);
  if (J <= 128)
    return launch_fwd<128>(enc, pred, K, bias, labels, g, blank_id, bf, blank, emit, lse, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rnnt_joint_bwd(const float* enc, const float* pred, const float* K,
                              const float* bias, const int* labels, const float* lse,
                              const float* g_blank, const float* g_emit, float* d_enc_part,
                              float* d_pred_part, float* dk_part, float* db_part, int B, int T,
                              int U1, int J, int V,
                              int blank_id, int bf, int nsplit, void* stream) {
  const Geo g = make_geo(B, T, U1, J, V);
  auto s = static_cast<cudaStream_t>(stream);
  if (J <= 64)
    return launch_bwd<64>(enc, pred, K, bias, labels, lse, g_blank, g_emit, g, blank_id, bf,
                          nsplit, d_enc_part, d_pred_part, dk_part, db_part, s);
  if (J <= 128)
    return launch_bwd<128>(enc, pred, K, bias, labels, lse, g_blank, g_emit, g, blank_id, bf,
                           nsplit, d_enc_part, d_pred_part, dk_part, db_part, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
