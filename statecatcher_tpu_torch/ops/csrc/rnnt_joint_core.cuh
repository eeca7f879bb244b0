// The fused RNN-T joint -> (blank, emit) log-probs, shared by the exact joint
// (rnnt_joint.cu, K6) and the banded joint (rnnt_band.cu, K8): the forward
// kernel and the two kernels of its backward, over a grid of lattice rows.
//
//   enc    (B, T, J) f32, pred (B, U1, J) f32, U1 = U+1 (the wrappers cast)
//   K      (J, V) f32 (the JAX layout), bias (V) f32, labels (B, U) int32
//   rows   r = (b*TT + t)*W + w, R = B*TT*W of them, at label position
//          u = w (K6: TT = T, W = U1) or u = o[b, t / Tb] + w (K8: TT = Tp,
//          the frames padded to whole time blocks, W = Wp, the band's width,
//          o the band starts).  Frames t >= T read enc as 0 and positions
//          u >= U1 read pred as 0 (the JAX kernels' zero padding); a label
//          position u >= U, or a label outside [0, V), selects no column
//          (emit logit 0, no one-hot) rather than read outside K.
//   fwd:   joint = tanh(enc_t + pred_u); logits_v = joint.K[:, v] + bias_v;
//          lse = logsumexp_v(logits); blank = logits[blank_id] - lse;
//          emit = joint.K[:, label_u] + bias[label_u] - lse (K6: u < U only,
//          written (B, T, U); K8: every row, written (B, Tp, Wp));
//          lse per row is written as the backward's residual.
//   bwd:   d_logits = g_b*[v == blank] + g_e*[v == label_u] - (g_b + g_e)*softmax
//          (K6: g_e = 0 at u = U); d_joint = (d_logits.K^T) * (1 - joint^2) per
//          row, summed in the kernel over w (d_enc) and over t (d_pred) within
//          a patch of PT frames x PU positions (K6 16 x 8, K8 8 x 16) and
//          written as partial sums per patch: (B, TT, nw, J) with nw =
//          ceil(W/PU)*PU/8 groups of 8 positions, and (B, ceil(TT/PT), W, J);
//          d_K = sum over rows of joint^T d_logits, d_bias = sum of d_logits,
//          written as partial sums per row split.  The callers add the
//          partials up; nothing row-sized leaves the kernels.
//   bf16:  with bf != 0 (bf16 enc/pred) the joint, K, the bias and d_logits
//          entering the logits or a product are rounded to bf16 first; the
//          products are exact in f32 and the sums are f32, as _joint_tile's
//          bf16 matmul with f32 accumulation over the padded kernel matrix,
//          whose row J holds the bias.  The emit logit uses the f32 joint, K
//          and bias, as the TPU kernels' gathered emit column does.
//
// Bound on the card: operations.  Forward: R*V*(2J + ~8) flops (the
// contraction, and the exp and compares of the logsumexp), 3.3e11 + 2.6e9
// exps at R = 2.5M rows (B=32, T=1598, U=48 exact, or U=128 at band 32),
// J=64, V=1024: ~5 ms at the 67 TFLOP/s of f32 outside the tensor cores.
// Backward: the function needs the logits once more (they are not saved),
// d_joint and d_K: three contractions, ~3x.  This design recomputes the
// logits in both of its kernels, a fourth contraction that the bound does
// not count.
//
// Design (a simple tiled kernel, f32 FMA, no tensor cores): a block of 256
// threads (16 x 16) owns tiles of 128 rows x 64 vocab columns; each thread a
// 8 x 4 register micro-tile.  The rows' joint values (tanh recomputed from
// enc and pred) and a 64-column tile of K sit in shared memory, read as
// float4 broadcasts.  The (rows, V) logits never leave registers:
//   fwd       walks V in tiles with an online max/sum per row, merged across
//             the 16 threads of a row by shuffles at the end;
//   bwd rows  owns a PT x PU patch of (t, w) of one batch row (a thread's 8
//             rows are 8 positions of one frame), walks V in tiles, forms the
//             d_logits tile in shared memory and accumulates d_joint
//             (rows x J) in registers; then sums it over w in registers and
//             over t through shared memory.  W is padded to a multiple of PU
//             here (K6: 49 -> 56 rows at U = 48);
//   bwd d_K   fixes one V tile per block and walks a strided share of the
//             row tiles, accumulating d_K (J x 64) and d_bias in registers;
//             its partial sums go out per split (gridDim.y), so the result is
//             deterministic: no atomics, as the TPU kernels' sequential grid
//             did by accumulating in place.
// The rows' offsets into enc and pred are worked out once per row and tile
// (load_row_offsets), not per element.  Only the per-row lse is saved by the
// forward; nothing joint-sized is kept.

#pragma once

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

struct Geo {
  long long R;
  int B, T, TT, W, U1, U, J, V;
  const int* o;                      // K8: band starts (B, nblk); K6: nullptr
  int Tb, nblk;                      // K8: frames per band block, blocks per row
  int PT, PU;                        // bwd rows patch: PT frames x PU positions (PT*PU = kRT)
};

// Batch row, frame and label position of row r (bt = b*TT + t)
struct RowPos {
  long long bt;
  int b, t, u;
};

__device__ __forceinline__ RowPos row_pos(const Geo& g, long long r) {
  RowPos p;
  p.bt = r / g.W;
  const int w = static_cast<int>(r - p.bt * g.W);
  p.b = static_cast<int>(p.bt / g.TT);
  p.t = static_cast<int>(p.bt - static_cast<long long>(p.b) * g.TT);
  p.u = g.o != nullptr ? g.o[p.b * g.nblk + p.t / g.Tb] + w : w;
  return p;
}

// The kRT rows a block owns: the linear rows r0 .. r0+kRT (b < 0), or the
// patch of frames t0 .. t0+PT and positions w0 .. w0+PU of batch row b.
struct Tile {
  long long r0;
  int b, t0, w0;
};

// Global row of the tile's row `row`, or -1 outside the rows.
__device__ __forceinline__ long long tile_row(const Tile& tl, const Geo& g, int row) {
  if (tl.b < 0) {
    const long long r = tl.r0 + row;
    return r < g.R ? r : -1;
  }
  const int t = tl.t0 + row / g.PU, w = tl.w0 + row % g.PU;
  return (t < g.TT && w < g.W) ? (static_cast<long long>(tl.b) * g.TT + t) * g.W + w : -1;
}

__device__ __forceinline__ Tile linear_tile(long long r0) { return Tile{r0, -1, 0, 0}; }

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The offsets of the tile's rows in enc and pred, s_off[0][row] and
// s_off[1][row], -1 where the row reads 0 (a padded frame or position, or
// no row): computed once per row, so the per-element loads do no division.
__device__ void load_row_offsets(const Geo& g, const Tile& tl, long long (*s_off)[kRT]) {
  for (int row = threadIdx.x; row < kRT; row += kThreads) {
    const long long r = tile_row(tl, g, row);
    long long eo = -1, po = -1;
    if (r >= 0) {
      const RowPos p = row_pos(g, r);
      if (p.t < g.T) eo = (static_cast<long long>(p.b) * g.T + p.t) * g.J;
      if (p.u < g.U1) po = (static_cast<long long>(p.b) * g.U1 + p.u) * g.J;
    }
    s_off[0][row] = eo;
    s_off[1][row] = po;
  }
}

// tanh(enc_t + pred_u)_j of the tile's row `row` (0 past J and where the
// row reads 0)
__device__ __forceinline__ float joint_at(const float* __restrict__ enc,
                                          const float* __restrict__ pred, const Geo& g,
                                          long long (*s_off)[kRT], int row, int j) {
  if (j >= g.J) return 0.0f;
  const long long eo = s_off[0][row], po = s_off[1][row];
  return tanhf((eo >= 0 ? enc[eo + j] : 0.0f) + (po >= 0 ? pred[po + j] : 0.0f));
}

// The label of row position p, or -1 where it selects no column
__device__ __forceinline__ int row_label(const Geo& g, const int* __restrict__ labels,
                                         const RowPos& p) {
  if (p.u >= g.U) return -1;
  const int lab = labels[p.b * g.U + p.u];
  return (lab < 0 || lab >= g.V) ? -1 : lab;
}

// The bias of column v as the logits see it (bf16-rounded under bf16)
__device__ __forceinline__ float logit_bias(const float* __restrict__ bias, const Geo& g, int v,
                                            bool round) {
  if (v >= g.V) return 0.0f;
  return round ? rbf(bias[v]) : bias[v];
}

// The joint of the tile's rows into jT[j][row] (and jR[row][j] when given),
// through the row offsets s_off (filled here; valid until the next call).
template <int JP>
__device__ void load_joint(const float* __restrict__ enc, const float* __restrict__ pred,
                           const Geo& g, const Tile& tl, bool round, long long (*s_off)[kRT],
                           float* jT, float* jR) {
  load_row_offsets(g, tl, s_off);
  __syncthreads();
  for (int e = threadIdx.x; e < kRT * JP; e += kThreads) {
    const int row = e / JP;
    const int j = e % JP;
    float v = joint_at(enc, pred, g, s_off, row, j);
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

// Per-row scalars of the backward: g_b, g_e, label (-1 where it selects no
// column), lse; zeros outside the rows, so those rows give d_logits = 0.
__device__ void load_row_scalars(const Geo& g, const Tile& tl, const int* __restrict__ labels,
                                 const float* __restrict__ lse, const float* __restrict__ g_blank,
                                 const float* __restrict__ g_emit, float* s_gb, float* s_ge,
                                 int* s_lab, float* s_lse) {
  for (int row = threadIdx.x; row < kRT; row += kThreads) {
    const long long r = tile_row(tl, g, row);
    float gb = 0.0f, ge = 0.0f, ls = 0.0f;
    int lab = -1;
    if (r >= 0) {
      const RowPos p = row_pos(g, r);
      gb = g_blank[r];
      ls = lse[r];
      if (g.o != nullptr)
        ge = g_emit[r];                                   // K8: every row has an emit
      else if (p.u < g.U)
        ge = g_emit[p.bt * g.U + p.u];
      lab = row_label(g, labels, p);
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
// Forward
// ---------------------------------------------------------------------------
template <int JP>
__global__ void __launch_bounds__(kThreads)
joint_fwd_kernel(const float* __restrict__ enc, const float* __restrict__ pred,
                 const float* __restrict__ K, const float* __restrict__ bias,
                 const int* __restrict__ labels, Geo g, int blank_id, int bf,
                 float* __restrict__ blank_out, float* __restrict__ emit_out,
                 float* __restrict__ lse_out) {
  extern __shared__ float4 smem4[];
  float* jT = reinterpret_cast<float*>(smem4);  // [JP][kRP]
  float* kT = jT + JP * kRP;                     // [JP][kVT]
  float* s_blank = kT + JP * kVT;                // [kRT] blank logit
  float* s_emit = s_blank + kRT;                 // [kRT] emit logit
  __shared__ long long s_off[2][kRT];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRT;
  const bool round = bf != 0;

  load_joint<JP>(enc, pred, g, linear_tile(r0), false, s_off, jT, nullptr);
  __syncthreads();
  // emit logit from the f32 joint and the f32 column of K and bias at the label
  for (int row = tid; row < kRT; row += kThreads) {
    const long long r = r0 + row;
    float e = 0.0f;
    if (r < g.R) {
      const int lab = row_label(g, labels, row_pos(g, r));
      if (lab >= 0) {  // never read K outside its columns
        for (int j = 0; j < g.J; ++j)
          e = fmaf(jT[j * kRP + row], K[static_cast<size_t>(j) * g.V + lab], e);
        e += bias[lab];
      }
    }
    s_emit[row] = e;
  }
  if (round) {
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
    load_k<JP>(K, g, v0, round, kT, nullptr);
    __syncthreads();
    float acc[kRows][kCols];
    logits_tile<JP>(jT, kT, ty, tx, acc);
    float bv[kCols];
    bool ok[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int v = v0 + tx * kCols + c;
      ok[c] = v < g.V;
      bv[c] = logit_bias(bias, g, v, round);
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
      if (g.o != nullptr) {
        emit_out[r] = s_emit[row] - ls;
      } else {
        const RowPos p = row_pos(g, r);
        if (p.u < g.U) emit_out[p.bt * g.U + p.u] = s_emit[row] - ls;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, part 1: d_enc and d_pred, partial sums per (t, w) patch
// ---------------------------------------------------------------------------
// grid (ceil(W/PU), ceil(TT/PT), B); d_enc_part (B, TT, gridDim.x*PU/8, J),
// d_pred_part (B, gridDim.y, W, J)
template <int JP>
__global__ void __launch_bounds__(kThreads)
joint_bwd_rows_kernel(const float* __restrict__ enc, const float* __restrict__ pred,
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
  __shared__ long long s_off[2][kRT];
  const Tile tl{0, static_cast<int>(blockIdx.z), static_cast<int>(blockIdx.y) * g.PT,
                static_cast<int>(blockIdx.x) * g.PU};
  const bool round = bf != 0;

  load_joint<JP>(enc, pred, g, tl, round, s_off, jT, nullptr);
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
      const float bv = logit_bias(bias, g, v, round);
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
  // thread's 8 rows are 8 positions of frame t: their sum is its d_enc
  // partial for that group of 8.  d_joint goes to shared memory (over jT,
  // read for the last time above) for the sums over t.
  __syncthreads();
  float* dS = jT;                                 // [JP][kRP] d_joint
  const int t = tl.t0 + (ty * kRows) / g.PU;
  const int n_grp = gridDim.x * (g.PU / 8);
  const int grp = blockIdx.x * (g.PU / 8) + (ty * kRows % g.PU) / 8;
#pragma unroll
  for (int q = 0; q < kJ; ++q) {
    const int j = tx * kJ + q;
    float se = 0.0f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long r = tile_row(tl, g, ty * kRows + i);
      const float x = joint_at(enc, pred, g, s_off, ty * kRows + i, j);
      const float d = r >= 0 ? dj[i][q] * (1.0f - x * x) : 0.0f;
      dS[j * kRP + ty * kRows + i] = d;
      se += d;
    }
    if (t < g.TT && j < g.J)
      d_enc_part[((static_cast<size_t>(tl.b) * g.TT + t) * n_grp + grp) * g.J + j] = se;
  }
  __syncthreads();
  for (int e = tid; e < g.PU * JP; e += kThreads) {
    const int ww = e % g.PU, j = e / g.PU;
    const int w = tl.w0 + ww;
    if (w >= g.W || j >= g.J) continue;
    float sp = 0.0f;
    for (int tt = 0; tt < g.PT; ++tt) sp += dS[j * kRP + tt * g.PU + ww];
    d_pred_part[((static_cast<size_t>(tl.b) * gridDim.y + blockIdx.y) * g.W + w) * g.J + j] = sp;
  }
}

// ---------------------------------------------------------------------------
// Backward, part 2: d_K and d_bias, partial sums per row split
// ---------------------------------------------------------------------------
template <int JP>
__global__ void __launch_bounds__(kThreads)
joint_bwd_dk_kernel(const float* __restrict__ enc, const float* __restrict__ pred,
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
  __shared__ long long s_off[2][kRT];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int v0 = blockIdx.x * kVT;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const long long ntiles = (g.R + kRT - 1) / kRT;
  const bool round = bf != 0;

  load_k<JP>(K, g, v0, round, kT, nullptr);
  float bv[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) bv[c] = logit_bias(bias, g, v0 + tx * kCols + c, round);
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
    load_joint<JP>(enc, pred, g, linear_tile(r0), round, s_off, jT, jR);
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
  cudaError_t err = cudaFuncSetAttribute(joint_fwd_kernel<JP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (g.R + kRT - 1) / kRT;
  joint_fwd_kernel<JP><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      enc, pred, K, bias, labels, g, blank_id, bf, blank, emit, lse);
  return static_cast<int>(cudaGetLastError());
}

// The patch grid of the rows kernel: (ceil(W/PU), ceil(TT/PT), B)
dim3 patch_grid(const Geo& g) {
  return dim3((g.W + g.PU - 1) / g.PU, (g.TT + g.PT - 1) / g.PT, g.B);
}

template <int JP>
int launch_bwd(const float* enc, const float* pred, const float* K, const float* bias,
               const int* labels, const float* lse, const float* g_blank, const float* g_emit,
               const Geo& g, int blank_id, int bf, int nsplit, float* d_enc_part,
               float* d_pred_part, float* dk_part, float* db_part, cudaStream_t stream) {
  const size_t smem_rows = rows_smem(JP), smem_dk = dk_smem(JP);
  cudaError_t err = cudaFuncSetAttribute(joint_bwd_rows_kernel<JP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_rows));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(joint_bwd_dk_kernel<JP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dk));
  if (err != cudaSuccess) return static_cast<int>(err);
  joint_bwd_rows_kernel<JP><<<patch_grid(g), kThreads, smem_rows, stream>>>(
      enc, pred, K, bias, labels, lse, g_blank, g_emit, g, blank_id, bf, d_enc_part, d_pred_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.V + kVT - 1) / kVT, nsplit);
  joint_bwd_dk_kernel<JP><<<grid, kThreads, smem_dk, stream>>>(
      enc, pred, K, bias, labels, lse, g_blank, g_emit, g, blank_id, bf, dk_part, db_part);
  return static_cast<int>(cudaGetLastError());
}

Geo make_geo(int B, int T, int TT, int W, int U1, int J, int V, const int* o, int Tb, int PT) {
  Geo g;
  g.R = static_cast<long long>(B) * TT * W;
  g.B = B;
  g.T = T;
  g.TT = TT;
  g.W = W;
  g.U1 = U1;
  g.U = U1 - 1;
  g.J = J;
  g.V = V;
  g.o = o;
  g.Tb = Tb > 0 ? Tb : 1;
  g.nblk = (TT + g.Tb - 1) / g.Tb;
  g.PT = PT;
  g.PU = kRT / PT;
  return g;
}

}  // namespace
