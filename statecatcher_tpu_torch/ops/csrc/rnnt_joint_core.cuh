// The fused RNN-T joint -> (blank, emit) log-probs, shared by the exact joint
// (rnnt_joint.cu, K6) and the banded joint (rnnt_band.cu, K8): the kernels of
// the forward and of its backward, over a grid of lattice rows.
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
// Bound on the card: operations.  Per (row, v) the forward contracts 2J and
// the backward 6J (the logits once more, as they are not saved, d_joint and
// d_K), at the card's fastest rate for the inputs' accuracy: f32 as three
// TF32 products (165 TFLOP/s), bf16 at 989; ~5 (forward) and ~10 (backward)
// elementwise operations at the 67 TFLOP/s of f32 outside the tensor cores.
// At R = 2.5M rows (B=32, T=1598, U=48 exact, or U=128 at band 32), J=64,
// V=1024: forward 2.0 ms f32, 0.33 bf16; backward 6.0 ms f32, 1.0 bf16.
// The forward's one exp per (row, v) on the SFU (16 a clock per SM) takes
// ~0.6 ms there: under bf16 the exps, not the products, set its pace.
//
// Both directions take their products on the tensor cores through
// warp-level mma.sync, 3xTF32 for f32 inputs (x = hi + lo, each rounded to
// tf32; hi*hi + hi*lo + lo*hi in f32, ~2^-22 of each product dropped) and
// bf16 for bf16 inputs (the operands the contract rounds, exact products, f32
// sums: the same function, summed in another order).  The instance is chosen
// by J and dtype at compile time.  exp is ex2.approx of a prescaled argument.
// The tensor cores' f32 accumulator does not round to nearest, so no chain of
// products runs long: each 64-column tile (logits) or 64-row tile (d_K) is
// summed alone and added to the total in f32.
//   kprep (joint_kprep_kernel): K and the bias once per call in the operand
//         form that the forward and the backward's rows kernel stream
//         (KTile), so that none of their blocks converts them.
//
// Forward (joint_fwd_mma_kernel): a block of 8 warps owns 256 consecutive
// rows at J <= 64 (two m16 tiles per warp, which share each B fragment: half
// the L2 reads of K and of shared-memory loads per product) or 128 at
// J <= 128.  The joint (tanh once per element) goes to shared
// memory in f32; each warp loads its A fragments from it once (bf16 packed,
// or f32 split per k-step under 3xTF32) and keeps them in registers across
// all of V.  K's tiles stream through rings of 2-3 stages by 16-byte
// cp.async (under bf16 only the [v][j] half and the bias).  Per 64-column
// tile a thread's rows each hold 16 logits in the accumulator's layout: the
// tile max, the rescaled running sum and the exps stay in registers; each
// row's (max, sum) merges over its 4 lanes once, at the end.  At J <= 64 the
// block's two groups of 4 warps each stream K through a ring of their own
// and take turns on the tensor cores (named barriers), so that one group's
// exps run beside the other's products.  The per-element sequence of
// products is the rows kernel's (same KTile, same k order, the bias added
// after), so the backward recomputes the logits bit for bit against the
// saved lse.  The blank logit is picked in tile blank_id / 64.  The emit
// logit is the f32 dot of the joint with ke = K[:, label_u] (B, U, J),
// gathered by the wrapper (zero where a label selects no column), 8 lanes to
// a row on contiguous loads issued before the joint is formed.
//
// Backward (replacing a design of f32 FMA kernels, which took 66 ms at the
// shape above against a 15 ms FMA bound):
//   rows  (joint_bwd_rows_mma_kernel): a PT x PU patch of (t, w) of one batch
//         row (K6 16 x 8, K8 8 x 16), 8 warps of 16 rows.  Per 64-column
//         tile of K (double-buffered by 16-byte cp.async) a warp takes its
//         logits, turns the accumulator into d_logits in registers from the
//         saved per-row lse, and feeds it straight back as the A operand of
//         d_joint += d_logits . K_tile^T (the C fragment's layout is the A
//         fragment's: no shared-memory round trip).  tanh' uses the f32
//         joint; d_enc sums over the 8 positions of a frame by shuffles,
//         d_pred over the patch's frames through shared memory;
//   rowrec (joint_bwd_rowrec_kernel): each row's offsets, label, cotangents
//         and lse, in row order, so that the d_K kernel divides nothing and
//         can prefetch a tile's rows;
//   d_K   (joint_bwd_dk_mma_kernel): a block owns 128 columns of V, their K
//         slice resident in shared memory, and walks every nsplit-th tile of
//         64 rows, the next tile's row records in flight (cp.async): the
//         joint (tanh once per tile and slice: V/128 times in all, its loads
//         issued 16 at a time), the logits, d_logits staged in shared memory
//         in the operand type, then d_K (J x 128, in the warps' registers) +=
//         joint^T . d_logits (bf16 operands through ldmatrix).  nsplit is
//         sized from the kernel's occupancy, so that the grid is one wave on
//         every SM.  Partial sums go out per split and are added in a fixed
//         order: deterministic, no atomics, as the TPU kernels' sequential
//         grid accumulated in place.
// Both recompute the logits, a fourth contraction: a block cannot hold d_K for
// the whole vocabulary (J x V f32 is 256 KB at J=64, V=1024).  Only the
// per-row lse is saved by the forward; nothing joint-sized is kept.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma_frag.cuh"

namespace {

constexpr int kRT = 128;             // rows of a backward patch
constexpr int kVT = 64;              // vocab columns per tile
constexpr int kThreads = 256;        // 8 warps

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

// The kRT rows of a backward patch: frames t0 .. t0+PT and positions
// w0 .. w0+PU of batch row b.
struct Tile {
  int b, t0, w0;
};

// Global row of the tile's row `row`, or -1 outside the rows.
__device__ __forceinline__ long long tile_row(const Tile& tl, const Geo& g, int row) {
  const int t = tl.t0 + row / g.PU, w = tl.w0 + row % g.PU;
  return (t < g.TT && w < g.W) ? (static_cast<long long>(tl.b) * g.TT + t) * g.W + w : -1;
}

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16(x));
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

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d_logits of one element of logit l, from its row's c = -(g_b + g_e) and
// ls2 = lse * log2(e): c * 2^(l log2(e) - ls2), plus g_b at the blank and
// g_e at the label (in f32: the callers round it to bf16 where the contract
// asks)
__device__ __forceinline__ float dlogit(float l, float c, float ls2, float gb, float ge, int v,
                                        int blank_id, int lab) {
  return c * ex2(fmaf(l, kLog2e, -ls2)) + ((v == blank_id ? gb : 0.0f) + (v == lab ? ge : 0.0f));
}

// ---------------------------------------------------------------------------
// Tensor-core fragments (warp-level mma.sync)
// ---------------------------------------------------------------------------
// The fragments and their helpers are in mma_frag.cuh.

// bf16 acc[n] += A (16 x KD) . B (KD x 8*NT), on 16-bit tiles in shared
// memory through ldmatrix.  A's (m, k) is at A[m*sa + k] (A_KMAJOR: at
// A[k*sa + m]); B's (k, n) at B[n*sb + k] (B_KMAJOR: at B[k*sb + n]).  NT is
// even: a B load serves two n-tiles.
template <int KD, int NT, bool A_KMAJOR, bool B_KMAJOR>
__device__ __forceinline__ void warp_mma_ldsm(const __nv_bfloat16* A, int sa,
                                              const __nv_bfloat16* B, int sb, int lane,
                                              float acc[NT][4]) {
  const int r8 = lane & 7, hi8 = (lane >> 3) & 1, hi16 = lane >> 4;
#pragma unroll
  for (int k0 = 0; k0 < KD; k0 += 16) {
    uint32_t a[4];
    if (A_KMAJOR)
      ldsm_x4_trans(a, A + (k0 + r8 + 8 * hi16) * sa + 8 * hi8);
    else
      ldsm_x4(a, A + (r8 + 8 * hi8) * sa + k0 + 8 * hi16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      if (B_KMAJOR)
        ldsm_x4_trans(b, B + (k0 + r8 + 8 * hi8) * sb + 16 * np + 8 * hi16);
      else
        ldsm_x4(b, B + (16 * np + r8 + 8 * hi16) * sb + k0 + 8 * hi8);
      mma_bf16(acc[2 * np], a, b);
      mma_bf16(acc[2 * np + 1], a, b + 2);
    }
  }
}

// What the backward needs of row r: its offsets into enc and pred (-1: the
// row reads 0 there), its label (-1: no column), g_b, g_e and lse; a row r <
// 0 (outside the rows) has none of them, so it gives d_logits = 0.
struct RowRec {
  int eo, po, lab;
  float gb, ge, ls;
};

__device__ __forceinline__ RowRec row_record(const Geo& g, long long r,
                                             const int* __restrict__ labels,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ g_blank,
                                             const float* __restrict__ g_emit) {
  RowRec x{-1, -1, -1, 0.0f, 0.0f, 0.0f};
  if (r < 0) return x;
  const RowPos p = row_pos(g, r);
  if (p.t < g.T) x.eo = (p.b * g.T + p.t) * g.J;
  if (p.u < g.U1) x.po = (p.b * g.U1 + p.u) * g.J;
  x.gb = g_blank[r];
  x.ls = lse[r];
  if (g.o != nullptr)
    x.ge = g_emit[r];                                     // K8: every row has an emit
  else if (p.u < g.U)
    x.ge = g_emit[p.bt * g.U + p.u];
  x.lab = row_label(g, labels, p);
  return x;
}

// The row records of a tile of NR rows in shared memory, one array per field
template <int NR>
struct RowsS {
  int eo[NR], po[NR], lab[NR];
  float gb[NR], ge[NR], ls[NR];
};

template <int NR>
__device__ void load_rows(const Geo& g, const Tile& tl, const int* __restrict__ labels,
                          const float* __restrict__ lse, const float* __restrict__ g_blank,
                          const float* __restrict__ g_emit, RowsS<NR>& rs) {
  for (int row = threadIdx.x; row < NR; row += kThreads) {
    const RowRec x = row_record(g, tile_row(tl, g, row), labels, lse, g_blank, g_emit);
    rs.eo[row] = x.eo;
    rs.po[row] = x.po;
    rs.lab[row] = x.lab;
    rs.gb[row] = x.gb;
    rs.ge[row] = x.ge;
    rs.ls[row] = x.ls;
  }
}

// Operand type of the backward's shared tiles: f32 (split to 3xTF32 when a
// fragment is loaded) or bf16 (rounded once, when stored)
template <bool BF>
using Op = typename std::conditional<BF, __nv_bfloat16, float>::type;

template <typename T>
__device__ __forceinline__ T to_op(float x) {
  if constexpr (std::is_same<T, float>::value)
    return x;
  else
    return __float2bfloat16(x);
}

__device__ __forceinline__ float op_f(float x) { return x; }
__device__ __forceinline__ float op_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// jS[row*JS + j] = tanh(enc + pred) of the NR rows as operands of type T,
// from the rows' offsets (-1: reads 0), 0 past J.  A thread keeps one j and
// issues its loads QB rows at a time before any tanh, so their latencies
// overlap.
template <int NR, int JP, int JS, int QB = 16, typename T>
__device__ __forceinline__ void load_joint_rows(const float* __restrict__ enc,
                                                const float* __restrict__ pred, const Geo& g,
                                                const int* eo, const int* po, T* jS) {
  constexpr int kStride = kThreads / JP;          // rows per pass of the block
  constexpr int NQ = NR / kStride;                // rows per thread
  static_assert(NQ % QB == 0, "rows per thread");
  const int j = threadIdx.x % JP, row0 = threadIdx.x / JP;
  const bool jok = j < g.J;
#pragma unroll
  for (int q0 = 0; q0 < NQ; q0 += QB) {
    float x[QB];
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      const int row = row0 + (q0 + q) * kStride;
      const int e = eo[row], p = po[row];
      x[q] = (jok && e >= 0 ? enc[e + j] : 0.0f) + (jok && p >= 0 ? pred[p + j] : 0.0f);
    }
#pragma unroll
    for (int q = 0; q < QB; ++q) jS[(row0 + (q0 + q) * kStride) * JS + j] = to_op<T>(tanhf(x[q]));
  }
}

// tf32 A fragment, split, of the 16 x 8 tile whose element (m, k) is
// X[m*sm + k*sk] (m, k from the tile's corner X)
__device__ __forceinline__ void frag_a(const float* X, int sm, int sk, int gq, int tq,
                                       Split a[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    a[e] = split_tf32(X[(gq + 8 * (e & 1)) * sm + (tq + 4 * (e >> 1)) * sk]);
}
// bf16 A fragment of the 16 x 16 tile whose element (m, k) is X[m*sm + k], f32
__device__ __forceinline__ void frag_a(const float* X, int sm, int gq, int tq, uint32_t a[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* p = X + (gq + 8 * (r & 1)) * sm + 2 * tq + 8 * (r >> 1);
    a[r] = pack_bf16(p[0], p[1]);
  }
}
// tf32 B fragment, split, of the 8 x 8 tile whose element (k, n) is X[k*sk + n*sn]
__device__ __forceinline__ void frag_b(const float* X, int sk, int sn, int gq, int tq,
                                       Split b[2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) b[e] = split_tf32(X[(tq + 4 * e) * sk + gq * sn]);
}

// k-step of the instruction: 8 (tf32) or 16 (bf16)
template <bool BF>
constexpr int kStep = BF ? 16 : 8;

// acc[n][.] += A (16 x KD) . B (KD x 8*NT) in 3xTF32: A's (m, k) at
// A[m*sam + k*sak], B's (k, n) at B[k*sbk + n*sbn]
template <int KD, int NT>
__device__ __forceinline__ void warp_mma_3xtf32(const float* A, int sam, int sak, const float* B,
                                                int sbk, int sbn, int gq, int tq,
                                                float acc[NT][4]) {
#pragma unroll 2
  for (int k0 = 0; k0 < KD; k0 += 8) {
    Split a[4];
    frag_a(A + k0 * sak, sam, sak, gq, tq, a);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      Split b[2];
      frag_b(B + k0 * sbk + 8 * n * sbn, sbk, sbn, gq, tq, b);
      mma_3xtf32(acc[n], a, b);
    }
  }
}

// ---------------------------------------------------------------------------
// K's operand form, for the forward and the backward's rows kernel
// ---------------------------------------------------------------------------
// One 64-column tile of K in the operand form of the tensor cores, in 32-bit
// words: f32 as tf32 hi and lo, each [j][v]; bf16 as [v][j] (the logits' B)
// and [j][v] (d_joint's B); then the tile's bias as the logits see it (f32;
// bf16-rounded under bf16).  K changes every step, so joint_kprep_kernel
// writes the ceil(V/64) tiles once per call and every block of the forward
// and of the rows kernel copies them as they are.
template <int JP, bool BF>
struct KTile {
  static constexpr int KS = kVT + 8;              // f32: hi, lo [j][v]
  static constexpr int KVS = JP + 8;              // bf16: [v][j]
  static constexpr int KJS = kVT + 8;             // bf16: [j][v]
  static constexpr int OPS = BF ? (kVT * KVS + JP * KJS) / 2 : 2 * JP * KS;
  static constexpr int WORDS = OPS + kVT;         // a multiple of 4: 16-byte copies
};

template <int JP, bool BF>
__global__ void joint_kprep_kernel(const float* __restrict__ K, const float* __restrict__ bias,
                                   Geo g, uint32_t* __restrict__ kop) {
  using KT = KTile<JP, BF>;
  uint32_t* dst = kop + static_cast<size_t>(blockIdx.x) * KT::WORDS;
  const int v0 = blockIdx.x * kVT;
  for (int e = threadIdx.x; e < JP * kVT; e += blockDim.x) {
    const int j = e / kVT, vv = e % kVT, v = v0 + vv;
    const float x = (j < g.J && v < g.V) ? K[static_cast<size_t>(j) * g.V + v] : 0.0f;
    if constexpr (BF) {
      __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(dst);
      h[vv * KT::KVS + j] = __float2bfloat16(x);
      h[kVT * KT::KVS + j * KT::KJS + vv] = __float2bfloat16(x);
    } else {
      const Split sp = split_tf32(x);
      dst[j * KT::KS + vv] = sp.hi;
      dst[JP * KT::KS + j * KT::KS + vv] = sp.lo;
    }
  }
  for (int vv = threadIdx.x; vv < kVT; vv += blockDim.x)
    dst[KT::OPS + vv] = __float_as_uint(logit_bias(bias, g, v0 + vv, BF));
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------
// The forward's layout at J <= JP: MT m16 tiles of rows per warp (two at
// J <= 64, sharing each B fragment; one at J <= 128, where two would not fit
// shared memory beside the f32 stages), NR rows per block, the f32 joint
// [row][j] and NG rings of NS stages of the KTile words the logits read
// (f32: all of them; bf16: the [v][j] half), each followed by the tile's
// bias.  PP (J <= 64): two groups of 4 warps, each with its own ring,
// take turns on the tensor cores, so that one group's exps run beside the
// other's products (with one ring, the barrier of each tile lines all warps
// up: products, then exps).
template <int JP, bool BF>
struct FwdLayout {
  static constexpr int MT = JP == 64 ? 2 : 1;
  static constexpr int NR = 8 * 16 * MT;
  static constexpr int JS = JP + 4;
  static constexpr int KOPS = BF ? kVT * KTile<JP, BF>::KVS / 2 : KTile<JP, BF>::OPS;
  static constexpr int STAGE = KOPS + kVT;
  static constexpr bool PP = JP == 64;
  static constexpr int NG = PP ? 2 : 1;
  static constexpr int NS = (BF && !PP) ? 3 : 2;
  static constexpr size_t bytes() { return sizeof(float) * (NR * JS + NG * NS * STAGE); }
};

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The bias of a column past V: no logit (its exp is 0 against any real
// logit); finite, so that a lane whose columns all lie past V adds no NaN
constexpr float kNoLogit = -1e30f;

// grid ceil(R / NR): block x owns rows x*NR .. x*NR+NR.  ke (B, U, J) and be
// (B, U): the f32 column of K and the bias at each label, 0 where the label
// selects no column.
template <int JP, bool BF>
__global__ void __launch_bounds__(kThreads, (BF && JP == 64) ? 2 : 1)
joint_fwd_mma_kernel(const float* __restrict__ enc, const float* __restrict__ pred,
                     const uint32_t* __restrict__ kop, const float* __restrict__ ke,
                     const float* __restrict__ be, Geo g, int blank_id,
                     float* __restrict__ blank_out, float* __restrict__ emit_out,
                     float* __restrict__ lse_out) {
  using L = FwdLayout<JP, BF>;
  using KT = KTile<JP, BF>;
  using AR = typename std::conditional<BF, uint32_t, float>::type;
  constexpr int MT = L::MT, NR = L::NR, JS = L::JS, NS = L::NS, KS = KT::KS;
  constexpr int GT = kThreads / L::NG;            // threads of a ring's group
  constexpr int NV = kVT / 8;                     // n-tiles of a logits tile
  constexpr int NK = JP / kStep<BF>;              // k-steps
  extern __shared__ float4 smem4[];
  float* jS = reinterpret_cast<float*>(smem4);   // [NR][JS] f32 joint
  uint32_t* stage = reinterpret_cast<uint32_t*>(jS + NR * JS);  // [NG][NS][STAGE]
  __shared__ int s_eo[NR], s_po[NR], s_ko[NR];
  __shared__ float s_out[3][NR];                  // lse, blank, emit (the emit logit first)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int r8 = tid & 7, hi8 = (tid >> 3) & 1, hi16 = (tid >> 4) & 1;  // ldmatrix rows
  const long long r0 = static_cast<long long>(blockIdx.x) * NR;
  const int nvt = (g.V + kVT - 1) / kVT;
  const int gid = tid / GT, gtid = tid % GT;      // the thread's group and ring
  uint32_t* ring = stage + gid * NS * L::STAGE;

  auto issue_k = [&](int it) {                    // the words the logits read, and the bias
    uint32_t* dst = ring + (it % NS) * L::STAGE;
    const uint32_t* src = kop + static_cast<size_t>(it) * KT::WORDS;
    for (int e = gtid; e < L::STAGE / 4; e += GT) {
      const int w = 4 * e;
      cp_async16(dst + w, src + (w < L::KOPS ? w : KT::OPS + (w - L::KOPS)));
    }
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nvt) issue_k(s);
    cp_async_commit();
  }

  // each row's offsets into enc, pred (-1: reads 0) and its ke row (-1: none)
  for (int row = tid; row < NR; row += kThreads) {
    const long long r = r0 + row;
    int eo = -1, po = -1, ko = -1;
    if (r < g.R) {
      const RowPos p = row_pos(g, r);
      if (p.t < g.T) eo = (p.b * g.T + p.t) * g.J;
      if (p.u < g.U1) po = (p.b * g.U1 + p.u) * g.J;
      if (p.u < g.U) ko = p.b * g.U + p.u;
    }
    s_eo[row] = eo;
    s_po[row] = po;
    s_ko[row] = ko;
  }
  __syncthreads();
  // the emit logit: the f32 joint . ke + be, 8 lanes to a row (row warp*4 +
  // grp + 32q), each lane every 8th j; its ke values are loaded before the
  // joint is formed, so that their latency overlaps the joint's loads.  The
  // joint's loads go out all at once under f32 (one block per SM, nothing
  // else to hide them: on the H100 0.1-0.2 ms of 5.1 at phase 8's shape),
  // 16 rows at a time under bf16 (two blocks per SM, 128 registers).  be is
  // read after the joint: loaded beside ke, it took registers that the f32
  // loads need, and the gain was lost.
  constexpr int NQ = NR / 32, NJ8 = JP / 8, QB = BF ? 16 : NR * JP / kThreads;
  const int grp = lane >> 3, l8 = lane & 7;
  float kv[NQ][NJ8];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int ko = s_ko[warp * 4 + grp + 32 * q];
#pragma unroll
    for (int i = 0; i < NJ8; ++i) {
      const int j = l8 + 8 * i;
      kv[q][i] = (ko >= 0 && j < g.J) ? ke[static_cast<size_t>(ko) * g.J + j] : 0.0f;
    }
  }
  load_joint_rows<NR, JP, JS, QB>(enc, pred, g, s_eo, s_po, jS);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int row = warp * 4 + grp + 32 * q, ko = s_ko[row];
    float e = 0.0f;
#pragma unroll
    for (int i = 0; i < NJ8; ++i) e = fmaf(jS[row * JS + l8 + 8 * i], kv[q][i], e);
    e += __shfl_xor_sync(0xffffffffu, e, 4);
    e += __shfl_xor_sync(0xffffffffu, e, 2);
    e += __shfl_xor_sync(0xffffffffu, e, 1);
    if (l8 == 0) s_out[2][row] = ko >= 0 ? e + be[ko] : 0.0f;
  }

  // the warp's A fragments, kept in registers across V: bf16 packed, or the
  // f32 values that each k-step splits (into the rows kernel's frag_a bits)
  const int wrow = warp * 16 * MT;
  AR ar[MT][NK][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      const float* X = jS + (wrow + 16 * mt) * JS + ks * kStep<BF>;
      if constexpr (BF) {
        frag_a(X, JS, gq, tq, ar[mt][ks]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) ar[mt][ks][e] = X[(gq + 8 * (e & 1)) * JS + tq + 4 * (e >> 1)];
      }
    }

  // the thread's rows: gq and gq + 8 of each of its m-tiles; running max and
  // sum of 2^((l - m) log2(e)) over its columns
  float m[MT][2], s[MT][2], bl[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = kNoLogit;
      s[mt][h] = 0.0f;
      bl[mt][h] = 0.0f;
    }
  const int blank_tile = blank_id / kVT, blank_col = blank_id % kVT;
  __syncthreads();                                // the emit logits are in s_out[2]

  for (int it = 0; it < nvt; ++it) {
    cp_async_wait<NS - 2>();
    if constexpr (L::PP)                          // tile it has landed; tile it-1 is done
      bar_sync(1 + gid, GT);
    else
      __syncthreads();
    if (it + NS - 1 < nvt) issue_k(it + NS - 1);  // into the stage tile it-1 used
    cp_async_commit();
    const uint32_t* kt = ring + (it % NS) * L::STAGE;
    const uint32_t* kHi = kt;                                   // f32
    const uint32_t* kLo = kt + JP * KS;
    const __nv_bfloat16* kV = reinterpret_cast<const __nv_bfloat16*>(kt);  // bf16
    const float* sb = reinterpret_cast<const float*>(kt + L::KOPS);
    float acc[MT][NV][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.0f;
    // logits (16 rows x 64) = joint (16 x JP) . K_tile (JP x 64), per
    // element the rows kernel's sequence of products.  PP: group 0 takes
    // the tensor cores for tile it after group 1 has had them for tile
    // it-1 (barrier 3), group 1 after group 0 for tile it (barrier 4)
    if constexpr (L::PP)
      if (gid == 1 || it > 0) bar_sync(3 + gid, kThreads);
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      const int k0 = ks * kStep<BF>;
      if constexpr (BF) {
#pragma unroll
        for (int np = 0; np < NV / 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, kV + (16 * np + r8 + 8 * hi16) * KT::KVS + k0 + 8 * hi8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * np], ar[mt][ks], b);
            mma_bf16(acc[mt][2 * np + 1], ar[mt][ks], b + 2);
          }
        }
      } else {
        Split a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[mt][e] = split_tf32(ar[mt][ks][e]);
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int o = (k0 + tq) * KS + 8 * n + gq;
          const Split b[2] = {{kHi[o], kLo[o]}, {kHi[o + 4 * KS], kLo[o + 4 * KS]}};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_3xtf32(acc[mt][n], a[mt], b);
        }
      }
    }
    if constexpr (L::PP) {                        // the products done, hand over
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NV; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) asm volatile("" ::"f"(acc[mt][n][e]));
      bar_arrive(4 - gid, kThreads);
    }
    // + bias; columns past V (in the last tile only) take no logit
    const int v0 = it * kVT;
    float bv[NV][2];
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const float2 x = *reinterpret_cast<const float2*>(sb + 8 * n + 2 * tq);
      bv[n][0] = x.x;
      bv[n][1] = x.y;
    }
    if (v0 + kVT > g.V) {
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (v0 + 8 * n + 2 * tq + c >= g.V) bv[n][c] = kNoLogit;
    }
    // online log-sum-exp of each of the thread's rows over its 16 columns
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tmax = kNoLogit;
#pragma unroll
        for (int n = 0; n < NV; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            acc[mt][n][2 * h + c] += bv[n][c];
            tmax = fmaxf(tmax, acc[mt][n][2 * h + c]);
          }
        if (it == blank_tile) {
#pragma unroll
          for (int n = 0; n < NV; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (8 * n + 2 * tq + c == blank_col) bl[mt][h] = acc[mt][n][2 * h + c];
        }
        const float mn = fmaxf(m[mt][h], tmax), m2 = mn * kLog2e;
        float add = 0.0f;
#pragma unroll
        for (int n = 0; n < NV; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) add += ex2(fmaf(acc[mt][n][2 * h + c], kLog2e, -m2));
        s[mt][h] = fmaf(s[mt][h], ex2(fmaf(m[mt][h], kLog2e, -m2)), add);
        m[mt][h] = mn;
      }
  }
  cp_async_wait<0>();
  if constexpr (L::PP)
    if (gid == 0) bar_sync(3, kThreads);          // group 1's last hand-over

  // merge each row's (max, sum) over its 4 lanes; lane tq = 0 writes
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[mt][h], off);
        const float so = __shfl_xor_sync(0xffffffffu, s[mt][h], off);
        const float mn = fmaxf(m[mt][h], mo), m2 = mn * kLog2e;
        s[mt][h] = s[mt][h] * ex2(fmaf(m[mt][h], kLog2e, -m2)) + so * ex2(fmaf(mo, kLog2e, -m2));
        m[mt][h] = mn;
      }
      const float blank = __shfl_sync(0xffffffffu, bl[mt][h], (lane & ~3) | ((blank_col & 7) >> 1));
      if (tq == 0) {
        const int row = wrow + 16 * mt + gq + 8 * h;
        const float ls = m[mt][h] + logf(s[mt][h]);
        s_out[0][row] = ls;
        s_out[1][row] = blank - ls;
        s_out[2][row] -= ls;
      }
    }
  __syncthreads();
  for (int row = tid; row < NR; row += kThreads) {
    const long long r = r0 + row;
    if (r >= g.R) break;
    lse_out[r] = s_out[0][row];
    blank_out[r] = s_out[1][row];
    if (g.o != nullptr) {
      emit_out[r] = s_out[2][row];                // K8: every row
    } else {
      const RowPos p = row_pos(g, r);
      if (p.u < g.U) emit_out[p.bt * g.U + p.u] = s_out[2][row];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, part 1: d_enc and d_pred, partial sums per (t, w) patch
// ---------------------------------------------------------------------------

// grid (ceil(W/PU), ceil(TT/PT), B); d_enc_part (B, TT, gridDim.x*PU/8, J),
// d_pred_part (B, gridDim.y, W, J).  Warp w owns the patch's rows 16w ..
// 16w+15.  Per 64-column tile of K in the operand form (KTile; double-
// buffered by cp.async) a warp takes its logits on the tensor cores, turns the
// accumulator into d_logits in registers and feeds it straight back as the A
// operand of d_joint += d_logits . K_tile^T.
template <int JP, bool BF>
size_t rows_smem() {
  return sizeof(float) * kRT * (JP + 4) + sizeof(uint32_t) * 2 * KTile<JP, BF>::WORDS;
}

template <int JP, bool BF>
__global__ void __launch_bounds__(kThreads, JP == 64 ? 2 : 1)
joint_bwd_rows_mma_kernel(const float* __restrict__ enc, const float* __restrict__ pred,
                          const uint32_t* __restrict__ kop, const int* __restrict__ labels,
                          const float* __restrict__ lse, const float* __restrict__ g_blank,
                          const float* __restrict__ g_emit, Geo g, int blank_id,
                          float* __restrict__ d_enc_part, float* __restrict__ d_pred_part) {
  using KT = KTile<JP, BF>;
  constexpr int JS = JP + 4, KS = KT::KS;         // f32 joint [row][j]; f32 K tile stride
  constexpr int NJ = JP / 8;                      // n-tiles of d_joint
  constexpr int NV = kVT / 8;                     // n-tiles of a logits tile
  extern __shared__ float4 smem4[];
  float* jS = reinterpret_cast<float*>(smem4);   // [kRT][JS] f32 joint, then d_joint
  uint32_t* stage = reinterpret_cast<uint32_t*>(jS + kRT * JS);  // [2][KT::WORDS]
  __shared__ RowsS<kRT> rs;
  const int tid = threadIdx.x, warp = tid >> 5, gq = (tid & 31) >> 2, tq = tid & 3;
  const int r8 = tid & 7, hi8 = (tid >> 3) & 1, hi16 = (tid >> 4) & 1;  // ldmatrix rows
  const Tile tl{static_cast<int>(blockIdx.z), static_cast<int>(blockIdx.y) * g.PT,
                static_cast<int>(blockIdx.x) * g.PU};
  const int nvt = (g.V + kVT - 1) / kVT;

  auto issue_k = [&](int it) {
    uint32_t* dst = stage + (it & 1) * KT::WORDS;
    const uint32_t* src = kop + static_cast<size_t>(it) * KT::WORDS;
    for (int e = tid; e < KT::WORDS / 4; e += kThreads) cp_async16(dst + 4 * e, src + 4 * e);
    cp_async_commit();
  };
  issue_k(0);
  load_rows<kRT>(g, tl, labels, lse, g_blank, g_emit, rs);
  __syncthreads();
  load_joint_rows<kRT, JP, JS>(enc, pred, g, rs.eo, rs.po, jS);
  // the thread's two rows of the warp's 16: gq and gq + 8
  float gb[2], ge[2], c[2], ls2[2];
  int lab[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = warp * 16 + gq + 8 * h;
    gb[h] = rs.gb[row];
    ge[h] = rs.ge[row];
    c[h] = -(gb[h] + ge[h]);
    ls2[h] = rs.ls[row] * kLog2e;
    lab[h] = rs.lab[row];
  }

  float dj[NJ][4];
#pragma unroll
  for (int n = 0; n < NJ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dj[n][e] = 0.0f;

  for (int it = 0; it < nvt; ++it) {
    if (it + 1 < nvt) {
      issue_k(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                              // tile it has landed; tile it-1 is done
    const uint32_t* kt = stage + (it & 1) * KT::WORDS;
    const uint32_t* kHi = kt;                                   // f32
    const uint32_t* kLo = kt + JP * KS;
    const __nv_bfloat16* kV = reinterpret_cast<const __nv_bfloat16*>(kt);  // bf16
    const __nv_bfloat16* kJ = kV + kVT * KT::KVS;
    const float* sb = reinterpret_cast<const float*>(kt + KT::OPS);
    const int v0 = it * kVT;
    float acc[NV][4];
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    // logits (16 rows x 64) = joint (16 x JP) . K_tile (JP x 64)
    const float* ja = jS + warp * 16 * JS;
#pragma unroll 2
    for (int k0 = 0; k0 < JP; k0 += kStep<BF>) {
      if constexpr (BF) {
        uint32_t a[4];
        frag_a(ja + k0, JS, gq, tq, a);
#pragma unroll
        for (int np = 0; np < NV / 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, kV + (16 * np + r8 + 8 * hi16) * KT::KVS + k0 + 8 * hi8);
          mma_bf16(acc[2 * np], a, b);
          mma_bf16(acc[2 * np + 1], a, b + 2);
        }
      } else {
        Split a[4];
        frag_a(ja + k0, JS, 1, gq, tq, a);
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int o = (k0 + tq) * KS + 8 * n + gq;
          const Split b[2] = {{kHi[o], kLo[o]}, {kHi[o + 4 * KS], kLo[o + 4 * KS]}};
          mma_3xtf32(acc[n], a, b);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, col = 8 * n + 2 * tq + (e & 1), v = v0 + col;
        // (under bf16 the A fragment's pack below rounds d_logits to bf16)
        acc[n][e] = v < g.V ? dlogit(acc[n][e] + sb[col], c[h], ls2[h], gb[h], ge[h], v,
                                     blank_id, lab[h])
                            : 0.0f;
      }
    // d_joint += d_logits . K_tile^T: B's (k = v, n = j) is K_tile[j][v],
    // the tile's sum taken alone
    float djt[NJ][4];
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) djt[n][e] = 0.0f;
    if constexpr (BF) {
#pragma unroll
      for (int kk = 0; kk < NV / 2; ++kk) {
        const uint32_t a[4] = {pack_bf16(acc[2 * kk][0], acc[2 * kk][1]),
                               pack_bf16(acc[2 * kk][2], acc[2 * kk][3]),
                               pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]),
                               pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < NJ / 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, kJ + (16 * np + r8 + 8 * hi16) * KT::KJS + 16 * kk + 8 * hi8);
          mma_bf16(djt[2 * np], a, b);
          mma_bf16(djt[2 * np + 1], a, b + 2);
        }
      }
    } else {
      // the accumulator's columns 2tq, 2tq+1 serve as the A fragment's k =
      // tq, tq+4, and B's k follows them: the sum over v is unchanged
#pragma unroll
      for (int kk = 0; kk < NV; ++kk) {
        const Split a[4] = {split_tf32(acc[kk][0]), split_tf32(acc[kk][2]),
                            split_tf32(acc[kk][1]), split_tf32(acc[kk][3])};
#pragma unroll
        for (int n = 0; n < NJ; ++n) {
          const int o = (8 * n + gq) * KS + 8 * kk + 2 * tq;
          const uint2 hi = *reinterpret_cast<const uint2*>(kHi + o);
          const uint2 lo = *reinterpret_cast<const uint2*>(kLo + o);
          const Split b[2] = {{hi.x, lo.x}, {hi.y, lo.y}};
          mma_3xtf32(djt[n], a, b);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dj[n][e] += djt[n][e];
    __syncthreads();                              // the next issue overwrites this stage
  }

  // d_joint *= tanh'(f32 joint), 0 outside the rows; each element is read and
  // overwritten in jS by the one thread that holds it.  Rows gq of a warp
  // half (8 positions of one frame) sum to its d_enc partial.
  const int n_grp = gridDim.x * (g.PU / 8);
#pragma unroll
  for (int n = 0; n < NJ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = warp * 16 + gq + 8 * (e >> 1), j = 8 * n + 2 * tq + (e & 1);
      const float x = jS[row * JS + j];
      const float d = tile_row(tl, g, row) >= 0 ? dj[n][e] * (1.0f - x * x) : 0.0f;
      jS[row * JS + j] = d;
      dj[n][e] = d;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row0 = warp * 16 + 8 * h;
    const int t = tl.t0 + row0 / g.PU;
    const int grp = blockIdx.x * (g.PU / 8) + (row0 % g.PU) / 8;
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float s = dj[n][2 * h + c];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        const int j = 8 * n + 2 * tq + c;
        if (gq == 0 && t < g.TT && j < g.J)
          d_enc_part[((static_cast<size_t>(tl.b) * g.TT + t) * n_grp + grp) * g.J + j] = s;
      }
  }
  __syncthreads();
  for (int e = tid; e < g.PU * JP; e += kThreads) {
    const int ww = e % g.PU, j = e / g.PU;
    const int w = tl.w0 + ww;
    if (w >= g.W || j >= g.J) continue;
    float sp = 0.0f;
    for (int tt = 0; tt < g.PT; ++tt) sp += jS[(tt * g.PU + ww) * JS + j];
    d_pred_part[((static_cast<size_t>(tl.b) * gridDim.y + blockIdx.y) * g.W + w) * g.J + j] = sp;
  }
}

// ---------------------------------------------------------------------------
// Backward, part 2: d_K and d_bias, partial sums per row split
// ---------------------------------------------------------------------------
// The row records (RowRec) of every row in linear order, for the d_K kernel:
// six int32 planes of Rp = ceil(R/kDR)*kDR rows (eo, po, lab, gb, ge, lse;
// the floats bit for bit), rows r >= R with none.
constexpr int kDR = 64;                           // rows per d_K tile
constexpr int kVS = 128;                          // vocab columns per d_K block

__global__ void joint_bwd_rowrec_kernel(const int* __restrict__ labels,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ g_blank,
                                        const float* __restrict__ g_emit, Geo g, long long Rp,
                                        int* __restrict__ rec) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= Rp) return;
  const RowRec x = row_record(g, r < g.R ? r : -1, labels, lse, g_blank, g_emit);
  rec[r] = x.eo;
  rec[Rp + r] = x.po;
  rec[2 * Rp + r] = x.lab;
  rec[3 * Rp + r] = __float_as_int(x.gb);
  rec[4 * Rp + r] = __float_as_int(x.ge);
  rec[5 * Rp + r] = __float_as_int(x.ls);
}

// grid (ceil(V/kVS), nsplit): block (x, s) owns columns x*kVS .. +kVS, their
// K slice resident in shared memory, and walks row tiles s, s + nsplit, ...
// of kDR rows, the next tile's row records in flight (cp.async) while it
// works on this one.  Per tile: the joint (tanh once per tile and V slice) in
// the operand type; the logits on the tensor cores (warps as 4 row groups x
// 2 column halves); d_logits staged in the operand type; then d_K (J x kVS,
// spread over the warps' registers) += joint^T . d_logits.
template <int JP, bool BF>
struct DkLayout {
  static constexpr int JS = JP + (BF ? 8 : 4);    // joint [row][j]
  static constexpr int KS = BF ? JP + 8 : kVS + 8; // K slice: bf16 [v][j], f32 [j][v]
  static constexpr int DS = kVS + 8;              // d_logits [row][v]
  static constexpr int K_ELEMS = BF ? kVS * KS : JP * KS;
  static constexpr size_t bytes() {
    return sizeof(Op<BF>) * (K_ELEMS + kDR * JS + kDR * DS);
  }
};

template <int JP, bool BF>
__global__ void __launch_bounds__(kThreads, JP == 64 ? 2 : 1)
joint_bwd_dk_mma_kernel(const float* __restrict__ enc, const float* __restrict__ pred,
                        const float* __restrict__ K, const float* __restrict__ bias,
                        const int* __restrict__ rec, long long Rp, Geo g, int blank_id,
                        float* __restrict__ dk_part, float* __restrict__ db_part) {
  using L = DkLayout<JP, BF>;
  using T = Op<BF>;
  constexpr int MT = JP / 16;                     // m-tiles of d_K (16 j each)
  constexpr int WPM = 8 / MT;                     // warps per m-tile
  constexpr int NTW = kVS / 8 / WPM;              // n-tiles of d_K per warp
  extern __shared__ float4 smem4[];
  T* kS = reinterpret_cast<T*>(smem4);
  T* jS = kS + L::K_ELEMS;
  T* dS = jS + kDR * L::JS;
  __shared__ __align__(16) int recS[2][6][kDR];   // row records of this tile and the next
  __shared__ float sb[kVS];                       // the bias as the logits see it
  __shared__ float red[4][kVS];
  const int tid = threadIdx.x, warp = tid >> 5, gq = (tid & 31) >> 2, tq = tid & 3;
  const int rg = warp & 3, ch = warp >> 2;        // logits: row group, column half
  const int mt = warp / WPM, nb = (warp % WPM) * NTW;  // d_K: m-tile, first n-tile
  const int v0 = blockIdx.x * kVS;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const long long ntiles = Rp / kDR;

  auto issue_rec = [&](long long tile, int buf) {  // 6 planes x kDR ints, 16 bytes a thread
    if (tid < 6 * kDR / 4) {
      const int plane = tid / (kDR / 4), part = tid % (kDR / 4);
      cp_async16(&recS[buf][plane][4 * part], rec + plane * Rp + tile * kDR + 4 * part);
    }
    cp_async_commit();
  };
  if (split < ntiles) issue_rec(split, 0);
  for (int e = tid; e < JP * kVS; e += kThreads) {
    const int j = e / kVS, vv = e % kVS, v = v0 + vv;
    const float x = (j < g.J && v < g.V) ? K[static_cast<size_t>(j) * g.V + v] : 0.0f;
    kS[BF ? vv * L::KS + j : j * L::KS + vv] = to_op<T>(x);
  }
  if (tid < kVS) sb[tid] = logit_bias(bias, g, v0 + tid, BF);
  float cs[8][2];
#pragma unroll
  for (int n = 0; n < 8; ++n) cs[n][0] = cs[n][1] = 0.0f;
  float dk[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = 0.0f;

  int it = 0;
  for (long long tile = split; tile < ntiles; tile += nsplit, ++it) {
    const int cur = it & 1;
    if (tile + nsplit < ntiles) {
      issue_rec(tile + nsplit, cur ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                              // records landed; the last tile is done
    const int* rc = &recS[cur][0][0];
    load_joint_rows<kDR, JP, L::JS>(enc, pred, g, rc, rc + kDR, jS);
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    if constexpr (BF)
      warp_mma_ldsm<JP, 8, false, false>(jS + rg * 16 * L::JS, L::JS, kS + 64 * ch * L::KS,
                                         L::KS, tid & 31, acc);
    else
      warp_mma_3xtf32<JP, 8>(jS + rg * 16 * L::JS, L::JS, 1, kS + 64 * ch, L::KS, 1, gq, tq, acc);
    const int* rlab = rc + 2 * kDR;
    const float* rgb = reinterpret_cast<const float*>(rc + 3 * kDR);
    const float* rge = rgb + kDR;
    const float* rls = rge + kDR;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rg * 16 + gq + 8 * (e >> 1);
        const int col = 64 * ch + 8 * n + 2 * tq + (e & 1), v = v0 + col;
        const float gb = rgb[row], ge = rge[row];
        const T d = to_op<T>(v < g.V ? dlogit(acc[n][e] + sb[col], -(gb + ge),
                                              rls[row] * kLog2e, gb, ge, v, blank_id, rlab[row])
                                     : 0.0f);             // rounded once, under bf16
        cs[n][e & 1] += op_f(d);
        dS[row * L::DS + col] = d;
      }
    __syncthreads();
    // d_K (m = j, n = v) += sum over the tile's rows (k) of joint[k][m] . dS[k][n],
    // the tile's sum taken alone: one chain over a split's ~10^5 rows
    // drifted by 4.8e-4 of d_K's scale at 2.5M rows
    float dkt[NTW][4];
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dkt[n][e] = 0.0f;
    if constexpr (BF)
      warp_mma_ldsm<kDR, NTW, true, true>(jS + 16 * mt, L::JS, dS + 8 * nb, L::DS, tid & 31, dkt);
    else
      warp_mma_3xtf32<kDR, NTW>(jS + 16 * mt, 1, L::JS, dS + 8 * nb, L::DS, 1, gq, tq, dkt);
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] += dkt[n][e];
  }

  // d_bias: the column sums over the 8 rows of each lane group, then over the
  // 4 row groups, in a fixed order
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float s = cs[n][c];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (gq == 0) red[rg][64 * ch + 8 * n + 2 * tq + c] = s;
    }
  __syncthreads();
  if (tid < kVS && v0 + tid < g.V)
    db_part[static_cast<size_t>(split) * g.V + v0 + tid] =
        ((red[0][tid] + red[1][tid]) + red[2][tid]) + red[3][tid];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 16 * mt + gq + 8 * (e >> 1), v = v0 + 8 * (nb + n) + 2 * tq + (e & 1);
      if (j < g.J && v < g.V) dk_part[(static_cast<size_t>(split) * g.J + j) * g.V + v] = dk[n][e];
    }
}

// The kernels' offsets into enc, pred and ke are int32
bool offsets_fit(const Geo& g) {
  return static_cast<long long>(g.B) * g.T * g.J <= INT32_MAX &&
         static_cast<long long>(g.B) * g.U1 * g.J <= INT32_MAX;
}

template <int JP, bool BF>
int launch_fwd_mma(const float* enc, const float* pred, const float* K, const float* bias,
                   const float* ke, const float* be, const Geo& g, int blank_id, uint32_t* kop,
                   float* blank, float* emit, float* lse, cudaStream_t stream) {
  using L = FwdLayout<JP, BF>;
  cudaError_t e = cudaFuncSetAttribute(joint_fwd_mma_kernel<JP, BF>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::bytes()));
  if (e != cudaSuccess) return static_cast<int>(e);
  joint_kprep_kernel<JP, BF><<<(g.V + kVT - 1) / kVT, kThreads, 0, stream>>>(K, bias, g, kop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (g.R + L::NR - 1) / L::NR;
  joint_fwd_mma_kernel<JP, BF><<<static_cast<unsigned>(blocks), kThreads, L::bytes(), stream>>>(
      enc, pred, kop, ke, be, g, blank_id, blank, emit, lse);
  return static_cast<int>(cudaGetLastError());
}

// The forward's kernels at J <= 64 or J <= 128, f32 (bf = 0) or bf16.  ke
// (B, U, J) and be (B, U) from the wrapper: K's f32 column and the bias at
// each label (0 where it selects no column); kop, joint_sizes' out[1] words
// of scratch (K's operand form).
int launch_fwd(const float* enc, const float* pred, const float* K, const float* bias,
               const float* ke, const float* be, const Geo& g, int blank_id, int bf, void* kop,
               float* blank, float* emit, float* lse, cudaStream_t stream) {
  if (!offsets_fit(g)) return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* kw = static_cast<uint32_t*>(kop);
#define SC_FWD(JP, BF) \
  launch_fwd_mma<JP, BF>(enc, pred, K, bias, ke, be, g, blank_id, kw, blank, emit, lse, stream)
  if (g.J <= 64) return bf ? SC_FWD(64, true) : SC_FWD(64, false);
  if (g.J <= 128) return bf ? SC_FWD(128, true) : SC_FWD(128, false);
#undef SC_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// The patch grid of the rows kernel: (ceil(W/PU), ceil(TT/PT), B)
dim3 patch_grid(const Geo& g) {
  return dim3((g.W + g.PU - 1) / g.PU, (g.TT + g.PT - 1) / g.PT, g.B);
}

template <int JP, bool BF>
int set_bwd_smem() {
  cudaError_t err = cudaFuncSetAttribute(joint_bwd_rows_mma_kernel<JP, BF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(rows_smem<JP, BF>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(joint_bwd_dk_mma_kernel<JP, BF>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(DkLayout<JP, BF>::bytes())));
}

// The sizes the wrappers allocate and launch by: out[0] = blocks of the d_K
// kernel resident on one SM (its grid is sized from it), out[1] = 32-bit
// words of K's operand form (KTile), for both directions.  Returns a
// cudaError_t.
template <int JP, bool BF>
int joint_sizes(int V, int* out) {
  const int err = set_bwd_smem<JP, BF>();
  if (err != 0) return err;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], joint_bwd_dk_mma_kernel<JP, BF>, kThreads, DkLayout<JP, BF>::bytes());
  out[1] = (V + kVT - 1) / kVT * KTile<JP, BF>::WORDS;
  return static_cast<int>(e);
}

int joint_sizes(int J, int V, int bf, int* out) {
  if (J <= 64) return bf ? joint_sizes<64, true>(V, out) : joint_sizes<64, false>(V, out);
  if (J <= 128) return bf ? joint_sizes<128, true>(V, out) : joint_sizes<128, false>(V, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int JP, bool BF>
int launch_bwd_mma(const float* enc, const float* pred, const float* K, const float* bias,
                   const int* labels, const float* lse, const float* g_blank,
                   const float* g_emit, const Geo& g, int blank_id, int nsplit, int* rec,
                   uint32_t* kop, float* d_enc_part, float* d_pred_part, float* dk_part,
                   float* db_part, cudaStream_t stream) {
  const int err = set_bwd_smem<JP, BF>();
  if (err != 0) return err;
  joint_kprep_kernel<JP, BF><<<(g.V + kVT - 1) / kVT, kThreads, 0, stream>>>(K, bias, g, kop);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  joint_bwd_rows_mma_kernel<JP, BF><<<patch_grid(g), kThreads, rows_smem<JP, BF>(), stream>>>(
      enc, pred, kop, labels, lse, g_blank, g_emit, g, blank_id, d_enc_part, d_pred_part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long Rp = (g.R + kDR - 1) / kDR * kDR;
  joint_bwd_rowrec_kernel<<<static_cast<unsigned>((Rp + 255) / 256), 256, 0, stream>>>(
      labels, lse, g_blank, g_emit, g, Rp, rec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((g.V + kVS - 1) / kVS, nsplit);
  joint_bwd_dk_mma_kernel<JP, BF><<<grid, kThreads, DkLayout<JP, BF>::bytes(), stream>>>(
      enc, pred, K, bias, rec, Rp, g, blank_id, dk_part, db_part);
  return static_cast<int>(cudaGetLastError());
}

// The backward's kernels at J <= 64 or J <= 128, f32 (bf = 0) or bf16.
// Scratch from the wrapper: rec, 6 * ceil(R/64)*64 ints (the row records),
// and kop, joint_sizes' out[1] words (K's operand form).  The offsets into enc
// and pred are int32.
int launch_bwd(const float* enc, const float* pred, const float* K, const float* bias,
               const int* labels, const float* lse, const float* g_blank, const float* g_emit,
               const Geo& g, int blank_id, int bf, int nsplit, int* rec, void* kop,
               float* d_enc_part, float* d_pred_part, float* dk_part, float* db_part,
               cudaStream_t stream) {
  if (!offsets_fit(g)) return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* kw = static_cast<uint32_t*>(kop);
#define SC_BWD(JP, BF)                                                                     \
  launch_bwd_mma<JP, BF>(enc, pred, K, bias, labels, lse, g_blank, g_emit, g, blank_id, nsplit, \
                         rec, kw, d_enc_part, d_pred_part, dk_part, db_part, stream)
  if (g.J <= 64) return bf ? SC_BWD(64, true) : SC_BWD(64, false);
  if (g.J <= 128) return bf ? SC_BWD(128, true) : SC_BWD(128, false);
#undef SC_BWD
  return static_cast<int>(cudaErrorInvalidValue);
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
