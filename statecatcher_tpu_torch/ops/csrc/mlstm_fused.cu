// The fused lane-major chunkwise mLSTM for Hopper (sm_90a): K9a and K9b.  The
// chunk math and its contract are in mlstm_chunk.cuh, with the passes both
// directions share (1.-3. below) and the forward's design.
//
// Replaces the TPU kernels of statecatcher_tpu/ops/mlstm_fused.py:
//   K9a  launch_fwd's passes (gates, gates_m or gates_one, state, nterm,
//        scan_fwd, fwd_exit, fwd_out in mlstm_chunk.cuh)
//                          <- _fwd_kernel (:158), launched by _fused_fwd_impl (:199)
//   K9b  passes 1.-3. of mlstm_chunk.cuh and the bwd_*_kernel below
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
//               tile into dq.  Above dqk = 256, U and dq take slabs of 256
//               columns: q.U summed over the slabs in order before den, then
//               U formed again and Q walked again for each slab's dq;
//   5. state, nterm (as 2., NC chunks): dC_c and dn_c;
//   6. scan_bwd (E/256, B*H): dC' and dn' of every chunk, dC0, dn0 and dg's
//               partial sums per block, elementwise in reverse;
//   7. dk       (L/64, NC, B*H): per 64-row tile s: w Y, dw, then S^T and G^T
//               tiles over t >= s: Q^T tile by tile into dk, colD (above dqk
//               = 256 slab by slab as the rows' dq: dw over the slabs in
//               order, S^T and colD with the first);
//   8. dv       (L/64 * dv/128, NC, B*H): w Z, then S^T tiles into dv;
//   9. chain    (NC, B*H): the gate chain with dm' = 0 (block sums, tie counts
//               over each run of equal R, which may cross threads' rows), dic
//               and dlf; dmc and to1 per chunk;
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

#include "mlstm_chunk.cuh"

namespace mlstm {
namespace {

struct ChunkGates {
  float *b, *a, *mu, *aux0, *aux1;
};

// ---------------------------------------------------------------------------
// 4. Rows of a chunk: den, dqn, dmu, dsp, rowD and dq, per 64-row tile
// ---------------------------------------------------------------------------
// floats of shared memory of the rows, dk and dv kernels: the staging area,
// `tiles` 64 x 64 tiles, the chunk's gate rows (5 x rows_floats(L)) and the
// tile's row terms (12 x 64)
// The rows kernel keeps sweep 1's G of its first two s-tiles (all of them at
// L <= 128) and forms G again for the others: four kept tiles (L = 256)
// would leave room for one block per SM.  With more than one slab of dq the
// kept tiles hold Q for the later slabs, and the others are formed in a
// third tile.
constexpr int kKeptG = 2;

inline size_t tiles_smem_bytes(int N, int tiles, int L) {
  return sizeof(float) * (stage_floats(N) + static_cast<size_t>(tiles) * kTile * kQP +
                          5 * rows_floats(L) + 12 * kTile);
}

// Slabs of DQ columns of dq or dk: DQ <= 128 covers dqk, DQ = 256 any dqk
template <int DQ>
__host__ __device__ __forceinline__ int dq_slabs(int dqk) {
  return DQ < 256 ? 1 : (dqk + DQ - 1) / DQ;
}

template <typename Tin, int DQ>
__global__ void __launch_bounds__(kThreads, 2) bwd_rows_kernel(Params p) {
  extern __shared__ float sm[];
  constexpr bool kBf = std::is_same<Tin, __nv_bfloat16>::value;
  float* stage = sm;
  const int t0 = blockIdx.x * kTile, L = p.L, R_ = rows_floats(L);
  const int nslab = dq_slabs<DQ>(p.dqk);
  float* Gs = stage + stage_floats(DQ);        // kKeptG tiles: G, then inv Q (+ 1, nslab > 1)
  float* gr = Gs + (kKeptG + (nslab > 1)) * kTile * kQP;
  const ChunkGates G{gr, gr + R_, gr + 2 * R_, gr + 3 * R_, gr + 4 * R_};   // aux0 = sp
  float* sw = G.aux1 + R_;                     // 64 each: sw, swg, qU, qn, den, dqn, ...
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

  // U = dh C^T (64 x dqk), then q_t . U_t, slab by slab (columns d0 + d)
  Acc<DQ> acc;
  auto form_U = [&](int d0) {
    zero<DQ>(acc);
    mma_tile<DQ, false, true, false>(dv, hd.dhm(t0), mat(Cc + static_cast<size_t>(d0) * dv, dv,
                                                        dqk - d0, dv), stage, acc);
  };
  for (int sl = 0; sl < nslab; ++sl) {
    const int d0 = sl * DQ;
    form_U(d0);
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
          x[i][j][e] = d < dqk - d0 ? rw.Q(t0 + r, d0 + d) * acc[i][j][e] : 0.f;
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

  Tin* dq = static_cast<Tin*>(p.dq) + (hd.bh / p.H) * p.lay.qk_b + (hd.bh % p.H) * p.lay.qk_h;
  for (int sl = 0; sl < nslab; ++sl) {
    const int d0 = sl * DQ, nd = dqk - d0;
    if (nslab > 1) form_U(d0);                 // (one slab: U is still in acc)
    // dq = inv sp (U/den + dqn n) + inv Q k
    each<DQ>(acc, [&](int r, int d, float& x) {
      const int t = t0 + r;
      const float sp = t < L ? G.aux0[t] : 0.f;
      x = d < nd ? p.inv * sp * (x / den[r] + dqn[r] * nc[d0 + d]) : 0.f;
    });
    // sweep 2: inv Q = inv E (G/den + dqn), from sweep 1's G (or G again), tile
    // by tile into dq; the kept tiles turn into Q once, in the first slab
    for (int s0 = 0; s0 <= t0 && s0 < L; s0 += kTile) {
      const bool kept = s0 < kKeptG * kTile;
      float* Qk = Gs + (kept || nslab == 1 ? (s0 / kTile) % kKeptG : kKeptG) * kTile * kQP;
      if (kept) {
        if (sl == 0)
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
      const Mat<Tin> K = hd.km(s0);
      mma_tile<DQ, false, true, true>(min(kTile, L - s0), mat<float>(Qk, kQP, kTile, kTile),
                                      mat(K.p + d0, K.ld, K.nrow, nd), stage, acc);
    }
    each<DQ>(acc, [&](int r, int d, float& x) {
      const int t = t0 + r;
      if (t < L && d < nd)
        st(dq + static_cast<size_t>(rw.t0 + t) * p.lay.qk_r + d0 + d, rw.valid(t) ? x : 0.f);
    });
  }
}

// ---------------------------------------------------------------------------
// 6. The exit adjoints of every chunk, in reverse: dC'_{c-1} = g_c dC'_c +
// dC_c (one thread per element of C and n), and dg's partial sums per block
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) bwd_scan_bwd_kernel(Params p) {
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
__global__ void __launch_bounds__(kThreads, 2) bwd_dk_kernel(Params p) {
  extern __shared__ float sm[];
  constexpr bool kBf = std::is_same<Tin, __nv_bfloat16>::value;
  float* stage = sm;
  float* Qs = stage + stage_floats(DQ);        // inv Q^T of one t-tile
  const int R_ = rows_floats(p.L);
  float* gr = Qs + kTile * kQP;
  const ChunkGates G{gr, gr + R_, gr + 2 * R_, gr + 3 * R_, gr + 4 * R_};   // den, dqn
  float* wv = G.aux1 + R_;                     // w of the tile's rows (64)
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

  auto E = [&](int t, int s) {
    return s <= t && t < L ? expf(G.b[t] + G.a[s] - G.mu[t]) : 0.f;
  };
  Tin* dk = static_cast<Tin*>(p.dk) + (hd.bh / p.H) * p.lay.qk_b + (hd.bh % p.H) * p.lay.qk_h;
  const int nslab = dq_slabs<DQ>(dqk);
  for (int sl = 0; sl < nslab; ++sl) {         // dk's columns d0 + d
    const int d0 = sl * DQ, nd = dqk - d0;
    Acc<DQ> acc;
    zero<DQ>(acc);
    mma_tile<DQ, false, true, false>(dv, hd.vm(s0, wv), mat(lam + static_cast<size_t>(d0) * dv,
                                                            dv, nd, dv), stage, acc);
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
            const float y = d < nd ? acc[i][j][e] + wv[r] * lamn[d0 + d] : 0.f;
            acc[i][j][e] = y;
            x[i][j][e] = d < nd ? rw.K(s0 + r, d0 + d) * y : 0.f;
          }
      row_sums<DQ>(x, red, dZ);
    }

    for (int t0 = s0; t0 < L; t0 += kTile) {
      Acc<kTile> S, Gt;
      zero<kTile>(S);
      zero<kTile>(Gt);
      if (sl == 0) mma_tile<kTile, kBf, true, false>(dqk, hd.km(s0), hd.qm(t0), stage, S);
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
      if (sl == 0)
        row_sums<kTile>(S, red, colD);         // (syncs: Qs is complete after it)
      else
        __syncthreads();
      const Mat<Tin> Qm = hd.qm(t0);
      mma_tile<DQ, false, true, true>(min(kTile, L - t0), mat<float>(Qs, kQP, kTile, kTile),
                                      mat(Qm.p + d0, Qm.ld, Qm.nrow, nd), stage, acc);
    }
    each<DQ>(acc, [&](int r, int d, float& x) {
      const int s = s0 + r;
      if (s < L && d < nd)
        st(dk + static_cast<size_t>(rw.t0 + s) * p.lay.qk_r + d0 + d, rw.valid(s) ? x : 0.f);
    });
  }
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
__global__ void __launch_bounds__(kThreads, 2) bwd_dv_kernel(Params p) {
  extern __shared__ float sm[];
  constexpr bool kBf = std::is_same<Tin, __nv_bfloat16>::value;
  float* stage = sm;
  float* Ws = stage + stage_floats(NV);        // (S E/den)^T of one t-tile
  const int R_ = rows_floats(p.L);
  float* gr = Ws + kTile * kQP;
  const ChunkGates G{gr, gr + R_, gr + 2 * R_, gr + 3 * R_, nullptr};   // aux0 = den
  float* wv = G.aux0 + R_;
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
// 9. The gate chain of each chunk with dm' = 0: thread t takes rows t, t + 256,
// ...; the rows' terms in dynamic shared memory (7 x rows_floats(L))
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) bwd_chain_kernel(Params p) {
  extern __shared__ float sm[];
  __shared__ float sh[kThreads / 32];
  const int c = blockIdx.x, L = p.L, t = threadIdx.x, R_ = rows_floats(L);
  float *sa = sm, *sR = sa + R_, *sdR = sR + R_, *scnt = sdR + R_, *sx = scnt + R_;
  float *sdb = sx + R_, *sda = sdb + R_;
  const Head<float> hd(p, blockIdx.y, c);
  const float m = hd.cfield(CM)[c], gc = hd.cfield(CG)[c], bL = hd.cfield(CBL)[c],
              A = hd.cfield(CA)[c];
  float dg = 0.f;
  for (int i = 0; i < p.wk.nscan; ++i) dg += hd.dgp[c * p.wk.nscan + i];
  float dz_t = 0.f, dmc_t = 0.f;                     // the thread's rows' partial sums
  for (int r = t; r < L; r += kThreads) {
    const int g = c * L + r;
    const float sp = hd.field(RSP)[g], R = hd.field(RR)[g], rowD = hd.field(RROWD)[g];
    const float dX = hd.field(RDSP)[g] * sp;
    const float dmu = hd.field(RDMU)[g] - rowD - dX;
    const float tom = to_first(m, R);
    const float dz = hd.field(RDZ)[g], dmc_r = dX + dmu * tom;
    sdb[r] = rowD + dX + dmu;
    sdR[r] = dmu * (1.f - tom);
    sda[r] = hd.field(RCOLD)[g] + dz;
    sa[r] = hd.field(RA)[g];
    sR[r] = R;
    dz_t = r == t ? dz : dz_t + dz;
    dmc_t = r == t ? dmc_r : dmc_t + dmc_r;
  }
  const float sum_dz = block_sum(dz_t, sh);
  const float dY = dg * gc;
  const float dm_tot = -sum_dz - dY;                 // dm' = 0 here; see the fixup
  const float to1 = to_first(m + bL, bL + A);
  const float dmc = block_sum(dmc_t, sh) + dY + dm_tot * to1;
  if (t == (L - 1) % kThreads) {
    sdR[L - 1] += dm_tot * (1.f - to1);
    sdb[L - 1] += sum_dz + dY + dm_tot;              // dbL
  }
  __syncthreads();
  // R_t = max_{s<=t} a_s: a tie's share goes to every s <= t with a_s = R_t,
  // all of them in the run of equal R ending at t (R does not decrease)
  for (int r = t; r < L; r += kThreads) {
    float cnt = 0.f;
    for (int s = r; s >= 0 && sR[s] == sR[r]; --s) cnt += sa[s] == sR[r] ? 1.f : 0.f;
    scnt[r] = cnt;
  }
  __syncthreads();
  // dlogf_t = sum_{u >= t} (db_u - da_u): sx holds the rows reversed for the scan
  for (int r = t; r < L; r += kThreads) {
    float da = sda[r];
    if (sa[r] == sR[r])
      for (int u = r; u < L && sR[u] == sa[r]; ++u) da += sdR[u] / scnt[u];
    sda[r] = da;
    sx[L - 1 - r] = sdb[r] - da;
  }
  rows_scan(sx, L, 0.f, sh, Add());
  for (int r = t; r < L; r += kThreads) {
    const int g = c * L + r;
    p.dic[static_cast<size_t>(hd.bh) * p.Tp + g] = g < p.T ? sda[r] : 0.f;
    p.dlf[static_cast<size_t>(hd.bh) * p.Tp + g] = g < p.T ? sx[L - 1 - r] : 0.f;
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
__global__ void __launch_bounds__(kThreads) bwd_fixup_kernel(Params p) {
  extern __shared__ float sx[];                      // the rows' hits, reversed
  __shared__ float sh[kThreads / 32];
  const int c = blockIdx.x, L = p.L, t = threadIdx.x;
  const Head<float> hd(p, blockIdx.y, c);
  float x = p.dmT[hd.bh];
  for (int cc = hd.NC - 1; cc > c; --cc) x = hd.cfield(CDMC)[cc] + hd.cfield(CTO1)[cc] * x;
  if (c == 0 && t == 0) p.dm0[hd.bh] = hd.cfield(CDMC)[0] + hd.cfield(CTO1)[0] * x;
  const float share = x * (1.f - hd.cfield(CTO1)[c]) / hd.cfield(CCNT)[c];
  const float A = hd.cfield(CA)[c];
  for (int r = t; r < L; r += kThreads) sx[L - 1 - r] = hd.field(RA)[c * L + r] == A ? 1.f : 0.f;
  rows_scan(sx, L, 0.f, sh, Add());                  // sx[L-1-r]: hits at rows >= r
  const size_t o = static_cast<size_t>(hd.bh) * p.Tp;
  for (int r = t; r < L; r += kThreads) {
    const int g = c * L + r;
    if (g < p.T && hd.field(RA)[g] == A) p.dic[o + g] += share;
    if (g < p.T) p.dlf[o + g] += x - share * sx[L - 1 - r];
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

template <typename Tin, int DQ, int NV>
int launch_bwd(const Params& p, int B, cudaStream_t s) {
  const int BH = B * p.H, NC = p.Tp / p.L, nrt = (p.L + kTile - 1) / kTile;
  const int ndt = (p.dqk + kTile - 1) / kTile;
  const int nst = ndt * ((p.dv_ + kTile - 1) / kTile);
  const size_t rows_smem = sizeof(float) * rows_floats(p.L), gate_smem = sizeof(float) * 2 * p.L;
  const size_t state_smem = sizeof(float) * stage_floats(kTile) + rows_smem;
  const int nslab = dq_slabs<DQ>(p.dqk);
  const unsigned nscan = static_cast<unsigned>(p.wk.nscan);
  int err = launch(gates_kernel, dim3(NC, BH), gate_smem, p, s);
  if (err == 0) err = launch(gates_m_kernel, dim3(NC, BH), 0, p, s);
  if (err == 0 && NC > 1)
    err = launch(state_kernel<Tin, false>, dim3(nst, NC - 1, BH), state_smem, p, s);
  if (err == 0 && NC > 1)
    err = launch(nterm_kernel<Tin, false>, dim3(NC - 1, BH, ndt), rows_smem, p, s);
  if (err == 0) err = launch(scan_fwd_kernel, dim3(nscan, BH), 0, p, s);
  if (err == 0)
    err = launch(bwd_rows_kernel<Tin, DQ>, dim3(nrt, NC, BH),
                 tiles_smem_bytes(DQ, kKeptG + (nslab > 1), p.L), p, s);
  if (err == 0) err = launch(state_kernel<Tin, true>, dim3(nst, NC, BH), state_smem, p, s);
  if (err == 0) err = launch(nterm_kernel<Tin, true>, dim3(NC, BH, ndt), rows_smem, p, s);
  if (err == 0) err = launch(bwd_scan_bwd_kernel, dim3(nscan, BH), 0, p, s);
  if (err == 0)
    err = launch(bwd_dk_kernel<Tin, DQ>, dim3(nrt, NC, BH), tiles_smem_bytes(DQ, 1, p.L), p, s);
  if (err == 0)
    err = launch(bwd_dv_kernel<Tin, NV>, dim3(nrt * ((p.dv_ + NV - 1) / NV), NC, BH),
                 tiles_smem_bytes(NV, 1, p.L), p, s);
  if (err == 0) err = launch(bwd_chain_kernel, dim3(NC, BH), 7 * rows_smem, p, s);
  if (err == 0) err = launch(bwd_fixup_kernel, dim3(NC, BH), rows_smem, p, s);
  return err;
}

// The instances by shape: dq and dk 64, 128 or 256 columns a block (above
// 256 in slabs of 256), dv 64 or 128
template <typename Tin>
int launch_bwd_for(const Params& p, int B, cudaStream_t s) {
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
// is float32, 1 bfloat16 (q, k, v, h, dh, dq, dk, dv).  L must divide Tp and
// T > Tp - L; B*H and Tp/L at most 65535, the grids' y and z limit, and each
// launch's dynamic shared memory (it grows with L) within the block's limit
// (the wrapper checks both: check_launch, max_chunk).
// The floats of K9a's and K9b's workspaces (the work argument) for these shapes.
extern "C" long long mlstm_fused_fwd_work(int B, int H, int Tp, int dqk, int dv, int L) {
  return static_cast<long long>(B) * H * work_layout(Tp, dqk, dv, L, false).stride;
}
extern "C" long long mlstm_fused_bwd_work(int B, int H, int Tp, int dqk, int dv, int L) {
  return static_cast<long long>(B) * H * work_layout(Tp, dqk, dv, L, true).stride;
}

extern "C" int mlstm_fused_fwd(int dtype, const void* q, const void* k, const void* v,
                               const float* ic, const float* lf, const float* C0, const float* n0,
                               const float* m0, void* h, float* CT, float* nT, float* mT,
                               float* work, int B, int H, int Tp, int T, int dqk, int dv, int L,
                               void* stream) {
  Params p{};
  p.q = q, p.k = k, p.v = v, p.ic = ic, p.lf = lf, p.C0 = C0, p.n0 = n0, p.m0 = m0;
  p.h = h, p.CT = CT, p.nT = nT, p.mT = mT, p.work = work;
  p.wk = work_layout(Tp, dqk, dv, L, false);
  p.lay = lane_layout(H, Tp, dqk, dv);
  p.H = H, p.Tp = Tp, p.T = T, p.Tg = T, p.Th = Tp, p.dqk = dqk, p.dv_ = dv, p.L = L;
  p.inv = inv_sqrt(dqk);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd_for<float>(p, B, s);
  if (dtype == 1) return launch_fwd_for<__nv_bfloat16>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mlstm_fused_bwd(int dtype, const void* q, const void* k, const void* v,
                               const float* ic, const float* lf, const float* C0, const float* n0,
                               const float* m0, const void* dh, const float* dCT,
                               const float* dnT, const float* dmT, void* dq, void* dk, void* dv,
                               float* dic, float* dlf, float* dC0, float* dn0, float* dm0,
                               float* work, int B, int H, int Tp, int T, int dqk, int dv_, int L,
                               void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q, p.k = k, p.v = v, p.dh = dh, p.ic = ic, p.lf = lf, p.C0 = C0, p.n0 = n0, p.m0 = m0;
  p.dCT = dCT, p.dnT = dnT, p.dmT = dmT, p.dq = dq, p.dk = dk, p.dv = dv;
  p.dic = dic, p.dlf = dlf, p.dC0 = dC0, p.dn0 = dn0, p.dm0 = dm0, p.work = work;
  p.wk = work_layout(Tp, dqk, dv_, L, true);
  p.lay = lane_layout(H, Tp, dqk, dv_);
  p.H = H, p.Tp = Tp, p.T = T, p.Tg = T, p.dqk = dqk, p.dv_ = dv_, p.L = L;
  p.inv = inv_sqrt(dqk);
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_bwd_for<float>(p, B, s) : launch_bwd_for<__nv_bfloat16>(p, B, s);
}
