// Fused LucyRNN cell, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel statecatcher_tpu/ops/lucy_fused_lm.py:248
// _bwd_kernel, launched by _fused_lm_bwd_impl (:364): the reverse adjoints of
// both recurrences plus the closed-form adjoint of the gate chain, emitting
// d_gates directly.
//
//   gates  (B, T, 7D) f32 or bf16, lane-major (order r, z, k, v, h_pre,
//          decay, alpha), bias unapplied;  bias (7D) f32;  h0, s0 (B, D) f32
//   h_all, s_all (B, T, D) forward outputs, g_h, g_s (B, T, D) their
//          cotangents, all in the gates' dtype; g_s may be null (zero)
//   ->     d_gates (B, T, 7D) in the gates' dtype; dh0, ds0 (B, D) f32;
//          dbias_part (B, 7D) f32, the sum over t of d_gates for each b (the
//          wrapper sums it over b: deterministic, no atomics)
//
// Per step t, walking t = T-1 .. 0 (as ops/lucy_fused_lm.py's plain version):
//   recompute the gate chain in its rsqrt form (a_s = decay_n, b_s =
//   alpha_n*kv, a_h = z_n, bh_c = 1 - z_n, h_pre_n);
//   lam_h = g_h[t] + a_h[t+1]*lam_h;   c = tanh(h_pre_n + s[t])
//   d_pre = lam_h*(bh_c*(1 - c^2));   lam_s = (g_s[t] + d_pre) + a_s[t+1]*lam_s
//   chain adjoint of (lam_s*s[t-1], lam_s, lam_h*h[t-1], lam_h*c, d_pre)
//   -> the 7 d_gates of step t, also added into the d_bias sums.
// At the end dh0 = lam_h*a_h[0] and ds0 = lam_s*a_s[0].
//
// Bound on the card: bytes.  18 planes of B*T*D (7 gate planes, h_all,
// s_all, g_h and g_s read; 7 d_gates planes written): at B=32, T=1598,
// D=512 that is 1.885 GB in f32, 0.563 ms at 3.35 TB/s (0.281 ms in bf16),
// against ~132 operations per element (0.10 ms at 67 TFLOP/s f32).
//
// Design.  Only the two adjoint steps (three operations an element) are
// serial; everything else is elementwise over a tile.  A block owns one
// batch row b and DT = 32 columns and walks T backwards in time tiles of TC
// steps (4 in f32, 8 in bf16), with two kinds of warps:
//   * loads: the 4 chain warps keep a ring of S = 5 stages in shared memory,
//     filled by 16-byte cp.async 2 tiles ahead of the tile being started.
//     A stage holds a tile's 11*TC + 1 rows of DT: the 7 gate planes, g_h,
//     g_s (zeros when null), h[t-1] and s[t-1 .. t0+TC-1] (TC + 1 rows; the
//     row shared with the next tile is loaded again, rows before t = 0 are
//     zeros and h0, s0 come from registers);
//   * pass 1 (chain warps, tile i): the chain's z_n and decay_n, c =
//     tanh(h_pre_n + s[t]) and the lam_h -> d_pre weight bh_c*(1 - c^2),
//     per element, into a coefficient tile (f32, three buffers);
//   * walk (the serial warp, one thread per column, tile i-1): lam_h,
//     lam_s, a_h[t+1], a_s[t+1] in registers across tiles; the tile's inputs
//     read into registers first; lam_h, lam_s and d_pre per step into a tile
//     of its own (f32, two buffers);
//   * pass 2 (chain warps, tile i-2): the chain recomputed in rsqrt form
//     from the stage's gates (z_n, decay_n and c taken from pass 1), the
//     closed-form adjoint, d_gates written straight from registers (each
//     warp store is 32 neighbouring columns of one row: coalesced), and the
//     thread's d_bias sums.
// So in phase i pass 1 of tile i, the walk of tile i-1 and pass 2 of tile
// i-2 run together; one barrier separates phases, and a stage lives from
// its load to pass 2, three phases.  The d_bias sums are added per thread
// in tile order, then over the block's 4 threads of a column in a fixed
// order: two calls give the same bits.  Shared memory per block: 5 x 5.6 KB
// stages + 3 x 2 KB coefficients + 2 x 1.5 KB lambdas = 37.1 KB in f32 (five
// blocks of 160 threads per SM: at B=32 all 512 blocks in one wave), 5 x 5.6
// + 3 x 4 + 2 x 3 = 45.8 KB in bf16 (four).  Each element's expressions are
// those of the one-thread-per-column kernel this replaces.  What bounds it:
// in f32 the loads (0.43 ms at B=32 without them, against 0.68), in bf16 the
// instructions of pass 2's arithmetic and of the loads
// (tools/lucy_cell_variants.py).  Ragged edges: steps past T are skipped by
// the walk and pass 2, columns past D are computed on zeros and never
// stored.  Copies fall to 8 or 4 bytes (2, synchronously, for bf16 rows of
// odd D) where a row does not start on 16 bytes.  tools/lucy_cell_variants.py
// builds and times other tile sizes.

#include "lucy_tile.cuh"

namespace {

using namespace lucy_tile;

template <typename G>
struct Bwd {
  static constexpr int DT = 32;                         // columns per block
  static constexpr int TC = sizeof(G) == 4 ? 4 : 8;     // steps per tile
  static constexpr int S = 5;                           // ring stages
  static constexpr int kChainWarps = 4;
  static constexpr int kSerial = DT;                    // one thread per column
  static constexpr int kChain = 32 * kChainWarps;
  static constexpr int kThreads = kSerial + kChain;
  static constexpr int kRowsPerPass = kChain / DT;      // steps per chain pass
  // stage rows: gates (7 per step), g_h, g_s, h[t-1], s[t-1] .. s[t0+TC-1]
  static constexpr int kRowGh = 7 * TC, kRowGs = 8 * TC, kRowH = 9 * TC, kRowS = 10 * TC;
  static constexpr int kRows = 11 * TC + 1;
  static constexpr int kStageElems = kRows * DT;        // G
  static constexpr int kCoefElems = 4 * TC * DT;        // f32: w, z_n, d_n, c
  static constexpr int kLamElems = 3 * TC * DT;         // f32: lam_h, lam_s, d_pre
  static constexpr size_t kStageBytes = kStageElems * sizeof(G);
  static constexpr size_t kSmem =
      S * kStageBytes + (3 * kCoefElems + 2 * kLamElems) * sizeof(float);
  static constexpr int kMinBlocks = 232448 / (kSmem + 1024);   // as many as shared memory holds
  static_assert(DT % 32 == 0 && kChain % DT == 0 && TC % kRowsPerPass == 0, "tile geometry");
  static_assert(S >= 4 && (DT * sizeof(G)) % 16 == 0, "ring geometry");
  static_assert(kRowsPerPass * 7 * DT * sizeof(float) <= kSmem, "d_bias scratch");
};

template <typename G, int VB>
__global__ void __launch_bounds__(Bwd<G>::kThreads, Bwd<G>::kMinBlocks)
lucy_fused_lm_bwd_kernel(const G* __restrict__ gates, const float* __restrict__ bias,
                         const float* __restrict__ h0, const float* __restrict__ s0,
                         const G* __restrict__ h_all, const G* __restrict__ s_all,
                         const G* __restrict__ g_h, const G* __restrict__ g_s,
                         G* __restrict__ d_gates, float* __restrict__ dh0,
                         float* __restrict__ ds0, float* __restrict__ dbias_part,
                         int T, int D) {
  using P = Bwd<G>;
  constexpr int DT = P::DT, TC = P::TC, S = P::S, RP = P::kRowsPerPass;
  extern __shared__ __align__(16) unsigned char smem[];
  G* stages = reinterpret_cast<G*>(smem);
  float* coefs = reinterpret_cast<float*>(smem + S * P::kStageBytes);
  float* lams = coefs + 3 * P::kCoefElems;

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * DT;
  const int nT = (T + TC - 1) / TC;
  const bool serial = threadIdx.x < P::kSerial;
  const int ct = threadIdx.x - P::kSerial;              // chain thread index
  const int col = serial ? threadIdx.x : ct % DT;
  const int r0 = serial ? 0 : ct / DT;                  // chain: first step of its passes
  const bool live = d0 + col < D;

  const size_t row = static_cast<size_t>(7) * D;
  const G* gb = gates + static_cast<size_t>(b) * T * row;
  G* dgb = d_gates + static_cast<size_t>(b) * T * row;
  const size_t plane = static_cast<size_t>(b) * T * D;
  const G* hab = h_all + plane;
  const G* sab = s_all + plane;
  const G* ghb = g_h + plane;
  const G* gsb = g_s ? g_s + plane : nullptr;

  // serial: the adjoints and the next step's coefficients
  float lam_h = 0.0f, lam_s = 0.0f;
  float a_h_next = 1.0f, a_s_next = 1.0f;
  // chain: the column's biases, initial states and d_bias sums
  float bi[7], db[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    bi[i] = live ? bias[i * D + d0 + col] : 0.0f;
    db[i] = 0.0f;
  }
  const float h_init = live ? h0[static_cast<size_t>(b) * D + d0 + col] : 0.0f;
  const float s_init = live ? s0[static_cast<size_t>(b) * D + d0 + col] : 0.0f;

  // Tile j of the walk is time tile nT-1-j: steps t0 .. t0+TC-1.
  auto tile_t0 = [&](int j) { return (nT - 1 - j) * TC; };

  auto load = [&](int j) {                              // chain threads: tile j's rows
    if (j < nT) {
      const int t0 = tile_t0(j);
      copy_rows<G, DT, VB>(
          stages + (j % S) * P::kStageElems, P::kRows,
          [&](int r) -> const G* {
            if (r < P::kRowGh) {
              const int t = t0 + r / 7;
              return t < T ? gb + static_cast<size_t>(t) * row + (r % 7) * D : nullptr;
            }
            const G* base;
            int t;
            if (r < P::kRowGs) {
              base = ghb, t = t0 + r - P::kRowGh;
            } else if (r < P::kRowH) {
              base = gsb, t = t0 + r - P::kRowGs;
            } else if (r < P::kRowS) {
              base = hab, t = t0 - 1 + r - P::kRowH;
            } else {
              base = sab, t = t0 - 1 + r - P::kRowS;
            }
            return base != nullptr && t >= 0 && t < T ? base + static_cast<size_t>(t) * D
                                                      : nullptr;
          },
          d0, D, gates, ct, P::kChain);
    }
    cp_async_commit();
  };

  if (!serial)
    for (int j = 0; j < S - 3; ++j) load(j);

  // Phase j: the chain warps run pass 1 of tile j and pass 2 of tile j-2;
  // the serial warp walks tile j-1.
  for (int j = 0; j <= nT + 1; ++j) {
    if (!serial) cp_async_wait<S - 4>();                // tile j has landed
    __syncthreads();
    if (serial) {
      if (j >= 1 && j <= nT) {
        const int t0 = tile_t0(j - 1);
        const G* st = stages + ((j - 1) % S) * P::kStageElems;
        const float* cf = coefs + ((j - 1) % 3) * P::kCoefElems;
        float* lm = lams + ((j - 1) & 1) * P::kLamElems;
        // the tile's inputs into registers first, so the loads are not held
        // behind the previous steps' stores
        float gh[TC], gs[TC], w[TC], z_n[TC], d_n[TC], lh[TC], ls[TC], dp[TC];
#pragma unroll
        for (int t = 0; t < TC; ++t) {
          gh[t] = to_f32(st[(P::kRowGh + t) * DT + col]);
          gs[t] = to_f32(st[(P::kRowGs + t) * DT + col]);
          w[t] = cf[(0 * TC + t) * DT + col];
          z_n[t] = cf[(1 * TC + t) * DT + col];
          d_n[t] = cf[(2 * TC + t) * DT + col];
        }
#pragma unroll
        for (int t = TC - 1; t >= 0; --t) {
          float d_pre = 0.0f;
          if (t0 + t < T) {                             // only the last time tile is ragged
            lam_h = gh[t] + a_h_next * lam_h;
            d_pre = lam_h * w[t];
            lam_s = (gs[t] + d_pre) + a_s_next * lam_s;
            a_h_next = z_n[t];
            a_s_next = d_n[t];
          }
          lh[t] = lam_h;
          ls[t] = lam_s;
          dp[t] = d_pre;
        }
#pragma unroll
        for (int t = 0; t < TC; ++t) {                  // steps past T: never read
          lm[(0 * TC + t) * DT + col] = lh[t];
          lm[(1 * TC + t) * DT + col] = ls[t];
          lm[(2 * TC + t) * DT + col] = dp[t];
        }
      }
    } else {
      load(j + S - 3);                                  // into the stage tile j-3 used
      if (j < nT) {                                     // pass 1, tile j
        const G* st = stages + (j % S) * P::kStageElems;
        float* cf = coefs + (j % 3) * P::kCoefElems;
#pragma unroll
        for (int k = 0; k < TC / RP; ++k) {
          const int t = r0 + k * RP;
          const G* g = st + t * 7 * DT + col;
          const float r = to_f32(g[0 * DT]) + bi[0];
          const float z = to_f32(g[1 * DT]) + bi[1];
          const float h_pre = to_f32(g[4 * DT]) + bi[4];
          const float decay = to_f32(g[5 * DT]) + bi[5];
          const float i_rz = rsqrtf((r * r + z * z) * 0.5f + kEps);
          const float i_d = rsqrtf(decay * decay + kEps);
          const float i_p = rsqrtf(h_pre * h_pre + kEps);
          const float z_n = sigmoid_f32(z * i_rz);
          const float d_n = sigmoid_f32(decay * i_d);
          const float bh_c = 1.0f - z_n;
          const float h_pre_n = h_pre * i_p;
          const float s_cur = to_f32(st[(P::kRowS + t + 1) * DT + col]);
          const float c = tanhf(h_pre_n + s_cur);
          cf[(0 * TC + t) * DT + col] = bh_c * (1.0f - c * c);
          cf[(1 * TC + t) * DT + col] = z_n;
          cf[(2 * TC + t) * DT + col] = d_n;
          cf[(3 * TC + t) * DT + col] = c;
        }
      }
      if (j >= 2) {                                     // pass 2, tile j-2
        const int jj = j - 2;
        const int t0 = tile_t0(jj);
        const G* st = stages + (jj % S) * P::kStageElems;
        const float* cf = coefs + (jj % 3) * P::kCoefElems;
        const float* lm = lams + (jj & 1) * P::kLamElems;
#pragma unroll
        for (int k = 0; k < TC / RP; ++k) {
          const int t = r0 + k * RP;
          const int tt = t0 + t;
          if (tt >= T || !live) continue;
          const G* g = st + t * 7 * DT + col;
          const float r = to_f32(g[0 * DT]) + bi[0];
          const float z = to_f32(g[1 * DT]) + bi[1];
          const float kk = to_f32(g[2 * DT]) + bi[2];
          const float v = to_f32(g[3 * DT]) + bi[3];
          const float h_pre = to_f32(g[4 * DT]) + bi[4];
          const float decay = to_f32(g[5 * DT]) + bi[5];
          const float alpha = to_f32(g[6 * DT]) + bi[6];

          // gate chain, rsqrt form (ops/lucy_fused_lm.py:_gate_chain_res)
          const float i_rz = rsqrtf((r * r + z * z) * 0.5f + kEps);
          const float q_kv = (kk * kk + v * v) * 0.5f + kEps;
          const float i_kv = rsqrtf(q_kv);
          const float inv_qe = 1.0f / (q_kv + kEps);
          const float i_d = rsqrtf(decay * decay + kEps);
          const float i_a = rsqrtf(alpha * alpha + kEps);
          const float i_p = rsqrtf(h_pre * h_pre + kEps);
          const float z_n = cf[(1 * TC + t) * DT + col];
          const float d_n = cf[(2 * TC + t) * DT + col];
          const float c = cf[(3 * TC + t) * DT + col];
          const float a_n = sigmoid_f32(alpha * i_a);
          const float F = (i_kv * i_kv) * inv_qe;
          const float kv = (kk * v) * F;

          const float lh = lm[(0 * TC + t) * DT + col];
          const float ls = lm[(1 * TC + t) * DT + col];
          const float d_pre = lm[(2 * TC + t) * DT + col];
          const float s_prev = tt > 0 ? to_f32(st[(P::kRowS + t) * DT + col]) : s_init;
          const float h_prev = tt > 0 ? to_f32(st[(P::kRowH + t) * DT + col]) : h_init;

          // cotangents of (a_s, b_s, a_h, bh_c, h_pre_n)
          const float ca = ls * s_prev;
          const float cb = ls;
          const float cah = lh * h_prev;
          const float cbh = lh * c;
          const float cp = d_pre;

          // closed-form chain adjoint (ops/lucy_fused_lm.py:_gate_chain_bwd)
          float out[7];
          out[5] = ca * (d_n * (1.0f - d_n)) * (kEps * i_d * i_d * i_d);
          const float c_kv = cb * a_n;
          out[6] = (cb * kv) * (a_n * (1.0f - a_n)) * (kEps * i_a * i_a * i_a);
          const float gz = (cah - cbh) * (z_n * (1.0f - z_n));
          const float i_rz3 = (i_rz * i_rz) * i_rz;
          out[1] = gz * (i_rz - (0.5f * (z * z)) * i_rz3);
          out[0] = gz * ((-0.5f) * (z * r) * i_rz3);
          out[4] = cp * (kEps * i_p * i_p * i_p);
          const float tF = (2.0f * q_kv + kEps) * F;
          out[2] = (c_kv * v) * F * (1.0f - (kk * kk) * tF);
          out[3] = (c_kv * kk) * F * (1.0f - (v * v) * tF);

          G* dg = dgb + static_cast<size_t>(tt) * row + d0 + col;
#pragma unroll
          for (int i = 0; i < 7; ++i) {
            store(dg + static_cast<size_t>(i) * D, out[i]);
            db[i] += out[i];
          }
        }
      }
    }
  }

  // dh0, ds0 from the serial warp; d_bias: each chain thread's sums, then
  // the RP threads of a column added in a fixed order
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);          // [RP][7][DT], over stage 0
  if (serial) {
    if (live) {
      dh0[static_cast<size_t>(b) * D + d0 + col] = lam_h * a_h_next;
      ds0[static_cast<size_t>(b) * D + d0 + col] = lam_s * a_s_next;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 7; ++i) red[(r0 * 7 + i) * DT + col] = db[i];
  }
  __syncthreads();
  if (!serial && r0 == 0 && live) {
    float* dbp = dbias_part + static_cast<size_t>(b) * row + d0 + col;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      float sum = red[i * DT + col];
      for (int p = 1; p < RP; ++p) sum += red[(p * 7 + i) * DT + col];
      dbp[static_cast<size_t>(i) * D] = sum;
    }
  }
}

template <typename G, int VB>
int launch_vb(const void* gates, const float* bias, const float* h0, const float* s0,
              const void* h_all, const void* s_all, const void* g_h, const void* g_s,
              void* d_gates, float* dh0, float* ds0, float* dbias_part, int B, int T, int D,
              cudaStream_t stream) {
  using P = Bwd<G>;
  auto kernel = lucy_fused_lm_bwd_kernel<G, VB>;
  const cudaError_t err = allow_smem(kernel, P::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((D + P::DT - 1) / P::DT, B);
  kernel<<<grid, P::kThreads, P::kSmem, stream>>>(
      static_cast<const G*>(gates), bias, h0, s0, static_cast<const G*>(h_all),
      static_cast<const G*>(s_all), static_cast<const G*>(g_h), static_cast<const G*>(g_s),
      static_cast<G*>(d_gates), dh0, ds0, dbias_part, T, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename G>
int launch(const void* gates, const float* bias, const float* h0, const float* s0,
           const void* h_all, const void* s_all, const void* g_h, const void* g_s,
           void* d_gates, float* dh0, float* ds0, float* dbias_part, int B, int T, int D,
           cudaStream_t stream) {
#define LUCY_K2_LAUNCH(VB)                                                                  \
  launch_vb<G, VB>(gates, bias, h0, s0, h_all, s_all, g_h, g_s, d_gates, dh0, ds0, dbias_part, \
                   B, T, D, stream)
  switch (copy_unit_bytes(sizeof(G), D, {gates, h_all, s_all, g_h, g_s})) {
    case 16: return LUCY_K2_LAUNCH(16);
    case 8: return LUCY_K2_LAUNCH(8);
    case 4: return LUCY_K2_LAUNCH(4);
    default:
      if constexpr (sizeof(G) == 2) return LUCY_K2_LAUNCH(2);
      return static_cast<int>(cudaErrorMisalignedAddress);
  }
#undef LUCY_K2_LAUNCH
}

}  // namespace

// dtype: 0 = float32 gates, activations and cotangents, 1 = bfloat16.
// g_s may be null.  Returns the cudaError_t of the launch (0 on success).
extern "C" int lucy_fused_lm_bwd(int dtype, const void* gates, const float* bias,
                                 const float* h0, const float* s0, const void* h_all,
                                 const void* s_all, const void* g_h, const void* g_s,
                                 void* d_gates, float* dh0, float* ds0, float* dbias_part,
                                 int B, int T, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(gates, bias, h0, s0, h_all, s_all, g_h, g_s, d_gates, dh0, ds0,
                         dbias_part, B, T, D, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(gates, bias, h0, s0, h_all, s_all, g_h, g_s, d_gates, dh0,
                                 ds0, dbias_part, B, T, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
