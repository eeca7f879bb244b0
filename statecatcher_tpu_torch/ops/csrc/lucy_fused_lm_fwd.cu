// Fused LucyRNN cell, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel statecatcher_tpu/ops/lucy_fused_lm.py:156
// _fwd_kernel, launched by _fused_lm_fwd_impl (:196): bias add + grouped-RMS
// gate chain + s-scan -> tanh -> h-scan in one pass over the gates.
//
//   gates (B, T, 7D) f32 or bf16, lane-major: gate i of (b, t) starts at
//         ((b*T + t)*7 + i)*D, order r, z, k, v, h_pre, decay, alpha
//   bias  (7D) f32, unapplied;  h0, s0 (B, D) f32
//   ->    h_all, s_all (B, T, D) in the gates' dtype; all math in f32
//
// Gate chain in the sqrt/divide form of ops/lucy_gates.py (the plain
// version), eps 1e-6:
//   z_n = sigmoid(z / sqrt((r^2+z^2)/2+eps))       decay_n, alpha_n likewise
//   kv  = (k/rms_kv)(v/rms_kv) / (rms_kv^2 + eps)   h_pre_n = h_pre/sqrt(h_pre^2+eps)
//   s_t = decay_n*s_{t-1} + alpha_n*kv;  c = tanh(h_pre_n + s_t)
//   h_t = z_n*h_{t-1} + (1 - z_n)*c
//
// Bound on the card: bytes.  7 planes read and 2 written against ~58
// operations per element (sqrt, divide, exp and tanh counted as one each):
// at B=32, T=1598, D=512 that is 942.5 MB in f32 (0.281 ms at 3.35 TB/s)
// against 1.52 G operations (0.023 ms at 67 TFLOP/s f32).
//
// Design.  Only three operations per element form the recurrences (the s
// step, the tanh, the h step); the gate chain does not depend on the state.
// So a block owns one batch row b and DT = 64 columns and walks T in time
// tiles of TC = 12 steps, with two kinds of warps:
//   * loads: the 12 chain warps keep a ring of S = 3 stages of gate tiles
//     (TC x 7 x DT, the layout of the gates' rows) in shared memory, filled
//     by 16-byte cp.async 2 tiles ahead of the tile being computed (2 x 21 KB
//     in flight per block in f32, ~86 KB per SM);
//   * chain: the chain warps turn tile i's gates into the four per-element
//     coefficients the recurrence needs (decay_n, alpha_n*kv, z_n, h_pre_n;
//     f32, two buffers), all elements of the tile in parallel;
//   * walk: the 2 serial warps, one thread per column, walk tile i-1's TC
//     steps with h and s in registers (4 steps' coefficients loaded at a
//     time) and write h, s into an output tile (two buffers, gates' dtype);
//   * stores: the chain warps write tile i-2's output tile with 16-byte
//     coalesced stores.
// So in phase i the chain of tile i overlaps the walk of tile i-1; one
// barrier separates phases.  Shared memory per block: 3 x 21 KB stages + 2 x
// 12 KB coefficients + 2 x 6 KB outputs = 99 KB in f32, 3 x 10.5 + 2 x 12 +
// 2 x 3 = 61.5 KB in bf16; 448 threads of 72 registers, two blocks (28
// warps) per SM.  What bounds it: instructions, not bytes.  The chain's
// IEEE sqrt and divides (five and ten an element, kept so that each
// element's expressions, the same operations in the same order as the
// one-thread-per-column kernel this replaces, give the same bits) are ~250
// instructions an element; without them the kernel takes 0.32 ms f32, 0.17
// bf16 at B=32 (tools/lucy_cell_variants.py).  Ragged edges: steps past T and columns
// past D are loaded as zeros and never stored.  Copies fall to 8 or 4 bytes
// (2, synchronously, for bf16 rows of odd D) where a row does not start on
// 16 bytes.  tools/lucy_cell_variants.py builds and times other tile sizes.

#include "lucy_tile.cuh"

namespace {

using namespace lucy_tile;

template <typename G>
struct Fwd {
  static constexpr int DT = 64;                         // columns per block
  static constexpr int TC = 12;                         // steps per tile
  static constexpr int S = 3;                           // ring stages
  static constexpr int kChainWarps = 12;
  static constexpr int kMinBlocks = 2;                  // registers: ~72 a thread
  static constexpr int kSerial = DT;                    // one thread per column
  static constexpr int kChain = 32 * kChainWarps;
  static constexpr int kThreads = kSerial + kChain;
  static constexpr int kRowsPerPass = kChain / DT;      // steps per chain pass
  static constexpr int kWalk = TC % 8 == 0 ? 8 : (TC % 4 == 0 ? 4 : 1);  // walk's register batch
  static constexpr int kStageElems = TC * 7 * DT;       // G
  static constexpr int kCoefElems = 4 * TC * DT;        // f32, one buffer
  static constexpr int kOutElems = 2 * TC * DT;         // G, one buffer
  static constexpr size_t kStageBytes = kStageElems * sizeof(G);
  static constexpr size_t kSmem =
      S * kStageBytes + 2 * kCoefElems * sizeof(float) + 2 * kOutElems * sizeof(G);
  static_assert(DT % 32 == 0 && kChain % DT == 0 && TC % kRowsPerPass == 0, "tile geometry");
  static_assert(S >= 2 && (DT * sizeof(G)) % 16 == 0, "ring geometry");
};

template <typename G, int VB>
__global__ void __launch_bounds__(Fwd<G>::kThreads, Fwd<G>::kMinBlocks)
lucy_fused_lm_fwd_kernel(const G* __restrict__ gates, const float* __restrict__ bias,
                         const float* __restrict__ h0, const float* __restrict__ s0,
                         G* __restrict__ h_all, G* __restrict__ s_all, int T, int D) {
  using P = Fwd<G>;
  constexpr int DT = P::DT, TC = P::TC, S = P::S, kWalk = P::kWalk;
  extern __shared__ __align__(16) unsigned char smem[];
  G* stages = reinterpret_cast<G*>(smem);
  float* coefs = reinterpret_cast<float*>(smem + S * P::kStageBytes);
  G* outs = reinterpret_cast<G*>(smem + S * P::kStageBytes + 2 * P::kCoefElems * sizeof(float));

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * DT;
  const int nT = (T + TC - 1) / TC;
  const bool serial = threadIdx.x < P::kSerial;
  const int ct = threadIdx.x - P::kSerial;                 // chain thread index
  const int col = serial ? threadIdx.x : ct % DT;
  const int r0 = serial ? 0 : ct / DT;                     // chain: first step of its passes
  const bool live = d0 + col < D;

  const size_t row = static_cast<size_t>(7) * D;
  const G* gb = gates + static_cast<size_t>(b) * T * row;
  G* hb = h_all + static_cast<size_t>(b) * T * D;
  G* sb = s_all + static_cast<size_t>(b) * T * D;

  // serial: the two states; chain: the column's 7 biases
  float h = live ? h0[static_cast<size_t>(b) * D + d0 + col] : 0.0f;
  float s = live ? s0[static_cast<size_t>(b) * D + d0 + col] : 0.0f;
  float bi[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) bi[i] = live ? bias[i * D + d0 + col] : 0.0f;

  auto load = [&](int j) {                                 // chain threads: tile j's gates
    if (j < nT) {
      const int t0 = j * TC;
      copy_rows<G, DT, VB>(
          stages + (j % S) * P::kStageElems, TC * 7,
          [&](int r) -> const G* {
            const int t = t0 + r / 7;
            return t < T ? gb + static_cast<size_t>(t) * row + (r % 7) * D : nullptr;
          },
          d0, D, gates, ct, P::kChain);
    }
    cp_async_commit();
  };

  if (!serial)
    for (int j = 0; j < S - 1; ++j) load(j);

  // Phase j: the chain warps compute tile j and store tile j-2; the serial
  // warps walk tile j-1.
  for (int j = 0; j <= nT + 1; ++j) {
    if (!serial) cp_async_wait<S - 2>();                   // tile j has landed
    __syncthreads();
    if (serial) {
      if (j >= 1 && j <= nT) {
        const float* cf = coefs + ((j - 1) & 1) * P::kCoefElems;
        G* o = outs + ((j - 1) & 1) * P::kOutElems;
        // kWalk steps at a time: their coefficients into registers first, so
        // the loads are not held behind the previous steps' stores
#pragma unroll
        for (int tw = 0; tw < TC; tw += kWalk) {
          float decay_n[kWalk], alpha_kv[kWalk], z_n[kWalk], h_pre_n[kWalk];
#pragma unroll
          for (int u = 0; u < kWalk; ++u) {
            decay_n[u] = cf[(0 * TC + tw + u) * DT + col];
            alpha_kv[u] = cf[(1 * TC + tw + u) * DT + col];
            z_n[u] = cf[(2 * TC + tw + u) * DT + col];
            h_pre_n[u] = cf[(3 * TC + tw + u) * DT + col];
          }
          float hs[kWalk], ss[kWalk];
#pragma unroll
          for (int u = 0; u < kWalk; ++u) {                // steps past T: never stored
            s = decay_n[u] * s + alpha_kv[u];
            const float c = tanhf(h_pre_n[u] + s);
            h = z_n[u] * h + (1.0f - z_n[u]) * c;
            hs[u] = h;
            ss[u] = s;
          }
#pragma unroll
          for (int u = 0; u < kWalk; ++u) {
            store(o + (tw + u) * DT + col, hs[u]);
            store(o + (TC + tw + u) * DT + col, ss[u]);
          }
        }
      }
    } else {
      load(j + S - 1);                                     // into the stage tile j-1 used
      if (j < nT) {
        const G* st = stages + (j % S) * P::kStageElems;
        float* cf = coefs + (j & 1) * P::kCoefElems;
#pragma unroll
        for (int k = 0; k < TC / P::kRowsPerPass; ++k) {
          const int t = r0 + k * P::kRowsPerPass;
          const G* g = st + t * 7 * DT + col;
          const float r = to_f32(g[0 * DT]) + bi[0];
          const float z = to_f32(g[1 * DT]) + bi[1];
          const float kk = to_f32(g[2 * DT]) + bi[2];
          const float v = to_f32(g[3 * DT]) + bi[3];
          const float h_pre = to_f32(g[4 * DT]) + bi[4];
          const float decay = to_f32(g[5 * DT]) + bi[5];
          const float alpha = to_f32(g[6 * DT]) + bi[6];

          const float rms_rz = sqrtf((r * r + z * z) / 2.0f + kEps);
          const float rms_kv2 = (kk * kk + v * v) / 2.0f + kEps;
          const float rms_kv = sqrtf(rms_kv2);
          const float z_n = sigmoid_f32(z / rms_rz);
          const float decay_n = sigmoid_f32(decay / sqrtf(decay * decay + kEps));
          const float alpha_n = sigmoid_f32(alpha / sqrtf(alpha * alpha + kEps));
          const float h_pre_n = h_pre / sqrtf(h_pre * h_pre + kEps);
          const float kv = (kk / rms_kv) * (v / rms_kv) / (rms_kv2 + kEps);

          cf[(0 * TC + t) * DT + col] = decay_n;
          cf[(1 * TC + t) * DT + col] = alpha_n * kv;
          cf[(2 * TC + t) * DT + col] = z_n;
          cf[(3 * TC + t) * DT + col] = h_pre_n;
        }
      }
      if (j >= 2) {                                        // tile j-2: h rows, then s rows
        const int t0 = (j - 2) * TC;
        store_rows<G, DT, VB>(
            outs + (j & 1) * P::kOutElems, 2 * TC,
            [&](int r) -> G* {
              const int t = t0 + (r < TC ? r : r - TC);
              return t < T ? (r < TC ? hb : sb) + static_cast<size_t>(t) * D : nullptr;
            },
            d0, D, ct, P::kChain);
      }
    }
  }
}

template <typename G, int VB>
int launch_vb(const void* gates, const float* bias, const float* h0, const float* s0,
              void* h_all, void* s_all, int B, int T, int D, cudaStream_t stream) {
  using P = Fwd<G>;
  auto kernel = lucy_fused_lm_fwd_kernel<G, VB>;
  const cudaError_t err = allow_smem(kernel, P::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((D + P::DT - 1) / P::DT, B);
  kernel<<<grid, P::kThreads, P::kSmem, stream>>>(
      static_cast<const G*>(gates), bias, h0, s0, static_cast<G*>(h_all),
      static_cast<G*>(s_all), T, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename G>
int launch(const void* gates, const float* bias, const float* h0, const float* s0,
           void* h_all, void* s_all, int B, int T, int D, cudaStream_t stream) {
  switch (copy_unit_bytes(sizeof(G), D, {gates, h_all, s_all})) {
    case 16: return launch_vb<G, 16>(gates, bias, h0, s0, h_all, s_all, B, T, D, stream);
    case 8: return launch_vb<G, 8>(gates, bias, h0, s0, h_all, s_all, B, T, D, stream);
    case 4: return launch_vb<G, 4>(gates, bias, h0, s0, h_all, s_all, B, T, D, stream);
    default:
      if constexpr (sizeof(G) == 2)
        return launch_vb<G, 2>(gates, bias, h0, s0, h_all, s_all, B, T, D, stream);
      return static_cast<int>(cudaErrorMisalignedAddress);
  }
}

}  // namespace

// dtype: 0 = float32 gates and outputs, 1 = bfloat16.  Returns the
// cudaError_t of the launch (0 on success); the caller raises on non-zero.
extern "C" int lucy_fused_lm_fwd(int dtype, const void* gates, const float* bias,
                                 const float* h0, const float* s0, void* h_all,
                                 void* s_all, int B, int T, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(gates, bias, h0, s0, h_all, s_all, B, T, D, st);
  if (dtype == 1) return launch<__nv_bfloat16>(gates, bias, h0, s0, h_all, s_all, B, T, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
