// Shared pieces of the LucyRNN cell kernels K1 (lucy_fused_lm_fwd.cu), K2
// (lucy_fused_lm_bwd.cu), K12 and K11 (lucy_cell_scan.cu) and K5a and K5b
// (linear_scan.cu): the element helpers, the cp.async ring's copies of row
// tiles into shared memory, the 16-byte stores out of it, the launch-time
// choice of the copy width, the cell forward's kernel body
// (`cell_fwd_kernel`), which K1 and K12 instantiate with their own gate chain
// and step, and the ring scan's (`ring_scan_kernel`), which K5a, K5b and K11
// instantiate with their own step.
//
// All of them give a block one batch row b and a tile of DT columns, and
// walk time in tiles of TC steps.  A tile's rows (one gate plane, one
// cotangent plane, ... at one step) are DT contiguous elements in device
// memory; in shared memory they are stored row after row, DT elements each.
// The batch row is the grid's y, which CUDA holds to kGridY rows: the
// launchers walk the batch in slices of at most kGridY rows, each launch's
// pointers offset to its slice's first row, so any B runs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace lucy_tile {

constexpr float kEps = 1e-6f;
constexpr int kGridY = 65535;                  // CUDA's limit on a grid's y

// The batch rows [b0, b0 + nb) of the slices of at most kGridY rows that
// cover B: f(b0, nb) for each, in order; returns the first non-zero result.
template <typename Fn>
inline int for_each_batch_slice(int B, Fn f) {
  for (int b0 = 0; b0 < B; b0 += kGridY) {
    const int err = f(b0, B - b0 < kGridY ? B - b0 : kGridY);
    if (err != 0) return err;
  }
  return 0;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename G>
__device__ __forceinline__ G zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16_rn(0.0f); }

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

// One copy unit of VB bytes (16, 8 or 4) from device to shared memory,
// asynchronous; a false `valid` fills the unit with zeros and reads nothing.
template <int VB>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? VB : 0;
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem),
                 "n"(VB), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int VB>
struct Unit;
template <>
struct Unit<16> { using T = uint4; };
template <>
struct Unit<8> { using T = uint2; };
template <>
struct Unit<4> { using T = unsigned; };
template <>
struct Unit<2> { using T = unsigned short; };

// Copy `nrows` rows of DT elements into dst (row r at dst + r*DT), in units
// of VB bytes, spread over threads tid = 0 .. nthreads-1.  src(r) gives row
// r's first element in device memory (column 0), or nullptr for a row that
// does not exist (a step outside [0, T)): such rows, and columns at or past
// D - d0, are filled with zeros.  VB >= 4 copies with cp.async (the caller
// commits and waits); VB == 2 (bf16 rows not 4-byte aligned) copies
// synchronously.  `safe` is any valid device address.
template <typename G, int DT, int VB, typename RowFn>
__device__ __forceinline__ void copy_rows(G* dst, int nrows, RowFn src, int d0, int D,
                                          const G* safe, int tid, int nthreads) {
  constexpr int kVec = VB / static_cast<int>(sizeof(G));
  constexpr int kPerRow = DT / kVec;
  static_assert(kVec >= 1 && DT % kVec == 0, "copy unit must divide the tile width");
  for (int g = tid; g < nrows * kPerRow; g += nthreads) {
    const int r = g / kPerRow;
    const int c = (g - r * kPerRow) * kVec;
    const G* row = src(r);
    const bool ok = row != nullptr && d0 + c < D;
    G* q = dst + r * DT + c;
    if constexpr (VB >= 4) {
      cp_async<VB>(q, ok ? row + d0 + c : safe, ok);
    } else {
      *q = ok ? row[d0 + c] : zero<G>();
    }
  }
}

// Store `nrows` rows of DT elements from src (row r at src + r*DT) to device
// memory in units of VB bytes; dst(r) gives row r's column 0, or nullptr to
// skip the row; columns at or past D - d0 are skipped.
template <typename G, int DT, int VB, typename RowFn>
__device__ __forceinline__ void store_rows(const G* src, int nrows, RowFn dst, int d0, int D,
                                           int tid, int nthreads) {
  using U = typename Unit<VB>::T;
  constexpr int kVec = VB / static_cast<int>(sizeof(G));
  constexpr int kPerRow = DT / kVec;
  for (int g = tid; g < nrows * kPerRow; g += nthreads) {
    const int r = g / kPerRow;
    const int c = (g - r * kPerRow) * kVec;
    G* row = dst(r);
    if (row != nullptr && d0 + c < D)
      *reinterpret_cast<U*>(row + d0 + c) = *reinterpret_cast<const U*>(src + r * DT + c);
  }
}

// The widest copy unit (16, 8 or 4 bytes; 2 only for bf16) that every row of
// every tensor in `ptrs` (null entries skipped) starts on: rows are D elements
// of `es` bytes apart.
inline int copy_unit_bytes(int es, int D, std::initializer_list<const void*> ptrs) {
  for (int vb : {16, 8, 4}) {
    if (vb < es || (static_cast<long long>(D) * es) % vb) continue;
    bool ok = true;
    for (const void* p : ptrs)
      if (p != nullptr && reinterpret_cast<std::uintptr_t>(p) % vb) ok = false;
    if (ok) return vb;
  }
  return es;
}

// Opt a kernel in to `bytes` of dynamic shared memory (needed above 48 KB).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// The cell forward (K1, K12).  Only three operations per element form the
// recurrences (the s step, the tanh, the h step); the gate chain does not
// depend on the state.  So a block owns one batch row b and DT = 64 columns
// and walks T in time tiles of TC = 12 steps, with two kinds of warps:
//   * loads: the 12 chain warps keep a ring of S = 3 stages of gate tiles
//     (TC x 7 x DT, the layout of the gates' rows) in shared memory, filled
//     by 16-byte cp.async 2 tiles ahead of the tile being computed (2 x 21 KB
//     in flight per block in f32, ~86 KB per SM), with the tile's TC frame
//     mask values where there is a mask (read into a register one phase
//     before they are put in their stage);
//   * chain: the chain warps turn tile i's gates into the four per-element
//     coefficients the walk needs (f32, two buffers), all elements of the
//     tile in parallel;
//   * walk: the 2 serial warps, one thread per column, walk tile i-1's TC
//     steps with h and s in registers (kWalk steps' coefficients loaded at a
//     time) and write h, s into an output tile (two buffers, gates' dtype);
//   * stores: the chain warps write tile i-2's output tile with 16-byte
//     coalesced stores.
// So in phase i the chain of tile i overlaps the walk of tile i-1; one
// barrier separates phases.  Shared memory per block: 3 x 21 KB stages + 2 x
// 12 KB coefficients + 2 x 6 KB outputs = 99 KB in f32, 3 x 10.5 + 2 x 12 +
// 2 x 3 = 61.5 KB in bf16 (and S x TC mask floats); 448 threads of at most
// 72 registers, two blocks (28 warps) per SM.  Ragged edges: steps past T and
// columns past D are loaded as zeros and never stored.  Copies fall to 8 or
// 4 bytes (2, synchronously, for bf16 rows of odd D) where a row does not
// start on 16 bytes.
//
// A chain policy `Chain` gives the arithmetic:
//   kBias      add the (7D) f32 bias to the gates in the chain (K1);
//   kMasked    read a (B, T) byte frame mask, 0 or 1 (K12's masked form);
//   coefs(x, m, c)    the 7 gates x (order r, z, k, v, h_pre, decay, alpha)
//                     and the step's mask value m -> the 4 coefficients c;
//   step(c0, c1, c2, c3, s, h)    one step of the two recurrences.

template <typename G>
struct FwdTile {
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
  static constexpr size_t kMaskSmem = S * TC * sizeof(float);   // after kSmem, if masked
  static_assert(DT % 32 == 0 && kChain % DT == 0 && TC % kRowsPerPass == 0, "tile geometry");
  static_assert(S >= 3 && (DT * sizeof(G)) % 16 == 0, "ring geometry");
  static_assert(TC <= kChain, "the mask's loaders");
};

template <typename Chain, typename G, int VB>
__global__ void __launch_bounds__(FwdTile<G>::kThreads, FwdTile<G>::kMinBlocks)
cell_fwd_kernel(const G* __restrict__ gates, const float* __restrict__ bias,
                const unsigned char* __restrict__ mask, const float* __restrict__ h0,
                const float* __restrict__ s0, G* __restrict__ h_all, G* __restrict__ s_all,
                int T, int D) {
  using P = FwdTile<G>;
  constexpr int DT = P::DT, TC = P::TC, S = P::S, kWalk = P::kWalk;
  extern __shared__ __align__(16) unsigned char smem[];
  G* stages = reinterpret_cast<G*>(smem);
  float* coefs = reinterpret_cast<float*>(smem + S * P::kStageBytes);
  G* outs = reinterpret_cast<G*>(smem + S * P::kStageBytes + 2 * P::kCoefElems * sizeof(float));
  float* masks = reinterpret_cast<float*>(smem + P::kSmem);   // S x TC, masked only

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
  const unsigned char* mb = Chain::kMasked ? mask + static_cast<size_t>(b) * T : nullptr;

  // serial: the two states; chain: the column's 7 biases (K1)
  float h = live ? h0[static_cast<size_t>(b) * D + d0 + col] : 0.0f;
  float s = live ? s0[static_cast<size_t>(b) * D + d0 + col] : 0.0f;
  float bi[7];
  if constexpr (Chain::kBias) {
#pragma unroll
    for (int i = 0; i < 7; ++i) bi[i] = live ? bias[i * D + d0 + col] : 0.0f;
  }

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
  // masked: chain thread ct < TC holds step ct of tile j+S-1's mask in a
  // register from phase j and puts it in the tile's stage in phase j+1
  auto mask_of = [&](int j) -> float {
    const int t = j * TC + ct;
    return t < T ? static_cast<float>(mb[t]) : 1.0f;
  };
  float m_next = 1.0f;

  if (!serial) {
    for (int j = 0; j < S - 1; ++j) load(j);
    if constexpr (Chain::kMasked) {
      if (ct < TC) {
        for (int j = 0; j < S - 2; ++j) masks[(j % S) * TC + ct] = mask_of(j);
        m_next = mask_of(S - 2);
      }
    }
  }

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
          float c0[kWalk], c1[kWalk], c2[kWalk], c3[kWalk];
#pragma unroll
          for (int u = 0; u < kWalk; ++u) {
            c0[u] = cf[(0 * TC + tw + u) * DT + col];
            c1[u] = cf[(1 * TC + tw + u) * DT + col];
            c2[u] = cf[(2 * TC + tw + u) * DT + col];
            c3[u] = cf[(3 * TC + tw + u) * DT + col];
          }
          float hs[kWalk], ss[kWalk];
#pragma unroll
          for (int u = 0; u < kWalk; ++u) {                // steps past T: never stored
            Chain::step(c0[u], c1[u], c2[u], c3[u], s, h);
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
      if constexpr (Chain::kMasked) {
        if (ct < TC) {                                     // tile j+S-2's stage is not read
          masks[((j + S - 2) % S) * TC + ct] = m_next;    // before phase j+1
          m_next = mask_of(j + S - 1);
        }
      }
      if (j < nT) {
        const G* st = stages + (j % S) * P::kStageElems;
        float* cf = coefs + (j & 1) * P::kCoefElems;
#pragma unroll
        for (int k = 0; k < TC / P::kRowsPerPass; ++k) {
          const int t = r0 + k * P::kRowsPerPass;
          const G* g = st + t * 7 * DT + col;
          float x[7];
#pragma unroll
          for (int i = 0; i < 7; ++i) {
            x[i] = to_f32(g[i * DT]);
            if constexpr (Chain::kBias) x[i] = x[i] + bi[i];
          }
          const float m = Chain::kMasked ? masks[(j % S) * TC + t] : 1.0f;
          float c[4];
          Chain::coefs(x, m, c);
#pragma unroll
          for (int i = 0; i < 4; ++i) cf[(i * TC + t) * DT + col] = c[i];
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

template <typename Chain, typename G, int VB>
int launch_cell_fwd_vb(const G* gates, const float* bias, const unsigned char* mask,
                       const float* h0, const float* s0, G* h_all, G* s_all, int B, int T, int D,
                       cudaStream_t stream) {
  using P = FwdTile<G>;
  auto kernel = cell_fwd_kernel<Chain, G, VB>;
  const size_t smem = P::kSmem + (Chain::kMasked ? P::kMaskSmem : 0);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return for_each_batch_slice(B, [&](int b0, int nb) {
    const size_t plane = static_cast<size_t>(b0) * T * D, row = static_cast<size_t>(b0) * D;
    const dim3 grid((D + P::DT - 1) / P::DT, nb);
    kernel<<<grid, P::kThreads, smem, stream>>>(
        gates + 7 * plane, bias, mask ? mask + static_cast<size_t>(b0) * T : nullptr, h0 + row,
        s0 + row, h_all + plane, s_all + plane, T, D);
    return static_cast<int>(cudaGetLastError());
  });
}

// Launch the cell forward of `Chain` on (B, T, 7D) gates with the widest copy
// unit the gates' and outputs' rows allow.  Returns the cudaError_t of the
// first launch that failed (0 if none).
template <typename Chain, typename G>
int launch_cell_fwd(const void* gates, const float* bias, const unsigned char* mask,
                    const float* h0, const float* s0, void* h_all, void* s_all, int B, int T,
                    int D, cudaStream_t stream) {
  const G* g = static_cast<const G*>(gates);
  G* ho = static_cast<G*>(h_all);
  G* so = static_cast<G*>(s_all);
  switch (copy_unit_bytes(sizeof(G), D, {gates, h_all, s_all})) {
    case 16: return launch_cell_fwd_vb<Chain, G, 16>(g, bias, mask, h0, s0, ho, so, B, T, D, stream);
    case 8: return launch_cell_fwd_vb<Chain, G, 8>(g, bias, mask, h0, s0, ho, so, B, T, D, stream);
    case 4: return launch_cell_fwd_vb<Chain, G, 4>(g, bias, mask, h0, s0, ho, so, B, T, D, stream);
    default:
      if constexpr (sizeof(G) == 2)
        return launch_cell_fwd_vb<Chain, G, 2>(g, bias, mask, h0, s0, ho, so, B, T, D, stream);
      return static_cast<int>(cudaErrorMisalignedAddress);
  }
}


// ---------------------------------------------------------------------------
// The ring scan (K5a, K5b, K11): elementwise recurrences over (B, T, D)
// planes whose only serial work is a few operations a step.  A block owns
// one batch row b and DT columns (one 128-byte line of a row, unless the
// step says otherwise) and walks time in tiles of TC steps, with two kinds of
// warps:
//   * copies: kCopy threads keep an S-stage ring of input tiles (kIn planes
//     x TC rows x DT, plane after plane) in shared memory, filled by cp.async
//     (copy_rows, 16 bytes a thread where the rows allow) S-1 tiles ahead of
//     the walk, and store the output tile the walk wrote in the phase before
//     (kOut planes, two buffers) with store_rows' 16-byte stores, a pass a
//     plane (two input planes: one pass over both);
//   * walk: one thread a column walks the tile that has landed out of shared
//     memory, its carries in registers, and writes each step's outputs into
//     the output tile.
// So in phase j the walk of tile j, the loads of tiles j+1 .. j+S-1 and the
// stores of tile j-1 overlap; one barrier a phase separates them, and the
// walk never waits on a device load.  A reverse step visits the time tiles
// from the latest to the earliest and walks each from its latest step down.
// Tiles sit on multiples of TC, so the one partial tile (the one holding
// step T-1) is the last walked forwards and the first walked backwards.
// Steps past T and columns past D are loaded as zeros and never stored (a
// reverse step must leave its carries as they started on zero inputs).
//
// A step policy `Step` gives:
//   DT, TC, S, kCopy      the geometry above;
//   kIn, kOut             planes in (at most 4) and out (at most 2);
//   kCarry, kInit         carries in registers (at most 2); the first kInit of
//                         them start from the (B, D) f32 arrays c0, c1, the
//                         rest (and every carry of a column past D) from 0;
//   kReverse              walk time backwards;
//   step(x, c, y)         one step: the kIn inputs (x(i), plane i's value at
//                         this step, in f32) and the carries c -> the new
//                         carries and the kOut outputs y.  The step reads
//                         each input where its arithmetic first needs it.

template <typename Step, typename Tx>
struct Ring {
  static constexpr int DT = Step::DT, TC = Step::TC, S = Step::S;
  static constexpr int kWalk = DT;                                 // one thread per column
  static constexpr int kCopy = Step::kCopy;
  static constexpr int kThreads = kWalk + kCopy;
  static constexpr int kStageElems = Step::kIn * TC * DT;          // the planes' rows, in order
  static constexpr int kOutElems = Step::kOut * TC * DT;           // one buffer
  static constexpr size_t kSmem = (S * kStageElems + 2 * kOutElems) * sizeof(Tx);
  static_assert(DT % 32 == 0 && S >= 2 && kCopy % 32 == 0, "tile geometry");
  static_assert(Step::kIn <= 4 && Step::kOut <= 2 && Step::kInit <= Step::kCarry &&
                Step::kCarry <= 2, "step policy");
};

template <typename Step, typename Tx, int VB>
__global__ void __launch_bounds__(Ring<Step, Tx>::kThreads)
ring_scan_kernel(const Tx* __restrict__ x0, const Tx* __restrict__ x1,
                 const Tx* __restrict__ x2, const Tx* __restrict__ x3,
                 const float* __restrict__ c0, const float* __restrict__ c1,
                 Tx* __restrict__ y0, Tx* __restrict__ y1, int T, int D) {
  using P = Ring<Step, Tx>;
  constexpr int DT = P::DT, TC = P::TC, S = P::S, NI = Step::kIn, NO = Step::kOut;
  extern __shared__ __align__(16) unsigned char smem[];
  Tx* stages = reinterpret_cast<Tx*>(smem);
  Tx* outs = stages + S * P::kStageElems;

  const int bi = blockIdx.y;
  const int d0 = blockIdx.x * DT;
  const int nT = (T + TC - 1) / TC;
  const bool walker = threadIdx.x < P::kWalk;
  const int ct = threadIdx.x - P::kWalk;                   // copy thread index
  const size_t base = static_cast<size_t>(bi) * T * D;
  const Tx* const in[4] = {x0 + base, x1 + base, NI > 2 ? x2 + base : nullptr,
                           NI > 3 ? x3 + base : nullptr};
  Tx* const out[2] = {y0 + base, NO > 1 ? y1 + base : nullptr};
  // the walker's carries, from c0 and c1 (0 for columns past D) or from 0;
  // written out here: read through a helper lambda, nvcc scheduled K5a's
  // kernel otherwise than in its one-kernel form
  float c[Step::kCarry];
  if constexpr (Step::kInit > 0) {
    c[0] = walker && d0 + static_cast<int>(threadIdx.x) < D
               ? c0[static_cast<size_t>(bi) * D + d0 + threadIdx.x]
               : 0.0f;
  } else {
    c[0] = 0.0f;
  }
  if constexpr (Step::kInit > 1) {
    c[1] = walker && d0 + static_cast<int>(threadIdx.x) < D
               ? c1[static_cast<size_t>(bi) * D + d0 + threadIdx.x]
               : 0.0f;
  } else if constexpr (Step::kCarry > 1) {
    c[1] = 0.0f;
  }
  // the first step of the time tile that phase j visits
  auto tile_t0 = [&](int j) { return (Step::kReverse ? nT - 1 - j : j) * TC; };

  auto load = [&](int j) {                                 // copy threads: tile j's planes
    if (j < nT) {
      const int t0 = tile_t0(j);
      if constexpr (NI == 2) {
        // one pass over both planes' rows, a row's plane by one compare
        copy_rows<Tx, DT, VB>(
            stages + (j % S) * P::kStageElems, 2 * TC,
            [&](int r) -> const Tx* {
              const int t = t0 + (r < TC ? r : r - TC);
              return t < T ? (r < TC ? in[0] : in[1]) + static_cast<size_t>(t) * D : nullptr;
            },
            d0, D, x0, ct, P::kCopy);
      } else {
        // a pass a plane: a select among more planes in the copy loop costs
        // the copy warps' issue more than the passes do
#pragma unroll
        for (int i = 0; i < NI; ++i)
          copy_rows<Tx, DT, VB>(
              stages + (j % S) * P::kStageElems + i * TC * DT, TC,
              [&](int r) -> const Tx* {
                return t0 + r < T ? in[i] + static_cast<size_t>(t0 + r) * D : nullptr;
              },
              d0, D, x0, ct, P::kCopy);
      }
    }
    cp_async_commit();
  };

  if (!walker)
    for (int j = 0; j < S - 1; ++j) load(j);

  // Phase j: the walkers walk tile j; the copy warps start tile j+S-1's loads
  // and store tile j-1's outputs.
  for (int j = 0; j <= nT; ++j) {
    if (!walker) cp_async_wait<S - 2>();                   // tile j has landed
    __syncthreads();
    if (walker) {
      if (j < nT) {
        const Tx* src = stages + (j % S) * P::kStageElems + threadIdx.x;
        Tx* o = outs + (j & 1) * P::kOutElems + threadIdx.x;
#pragma unroll
        for (int u = 0; u < TC; ++u) {                      // steps past T: never stored
          const int t = Step::kReverse ? TC - 1 - u : u;
          float y[NO];
          Step::step([&](int i) { return to_f32(src[(i * TC + t) * DT]); }, c, y);
#pragma unroll
          for (int i = 0; i < NO; ++i) store(o + (i * TC + t) * DT, y[i]);
        }
      }
    } else {
      load(j + S - 1);                                     // into the stage tile j-1 used
      if (j >= 1) {
        const int t0 = tile_t0(j - 1);
#pragma unroll
        for (int i = 0; i < NO; ++i)                       // a pass a plane
          store_rows<Tx, DT, VB>(
              outs + ((j - 1) & 1) * P::kOutElems + i * TC * DT, TC,
              [&](int r) -> Tx* {
                return t0 + r < T ? out[i] + static_cast<size_t>(t0 + r) * D : nullptr;
              },
              d0, D, ct, P::kCopy);
      }
    }
  }
}

// The planes of one ring scan over (B, T, D): up to four inputs and two
// outputs, all of one dtype, and the (B, D) f32 first values of up to two
// carries; null where the step has fewer.
struct ScanPlanes {
  const void* in[4];
  const float* init[2];
  void* out[2];
};

template <typename Step, typename Tx, int VB>
int launch_ring_scan_vb(const ScanPlanes& p, int B, int T, int D, cudaStream_t stream) {
  using P = Ring<Step, Tx>;
  auto kernel = ring_scan_kernel<Step, Tx, VB>;
  if constexpr (P::kSmem > 48 * 1024) {
    const cudaError_t err = allow_smem(kernel, P::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return for_each_batch_slice(B, [&](int b0, int nb) {
    const size_t plane = static_cast<size_t>(b0) * T * D, row = static_cast<size_t>(b0) * D;
    auto x = [&](int i) { return p.in[i] ? static_cast<const Tx*>(p.in[i]) + plane : nullptr; };
    auto y = [&](int i) { return p.out[i] ? static_cast<Tx*>(p.out[i]) + plane : nullptr; };
    auto c = [&](int i) { return p.init[i] ? p.init[i] + row : nullptr; };
    const dim3 grid((D + P::DT - 1) / P::DT, nb);
    kernel<<<grid, P::kThreads, P::kSmem, stream>>>(x(0), x(1), x(2), x(3), c(0), c(1), y(0),
                                                    y(1), T, D);
    return static_cast<int>(cudaGetLastError());
  });
}

// Launch the ring scan of `Step` with the widest copy unit that every
// plane's rows allow.  Returns the cudaError_t of the first launch that
// failed (0 if none).
template <typename Step, typename Tx>
int launch_ring_scan(const ScanPlanes& p, int B, int T, int D, cudaStream_t stream) {
  switch (copy_unit_bytes(sizeof(Tx), D, {p.in[0], p.in[1], p.in[2], p.in[3], p.out[0],
                                          p.out[1]})) {
    case 16: return launch_ring_scan_vb<Step, Tx, 16>(p, B, T, D, stream);
    case 8: return launch_ring_scan_vb<Step, Tx, 8>(p, B, T, D, stream);
    case 4: return launch_ring_scan_vb<Step, Tx, 4>(p, B, T, D, stream);
    default:
      if constexpr (sizeof(Tx) == 2) return launch_ring_scan_vb<Step, Tx, 2>(p, B, T, D, stream);
      return static_cast<int>(cudaErrorMisalignedAddress);
  }
}

}  // namespace lucy_tile
