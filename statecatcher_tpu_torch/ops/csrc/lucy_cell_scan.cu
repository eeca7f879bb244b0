// LucyRNN cell forwards for Hopper (sm_90a): the fused masked cell (K12) and
// the dual scan (K11).
//
// Replaces two TPU kernels of statecatcher_tpu/ops/lucy_pallas.py:
//   K12  lucy_tile::cell_fwd_kernel<MaskedCellChain<masked>>
//                               <- _fused_cell_kernel (:319), launched by
//                                  _fused_cell_fwd_impl (:390)
//   K11  lucy_tile::ring_scan_kernel<DualScan>
//                               <- _dual_scan_kernel (:527), launched by
//                                  _dual_scan_fwd_impl (:568)
//
//   K12:  gates (B, T, 7, D) f32 or bf16, the bias already added by the
//         caller (in the gates' dtype), order r, z, k, v, h_pre, decay,
//         alpha; h0, s0 (B, D) f32 (the wrapper casts); an optional frame
//         mask (B, T) of bytes, 0 or 1  ->  h_all, s_all (B, T, D) in the
//         gates' dtype.  The gate chain in f32, in the sqrt/divide form of
//         ops/lucy_gates.py (the plain version), eps 1e-6:
//           z_n = sigmoid(z / sqrt((r^2+z^2)/2+eps))   decay_n, alpha_n likewise
//           kv  = (k/rms_kv)(v/rms_kv) / (rms_kv^2+eps)  h_pre_n = h_pre/sqrt(h_pre^2+eps)
//           a_s = decay_n, b_s = alpha_n*kv, a_h = z_n, bh_c = 1 - z_n
//         A mask value m turns them into m*a + (1-m) and m*b (the identity
//         map where m = 0), written as that arithmetic so that a NaN gate
//         propagates as in the plain version.  Then
//           s_t = a_s*s_{t-1} + b_s;  c = tanh(h_pre_n + s_t);
//           h_t = a_h*h_{t-1} + bh_c*c
//   K11:  a_s, b_s, a_h, h_pre_n (B, T, D) in one dtype, f32 or bf16; h0, s0
//         (B, D) f32  ->  h_all, s_all (B, T, D) in that dtype:
//           s_t = a_s*s_{t-1} + b_s;  c = tanh(h_pre_n + s_t);
//           h_t = a_h*h_{t-1} + (1 - a_h)*c
//         (the mask, if any, is already in the coefficients: a masked step
//         has a_h = 1, so its offset (1 - a_h)*c is 0.)
// Both carry s and h in f32 and round only what they write.  Every product,
// sum and quotient is rounded on its own (no fused multiply-add), in the
// order of the plain versions (ops/lucy_gates.py, ops/scan.py:
// linear_scan_seq), and sqrt, exp and tanh are the library's, as PyTorch's
// CUDA kernels call them: on the card the kernels and the plain versions
// agree bit for bit in f32.
//
// Bound on the card: bytes.  K12 reads 7 planes and writes 2 (the mask is
// B*T bytes): 9*B*T*D elements, 942.5 MB at B=32, T=1598, D=512 in f32,
// 0.281 ms at 3.35 TB/s (0.141 ms bf16), against ~51 operations per element
// (0.020 ms at 67 TFLOP/s).  K11 reads 4 planes and writes 2: 628.3 MB, 0.188
// ms f32 (0.094 ms bf16), against ~8 operations per element.
//
// K12's design: K1's schedule, the cell forward of lucy_tile.cuh
// (`cell_fwd_kernel`).  A block owns one batch row and 64 columns and walks
// time in tiles of 12 steps through a 3-stage cp.async ring of the 7 gate
// planes and the tile's 12 mask values; 12 chain warps turn tile j's gates
// into the four coefficients (a_s, b_s, a_h, h_pre_n), the mask folded in,
// while one thread a column walks tile j-1 (the two steps and the tanh, h
// and s in registers) and the chain warps store tile j-2's h and s with
// 16-byte stores.  Its chain differs from K1's in three ways: no bias input
// (the caller has added it), every operation rounded as written (K1 lets
// nvcc contract), and the optional mask.  The h step's offset is (1 - a_h)*c:
// with m in {0, 1}, 1 - (m*z_n + (1-m)) is m*(1 - z_n), bit for bit and NaN
// for NaN, so four coefficients carry the masked step too.  What bounds it:
// instructions, as K1: the chain's IEEE sqrt and divides, ~250 instructions
// an element, all of the tile's elements in parallel on 12 warps.
//
// K11's design: K5a's, lucy_tile.cuh's ring scan (`ring_scan_kernel`) with
// four planes in and two out.  A block owns one batch row and DT columns (one
// 128-byte line of a row: 32 in f32, 64 in bf16) and walks time in tiles of
// TC = 32 steps through an S = 4 stage ring: four copy warps fill it by
// cp.async 3 tiles ahead (3 x 16 KB in flight a block), a pass a plane, and
// store the tile walked in the phase before (h rows, then s rows) with
// 16-byte stores; one thread a column walks the tile that has landed, h and s
// in registers (the step of K12, MaskedCellChain::step).  80 KB of shared
// memory a block, two blocks an SM (~96 KB in flight): at B=32, D=512 the 512
// blocks (f32; 256 in bf16) take two waves, and still beat tiles of 16 steps
// (40 KB, one wave, the same bytes in flight) by 6-8 % in f32 and 2-4 % in
// bf16: half the phases and barriers for the same bytes.  One pass over all
// four planes' rows, a row's plane picked by compares, cost ~4 % more than a
// pass a plane.  What bounds it: the copies, as K5a: without the walk it is
// no faster in f32 and ~3 % faster in bf16; 3 stages, 2 or 8 copy warps, or
// 32 columns a block in bf16 were slower (tools/lucy_cell_variants.py).  The
// TPU kernel's time chunks of 256 rows, its Hillis-Steele composition of each
// chunk, its 128-lane padding of D and the identity rows of its ragged tail
// are TPU tiling and are not carried over: rows >= T are loaded as zeros and
// never stored.

#include "lucy_tile.cuh"

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sigmoid_rn(float x) { return div(1.0f, add(1.0f, expf(-x))); }

// s <- a*s + b, the product and the sum each rounded once
__device__ __forceinline__ float scan_step(float a, float s, float b) { return add(mul(a, s), b); }

// K12's chain: (a_s, b_s, a_h, h_pre_n), the mask folded in as the plain
// version does (ops/lucy_gates.py), every operation rounded on its own.
template <bool kMask>
struct MaskedCellChain {
  static constexpr bool kBias = false;
  static constexpr bool kMasked = kMask;

  __device__ static __forceinline__ void coefs(const float (&x)[7], float m, float (&c)[4]) {
    constexpr float kEps = lucy_tile::kEps;
    const float r = x[0], z = x[1], kk = x[2], v = x[3];
    const float h_pre = x[4], decay = x[5], alpha = x[6];
    const float rms_rz = sqrtf(add(div(add(mul(r, r), mul(z, z)), 2.0f), kEps));
    const float rms_kv2 = add(div(add(mul(kk, kk), mul(v, v)), 2.0f), kEps);
    const float rms_kv = sqrtf(rms_kv2);
    const float z_n = sigmoid_rn(div(z, rms_rz));
    const float decay_n = sigmoid_rn(div(decay, sqrtf(add(mul(decay, decay), kEps))));
    const float alpha_n = sigmoid_rn(div(alpha, sqrtf(add(mul(alpha, alpha), kEps))));
    const float h_pre_n = div(h_pre, sqrtf(add(mul(h_pre, h_pre), kEps)));
    const float kv = div(mul(div(kk, rms_kv), div(v, rms_kv)), add(rms_kv2, kEps));
    float a_s = decay_n, b_s = mul(alpha_n, kv), a_h = z_n;
    if constexpr (kMask) {
      a_s = add(mul(m, a_s), 1.0f - m);
      b_s = mul(m, b_s);
      a_h = add(mul(m, a_h), 1.0f - m);
    }
    c[0] = a_s;
    c[1] = b_s;
    c[2] = a_h;
    c[3] = h_pre_n;
  }

  __device__ static __forceinline__ void step(float a_s, float b_s, float a_h, float h_pre_n,
                                              float& s, float& h) {
    s = scan_step(a_s, s, b_s);
    const float c = tanhf(add(h_pre_n, s));
    h = scan_step(a_h, h, mul(1.0f - a_h, c));
  }
};

// K11's step: the (unmasked) cell step on the planes a_s, b_s, a_h, h_pre_n,
// s (c[0]) from s0, h (c[1]) from h0; outputs h, then s.
template <typename P>
struct DualScan {
  static constexpr int DT = 128 / static_cast<int>(sizeof(P));  // columns per block
  static constexpr int TC = 32;                                   // steps per tile
  static constexpr int S = 4;                                     // ring stages
  static constexpr int kCopy = 128;                               // four copy warps
  static constexpr int kIn = 4, kOut = 2, kCarry = 2, kInit = 2;
  static constexpr bool kReverse = false;
  template <typename X>
  __device__ static __forceinline__ void step(X x, float (&c)[2], float (&y)[2]) {
    MaskedCellChain<false>::step(x(0), x(1), x(2), x(3), c[0], c[1]);
    y[0] = c[1];
    y[1] = c[0];
  }
};

template <bool kMask, typename G>
int launch_cell(const void* gates, const unsigned char* mask, const float* h0, const float* s0,
                void* h_all, void* s_all, int B, int T, int D, cudaStream_t st) {
  return lucy_tile::launch_cell_fwd<MaskedCellChain<kMask>, G>(gates, nullptr, mask, h0, s0,
                                                               h_all, s_all, B, T, D, st);
}

}  // namespace

// Each returns the cudaError_t of its first failed launch (0 on success);
// the caller raises on non-zero.  dtype 0 is float32, 1 bfloat16 (the gates
// or planes and the outputs).  ``mask`` may be null (no frame mask).  Any B:
// the launches walk the batch in slices of the grid's 65535 rows.
extern "C" int lucy_fused_cell_fwd(int dtype, const void* gates, const unsigned char* mask,
                                   const float* h0, const float* s0, void* h_all, void* s_all,
                                   int B, int T, int D, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mask != nullptr ? launch_cell<true, float>(gates, mask, h0, s0, h_all, s_all, B, T, D, st)
                           : launch_cell<false, float>(gates, mask, h0, s0, h_all, s_all, B, T, D,
                                                       st);
  if (dtype == 1)
    return mask != nullptr
               ? launch_cell<true, __nv_bfloat16>(gates, mask, h0, s0, h_all, s_all, B, T, D, st)
               : launch_cell<false, __nv_bfloat16>(gates, mask, h0, s0, h_all, s_all, B, T, D,
                                                   st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int lucy_dual_scan_fwd(int dtype, const void* a_s, const void* b_s, const void* a_h,
                                  const void* h_pre, const float* h0, const float* s0,
                                  void* h_all, void* s_all, int B, int T, int D, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const lucy_tile::ScanPlanes p{{a_s, b_s, a_h, h_pre}, {s0, h0}, {h_all, s_all}};
  if (dtype == 0) return lucy_tile::launch_ring_scan<DualScan<float>, float>(p, B, T, D, st);
  if (dtype == 1)
    return lucy_tile::launch_ring_scan<DualScan<__nv_bfloat16>, __nv_bfloat16>(p, B, T, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
