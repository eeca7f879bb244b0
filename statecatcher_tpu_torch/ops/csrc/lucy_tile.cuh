// Shared pieces of the fused LucyRNN cell kernels K1 (lucy_fused_lm_fwd.cu)
// and K2 (lucy_fused_lm_bwd.cu): the element helpers, the cp.async ring's
// copies of row tiles into shared memory, the 16-byte stores out of it, and
// the launch-time choice of the copy width.
//
// Both kernels give a block one batch row b and a tile of DT columns, and
// walk time in tiles of TC steps.  A tile's rows (one gate plane, one
// cotangent plane, ... at one step) are DT contiguous elements in device
// memory; in shared memory they are stored row after row, DT elements each.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace lucy_tile {

constexpr float kEps = 1e-6f;

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

}  // namespace lucy_tile
