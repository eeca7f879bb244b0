// Warp-level tensor-core fragments (mma.sync) for Hopper (sm_90a), shared by
// the RNN-T joint's backward (rnnt_joint_core.cuh) and the mLSTM backward
// (mlstm_fused.cu): the fragment layouts, the 3xTF32 split, the tf32 and bf16
// products, ldmatrix and 16-byte cp.async.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Fragments of a warp's 16 x 8 tile, lane = 4*gq + tq (gq = lane / 4, tq = lane % 4):
//   C (f32, both):     c[e] at row gq + 8*(e/2), column 2*tq + e%2
//   tf32 m16n8k8:      A a[e] at row gq + 8*(e%2), k = tq + 4*(e/2); B b[e] at k = tq + 4*e, n = gq
//   bf16 m16n8k16:     A reg r holds row gq + 8*(r%2), k = 2*tq + 8*(r/2) and the next k;
//                      B reg r holds k = 2*tq + 8*r and the next k, n = gq
// f32 inputs take three tf32 products (3xTF32): x = hi + lo with hi = rna_tf32(x)
// and lo = rna_tf32(x - hi); a*b ~ hi_a*hi_b + hi_a*lo_b + lo_a*hi_b, the dropped
// lo_a*lo_b and lo's rounding are ~2^-22 of |a*b|.  bf16 inputs round each
// operand to bf16 once, as the contract asks; a bf16 product is exact in f32.

struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ Split split_tf32(float x) {
  const uint32_t hi = tf32_bits(x);
  return Split{hi, tf32_bits(x - __uint_as_float(hi))};
}

// bf16(x0) in the low half, bf16(x1) in the high half (round to nearest even)
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void mma_tf32(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a*b in 3xTF32: the small terms first
__device__ __forceinline__ void mma_3xtf32(float c[4], const Split a[4], const Split b[2]) {
  mma_tf32(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ldmatrix: four 8 x 8 tiles of 16-bit values from shared memory, lane t
// giving the address of row t % 8 of tile t / 8 (16 bytes, 16-byte aligned).
// Register i gets tile i's (row gq, columns 2tq, 2tq+1); with .trans its
// (rows 2tq, 2tq+1, column gq).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// One 16-byte asynchronous copy global -> shared (both 16-byte aligned)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}

}  // namespace
