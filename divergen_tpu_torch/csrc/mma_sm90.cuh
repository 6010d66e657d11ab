// Warp-level building blocks shared by the port's kernels: cp.async copies,
// ldmatrix loads, the bf16 m16n8k16 tensor-core product (mma.sync), and the
// float32 bodies' TF32 split and m16n8k8 tf32 product, with the register
// layouts the PTX ISA documents for them. For one warp, with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major) a[0..3]: (row g,   cols 2t..2t+1), (row g+8, cols 2t..),
//                                   (row g,   cols 2t+8..),   (row g+8, cols 2t+8..)
//   B (16 x 8, k x n)      b[0..1]: (k 2t..2t+1, col g), (k 2t+8..2t+9, col g)
//   C (16 x 8, f32)        c[0..3]: (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1)
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dg {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses L1; when !valid it writes zeros
// and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16 bf16) * b (16x8 bf16), f32 accumulate
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- float32-accurate products on the TF32 tensor cores ("3xTF32")
//
// x = big + small with big = tf32(x) and small = tf32(x - big), both rounded
// to nearest, ties away (cvt.rna; a mask of the low 13 bits would truncate);
// x - big is exact in f32. a b ~ a_small b_big + a_big b_small + a_big b_big
// (three products, the small terms first) leaves out a_small b_small and the
// rounding of small, each about 2^-21 relative to a b: float32's own order
// (ops/tf32x3.py emulates it on the CPU). The tensor core's own accumulation
// truncates, so a long sum is kept in f32 registers a few products at a time.
// m16n8k8 tf32 fragments, g = lane / 4, t = lane % 4:
//   A (16 x 8) a[0..3]: (row g, col t), (row g+8, col t), (row g, col t+4), (row g+8, col t+4)
//   B (8 x 8, k x n) b0, b1: (k t, col g), (k t+4, col g)
//   C (16 x 8, f32)  c[0..3]: as the bf16 product's

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x -> (big, small) as tf32 bit patterns
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// c += a b, one tf32 pass (not volatile: the compiler may interleave
// independent products)
__device__ __forceinline__ void mma_tf32_1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, `lo` in the low half (lower column)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace dg
