// Hopper's asynchronous building blocks, shared by the kernels built on TMA
// and wgmma (int8_matmul.cu, flash_attention_sm90.cu, flash_attention_d512.cu,
// flash_attention_relpos_sm90.cu, gn_conv.cu): mbarriers, TMA tile loads,
// named barriers, the shared-memory descriptors of a tile under the 128- and
// 32-byte swizzles, the wgmma fence / commit / wait, and, on the host, the
// lookup of libcuda's cuTensorMapEncodeTiled (PTX ISA 8.0, sm_90a).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is not linked)
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"  // dg::smem_addr

namespace dg {

// ---- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrive, and expect `bytes` more of TMA transactions in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- named barriers (id 0 is __syncthreads'): `threads` arrivals complete a phase

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- TMA: the box of `map` at the given coordinates (c0 the innermost) into
// dst; completion is counted on `bar` in bytes

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// ---- wgmma

// Descriptor of a tile of 128-byte rows under the 128-byte swizzle (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B), starting on a 1024-byte boundary: start
// address >> 4, leading byte offset `lbo`, stride byte offset 1024 (eight
// rows, one swizzle atom) between groups of 8 rows along the strided
// dimension, layout 1 (128-byte swizzle); offsets in 16-byte units.
//   * K-major operand (K contiguous in the row): `lbo` is unused; the k-th
//     32-byte step of K inside the row is the start address + 32 k (+2 k).
//   * MN-major operand (M or N contiguous in the row, 64 bf16 = one swizzle
//     atom): the rows run along K; `lbo` would step to the next 64-wide atom
//     of M or N; a step of 16 rows of K is the start address + 2048 (+128).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile, uint32_t lbo = 1) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3ffff) >> 4) | (static_cast<uint64_t>(lbo & 0x3fff) << 16) |
         (64ull << 32) | (1ull << 62);
}

// The same under the 32-byte swizzle (CU_TENSOR_MAP_SWIZZLE_32B): rows of
// 32 bytes (16 bf16), eight rows (256 bytes, one swizzle atom) between
// groups of 8 rows along the strided dimension, the tile on a 256-byte
// boundary. K-major: one k-step of 16 is the whole row. MN-major (16 of M or
// N in the row, the rows along K): a step of 16 rows of K is the start
// address + 512 (+32).
__device__ __forceinline__ uint64_t sw32_desc(const void* tile, uint32_t lbo = 1) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3ffff) >> 4) | (static_cast<uint64_t>(lbo & 0x3fff) << 16) |
         (16ull << 32) | (3ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma reads or writes across its issue or its wait
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- host: the tensor-map encoder, looked up at run time (no -lcuda)

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or null where libcuda lacks it
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

}  // namespace dg
