// W8A8 GEMM with a dequantization epilogue, for Hopper (sm_90a): int8 x int8
// products on the tensor cores into int32, then
//     out[r, c] = (float(acc[r, c]) * x_scale[r]) * w_scale[c]
// written as bf16 or f32.
//
// Replaces the two Pallas TPU kernels of divergen_tpu/ops/pallas/int8_matmul.py:
//   * int8_matmul_pallas (_kernel): x already quantized (int8 (M, K) and a
//     per-row f32 scale, from ops/quant.py:quantize_act): int8_gemm_kernel;
//   * int8_matmul_fused_quant (_kernel_fq): bf16 or f32 x, quantized per row
//     with the TPU kernel's own scale max(absmax, 1e-12) / 127, a true
//     division, round half to even and a clip to +-127 (which differs from
//     quantize_act's max(absmax / 127, 1e-12) for rows whose absmax is below
//     1.27e-10): quantize_rows_kernel, then the same int8_gemm_kernel.
// The int32 sums are exact, so the result equals the plain version's bit for
// bit: the same int8 operands, the same f32 products in the same order, the
// same rounding to the output type.
//
// What bounds it on the H100: operations. At the SDXL UNet's shapes (M 4096
// or 16384 tokens, K 640..5120, N 640..10240) a GEMM does 2MKN int8
// operations on a few tens of MB, thousands of operations per byte, far over
// the card's 590 per byte at 1979 TOPS, so the tensor cores are the limit and
// the int32 accumulator must never reach device memory.
//
// Why the quantization is a pass of its own: the TPU kernel quantizes x in
// the GEMM because its block holds the whole K extent in VMEM and its grid
// runs in order on one core, so each row is quantized once and x makes one
// trip from HBM. Here the blocks are independent and each output tile of
// BN columns would quantize its 128 rows again: at ff_geglu (N 10240) every
// row 40 times, 40 absmax passes over x and 40x the true divisions. The pass
// moves 3 bytes per bf16 element (about 5 us at ff_geglu at 3.35 TB/s); the
// redundancy it removes cost most of a millisecond. One warp per row: the
// absmax by a shuffle reduction, the scale by __fdiv_rn, then each element
// quantized once (a product with the reciprocal where that provably rounds as
// the true quotient does, the true division elsewhere: quant_byte; a true
// division per element made the pass 1.34x slower at K 640 and 1.14x at K
// 1280) into an int8 (M, K) and an f32 (M,) scratch the wrapper allocates.
//
// The GEMM: a persistent grid of one block per SM (the wrapper picks the
// block count and the tile width BN, ops/int8_matmul.py:gemm_plan) walks the
// 128 x BN output tiles, row tiles fastest, so the blocks in flight share a
// band of the weight. Three warpgroups: one producer, whose one thread keeps
// TMA loads of 128 x 128-byte x tiles and BN x 128-byte weight tiles in flight
// through a ring of shared-memory stages (mbarriers: "full" when a stage's
// bytes have landed, "empty" when its consumer is done with it), and two
// consumer warpgroups that take the block's tiles in turn ("ping-pong"): each
// issues wgmma.mma_async m64nBNk32.s32.s8.s8 for the two 64-row halves of its
// tile on the stages as they arrive, one commit group in flight, the s32
// accumulators in registers (BN a thread), then dequantizes them in registers
// and stores bf16 or f32 straight to device memory, masked at the M and N
// tails, while the other warpgroup's products keep the tensor cores busy (with
// one tile shared by both warpgroups the tensor cores stood idle during every
// epilogue). Before the stores, lanes trade sums within their quad so that
// each holds 8 adjacent columns: a warp writes whole 32-byte sectors, 16 bytes
// a lane (32 in f32). Both operands are K-major (x (M, K), the weight (N, K)), the only
// layout wgmma takes for 8-bit types, and TMA's 128-byte swizzle lays them out
// as the descriptors read them. setmaxnreg moves registers from the producer
// to the consumers. TMA zero-fills reads past M, N and K, so any M and N work
// and any K that is a multiple of 16 (TMA's 16-byte row strides). The tensor
// maps are encoded on the host by libcuda's cuTensorMapEncodeTiled (its
// entry point looked up at run time: no -lcuda) on every call: a cache of
// them saved no host time that showed (under 0.1 ms an int8 UNet call).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_moments.cuh"  // dg::load_vec, dg::store_pair, dg::store_one
#include "mma_sm90.cuh"    // dg::smem_addr
#include "sm90_async.cuh"  // mbarriers, TMA, the swizzled descriptor, wgmma fences

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;                    // output rows per tile
constexpr int kBK = 128;                    // K bytes per stage: one 128-byte swizzle row
constexpr int kConsumers = 2;               // warpgroups, each on tiles of its own
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kStages = 6;                  // shared-memory ring depth
constexpr int kQuantRows = 8;               // rows per block of the quantize pass (one a warp)

template <int BN>
struct Tile {
  static_assert(BN % 32 == 0 && BN <= 160, "wgmma N; two accumulators of BN / 2 registers");
  static constexpr int kBytesA = kBM * kBK;
  static constexpr int kBytesB = BN * kBK;
  static constexpr int kStage = kBytesA + kBytesB;
  static constexpr int kSmem = kStages * kStage + 1024;  // + slack to align the ring to 1024
  static_assert(kBytesA % 1024 == 0 && kBytesB % 1024 == 0, "swizzle atoms stay aligned");
  static_assert(kSmem + 256 <= 232448, "the ring and the barriers fit in a block's 227 KB");
};

struct GemmArgs {
  const float* xs;  // (m,) f32 row scales
  const float* ws;  // (n,) f32 column scales
  void* out;        // (m, n) TO
  int m, n, k;
  int tiles_m, tiles;
};

// one int8 of round-half-even(fl(v / s)) clipped to +-127, as a byte, where
// fl(v / s) is the correctly rounded quotient. With r = fl(1 / s), fl(v r)
// lies within 3 * 2^-24 |v / s| of fl(v / s); since |v / s| <= 127 (1 + 2^-24),
// the two round to the same integer unless fl(v r) is within 2.3e-5 of a
// half-integer, and only then (ties included) is the quotient computed by a
// true division.
__device__ __forceinline__ uint32_t quant_byte(float v, float s, float r) {
  float q = __fmul_rn(v, r);
  if (fabsf(q - rintf(q)) > 0.4999f) q = __fdiv_rn(v, s);
  q = fminf(fmaxf(rintf(q), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

// x (m, k) TX -> xq (m, k) int8 and xs (m,) f32, one warp per row; k % 8 == 0
template <typename TX>
__global__ void __launch_bounds__(32 * kQuantRows) quantize_rows_kernel(
    const TX* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs, int m, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kQuantRows + (threadIdx.x >> 5);
  if (row >= m) return;
  const TX* xr = x + static_cast<int64_t>(row) * k;
  float amax = 0.f;
#pragma unroll 4
  for (int c = lane * 8; c < k; c += 256) {
    float v[8];
    dg::load_vec<8>(xr + c, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
  const float r = __frcp_rn(s);
  if (lane == 0) xs[row] = s;
  int8_t* qr = xq + static_cast<int64_t>(row) * k;
#pragma unroll 4
  for (int c = lane * 8; c < k; c += 256) {
    float v[8];
    dg::load_vec<8>(xr + c, v);
    uint32_t word[2];
#pragma unroll
    for (int w = 0; w < 2; ++w)
      word[w] = quant_byte(v[4 * w], s, r) | (quant_byte(v[4 * w + 1], s, r) << 8) |
                (quant_byte(v[4 * w + 2], s, r) << 16) | (quant_byte(v[4 * w + 3], s, r) << 24);
    *reinterpret_cast<uint2*>(qr + c) = make_uint2(word[0], word[1]);
  }
}

// 8 adjacent outputs, 16-byte aligned: 16 bytes of bf16 or 32 of f32
__device__ __forceinline__ void store8(bf16* p, const float (&y)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(dg::pack_bf16x2(y[0], y[1]), dg::pack_bf16x2(y[2], y[3]),
                 dg::pack_bf16x2(y[4], y[5]), dg::pack_bf16x2(y[6], y[7]));
}
__device__ __forceinline__ void store8(float* p, const float (&y)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(y[4], y[5], y[6], y[7]);
}

// d (64 x N s32, the warpgroup's accumulator fragment) += A (64 x 32 s8, K-major,
// descriptor a) * B (N x 32 s8, K-major, descriptor b)^T; scale_d = 0: d = A B^T.
// Fragment: thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 + {0, 8},
// columns 8 j + 2 (t % 4) + {0, 1}, as d[4 j + {0, 1}] (row +0), d[4 j + {2, 3}] (row +8).
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);

#define DG_R8(i)                                                                          \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : DG_R8(0), DG_R8(8), DG_R8(16), DG_R8(24), DG_R8(32), DG_R8(40), DG_R8(48),
        DG_R8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<160>(int (&d)[80], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p;\n}\n"
      : DG_R8(0), DG_R8(8), DG_R8(16), DG_R8(24), DG_R8(32), DG_R8(40), DG_R8(48),
        DG_R8(56), DG_R8(64), DG_R8(72)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef DG_R8

template <int BN, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w, const GemmArgs a) {
  typedef Tile<BN> T;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], turn[kConsumers];
  // the ring starts on a 1024-byte boundary of the shared window (the swizzle's atom)
  unsigned char* ring = smem_raw + ((1024 - (dg::smem_addr(smem_raw) & 1023)) & 1023);
  auto tile_x = [&](int st) { return ring + st * T::kStage; };
  auto tile_w = [&](int st) { return ring + st * T::kStage + T::kBytesA; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      dg::mbar_init(&full[s], 1);
      dg::mbar_init(&empty[s], 1);  // released by the one consumer that owns the tile
    }
    for (int c = 0; c < kConsumers; ++c) dg::mbar_init(&turn[c], 1);
    dg::mbar_init_fence();
  }
  __syncthreads();

  // the block's j-th tile is t = blockIdx.x + j * gridDim.x; its k-th stage of
  // K is the (j * n_k + k)-th use of the ring
  const int n_k = (a.k + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every load; the warpgroup gives up registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
        const int m0 = (t % a.tiles_m) * kBM;
        const int n0 = (t / a.tiles_m) * BN;
        for (int kt = 0; kt < n_k; ++kt) {
          dg::mbar_wait(&empty[stage], phase ^ 1);  // the first pass over the ring does not wait
          dg::mbar_arrive_expect_tx(&full[stage], T::kStage);
          dg::tma_load_2d(tile_x(stage), &map_x, &full[stage], kt * kBK, m0);
          dg::tma_load_2d(tile_w(stage), &map_w, &full[stage], kt * kBK, n0);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // consumer c = wg - 1 takes the block's tiles j = c, c + 2, ...: while one
    // dequantizes and stores a tile, the other's products keep the tensor cores
    // busy. Their K loops take turns (turn[c]: the other has passed its last
    // wait on the ring), so that no consumer waits on a stage more than one
    // pass of the ring ahead of the loads, where a phase parity would alias.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid & 31;
    int acc[2][BN / 2];  // rows 0..63 and 64..127 of the tile
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[0][i] = acc[1][i] = 0;  // each tile overwrites them
    for (int j = c, t = blockIdx.x + j * gridDim.x; t < a.tiles;
         j += kConsumers, t += kConsumers * gridDim.x) {
      const int m0 = (t % a.tiles_m) * kBM;
      const int n0 = (t / a.tiles_m) * BN;
      if (j > 0) dg::mbar_wait(&turn[c], ((j - 1) / kConsumers) & 1);
      int held = -1;  // the stage read by the commit group still in flight
      for (int kt = 0; kt < n_k; ++kt) {
        const int use = j * n_k + kt;
        const int stage = use % kStages;
        dg::mbar_wait(&full[stage], (use / kStages) & 1);
        const uint64_t da = dg::sw128_desc(tile_x(stage));
        const uint64_t db = dg::sw128_desc(tile_w(stage));
        dg::fence_regs(acc[0]);
        dg::fence_regs(acc[1]);
        dg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) {  // 32 bytes of K per instruction
          wgmma_s8<BN>(acc[0], da + 2 * kk, db + 2 * kk, (kt | kk) != 0);
          wgmma_s8<BN>(acc[1], da + (64 * kBK >> 4) + 2 * kk, db + 2 * kk, (kt | kk) != 0);
        }
        dg::wgmma_commit();
        dg::fence_regs(acc[0]);
        dg::fence_regs(acc[1]);
        dg::wgmma_wait<1>();  // the previous stage's products are done: release it
        if (held >= 0 && tid == 0) dg::mbar_arrive(&empty[held]);
        held = stage;
      }
      if (tid == 0) dg::mbar_arrive(&turn[1 - c]);
      dg::wgmma_wait<0>();
      dg::fence_regs(acc[0]);
      dg::fence_regs(acc[1]);
      if (tid == 0) dg::mbar_arrive(&empty[held]);

      // dequantize in registers: (float(acc) * x_scale[row]) * w_scale[col] -> TO.
      // Lane t of a quad holds columns 2 t, 2 t + 1 of each block of 8; two
      // exchanges (with lane t ^ 1, then t ^ 2) leave it all 8 columns of
      // block 4 q + t of each group of 4 blocks, so that each lane stores 16
      // bytes (bf16) or 32 (f32) and a warp whole 32-byte sectors.
      const int t4 = lane & 3;
      const bool o1 = t4 & 1, o2 = t4 & 2;
      // whole, aligned blocks of 8 columns: store8 writes all 8, in 16-byte stores
      const bool vec = a.n % 8 == 0;
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + 64 * half + (tid >> 5) * 16 + (lane >> 2) + 8 * h;
          const float xs = row < a.m ? a.xs[row] : 0.f;
          TO* orow = static_cast<TO*>(a.out) + static_cast<int64_t>(row) * a.n;
#pragma unroll
          for (int q = 0; q < BN / 32; ++q) {
            // with lane t ^ 1: 4 adjacent columns of blocks 4 q + o1 and 4 q + 2 + o1
            int s1[2][4];
#pragma unroll
            for (int pr = 0; pr < 2; ++pr) {
              const int l0 = acc[half][4 * (4 * q + 2 * pr) + 2 * h];
              const int l1 = acc[half][4 * (4 * q + 2 * pr) + 2 * h + 1];
              const int h0 = acc[half][4 * (4 * q + 2 * pr + 1) + 2 * h];
              const int h1 = acc[half][4 * (4 * q + 2 * pr + 1) + 2 * h + 1];
              const int r0 = __shfl_xor_sync(0xffffffffu, o1 ? l0 : h0, 1);
              const int r1 = __shfl_xor_sync(0xffffffffu, o1 ? l1 : h1, 1);
              s1[pr][0] = o1 ? r0 : l0;
              s1[pr][1] = o1 ? r1 : l1;
              s1[pr][2] = o1 ? h0 : r0;
              s1[pr][3] = o1 ? h1 : r1;
            }
            // with lane t ^ 2: the 8 columns of block 4 q + t
            int v[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = __shfl_xor_sync(0xffffffffu, o2 ? s1[0][i] : s1[1][i], 2);
              v[i] = o2 ? r : s1[0][i];
              v[4 + i] = o2 ? s1[1][i] : r;
            }
            const int col = n0 + 8 * (4 * q + t4);
            if (row >= a.m || col >= a.n) continue;
            float y[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              y[i] = col + i < a.n
                         ? __fmul_rn(__fmul_rn(__int2float_rn(v[i]), xs), __ldg(a.ws + col + i))
                         : 0.f;
            if (vec) {
              store8(orow + col, y);
            } else {
#pragma unroll
              for (int i = 0; i < 8; ++i)
                if (col + i < a.n) dg::store_one(orow + col + i, y[i]);
            }
          }
        }
    }
  }
}

// ---- host side: tensor maps

// the map of a row-major (rows, cols) int8 matrix read in boxes of box_rows x
// 128 bytes with the 128-byte swizzle, zeros past its edges; false if the
// encoder refuses it
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const dg::EncodeTiledFn encode = dg::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};  // bytes, of dimension 1
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, typename TO>
int launch_gemm(const CUtensorMap& map_x, const CUtensorMap& map_w, const GemmArgs& a, int ctas,
                cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_kernel<BN, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_gemm_kernel<BN, TO><<<ctas, kThreads, Tile<BN>::kSmem, stream>>>(map_x, map_w, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int launch_gemm_bn(const CUtensorMap& map_x, const CUtensorMap& map_w, const GemmArgs& a, int bn,
                   int ctas, cudaStream_t stream) {
  switch (bn) {
    case 160: return launch_gemm<160, TO>(map_x, map_w, a, ctas, stream);
    case 128: return launch_gemm<128, TO>(map_x, map_w, a, ctas, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (m, k) bf16 or, with x_f32, f32 -> xq (m, k) int8 and xs (m,) f32 with
// the fused kernel's row scale max(absmax, 1e-12) / 127; k a multiple of 16
extern "C" int dg_int8_quantize_rows(const void* x, void* xq, void* xs, int m, int k, int x_f32,
                                     void* stream) {
  if (m <= 0 || k <= 0 || k % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (m + kQuantRows - 1) / kQuantRows;
  int8_t* q = static_cast<int8_t*>(xq);
  float* sc = static_cast<float*>(xs);
  if (x_f32)
    quantize_rows_kernel<float><<<blocks, 32 * kQuantRows, 0, s>>>(static_cast<const float*>(x),
                                                                  q, sc, m, k);
  else
    quantize_rows_kernel<bf16><<<blocks, 32 * kQuantRows, 0, s>>>(static_cast<const bf16*>(x),
                                                                 q, sc, m, k);
  return static_cast<int>(cudaGetLastError());
}

// xq (m, k) int8, xs (m,) f32, wq (n, k) int8 (the transpose of w_q (k, n)),
// ws (n,) f32, out (m, n) bf16 or, with out_f32, f32; k a multiple of 16,
// xq and wq 16-byte aligned. bn (160 or 128) is the tile width and ctas
// the number of persistent blocks (ops/int8_matmul.py:gemm_plan).
extern "C" int dg_int8_matmul(const void* xq, const void* xs, const void* wq, const void* ws,
                              void* out, int m, int n, int k, int out_f32, int bn, int ctas,
                              void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 != 0 || ctas <= 0 ||
      (bn != 160 && bn != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w;
  if (!tensor_map(&map_x, xq, m, k, kBM) || !tensor_map(&map_w, wq, n, k, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  GemmArgs a{};
  a.xs = static_cast<const float*>(xs);
  a.ws = static_cast<const float*>(ws);
  a.out = out;
  a.m = m;
  a.n = n;
  a.k = k;
  a.tiles_m = (m + kBM - 1) / kBM;
  a.tiles = a.tiles_m * ((n + bn - 1) / bn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch_gemm_bn<float>(map_x, map_w, a, bn, ctas, s)
                 : launch_gemm_bn<bf16>(map_x, map_w, a, bn, ctas, s);
}
