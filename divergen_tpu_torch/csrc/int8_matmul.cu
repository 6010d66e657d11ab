// W8A8 GEMM with a dequantization epilogue, for Hopper (sm_90a): int8 x int8
// products on the tensor cores into int32, then
//     out[r, c] = (float(acc[r, c]) * x_scale[r]) * w_scale[c]
// written as bf16 or f32.
//
// Replaces the two Pallas TPU kernels of divergen_tpu/ops/pallas/int8_matmul.py:
//   * int8_matmul_pallas (_kernel): x already quantized (int8 (M, K) and a
//     per-row f32 scale, from ops/quant.py:quantize_act);
//   * int8_matmul_fused_quant (_kernel_fq): bf16 or f32 x, quantized inside
//     the kernel with the per-row scale max(absmax, 1e-12) / 127, a true
//     division, round half to even and a clip to +-127 (the TPU kernel's own
//     formula, which differs from quantize_act's max(absmax / 127, 1e-12) for
//     rows whose absmax is below 1.27e-10).
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
// Design: the body of csrc/ln_matmul.cu in bytes. The s8 m16n8k32 product
// reads fragments with the same byte layout as the bf16 m16n8k16 one, so a
// tile of int8 rows of 64 bytes is loaded with the same ldmatrix calls as a
// tile of bf16 rows of 32 elements (see mma_sm90.cuh). A block computes a
// 128 x 256 output tile with 8 warps of 64 x 64, K in steps of 64 through a
// three-stage cp.async ring (two tiles in flight while one is multiplied);
// the accumulator lives in registers and the epilogue dequantizes it there
// and writes bf16 or f32 straight to device memory. The fused-quant variant
// first reads its 128 rows of x across the whole K for their absmax
// (overlapped with the first copies of the ring), keeps the 128 scales in
// shared memory, streams raw x tiles (bf16, or f32 in chunks of two 16-byte
// copies) through the ring and has each thread quantize the chunks it copied
// into an int8 tile beside them before the tile is used.
// K is never split across blocks. Any M and N; K a multiple of 16 (whole
// 16-byte chunks), with the M, N and K tails masked (zero-filled on load,
// not stored). No TMA, wgmma or warp specialisation yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_moments.cuh"  // dg::load_vec, dg::store_pair, dg::store_one
#include "mma_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;    // rows of x per block
constexpr int kBN = 256;    // weight rows (output columns) per block
constexpr int kBK = 64;     // K per tile: int8 elements = bytes
constexpr int kStages = 3;  // cp.async ring depth
constexpr int kWM = 64;     // rows per warp
constexpr int kWN = 64;     // output columns per warp
constexpr int kWarpsN = kBN / kWN;
constexpr int kThreads = 32 * (kBM / kWM) * kWarpsN;
constexpr int kLDQ = kBK + 16;  // bytes per int8 row in shared memory
constexpr int kQRowStep = kThreads / (kBK / 16);  // rows between a thread's int8 chunks
constexpr int kXRowStep = kThreads / (kBK / 8);   // ... and its 8-element x chunks
constexpr int kAQChunks = kBM / kQRowStep;        // 16-byte int8 x chunks per thread
constexpr int kBChunks = kBN / kQRowStep;         // 16-byte weight chunks per thread
constexpr int kAXChunks = kBM / kXRowStep;        // 8-element raw x chunks per thread
constexpr size_t kTileQA = static_cast<size_t>(kBM) * kLDQ;
constexpr size_t kTileB = static_cast<size_t>(kBN) * kLDQ;
static_assert(kThreads == 256 && kAQChunks * kQRowStep == kBM &&
                  kBChunks * kQRowStep == kBN && kAXChunks * kXRowStep == kBM,
              "tile plan");
static_assert(kTileQA % 128 == 0 && kTileB % 128 == 0, "aligned regions");

// TX: the raw x element of the fused-quant variant (bf16 or f32)
template <bool FQ, typename TX>
struct Plan {
  // elements per raw x row: 16 bytes of padding
  static constexpr int kLDX = kBK + 16 / static_cast<int>(sizeof(TX));
  static constexpr size_t kTileX = sizeof(TX) * kBM * kLDX;
  static constexpr size_t kStage = kTileQA + kTileB + (FQ ? kTileX : 0);
  static constexpr size_t kSmem = kStages * kStage;
  static_assert(kTileX % 128 == 0, "aligned regions");
};

struct Args {
  const int8_t* xq;  // (m, k) int8 (int8_matmul_pallas)
  const float* xs;   // (m,) f32 (int8_matmul_pallas)
  const void* x;     // (m, k) TX (int8_matmul_fused_quant)
  const int8_t* wq;  // (n, k) int8: the (k, n) weight read as its transpose
  const float* ws;   // (n,) f32
  void* out;         // (m, n) TO
  int m, n, k;
};


// one int8 of round-half-even(v / s) clipped to +-127, as a byte
__device__ __forceinline__ uint32_t quant_byte(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

template <bool FQ, typename TX, typename TO>
__global__ void __launch_bounds__(kThreads, 1) int8_gemm_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_xs[kBM];  // the block's per-row activation scales
  typedef Plan<FQ, TX> P;
  const TX* x = static_cast<const TX*>(a.x);

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / kWarpsN;  // 2 warps down, 64 rows each
  const int wn = warp % kWarpsN;  // 4 warps across, 64 columns each
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // this thread copies int8 chunks at rows qr + i * kQRowStep, bytes qc..qc+15,
  // and raw x chunks at rows xr + i * kXRowStep, elements xc..xc+7, of each tile
  const int qr = threadIdx.x / (kBK / 16);
  const int qc = (threadIdx.x % (kBK / 16)) * 16;
  const int xr = threadIdx.x / (kBK / 8);
  const int xc = (threadIdx.x % (kBK / 8)) * 8;

  auto stage_qa = [&](int st) { return smem + st * P::kStage; };
  auto stage_b = [&](int st) { return smem + st * P::kStage + kTileQA; };
  auto stage_x = [&](int st) {
    return reinterpret_cast<TX*>(smem + st * P::kStage + kTileQA + kTileB);
  };
  auto load_tile = [&](int st, int k0) {  // zeros outside M, N and K
    const bool kq_ok = k0 + qc < a.k;
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int r = qr + i * kQRowStep;
      const bool ok = kq_ok && n0 + r < a.n;
      dg::cp_async16(stage_b(st) + r * kLDQ + qc,
                     ok ? a.wq + static_cast<int64_t>(n0 + r) * a.k + k0 + qc : a.wq, ok);
    }
    if (FQ) {
      const bool kx_ok = k0 + xc < a.k;
#pragma unroll
      for (int i = 0; i < kAXChunks; ++i) {
        const int r = xr + i * kXRowStep;
        const bool ok = kx_ok && m0 + r < a.m;
        const TX* src = ok ? x + static_cast<int64_t>(m0 + r) * a.k + k0 + xc : x;
        TX* dst = stage_x(st) + r * P::kLDX + xc;
#pragma unroll
        for (int part = 0; part < static_cast<int>(sizeof(TX)) / 2; ++part)  // 16 bytes each
          dg::cp_async16(dst + part * 4, src + part * 4, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kAQChunks; ++i) {
        const int r = qr + i * kQRowStep;
        const bool ok = kq_ok && m0 + r < a.m;
        dg::cp_async16(stage_qa(st) + r * kLDQ + qc,
                       ok ? a.xq + static_cast<int64_t>(m0 + r) * a.k + k0 + qc : a.xq, ok);
      }
    }
  };
  auto quantize_tile = [&](int st) {  // this thread's own raw x chunks -> int8 tile
#pragma unroll
    for (int i = 0; i < kAXChunks; ++i) {
      const int r = xr + i * kXRowStep;
      const float s = s_xs[r];
      float v[8];
      dg::load_vec<8>(stage_x(st) + r * P::kLDX + xc, v);
      uint32_t word[2];
#pragma unroll
      for (int w = 0; w < 2; ++w)
        word[w] = quant_byte(v[4 * w], s) | (quant_byte(v[4 * w + 1], s) << 8) |
                  (quant_byte(v[4 * w + 2], s) << 16) | (quant_byte(v[4 * w + 3], s) << 24);
      *reinterpret_cast<uint2*>(stage_qa(st) + r * kLDQ + xc) = make_uint2(word[0], word[1]);
    }
  };

  const int n_tiles = (a.k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // one commit group per tile, even if empty
    if (s < n_tiles) load_tile(s, s * kBK);
    dg::cp_async_commit();
  }

  if (FQ) {
    // per-row absmax over the whole K while the first tiles are in flight:
    // warp w takes rows w, w + 8, ...; rows past M get scale 1 (their zeros
    // quantize to zeros)
    for (int r = warp; r < kBM; r += kThreads / 32) {
      const int row = m0 + r;
      float amax = 0.f;
      if (row < a.m) {
        const TX* xrow = x + static_cast<int64_t>(row) * a.k;
        for (int c = lane * 8; c < a.k; c += 256) {
          float v[8];
          dg::load_vec<8>(xrow + c, v);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            amax = fmaxf(amax, fmaxf(fabsf(v[2 * j]), fabsf(v[2 * j + 1])));
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      if (lane == 0) s_xs[r] = row < a.m ? fmaxf(amax, 1e-12f) / 127.f : 1.f;
    }
  } else {
    for (int r = threadIdx.x; r < kBM; r += kThreads)
      s_xs[r] = m0 + r < a.m ? a.xs[m0 + r] : 0.f;
  }
  __syncthreads();  // the scales are visible to every thread

  constexpr int kMI = kWM / 16;  // m16 tiles per warp
  constexpr int kNJ = kWN / 8;   // n8 tiles per warp
  int acc[kMI][kNJ][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    dg::cp_async_wait<kStages - 2>();  // tile t's own chunks have landed
    if (FQ) quantize_tile(st);
    __syncthreads();  // tile t complete for all; stage (t - 1) % kStages free
    if (t + kStages - 1 < n_tiles)
      load_tile((t + kStages - 1) % kStages, (t + kStages - 1) * kBK);
    dg::cp_async_commit();
    const unsigned char* tA = stage_qa(st);
    const unsigned char* tB = stage_b(st);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {  // bytes: one m16n8k32 step
      uint32_t af[kMI][4], bfr[kNJ / 2][4];
#pragma unroll
      for (int i = 0; i < kMI; ++i)
        dg::ldmatrix_x4(af[i], tA + (wm * kWM + i * 16 + (lane & 15)) * kLDQ + kk +
                                   (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < kNJ / 2; ++j)
        dg::ldmatrix_x4(bfr[j], tB + (wn * kWN + j * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLDQ +
                                    kk + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNJ / 2; ++j) {
          dg::mma_s8_16832(acc[i][2 * j], af[i], bfr[j][0], bfr[j][1]);
          dg::mma_s8_16832(acc[i][2 * j + 1], af[i], bfr[j][2], bfr[j][3]);
        }
    }
  }
  dg::cp_async_wait<0>();

  // dequantize in registers: (float(acc) * x_scale[row]) * w_scale[col] -> TO
  const bool pairs = (a.n & 1) == 0;  // pair stores stay aligned
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * kWM + i * 16 + g + 8 * h;
      if (m0 + r >= a.m) continue;
      const float xs = s_xs[r];
      TO* orow = static_cast<TO*>(a.out) + static_cast<int64_t>(m0 + r) * a.n;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int col = n0 + wn * kWN + j * 8 + 2 * t4;
        if (col >= a.n) continue;
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), xs), a.ws[col]);
        if (col + 1 < a.n) {
          const float v1 =
              __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), xs), a.ws[col + 1]);
          if (pairs) {
            dg::store_pair(orow + col, v0, v1);
          } else {
            dg::store_one(orow + col, v0);
            dg::store_one(orow + col + 1, v1);
          }
        } else {
          dg::store_one(orow + col, v0);
        }
      }
    }
}

template <bool FQ, typename TX, typename TO>
int launch(const Args& a, cudaStream_t stream) {
  if (a.k % 16 != 0 || a.m <= 0 || a.n <= 0 || a.k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  typedef Plan<FQ, TX> P;
  cudaError_t err = cudaFuncSetAttribute(int8_gemm_kernel<FQ, TX, TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(P::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.n + kBN - 1) / kBN, (a.m + kBM - 1) / kBM);
  int8_gemm_kernel<FQ, TX, TO><<<grid, kThreads, P::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xq (m, k) int8, xs (m,) f32, wq (n, k) int8 (the transpose of w_q (k, n)),
// ws (n,) f32, out (m, n) bf16 or, with out_f32, f32; k a multiple of 16.
extern "C" int dg_int8_matmul(const void* xq, const void* xs, const void* wq, const void* ws,
                              void* out, int m, int n, int k, int out_f32, void* stream) {
  Args a{};
  a.xq = static_cast<const int8_t*>(xq);
  a.xs = static_cast<const float*>(xs);
  a.wq = static_cast<const int8_t*>(wq);
  a.ws = static_cast<const float*>(ws);
  a.out = out;
  a.m = m;
  a.n = n;
  a.k = k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch<false, bf16, float>(a, s) : launch<false, bf16, bf16>(a, s);
}

// x (m, k) bf16 or, with x_f32, f32, quantized per row in the kernel; the
// rest as above.
extern "C" int dg_int8_matmul_fused_quant(const void* x, const void* wq, const void* ws, void* out,
                                          int m, int n, int k, int x_f32, int out_f32,
                                          void* stream) {
  Args a{};
  a.x = x;
  a.wq = static_cast<const int8_t*>(wq);
  a.ws = static_cast<const float*>(ws);
  a.out = out;
  a.m = m;
  a.n = n;
  a.k = k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return out_f32 ? launch<true, float, float>(a, s) : launch<true, float, bf16>(a, s);
  return out_f32 ? launch<true, bf16, float>(a, s) : launch<true, bf16, bf16>(a, s);
}
