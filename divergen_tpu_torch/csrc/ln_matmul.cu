// Fused LayerNorm + GEMM (+ bias) with a none / GELU / GEGLU epilogue, for
// Hopper (sm_90a), bf16 in and out, f32 accumulation.
//
// Replaces the Pallas TPU kernel divergen_tpu/ops/pallas/ln_matmul.py:
// fused_ln_matmul (_kernel for the none/GELU epilogues, _kernel_geglu for
// GEGLU). It computes
//     y   = bf16( (x - mean) * rsqrt(max(E[x^2] - mean^2, 0) + eps) * g + b )
//     out = epilogue( y @ w + bias )
// with the epilogues: none; exact-erf GELU; or GEGLU h * gelu(gate), where h
// is output column j and gate is column j + N/2, writing (M, N/2).
//
// What bounds it on the H100: at the UNet's GEGLU shapes (M = 4096..16384,
// K = 640 / 1280, N = 5120 / 10240) the product is compute-bound (well over
// 300 FLOP per byte), so the tensor cores are the limit; the LayerNorm is
// memory-bound and must not add a round trip of the normalized activation
// through device memory.
//
// Design: a stats pass writes only (mean, rstd) per row, (M, 2) floats; the
// GEMM normalizes each A tile on its way from x into shared memory, so the
// normalized activation exists only on chip. The GEMM is a 128 x 256 block
// tile over K tiles of 64, 8 warps of 64 x 64, on the tensor cores through
// mma.sync m16n8k16 (bf16 x bf16 -> f32) with ldmatrix operand loads. x and
// weight tiles stream through a three-stage cp.async ring, so two tiles are
// in flight while one is multiplied; each thread normalizes the x chunks it
// copied, in place in shared memory, before the tile is used. The 64 x 64
// warp tile keeps shared-memory reads per product low enough that the
// ldmatrix traffic does not cap the tensor cores. For GEGLU the block's 256
// weight columns are 128 h columns and their 128 gate columns N/2 further
// on, so the epilogue pairs them in shared memory and writes 128 outputs.
// The weight is read in nn.Linear's (N, K) row-major layout, which is the
// "col" B operand of the product. No TMA, wgmma or warp specialisation yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;     // rows of x per block
constexpr int kBW = 256;     // weight columns per block
constexpr int kBK = 64;      // K per tile
constexpr int kStages = 3;   // cp.async ring depth
constexpr int kWM = 64;      // rows per warp
constexpr int kWN = 64;      // weight columns per warp
constexpr int kWarpsN = kBW / kWN;
constexpr int kLD = kBK + 8;
constexpr int kLDC = kBW + 4;
constexpr int kThreads = 32 * (kBM / kWM) * kWarpsN;
constexpr int kRowStep = kThreads / (kBK / 8);  // rows between a thread's chunks
constexpr int kAChunks = kBM / kRowStep;        // 16-byte chunks per thread per tile
constexpr int kBChunks = kBW / kRowStep;
constexpr size_t kTileA = sizeof(bf16) * kBM * kLD;
constexpr size_t kStageBytes = kTileA + sizeof(bf16) * kBW * kLD;
constexpr size_t kPipeBytes = kStages * kStageBytes;
constexpr size_t kCBytes = sizeof(float) * kBM * kLDC;  // epilogue, reuses the ring
constexpr size_t kSmem = kPipeBytes > kCBytes ? kPipeBytes : kCBytes;
static_assert(kThreads == 256 && kAChunks * kRowStep == kBM && kBChunks * kRowStep == kBW,
              "tile plan");
static_assert(kTileA % 128 == 0 && kStageBytes % 128 == 0, "aligned regions");

enum Epilogue { kNone = 0, kGelu = 1, kGeglu = 2 };

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// one warp per row: mean and rstd from E[x] and E[x^2] in f32
__global__ void ln_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ stats,
                                int m, int k, float eps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= m) return;
  const bf16* xr = x + static_cast<int64_t>(row) * k;
  float s = 0.f, ss = 0.f;
  for (int c = lane * 8; c < k; c += 256) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      s += f.x + f.y;
      ss += f.x * f.x + f.y * f.y;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if (lane == 0) {
    const float mean = s / k;
    const float var = fmaxf(ss / k - mean * mean, 0.f);
    stats[row] = make_float2(mean, rsqrtf(var + eps));
  }
}

struct GemmArgs {
  const bf16* x;
  const bf16* wt;  // (n, k)
  const float* gamma;
  const float* beta;
  const float* bias;  // may be null
  const float2* stats;
  bf16* out;
  int m, n, k;
};

template <int EPI>
__global__ void __launch_bounds__(kThreads, 1) ln_matmul_kernel(const GemmArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sC = reinterpret_cast<float*>(smem);  // after the main loop

  constexpr int kOutCols = EPI == kGeglu ? kBW / 2 : kBW;
  const int half = a.n / 2;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kOutCols;  // first output column of the block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / kWarpsN;  // 2 warps down, 64 rows each
  const int wn = warp % kWarpsN;  // 4 warps across, 64 weight columns each
  const int g = lane >> 2;
  const int t4 = lane & 3;

  // this thread copies (and normalizes) chunks at rows cr + i * kRowStep,
  // columns kc..kc+7 of every A and B tile
  const int cr = threadIdx.x / (kBK / 8);
  const int kc = (threadIdx.x % (kBK / 8)) * 8;
  int b_col[kBChunks];  // weight row (output column) of each B chunk, -1 if none
  float2 a_stat[kAChunks];
#pragma unroll
  for (int i = 0; i < kBChunks; ++i) {
    const int r = cr + i * kRowStep;
    if (EPI == kGeglu) {
      const int col = n0 + (r % (kBW / 2));
      b_col[i] = col < half ? (r < kBW / 2 ? col : half + col) : -1;
    } else {
      b_col[i] = n0 + r < a.n ? n0 + r : -1;
    }
  }
#pragma unroll
  for (int i = 0; i < kAChunks; ++i) {
    const int r = cr + i * kRowStep;
    a_stat[i] = m0 + r < a.m ? a.stats[m0 + r] : make_float2(0.f, 0.f);
  }

  auto stage_a = [&](int st) {
    return reinterpret_cast<bf16*>(smem + st * kStageBytes);
  };
  auto stage_b = [&](int st) {
    return reinterpret_cast<bf16*>(smem + st * kStageBytes + kTileA);
  };
  auto load_tile = [&](int st, int k0) {  // raw x and w chunks; zeros outside
    const bool k_ok = k0 + kc < a.k;
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int r = cr + i * kRowStep;
      const bool a_ok = k_ok && m0 + r < a.m;
      dg::cp_async16(stage_a(st) + r * kLD + kc,
                     a_ok ? a.x + static_cast<int64_t>(m0 + r) * a.k + k0 + kc : a.x, a_ok);
    }
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int r = cr + i * kRowStep;
      const bool b_ok = k_ok && b_col[i] >= 0;
      dg::cp_async16(stage_b(st) + r * kLD + kc,
                     b_ok ? a.wt + static_cast<int64_t>(b_col[i]) * a.k + k0 + kc : a.wt, b_ok);
    }
  };
  auto normalize_tile = [&](int st, int k0) {  // this thread's own A chunks, in place
    if (k0 + kc >= a.k) return;
    const float4 g0 = *reinterpret_cast<const float4*>(a.gamma + k0 + kc);
    const float4 g1 = *reinterpret_cast<const float4*>(a.gamma + k0 + kc + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(a.beta + k0 + kc);
    const float4 b1 = *reinterpret_cast<const float4*>(a.beta + k0 + kc + 4);
    const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int r = cr + i * kRowStep;
      if (m0 + r >= a.m) continue;  // padding rows stay zero
      uint4* cell = reinterpret_cast<uint4*>(stage_a(st) + r * kLD + kc);
      uint4 u = *cell;
      uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
        const float y0 = (f.x - a_stat[i].x) * a_stat[i].y * gg[2 * j] + bb[2 * j];
        const float y1 = (f.y - a_stat[i].x) * a_stat[i].y * gg[2 * j + 1] + bb[2 * j + 1];
        w[j] = dg::pack_bf16x2(y0, y1);
      }
      *cell = u;
    }
  };

  constexpr int kMI = kWM / 16;  // m16 tiles per warp
  constexpr int kNJ = kWN / 8;   // n8 tiles per warp
  float acc[kMI][kNJ][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int n_tiles = (a.k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // one commit group per tile, even if empty
    if (s < n_tiles) load_tile(s, s * kBK);
    dg::cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    dg::cp_async_wait<kStages - 2>();  // tile t's own chunks have landed
    normalize_tile(st, t * kBK);
    __syncthreads();  // tile t complete for all; stage (t - 1) % kStages free
    if (t + kStages - 1 < n_tiles)
      load_tile((t + kStages - 1) % kStages, (t + kStages - 1) * kBK);
    dg::cp_async_commit();
    const bf16* tA = stage_a(st);
    const bf16* tB = stage_b(st);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[kMI][4], bfr[kNJ / 2][4];
#pragma unroll
      for (int i = 0; i < kMI; ++i)
        dg::ldmatrix_x4(af[i], tA + (wm * kWM + i * 16 + (lane & 15)) * kLD + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kNJ / 2; ++j)
        dg::ldmatrix_x4(bfr[j], tB + (wn * kWN + j * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLD +
                                   kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNJ / 2; ++j) {
          dg::mma_bf16_16816(acc[i][2 * j], af[i], bfr[j][0], bfr[j][1]);
          dg::mma_bf16_16816(acc[i][2 * j + 1], af[i], bfr[j][2], bfr[j][3]);
        }
    }
  }
  dg::cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the output tile

#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      float* cell = sC + (wm * kWM + i * 16 + g) * kLDC + wn * kWN + j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(cell) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(cell + 8 * kLDC) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();

  const int out_cols = EPI == kGeglu ? half : a.n;
  for (int e = threadIdx.x; e < kBM * kOutCols; e += kThreads) {
    const int r = e / kOutCols;
    const int c = e % kOutCols;
    const int gm = m0 + r;
    const int gn = n0 + c;
    if (gm >= a.m || gn >= out_cols) continue;
    float val = sC[r * kLDC + c];
    if (a.bias != nullptr) val += a.bias[gn];
    if (EPI == kGeglu) {
      float gate = sC[r * kLDC + kBW / 2 + c];
      if (a.bias != nullptr) gate += a.bias[half + gn];
      val *= gelu_erf(gate);
    } else if (EPI == kGelu) {
      val = gelu_erf(val);
    }
    a.out[static_cast<int64_t>(gm) * out_cols + gn] = __float2bfloat16(val);
  }
}

template <int EPI>
int launch_gemm(const GemmArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ln_matmul_kernel<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int out_cols = EPI == kGeglu ? a.n / 2 : a.n;
  const int block_cols = EPI == kGeglu ? kBW / 2 : kBW;
  const dim3 grid((out_cols + block_cols - 1) / block_cols, (a.m + kBM - 1) / kBM);
  ln_matmul_kernel<EPI><<<grid, kThreads, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, k) bf16, wt (n, k) bf16 (the transpose of w (k, n)), gamma/beta (k,)
// f32, bias (n,) f32 or null, stats (m, 2) f32 scratch, out (m, n) bf16 or
// (m, n/2) for GEGLU. Launches the stats pass, then the GEMM.
extern "C" int dg_ln_matmul_bf16(const void* x, const void* wt, const void* gamma,
                                 const void* beta, const void* bias, void* stats, void* out,
                                 int m, int n, int k, float eps, int epilogue, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GemmArgs a;
  a.x = static_cast<const bf16*>(x);
  a.wt = static_cast<const bf16*>(wt);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.bias = static_cast<const float*>(bias);
  a.stats = static_cast<const float2*>(stats);
  a.out = static_cast<bf16*>(out);
  a.m = m;
  a.n = n;
  a.k = k;
  ln_stats_kernel<<<(m + 7) / 8, 256, 0, s>>>(a.x, static_cast<float2*>(stats), m, k, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (epilogue) {
    case kNone:
      return launch_gemm<kNone>(a, s);
    case kGelu:
      return launch_gemm<kGelu>(a, s);
    case kGeglu:
      return launch_gemm<kGeglu>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
