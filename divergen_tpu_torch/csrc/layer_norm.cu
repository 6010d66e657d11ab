// Row LayerNorm for Hopper (sm_90a), bf16 in and out, f32 statistics and
// affine.
//
// Replaces the Pallas TPU kernel divergen_tpu/ops/pallas/layer_norm.py:
// fused_layer_norm (_ln_kernel). Per row of C values, in f32:
//     mean = sum(x) / C,  var = sum((x - mean)^2) / C   (the centred form)
//     y    = (x - mean) * rsqrt(var + eps) * gamma + beta,  rounded to bf16.
//
// What bounds it on the H100: bytes. About ten f32 operations per element
// against 4 bytes read and written; at the UNet's (16384, 640) that is 21 MB
// in and 21 MB out, 0.0125 ms at 3.35 TB/s.
//
// Design: one warp per row, eight rows per block. When C is a multiple of 8
// and at most 2048 (every LayerNorm of the UNet: C 640 and 1280), each lane
// reads the row in 16-byte chunks (lanes side by side, 512 contiguous bytes
// per warp step) and keeps them in registers, so x is read once: the warp
// reduces the sum, then the centred squares, then writes the row. Any other C
// takes a plain loop that re-reads the row from the cache for each of the
// three passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;  // rows per block
constexpr int kMaxChunks = 8;  // 16-byte chunks a lane keeps: C <= 8 * 8 * 32 = 2048

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// lane l holds chunk i at columns (i * 32 + l) * 8 .. + 7
template <int CHUNKS>
__global__ void __launch_bounds__(32 * kWarps) ln_vec_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, bf16* __restrict__ out, int rows, int c, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const bf16* xr = x + static_cast<int64_t>(row) * c;
  float v[CHUNKS][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int col = (i * 32 + lane) * 8;
    if (col < c) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + col);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        v[i][2 * j] = f.x;
        v[i][2 * j + 1] = f.y;
        s += f.x + f.y;
      }
    }
  }
  const float mean = warp_sum(s) / c;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    if ((i * 32 + lane) * 8 < c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[i][j] - mean;
        ss += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(ss) / c + eps);
  bf16* orow = out + static_cast<int64_t>(row) * c;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int col = (i * 32 + lane) * 8;
    if (col < c) {
      uint4 u;
      uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c0 = col + 2 * j;
        const float y0 = (v[i][2 * j] - mean) * rstd * gamma[c0] + beta[c0];
        const float y1 = (v[i][2 * j + 1] - mean) * rstd * gamma[c0 + 1] + beta[c0 + 1];
        __nv_bfloat162 h = __floats2bfloat162_rn(y0, y1);
        w[j] = *reinterpret_cast<uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(orow + col) = u;
    }
  }
}

// any C: three passes over the row, elements lane, lane + 32, ...
__global__ void __launch_bounds__(32 * kWarps) ln_any_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, bf16* __restrict__ out, int rows, int c, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const bf16* xr = x + static_cast<int64_t>(row) * c;
  float s = 0.f;
  for (int col = lane; col < c; col += 32) s += __bfloat162float(xr[col]);
  const float mean = warp_sum(s) / c;
  float ss = 0.f;
  for (int col = lane; col < c; col += 32) {
    const float d = __bfloat162float(xr[col]) - mean;
    ss += d * d;
  }
  const float rstd = rsqrtf(warp_sum(ss) / c + eps);
  bf16* orow = out + static_cast<int64_t>(row) * c;
  for (int col = lane; col < c; col += 32)
    orow[col] = __float2bfloat16((__bfloat162float(xr[col]) - mean) * rstd * gamma[col] + beta[col]);
}

template <int CHUNKS>
void launch_vec(dim3 grid, const bf16* x, const float* g, const float* b, bf16* o, int rows,
                int c, float eps, cudaStream_t s) {
  ln_vec_kernel<CHUNKS><<<grid, 32 * kWarps, 0, s>>>(x, g, b, o, rows, c, eps);
}

}  // namespace

// x, out (rows, c) bf16, contiguous and 16-byte aligned; gamma, beta (c,) f32.
extern "C" int dg_layer_norm_bf16(const void* x, const void* gamma, const void* beta, void* out,
                                  int rows, int c, float eps, void* stream) {
  if (rows <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const int chunks = (c + 255) / 256;
  if (c % 8 != 0 || chunks > kMaxChunks) {
    ln_any_kernel<<<grid, 32 * kWarps, 0, s>>>(xp, gp, bp, op, rows, c, eps);
    return static_cast<int>(cudaGetLastError());
  }
  switch (chunks) {
    case 1: launch_vec<1>(grid, xp, gp, bp, op, rows, c, eps, s); break;
    case 2: launch_vec<2>(grid, xp, gp, bp, op, rows, c, eps, s); break;
    case 3: launch_vec<3>(grid, xp, gp, bp, op, rows, c, eps, s); break;
    case 4: launch_vec<4>(grid, xp, gp, bp, op, rows, c, eps, s); break;
    case 5: launch_vec<5>(grid, xp, gp, bp, op, rows, c, eps, s); break;
    case 6: launch_vec<6>(grid, xp, gp, bp, op, rows, c, eps, s); break;
    case 7: launch_vec<7>(grid, xp, gp, bp, op, rows, c, eps, s); break;
    default: launch_vec<8>(grid, xp, gp, bp, op, rows, c, eps, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
