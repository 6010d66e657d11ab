// Row LayerNorm for Hopper (sm_90a), bf16 or f32 in and out (the output in
// x's type), f32 statistics and affine.
//
// Replaces the Pallas TPU kernel divergen_tpu/ops/pallas/layer_norm.py:
// fused_layer_norm (_ln_kernel). Per row of C values, in f32:
//     mean = sum(x) / C,  var = sum((x - mean)^2) / C   (the centred form)
//     y    = (x - mean) * rsqrt(var + eps) * gamma + beta,  in x's type.
//
// What bounds it on the H100: bytes. About ten f32 operations per element
// against 4 bytes read and written in bf16 (8 in f32); at the UNet's
// (16384, 640) in bf16 that is 21 MB in and 21 MB out, 0.0125 ms at 3.35 TB/s.
//
// Design: one warp per row, eight rows per block. When C is a multiple of 8
// and at most 2048 (every LayerNorm of the UNet: C 640 and 1280), each lane
// reads the row in chunks of 8 elements (16 bytes in bf16, two 16-byte loads
// in f32; lanes side by side) and keeps them in registers as floats, so x is
// read once: the warp reduces the sum, then the centred squares, then writes
// the row. Any other C
// takes a plain loop that re-reads the row from the cache for each of the
// three passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_moments.cuh"  // dg::load_vec, dg::store_vec, dg::to_float

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;  // rows per block
constexpr int kMaxChunks = 8;  // 8-element chunks a lane keeps: C <= 8 * 8 * 32 = 2048

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// lane l holds chunk i at columns (i * 32 + l) * 8 .. + 7
template <typename T, int CHUNKS>
__global__ void __launch_bounds__(32 * kWarps) ln_vec_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ out, int rows, int c, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<int64_t>(row) * c;
  float v[CHUNKS][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int col = (i * 32 + lane) * 8;
    if (col < c) {
      dg::load_vec<8>(xr + col, v[i]);
#pragma unroll
      for (int j = 0; j < 8; j += 2) s += v[i][j] + v[i][j + 1];
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
  T* orow = out + static_cast<int64_t>(row) * c;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int col = (i * 32 + lane) * 8;
    if (col < c) {
      float y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = (v[i][j] - mean) * rstd * gamma[col + j] + beta[col + j];
      dg::store_vec<8>(orow + col, y);
    }
  }
}

// any C: three passes over the row, elements lane, lane + 32, ...
template <typename T>
__global__ void __launch_bounds__(32 * kWarps) ln_any_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ out, int rows, int c, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<int64_t>(row) * c;
  float s = 0.f;
  for (int col = lane; col < c; col += 32) s += dg::to_float(xr[col]);
  const float mean = warp_sum(s) / c;
  float ss = 0.f;
  for (int col = lane; col < c; col += 32) {
    const float d = dg::to_float(xr[col]) - mean;
    ss += d * d;
  }
  const float rstd = rsqrtf(warp_sum(ss) / c + eps);
  T* orow = out + static_cast<int64_t>(row) * c;
  for (int col = lane; col < c; col += 32) {
    const float y[1] = {(dg::to_float(xr[col]) - mean) * rstd * gamma[col] + beta[col]};
    dg::store_vec<1>(orow + col, y);
  }
}

template <typename T, int CHUNKS>
void launch_vec(dim3 grid, const T* x, const float* g, const float* b, T* o, int rows, int c,
                float eps, cudaStream_t s) {
  ln_vec_kernel<T, CHUNKS><<<grid, 32 * kWarps, 0, s>>>(x, g, b, o, rows, c, eps);
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* out, int rows, int c,
           float eps, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  T* op = static_cast<T*>(out);
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const int chunks = (c + 255) / 256;
  if (c % 8 != 0 || chunks > kMaxChunks) {
    ln_any_kernel<T><<<grid, 32 * kWarps, 0, s>>>(xp, gp, bp, op, rows, c, eps);
    return static_cast<int>(cudaGetLastError());
  }
  switch (chunks) {
    case 1: launch_vec<T, 1>(grid, xp, gp, bp, op, rows, c, eps, s); break;
    case 2: launch_vec<T, 2>(grid, xp, gp, bp, op, rows, c, eps, s); break;
    case 3: launch_vec<T, 3>(grid, xp, gp, bp, op, rows, c, eps, s); break;
    case 4: launch_vec<T, 4>(grid, xp, gp, bp, op, rows, c, eps, s); break;
    case 5: launch_vec<T, 5>(grid, xp, gp, bp, op, rows, c, eps, s); break;
    case 6: launch_vec<T, 6>(grid, xp, gp, bp, op, rows, c, eps, s); break;
    case 7: launch_vec<T, 7>(grid, xp, gp, bp, op, rows, c, eps, s); break;
    default: launch_vec<T, 8>(grid, xp, gp, bp, op, rows, c, eps, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out (rows, c) bf16 or, with x_f32, f32, contiguous and 16-byte aligned;
// gamma, beta (c,) f32.
extern "C" int dg_layer_norm(const void* x, const void* gamma, const void* beta, void* out,
                             int rows, int c, float eps, int x_f32, void* stream) {
  if (rows <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32) return launch<float>(x, gamma, beta, out, rows, c, eps, s);
  return launch<bf16>(x, gamma, beta, out, rows, c, eps, s);
}
