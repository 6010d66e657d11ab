// Per-channel moments of NHWC activations, the first pass of the fused
// GroupNorm + SiLU + 3x3 conv (gn_conv.cu), and the element loads and stores
// the port's kernels (the GroupNorm kernel, group_norm.cu, among them) use for
// bf16 and f32 tensors.
//
// gn_moments_kernel: grid (channel tiles, splits, B), block 32 x 8. A block
// owns 32 channel vectors (8 channels of 16 or 32 bytes each when C is a
// multiple of 8, else single channels) and a contiguous range of the image's
// H W positions; its 8 warps walk the positions in steps of 8, each lane
// summing x and x^2 of its channels in f32. The 8 partial sums of a channel
// are added in warp order through shared memory and written once per
// (image, split): (B, splits, 2, C) floats. The split count is chosen by the
// caller from the shapes alone, so the order of every sum is fixed and two
// runs give the same bits (no atomics). The kernel sits in an unnamed
// namespace: each translation unit that includes this header (they are
// compiled without relocatable device code) gets its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dg {

constexpr int kMomentVecs = 32;  // channel vectors per moments block (one per lane)
constexpr int kMomentRows = 8;   // positions per step of a moments block (one per warp)

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

// VEC (8 or 1) consecutive elements at p as floats; VEC 8 needs p 16-byte aligned
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const float4 lo = *reinterpret_cast<const float4*>(p);
    const float4 hi = *reinterpret_cast<const float4*>(p + 4);
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
  } else {
    v[0] = *p;
  }
}

// VEC values to p, rounded to the element type; VEC 8 needs p 16-byte aligned
template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&y)[VEC]) {
  if constexpr (VEC == 8) {
    uint4 u;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * j], y[2 * j + 1]);
      w[j] = *reinterpret_cast<uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = __float2bfloat16(y[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&y)[VEC]) {
  if constexpr (VEC == 8) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(y[4], y[5], y[6], y[7]);
  } else {
    *p = y[0];
  }
}

// v0, v1 to p[0], p[1] (p aligned to two elements), and v to p[0]
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }

namespace {

template <typename T, int VEC>
__global__ void __launch_bounds__(kMomentVecs * kMomentRows) gn_moments_kernel(
    const T* __restrict__ x, float* __restrict__ part, int hw, int c, int splits) {
  __shared__ float red[2][kMomentRows][kMomentVecs][VEC];
  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int c0 = (blockIdx.x * kMomentVecs + threadIdx.x) * VEC;
  const int p_begin = static_cast<int>(static_cast<int64_t>(hw) * s / splits);
  const int p_end = static_cast<int>(static_cast<int64_t>(hw) * (s + 1) / splits);
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.f;
  if (c0 < c) {
    const T* xb = x + static_cast<int64_t>(b) * hw * c + c0;
    for (int p = p_begin + threadIdx.y; p < p_end; p += kMomentRows) {
      float v[VEC];
      load_vec<VEC>(xb + static_cast<int64_t>(p) * c, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s1[j] += v[j];
        s2[j] += v[j] * v[j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    red[0][threadIdx.y][threadIdx.x][j] = s1[j];
    red[1][threadIdx.y][threadIdx.x][j] = s2[j];
  }
  __syncthreads();
  if (threadIdx.y < 2 && c0 < c) {  // warp 0 writes the sums, warp 1 the squares
    float* dst = part + ((static_cast<int64_t>(b) * splits + s) * 2 + threadIdx.y) * c + c0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int y = 0; y < kMomentRows; ++y) acc += red[threadIdx.y][y][threadIdx.x][j];
      dst[j] = acc;
    }
  }
}

// launches the moments pass on (batch, hw, c) x; VEC 8 when c % 8 == 0
template <typename T, int VEC>
cudaError_t launch_moments(const T* x, float* part, int batch, int hw, int c, int splits,
                           cudaStream_t stream) {
  const int nv = c / VEC;
  const dim3 grid((nv + kMomentVecs - 1) / kMomentVecs, splits, batch);
  gn_moments_kernel<T, VEC><<<grid, dim3(kMomentVecs, kMomentRows), 0, stream>>>(x, part, hw, c,
                                                                                 splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dg
