// NHWC GroupNorm with an optional SiLU, for Hopper (sm_90a), bf16 or f32 in
// and out (the output in x's type), f32 statistics and affine.
//
// Replaces the Pallas TPU kernel divergen_tpu/ops/pallas/group_norm.py:
// fused_group_norm (_moments_kernel, the group combine at :151-156,
// _apply_kernel). It computes, per image b and group g of C / G channels,
//     mean = sum(x) / n,  var = max(sum(x^2) / n - mean^2, 0),  n = H W C / G
//     y    = (x - mean) * rsqrt(var + eps) * scale[c] + bias[c]   [then y * sigmoid(y)]
// with y rounded to x's type.
//
// What bounds it on the H100: bytes. A handful of f32 operations per element
// against 4 bytes read and written, far under the card's balance point; at
// the UNet's (4, 128, 128, 320) in bf16 that is 42 MB in and 42 MB out. A
// two-pass norm reads x twice (statistics, then apply), the TPU kernel's
// floor too.
//
// Design: three launches on the caller's stream.
//   1. gn_moments_kernel (gn_moments.cuh): per-(image, split) channel sums of
//      x and x^2 in a fixed order, (B, splits, 2, C) floats; the split count
//      is chosen by the wrapper from the shapes alone, so two runs give the
//      same bits (no atomics).
//   2. gn_finalize_kernel: one block per image walks C in chunks of
//      kFinalizeChunk channels: a thread a channel adds the splits in order
//      into shared memory, then one thread per group adds the chunk's
//      channels of its group in order to running sums it keeps in registers.
//      Then it writes the group's mean and rstd (clamped var, as the TPU path
//      does). Shared memory does not grow with C.
//   3. gn_apply_kernel: a grid-stride pass over the channel vectors of every
//      position, (x - mean) * rstd * scale + bias, SiLU when asked, out in
//      x's type.
// Any B, H, W and C (G = gcd(32, C) is chosen by the caller and divides it);
// x in bf16 or f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_moments.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kApplyThreads = 256;
constexpr int64_t kApplyBlocks = 132 * 16;  // grid-stride: 16 blocks an SM at most
constexpr int kMaxGroups = 32;
constexpr int kFinalizeThreads = 256;
constexpr int kFinalizeChunk = 1024;  // channels a finalize block holds at a time

// one block per image: the channels in chunks; each thread adds the splits of
// its channels in order, then one thread per group adds its channels in order
__global__ void __launch_bounds__(kFinalizeThreads) gn_finalize_kernel(
    const float* __restrict__ part, float2* __restrict__ stats, int hw, int c, int groups,
    int splits, float eps) {
  __shared__ float chan[2][kFinalizeChunk];  // the chunk's channel sums and sums of squares
  const int b = blockIdx.x;
  const int g = threadIdx.x;
  const int cpg = c / groups;
  float t1 = 0.f, t2 = 0.f;  // thread g: its group's running sums
  for (int c0 = 0; c0 < c; c0 += kFinalizeChunk) {
    const int n = min(kFinalizeChunk, c - c0);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float c1 = 0.f, c2 = 0.f;
      for (int s = 0; s < splits; ++s) {
        const float* row = part + (static_cast<int64_t>(b) * splits + s) * 2 * c;
        c1 += row[c0 + i];
        c2 += row[c + c0 + i];
      }
      chan[0][i] = c1;
      chan[1][i] = c2;
    }
    __syncthreads();
    if (g < groups) {
      const int lo = max(g * cpg, c0), hi = min((g + 1) * cpg, c0 + n);
      for (int ch = lo; ch < hi; ++ch) {
        t1 += chan[0][ch - c0];
        t2 += chan[1][ch - c0];
      }
    }
    __syncthreads();  // the chunk is read before the next one overwrites it
  }
  if (g >= groups) return;
  const float n = static_cast<float>(static_cast<int64_t>(hw) * cpg);
  const float mean = t1 / n;
  const float var = fmaxf(t2 / n - mean * mean, 0.f);
  stats[b * groups + g] = make_float2(mean, rsqrtf(var + eps));
}

template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kApplyThreads) gn_apply_kernel(
    const T* __restrict__ x, const float2* __restrict__ stats,
    const float* __restrict__ scale, const float* __restrict__ bias, T* __restrict__ out,
    int batch, int hw, int c, int groups) {
  const int nv = c / VEC;
  const int cpg = c / groups;
  const int64_t total = static_cast<int64_t>(batch) * hw * nv;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c0 = static_cast<int>(i % nv) * VEC;
    const int64_t pos = i / nv;  // b * hw + p
    const int b = static_cast<int>(pos / hw);
    const int64_t off = pos * c + c0;
    float v[VEC];
    dg::load_vec<VEC>(x + off, v);
    float y[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int ch = c0 + j;
      const float2 st = stats[b * groups + ch / cpg];
      float t = (v[j] - st.x) * st.y;
      t = t * scale[ch] + bias[ch];
      if (SILU) t = t / (1.f + expf(-t));
      y[j] = t;
    }
    dg::store_vec<VEC>(out + off, y);
  }
}

template <typename T, int VEC>
int launch(const T* x, const float* scale, const float* bias, float* part, float2* stats, T* out,
           int batch, int hw, int c, int groups, int splits, float eps, bool silu,
           cudaStream_t stream) {
  cudaError_t err = dg::launch_moments<T, VEC>(x, part, batch, hw, c, splits, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_finalize_kernel<<<batch, kFinalizeThreads, 0, stream>>>(part, stats, hw, c, groups, splits,
                                                             eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(batch) * hw * (c / VEC);
  const int64_t want = (total + kApplyThreads - 1) / kApplyThreads;
  const int blocks = static_cast<int>(want < kApplyBlocks ? want : kApplyBlocks);
  if (silu)
    gn_apply_kernel<T, VEC, true><<<blocks, kApplyThreads, 0, stream>>>(x, stats, scale, bias, out,
                                                                        batch, hw, c, groups);
  else
    gn_apply_kernel<T, VEC, false><<<blocks, kApplyThreads, 0, stream>>>(x, stats, scale, bias,
                                                                         out, batch, hw, c, groups);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* scale, const void* bias, void* part, void* stats,
             void* out, int batch, int hw, int c, int groups, int splits, float eps, bool silu,
             cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  float* pp = static_cast<float*>(part);
  float2* stp = static_cast<float2*>(stats);
  T* op = static_cast<T*>(out);
  if (c % 8 == 0)
    return launch<T, 8>(xp, sp, bp, pp, stp, op, batch, hw, c, groups, splits, eps, silu, st);
  return launch<T, 1>(xp, sp, bp, pp, stp, op, batch, hw, c, groups, splits, eps, silu, st);
}

}  // namespace

// x, out (batch, hw, c) bf16 or, with x_f32, f32 (NHWC with H W flattened);
// scale, bias (c,) f32; part (batch, splits, 2, c) and stats (batch, groups, 2)
// f32 scratch; groups <= 32 and divides c.
extern "C" int dg_group_norm(const void* x, const void* scale, const void* bias, void* part,
                             void* stats, void* out, int batch, int hw, int c, int groups,
                             int splits, float eps, int silu, int x_f32, void* stream) {
  if (batch <= 0 || hw <= 0 || c <= 0 || groups <= 0 || groups > kMaxGroups || c % groups ||
      splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return dispatch<float>(x, scale, bias, part, stats, out, batch, hw, c, groups, splits, eps,
                           silu != 0, st);
  return dispatch<bf16>(x, scale, bias, part, stats, out, batch, hw, c, groups, splits, eps,
                        silu != 0, st);
}
