// NHWC GroupNorm with an optional SiLU, for Hopper (sm_90a), bf16 in and out,
// f32 statistics and affine.
//
// Replaces the Pallas TPU kernel divergen_tpu/ops/pallas/group_norm.py:
// fused_group_norm (_moments_kernel, the group combine at :151-156,
// _apply_kernel). It computes, per image b and group g of C / G channels,
//     mean = sum(x) / n,  var = max(sum(x^2) / n - mean^2, 0),  n = H W C / G
//     y    = (x - mean) * rsqrt(var + eps) * scale[c] + bias[c]   [then y * sigmoid(y)]
// with y rounded to bf16.
//
// What bounds it on the H100: bytes. A handful of f32 operations per element
// against 4 bytes read and written, far under the card's balance point; at
// the UNet's (4, 128, 128, 320) that is 42 MB in and 42 MB out. A two-pass
// norm reads x twice (statistics, then apply), the TPU kernel's floor too.
//
// Design: three launches on the caller's stream.
//   1. gn_moments_kernel: grid (channel tiles, splits, B), block 32 x 8. A
//      block owns 32 channel vectors (8 channels of 16 bytes each when C is a
//      multiple of 8, else single channels) and a contiguous range of the
//      image's H W positions; its 8 warps walk the positions in steps of 8,
//      each lane summing x and x^2 of its channels in f32 (a warp reads 512
//      contiguous bytes per position). The 8 partial sums of a channel are
//      added in warp order through shared memory and written once per
//      (image, split): (B, splits, 2, C) floats. The split count is chosen by
//      the wrapper from the shapes alone, so the order of every sum is fixed
//      and two runs give the same bits (no atomics).
//   2. gn_finalize_kernel: one block per image adds the splits of each
//      channel in order (a thread a channel), then one thread per group adds
//      its channels in order and writes the group's mean and rstd (clamped
//      var, as the TPU path does).
//   3. gn_apply_kernel: a grid-stride pass over the channel vectors of every
//      position, (x - mean) * rstd * scale + bias, SiLU when asked, bf16 out.
// Any B, H, W; any C up to 6144 (G = gcd(32, C) is chosen by the caller and
// divides it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTileVecs = 32;  // channel vectors per moments block (one per lane)
constexpr int kRowsPerIter = 8;  // positions per step of a moments block (one per warp)
constexpr int kApplyThreads = 256;
constexpr int64_t kApplyBlocks = 132 * 16;  // grid-stride: 16 blocks an SM at most
constexpr int kMaxGroups = 32;
constexpr int kFinalizeThreads = 256;
constexpr int kMaxChannels = 6144;  // the finalize block's 2 C floats stay under 48 KB

template <int VEC>
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[VEC]) {
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
__global__ void __launch_bounds__(kTileVecs * kRowsPerIter) gn_moments_kernel(
    const bf16* __restrict__ x, float* __restrict__ part, int hw, int c, int splits) {
  __shared__ float red[2][kRowsPerIter][kTileVecs][VEC];
  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int c0 = (blockIdx.x * kTileVecs + threadIdx.x) * VEC;
  const int p_begin = static_cast<int>(static_cast<int64_t>(hw) * s / splits);
  const int p_end = static_cast<int>(static_cast<int64_t>(hw) * (s + 1) / splits);
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.f;
  if (c0 < c) {
    const bf16* xb = x + static_cast<int64_t>(b) * hw * c + c0;
    for (int p = p_begin + threadIdx.y; p < p_end; p += kRowsPerIter) {
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
      for (int y = 0; y < kRowsPerIter; ++y) acc += red[threadIdx.y][y][threadIdx.x][j];
      dst[j] = acc;
    }
  }
}

// one block per image: each thread adds the splits of its channels in order
// into shared memory, then one thread per group adds the group's channels
__global__ void __launch_bounds__(kFinalizeThreads) gn_finalize_kernel(
    const float* __restrict__ part, float2* __restrict__ stats, int hw, int c, int groups,
    int splits, float eps) {
  extern __shared__ float chan[];  // (2, c): per-channel sums and sums of squares
  const int b = blockIdx.x;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float c1 = 0.f, c2 = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* row = part + (static_cast<int64_t>(b) * splits + s) * 2 * c;
      c1 += row[ch];
      c2 += row[c + ch];
    }
    chan[ch] = c1;
    chan[c + ch] = c2;
  }
  __syncthreads();
  const int g = threadIdx.x;
  if (g >= groups) return;
  const int cpg = c / groups;
  float t1 = 0.f, t2 = 0.f;
  for (int ch = g * cpg; ch < (g + 1) * cpg; ++ch) {
    t1 += chan[ch];
    t2 += chan[c + ch];
  }
  const float n = static_cast<float>(static_cast<int64_t>(hw) * cpg);
  const float mean = t1 / n;
  const float var = fmaxf(t2 / n - mean * mean, 0.f);
  stats[b * groups + g] = make_float2(mean, rsqrtf(var + eps));
}

template <int VEC, bool SILU>
__global__ void __launch_bounds__(kApplyThreads) gn_apply_kernel(
    const bf16* __restrict__ x, const float2* __restrict__ stats,
    const float* __restrict__ scale, const float* __restrict__ bias, bf16* __restrict__ out,
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
    load_vec<VEC>(x + off, v);
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
    if constexpr (VEC == 8) {
      uint4 u;
      uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * j], y[2 * j + 1]);
        w[j] = *reinterpret_cast<uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(out + off) = u;
    } else {
      out[off] = __float2bfloat16(y[0]);
    }
  }
}

template <int VEC>
int launch(const bf16* x, const float* scale, const float* bias, float* part, float2* stats,
           bf16* out, int batch, int hw, int c, int groups, int splits, float eps, bool silu,
           cudaStream_t stream) {
  const int nv = c / VEC;
  const dim3 mgrid((nv + kTileVecs - 1) / kTileVecs, splits, batch);
  gn_moments_kernel<VEC><<<mgrid, dim3(kTileVecs, kRowsPerIter), 0, stream>>>(x, part, hw, c,
                                                                               splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_finalize_kernel<<<batch, kFinalizeThreads, 2 * c * sizeof(float), stream>>>(
      part, stats, hw, c, groups, splits, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(batch) * hw * nv;
  const int64_t want = (total + kApplyThreads - 1) / kApplyThreads;
  const int blocks = static_cast<int>(want < kApplyBlocks ? want : kApplyBlocks);
  if (silu)
    gn_apply_kernel<VEC, true><<<blocks, kApplyThreads, 0, stream>>>(x, stats, scale, bias, out,
                                                                     batch, hw, c, groups);
  else
    gn_apply_kernel<VEC, false><<<blocks, kApplyThreads, 0, stream>>>(x, stats, scale, bias, out,
                                                                      batch, hw, c, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out (batch, hw, c) bf16 (NHWC with H W flattened); scale, bias (c,) f32;
// part (batch, splits, 2, c) and stats (batch, groups, 2) f32 scratch;
// groups <= 32 and divides c.
extern "C" int dg_group_norm_bf16(const void* x, const void* scale, const void* bias, void* part,
                                  void* stats, void* out, int batch, int hw, int c, int groups,
                                  int splits, float eps, int silu, void* stream) {
  if (batch <= 0 || hw <= 0 || c <= 0 || c > kMaxChannels || groups <= 0 ||
      groups > kMaxGroups || c % groups || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  float* pp = static_cast<float*>(part);
  float2* stp = static_cast<float2*>(stats);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c % 8 == 0)
    return launch<8>(xp, sp, bp, pp, stp, op, batch, hw, c, groups, splits, eps, silu != 0, st);
  return launch<1>(xp, sp, bp, pp, stp, op, batch, hw, c, groups, splits, eps, silu != 0, st);
}
