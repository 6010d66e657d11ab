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
// the UNet's (4, 128, 128, 320) in bf16 that is 42 MB in and 42 MB out. The
// statistics need all of an image before its first output, so x is read
// twice (the TPU kernel's floor too); what is left to win is that the second
// read find x in the 50 MB L2 and that nothing else cost a pass.
//
// Design: two launches on the caller's stream over one plan
// (ops/group_norm.py:norm_plan, a function of the shapes only): block
// (ct, s, b) owns channel tile ct (tile_vecs vectors of VEC channels, VEC 8
// when C % 8 == 0, else 1) of positions [hw s / splits, hw (s + 1) / splits)
// of image b. A block has tile_vecs x rows threads (at most kNormThreads);
// thread t keeps the vector t % tile_vecs and walks the positions t / tile_vecs,
// + rows, ..., so each step of a block reads rows whole positions of the tile,
// contiguous in memory, 16 bytes a thread (32 for f32). The grid is one wave
// of the blocks the card holds at once.
//   1. The partials pass: per-thread f32 sums of x and x^2 of its channels,
//      added over the block's rows in row order, then over each group's
//      channels of the tile in channel order: (B, splits, ctiles, 2, G)
//      floats. No atomics. In bf16 with one channel tile (every UNet shape),
//      gn_partials_bulk_kernel: the block's positions, one contiguous run,
//      come through a ring of kRing steps in shared memory by bulk
//      asynchronous copies that one thread issues (on an H100, 0.0503
//      against the register loads' 0.0530 ms at (4, 128, 128, 320),
//      PERF.md); else
//      gn_partials_kernel, each thread's own 16-byte loads, two steps in
//      flight.
//   2. gn_apply_kernel: the group combine in its prologue (what a third
//      launch of one block per image did before): the block adds its image's
//      splits x ctiles partials in a fixed order (strided slices, then the
//      slices in order), clamps the variance and takes its channels' mean,
//      a = rstd scale and bias; then y = (x - mean) a + bias (SiLU when asked).
//      Its first x loads are issued before the prologue. It walks its
//      positions from the last to the first, so the part of x the partials
//      pass read last, which L2 still holds, is read first; x is read and y
//      written as streaming data (evict-first), so y does not push x out.
// Any B, H, W and C (G = gcd(32, C) is chosen by the caller and divides it);
// x in bf16 or f32. Two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_moments.cuh"  // dg::load_vec
#include "sm90_async.cuh"  // mbarriers

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kNormThreads = 512;  // threads of a block at most
constexpr int kMaxGroups = 32;
constexpr int kUnroll = 2;  // steps of x loads in flight a thread of the apply pass and the
                            // register partials pass
constexpr int kRing = 4;    // steps of the bulk-copy partials pass in flight

struct NormPlan {
  int tile_vecs;  // channel vectors of a channel tile
  int rows;       // positions a step of a block
  int ctiles;     // channel tiles
  int splits;     // position ranges of an image
};

// x's last use: a streaming load (evict-first), VEC consecutive elements
template <int VEC>
__device__ __forceinline__ void load_last(const bf16* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
    v[0] = __bfloat162float(__ldcs(p));
  }
}

template <int VEC>
__device__ __forceinline__ void load_last(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const float4 lo = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 hi = __ldcs(reinterpret_cast<const float4*>(p + 4));
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
  } else {
    v[0] = __ldcs(p);
  }
}

// y to p as streaming stores (evict-first), rounded to the element type
template <int VEC>
__device__ __forceinline__ void store_stream(bf16* p, const float (&y)[VEC]) {
  if constexpr (VEC == 8) {
    uint4 u;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * j], y[2 * j + 1]);
      w[j] = *reinterpret_cast<uint32_t*>(&h);
    }
    __stcs(reinterpret_cast<uint4*>(p), u);
  } else {
    __stcs(p, __float2bfloat16(y[0]));
  }
}

template <int VEC>
__device__ __forceinline__ void store_stream(float* p, const float (&y)[VEC]) {
  if constexpr (VEC == 8) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(y[0], y[1], y[2], y[3]));
    __stcs(reinterpret_cast<float4*>(p + 4), make_float4(y[4], y[5], y[6], y[7]));
  } else {
    __stcs(p, y[0]);
  }
}

// this block's positions [*begin, *end) and this thread's channel vector
// (false if the thread has none: the last tile may be narrower)
__device__ __forceinline__ bool block_share(const NormPlan& pl, int hw, int nv, int* begin,
                                            int* end, int* vec) {
  const int s = blockIdx.y;
  *begin = static_cast<int>(static_cast<int64_t>(hw) * s / pl.splits);
  *end = static_cast<int>(static_cast<int64_t>(hw) * (s + 1) / pl.splits);
  *vec = blockIdx.x * pl.tile_vecs + static_cast<int>(threadIdx.x) % pl.tile_vecs;
  return *vec < nv;
}

// the block's partials from each thread's sums s1, s2 of x and x^2 over its
// VEC channels: red[m][r][tile_vecs VEC] holds thread t's at t VEC; added over
// the rows in row order, then over each group's channels of the tile in
// channel order (0 for a group outside the tile)
template <int VEC>
__device__ __forceinline__ void write_partials(float (&red)[2][kNormThreads * VEC],
                                               const float (&s1)[VEC], const float (&s2)[VEC],
                                               const NormPlan& pl, int c, int groups,
                                               float* part) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    red[0][threadIdx.x * VEC + j] = s1[j];
    red[1][threadIdx.x * VEC + j] = s2[j];
  }
  __syncthreads();
  const int width = pl.tile_vecs * VEC;  // channels of a tile
  for (int i = threadIdx.x; i < 2 * width; i += blockDim.x) {  // the rows, in order
    const int m = i / width, j = i - m * width;
    float acc = 0.f;
    for (int r = 0; r < pl.rows; ++r) acc += red[m][r * width + j];
    red[m][j] = acc;  // only this thread reads or writes column j of row 0 here
  }
  __syncthreads();
  const int c0 = blockIdx.x * width;  // the tile's first channel
  const int cpg = c / groups;
  float* dst = part + ((static_cast<int64_t>(blockIdx.z) * pl.splits + blockIdx.y) * pl.ctiles +
                       blockIdx.x) * 2 * groups;
  for (int i = threadIdx.x; i < 2 * groups; i += blockDim.x) {  // a group's channels, in order
    const int m = i / groups, g = i - m * groups;
    const int lo = max(g * cpg, c0), hi = min((g + 1) * cpg, min(c, c0 + width));
    float acc = 0.f;
    for (int ch = lo; ch < hi; ++ch) acc += red[m][ch - c0];
    dst[i] = acc;
  }
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, as one bulk asynchronous copy counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dg::smem_addr(dst)), "l"(src), "r"(bytes), "r"(dg::smem_addr(bar))
      : "memory");
}

// the partials pass with one channel tile of vectors of 8 (C % 8 == 0, C <= 8
// kNormThreads): the block's positions come through a ring of kRing steps in
// shared memory by bulk copies, one thread issuing; each thread sums its
// vector from there
template <typename T>
__global__ void __launch_bounds__(kNormThreads, 2) gn_partials_bulk_kernel(
    const T* __restrict__ x, float* __restrict__ part, int hw, int c, int groups,
    const NormPlan pl) {
  constexpr int VEC = 8;
  extern __shared__ __align__(128) unsigned char ring_raw[];
  __shared__ float red[2][kNormThreads * VEC];
  __shared__ __align__(8) uint64_t full[kRing];
  T* ring = reinterpret_cast<T*>(ring_raw);
  const int b = blockIdx.z;
  const int step = pl.rows * c;  // elements of a step
  int begin, end, vec;
  const bool mine = block_share(pl, hw, c / VEC, &begin, &end, &vec);
  const int steps = (end - begin + pl.rows - 1) / pl.rows;
  const T* xb = x + static_cast<int64_t>(b) * hw * c;
  auto issue = [&](int k) {
    const int p0 = begin + k * pl.rows;
    const uint32_t bytes = static_cast<uint32_t>(min(pl.rows, end - p0)) * c * sizeof(T);
    dg::mbar_arrive_expect_tx(&full[k % kRing], bytes);
    bulk_load(ring + (k % kRing) * step, xb + static_cast<int64_t>(p0) * c, bytes, &full[k % kRing]);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) dg::mbar_init(&full[i], 1);
    dg::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < kRing && k < steps; ++k) issue(k);
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.f;
  const int row = threadIdx.x / pl.tile_vecs;
  for (int k = 0; k < steps; ++k) {
    dg::mbar_wait(&full[k % kRing], (k / kRing) & 1);
    if (mine && begin + k * pl.rows + row < end) {
      float v[VEC];
      dg::load_vec<VEC>(ring + (k % kRing) * step + threadIdx.x * VEC, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s1[j] += v[j];
        s2[j] += v[j] * v[j];
      }
    }
    __syncthreads();  // the stage is read
    if (threadIdx.x == 0 && k + kRing < steps) issue(k + kRing);
  }
  write_partials<VEC>(red, s1, s2, pl, c, groups, part);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kNormThreads, 2) gn_partials_kernel(
    const T* __restrict__ x, float* __restrict__ part, int hw, int c, int groups,
    const NormPlan pl) {
  __shared__ float red[2][kNormThreads * VEC];
  const int b = blockIdx.z;
  const int nv = c / VEC;
  const int row = threadIdx.x / pl.tile_vecs;
  int begin, end, vec;
  const bool mine = block_share(pl, hw, nv, &begin, &end, &vec);
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.f;
  if (mine) {
    const T* xb = x + static_cast<int64_t>(b) * hw * c + static_cast<int64_t>(vec) * VEC;
    for (int p0 = begin + row; p0 < end; p0 += kUnroll * pl.rows) {
      float v[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (p0 + u * pl.rows < end)
          dg::load_vec<VEC>(xb + static_cast<int64_t>(p0 + u * pl.rows) * c, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (p0 + u * pl.rows < end)
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            s1[j] += v[u][j];
            s2[j] += v[u][j] * v[u][j];
          }
    }
  }
  write_partials<VEC>(red, s1, s2, pl, c, groups, part);
}

template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kNormThreads, 2) gn_apply_kernel(
    const T* __restrict__ x, const float* __restrict__ part, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ out, int hw, int c, int groups, float eps,
    const NormPlan pl) {
  __shared__ float slice[kNormThreads];
  __shared__ float2 stats[kMaxGroups];  // (mean, rstd)
  const int b = blockIdx.z;
  const int nv = c / VEC;
  const int row = threadIdx.x / pl.tile_vecs;
  int begin, end, vec;
  const bool mine = block_share(pl, hw, nv, &begin, &end, &vec);
  const int64_t image = static_cast<int64_t>(b) * hw * c + static_cast<int64_t>(vec) * VEC;
  const T* xb = x + image;
  T* ob = out + image;

  // the first step's loads, in flight during the prologue: positions from the last
  int p0 = end - 1 - row;
  float v[kUnroll][VEC];
  if (mine) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (p0 - u * pl.rows >= begin)
        load_last<VEC>(xb + static_cast<int64_t>(p0 - u * pl.rows) * c, v[u]);
  }

  // the image's partials, (splits x ctiles) entries of 2 x groups: thread t
  // adds entries r, r + R, ... of pair t % (2 groups), r = t / (2 groups),
  // then R slices are added in order
  const int pairs = 2 * groups;
  const int slices = static_cast<int>(blockDim.x) / pairs;  // >= 1: dg_group_norm checks
  const int entries = pl.splits * pl.ctiles;
  const float* src = part + static_cast<int64_t>(b) * entries * pairs;
  if (static_cast<int>(threadIdx.x) < slices * pairs) {
    const int q = threadIdx.x % pairs, r = threadIdx.x / pairs;
    float acc = 0.f;
    for (int e = r; e < entries; e += slices) acc += src[e * pairs + q];
    slice[threadIdx.x] = acc;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < groups) {
    const int g = threadIdx.x;
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < slices; ++r) {
      t1 += slice[r * pairs + g];
      t2 += slice[r * pairs + groups + g];
    }
    const float n = static_cast<float>(static_cast<int64_t>(hw) * (c / groups));
    const float mean = t1 / n;
    const float var = fmaxf(t2 / n - mean * mean, 0.f);
    stats[g] = make_float2(mean, rsqrtf(var + eps));
  }
  __syncthreads();
  if (!mine) return;

  // this thread's channels: y = (x - mean) a + bias with a = rstd scale
  const int cpg = c / groups;
  float mean[VEC], a[VEC], b2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int ch = vec * VEC + j;
    const float2 st = stats[ch / cpg];
    mean[j] = st.x;
    a[j] = st.y * __ldg(scale + ch);
    b2[j] = __ldg(bias + ch);
  }
  for (;;) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 - u * pl.rows;
      if (p >= begin) {
        float y[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float t = fmaf(v[u][j] - mean[j], a[j], b2[j]);
          if (SILU) {
            if constexpr (sizeof(T) == 2) t = __fdividef(t, 1.f + __expf(-t));
            else t = t / (1.f + expf(-t));
          }
          y[j] = t;
        }
        store_stream<VEC>(ob + static_cast<int64_t>(p) * c, y);
      }
    }
    p0 -= kUnroll * pl.rows;
    if (p0 < begin) break;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (p0 - u * pl.rows >= begin)
        load_last<VEC>(xb + static_cast<int64_t>(p0 - u * pl.rows) * c, v[u]);
  }
}

template <typename T, int VEC>
int launch(const T* x, const float* scale, const float* bias, float* part, T* out, int batch,
           int hw, int c, int groups, const NormPlan& pl, float eps, bool silu,
           cudaStream_t stream) {
  const dim3 grid(pl.ctiles, pl.splits, batch);
  const int threads = pl.tile_vecs * pl.rows;
  cudaError_t err;
  if (VEC == 8 && sizeof(T) == 2 && pl.ctiles == 1) {
    const int ring = kRing * threads * 8 * static_cast<int>(sizeof(T));
    err = cudaFuncSetAttribute(gn_partials_bulk_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, ring);
    if (err != cudaSuccess) return static_cast<int>(err);
    gn_partials_bulk_kernel<T><<<grid, threads, ring, stream>>>(x, part, hw, c, groups, pl);
  } else {
    gn_partials_kernel<T, VEC><<<grid, threads, 0, stream>>>(x, part, hw, c, groups, pl);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (silu)
    gn_apply_kernel<T, VEC, true><<<grid, threads, 0, stream>>>(x, part, scale, bias, out, hw, c,
                                                                groups, eps, pl);
  else
    gn_apply_kernel<T, VEC, false><<<grid, threads, 0, stream>>>(x, part, scale, bias, out, hw, c,
                                                                 groups, eps, pl);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* scale, const void* bias, void* part, void* out, int batch,
             int hw, int c, int groups, const NormPlan& pl, float eps, bool silu,
             cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  float* pp = static_cast<float*>(part);
  T* op = static_cast<T*>(out);
  if (c % 8 == 0) return launch<T, 8>(xp, sp, bp, pp, op, batch, hw, c, groups, pl, eps, silu, st);
  return launch<T, 1>(xp, sp, bp, pp, op, batch, hw, c, groups, pl, eps, silu, st);
}

}  // namespace

// x, out (batch, hw, c) bf16 or, with x_f32, f32 (NHWC with H W flattened);
// scale, bias (c,) f32; part (batch, splits, ctiles, 2, groups) f32 scratch;
// groups <= 32 and divides c. The plan (tile_vecs, rows, ctiles, splits) is
// ops/group_norm.py:norm_plan's: its tiles cover the channel vectors, and a
// block has at most dg_group_norm_threads() threads and at least 2 groups.
extern "C" int dg_group_norm(const void* x, const void* scale, const void* bias, void* part,
                             void* out, int batch, int hw, int c, int groups, int tile_vecs,
                             int rows, int ctiles, int splits, float eps, int silu, int x_f32,
                             void* stream) {
  const int nv = c % 8 == 0 ? c / 8 : c;
  if (batch <= 0 || hw <= 0 || c <= 0 || groups <= 0 || groups > kMaxGroups || c % groups ||
      tile_vecs <= 0 || rows <= 0 || tile_vecs * rows > kNormThreads ||
      tile_vecs * rows < 2 * groups || ctiles <= 0 || batch > 65535 ||
      static_cast<int64_t>(ctiles) * tile_vecs < nv || (ctiles - 1) * tile_vecs >= nv ||
      splits <= 0 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const NormPlan pl = {tile_vecs, rows, ctiles, splits};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return dispatch<float>(x, scale, bias, part, out, batch, hw, c, groups, pl, eps, silu != 0, st);
  return dispatch<bf16>(x, scale, bias, part, out, batch, hw, c, groups, pl, eps, silu != 0, st);
}

// the most threads a block of either pass has (ops/group_norm.py:NORM_THREADS)
extern "C" int dg_group_norm_threads() { return kNormThreads; }
