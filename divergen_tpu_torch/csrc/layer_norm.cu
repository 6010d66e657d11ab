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
// Design: rows are walked by warps, one row at a time. When C is a multiple
// of 8 and at most 2048 (every LayerNorm of the UNet: C 640 and 1280), a
// persistent grid (ln_rows_kernel) gives each warp at least kRowsPerWarp
// rows, taken kWarps * gridDim.x apart, and keeps the next row's 16-byte
// loads in flight while it reduces and stores the current one (a register
// double buffer: at C = 1280 five chunks of 8 elements a lane, lanes side by
// side), so that the reads of one row overlap the writes of the last (with
// one row a warp, every warp loads, then reduces, then stores at the same
// time, and reads and writes do not overlap). x is read
// once; the warp reduces the sum, then the centred squares (two shuffle
// trees), then writes the row with streaming stores (st.global.cs: the
// output is not read again by this kernel). gamma and beta are staged once a
// block in shared memory and read as float4. Any other C takes a plain loop
// that re-reads the row from the cache for each of the three passes
// (ln_any_kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_moments.cuh"  // dg::store_vec, dg::to_float

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;  // warps per block
constexpr int kMaxChunks = 8;  // 8-element chunks a lane keeps: C <= 8 * 8 * 32 = 2048
constexpr int kRowsPerWarp = 2;  // the persistent grid is cut so that a warp walks at least these

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 8 elements of T as raw 16-byte words: one for bf16, two for f32
template <typename T>
struct Chunk {
  static constexpr int kWords = sizeof(T) / 2;
  uint4 w[kWords];

  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
  __device__ __forceinline__ void unpack(float (&v)[8]) const {
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        v[2 * j] = f.x;
        v[2 * j + 1] = f.y;
      }
    } else {
      const float* f = reinterpret_cast<const float*>(w);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = f[j];
    }
  }
  // y rounded to T, to p by streaming stores
  __device__ __forceinline__ static void store(T* p, const float (&y)[8]) {
    uint4 out[kWords];
    if constexpr (sizeof(T) == 2) {
      uint32_t* o = reinterpret_cast<uint32_t*>(out);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * j], y[2 * j + 1]);
        o[j] = *reinterpret_cast<uint32_t*>(&h);
      }
    } else {
      float* o = reinterpret_cast<float*>(out);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = y[j];
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i) __stcs(reinterpret_cast<uint4*>(p) + i, out[i]);
  }
};

// lane l holds chunk i of a row at columns (i * 32 + l) * 8 .. + 7; gamma and
// beta (c floats each) in dynamic shared memory
template <typename T, int CHUNKS>
__global__ void __launch_bounds__(32 * kWarps) ln_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ out, int rows, int c, float eps) {
  extern __shared__ float4 gb4[];
  float* sg = reinterpret_cast<float*>(gb4);
  float* sb = sg + c;
  for (int i = threadIdx.x; i < c; i += 32 * kWarps) {
    sg[i] = gamma[i];
    sb[i] = beta[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int step = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  Chunk<T> cur[CHUNKS], nxt[CHUNKS];
  auto load = [&](Chunk<T>(&buf)[CHUNKS], int r) {
    const T* xr = x + static_cast<int64_t>(r) * c;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int col = (i * 32 + lane) * 8;
      if (col < c) buf[i].load(xr + col);
    }
  };
  if (row < rows) load(cur, row);
  for (; row < rows; row += step) {
    if (row + step < rows) load(nxt, row + step);  // in flight while this row is done
    float v[CHUNKS][8];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      if ((i * 32 + lane) * 8 < c) {
        cur[i].unpack(v[i]);
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
        const float4 g0 = *reinterpret_cast<const float4*>(sg + col);
        const float4 g1 = *reinterpret_cast<const float4*>(sg + col + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(sb + col);
        const float4 b1 = *reinterpret_cast<const float4*>(sb + col + 4);
        const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        float y[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) y[j] = (v[i][j] - mean) * rstd * g[j] + bb[j];
        Chunk<T>::store(orow + col, y);
      }
    }
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) cur[i] = nxt[i];
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

// the persistent grid: at most the blocks resident at once, and few enough
// that each warp walks kRowsPerWarp rows
template <typename T, int CHUNKS>
int launch_rows(const T* x, const float* g, const float* b, T* o, int rows, int c, float eps,
                cudaStream_t s) {
  const size_t smem = 2 * sizeof(float) * c;
  int dev = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, ln_rows_kernel<T, CHUNKS>,
                                                        32 * kWarps, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t wanted = (static_cast<int64_t>(rows) + kWarps * kRowsPerWarp - 1) /
                         (kWarps * kRowsPerWarp);
  const int64_t most = static_cast<int64_t>(sms) * (resident > 0 ? resident : 1);
  const int blocks = static_cast<int>(wanted < most ? wanted : most);
  ln_rows_kernel<T, CHUNKS><<<blocks, 32 * kWarps, smem, s>>>(x, g, b, o, rows, c, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* out, int rows, int c,
           float eps, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  T* op = static_cast<T*>(out);
  const int chunks = (c + 255) / 256;
  if (c % 8 != 0 || chunks > kMaxChunks) {
    const dim3 grid((rows + kWarps - 1) / kWarps);
    ln_any_kernel<T><<<grid, 32 * kWarps, 0, s>>>(xp, gp, bp, op, rows, c, eps);
    return static_cast<int>(cudaGetLastError());
  }
  switch (chunks) {
    case 1: return launch_rows<T, 1>(xp, gp, bp, op, rows, c, eps, s);
    case 2: return launch_rows<T, 2>(xp, gp, bp, op, rows, c, eps, s);
    case 3: return launch_rows<T, 3>(xp, gp, bp, op, rows, c, eps, s);
    case 4: return launch_rows<T, 4>(xp, gp, bp, op, rows, c, eps, s);
    case 5: return launch_rows<T, 5>(xp, gp, bp, op, rows, c, eps, s);
    case 6: return launch_rows<T, 6>(xp, gp, bp, op, rows, c, eps, s);
    case 7: return launch_rows<T, 7>(xp, gp, bp, op, rows, c, eps, s);
    default: return launch_rows<T, 8>(xp, gp, bp, op, rows, c, eps, s);
  }
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
