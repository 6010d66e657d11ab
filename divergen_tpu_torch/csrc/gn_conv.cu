// Fused GroupNorm + SiLU + 3x3 convolution (zero padding 1, stride 1) over
// NHWC activations, for Hopper (sm_90a): x in bf16 or f32 and the output in
// x's type; the normalized activation and the weight in bf16, f32 sums.
//
// Replaces the Pallas TPU kernel divergen_tpu/ops/pallas/fused_gn_conv.py:
// fused_gn_silu_conv3x3 (the moments and the fold at :101-114, _kernel). Per
// image b, with G the largest divisor of C that is at most `groups`:
//     m1[b, c] = mean over (h, w) of x,   m2[b, c] = mean over (h, w) of x^2
//     mean[b, g], e2[b, g] = the means of m1 and m2 over the group's channels
//     rstd[b, g] = rsqrt(e2 - mean^2 + eps)                  (no clamp)
//     a[b, c] = rstd * scale[c],   s[b, c] = bias[c] - mean * a[b, c]
//     y[b, h, w, c] = bf16(silu(x * a + s)), and 0 outside the image: the
//                     conv pads the normalized activation
//     out[b, h, w, o] = sum over (dy, dx, c) of
//                       y[b, h + dy - 1, w + dx - 1, c] * bf16(weight[o, c, dy, dx])
//                       + conv_bias[o]
//
// What bounds it on the H100: operations. It is an implicit GEMM of
// M = B H W output pixels, N = Co and K = 9 C. At the UNet's level 0,
// (4, 128, 128, 320) -> 320, that is 120.8 GFLOP against about 84 MB read
// and written; at level 2, (4, 32, 32, 2560) -> 1280, 241.6 GFLOP. Thousands
// of operations per byte, so the tensor cores are the limit, and the
// normalized activation must not make a round trip through device memory.
//
// Design: three launches on the caller's stream.
//   1. dg::gn_moments_kernel (gn_moments.cuh), kernel 7's moments pass with
//      its fixed order of sums: (B, splits, 2, C) channel sums.
//   2. gnc_fold_kernel: one block per image walks C in chunks: a thread a
//      channel adds the splits in order and divides by H W, then one thread
//      per group adds its channels' means in order; it writes the folded
//      a and s, (B, C) f32 each. The bits are the same on every run.
//   3. gn_conv_kernel: the GEMM on kernel 2's block body (ln_matmul.cu): a
//      128 x 256 output tile, 8 warps of 64 x 64, mma.sync m16n8k16 bf16 ->
//      f32 with ldmatrix loads, K in steps of 64 through a cp.async ring.
//      K runs over (tap, channel): a K tile is 64 channels of one tap, so
//      there are 9 ceil(C / 64) tiles, the channels past C zero. A row of the
//      A tile is one output pixel; for tap (dy, dx) its chunks of 8 channels
//      come from input pixel (h + dy - 1, w + dx - 1) as raw x: 16-byte
//      copies when C % 8 == 0, plain masked loads otherwise, zero-filled
//      outside the image. Before the barrier each thread turns the chunks it
//      copied into bf16 silu(a x + s), computed in f32, and writes zeros where
//      the pixel lies outside the image or the channel past C (the quantize
//      on load of int8_matmul.cu): in place for bf16 x, with a three-stage
//      ring; from a raw f32 tile beside the bf16 one for f32 x, with two
//      stages so that the ring fits in shared memory. The B tile reads the
//      weight in the (N, K) row-major layout (Co, 3, 3, Cp) bf16, Cp = C
//      rounded up to 8 with zeros, which the wrapper copies for each call.
//      The epilogue adds the conv bias in f32 and writes x's type straight
//      from the registers.
// Any B, H, W, C and Co. No TMA, wgmma or warp specialisation yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_moments.cuh"
#include "mma_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;    // output pixels per block
constexpr int kBN = 256;    // output channels per block
constexpr int kBK = 64;     // input channels of one tap per K tile
constexpr int kWM = 64;     // pixels per warp
constexpr int kWN = 64;     // output channels per warp
constexpr int kWarpsN = kBN / kWN;
constexpr int kThreads = 32 * (kBM / kWM) * kWarpsN;
constexpr int kLD = kBK + 8;   // bf16 elements per A and B row in shared memory
constexpr int kLDR = kBK + 4;  // floats per raw f32 x row in shared memory
constexpr int kRowStep = kThreads / (kBK / 8);  // rows between a thread's chunks
constexpr int kAChunks = kBM / kRowStep;        // 8-channel A chunks per thread per tile
constexpr int kBChunks = kBN / kRowStep;        // 16-byte B chunks per thread per tile
constexpr size_t kTileA = sizeof(bf16) * kBM * kLD;
constexpr size_t kTileB = sizeof(bf16) * kBN * kLD;
constexpr size_t kTileR = sizeof(float) * kBM * kLDR;
constexpr int kFoldThreads = 256;
constexpr int kFoldChunk = 1024;  // channels a fold block holds at a time
constexpr int kMaxGroups = 32;
static_assert(kThreads == 256 && kAChunks * kRowStep == kBM && kBChunks * kRowStep == kBN,
              "tile plan");
static_assert(kTileA % 128 == 0 && kTileB % 128 == 0 && kTileR % 128 == 0, "aligned regions");

// T: x's element. A bf16 x chunk is transformed in place in the A tile; an
// f32 one is copied into a raw tile beside it.
template <typename T>
struct Plan {
  static constexpr bool kInPlace = sizeof(T) == sizeof(bf16);
  static constexpr int kStages = kInPlace ? 3 : 2;
  static constexpr int kLDRaw = kInPlace ? kLD : kLDR;  // elements per raw x row
  static constexpr size_t kRawOffset = kInPlace ? 0 : kTileA + kTileB;
  static constexpr size_t kStage = kTileA + kTileB + (kInPlace ? 0 : kTileR);
  static constexpr size_t kSmem = kStages * kStage;
};

// one block per image: the channels in chunks; each thread adds the splits
// of its channels in order, then one thread per group adds its channels'
// means in order; then the fold of every channel
__global__ void __launch_bounds__(kFoldThreads) gnc_fold_kernel(
    const float* __restrict__ part, const float* __restrict__ scale,
    const float* __restrict__ bias, float* __restrict__ fa, float* __restrict__ fs, int hw,
    int c, int groups, int splits, float eps) {
  __shared__ float chan[2][kFoldChunk];  // the chunk's E[x] and E[x^2] per channel
  __shared__ float2 gstat[kMaxGroups];   // (mean, rstd) per group
  const int b = blockIdx.x;
  const int g = threadIdx.x;
  const int cpg = c / groups;
  const float n_pos = static_cast<float>(hw);
  float t1 = 0.f, t2 = 0.f;  // thread g: its group's running sums of channel means
  for (int c0 = 0; c0 < c; c0 += kFoldChunk) {
    const int n = min(kFoldChunk, c - c0);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float c1 = 0.f, c2 = 0.f;
      for (int s = 0; s < splits; ++s) {
        const float* row = part + (static_cast<int64_t>(b) * splits + s) * 2 * c;
        c1 += row[c0 + i];
        c2 += row[c + c0 + i];
      }
      chan[0][i] = c1 / n_pos;
      chan[1][i] = c2 / n_pos;
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
  if (g < groups) {
    const float mean = t1 / static_cast<float>(cpg);
    const float e2 = t2 / static_cast<float>(cpg);
    gstat[g] = make_float2(mean, rsqrtf(e2 - mean * mean + eps));  // unclamped, as the TPU fold
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const float2 st = gstat[ch / cpg];
    const float a = st.y * scale[ch];
    fa[static_cast<int64_t>(b) * c + ch] = a;
    fs[static_cast<int64_t>(b) * c + ch] = bias[ch] - st.x * a;
  }
}

struct ConvArgs {
  const void* x;       // (batch, h, w, c) T
  const float* fa;     // (batch, c) folded scale
  const float* fs;     // (batch, c) folded shift
  const bf16* wt;      // (co, 3, 3, cp): (N, K) row-major
  const float* bias;   // (co,)
  void* out;           // (batch, h, w, co) T
  int batch, h, w, c, cp, co;
};

__device__ __forceinline__ float silu(float t) { return t * __frcp_rn(1.f + __expf(-t)); }

// VEC: C % 8 == 0, so every 8-channel chunk is whole and 16-byte aligned
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 1) gn_conv_kernel(const ConvArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  typedef Plan<T> P;
  constexpr int kS = P::kStages;
  const T* x = static_cast<const T*>(p.x);
  const int hw = p.h * p.w;
  const int m_total = p.batch * hw;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / kWarpsN;  // 2 warps down, 64 pixels each
  const int wn = warp % kWarpsN;  // 4 warps across, 64 output channels each
  const int g = lane >> 2;
  const int t4 = lane & 3;

  // this thread copies (and transforms) chunks at rows cr + i * kRowStep,
  // channels kc..kc+7 of every A and B tile
  const int cr = threadIdx.x / (kBK / 8);
  const int kc = (threadIdx.x % (kBK / 8)) * 8;
  int a_img[kAChunks], a_y[kAChunks], a_x[kAChunks];  // each A row's output pixel
#pragma unroll
  for (int i = 0; i < kAChunks; ++i) {
    const int m = m0 + cr + i * kRowStep;
    const int img = m / hw;
    const int rem = m - img * hw;
    a_img[i] = m < m_total ? img : -1;  // -1: a row past M, all zeros
    a_y[i] = rem / p.w;
    a_x[i] = rem - a_y[i] * p.w;
  }
  const int c_tiles = (p.c + kBK - 1) / kBK;
  const int n_tiles = 9 * c_tiles;
  const int64_t w_row = 9 * static_cast<int64_t>(p.cp);

  auto stage_a = [&](int st) { return reinterpret_cast<bf16*>(smem + st * P::kStage); };
  auto stage_b = [&](int st) {
    return reinterpret_cast<bf16*>(smem + st * P::kStage + kTileA);
  };
  auto stage_raw = [&](int st) {
    return reinterpret_cast<T*>(smem + st * P::kStage + P::kRawOffset);
  };
  // tile t is tap t / c_tiles, channels from (t % c_tiles) * kBK; the element
  // offset of chunk i's input pixel and channel, or -1 when it reads nothing
  auto source = [&](int t, int i, int& ch) -> int64_t {
    const int tap = t / c_tiles;
    ch = (t - tap * c_tiles) * kBK + kc;
    const int yy = a_y[i] + tap / 3 - 1;
    const int xx = a_x[i] + tap % 3 - 1;
    if (a_img[i] < 0 || yy < 0 || yy >= p.h || xx < 0 || xx >= p.w || ch >= p.c) return -1;
    return ((static_cast<int64_t>(a_img[i]) * p.h + yy) * p.w + xx) * p.c + ch;
  };
  auto load_tile = [&](int st, int t) {  // weight chunks and raw x chunks
    const int tap = t / c_tiles;
    const int cw = (t - tap * c_tiles) * kBK + kc;
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int r = cr + i * kRowStep;
      const bool ok = cw < p.cp && n0 + r < p.co;
      dg::cp_async16(stage_b(st) + r * kLD + kc,
                     ok ? p.wt + (n0 + r) * w_row + tap * p.cp + cw : p.wt, ok);
    }
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      int ch;
      const int64_t off = source(t, i, ch);
      T* dst = stage_raw(st) + (cr + i * kRowStep) * P::kLDRaw + kc;
      if constexpr (VEC) {
        constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements per copy
        const T* src = off >= 0 ? x + off : x;
#pragma unroll
        for (int q = 0; q < 8 / kPer; ++q) dg::cp_async16(dst + q * kPer, src + q * kPer, off >= 0);
      } else if (off >= 0) {  // the transform reads only chunks of pixels in the image
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[j] = ch + j < p.c ? x[off + j] : dg::from_float<T>(0.f);
      }
    }
  };
  auto transform_tile = [&](int st, int t) {  // this thread's own chunks -> bf16 A tile
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int r = cr + i * kRowStep;
      int ch;
      const int64_t off = source(t, i, ch);
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (off >= 0) {
        float v[8], fa[8], fs[8];
        const T* raw = stage_raw(st) + r * P::kLDRaw + kc;
        const int64_t ab = static_cast<int64_t>(a_img[i]) * p.c + ch;
        if constexpr (VEC) {
          dg::load_vec<8>(raw, v);
          dg::load_vec<8>(p.fa + ab, fa);
          dg::load_vec<8>(p.fs + ab, fs);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const bool in = ch + j < p.c;
            v[j] = dg::to_float(raw[j]);
            fa[j] = in ? p.fa[ab + j] : 0.f;
            fs[j] = in ? p.fs[ab + j] : 0.f;
          }
        }
        uint32_t* word = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          const float y0 = VEC || ch + j < p.c ? silu(v[j] * fa[j] + fs[j]) : 0.f;
          const float y1 = VEC || ch + j + 1 < p.c ? silu(v[j + 1] * fa[j + 1] + fs[j + 1]) : 0.f;
          word[j / 2] = dg::pack_bf16x2(y0, y1);
        }
      }
      *reinterpret_cast<uint4*>(stage_a(st) + r * kLD + kc) = packed;
    }
  };

  constexpr int kMI = kWM / 16;  // m16 tiles per warp
  constexpr int kNJ = kWN / 8;   // n8 tiles per warp
  float acc[kMI][kNJ][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {  // one commit group per tile, even if empty
    if (s < n_tiles) load_tile(s, s);
    dg::cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kS;
    dg::cp_async_wait<kS - 2>();  // tile t's own chunks have landed
    transform_tile(st, t);
    __syncthreads();  // tile t complete for all; stage (t - 1) % kS free
    if (t + kS - 1 < n_tiles) load_tile((t + kS - 1) % kS, t + kS - 1);
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

  // epilogue in registers: + conv bias (f32) -> T
  T* out = static_cast<T*>(p.out);
  const bool pairs = (p.co & 1) == 0;  // pair stores stay aligned
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * kWM + i * 16 + g + 8 * h;
      if (m >= m_total) continue;
      T* orow = out + static_cast<int64_t>(m) * p.co;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int col = n0 + wn * kWN + j * 8 + 2 * t4;
        if (col >= p.co) continue;
        const float v0 = acc[i][j][2 * h] + p.bias[col];
        if (col + 1 < p.co) {
          const float v1 = acc[i][j][2 * h + 1] + p.bias[col + 1];
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

template <typename T, bool VEC>
cudaError_t launch_conv(const ConvArgs& a, cudaStream_t stream) {
  typedef Plan<T> P;
  cudaError_t err = cudaFuncSetAttribute(gn_conv_kernel<T, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(P::kSmem));
  if (err != cudaSuccess) return err;
  const int64_t m_total = static_cast<int64_t>(a.batch) * a.h * a.w;
  const dim3 grid(static_cast<unsigned>((m_total + kBM - 1) / kBM), (a.co + kBN - 1) / kBN);
  gn_conv_kernel<T, VEC><<<grid, kThreads, P::kSmem, stream>>>(a);
  return cudaGetLastError();
}

// fa, fs: the writable (batch, c) buffers that a.fa and a.fs point to
template <typename T>
int run(const ConvArgs& a, const float* scale, const float* bias, float* part, float* fa,
        float* fs, int groups, int splits, float eps, cudaStream_t stream) {
  const T* x = static_cast<const T*>(a.x);
  const int hw = a.h * a.w;
  const bool vec = a.c % 8 == 0;
  cudaError_t err = vec ? dg::launch_moments<T, 8>(x, part, a.batch, hw, a.c, splits, stream)
                        : dg::launch_moments<T, 1>(x, part, a.batch, hw, a.c, splits, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  gnc_fold_kernel<<<a.batch, kFoldThreads, 0, stream>>>(part, scale, bias, fa, fs, hw, a.c,
                                                         groups, splits, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(vec ? launch_conv<T, true>(a, stream) : launch_conv<T, false>(a, stream));
}

}  // namespace

// x (batch, h, w, c) bf16 or, with x_f32, f32; scale, bias (c,) f32 (the
// GroupNorm affine); wt (co, 3, 3, cp) bf16 with cp = c rounded up to 8 and
// zeros past c; conv_bias (co,) f32; part (batch, splits, 2, c), fa and fs
// (batch, c) f32 scratch; out (batch, h, w, co) in x's type. groups <= 32
// divides c.
extern "C" int dg_gn_conv(const void* x, const void* scale, const void* bias, const void* wt,
                          const void* conv_bias, void* part, void* fa, void* fs, void* out,
                          int batch, int h, int w, int c, int cp, int co, int groups, int splits,
                          float eps, int x_f32, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || co <= 0 || cp < c || cp % 8 || groups <= 0 ||
      groups > kMaxGroups || c % groups || splits <= 0 ||
      static_cast<int64_t>(batch) * h * w > (static_cast<int64_t>(1) << 31) - kBM)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a;
  a.x = x;
  a.fa = static_cast<const float*>(fa);
  a.fs = static_cast<const float*>(fs);
  a.wt = static_cast<const bf16*>(wt);
  a.bias = static_cast<const float*>(conv_bias);
  a.out = out;
  a.batch = batch;
  a.h = h;
  a.w = w;
  a.c = c;
  a.cp = cp;
  a.co = co;
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  float* pp = static_cast<float*>(part);
  float* fap = static_cast<float*>(fa);
  float* fsp = static_cast<float*>(fs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32) return run<float>(a, sp, bp, pp, fap, fsp, groups, splits, eps, st);
  return run<bf16>(a, sp, bp, pp, fap, fsp, groups, splits, eps, st);
}
