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
// (4, 128, 128, 320) -> 320, that is 120.8 GFLOP against about 84 MB of x
// read and output written (0.122 ms at 989 TFLOP/s against 0.025 ms at
// 3.35 TB/s); at level 2, (4, 32, 32, 2560) -> 1280, 241.6 GFLOP.
//
// Why y makes one trip through device memory: a block of the GEMM reads
// each input pixel nine times (once per tap) and each block of output
// channels reads it again, so a transform applied on the way into shared
// memory runs 9 times per element and channel block: at level 0, with the
// mma.sync body's 256-wide blocks, some 377 M SiLUs (an exp and a
// reciprocal each) where 21 M do, in the GEMM's critical path. Applied
// once, y costs one write and one read of 42 MB at level 0 (about 0.025 ms,
// much of the read from L2), and the GEMM reads only bf16, for bf16 and f32
// x alike.
//
// Design: two C entry points, four launches on the caller's stream.
//   dg_gn_conv_apply:
//   1. dg::gn_moments_kernel (gn_moments.cuh), kernel 7's moments pass with
//      its fixed order of sums: (B, splits, 2, C) channel sums.
//   2. gnc_fold_kernel: one block per (group, image): a thread a channel
//      adds the splits in order and divides by H W, then one thread adds the
//      group's channel means in order; it writes the folded a and s, (B, C)
//      f32 each. The bits are the same on every run.
//   3. gnc_apply_kernel: y = bf16(silu(x a + s)) once per element, 8
//      channels a thread, into (B, H, W, Cp) bf16 scratch, Cp = C rounded
//      up to 8 (16-byte rows, as TMA needs), the channels past C zero.
//   dg_gn_conv_gemm:
//   4. conv_gemm_kernel<TO>: kernel 10's persistent, warp-specialized
//      GEMM (int8_matmul.cu) on bf16 wgmma. An output tile is th x tw = 128
//      pixels of one image (1 x 128, 2 x 64 or 4 x 32 at SDXL's widths: no
//      row wasted) by 160 output channels (ops/gn_conv.py: conv_plan). K
//      runs over (64-channel chunk, tap): for tap (dy, dx) and chunk c0 the
//      A tile is one TMA box (64, tw, th, 1) of a 4-D map over y, (Cp, W, H,
//      B), at (c0, w0 + dx - 1, h0 + dy - 1, b), and the B tile one box
//      (64, 1, 160) of a 3-D map over the weight operand
//      (Cp, 9, Co). TMA fills what lies outside a map with zeros, so a
//      coordinate of -1, W or H is exactly the conv's zero padding of the
//      normalized activation and no load carries a mask; channels past C
//      read y's zeros or the map's. Both boxes land as rows of 128 bytes
//      under the 128-byte swizzle, the K-major layout wgmma's descriptors
//      read. One producer thread keeps the loads in flight through a ring
//      of kStages mbarrier stages; two consumer warpgroups take the block's
//      tiles in turns, each holding a whole 128 x 160 tile in f32 registers
//      (wgmma m64n160k16 bf16, both operands from shared memory), so that one
//      adds the conv bias and stores while the other's products run. The
//      epilogue trades sums within each quad so that a lane writes 8
//      adjacent channels (16 bytes of bf16), masked at H, W and Co.
// Any B, H, W, C and Co; no atomics, so a call gives the same bits twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_moments.cuh"  // moments pass, dg::load_vec, dg::store_one
#include "mma_sm90.cuh"    // dg::smem_addr, dg::pack_bf16x2
#include "sm90_async.cuh"  // mbarriers, TMA, the swizzled descriptor, wgmma fences

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;          // output pixels per tile
// output channels per tile (ops/gn_conv.py: CONV_BN): every Co of SDXL's UNet
// is a multiple of 160, and a consumer's two m64n160 accumulators take 160
// registers a thread
constexpr int kBN = 160;
constexpr int kBK = 64;           // channels per stage: one 128-byte swizzle row of bf16
constexpr int kConsumers = 2;     // warpgroups, each on tiles of its own
constexpr int kThreads = 128 * (1 + kConsumers);
// shared-memory ring depth: on an H100 (tools/gn_conv_ab.py), at the 12
// conv shapes of a UNet call, 3 stages took 10.24 ms a call against 4's
// 8.85 (with the taps outermost in K); 4, 5 and 6 are within 0.3 % of each
// other (7.90 ms), and 4 takes the least shared memory
constexpr int kStages = 4;
constexpr int kFoldThreads = 128;
constexpr int kMaxGroups = 32;
constexpr int kMaxGroupChannels = 4096;  // the fold's 2 cpg floats: 32 KB at most
constexpr int kApplyThreads = 256;

constexpr int kBytesA = kBM * kBK * 2;
constexpr int kBytesB = kBN * kBK * 2;
constexpr int kStage = kBytesA + kBytesB;
constexpr int kSmem = kStages * kStage + 1024;  // + slack to align the ring to 1024
static_assert(kBytesA % 1024 == 0 && kBytesB % 1024 == 0, "swizzle atoms stay aligned");
static_assert(kSmem + 256 <= 232448, "the ring and the barriers fit in a block's 227 KB");

// one block per (group, image): a thread per channel of the group adds the
// splits in order and divides by H W; then one thread adds the group's
// channel means in order; then the fold of each channel. chan: 2 cpg floats
// of dynamic shared memory, the channels' E[x] and E[x^2].
__global__ void __launch_bounds__(kFoldThreads) gnc_fold_kernel(
    const float* __restrict__ part, const float* __restrict__ scale,
    const float* __restrict__ bias, float* __restrict__ fa, float* __restrict__ fs, int hw,
    int c, int groups, int splits, float eps) {
  extern __shared__ float chan[];
  __shared__ float2 stat;  // the group's (mean, rstd)
  const int b = blockIdx.y;
  const int cpg = c / groups;
  const int c0 = blockIdx.x * cpg;
  const float n_pos = static_cast<float>(hw);
  for (int i = threadIdx.x; i < cpg; i += blockDim.x) {
    float c1 = 0.f, c2 = 0.f;
#pragma unroll 8  // the loads in flight together; the adds stay in order
    for (int s = 0; s < splits; ++s) {
      const float* row = part + (static_cast<int64_t>(b) * splits + s) * 2 * c + c0 + i;
      c1 += row[0];
      c2 += row[c];
    }
    chan[i] = c1 / n_pos;
    chan[cpg + i] = c2 / n_pos;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int i = 0; i < cpg; ++i) {
      t1 += chan[i];
      t2 += chan[cpg + i];
    }
    const float mean = t1 / static_cast<float>(cpg);
    const float e2 = t2 / static_cast<float>(cpg);
    stat = make_float2(mean, rsqrtf(e2 - mean * mean + eps));  // unclamped, as the TPU fold
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cpg; i += blockDim.x) {
    const float a = stat.y * scale[c0 + i];
    fa[static_cast<int64_t>(b) * c + c0 + i] = a;
    fs[static_cast<int64_t>(b) * c + c0 + i] = bias[c0 + i] - stat.x * a;
  }
}

__device__ __forceinline__ float silu(float t) { return t * __frcp_rn(1.f + __expf(-t)); }

// y (pixels, cp) bf16 = bf16(silu(x a + s)) for the channels below c, 0 past
// them; a thread per 8 channels of a pixel. VEC: c % 8 == 0 (then cp == c),
// so every chunk is whole and 16-byte aligned.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kApplyThreads) gnc_apply_kernel(
    const T* __restrict__ x, const float* __restrict__ fa, const float* __restrict__ fs,
    bf16* __restrict__ y, int64_t chunks, int hw, int c, int cp) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kApplyThreads + threadIdx.x;
  if (i >= chunks) return;
  const int per_pixel = cp / 8;
  const int64_t p = i / per_pixel;
  const int ch = static_cast<int>(i - p * per_pixel) * 8;
  const int64_t ab = (p / hw) * c + ch;
  float v[8], fa8[8], fs8[8];
  if constexpr (VEC) {
    dg::load_vec<8>(x + p * c + ch, v);
    dg::load_vec<8>(fa + ab, fa8);
    dg::load_vec<8>(fs + ab, fs8);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // past c: silu(0 * 0 + 0) = 0
      const bool in = ch + j < c;
      v[j] = in ? dg::to_float(x[p * c + ch + j]) : 0.f;
      fa8[j] = in ? fa[ab + j] : 0.f;
      fs8[j] = in ? fs[ab + j] : 0.f;
    }
  }
  uint4 packed;
  uint32_t* word = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
  for (int j = 0; j < 8; j += 2)
    word[j / 2] = dg::pack_bf16x2(silu(v[j] * fa8[j] + fs8[j]),
                                  silu(v[j + 1] * fa8[j + 1] + fs8[j + 1]));
  *reinterpret_cast<uint4*>(y + p * cp + ch) = packed;
}

struct ConvArgs {
  const float* bias;  // (co,) f32
  void* out;          // (batch, h, w, co) TO
  int h, w, co;
  int tw_log2;        // the tile is th x tw pixels, tw = 1 << tw_log2, th = kBM / tw
  int tiles_w, tiles_h, tiles_n, tiles;
  int c_tiles;        // 64-channel chunks of cp
};

// tile t of the plan (ops/gn_conv.py:conv_plan): channel tiles fastest,
// then w, h and image, so that the blocks in flight share a few rows of y,
// and the whole weight through L2 (pixel tiles fastest made them sweep all
// of y, 63 MB at (4, 64, 64, 1920): 0.5511 against 0.5179 ms on an H100)
struct Origin {
  int b, h0, w0, n0;
};

__device__ __forceinline__ Origin origin(const ConvArgs& a, int t) {
  const int mt = t / a.tiles_n;
  const int hb = mt / a.tiles_w;
  Origin o;
  o.n0 = (t - mt * a.tiles_n) * kBN;
  o.w0 = (mt - hb * a.tiles_w) << a.tw_log2;
  o.h0 = (hb % a.tiles_h) * (kBM >> a.tw_log2);
  o.b = hb / a.tiles_h;
  return o;
}

// 8 adjacent outputs, 16-byte aligned: 16 bytes of bf16 or 32 of f32
__device__ __forceinline__ void store8(bf16* p, const float (&y)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(dg::pack_bf16x2(y[0], y[1]), dg::pack_bf16x2(y[2], y[3]),
                 dg::pack_bf16x2(y[4], y[5]), dg::pack_bf16x2(y[6], y[7]));
}
__device__ __forceinline__ void store8(float* p, const float (&y)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(y[4], y[5], y[6], y[7]);
}

// d (64 x 160 f32, the warpgroup's accumulator fragment) = [d +] A (64 x 16
// bf16, K-major, descriptor a) B^T, B (160 x 16 bf16, K-major, descriptor b);
// scale_d = 0 overwrites d. Fragment: thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 + {0, 8}, columns 8 j + 2 (t % 4) + {0, 1}, as
// d[4 j + {0, 1}] (row + 0), d[4 j + {2, 3}] (row + 8).
#define DG_F8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

__device__ __forceinline__ void wgmma_bf16(float (&d)[kBN / 2], uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : DG_F8(0), DG_F8(8), DG_F8(16), DG_F8(24), DG_F8(32), DG_F8(40), DG_F8(48), DG_F8(56),
        DG_F8(64), DG_F8(72)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef DG_F8

template <typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    conv_gemm_kernel(const __grid_constant__ CUtensorMap map_y,
                     const __grid_constant__ CUtensorMap map_w, const ConvArgs a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], turn[kConsumers];
  // the ring starts on a 1024-byte boundary of the shared window (the swizzle's atom)
  unsigned char* ring = smem_raw + ((1024 - (dg::smem_addr(smem_raw) & 1023)) & 1023);
  auto tile_a = [&](int st) { return ring + st * kStage; };
  auto tile_b = [&](int st) { return ring + st * kStage + kBytesA; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      dg::mbar_init(&full[s], 1);
      dg::mbar_init(&empty[s], 1);  // released by the one consumer that owns the tile
    }
    for (int c = 0; c < kConsumers; ++c) dg::mbar_init(&turn[c], 1);
    dg::mbar_init_fence();
  }
  __syncthreads();

  // the block's j-th tile is t = blockIdx.x + j * gridDim.x; its k-th stage
  // of K, channels 64 (k / 9) on of tap k % 9, is the (j * n_k + k)-th use of
  // the ring. The nine taps of a chunk run back to back, so that the rows of
  // y they share are still in L2 (with the taps outermost, the blocks in
  // flight swept all C channels between two taps: at (4, 64, 64, 1920) 65
  // MB, past L2, 0.8137 against 0.5511 ms on an H100)
  const int n_k = 9 * a.c_tiles;
  // the warpgroup index, taken from lane 0 so that the compiler knows it is
  // the same in every thread of a warp
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // producer: one thread issues every load; the warpgroup gives up registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
        const Origin o = origin(a, t);
        for (int kt = 0; kt < n_k; ++kt) {
          const int tap = kt % 9;
          const int c0 = (kt / 9) * kBK;
          dg::mbar_wait(&empty[stage], phase ^ 1);  // the first pass over the ring does not wait
          dg::mbar_arrive_expect_tx(&full[stage], kStage);
          dg::tma_load_4d(tile_a(stage), &map_y, &full[stage], c0, o.w0 + tap % 3 - 1,
                          o.h0 + tap / 3 - 1, o.b);
          dg::tma_load_3d(tile_b(stage), &map_w, &full[stage], c0, tap, o.n0);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // consumer c = wg - 1 takes the block's tiles j = c, c + 2, ...: while one
    // adds the bias and stores a tile, the other's products keep the tensor
    // cores busy. Their K loops take turns (turn[c]: the other has passed its
    // last wait on the ring), so that no consumer waits on a stage more than
    // one pass of the ring ahead of the loads, where a phase parity would alias.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid & 31;
    float acc[2][kBN / 2];  // rows 0..63 and 64..127 of the tile
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[0][i] = acc[1][i] = 0.f;  // each tile overwrites them
    for (int j = c, t = blockIdx.x + j * gridDim.x; t < a.tiles;
         j += kConsumers, t += kConsumers * gridDim.x) {
      const Origin o = origin(a, t);
      if (j > 0) dg::mbar_wait(&turn[c], ((j - 1) / kConsumers) & 1);
      int held = -1;  // the stage read by the commit group still in flight
      for (int kt = 0; kt < n_k; ++kt) {
        const int use = j * n_k + kt;
        const int stage = use % kStages;
        dg::mbar_wait(&full[stage], (use / kStages) & 1);
        const uint64_t da = dg::sw128_desc(tile_a(stage));
        const uint64_t db = dg::sw128_desc(tile_b(stage));
        dg::fence_regs(acc[0]);
        dg::fence_regs(acc[1]);
        dg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {  // 32 bytes of K per instruction
          wgmma_bf16(acc[0], da + 2 * kk, db + 2 * kk, (kt | kk) != 0);
          wgmma_bf16(acc[1], da + (64 * 128 >> 4) + 2 * kk, db + 2 * kk, (kt | kk) != 0);
        }
        dg::wgmma_commit();
        dg::fence_regs(acc[0]);
        dg::fence_regs(acc[1]);
        dg::wgmma_wait<1>();  // the previous stage's products are done: release it
        if (held >= 0 && tid == 0) dg::mbar_arrive(&empty[held]);
        held = stage;
      }
      if (tid == 0) dg::mbar_arrive(&turn[1 - c]);
      dg::wgmma_wait<0>();
      dg::fence_regs(acc[0]);
      dg::fence_regs(acc[1]);
      if (tid == 0) dg::mbar_arrive(&empty[held]);

      // epilogue in registers: + conv bias (f32) -> TO. Lane t of a quad holds
      // columns 2 t, 2 t + 1 of each block of 8; two exchanges (with lane
      // t ^ 1, then t ^ 2) leave it all 8 columns of block 4 q + t of each
      // group of 4 blocks, so that each lane stores 16 bytes (bf16) or 32
      // (f32) and a warp whole 32-byte sectors.
      const int t4 = lane & 3;
      const bool o1 = t4 & 1, o2 = t4 & 2;
      const bool vec = a.co % 8 == 0;  // whole, aligned blocks of 8 channels
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * half + (tid >> 5) * 16 + (lane >> 2) + 8 * h;  // row of the tile
          const int py = o.h0 + (r >> a.tw_log2);
          const int px = o.w0 + (r & ((1 << a.tw_log2) - 1));
          const bool inside = py < a.h && px < a.w;
          TO* orow = static_cast<TO*>(a.out) +
                     ((static_cast<int64_t>(o.b) * a.h + py) * a.w + px) * a.co;
#pragma unroll
          for (int q = 0; q < kBN / 32; ++q) {
            // with lane t ^ 1: 4 adjacent columns of blocks 4 q + o1 and 4 q + 2 + o1
            float s1[2][4];
#pragma unroll
            for (int pr = 0; pr < 2; ++pr) {
              const float l0 = acc[half][4 * (4 * q + 2 * pr) + 2 * h];
              const float l1 = acc[half][4 * (4 * q + 2 * pr) + 2 * h + 1];
              const float h0 = acc[half][4 * (4 * q + 2 * pr + 1) + 2 * h];
              const float h1 = acc[half][4 * (4 * q + 2 * pr + 1) + 2 * h + 1];
              const float r0 = __shfl_xor_sync(0xffffffffu, o1 ? l0 : h0, 1);
              const float r1 = __shfl_xor_sync(0xffffffffu, o1 ? l1 : h1, 1);
              s1[pr][0] = o1 ? r0 : l0;
              s1[pr][1] = o1 ? r1 : l1;
              s1[pr][2] = o1 ? h0 : r0;
              s1[pr][3] = o1 ? h1 : r1;
            }
            // with lane t ^ 2: the 8 columns of block 4 q + t
            float v[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float x = __shfl_xor_sync(0xffffffffu, o2 ? s1[0][i] : s1[1][i], 2);
              v[i] = o2 ? x : s1[0][i];
              v[4 + i] = o2 ? s1[1][i] : x;
            }
            const int col = o.n0 + 8 * (4 * q + t4);
            if (!inside || col >= a.co) continue;
            float y[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              y[i] = col + i < a.co ? v[i] + __ldg(a.bias + col + i) : 0.f;
            if (vec) {
              store8(orow + col, y);
            } else {
#pragma unroll
              for (int i = 0; i < 8; ++i)
                if (col + i < a.co) dg::store_one(orow + col + i, y[i]);
            }
          }
        }
    }
  }
}

// ---- host side

// a bf16 map of `rank` dimensions (dims[0] innermost, contiguous; strides
// in elements of dimensions 1 on), read in boxes under the 128-byte swizzle,
// zeros outside it; false if the encoder refuses it
bool tensor_map(CUtensorMap* map, const void* ptr, int rank, const int64_t* dims,
                const int64_t* strides, const int* box) {
  const dg::EncodeTiledFn encode = dg::encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t d[4], s[3];
  cuuint32_t bx[4], steps[4];
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    bx[i] = static_cast<cuuint32_t>(box[i]);
    steps[i] = 1;
    if (i > 0) s[i - 1] = static_cast<cuuint64_t>(strides[i - 1]) * sizeof(bf16);  // bytes
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), d, s, bx,
                steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TO>
int launch_gemm(const CUtensorMap& map_y, const CUtensorMap& map_w, const ConvArgs& a,
                int blocks, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      conv_gemm_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_gemm_kernel<TO><<<blocks, kThreads, kSmem, stream>>>(map_y, map_w, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int apply(const T* x, const float* scale, const float* bias, float* part, float* fa, float* fs,
          bf16* y, int batch, int hw, int c, int cp, int groups, int splits, float eps,
          cudaStream_t stream) {
  const bool vec = c % 8 == 0;
  cudaError_t err = vec ? dg::launch_moments<T, 8>(x, part, batch, hw, c, splits, stream)
                        : dg::launch_moments<T, 1>(x, part, batch, hw, c, splits, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cpg = c / groups;
  gnc_fold_kernel<<<dim3(groups, batch), kFoldThreads, 2 * cpg * sizeof(float), stream>>>(
      part, scale, bias, fa, fs, hw, c, groups, splits, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t chunks = static_cast<int64_t>(batch) * hw * (cp / 8);
  const unsigned blocks = static_cast<unsigned>((chunks + kApplyThreads - 1) / kApplyThreads);
  if (vec)
    gnc_apply_kernel<T, true><<<blocks, kApplyThreads, 0, stream>>>(x, fa, fs, y, chunks, hw, c,
                                                                    cp);
  else
    gnc_apply_kernel<T, false><<<blocks, kApplyThreads, 0, stream>>>(x, fa, fs, y, chunks, hw,
                                                                     c, cp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The normalized activation: x (batch, h, w, c) bf16 or, with x_f32, f32;
// scale, bias (c,) f32 (the GroupNorm affine); part (batch, splits, 2, c),
// fa and fs (batch, c) f32 scratch (fa, fs: the folded a and s); y (batch,
// h, w, cp) bf16, cp = c rounded up to 8, 16-byte aligned. groups <= 32
// divides c, with at most 4096 channels a group. Three launches: moments,
// fold, apply.
extern "C" int dg_gn_conv_apply(const void* x, const void* scale, const void* bias, void* part,
                                void* fa, void* fs, void* y, int batch, int h, int w, int c,
                                int cp, int groups, int splits, float eps, int x_f32,
                                void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || cp < c || cp % 8 || cp - c >= 8 ||
      groups <= 0 || groups > kMaxGroups || c % groups || c / groups > kMaxGroupChannels ||
      splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  float* pp = static_cast<float*>(part);
  float* fap = static_cast<float*>(fa);
  float* fsp = static_cast<float*>(fs);
  bf16* yp = static_cast<bf16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return apply(static_cast<const float*>(x), sp, bp, pp, fap, fsp, yp, batch, h * w, c, cp,
                 groups, splits, eps, st);
  return apply(static_cast<const bf16*>(x), sp, bp, pp, fap, fsp, yp, batch, h * w, c, cp,
               groups, splits, eps, st);
}

// The conv as an implicit GEMM: y (batch, h, w, cp) bf16 from
// dg_gn_conv_apply; wt (co, 3, 3, cp) bf16, zeros past c; conv_bias (co,)
// f32; out (batch, h, w, co) bf16 or, with out_f32, f32. Tiles of th x tw =
// 128 pixels (tw = 1 << tw_log2) by 160 channels on `blocks` persistent
// blocks (ops/gn_conv.py:conv_plan). y and wt 16-byte aligned.
extern "C" int dg_gn_conv_gemm(const void* y, const void* wt, const void* conv_bias, void* out,
                               int batch, int h, int w, int cp, int co, int tw_log2, int blocks,
                               int out_f32, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || cp <= 0 || cp % 8 || co <= 0 || tw_log2 < 0 ||
      tw_log2 > 7 || blocks <= 0 ||
      static_cast<int64_t>(batch) * h * w > (static_cast<int64_t>(1) << 31) - kBM)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tw = 1 << tw_log2, th = kBM / tw;
  const int64_t dims_y[4] = {cp, w, h, batch};
  const int64_t strides_y[3] = {cp, static_cast<int64_t>(w) * cp,
                                static_cast<int64_t>(h) * w * cp};
  const int box_y[4] = {kBK, tw, th, 1};
  const int64_t dims_w[3] = {cp, 9, co};
  const int64_t strides_w[2] = {cp, 9 * static_cast<int64_t>(cp)};
  const int box_w[3] = {kBK, 1, kBN};
  CUtensorMap map_y, map_w;
  if (!tensor_map(&map_y, y, 4, dims_y, strides_y, box_y) ||
      !tensor_map(&map_w, wt, 3, dims_w, strides_w, box_w))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a{};
  a.bias = static_cast<const float*>(conv_bias);
  a.out = out;
  a.h = h;
  a.w = w;
  a.co = co;
  a.tw_log2 = tw_log2;
  a.tiles_w = (w + tw - 1) / tw;
  a.tiles_h = (h + th - 1) / th;
  a.tiles_n = (co + kBN - 1) / kBN;
  a.tiles = batch * a.tiles_w * a.tiles_h * a.tiles_n;
  a.c_tiles = (cp + kBK - 1) / kBK;
  if (a.tiles < blocks) blocks = a.tiles;  // every block has a tile
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch_gemm<float>(map_y, map_w, a, blocks, s)
                 : launch_gemm<bf16>(map_y, map_w, a, blocks, s);
}
