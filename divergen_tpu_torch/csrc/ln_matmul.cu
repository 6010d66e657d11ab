// Fused LayerNorm + GEMM (+ bias) with a none / GELU / GEGLU epilogue, for
// Hopper (sm_90a): x and the weight in bf16 or f32, f32 sums, the output in
// x's type.
//
// Replaces the Pallas TPU kernel divergen_tpu/ops/pallas/ln_matmul.py:
// fused_ln_matmul (_kernel for the none/GELU epilogues, _kernel_geglu for
// GEGLU). It computes
//     y   = T( (x - mean) * rsqrt(max(E[x^2] - mean^2, 0) + eps) * g + b )
//     out = epilogue( y @ w + bias )
// with T x's type and the epilogues: none; exact-erf GELU; or GEGLU
// h * gelu(gate), where h is output column j and gate is column j + N/2,
// writing (M, N/2).
//
// What bounds it on the H100: operations. At the UNet's GEGLU shapes,
// (16384, 640, 5120) and (4096, 1280, 10240), a launch is 107.4 GFLOP
// (0.1086 ms at 989 TFLOP/s) against under 80 MB of x, weight and output
// (0.024 ms at 3.35 TB/s); SAM ViT-H's (16384, 1280, 3840 / 5120) likewise.
//
// Why the LayerNorm is a pass of its own: the TPU kernel normalizes a row
// block once into VMEM scratch (at j == 0) because its grid runs in order on
// one core. Here the blocks are independent, and a GEMM block that
// normalized its own A tiles repeated the work once per column tile: at N
// 10240 GEGLU every row 40 times, in the GEMM's critical path. The apply
// pass reads x once and writes y once (about 0.5 ms of a UNet call's 70
// launches at 3.35 TB/s, y mostly found again in L2 by the GEMM).
//
// Design: two C entry points, two launches on the caller's stream (a
// third, dg_tf32_split, for float32).
//   dg_ln_apply: ln_apply_kernel<T, CH, SPLIT>, one warp a row, each lane's
//     chunks of 8 elements held in registers as loaded (K <= 2048; a
//     longer row is read again from L1/L2), the moments in f32 by
//     shuffles, then y written once into scratch the wrapper allocates:
//     (M, K) bf16, or for float32 (SPLIT) its two tf32 parts, (2, M, K).
//   dg_ln_gemm (bf16): ln_gemm_kernel<EPI, false>, kernel 10's persistent,
//     warp-specialized GEMM (int8_matmul.cu) on bf16 wgmma m64n160k16 as
//     kernel 8 runs it (gn_conv.cu). An output tile is 128 rows by 160
//     weight rows, walked in groups of row tiles (ops/ln_matmul.py:
//     gemm_plan). Each K
//     stage is one TMA box of y (128 x 64) and two boxes of 80 rows of the
//     (N, K) weight, nn.Linear's layout read in place (no copy), stacked in
//     one shared-memory tile: rows 160 t .. 160 t + 159 for the none / GELU
//     epilogues; for GEGLU h rows 80 t .. and gate rows N/2 + 80 t ..
//     (ops/ln_matmul.py:weight_boxes). In wgmma's accumulator a thread holds
//     the same offsets in every 8-column group, so it holds h column c and
//     gate column c + 80 itself: h * gelu(gate) is formed in registers, no
//     shared-memory exchange. One producer thread keeps the loads in flight
//     through a ring of kStages mbarrier stages; two consumer warpgroups take
//     the block's tiles in turns, each holding a 128 x 160 f32 tile, so that
//     one runs its epilogue while the other's products run. The epilogue
//     adds the f32 bias, applies GELU or GEGLU, rounds to bf16 and trades
//     values within each quad so that a lane stores 16 bytes (8 for the
//     last pair of 8-column groups of a GEGLU tile), masked at the M and N
//     tails. TMA zero-fills loads past M, N and K.
//   dg_ln_gemm_f32: the same body on float32 operands (ln_gemm_kernel<EPI,
//     true>), at float32 accuracy on the TF32 tensor cores by three passes
//     (3xTF32): each operand x is held as big = tf32(x) and small = tf32(x -
//     big), both rounded to nearest (cvt.rna), and the accumulator takes
//     a_small b_big + a_big b_small + a_big b_big (about 2^-21 relative a
//     product, float32's own order; one-pass TF32's 5e-4 is not taken).
//     wgmma m64n160k8 tf32 reads both operands K-major from shared memory,
//     which y (M, K) and the weight (N, K) already are, so the split is done
//     before the GEMM: the apply pass writes y's two parts (dg_ln_apply on
//     float32 x: (2, M, K)), and dg_tf32_split writes the weight's ((2, N, K),
//     a pass over the weight per call: it reads 4 N K bytes and writes 8 N
//     K). A stage is then a 32-float (128-byte) slice of K of both parts of
//     both operands, 72 KB, three deep. Both consumers take every tile, each
//     64 of its 128 rows (consume_f32), and add each stage's products into
//     their sums in f32: the tensor core's accumulation truncates, which a
//     whole K in one accumulator showed (1e-5 relative at K = 1280). Bound:
//     2 M K N products at 494.7 / 3 = 165 TFLOP/s (the FMA body it replaced
//     was held to 67).
// No atomics: a call gives the same bits twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_moments.cuh"  // dg::load_vec, dg::store_vec
#include "mma_sm90.cuh"    // dg::smem_addr, dg::pack_bf16x2
#include "sm90_async.cuh"  // mbarriers, TMA, the swizzled descriptor, wgmma fences

namespace {

typedef __nv_bfloat16 bf16;

enum Epilogue { kNone = 0, kGelu = 1, kGeglu = 2 };

constexpr int kApplyRows = 8;       // rows per block of the apply pass (one a warp)

constexpr int kBM = 128;            // output rows per tile
constexpr int kBox = 80;            // weight rows per TMA box (ops/ln_matmul.py: WEIGHT_BOX)
constexpr int kBN = 2 * kBox;       // weight rows per tile: the wgmma's N
constexpr int kConsumers = 2;       // warpgroups, each on tiles of its own
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBytesA = kBM * 128;  // a stage's slice of K is one 128-byte swizzle row
constexpr int kBytesBox = kBox * 128;
constexpr int kBytesPart = kBytesA + 2 * kBytesBox;  // y's and the weight's tiles of one part
static_assert(kBytesA % 1024 == 0 && kBytesBox % 1024 == 0, "swizzle atoms stay aligned");

// the ring of the bf16 body (F32 false) and of the float32 one (3xTF32)
template <bool F32>
struct Ring {
  static constexpr int kBK = F32 ? 32 : 64;      // K per stage: 128 bytes of a row
  static constexpr int kParts = F32 ? 2 : 1;     // big and small parts of each operand
  // depth: on an H100 (tools/ln_matmul_ab.py), 6 bf16 stages were within 1 %
  // of 4 at the UNet's and SAM's four shapes; three float32 stages fill the
  // block's shared memory
  static constexpr int kStages = F32 ? 3 : 4;
  static constexpr int kStage = kParts * kBytesPart;
  static constexpr int kSmem = kStages * kStage + 1024;  // + slack to align the ring to 1024
  static_assert(kSmem + 256 <= 232448, "the ring and the barriers fit in a block's 227 KB");
};

// the tensor maps of y and the weight, one for each part
struct Maps {
  CUtensorMap y[2];
  CUtensorMap w[2];
};

// exact-erf GELU; the TPU kernel's Abramowitz-Stegun erf (a division and an
// exp) took 0.2252 against erff's 0.2001 ms at (16384, 640, 5120) GEGLU
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// ---- the apply pass

// 8 elements of T as they are loaded: 16 bytes of bf16, 32 of f32
template <typename T>
struct Raw {
  uint4 w[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ void load_raw(const T* p, Raw<T>& r) {
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T)) / 2; ++i)
    r.w[i] = reinterpret_cast<const uint4*>(p)[i];
}

__device__ __forceinline__ void unpack(const Raw<bf16>& r, float (&v)[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&r.w[0]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h2[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const Raw<float>& r, float (&v)[8]) {
  const float* f = reinterpret_cast<const float*>(&r.w[0]);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = f[j];
}

// y (m, k) T = T((x - mean) rstd g + b), one warp per row; k % 8 == 0. A
// lane holds its CH chunks of 8 elements as loaded (k <= 256 CH; raw bf16
// takes half the registers of floats, so more rows are in flight), all
// loads issued before the first sum; CH = 0 reads the row again instead.
// SPLIT (float32): y is (2, m, k), its big then its small tf32 part.
template <typename T, int CH, bool SPLIT>
__global__ void __launch_bounds__(32 * kApplyRows) ln_apply_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    T* __restrict__ y, int m, int k, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kApplyRows + (threadIdx.x >> 5);
  if (row >= m) return;
  const T* xr = x + static_cast<int64_t>(row) * k;
  T* yr = y + static_cast<int64_t>(row) * k;
  Raw<T> raw[CH > 0 ? CH : 1];
  float s = 0.f, ss = 0.f;
  auto add = [&](const float (&v)[8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s += v[j];
      ss += v[j] * v[j];
    }
  };
  if constexpr (CH > 0) {
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if ((lane + 32 * i) * 8 < k) load_raw(xr + (lane + 32 * i) * 8, raw[i]);
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if ((lane + 32 * i) * 8 < k) {
        float v[8];
        unpack(raw[i], v);
        add(v);
      }
  } else {
    for (int c = lane * 8; c < k; c += 256) {
      float v[8];
      dg::load_vec<8>(xr + c, v);
      add(v);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const float mean = s / k;
  const float rstd = 1.f / sqrtf(fmaxf(ss / k - mean * mean, 0.f) + eps);
  auto write = [&](int c, const float (&u)[8]) {
    float g[8], b[8], o[8];
    dg::load_vec<8>(gamma + c, g);
    dg::load_vec<8>(beta + c, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = (u[j] - mean) * rstd * g[j] + b[j];
    if constexpr (SPLIT) {
      float lo[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t big, small;
        dg::tf32_split(o[j], big, small);
        o[j] = __uint_as_float(big);
        lo[j] = __uint_as_float(small);
      }
      dg::store_vec<8>(yr + static_cast<int64_t>(m) * k + c, lo);
    }
    dg::store_vec<8>(yr + c, o);
  };
  if constexpr (CH > 0) {
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if ((lane + 32 * i) * 8 < k) {
        float v[8];
        unpack(raw[i], v);
        write((lane + 32 * i) * 8, v);
      }
  } else {
    for (int c = lane * 8; c < k; c += 256) {
      float v[8];
      dg::load_vec<8>(xr + c, v);
      write(c, v);
    }
  }
}

template <typename T, bool SPLIT>
int launch_apply(const T* x, const float* gamma, const float* beta, T* y, int m, int k,
                 float eps, cudaStream_t stream) {
  const int blocks = (m + kApplyRows - 1) / kApplyRows;
  const int threads = 32 * kApplyRows;
  switch ((k + 255) / 256) {  // chunks a lane holds
#define DG_APPLY(CH)                                                                   \
  case CH:                                                                             \
    ln_apply_kernel<T, CH, SPLIT><<<blocks, threads, 0, stream>>>(x, gamma, beta, y, m, k, eps); \
    break;
    DG_APPLY(1) DG_APPLY(2) DG_APPLY(3) DG_APPLY(4) DG_APPLY(5) DG_APPLY(6) DG_APPLY(7)
    DG_APPLY(8)
#undef DG_APPLY
    default:
      ln_apply_kernel<T, 0, SPLIT><<<blocks, threads, 0, stream>>>(x, gamma, beta, y, m, k, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- the GEMM: bf16, or float32 by 3xTF32

struct GemmArgs {
  const float* bias;  // (n,) f32 or null
  void* out;          // (m, out_cols) bf16, or f32 for the float32 body
  int m, out_cols;
  // tile column u reads weight rows u step + [0, 80) and u step + off2 + [0, 80)
  int step, off2;
  int tiles_m, tiles_n, tiles;
  int group;          // row tiles of a group (ops/ln_matmul.py:GemmPlan)
  int k_tiles;
};

// tile t of the plan (ops/ln_matmul.py:GemmPlan.tiles): groups of `group`
// row tiles, each swept over every column tile, row tiles fastest inside a
// group, so that the blocks in flight share a band of y and of the weight
__device__ __forceinline__ int2 tile_of(const GemmArgs& a, int t) {
  const int per_group = a.group * a.tiles_n;
  const int gi = t / per_group, local = t - gi * per_group;
  const int rows = min(a.group, a.tiles_m - gi * a.group);
  return make_int2(gi * a.group + local % rows, local / rows);
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

// the same on tf32 operands (float32 storage, the low 13 bits clear), K 8
__device__ __forceinline__ void wgmma_tf32(float (&d)[kBN / 2], uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1;\n}\n"
      : DG_F8(0), DG_F8(8), DG_F8(16), DG_F8(24), DG_F8(32), DG_F8(40), DG_F8(48), DG_F8(56),
        DG_F8(64), DG_F8(72)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef DG_F8

// The float32 body's consumer warpgroup c: both consumers take every tile of
// the block, consumer c its rows 64 c .. 64 c + 63 (80 accumulator registers,
// beside 80 of sums). A stage's twelve products (four 8-deep steps of K, each
// in three passes, the small terms first) go into `part` from zero, which is
// then added into `sum` in f32: the tensor core's own accumulation truncates,
// and over a whole K (up to 1920 products into one accumulator at K = 5120)
// that drifted by 1e-5 relative on an H100; a stage at a time it stays at
// float32's order. Then the epilogue: + bias, GELU or GEGLU, each lane storing
// its two columns of every 8-column group (a quad's 32 contiguous bytes).
template <int EPI>
__device__ __forceinline__ void consume_f32(const GemmArgs& a, int c, int tid, int lane, int n_k,
                                            unsigned char* ring, uint64_t* full,
                                            uint64_t* empty) {
  typedef Ring<true> R;
  constexpr int kGroups = EPI == kGeglu ? kBox / 8 : kBN / 8;
  constexpr uint64_t kSmall = kBytesPart >> 4;  // the small part's tile, in descriptor units
  float sum[kBN / 2], part[kBN / 2];
  for (int j = 0, t = blockIdx.x; t < a.tiles; ++j, t += gridDim.x) {
    const int2 tile = tile_of(a, t);
    const int m0 = tile.x * kBM + 64 * c;
    const int col0 = tile.y * a.step;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sum[i] = 0.f;
    for (int kt = 0; kt < n_k; ++kt) {
      const int use = j * n_k + kt;
      const int stage = use % R::kStages;
      dg::mbar_wait(&full[stage], (use / R::kStages) & 1);
      unsigned char* base = ring + stage * R::kStage;
      const uint64_t da = dg::sw128_desc(base) + c * (64 * 128 >> 4);
      const uint64_t db = dg::sw128_desc(base + kBytesA);
      dg::fence_regs(part);
      dg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tf32(part, da + kSmall + 2 * kk, db + 2 * kk, kk != 0);
        wgmma_tf32(part, da + 2 * kk, db + kSmall + 2 * kk, 1);
        wgmma_tf32(part, da + 2 * kk, db + 2 * kk, 1);
      }
      dg::wgmma_commit();
      dg::wgmma_wait<0>();
      dg::fence_regs(part);
      if (tid == 0) dg::mbar_arrive(&empty[stage]);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sum[i] += part[i];
    }
    const int t4 = lane & 3;
    float* out = static_cast<float*>(a.out);
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const int col = col0 + 8 * gi + 2 * t4;
      float bh[2] = {0.f, 0.f}, bg[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (a.bias != nullptr && col + e < a.out_cols) {
          bh[e] = __ldg(a.bias + col + e);
          if (EPI == kGeglu) bg[e] = __ldg(a.bias + a.off2 + col + e);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + (tid >> 5) * 16 + (lane >> 2) + 8 * h;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = sum[4 * gi + 2 * h + e] + bh[e];
          if (EPI == kGeglu) {
            v[e] *= gelu_erf(sum[4 * (gi + kGroups) + 2 * h + e] + bg[e]);
          } else if (EPI == kGelu) {
            v[e] = gelu_erf(v[e]);
          }
        }
        if (row < a.m && col < a.out_cols)
          *reinterpret_cast<float2*>(out + static_cast<int64_t>(row) * a.out_cols + col) =
              make_float2(v[0], v[1]);
      }
    }
  }
}

// F32: float32 y and weight, each as its two tf32 parts (maps y[0], w[0]
// the big parts, y[1], w[1] the small ones), the output in float32
template <int EPI, bool F32>
__global__ void __launch_bounds__(kThreads, 1)
    ln_gemm_kernel(const __grid_constant__ Maps maps, const GemmArgs a) {
  typedef Ring<F32> R;
  constexpr int kStages = R::kStages, kStage = R::kStage, kBK = R::kBK;
  // 8-column groups of the output tile: 10 (GEGLU: h is groups 0..9, gate 10..19) or 20
  constexpr int kGroups = EPI == kGeglu ? kBox / 8 : kBN / 8;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], turn[kConsumers];
  // the ring starts on a 1024-byte boundary of the shared window (the swizzle's atom)
  unsigned char* ring = smem_raw + ((1024 - (dg::smem_addr(smem_raw) & 1023)) & 1023);
  auto tile_a = [&](int st, int part) { return ring + st * kStage + part * kBytesPart; };
  auto tile_b = [&](int st, int part) { return tile_a(st, part) + kBytesA; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      dg::mbar_init(&full[s], 1);
      // released by the one consumer that owns the tile (float32: by both)
      dg::mbar_init(&empty[s], F32 ? kConsumers : 1);
    }
    for (int c = 0; c < kConsumers; ++c) dg::mbar_init(&turn[c], 1);
    dg::mbar_init_fence();
  }
  __syncthreads();

  // the block's j-th tile is t = blockIdx.x + j * gridDim.x; its k-th stage
  // of K is the (j * k_tiles + k)-th use of the ring
  const int n_k = a.k_tiles;
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
        const int2 tile = tile_of(a, t);
        const int m0 = tile.x * kBM;
        const int r0 = tile.y * a.step;
        for (int kt = 0; kt < n_k; ++kt) {
          dg::mbar_wait(&empty[stage], phase ^ 1);  // the first pass over the ring does not wait
          dg::mbar_arrive_expect_tx(&full[stage], kStage);
#pragma unroll
          for (int part = 0; part < R::kParts; ++part) {
            dg::tma_load_2d(tile_a(stage, part), &maps.y[part], &full[stage], kt * kBK, m0);
            dg::tma_load_2d(tile_b(stage, part), &maps.w[part], &full[stage], kt * kBK, r0);
            dg::tma_load_2d(tile_b(stage, part) + kBytesBox, &maps.w[part], &full[stage],
                            kt * kBK, r0 + a.off2);
          }
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // consumer c = wg - 1 takes the block's tiles j = c, c + 2, ...: while one
    // runs its epilogue, the other's products keep the tensor cores busy.
    // Their K loops take turns (turn[c]: the other has passed its last wait
    // on the ring), so that no consumer waits on a stage more than one pass
    // of the ring ahead of the loads, where a phase parity would alias.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid & 31;
    if constexpr (F32) {
      consume_f32<EPI>(a, c, tid, lane, n_k, ring, full, empty);
      return;
    }
    float acc[2][kBN / 2];  // rows 0..63 and 64..127 of the tile
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[0][i] = acc[1][i] = 0.f;  // each tile overwrites them
    for (int j = c, t = blockIdx.x + j * gridDim.x; t < a.tiles;
         j += kConsumers, t += kConsumers * gridDim.x) {
      const int2 tile = tile_of(a, t);
      const int m0 = tile.x * kBM;
      const int col0 = tile.y * a.step;  // the tile's first output column
      if (j > 0) dg::mbar_wait(&turn[c], ((j - 1) / kConsumers) & 1);
      int held = -1;  // the stage read by the commit group still in flight
      for (int kt = 0; kt < n_k; ++kt) {
        const int use = j * n_k + kt;
        const int stage = use % kStages;
        dg::mbar_wait(&full[stage], (use / kStages) & 1);
        const uint64_t da = dg::sw128_desc(tile_a(stage, 0));
        const uint64_t db = dg::sw128_desc(tile_b(stage, 0));
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

      // epilogue in registers, one run of column groups at a time (the bias
      // of those groups only, the accumulators dying as they are stored: the
      // whole tile's bias at once spilled 28 bytes for GEGLU, 96 for GELU,
      // and took 0.2154 against 0.2001 ms at (16384, 640, 5120) on an H100):
      // + bias (f32), then GELU, or GEGLU with the gate
      // kBox columns further on; then the stores. Lane t of a quad holds
      // columns 2 t, 2 t + 1 of each group of 8; two exchanges (with lane
      // t ^ 1, then t ^ 2) leave it all 8 columns of group 4 q + t of each
      // run of 4 groups (16-byte stores, a warp writing whole 32-byte
      // sectors); a last pair of groups (GEGLU's 8 and 9) takes one exchange
      // and 8-byte stores
      const int t4 = lane & 3;
      const bool o1 = t4 & 1, o2 = t4 & 2;
      // the output of group g's column 2 t + e in row 8 h of half `half`
      auto value = [&](int half, int g, int h, int e, const float (&bh)[2],
                       const float (&bg)[2]) {
        float v = acc[half][4 * g + 2 * h + e] + bh[e];
        if (EPI == kGeglu) {
          v *= gelu_erf(acc[half][4 * (g + kGroups) + 2 * h + e] + bg[e]);
        } else if (EPI == kGelu) {
          v = gelu_erf(v);
        }
        return v;
      };
      // the f32 bias of group g's columns 2 t, 2 t + 1 (and of their gates)
      auto bias_of = [&](int g, float (&bh)[2], float (&bg)[2]) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * g + 2 * t4 + e;
          const bool in = a.bias != nullptr && col < a.out_cols;
          bh[e] = in ? __ldg(a.bias + col) : 0.f;
          bg[e] = in && EPI == kGeglu ? __ldg(a.bias + a.off2 + col) : 0.f;
        }
      };
      bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
      for (int q = 0; q < kGroups / 4; ++q) {
        float bh[4][2], bg[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) bias_of(4 * q + i, bh[i], bg[i]);
        const int col = col0 + 8 * (4 * q + t4);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + 64 * half + (tid >> 5) * 16 + (lane >> 2) + 8 * h;
            // with lane t ^ 1: 4 adjacent columns of groups 4 q + o1 and 4 q + 2 + o1
            float s1[2][4];
#pragma unroll
            for (int pr = 0; pr < 2; ++pr) {
              const int gl = 4 * q + 2 * pr, il = 2 * pr;
              const float l0 = value(half, gl, h, 0, bh[il], bg[il]);
              const float l1 = value(half, gl, h, 1, bh[il], bg[il]);
              const float h0 = value(half, gl + 1, h, 0, bh[il + 1], bg[il + 1]);
              const float h1 = value(half, gl + 1, h, 1, bh[il + 1], bg[il + 1]);
              const float r0 = __shfl_xor_sync(0xffffffffu, o1 ? l0 : h0, 1);
              const float r1 = __shfl_xor_sync(0xffffffffu, o1 ? l1 : h1, 1);
              s1[pr][0] = o1 ? r0 : l0;
              s1[pr][1] = o1 ? r1 : l1;
              s1[pr][2] = o1 ? h0 : r0;
              s1[pr][3] = o1 ? h1 : r1;
            }
            // with lane t ^ 2: the 8 columns of group 4 q + t
            float v[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float x = __shfl_xor_sync(0xffffffffu, o2 ? s1[0][i] : s1[1][i], 2);
              v[i] = o2 ? x : s1[0][i];
              v[4 + i] = o2 ? s1[1][i] : x;
            }
            if (row < a.m && col < a.out_cols)  // out_cols % 8 == 0: whole groups
              *reinterpret_cast<uint4*>(out + static_cast<int64_t>(row) * a.out_cols + col) =
                  make_uint4(dg::pack_bf16x2(v[0], v[1]), dg::pack_bf16x2(v[2], v[3]),
                             dg::pack_bf16x2(v[4], v[5]), dg::pack_bf16x2(v[6], v[7]));
          }
      }
      if constexpr (kGroups % 4 == 2) {
        // groups p and p + 1: lane t (t even) gets columns 2 t .. 2 t + 3 of
        // group p, lane t + 1 the same columns of group p + 1
        constexpr int p = kGroups - 2;
        float bh[2][2], bg[2][2];
        bias_of(p, bh[0], bg[0]);
        bias_of(p + 1, bh[1], bg[1]);
        const int col = col0 + 8 * (p + o1) + 4 * (t4 >> 1);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + 64 * half + (tid >> 5) * 16 + (lane >> 2) + 8 * h;
            const float l0 = value(half, p, h, 0, bh[0], bg[0]);
            const float l1 = value(half, p, h, 1, bh[0], bg[0]);
            const float h0 = value(half, p + 1, h, 0, bh[1], bg[1]);
            const float h1 = value(half, p + 1, h, 1, bh[1], bg[1]);
            const float r0 = __shfl_xor_sync(0xffffffffu, o1 ? l0 : h0, 1);
            const float r1 = __shfl_xor_sync(0xffffffffu, o1 ? l1 : h1, 1);
            if (row < a.m && col < a.out_cols)
              *reinterpret_cast<uint2*>(out + static_cast<int64_t>(row) * a.out_cols + col) =
                  o1 ? make_uint2(dg::pack_bf16x2(r0, r1), dg::pack_bf16x2(h0, h1))
                     : make_uint2(dg::pack_bf16x2(l0, l1), dg::pack_bf16x2(r0, r1));
          }
      }
    }
  }
}

// the weight's two tf32 parts: big[i] = tf32(x[i]), small[i] = tf32(x[i] -
// big[i]), four elements a thread and step
__global__ void tf32_split_kernel(const float4* __restrict__ x, float4* __restrict__ big,
                                  float4* __restrict__ small, int64_t n4) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 v = x[i];
    uint32_t bx, by, bz, bw, sx, sy, sz, sw;
    dg::tf32_split(v.x, bx, sx);
    dg::tf32_split(v.y, by, sy);
    dg::tf32_split(v.z, bz, sz);
    dg::tf32_split(v.w, bw, sw);
    big[i] = make_float4(__uint_as_float(bx), __uint_as_float(by), __uint_as_float(bz),
                         __uint_as_float(bw));
    small[i] = make_float4(__uint_as_float(sx), __uint_as_float(sy), __uint_as_float(sz),
                           __uint_as_float(sw));
  }
}

// ---- host side

// the bf16 (or f32) map of a row-major (rows, cols) matrix read in boxes of
// box_rows x 128 bytes under the 128-byte swizzle, zeros past its edges;
// false if the encoder refuses it
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows, bool f32) {
  const dg::EncodeTiledFn encode = dg::encode_tiled();
  if (encode == nullptr) return false;
  const int elem = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};  // bytes
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int EPI, bool F32>
int launch_gemm(const Maps& maps, const GemmArgs& a, int blocks, cudaStream_t stream) {
  constexpr int smem = Ring<F32>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      ln_gemm_kernel<EPI, F32>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_gemm_kernel<EPI, F32><<<blocks, kThreads, smem, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

// the GEMM on maps already encoded: the tile walk of ops/ln_matmul.py:gemm_plan
template <bool F32>
int run_gemm(const Maps& maps, const void* bias, void* out, int m, int n, int k, int epilogue,
             int blocks, int group, cudaStream_t s) {
  const bool geglu = epilogue == kGeglu;
  GemmArgs a{};
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.m = m;
  a.out_cols = geglu ? n / 2 : n;
  a.step = geglu ? kBox : kBN;
  a.off2 = geglu ? n / 2 : kBox;
  a.tiles_m = (m + kBM - 1) / kBM;
  a.tiles_n = (a.out_cols + a.step - 1) / a.step;
  a.tiles = a.tiles_m * a.tiles_n;
  a.group = group < a.tiles_m ? group : a.tiles_m;
  a.k_tiles = (k + Ring<F32>::kBK - 1) / Ring<F32>::kBK;
  if (a.tiles < blocks) blocks = a.tiles;  // every block has a tile
  switch (epilogue) {
    case kNone: return launch_gemm<kNone, F32>(maps, a, blocks, s);
    case kGelu: return launch_gemm<kGelu, F32>(maps, a, blocks, s);
    default: return launch_gemm<kGeglu, F32>(maps, a, blocks, s);
  }
}

bool gemm_args_ok(int m, int n, int k, int epilogue, int blocks, int group) {
  const bool geglu = epilogue == kGeglu;
  return m > 0 && n > 0 && k > 0 && k % 8 == 0 && n % (geglu ? 16 : 8) == 0 && blocks > 0 &&
         group > 0 && epilogue >= kNone && epilogue <= kGeglu;
}

}  // namespace

// y = the LayerNorm of x (m, k) with gamma, beta (k,) f32: bf16 x gives y
// (m, k) bf16; float32 x (x_f32) gives y (2, m, k) f32, its big then its
// small tf32 part, for the float32 GEMM. k a multiple of 8, x and y 16-byte
// aligned
extern "C" int dg_ln_apply(const void* x, const void* gamma, const void* beta, void* y, int m,
                           int k, float eps, int x_f32, void* stream) {
  if (m <= 0 || k <= 0 || k % 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  return x_f32 ? launch_apply<float, true>(static_cast<const float*>(x), g, b,
                                           static_cast<float*>(y), m, k, eps, s)
               : launch_apply<bf16, false>(static_cast<const bf16*>(x), g, b,
                                           static_cast<bf16*>(y), m, k, eps, s);
}

// out = epilogue(y @ wt^T + bias): y (m, k) bf16 from dg_ln_apply, wt (n, k)
// bf16 (nn.Linear's weight), bias (n,) f32 or null, out (m, n) bf16, or (m,
// n / 2) for GEGLU; k a multiple of 8, n of 8 (of 16 for GEGLU), y and wt
// 16-byte aligned. `blocks` persistent blocks walk the tiles in groups of
// `group` row tiles (ops/ln_matmul.py:gemm_plan).
extern "C" int dg_ln_gemm(const void* y, const void* wt, const void* bias, void* out, int m,
                          int n, int k, int epilogue, int blocks, int group, void* stream) {
  if (!gemm_args_ok(m, n, k, epilogue, blocks, group))
    return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  if (!tensor_map(&maps.y[0], y, m, k, kBM, false) ||
      !tensor_map(&maps.w[0], wt, n, k, kBox, false))
    return static_cast<int>(cudaErrorInvalidValue);
  return run_gemm<false>(maps, bias, out, m, n, k, epilogue, blocks, group,
                         static_cast<cudaStream_t>(stream));
}

// The same at float32 accuracy (3xTF32): y2 (2, m, k) from dg_ln_apply's
// mode 2, wt2 (2, n, k) from dg_tf32_split of nn.Linear's (n, k) weight,
// out f32
extern "C" int dg_ln_gemm_f32(const void* y2, const void* wt2, const void* bias, void* out,
                              int m, int n, int k, int epilogue, int blocks, int group,
                              void* stream) {
  if (!gemm_args_ok(m, n, k, epilogue, blocks, group))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* y = static_cast<const float*>(y2);
  const float* w = static_cast<const float*>(wt2);
  Maps maps;
  if (!tensor_map(&maps.y[0], y, m, k, kBM, true) ||
      !tensor_map(&maps.y[1], y + static_cast<int64_t>(m) * k, m, k, kBM, true) ||
      !tensor_map(&maps.w[0], w, n, k, kBox, true) ||
      !tensor_map(&maps.w[1], w + static_cast<int64_t>(n) * k, n, k, kBox, true))
    return static_cast<int>(cudaErrorInvalidValue);
  return run_gemm<true>(maps, bias, out, m, n, k, epilogue, blocks, group,
                        static_cast<cudaStream_t>(stream));
}

// out (2, count) = the tf32 parts of x (count): big then small; count a
// multiple of 4, x and out 16-byte aligned
extern "C" int dg_tf32_split(const void* x, void* out, int64_t count, void* stream) {
  if (count <= 0 || count % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n4 = count / 4;
  const int64_t blocks = (n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096;
  float4* o = static_cast<float4*>(out);
  tf32_split_kernel<<<static_cast<unsigned>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), o, o + n4, n4);
  return static_cast<int>(cudaGetLastError());
}
