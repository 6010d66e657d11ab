// Swin window attention for Hopper (sm_90a), forward and backward, bf16 in and
// out, f32 softmax.
//
// Replaces two Pallas TPU kernels of divergen_tpu/ops/pallas/window_attention.py
// (forward bodies _fwd_kernel_packed and _fwd_kernel; the backward, further
// down in this file, replaces _bwd_kernel_packed and _bwd_kernel):
//   * fused_window_attention_packed (_fwd_kernel_packed): per window,
//     softmax(q k^T d^-1/2 + bias[h] + mask[b % nW]) v with q, k and v read
//     straight out of the fused (bn, n, 3C) projection, channels [q | k | v],
//     written to (bn, n, C) with no transposes;
//   * fused_window_attention (_fwd_kernel): the same on split (B, H, N, D)
//     tensors.
// Both are one body, forward and backward: q, k, v and o are addressed as
// base + b*batch_stride + h*head_stride + row*row_stride, so the packed
// layout, contiguous (B, H, N, D) tensors and heads-first views of a fused
// projection differ only in the strides the wrapper passes (one rank-4 TMA map
// per operand, window_map). The TPU kernel's blocking (G windows x HB heads
// per grid step, head blocks of 128 lanes, which is why six heads fall back to
// the split kernel there) does not carry over: any head count >= 1 takes the
// same path here.
//
// What bounds the forward on the H100: bytes. A window of 144 tokens at d = 32
// does 4*n*n*d = 2.7 MFLOP on 36 KB of q, k, v and o, 73 operations per byte,
// under the card's 295; at Swin-L's first stage (722 windows, 6 heads) that
// is 160 MB of q/k/v/o against 11.5 GFLOP. The (n, n) scores and
// probabilities must therefore never reach device memory, and the f32 bias
// (H, n, n) and shift mask (nW, n, n), 83 KB each a window and head at
// n = 144, must not be fetched again for every window and head from scattered
// addresses. What the forward does (window_attn_fwd_kernel):
//   * A block of NT warps (NT 16-row tiles cover n) takes one head and a
//     chunk of consecutive windows (ops/window_attention.py:forward_plan: as
//     many chunks as fill the blocks the card holds at once, one at n = 144),
//     and stages the head's bias once, scaled to units of q k^T, in shared
//     memory; keys past n hold -1e30, which masks them, so no score is tested
//     against n.
//   * q, k and v come by TMA (the backward's maps, rows past n zero-filled)
//     on mbarriers into buffers of two windows: the next window's arrive
//     while this one's products run. When n % 4 == 0 the window's mask comes
//     as one bulk asynchronous copy into a tile of its own, issued as soon as
//     every warp has read the previous one; else it is read from L2 into the
//     score registers at the end of the previous window.
//   * A warp owns 16 query rows and all keys: its scores start as bias +
//     mask (units of q k^T, as the backward recomputes them), take q k^T from
//     m16n8k16 bf16 products, and go through the whole softmax in base 2 in
//     registers. The normalized probabilities are rounded to bf16 and reused
//     in registers as the A operand of P V, and the 16 x 32 f32 result is
//     written as bf16. Rows past n are not written, so any 1 <= n <= 144
//     works (n = 49, 16 and 4 occur when the window shrinks on small maps).
//   * Keys are permuted within 16-key slabs (slot_key) so that a thread's
//     bias and mask come as 16-byte reads; the bias tile's rows are 16 (mod
//     32) floats apart, so those reads are conflict-free.
//   * Measured on an H100 against alternatives (PERF.md): two groups of nine
//     warps on alternate windows (18 warps cap a thread at 96 registers and
//     spilled: 0.2323 against 0.1565 ms at stage 1 with the mask), three
//     q/k/v buffers, each warp's bias rows kept in registers (spilled), two
//     P V accumulator chains: each slower. The mask's bulk copy took stage 1
//     with the mask from 0.1543 to 0.1361 ms; the softmax's max and sum in two
//     chains a row took 3-4 % off.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "sm90_async.cuh"  // mbarriers, TMA, the encoder

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kD = 32;               // head dim
constexpr int kRowBytes = kD * 2;    // a row of a q, k, v or do tile: 64 bytes, no padding
constexpr int kSwizzleSpan = 512;    // the 64-byte swizzle's pattern repeats every 512 bytes
constexpr int kMaxTokens = 144;

// ---------------------------------------------------------------------------
// What both directions share: tiles of one window and head as TMA writes them,
// the m16n8k16 products over them, the clamped bias and mask loads, the maps.

// the 16-byte chunk `chunk` (eight of d's 32 columns) of `row` in a tile that
// TMA wrote under the 64-byte swizzle: the chunk index is XORed with bits 7-8
// of the row's offset
__device__ __forceinline__ const unsigned char* sw64(const unsigned char* tile, int row,
                                                     int chunk) {
  return tile + row * kRowBytes + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// the A fragments of rows row0..row0+15 of a swizzled tile, over d = 32
__device__ __forceinline__ void load_rows(uint32_t (&af)[kD / 16][4], const unsigned char* t,
                                          int row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    dg::ldmatrix_x4(af[kk], sw64(t, row0 + (lane & 15), kk * 2 + (lane >> 4)));
}

// (c0, c1) += (16 rows in af) x (rows nb*16..+15 of the swizzled tile t)^T over
// d = 32: columns nb*16 + {2t, 2t+1} in c0 and + 8 in c1
__device__ __forceinline__ void rows_times_rows(float (&c0)[4], float (&c1)[4],
                                                const uint32_t (&af)[kD / 16][4],
                                                const unsigned char* t, int nb, int lane) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t kb[4];
    dg::ldmatrix_x4(kb, sw64(t, nb * 16 + (lane & 7) + ((lane >> 4) << 3),
                             kk * 2 + ((lane >> 3) & 1)));
    dg::mma_bf16_16816(c0, af[kk], kb[0], kb[1]);
    dg::mma_bf16_16816(c1, af[kk], kb[2], kb[3]);
  }
}

// acc (16 x 32) += a (16 x 16, the A layout) x (rows ks*16..+15 of the swizzled tile t)
__device__ __forceinline__ void frag_times_tile(float (&acc)[kD / 8][4], const uint32_t (&a)[4],
                                                const unsigned char* t, int ks, int lane) {
#pragma unroll
  for (int db = 0; db < kD / 16; ++db) {
    uint32_t vb[4];
    dg::ldmatrix_x4_trans(vb, sw64(t, ks * 16 + (lane & 15), db * 2 + (lane >> 4)));
    dg::mma_bf16_16816(acc[2 * db], a, vb[0], vb[1]);
    dg::mma_bf16_16816(acc[2 * db + 1], a, vb[2], vb[3]);
  }
}

// rows row0 + g and row0 + g + 8 of a 16 x 32 f32 accumulator, times `mul`, as bf16
__device__ __forceinline__ void store_rows(bf16* base, int64_t row_stride,
                                           const float (&acc)[kD / 8][4], float mul, int row0,
                                           int n, int g, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= n) continue;
    bf16* dst = base + row * row_stride + 2 * t4;
#pragma unroll
    for (int c = 0; c < kD / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(dst + c * 8) =
          __floats2bfloat162_rn(acc[c][2 * r] * mul, acc[c][2 * r + 1] * mul);
  }
}

// the box of window b and head h (rows 0..NP-1; the host put head and window
// at coordinates head_at and batch_at of the map)
__device__ __forceinline__ void tma_window(void* dst, const CUtensorMap* map, uint64_t* bar,
                                           int head_at, int batch_at, int h, int b) {
  const int c1 = head_at == 1 ? h : (batch_at == 1 ? b : 0);
  const int c2 = head_at == 2 ? h : (batch_at == 2 ? b : 0);
  const int c3 = head_at == 3 ? h : (batch_at == 3 ? b : 0);
  dg::tma_load_4d(dst, map, bar, 0, c1, c2, c3);
}

// an (n, n) f32 matrix (bias[h] or mask[b % nW]) at this thread's (row, key)
// pairs of the 16-row tile at row0, in the scores' layout. The indices of rows
// and keys past n are clamped (their scores are masked or never used), so no
// load sits behind a branch and all of them can be in flight at once.
template <int NT, bool PAIRS>
__device__ __forceinline__ void load_pairs_as(float (&x)[2 * NT][4], const float* src, int row0,
                                              int n, int g, int t4) {
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t row = min(row0 + g + r * 8, n - 1);
      const int key = j * 8 + 2 * t4;
      if (PAIRS) {  // n even: key < n means key + 1 < n
        const float2 v =
            __ldg(reinterpret_cast<const float2*>(src + row * n + (key < n ? key : 0)));
        x[j][2 * r] = v.x;
        x[j][2 * r + 1] = v.y;
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) x[j][2 * r + e] = __ldg(src + row * n + min(key + e, n - 1));
      }
    }
}

template <int NT>
__device__ __forceinline__ void load_pairs(float (&x)[2 * NT][4], const float* src, int row0,
                                           int n, int g, int t4) {
  if ((n & 1) == 0) load_pairs_as<NT, true>(x, src, row0, n, g, t4);  // 8-byte aligned pairs
  else load_pairs_as<NT, false>(x, src, row0, n, g, t4);
}

// A rank-4 bf16 map of one operand, (d = 32, n, heads, batch) at element
// strides rs, hs and bs, read in boxes of one window and head (32 x `rows`)
// under the 64-byte swizzle, zeros past n. Dimensions 1-3 go in order of
// stride (the packed layout's heads lie inside its rows); head_at and batch_at
// say which coordinate the head and the window became. False if the encoder
// refuses it.
bool window_map(CUtensorMap* map, int* head_at, int* batch_at, const void* ptr, int n, int heads,
                int batch, int64_t rs, int64_t hs, int64_t bs, int rows) {
  const dg::EncodeTiledFn encode = dg::encode_tiled();
  if (encode == nullptr) return false;
  const int64_t ext[3] = {n, heads, batch};
  const int64_t str[3] = {rs, hs, bs};
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && str[order[j - 1]] > str[order[j]]; --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  cuuint64_t dims[4] = {kD, 1, 1, 1};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {kD, 1, 1, 1};
  cuuint32_t steps[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    const int o = order[i];
    dims[i + 1] = static_cast<cuuint64_t>(ext[o]);
    strides[i] = static_cast<cuuint64_t>(str[o]) * sizeof(bf16);  // bytes
    if (o == 0) box[i + 1] = static_cast<cuuint32_t>(rows);
    if (o == 1) *head_at = i + 1;
    if (o == 2) *batch_at = i + 1;
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 16-row tiles of the bodies that take n tokens (0 if none does)
int body_tiles(int n) {
  if (n < 1 || n > kMaxTokens) return 0;
  const int tiles = (n + 15) / 16;
  return tiles <= 1 ? 1 : tiles <= 2 ? 2 : tiles <= 4 ? 4 : tiles <= 7 ? 7 : 9;
}

// ---------------------------------------------------------------------------
// Forward.

// The forward's key order within a 16-key slab: accumulator slot c (columns
// 0-7 of the slab's first n8 block, then 0-7 of its second) holds key
// slot_key(c). A thread's four slots of a row (2t, 2t + 1, 8 + 2t, 9 + 2t)
// are then the four consecutive keys 4t..4t+3 (the first two at 4t + 2 for
// t >= 2), so its bias and mask come as one 16-byte load, and each 8 x 8
// ldmatrix of K or V still reads 8 rows on distinct banks under the 64-byte
// swizzle. The softmax and P V sum over keys, so the order changes nothing
// else.
__device__ __forceinline__ int slot_key(int c) {
  const int t = (c & 7) >> 1;
  return 4 * t + (c & 1) + 2 * ((t >> 1) ^ (c >> 3));
}

// (c0, c1) += (16 rows in af) x (keys of slab nb of the swizzled tile t)^T over
// d = 32, in the forward's key order
__device__ __forceinline__ void rows_times_keys(float (&c0)[4], float (&c1)[4],
                                                const uint32_t (&af)[kD / 16][4],
                                                const unsigned char* t, int nb, int lane) {
  const int row = nb * 16 + slot_key((lane & 7) + ((lane >> 4) << 3));
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t kb[4];
    dg::ldmatrix_x4(kb, sw64(t, row, kk * 2 + ((lane >> 3) & 1)));
    dg::mma_bf16_16816(c0, af[kk], kb[0], kb[1]);
    dg::mma_bf16_16816(c1, af[kk], kb[2], kb[3]);
  }
}

// acc (16 x 32) += a (16 x 16, the A layout over slab ks's slots) x (the
// slab's rows of the swizzled tile t, in the forward's key order)
__device__ __forceinline__ void slots_times_tile(float (&acc)[kD / 8][4], const uint32_t (&a)[4],
                                                 const unsigned char* t, int ks, int lane) {
  const int row = ks * 16 + slot_key(lane & 15);
#pragma unroll
  for (int db = 0; db < kD / 16; ++db) {
    uint32_t vb[4];
    dg::ldmatrix_x4_trans(vb, sw64(t, row, db * 2 + (lane >> 4)));
    dg::mma_bf16_16816(acc[2 * db], a, vb[0], vb[1]);
    dg::mma_bf16_16816(acc[2 * db + 1], a, vb[2], vb[3]);
  }
}

// an (n, n) f32 mask at this thread's slots of the 16-row tile at row0 (rows
// g and g + 8), in the forward's key order, where it does not come by bulk
// copies (n % 4 != 0, or a mask not 16-byte aligned); rows and keys past n
// clamped (the bias tile masks those keys, those rows are not written), so
// every load can be in flight at once
template <int NT>
__device__ __forceinline__ void load_mask(float (&x)[2 * NT][4], const float* src, int row0,
                                          int n, int g, int t4) {
#pragma unroll
  for (int m = 0; m < NT; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t row = min(row0 + g + r * 8, n - 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // slot 2t4 + (e & 1) of the slab's n8 block e >> 1
        const int key = m * 16 + slot_key((e >> 1) * 8 + 2 * t4 + (e & 1));
        x[2 * m + (e >> 1)][2 * r + (e & 1)] = __ldg(src + row * n + min(key, n - 1));
      }
    }
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

constexpr int kFwdStages = 2;        // q, k, v buffers of a forward block
constexpr int kSmShared = 233472;    // shared memory of a multiprocessor that blocks can take
constexpr int kBlockReserved = 1024;  // the runtime's own share of it per block
constexpr int kSmWarps = 64;
constexpr int kSmBlocks = 32;

// shared memory of window_attn_fwd_kernel<NT>: byte offsets from a 512-byte boundary
template <int NT>
struct FwdSmem {
  static constexpr int NP = 16 * NT;
  static constexpr int kTile = NP * kRowBytes;  // q, k or v of one window and head
  // row stride of the f32 bias tile: 16 (mod 32) floats, so that the float4
  // reads of rows g and g + 1 by a quarter warp fall on distinct banks
  static constexpr int kLDB = NP | 16;
  static constexpr int kBias = kFwdStages * 3 * kTile;
  static constexpr int kMask = kBias + NP * kLDB * 4;  // one window's mask, (n, n) as in memory
  static constexpr int kBars = kMask + NP * NP * 4;    // full per stage, mask full, mask free
  static constexpr int kBytes = kBars + (kFwdStages + 2) * 8 + kSwizzleSpan;  // the launch's ask
  // blocks a multiprocessor holds at once (shared memory, warp slots); the
  // launch bounds keep the registers from holding fewer
  static constexpr int kResident = kSmShared / (kBytes + kBlockReserved) < kSmWarps / NT
                                       ? kSmShared / (kBytes + kBlockReserved)
                                       : kSmWarps / NT;
  static constexpr int kMinBlocks = kResident < kSmBlocks ? kResident : kSmBlocks;
};

struct WinFwdParams {
  const float* bias;  // (heads, n, n)
  const float* mask;  // (nw, n, n) or null
  bf16* o;
  int batch, heads, n, nw, per_chunk;
  int mask_bulk;  // the mask comes by bulk copies: n % 4 == 0, 16-byte aligned
  int head_at[3], batch_at[3];  // per map (q, k, v): the coordinate of head and window
  int64_t o_bs, o_hs, o_rs;
  float inv_scale, scale_log2;  // 1 / scale, and scale * log2(e)
};

template <int NT>
__global__ void __launch_bounds__(32 * NT, FwdSmem<NT>::kMinBlocks)
    window_attn_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v, const WinFwdParams p) {
  using L = FwdSmem<NT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((kSwizzleSpan - (dg::smem_addr(smem_raw) & (kSwizzleSpan - 1))) &
                  (kSwizzleSpan - 1));
  float* sB = reinterpret_cast<float*>(base + L::kBias);
  float* sM = reinterpret_cast<float*>(base + L::kMask);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* mask_full = full + kFwdStages;
  uint64_t* mask_free = mask_full + 1;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = warp * 16;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int h = blockIdx.x % p.heads;
  const int chunk = blockIdx.x / p.heads;
  const int n = p.n;
  const bool active = row0 < n;  // a tile of padding rows only takes part in the barriers
  const int b0 = chunk * p.per_chunk;
  const int count = min(p.batch, b0 + p.per_chunk) - b0;  // >= 1: dispatch_fwd checks
  const bool bulk = p.mask && p.mask_bulk;

  // (the lambda takes copies of the slots: a reference to p would move it to local memory)
  const int head_at[3] = {p.head_at[0], p.head_at[1], p.head_at[2]};
  const int batch_at[3] = {p.batch_at[0], p.batch_at[1], p.batch_at[2]};
  auto load = [&](int st, int b) {
    unsigned char* t = base + st * 3 * L::kTile;
    dg::mbar_arrive_expect_tx(&full[st], 3 * L::kTile);
    tma_window(t, &map_q, &full[st], head_at[0], batch_at[0], h, b);
    tma_window(t + L::kTile, &map_k, &full[st], head_at[1], batch_at[1], h, b);
    tma_window(t + 2 * L::kTile, &map_v, &full[st], head_at[2], batch_at[2], h, b);
  };
  auto mask_of = [&](int b) { return p.mask + static_cast<int64_t>(b % p.nw) * n * n; };
  auto load_mask_tile = [&](int b) {
    dg::mbar_arrive_expect_tx(mask_full, n * n * 4);
    bulk_load(sM, mask_of(b), n * n * 4, mask_full);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kFwdStages + 1; ++i) dg::mbar_init(&full[i], 1);
    dg::mbar_init(mask_free, NT);  // one arrival a warp
    dg::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < kFwdStages && i < count; ++i) load(i, b0 + i);
    if (bulk) load_mask_tile(b0);
  }

  // the head's bias in units of q k^T (bias / scale), each row's slab of 16
  // keys stored so that column 4t + i holds the key of thread t's slot i
  // (2t, 2t + 1, 8 + 2t, 9 + 2t): one float4 a row and slab for a thread.
  // Keys past n at -1e30, rows past n at 0 (their scores are never written).
  // Every thread's loads are issued before its first store.
  {
    constexpr int kPer = (L::NP * L::NP + 32 * NT - 1) / (32 * NT);
    const float* bias = p.bias + static_cast<int64_t>(h) * n * n;
    float v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = threadIdx.x + k * 32 * NT;
      const int r = e / L::NP;
      const int col = e - r * L::NP;
      const int i = col & 3, t = (col & 15) >> 2;
      const int key = (col & ~15) + slot_key(i < 2 ? 2 * t + i : 6 + 2 * t + i);
      v[k] = e < L::NP * L::NP && r < n && key < n ? __ldg(bias + r * n + key) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = threadIdx.x + k * 32 * NT;
      const int r = e / L::NP;
      const int col = e - r * L::NP;
      const int i = col & 3, t = (col & 15) >> 2;
      const int key = (col & ~15) + slot_key(i < 2 ? 2 * t + i : 6 + 2 * t + i);
      if (e < L::NP * L::NP) sB[r * L::kLDB + col] = key < n ? v[k] * p.inv_scale : kNegInf;
    }
  }

  // the scores of this warp's 16 rows against all NP keys; without bulk
  // copies of the mask, between windows they hold the next window's mask
  float s[2 * NT][4];
  if (active && p.mask && !bulk) load_mask<NT>(s, mask_of(b0), row0, n, g, t4);
  __syncthreads();  // the bias tile is whole

  const bool swap = t4 >= 2;  // a mask row's float4: this thread's first two slots are its last keys
  for (int i = 0; i < count; ++i) {
    const int b = b0 + i;
    const int st = i % kFwdStages;
    const unsigned char* tq = base + st * 3 * L::kTile;
    const unsigned char* tk = tq + L::kTile;
    const unsigned char* tv = tq + 2 * L::kTile;
    if (bulk) dg::mbar_wait(mask_full, i & 1);
    if (active) {
      // s = (bias + mask) / scale
#pragma unroll
      for (int m = 0; m < NT; ++m)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float4 bq = *reinterpret_cast<const float4*>(sB + (row0 + g + r * 8) * L::kLDB +
                                                             m * 16 + 4 * t4);
          float* lo = s[2 * m] + 2 * r;
          float* hi = s[2 * m + 1] + 2 * r;
          if (bulk) {  // the tile as in memory; rows and keys past n clamped
            const int row = min(row0 + g + r * 8, n - 1), key = m * 16 + 4 * t4;
            const float4 f = *reinterpret_cast<const float4*>(sM + row * n + (key < n ? key : 0));
            lo[0] = swap ? f.z : f.x;
            lo[1] = swap ? f.w : f.y;
            hi[0] = swap ? f.x : f.z;
            hi[1] = swap ? f.y : f.w;
          }
          if (p.mask) {
            lo[0] = fmaf(lo[0], p.inv_scale, bq.x);
            lo[1] = fmaf(lo[1], p.inv_scale, bq.y);
            hi[0] = fmaf(hi[0], p.inv_scale, bq.z);
            hi[1] = fmaf(hi[1], p.inv_scale, bq.w);
          } else {
            lo[0] = bq.x;
            lo[1] = bq.y;
            hi[0] = bq.z;
            hi[1] = bq.w;
          }
        }
    }
    if (bulk) {  // the mask tile is read: the next window's may come
      __syncwarp();
      if (lane == 0) dg::mbar_arrive(mask_free);
      if (threadIdx.x == 0 && i + 1 < count) {
        dg::mbar_wait(mask_free, i & 1);
        load_mask_tile(b + 1);
      }
      __syncwarp();
    }
    dg::mbar_wait(&full[st], (i / kFwdStages) & 1);
    if (active) {
      // s += q k^T
      uint32_t af[kD / 16][4];
      load_rows(af, tq, row0, lane);
#pragma unroll
      for (int nb = 0; nb < NT; ++nb) rows_times_keys(s[2 * nb], s[2 * nb + 1], af, tk, nb, lane);

      // the whole softmax in registers, in base 2: exp2(s scale log2(e) - max);
      // the row's max and sum in two chains each (even and odd n8 blocks), so
      // that no add waits on the one before
      float m4[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = (e >> 1) * 2 + (j & 1);
          m4[c] = fmaxf(m4[c], s[j][e]);
        }
      float mx[2] = {fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3])};
      float off[2], sum[2], inv[2], s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        off[r] = mx[r] * p.scale_log2;
      }
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2_approx(fmaf(s[j][e], p.scale_log2, -off[e >> 1]));
          s[j][e] = pe;
          s4[(e >> 1) * 2 + (j & 1)] += pe;
        }
      sum[0] = s4[0] + s4[1];
      sum[1] = s4[2] + s4[3];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        inv[r] = 1.f / sum[r];
      }

      // o = P V; the normalized probabilities, rounded to bf16 (half the
      // registers of s), are the A operand
      uint32_t pa[NT][4];
#pragma unroll
      for (int ks = 0; ks < NT; ++ks) {
        pa[ks][0] = dg::pack_bf16x2(s[2 * ks][0] * inv[0], s[2 * ks][1] * inv[0]);
        pa[ks][1] = dg::pack_bf16x2(s[2 * ks][2] * inv[1], s[2 * ks][3] * inv[1]);
        pa[ks][2] = dg::pack_bf16x2(s[2 * ks + 1][0] * inv[0], s[2 * ks + 1][1] * inv[0]);
        pa[ks][3] = dg::pack_bf16x2(s[2 * ks + 1][2] * inv[1], s[2 * ks + 1][3] * inv[1]);
      }
      float acc[kD / 8][4];
#pragma unroll
      for (int c = 0; c < kD / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < NT; ++ks) slots_times_tile(acc, pa[ks], tv, ks, lane);
      store_rows(p.o + b * p.o_bs + h * p.o_hs, p.o_rs, acc, 1.f, row0, n, g, t4);
    }
    // the next window's mask, in flight while the block waits for its tiles
    if (active && p.mask && !bulk && i + 1 < count) load_mask<NT>(s, mask_of(b + 1), row0, n, g, t4);
    __syncthreads();  // this stage's tiles are free
    if (threadIdx.x == 0 && i + kFwdStages < count) load(st, b + kFwdStages);
  }
}

// the operands as the entry points take them: pointers, and (batch, head,
// row) strides in elements (q, k, v, and do for the backward)
struct Operands {
  const void* ptr[4];
  int64_t strides[4][3];
};

template <int NT>
int launch_fwd(WinFwdParams p, const Operands& x, int chunks, cudaStream_t stream) {
  using L = FwdSmem<NT>;
  // a runtime call first: it makes the device's context current in this thread
  // (a forward recomputed under rematerialization runs on autograd's thread),
  // which the encoder, a driver call, needs
  const cudaError_t err = cudaFuncSetAttribute(
      window_attn_fwd_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i)
    if (!window_map(&maps[i], &p.head_at[i], &p.batch_at[i], x.ptr[i], p.n, p.heads, p.batch,
                    x.strides[i][2], x.strides[i][1], x.strides[i][0], L::NP))
      return static_cast<int>(cudaErrorInvalidValue);
  window_attn_fwd_kernel<NT><<<chunks * p.heads, 32 * NT, L::kBytes, stream>>>(
      maps[0], maps[1], maps[2], p);
  return static_cast<int>(cudaGetLastError());
}

// every chunk of per_chunk windows has one, and they cover batch
bool chunks_cover(int batch, int chunks, int per_chunk) {
  return batch >= 1 && chunks >= 1 && per_chunk >= 1 &&
         static_cast<int64_t>(chunks) * per_chunk >= batch &&
         static_cast<int64_t>(chunks - 1) * per_chunk < batch;
}

int dispatch_fwd(const WinFwdParams& p, const Operands& x, int chunks, cudaStream_t stream) {
  const int nt = body_tiles(p.n);
  if (p.heads < 1 || nt == 0 || !chunks_cover(p.batch, chunks, p.per_chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.mask && (p.nw < 1 || p.batch % p.nw)) return static_cast<int>(cudaErrorInvalidValue);
  switch (nt) {
    case 1: return launch_fwd<1>(p, x, chunks, stream);
    case 2: return launch_fwd<2>(p, x, chunks, stream);
    case 4: return launch_fwd<4>(p, x, chunks, stream);
    case 7: return launch_fwd<7>(p, x, chunks, stream);
    default: return launch_fwd<9>(p, x, chunks, stream);
  }
}


// ---------------------------------------------------------------------------
// Backward. Replaces _bwd_kernel_packed and _bwd_kernel of the same Pallas file:
// with s = q k^T scale + bias[h] + mask[b % nW] and p = softmax(s) recomputed,
//   dv = p^T do,  dp = do v^T,  ds = p (dp - rowsum(p dp)),
//   dq = ds k scale,  dk = ds^T q scale,  dbias[h] = sum over windows of ds,
// p and ds rounded to bf16 for their products, everything else in f32 (dbias
// sums the unrounded ds), the mask without a gradient: the Pallas body's five
// products. One body for both layouts: q, k, v by the forward's strides, do by
// its own, dq, dk and dv by one shared triple (the packed entry points them
// into one (bn, n, 3C) buffer, so no concatenation follows).
//
// What bounds it on the H100: bytes (at n = 144 five products of 1.3 MFLOP per
// window and head on 37 KB of q, k, v, do and 28 KB of dq, dk, dv, 92
// operations a byte against the card's 295), then what a window waits on:
// its loads, 166 KB of bias and mask from L2 for every window and head, the
// block's barriers. What is hard here, and what the design does:
//   * dv and dk reduce over query rows, which phase 1's layout (a warp owns 16
//     query rows and all keys, as in the forward) spreads over warps. Phase 1
//     computes s, p, dp, rowsum(p dp), ds and dq = ds k once, in registers, and
//     leaves p and ds, rounded to bf16, in two n x n shared tiles. After a block
//     barrier phase 2 (a warp owns 16 keys) takes dv = p^T do and dk = ds^T q
//     with ldmatrix.trans from those tiles: nothing is recomputed transposed,
//     and the bias and mask are read once, in row order.
//   * q, k, v and do come by TMA (one rank-4 map each over (d, n, heads,
//     batch) at the wrapper's strides, a box of one window and head, the
//     64-byte swizzle, rows past n zero-filled) on mbarriers, one thread
//     issuing: q and do through kQDStages buffers, so the next window's arrive
//     while this one computes, k and v through one, refilled for the next
//     window as soon as phase 1 is done with them.
//   * dbias sums ds over every window of a head. The TPU kernel keeps windows
//     innermost in a sequential grid; here a block owns one head and a chunk of
//     consecutive windows and adds each window's f32 ds into an n x n f32 tile
//     in shared memory. A thread owns the same elements in every window, so no
//     barrier guards the sum, and registers keep p and dp instead. The block
//     writes one partial per chunk, and dbias_reduce_kernel adds the partials
//     in chunk order: no atomics, the same bits on every run. With one chunk
//     the partial is the result. The wrapper's plan
//     (ops/window_attention.py:backward_plan) sizes the chunks so that the
//     blocks fill the slots the shared memory leaves on each multiprocessor.
//   * What is left is latency: at n = 144 the tiles take 230,936 bytes, so one
//     block of nine warps runs on a multiprocessor, in step at the barriers,
//     and three warps on one scheduler cap a thread at 168 registers (p and dp
//     alone take 144; a few spill). The bias and mask loads are therefore all
//     issued at once at a window's start and become the starting value of the
//     q k^T accumulator ((bias + mask) / scale, then s scale log2(e)): one
//     wait for L2 a window, and no registers held for the products meanwhile.
//     When n = 16 NT (144 on the main path) a warp reads its 16 rows of each
//     as one contiguous run of float4 and stages their sum through its own p
//     and ds rows, since in the scores' layout every load touches 8 rows.
//     Prefetching the next window's bias or mask during phase 2, taking dv and
//     dk one after the other, recomputing dp instead of keeping it, one q/do
//     buffer, and a body specialised to n = 144 were each measured slower
//     (PERF.md).
// Limits as the forward's: bf16, d = 32, 1 <= n <= 144, keys past n masked by
// index.

constexpr int kQDStages = 2;         // buffers of q and do

// shared memory of window_attn_bwd_kernel<NT>: byte offsets from a 512-byte boundary
template <int NT>
struct BwdSmem {
  static constexpr int NP = 16 * NT;
  static constexpr int kTile = NP * kRowBytes;  // q, k, v or do of one window and head
  static constexpr int kLD = NP + 8;            // row stride of the p, ds (bf16) and sum (f32) tiles
  static constexpr int kKV = 2 * kQDStages * kTile;  // after q, do of each stage: k, then v
  static constexpr int kP = kKV + 2 * kTile;
  static constexpr int kDS = kP + NP * kLD * 2;
  static constexpr int kSum = kDS + NP * kLD * 2;
  static constexpr int kBars = kSum + NP * kLD * 4;  // q/do full per stage, k/v full
  static constexpr int kBytes = kBars + (kQDStages + 1) * 8 + kSwizzleSpan;  // the launch's ask
};

struct WinBwdParams {
  const float* bias;  // (heads, n, n)
  const float* mask;  // (nw, n, n) or null
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* partial;  // (chunks, heads, n, n), or dbias itself with one chunk
  int batch, heads, n, nw, per_chunk;
  int head_at[4], batch_at[4];  // per map (q, k, v, do): the coordinate of head and window
  int64_t g_bs, g_hs, g_rs;     // dq, dk and dv
  float scale, scale_log2;
};

// the A fragment of x^T at (keys j0..j0+15, queries i0..i0+15), x a row-major
// [query][key] tile of row stride ld
__device__ __forceinline__ void load_transposed(uint32_t (&a)[4], const bf16* x, int ld, int i0,
                                                int j0, int lane) {
  dg::ldmatrix_x4_trans(a, x + (i0 + (lane & 7) + ((lane >> 4) << 3)) * ld + j0 +
                               ((lane >> 3) & 1) * 8);
}

// bias[h] + mask (mask may be null) at this thread's (row, key) pairs of the
// 16-row tile at row0, in the scores' layout, when n = 16 NT: the warp's 16
// rows of each are one contiguous run, read as float4 by consecutive lanes
// (each load touches 4 cache lines, not the 8 rows of the scores' layout),
// added, and staged through shared memory: rows 0-7 at stage_lo, 8-15 at
// stage_hi, 16 NT + 8 floats apart (conflict-free reads in the scores'
// layout). The staging is exactly the warp's own p and ds rows, free until
// it writes them later in phase 1.
template <int NT>
__device__ __forceinline__ void load_rows_staged(float (&x)[2 * NT][4], const float* bias,
                                                 const float* mask, float* stage_lo,
                                                 float* stage_hi, int row0, int lane, int g,
                                                 int t4) {
  constexpr int NP = 16 * NT;
  constexpr int LD = NP + 8;
  constexpr int kPerRow = NP / 4;  // float4 a row
  constexpr int kPerLane = 2 * NT;  // 16 rows x kPerRow float4 over 32 lanes
  const float4* b4 = reinterpret_cast<const float4*>(bias + static_cast<int64_t>(row0) * NP);
  const float4* m4 = reinterpret_cast<const float4*>(mask + static_cast<int64_t>(row0) * NP);
  float4 v[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) v[k] = __ldg(b4 + k * 32 + lane);
  if (mask) {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const float4 m = __ldg(m4 + k * 32 + lane);
      v[k].x += m.x;
      v[k].y += m.y;
      v[k].z += m.z;
      v[k].w += m.w;
    }
  }
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int f = k * 32 + lane;
    const int row = f / kPerRow;
    float* dst = row < 8 ? stage_lo + row * LD : stage_hi + (row - 8) * LD;
    *reinterpret_cast<float4*>(dst + (f % kPerRow) * 4) = v[k];
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 e =
          *reinterpret_cast<const float2*>((r ? stage_hi : stage_lo) + g * LD + j * 8 + 2 * t4);
      x[j][2 * r] = e.x;
      x[j][2 * r + 1] = e.y;
    }
  __syncwarp();
}

template <int NT>
__global__ void __launch_bounds__(32 * NT)
    window_attn_bwd_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do, const WinBwdParams p) {
  using L = BwdSmem<NT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((kSwizzleSpan - (dg::smem_addr(smem_raw) & (kSwizzleSpan - 1))) &
                  (kSwizzleSpan - 1));
  auto tile_q = [&](int st) { return base + 2 * st * L::kTile; };
  auto tile_do = [&](int st) { return base + (2 * st + 1) * L::kTile; };
  unsigned char* tk = base + L::kKV;
  unsigned char* tv = base + L::kKV + L::kTile;
  bf16* sP = reinterpret_cast<bf16*>(base + L::kP);
  bf16* sDS = reinterpret_cast<bf16*>(base + L::kDS);
  float* sSum = reinterpret_cast<float*>(base + L::kSum);
  uint64_t* full_qd = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* full_kv = full_qd + kQDStages;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int h = blockIdx.x % p.heads;
  const int chunk = blockIdx.x / p.heads;
  const int n = p.n;
  const int tiles = (n + 15) / 16;
  const int row0 = warp * 16;
  const bool active = row0 < n;  // a tile of padding rows only takes no part in the phases
  const float* bias = p.bias + static_cast<int64_t>(h) * n * n;
  const float bias_to_acc = 1.f / p.scale;  // bias and mask in units of q k^T
  const int b0 = chunk * p.per_chunk;
  const int count = min(p.batch, b0 + p.per_chunk) - b0;  // >= 1: dispatch_bwd checks

  // (the lambdas take copies of the slots: a reference to p would move it to local memory)
  const int head_at[4] = {p.head_at[0], p.head_at[1], p.head_at[2], p.head_at[3]};
  const int batch_at[4] = {p.batch_at[0], p.batch_at[1], p.batch_at[2], p.batch_at[3]};
  auto load_qd = [&](int st, int b) {
    dg::mbar_arrive_expect_tx(&full_qd[st], 2 * L::kTile);
    tma_window(tile_q(st), &map_q, &full_qd[st], head_at[0], batch_at[0], h, b);
    tma_window(tile_do(st), &map_do, &full_qd[st], head_at[3], batch_at[3], h, b);
  };
  auto load_kv = [&](int b) {
    dg::mbar_arrive_expect_tx(full_kv, 2 * L::kTile);
    tma_window(tk, &map_k, full_kv, head_at[1], batch_at[1], h, b);
    tma_window(tv, &map_v, full_kv, head_at[2], batch_at[2], h, b);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kQDStages; ++i) dg::mbar_init(&full_qd[i], 1);
    dg::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    load_kv(b0);
    for (int i = 0; i < kQDStages && i < count; ++i) load_qd(i, b0 + i);
  }

  // this thread's share of the chunk's ds sum (rows row0 + g (+ 8), keys j*8 +
  // 2*t4 (+ 1)): it alone adds to it, window after window
  if (active) {
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(sSum + (row0 + g + r * 8) * L::kLD + j * 8 + 2 * t4) =
            make_float2(0.f, 0.f);
  }

  for (int i = 0; i < count; ++i) {
    const int b = b0 + i;
    const int st = i % kQDStages;
    const unsigned char* tq = tile_q(st);
    const unsigned char* tdo = tile_do(st);
    const float* mask = p.mask ? p.mask + static_cast<int64_t>(b % p.nw) * n * n : nullptr;
    const int64_t g_off = b * p.g_bs + h * p.g_hs;
    dg::mbar_wait(&full_qd[st], (i / kQDStages) & 1);
    dg::mbar_wait(full_kv, i & 1);

    if (active) {
      // ---- phase 1: this warp's 16 query rows against all keys ----
      // s = (bias + mask) / scale + q k^T: every bias and mask load is issued at
      // once, and the products, which add onto them, start when they are in
      // (one wait for L2 a window, and no registers held for the products'
      // sake meanwhile); then, in base 2, s scale log2(e)
      float s[2 * NT][4];
      if (n == 16 * NT) {
        load_rows_staged<NT>(s, bias, mask, reinterpret_cast<float*>(sP + row0 * L::kLD),
                             reinterpret_cast<float*>(sDS + row0 * L::kLD), row0, lane, g, t4);
      } else {
        load_pairs<NT>(s, bias, row0, n, g, t4);
        if (mask) {
          float m[2 * NT][4];
          load_pairs<NT>(m, mask, row0, n, g, t4);
#pragma unroll
          for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] += m[j][e];
        }
      }
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= bias_to_acc;
      uint32_t af[kD / 16][4];
      load_rows(af, tq, row0, lane);
#pragma unroll
      for (int nb = 0; nb < NT; ++nb)
        rows_times_rows(s[2 * nb], s[2 * nb + 1], af, tk, nb, lane);
      float mx[2] = {kNegInf, kNegInf};  // keys past n masked by index
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * p.scale_log2;
          if (j * 8 + 2 * t4 + (e & 1) >= n) x = kNegInf;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f(s[j][e] - mx[e >> 1]);
          s[j][e] = pe;
          sum[e >> 1] += pe;
        }
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        inv[r] = 1.f / sum[r];
      }
      // p in f32, and rounded to bf16 into the p tile for phase 2
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          s[j][2 * r] *= inv[r];
          s[j][2 * r + 1] *= inv[r];
          *reinterpret_cast<uint32_t*>(sP + (row0 + g + r * 8) * L::kLD + j * 8 + 2 * t4) =
              dg::pack_bf16x2(s[j][2 * r], s[j][2 * r + 1]);
        }

      // dp = do v^T, and rowsum(p dp)
      load_rows(af, tdo, row0, lane);
      float dp[2 * NT][4];
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int nb = 0; nb < NT; ++nb)
        rows_times_rows(dp[2 * nb], dp[2 * nb + 1], af, tv, nb, lane);
      float delta[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) delta[e >> 1] += s[j][e] * dp[j][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
        delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
      }

      // ds = p (dp - delta), in place of dp: to the ds tile in bf16, then into
      // the chunk's sum in f32 (a loop of its own, so that its loads need not
      // wait behind the tile's stores)
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float d0 = s[j][2 * r] * (dp[j][2 * r] - delta[r]);
          const float d1 = s[j][2 * r + 1] * (dp[j][2 * r + 1] - delta[r]);
          dp[j][2 * r] = d0;
          dp[j][2 * r + 1] = d1;
          *reinterpret_cast<uint32_t*>(sDS + (row0 + g + r * 8) * L::kLD + j * 8 + 2 * t4) =
              dg::pack_bf16x2(d0, d1);
        }
      float2* sum_row[2] = {reinterpret_cast<float2*>(sSum + (row0 + g) * L::kLD + 2 * t4),
                            reinterpret_cast<float2*>(sSum + (row0 + g + 8) * L::kLD + 2 * t4)};
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float2 v = sum_row[r][j * 4];
          v.x += dp[j][2 * r];
          v.y += dp[j][2 * r + 1];
          sum_row[r][j * 4] = v;
        }

      // dq = ds k scale, ds rounded to bf16 as the A operand
      float acc[kD / 8][4];
#pragma unroll
      for (int c = 0; c < kD / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
#pragma unroll
      for (int nb = 0; nb < NT; ++nb) {
        uint32_t a[4];
        a[0] = dg::pack_bf16x2(dp[2 * nb][0], dp[2 * nb][1]);
        a[1] = dg::pack_bf16x2(dp[2 * nb][2], dp[2 * nb][3]);
        a[2] = dg::pack_bf16x2(dp[2 * nb + 1][0], dp[2 * nb + 1][1]);
        a[3] = dg::pack_bf16x2(dp[2 * nb + 1][2], dp[2 * nb + 1][3]);
        frag_times_tile(acc, a, tk, nb, lane);
      }
      store_rows(p.dq + g_off, p.g_rs, acc, p.scale, row0, n, g, t4);
    }
    __syncthreads();  // the p and ds tiles are whole; k and v are free
    if (threadIdx.x == 0 && i + 1 < count) load_kv(b + 1);

    if (active) {
      // ---- phase 2: this warp's 16 keys against all queries ----
      // dv = p^T do and dk = ds^T q scale; only the query tiles phase 1 wrote
      float av[kD / 8][4], ak[kD / 8][4];
#pragma unroll
      for (int c = 0; c < kD / 8; ++c) {
        av[c][0] = av[c][1] = av[c][2] = av[c][3] = 0.f;
        ak[c][0] = ak[c][1] = ak[c][2] = ak[c][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < NT; ++ks) {
        if (ks < tiles) {
          uint32_t a[4];
          load_transposed(a, sP, L::kLD, ks * 16, row0, lane);
          frag_times_tile(av, a, tdo, ks, lane);
          load_transposed(a, sDS, L::kLD, ks * 16, row0, lane);
          frag_times_tile(ak, a, tq, ks, lane);
        }
      }
      store_rows(p.dv + g_off, p.g_rs, av, 1.f, row0, n, g, t4);
      store_rows(p.dk + g_off, p.g_rs, ak, p.scale, row0, n, g, t4);
    }
    __syncthreads();  // the p and ds tiles and this stage's q and do are free
    if (threadIdx.x == 0 && i + kQDStages < count) load_qd(st, b + kQDStages);
  }

  // the chunk's ds sum (the loop ended on a barrier)
  float* out = p.partial + (static_cast<int64_t>(chunk) * p.heads + h) * n * n;
  for (int e = threadIdx.x; e < n * n; e += 32 * NT) out[e] = sSum[(e / n) * L::kLD + e % n];
}

// dbias[e] = partial[0][e] + partial[1][e] + ... in chunk order
__global__ void dbias_reduce_kernel(const float* partial, float* dbias, int chunks, int64_t size) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float sum = 0.f;
  for (int c = 0; c < chunks; ++c) sum += partial[c * size + e];
  dbias[e] = sum;
}

template <int NT>
int launch_bwd(WinBwdParams p, const Operands& x, int chunks, cudaStream_t stream) {
  using L = BwdSmem<NT>;
  // a runtime call first: it makes the device's context current in this thread
  // (autograd runs a backward on a thread of its own), which the encoder, a
  // driver call, needs
  const cudaError_t err = cudaFuncSetAttribute(
      window_attn_bwd_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i)
    if (!window_map(&maps[i], &p.head_at[i], &p.batch_at[i], x.ptr[i], p.n, p.heads, p.batch,
                    x.strides[i][2], x.strides[i][1], x.strides[i][0], L::NP))
      return static_cast<int>(cudaErrorInvalidValue);
  window_attn_bwd_kernel<NT><<<chunks * p.heads, 32 * NT, L::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_bwd(WinBwdParams p, const Operands& x, float* dbias, int chunks,
                 cudaStream_t stream) {
  const int nt = body_tiles(p.n);
  if (p.heads < 1 || nt == 0 || !chunks_cover(p.batch, chunks, p.per_chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.mask && (p.nw < 1 || p.batch % p.nw)) return static_cast<int>(cudaErrorInvalidValue);
  if (chunks == 1) p.partial = dbias;
  int code;
  if (nt == 1) code = launch_bwd<1>(p, x, chunks, stream);
  else if (nt == 2) code = launch_bwd<2>(p, x, chunks, stream);
  else if (nt == 4) code = launch_bwd<4>(p, x, chunks, stream);
  else if (nt == 7) code = launch_bwd<7>(p, x, chunks, stream);
  else code = launch_bwd<9>(p, x, chunks, stream);
  if (code != 0 || chunks == 1) return code;
  const int64_t size = static_cast<int64_t>(p.heads) * p.n * p.n;
  dbias_reduce_kernel<<<static_cast<unsigned>((size + 255) / 256), 256, 0, stream>>>(
      p.partial, dbias, chunks, size);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Split layout: q, k, v addressed by (batch, head, row) strides in elements,
// unit stride along d = 32; k and v share strides. bias (heads, n, n) and
// mask (nw, n, n) or null are contiguous f32; window b takes mask[b % nw].
// Each block takes one head and `per_chunk` consecutive windows, every chunk
// at least one, chunks * per_chunk >= batch (ops/window_attention.py:
// forward_plan). q, k and v are read by TMA: 16-byte aligned, strides
// multiples of 8 elements.
extern "C" int dg_window_attention_bf16(
    const void* q, const void* k, const void* v, const void* bias, const void* mask,
    void* o, int batch, int heads, int n, int nw, int chunks, int per_chunk, int64_t q_bs,
    int64_t q_hs, int64_t q_rs, int64_t kv_bs, int64_t kv_hs, int64_t kv_rs, int64_t o_bs,
    int64_t o_hs, int64_t o_rs, float scale, void* stream) {
  const Operands x = {{q, k, v, nullptr},
                      {{q_bs, q_hs, q_rs}, {kv_bs, kv_hs, kv_rs}, {kv_bs, kv_hs, kv_rs}, {0, 0, 0}}};
  WinFwdParams p = {};
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.o = static_cast<bf16*>(o);
  p.batch = batch;
  p.heads = heads;
  p.n = n;
  p.nw = nw;
  p.per_chunk = per_chunk;
  p.o_bs = o_bs;
  p.o_hs = o_hs;
  p.o_rs = o_rs;
  p.mask_bulk = n % 4 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  p.inv_scale = 1.f / scale;
  p.scale_log2 = scale * kLog2e;
  return dispatch_fwd(p, x, chunks, static_cast<cudaStream_t>(stream));
}

// Packed layout: qkv (bn, n, 3C) contiguous with C = heads * 32, channels
// [q | k | v], head-major inside each; o (bn, n, C) contiguous.
extern "C" int dg_window_attention_packed_bf16(
    const void* qkv, const void* bias, const void* mask, void* o, int bn, int n,
    int heads, int nw, int chunks, int per_chunk, float scale, void* stream) {
  const int64_t c = static_cast<int64_t>(heads) * kD;
  const bf16* base = static_cast<const bf16*>(qkv);
  return dg_window_attention_bf16(base, base + c, base + 2 * c, bias, mask, o, bn, heads, n,
                                  nw, chunks, per_chunk, n * 3 * c, kD, 3 * c, n * 3 * c, kD,
                                  3 * c, n * c, kD, c, scale, stream);
}

// Dynamic shared memory the forward body asks for at n tokens, 0 if no body
// takes n (ops/window_attention.py:forward_smem mirrors it for the plan).
extern "C" int dg_window_attention_fwd_smem(int n) {
  switch (body_tiles(n)) {
    case 1: return FwdSmem<1>::kBytes;
    case 2: return FwdSmem<2>::kBytes;
    case 4: return FwdSmem<4>::kBytes;
    case 7: return FwdSmem<7>::kBytes;
    case 9: return FwdSmem<9>::kBytes;
    default: return 0;
  }
}

// Blocks of the forward body at n tokens that one multiprocessor of this card
// holds at once, by the occupancy calculator (registers included), or a
// negative CUDA error; ops/window_attention.py:forward_resident is the plan's.
extern "C" int dg_window_attention_fwd_resident(int n) {
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  auto ask = [&](auto kernel, int nt, int bytes) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * nt, bytes);
  };
  switch (body_tiles(n)) {
    case 1: ask(window_attn_fwd_kernel<1>, 1, FwdSmem<1>::kBytes); break;
    case 2: ask(window_attn_fwd_kernel<2>, 2, FwdSmem<2>::kBytes); break;
    case 4: ask(window_attn_fwd_kernel<4>, 4, FwdSmem<4>::kBytes); break;
    case 7: ask(window_attn_fwd_kernel<7>, 7, FwdSmem<7>::kBytes); break;
    case 9: ask(window_attn_fwd_kernel<9>, 9, FwdSmem<9>::kBytes); break;
    default: break;
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Backward, split layout. q, k, v as in the forward; d_o, and dq, dk, dv (one
// stride triple for the three) addressed the same way. dbias (heads, n, n) f32
// is written, not added to. Each block takes one head and `per_chunk`
// consecutive windows, every chunk at least one; partial is scratch of
// (chunks, heads, n, n) f32 (unused with one chunk), chunks * per_chunk >=
// batch. q, k, v and d_o are read by TMA: 16-byte aligned, strides multiples
// of 8 elements.
extern "C" int dg_window_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* d_o, const void* bias,
    const void* mask, void* dq, void* dk, void* dv, void* dbias, void* partial, int batch,
    int heads, int n, int nw, int chunks, int per_chunk, int64_t q_bs, int64_t q_hs, int64_t q_rs,
    int64_t kv_bs, int64_t kv_hs, int64_t kv_rs, int64_t do_bs, int64_t do_hs, int64_t do_rs,
    int64_t g_bs, int64_t g_hs, int64_t g_rs, float scale, void* stream) {
  const Operands x = {{q, k, v, d_o},
                         {{q_bs, q_hs, q_rs},
                          {kv_bs, kv_hs, kv_rs},
                          {kv_bs, kv_hs, kv_rs},
                          {do_bs, do_hs, do_rs}}};
  WinBwdParams p = {};
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.partial = static_cast<float*>(partial);
  p.batch = batch;
  p.heads = heads;
  p.n = n;
  p.nw = nw;
  p.per_chunk = per_chunk;
  p.g_bs = g_bs;
  p.g_hs = g_hs;
  p.g_rs = g_rs;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return dispatch_bwd(p, x, static_cast<float*>(dbias), chunks, static_cast<cudaStream_t>(stream));
}

// Backward, packed layout: qkv and dqkv (bn, n, 3C), d_o (bn, n, C), all
// contiguous; dq, dk and dv land in their channel slots of dqkv.
extern "C" int dg_window_attention_packed_bwd_bf16(
    const void* qkv, const void* d_o, const void* bias, const void* mask, void* dqkv,
    void* dbias, void* partial, int bn, int n, int heads, int nw, int chunks, int per_chunk,
    float scale, void* stream) {
  const int64_t c = static_cast<int64_t>(heads) * kD;
  const bf16* base = static_cast<const bf16*>(qkv);
  bf16* grad = static_cast<bf16*>(dqkv);
  return dg_window_attention_bwd_bf16(
      base, base + c, base + 2 * c, d_o, bias, mask, grad, grad + c, grad + 2 * c, dbias, partial,
      bn, heads, n, nw, chunks, per_chunk, n * 3 * c, kD, 3 * c, n * 3 * c, kD, 3 * c, n * c, kD,
      c, n * 3 * c, kD, 3 * c, scale, stream);
}

// Dynamic shared memory the backward body asks for at n tokens, 0 if no body
// takes n (ops/window_attention.py:backward_smem mirrors it for the plan).
extern "C" int dg_window_attention_bwd_smem(int n) {
  switch (body_tiles(n)) {
    case 1: return BwdSmem<1>::kBytes;
    case 2: return BwdSmem<2>::kBytes;
    case 4: return BwdSmem<4>::kBytes;
    case 7: return BwdSmem<7>::kBytes;
    case 9: return BwdSmem<9>::kBytes;
    default: return 0;
  }
}
