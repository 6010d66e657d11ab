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
// Both are one body: q, k, v and o are addressed as
// base + b*batch_stride + h*head_stride + row*row_stride, so the packed
// layout, contiguous (B, H, N, D) tensors and heads-first views of a fused
// projection differ only in the strides the wrapper passes. The TPU kernel's
// blocking (G windows x HB heads per grid step, head blocks of 128 lanes,
// which is why six heads fall back to the split kernel there) does not carry
// over: any head count >= 1 takes the same path here.
//
// What bounds it on the H100: bytes. A window of 144 tokens at d = 32 does
// 4*n*n*d = 2.7 MFLOP on 36 KB of q, k, v and o, 73 operations per byte,
// under the card's 295; at Swin-L's first stage (722 windows, 6 heads) that
// is 160 MB of q/k/v/o against 11.5 GFLOP. The (n, n) scores and
// probabilities must therefore never reach device memory, and the f32 bias
// (H, n, n) and shift mask (nW, n, n) must be read from cache rather than
// from device memory once per head.
//
// Design: one block per (window, head). Its q, k and v (n x 32 bf16 each)
// come in with 16-byte cp.async copies through the given strides; rows past n
// are zero-filled in shared memory, nothing is padded in device memory. Each
// warp owns 16 query rows and all keys: its scores (16 x NP f32, 72 registers
// a thread at n = 144) come from m16n8k16 bf16 products, are scaled in f32
// after the product (as the TPU kernel does, not on q), take bias[h] and
// mask[b % nW] from global memory (the head index is the fastest block
// index, so the blocks that share a window's mask run together and find it in
// L2; the bias is 83 KB a head and stays there), and go through the whole
// softmax in registers: a window fits, so there is no online rescaling. The
// normalized probabilities are rounded to bf16, reused in registers as the A
// operand of P V, and the 16 x 32 f32 result is written as bf16. Keys past n
// are masked by index and rows past n are not written, so any 1 <= n <= 144
// works (n = 49, 16 and 4 occur when the window shrinks on small maps).
// No TMA or wgmma: the products are too small to feed a warpgroup.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kD = 32;       // head dim
constexpr int kLD = kD + 8;  // bf16 row stride in shared memory: 80 bytes keeps
                             // ldmatrix rows 16-byte aligned and on distinct banks

struct WinParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* bias;  // (heads, n, n)
  const float* mask;  // (nw, n, n) or null
  bf16* o;
  int heads, n, nw;
  int64_t q_bs, q_hs, q_rs;
  int64_t kv_bs, kv_hs, kv_rs;
  int64_t o_bs, o_hs, o_rs;
  float scale_log2;  // d^-1/2 * log2(e)
};

// NT: 16-row tiles that cover the window (n <= 16 * NT); one warp per tile
template <int NT>
__global__ void __launch_bounds__(32 * NT, (NT > 4 ? 2 : 4))
    window_attn_kernel(const WinParams p) {
  constexpr int NP = 16 * NT;
  constexpr int THREADS = 32 * NT;
  __shared__ __align__(128) bf16 sQ[NP * kLD];
  __shared__ __align__(128) bf16 sK[NP * kLD];
  __shared__ __align__(128) bf16 sV[NP * kLD];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int h = blockIdx.x % p.heads;
  const int b = blockIdx.x / p.heads;
  const int n = p.n;

  const bf16* q = p.q + b * p.q_bs + h * p.q_hs;
  const bf16* k = p.k + b * p.kv_bs + h * p.kv_hs;
  const bf16* v = p.v + b * p.kv_bs + h * p.kv_hs;

  // q, k, v of this (window, head): NP rows of four 16-byte chunks each
  for (int c = threadIdx.x; c < NP * (kD / 8); c += THREADS) {
    const int r = c >> 2;
    const int col = (c & 3) * 8;
    const bool ok = r < n;
    dg::cp_async16(sQ + r * kLD + col, ok ? q + r * p.q_rs + col : q, ok);
    dg::cp_async16(sK + r * kLD + col, ok ? k + r * p.kv_rs + col : k, ok);
    dg::cp_async16(sV + r * kLD + col, ok ? v + r * p.kv_rs + col : v, ok);
  }
  dg::cp_async_commit();
  dg::cp_async_wait<0>();
  __syncthreads();

  const int row0 = warp * 16;
  if (row0 >= n) return;  // a tile of padding rows only (no barrier follows)

  // scores of this warp's 16 rows against all NP keys
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    dg::ldmatrix_x4(qf[kk], sQ + (row0 + (lane & 15)) * kLD + kk * 16 + (lane >> 4) * 8);

  float s[2 * NT][4];
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
    for (int nb = 0; nb < NT; ++nb) {
      uint32_t kb[4];
      dg::ldmatrix_x4(kb, sK + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLD + kk * 16 +
                              ((lane >> 3) & 1) * 8);
      dg::mma_bf16_16816(s[2 * nb], qf[kk], kb[0], kb[1]);
      dg::mma_bf16_16816(s[2 * nb + 1], qf[kk], kb[2], kb[3]);
    }
  }

  // scale, bias and mask in f32 (base 2); lanes 4g..4g+3 share rows g and g+8
  const float* bias = p.bias + static_cast<int64_t>(h) * n * n;
  const float* mask =
      p.mask ? p.mask + static_cast<int64_t>(b % p.nw) * n * n : nullptr;
  const bool pairs = (n & 1) == 0;  // rows of bias and mask are 8-byte aligned
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    const int key = j * 8 + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + r * 8;
      float add[2] = {0.f, 0.f};
      if (row < n && key < n) {
        const int64_t at = static_cast<int64_t>(row) * n + key;
        if (pairs) {
          const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + at));
          add[0] = bv.x;
          add[1] = bv.y;
          if (mask) {
            const float2 mv = __ldg(reinterpret_cast<const float2*>(mask + at));
            add[0] += mv.x;
            add[1] += mv.y;
          }
        } else {
          add[0] = __ldg(bias + at);
          if (mask) add[0] += __ldg(mask + at);
          if (key + 1 < n) {
            add[1] = __ldg(bias + at + 1);
            if (mask) add[1] += __ldg(mask + at + 1);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[j][2 * r + e] * p.scale_log2 + add[e] * kLog2e;
        if (key + e >= n) x = kNegInf;
        s[j][2 * r + e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
  }

  // the whole softmax in registers
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = exp2f(s[j][e] - mx[e >> 1]);
      s[j][e] = pe;
      sum[e >> 1] += pe;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    inv[r] = 1.f / sum[r];
  }

  // o = P V; the normalized probabilities, rounded to bf16, are the A operand
  float acc[kD / 8][4];
#pragma unroll
  for (int c = 0; c < kD / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < NT; ++ks) {
    uint32_t pa[4];
    pa[0] = dg::pack_bf16x2(s[2 * ks][0] * inv[0], s[2 * ks][1] * inv[0]);
    pa[1] = dg::pack_bf16x2(s[2 * ks][2] * inv[1], s[2 * ks][3] * inv[1]);
    pa[2] = dg::pack_bf16x2(s[2 * ks + 1][0] * inv[0], s[2 * ks + 1][1] * inv[0]);
    pa[3] = dg::pack_bf16x2(s[2 * ks + 1][2] * inv[1], s[2 * ks + 1][3] * inv[1]);
#pragma unroll
    for (int db = 0; db < kD / 16; ++db) {
      uint32_t vb[4];
      dg::ldmatrix_x4_trans(vb, sV + (ks * 16 + (lane & 15)) * kLD + db * 16 + (lane >> 4) * 8);
      dg::mma_bf16_16816(acc[2 * db], pa, vb[0], vb[1]);
      dg::mma_bf16_16816(acc[2 * db + 1], pa, vb[2], vb[3]);
    }
  }

  bf16* o = p.o + b * p.o_bs + h * p.o_hs;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= n) continue;
    bf16* dst = o + row * p.o_rs + 2 * t4;
#pragma unroll
    for (int c = 0; c < kD / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(dst + c * 8) =
          __floats2bfloat162_rn(acc[c][2 * r], acc[c][2 * r + 1]);
  }
}

template <int NT>
int launch(const WinParams& p, int batch, cudaStream_t stream) {
  window_attn_kernel<NT><<<batch * p.heads, 32 * NT, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const WinParams& p, int batch, cudaStream_t stream) {
  if (batch < 1 || p.heads < 1 || p.n < 1 || p.n > 144) return static_cast<int>(cudaErrorInvalidValue);
  if (p.mask && (p.nw < 1 || batch % p.nw)) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (p.n + 15) / 16;
  if (tiles <= 1) return launch<1>(p, batch, stream);
  if (tiles <= 2) return launch<2>(p, batch, stream);
  if (tiles <= 4) return launch<4>(p, batch, stream);
  if (tiles <= 7) return launch<7>(p, batch, stream);
  return launch<9>(p, batch, stream);
}


// ---------------------------------------------------------------------------
// Backward. Replaces _bwd_kernel_packed and _bwd_kernel of the same Pallas file:
// with s = q k^T scale + bias[h] + mask[b % nW] and p = softmax(s) recomputed,
//   dv = p^T do,  dp = do v^T,  ds = p (dp - rowsum(p dp)),
//   dq = ds k scale,  dk = ds^T q scale,  dbias[h] = sum over windows of ds,
// p and ds rounded to bf16 for their products, everything else in f32, the
// mask without a gradient. One body for both layouts: q, k, v by the forward's
// strides, do by its own, dq, dk and dv by one shared triple (the packed entry
// points them into one (bn, n, 3C) buffer, so no concatenation follows).
//
// What bounds it on the H100: bytes again (seven small products per window
// and head, 9 MFLOP on 45 KB of q, k, v, do, dq, dk, dv), so the scores,
// probabilities and ds never leave the chip. What is hard here, and what the
// design does:
//   * dv and dk reduce over query rows, which the forward's layout spreads
//     over warps. Instead of staging p and ds in shared memory, the block runs
//     two phases on the same tiles. Phase 1 is the forward's layout (a warp
//     owns 16 query rows): it recomputes p, takes dp tile by tile twice (once
//     for rowsum(p dp), once for ds) and feeds ds in registers to ds k. It
//     leaves each row's max, 1/sum and rowsum in shared memory. Phase 2 is the
//     transposed problem (a warp owns 16 key rows and all queries): it
//     recomputes s^T = k q^T, rebuilds p^T from the saved row statistics, and
//     feeds p^T and ds^T in registers to p^T do and ds^T q. Two more products
//     than the minimum, no n x n buffer, no reduction across warps.
//   * dbias sums over every window of a head. The TPU kernel keeps the
//     windows innermost in a sequential grid; here a block owns one head and a
//     chunk of consecutive windows, loops over them, and keeps its ds sum in
//     registers (a thread owns the same (row, key) elements in every window).
//     It writes one partial per chunk, and dbias_reduce_kernel adds the
//     partials in chunk order: no atomics, the same bits on every run. With one
//     chunk the partial is the result.
// Limits as the forward's: bf16, d = 32, 1 <= n <= 144, rows past n zero-filled
// in shared memory and keys past n masked by index.

struct WinBwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* d_o;
  const float* bias;  // (heads, n, n)
  const float* mask;  // (nw, n, n) or null
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* partial;  // (chunks, heads, n, n)
  int batch, heads, n, nw, per_chunk;
  int64_t q_bs, q_hs, q_rs;
  int64_t kv_bs, kv_hs, kv_rs;
  int64_t do_bs, do_hs, do_rs;
  int64_t g_bs, g_hs, g_rs;  // dq, dk and dv
  float scale, scale_log2;
};

// c[2][4] = (16 rows of `a` at row0) x (16 rows of `b` at nb*16)^T over d = 32:
// columns nb*16 + {2t, 2t+1} in c[0] and + 8 in c[1]
__device__ __forceinline__ void rows_times_rows(float (&c)[2][4], const uint32_t (&af)[kD / 16][4],
                                                const bf16* b, int nb, int lane) {
#pragma unroll
  for (int t = 0; t < 2; ++t) c[t][0] = c[t][1] = c[t][2] = c[t][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t kb[4];
    dg::ldmatrix_x4(kb, b + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
    dg::mma_bf16_16816(c[0], af[kk], kb[0], kb[1]);
    dg::mma_bf16_16816(c[1], af[kk], kb[2], kb[3]);
  }
}

// the A fragments of 16 rows of a shared tile, over d = 32
__device__ __forceinline__ void load_rows(uint32_t (&af)[kD / 16][4], const bf16* a, int row0,
                                          int lane) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    dg::ldmatrix_x4(af[kk], a + (row0 + (lane & 15)) * kLD + kk * 16 + (lane >> 4) * 8);
}

// acc (16 x 32) += x (16 rows x keys ks*16..+15, f32 in the C layout, rounded to
// bf16 here) x (rows ks*16..+15 of the shared tile `b`)
__device__ __forceinline__ void frag_times_tile(float (&acc)[kD / 8][4], const float (&x)[2][4],
                                                const bf16* b, int ks, int lane) {
  uint32_t pa[4];
  pa[0] = dg::pack_bf16x2(x[0][0], x[0][1]);
  pa[1] = dg::pack_bf16x2(x[0][2], x[0][3]);
  pa[2] = dg::pack_bf16x2(x[1][0], x[1][1]);
  pa[3] = dg::pack_bf16x2(x[1][2], x[1][3]);
#pragma unroll
  for (int db = 0; db < kD / 16; ++db) {
    uint32_t vb[4];
    dg::ldmatrix_x4_trans(vb, b + (ks * 16 + (lane & 15)) * kLD + db * 16 + (lane >> 4) * 8);
    dg::mma_bf16_16816(acc[2 * db], pa, vb[0], vb[1]);
    dg::mma_bf16_16816(acc[2 * db + 1], pa, vb[2], vb[3]);
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

template <int NT>
__global__ void __launch_bounds__(32 * NT, 1) window_attn_bwd_kernel(const WinBwdParams p) {
  constexpr int NP = 16 * NT;
  constexpr int THREADS = 32 * NT;
  __shared__ __align__(128) bf16 sQ[NP * kLD];
  __shared__ __align__(128) bf16 sK[NP * kLD];
  __shared__ __align__(128) bf16 sV[NP * kLD];
  __shared__ __align__(128) bf16 sDO[NP * kLD];
  __shared__ __align__(16) float sMax[NP];    // per query row: max of the base-2 scores,
  __shared__ __align__(16) float sInv[NP];    // 1 / sum of exp2,
  __shared__ __align__(16) float sDelta[NP];  // rowsum(p dp)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int h = blockIdx.x % p.heads;
  const int chunk = blockIdx.x / p.heads;
  const int n = p.n;
  const int row0 = warp * 16;
  const bool active = row0 < n;  // a tile of padding rows only takes no part in the phases
  const bool pairs = (n & 1) == 0;
  const float* bias = p.bias + static_cast<int64_t>(h) * n * n;

  // this thread's share of the chunk's ds sum: rows row0 + g (+ 8), keys j*8 + 2*t4 (+ 1)
  float dsum[2 * NT][4];
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) dsum[j][0] = dsum[j][1] = dsum[j][2] = dsum[j][3] = 0.f;

  const int b_end = min(p.batch, (chunk + 1) * p.per_chunk);
  for (int b = chunk * p.per_chunk; b < b_end; ++b) {
    const bf16* q = p.q + b * p.q_bs + h * p.q_hs;
    const bf16* k = p.k + b * p.kv_bs + h * p.kv_hs;
    const bf16* v = p.v + b * p.kv_bs + h * p.kv_hs;
    const bf16* d_o = p.d_o + b * p.do_bs + h * p.do_hs;
    for (int c = threadIdx.x; c < NP * (kD / 8); c += THREADS) {
      const int r = c >> 2;
      const int col = (c & 3) * 8;
      const bool ok = r < n;
      dg::cp_async16(sQ + r * kLD + col, ok ? q + r * p.q_rs + col : q, ok);
      dg::cp_async16(sK + r * kLD + col, ok ? k + r * p.kv_rs + col : k, ok);
      dg::cp_async16(sV + r * kLD + col, ok ? v + r * p.kv_rs + col : v, ok);
      dg::cp_async16(sDO + r * kLD + col, ok ? d_o + r * p.do_rs + col : d_o, ok);
    }
    dg::cp_async_commit();
    dg::cp_async_wait<0>();
    __syncthreads();

    const float* mask = p.mask ? p.mask + static_cast<int64_t>(b % p.nw) * n * n : nullptr;
    const int64_t g_off = b * p.g_bs + h * p.g_hs;

    if (active) {
      // ---- phase 1: this warp's 16 query rows against all keys ----
      uint32_t af[kD / 16][4];
      load_rows(af, sQ, row0, lane);
      float s[2 * NT][4];
#pragma unroll
      for (int nb = 0; nb < NT; ++nb) {
        float c[2][4];
        rows_times_rows(c, af, sK, nb, lane);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[2 * nb + t][e] = c[t][e];
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) {
        const int key = j * 8 + 2 * t4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + g + r * 8;
          float add[2] = {0.f, 0.f};
          if (row < n && key < n) {
            const int64_t at = static_cast<int64_t>(row) * n + key;
            if (pairs) {
              const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + at));
              add[0] = bv.x;
              add[1] = bv.y;
              if (mask) {
                const float2 mv = __ldg(reinterpret_cast<const float2*>(mask + at));
                add[0] += mv.x;
                add[1] += mv.y;
              }
            } else {
              add[0] = __ldg(bias + at);
              if (mask) add[0] += __ldg(mask + at);
              if (key + 1 < n) {
                add[1] = __ldg(bias + at + 1);
                if (mask) add[1] += __ldg(mask + at + 1);
              }
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[j][2 * r + e] * p.scale_log2 + add[e] * kLog2e;
            if (key + e >= n) x = kNegInf;
            s[j][2 * r + e] = x;
            mx[r] = fmaxf(mx[r], x);
          }
        }
      }
      float sum[2] = {0.f, 0.f};
      float inv[2];
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
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        inv[r] = 1.f / sum[r];
      }
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= inv[e >> 1];  // p, f32

      // rowsum(p dp), with dp = do v^T taken 16 keys at a time
      load_rows(af, sDO, row0, lane);
      float delta[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < NT; ++nb) {
        float dp[2][4];
        rows_times_rows(dp, af, sV, nb, lane);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) delta[e >> 1] += s[2 * nb + t][e] * dp[t][e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
        delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
      }
      if (t4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sMax[row0 + g + r * 8] = mx[r];
          sInv[row0 + g + r * 8] = inv[r];
          sDelta[row0 + g + r * 8] = delta[r];
        }
      }

      // ds = p (dp - delta), summed for dbias, and dq = ds k scale
      float acc[kD / 8][4];
#pragma unroll
      for (int c = 0; c < kD / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
#pragma unroll
      for (int nb = 0; nb < NT; ++nb) {
        float ds[2][4];
        rows_times_rows(ds, af, sV, nb, lane);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ds[t][e] = s[2 * nb + t][e] * (ds[t][e] - delta[e >> 1]);
            dsum[2 * nb + t][e] += ds[t][e];
          }
        frag_times_tile(acc, ds, sK, nb, lane);
      }
      store_rows(p.dq + g_off, p.g_rs, acc, p.scale, row0, n, g, t4);
    }
    __syncthreads();  // every row's statistics are in shared memory

    if (active) {
      // ---- phase 2: this warp's 16 key rows against all queries ----
      // pt[j][..]: keys row0 + g (+ 8), queries j*8 + 2*t4 (+ 1)
      uint32_t af[kD / 16][4];
      load_rows(af, sK, row0, lane);
      float pt[2 * NT][4];
#pragma unroll
      for (int nb = 0; nb < NT; ++nb) {
        float c[2][4];
        rows_times_rows(c, af, sQ, nb, lane);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int qi = (2 * nb + t) * 8 + 2 * t4;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int query = qi + (e & 1);
            const int key = row0 + g + (e >> 1) * 8;
            float val = 0.f;
            if (query < n && key < n) {
              const int64_t at = static_cast<int64_t>(query) * n + key;
              float add = __ldg(bias + at);
              if (mask) add += __ldg(mask + at);
              const float x = c[t][e] * p.scale_log2 + add * kLog2e;
              val = exp2f(x - sMax[query]) * sInv[query];
            }
            pt[2 * nb + t][e] = val;
          }
        }
      }
      // dv = p^T do
      float acc[kD / 8][4];
#pragma unroll
      for (int c = 0; c < kD / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
#pragma unroll
      for (int nb = 0; nb < NT; ++nb) {
        float x[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[t][e] = pt[2 * nb + t][e];
        frag_times_tile(acc, x, sDO, nb, lane);
      }
      store_rows(p.dv + g_off, p.g_rs, acc, 1.f, row0, n, g, t4);

      // dk = ds^T q scale, with dp^T = v do^T taken 16 queries at a time
      load_rows(af, sV, row0, lane);
#pragma unroll
      for (int c = 0; c < kD / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
#pragma unroll
      for (int nb = 0; nb < NT; ++nb) {
        float ds[2][4];
        rows_times_rows(ds, af, sDO, nb, lane);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int qi = (2 * nb + t) * 8 + 2 * t4;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[t][e] = pt[2 * nb + t][e] * (ds[t][e] - sDelta[qi + (e & 1)]);
        }
        frag_times_tile(acc, ds, sQ, nb, lane);
      }
      store_rows(p.dk + g_off, p.g_rs, acc, p.scale, row0, n, g, t4);
    }
    __syncthreads();  // the tiles and statistics are free for the next window
  }

  if (!active) return;
  float* out = p.partial + (static_cast<int64_t>(chunk) * p.heads + h) * n * n;
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    const int key = j * 8 + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + r * 8;
      if (row >= n || key >= n) continue;
      float* dst = out + static_cast<int64_t>(row) * n + key;
      if (pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(dsum[j][2 * r], dsum[j][2 * r + 1]);
      } else {
        dst[0] = dsum[j][2 * r];
        if (key + 1 < n) dst[1] = dsum[j][2 * r + 1];
      }
    }
  }
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
int launch_bwd(const WinBwdParams& p, int chunks, cudaStream_t stream) {
  window_attn_bwd_kernel<NT><<<chunks * p.heads, 32 * NT, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_bwd(WinBwdParams p, float* dbias, int chunks, cudaStream_t stream) {
  if (p.batch < 1 || p.heads < 1 || p.n < 1 || p.n > 144 || chunks < 1 || p.per_chunk < 1 ||
      static_cast<int64_t>(chunks) * p.per_chunk < p.batch)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.mask && (p.nw < 1 || p.batch % p.nw)) return static_cast<int>(cudaErrorInvalidValue);
  if (chunks == 1) p.partial = dbias;
  const int tiles = (p.n + 15) / 16;
  int code;
  if (tiles <= 1) code = launch_bwd<1>(p, chunks, stream);
  else if (tiles <= 2) code = launch_bwd<2>(p, chunks, stream);
  else if (tiles <= 4) code = launch_bwd<4>(p, chunks, stream);
  else if (tiles <= 7) code = launch_bwd<7>(p, chunks, stream);
  else code = launch_bwd<9>(p, chunks, stream);
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
extern "C" int dg_window_attention_bf16(
    const void* q, const void* k, const void* v, const void* bias, const void* mask,
    void* o, int batch, int heads, int n, int nw, int64_t q_bs, int64_t q_hs,
    int64_t q_rs, int64_t kv_bs, int64_t kv_hs, int64_t kv_rs, int64_t o_bs,
    int64_t o_hs, int64_t o_rs, float scale, void* stream) {
  WinParams p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.o = static_cast<bf16*>(o);
  p.heads = heads;
  p.n = n;
  p.nw = nw;
  p.q_bs = q_bs;
  p.q_hs = q_hs;
  p.q_rs = q_rs;
  p.kv_bs = kv_bs;
  p.kv_hs = kv_hs;
  p.kv_rs = kv_rs;
  p.o_bs = o_bs;
  p.o_hs = o_hs;
  p.o_rs = o_rs;
  p.scale_log2 = scale * kLog2e;
  return dispatch(p, batch, static_cast<cudaStream_t>(stream));
}

// Packed layout: qkv (bn, n, 3C) contiguous with C = heads * 32, channels
// [q | k | v], head-major inside each; o (bn, n, C) contiguous.
extern "C" int dg_window_attention_packed_bf16(
    const void* qkv, const void* bias, const void* mask, void* o, int bn, int n,
    int heads, int nw, float scale, void* stream) {
  const int64_t c = static_cast<int64_t>(heads) * kD;
  const bf16* base = static_cast<const bf16*>(qkv);
  return dg_window_attention_bf16(base, base + c, base + 2 * c, bias, mask, o, bn, heads, n,
                                  nw, n * 3 * c, kD, 3 * c, n * 3 * c, kD, 3 * c, n * c, kD,
                                  c, scale, stream);
}

// Backward, split layout. q, k, v as in the forward; d_o, and dq, dk, dv (one
// stride triple for the three) addressed the same way. dbias (heads, n, n) f32
// is written, not added to. Each block takes one head and `per_chunk`
// consecutive windows; partial is scratch of (chunks, heads, n, n) f32 (unused
// with one chunk), chunks * per_chunk >= batch.
extern "C" int dg_window_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* d_o, const void* bias,
    const void* mask, void* dq, void* dk, void* dv, void* dbias, void* partial, int batch,
    int heads, int n, int nw, int chunks, int per_chunk, int64_t q_bs, int64_t q_hs, int64_t q_rs,
    int64_t kv_bs, int64_t kv_hs, int64_t kv_rs, int64_t do_bs, int64_t do_hs, int64_t do_rs,
    int64_t g_bs, int64_t g_hs, int64_t g_rs, float scale, void* stream) {
  WinBwdParams p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.d_o = static_cast<const bf16*>(d_o);
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
  p.q_bs = q_bs;
  p.q_hs = q_hs;
  p.q_rs = q_rs;
  p.kv_bs = kv_bs;
  p.kv_hs = kv_hs;
  p.kv_rs = kv_rs;
  p.do_bs = do_bs;
  p.do_hs = do_hs;
  p.do_rs = do_rs;
  p.g_bs = g_bs;
  p.g_hs = g_hs;
  p.g_rs = g_rs;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return dispatch_bwd(p, static_cast<float*>(dbias), chunks, static_cast<cudaStream_t>(stream));
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
