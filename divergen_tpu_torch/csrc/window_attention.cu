// Swin window attention forward for Hopper (sm_90a), bf16 in and out, f32 softmax.
//
// Replaces the forward of two Pallas TPU kernels of
// divergen_tpu/ops/pallas/window_attention.py:
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
