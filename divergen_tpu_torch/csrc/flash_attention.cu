// Flash attention forward with the decomposed relative-position bias of
// ViTDet and SAM, for Hopper (sm_90a) on mma.sync: bf16 in and out, f32
// softmax, head dim 80 (SAM ViT-H). Head dims 64 (SDXL) and 512 (the VAE)
// run on the wgmma + TMA bodies of flash_attention_sm90.cu and
// flash_attention_d512.cu.
//
// Replaces the Pallas TPU kernel flash_attention_relpos (_relpos_kernel) of
// divergen_tpu/ops/pallas/flash_attention.py: global self-attention over an
// H x W token grid with the decomposed relative-position bias
// bias[q, k = (u, v)] = Bh[u, q] + Bw[v, q], given as the two f32 factors
// (BH, H, N) and (BH, W, N). The (N, N) bias never exists in memory. q, k, v
// and o are addressed as base + b*batch_stride + h*head_stride +
// row*row_stride, so the (BH, N, D) layout and heads-first views of a fused
// projection differ only in the strides the wrapper passes.
//
// What bounds it on the H100: the two products per K tile run on the tensor
// cores; between them the online softmax (scale, bias, max, exp2, sum,
// rescale) runs on the FP32 units, and at d = 80 it costs about as much as
// the products. What must not happen is a round trip of scores,
// probabilities or the output accumulator through shared memory, and the K/V
// loads must overlap the math.
//
// Design (FlashAttention-2 style): one block per (q tile, head, batch) loops
// over K tiles inside the block (the TPU's sequential "arbitrary" grid axis
// becomes this loop). K/V tiles stream through a two-stage cp.async ring, so
// the next tile loads while this one is computed. Each of 4 warps keeps its
// 16 q rows as mma.sync A fragments, computes its scores in registers
// (m16n8k16 bf16 products, f32 accumulate, five k-steps of 16), runs the
// base-2 online softmax on them in registers (log2(e) folded into the scale;
// row max and sum reduced over the four lanes that share a row), reuses the
// probabilities in registers as the A operand of P@V, and keeps the f32
// output accumulator in registers. K tiles of 64 keys. Rows are 160 bytes
// and are stored at a stride of 176 bytes (D + 8 elements), which keeps
// every ldmatrix row address 16-byte aligned and the eight rows of one 8x8
// matrix on distinct banks; there is no swizzle that assumes a power of two,
// and the head dimension is not padded, so nothing is wasted.
// The TPU kernel computes the score tile transposed so that both bias
// broadcasts run along sublanes, and needs N to divide by its blocks;
// neither carries over. Here the block stages the two factor slabs of its q
// tile once, (H x BQ) and (W x BQ) f32, already multiplied by log2(e), in
// shared memory (34 KB at H = W = 64), and every score element adds
// bh[u][qi] + bw[v][qi]. The key's grid position (u, v) costs one integer
// division per thread and K tile and is stepped from there. The slab rows
// are padded by four floats so that the four lanes of a row group, whose
// keys differ by two grid columns, read distinct banks. Any H, W >= 1:
// ragged tiles are masked by index. At SAM's shape the kernel is bound by
// operations (4·BH·N²·d); the bias adds two shared-memory reads and one add
// per score element to the softmax work between the products.
// No TMA, wgmma or warp specialisation yet: flash_attention_sm90.cu has them
// for d = 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_moments.cuh"  // dg::store_pair
#include "mma_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct AttnParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int heads, sq, sk;
  int64_t q_bs, q_hs, q_rs;
  int64_t kv_bs, kv_hs, kv_rs;
  int64_t o_bs, o_hs, o_rs;
  float scale_log2;  // softmax scale * log2(e)
  // decomposed relative-position bias: contiguous (batch*heads, H, sq) and
  // (batch*heads, W, sq) f32 factors over an H x W key grid, sk == H*W
  const float* rel_bh;
  const float* rel_bw;
  int rel_h, rel_w;
};

// D: head dim; NR warps split the q rows; RG 16-row groups per warp; BK keys
// per tile.
template <int D, int NR, int RG, int BK>
struct Cfg {
  static constexpr int BQ = NR * RG * 16;  // q rows per block
  static constexpr int THREADS = 32 * NR;
  static constexpr int LD = D + 8;         // bf16 row stride in shared memory
  static constexpr int LDB = BQ + 4;       // f32 row stride of the rel-pos slabs
  static constexpr size_t q_bytes = sizeof(bf16) * BQ * LD;
  static constexpr size_t kv_bytes = sizeof(bf16) * BK * LD;  // one tile
  static constexpr size_t bytes = q_bytes + 4 * kv_bytes;
  static_assert(D % 16 == 0 && BK % 16 == 0, "tile shapes");
  static_assert(q_bytes % 128 == 0 && kv_bytes % 128 == 0, "aligned regions");
  // the rel-pos factor slabs of one q tile follow the other regions
  static size_t rel_bytes(int h, int w) { return sizeof(float) * (h + w) * LDB; }
};

// rows x D tile, global -> shared by 16-byte cp.async; rows >= valid are zeros
template <int D, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, int64_t stride,
                                          int rows, int valid) {
  constexpr int CPR = D / 8;
  for (int c = threadIdx.x; c < rows * CPR; c += THREADS) {
    const int r = c / CPR;
    const int col = (c - r * CPR) * 8;
    const bool ok = r < valid;
    dg::cp_async16(dst + r * ld + col, ok ? src + r * stride + col : src, ok);
  }
}

template <int D, int NR, int RG, int BK>
__global__ void __launch_bounds__(Cfg<D, NR, RG, BK>::THREADS)
    flash_attn_relpos_kernel(const AttnParams p) {
  using C = Cfg<D, NR, RG, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + C::q_bytes);  // 2 stages
  bf16* sV = reinterpret_cast<bf16*>(smem + C::q_bytes + 2 * C::kv_bytes);
  float* sBh = reinterpret_cast<float*>(smem + C::bytes);  // (H, LDB)
  float* sBw = sBh + p.rel_h * C::LDB;                     // (W, LDB)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * C::BQ;
  const int row0 = warp * RG * 16;  // first block row of this warp

  const bf16* q = p.q + b * p.q_bs + h * p.q_hs;
  const bf16* k = p.k + b * p.kv_bs + h * p.kv_hs;
  const bf16* v = p.v + b * p.kv_bs + h * p.kv_hs;
  bf16* o = p.o + b * p.o_bs + h * p.o_hs;

  const int n_tiles = (p.sk + BK - 1) / BK;
  load_tile<D, C::THREADS>(sQ, C::LD, q + q0 * p.q_rs, p.q_rs, C::BQ, p.sq - q0);
  dg::cp_async_commit();
  load_tile<D, C::THREADS>(sK, C::LD, k, p.kv_rs, BK, p.sk);
  load_tile<D, C::THREADS>(sV, C::LD, v, p.kv_rs, BK, p.sk);
  dg::cp_async_commit();
  {
    // the bias factors of this q tile, times log2(e); rows past sq are zeros
    const int64_t bh_idx = static_cast<int64_t>(b) * p.heads + h;
    const float* gbh = p.rel_bh + bh_idx * p.rel_h * p.sq;
    const float* gbw = p.rel_bw + bh_idx * p.rel_w * p.sq;
    for (int i = threadIdx.x; i < (p.rel_h + p.rel_w) * C::BQ; i += C::THREADS) {
      const int r = i / C::BQ;
      const int c = i - r * C::BQ;
      const float* src = r < p.rel_h ? gbh + static_cast<int64_t>(r) * p.sq
                                     : gbw + static_cast<int64_t>(r - p.rel_h) * p.sq;
      sBh[r * C::LDB + c] = q0 + c < p.sq ? src[q0 + c] * kLog2e : 0.f;
    }
  }
  dg::cp_async_wait<1>();  // q has landed
  __syncthreads();

  // q rows of this warp as A fragments
  uint32_t qf[RG][D / 16][4];
#pragma unroll
  for (int rg = 0; rg < RG; ++rg)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      dg::ldmatrix_x4(qf[rg][kk],
                      sQ + (row0 + rg * 16 + (lane & 15)) * C::LD + kk * 16 + (lane >> 4) * 8);

  float acc[RG][D / 8][4];
  float m_run[RG][2], l_run[RG][2];
#pragma unroll
  for (int rg = 0; rg < RG; ++rg) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      acc[rg][n][0] = acc[rg][n][1] = acc[rg][n][2] = acc[rg][n][3] = 0.f;
    m_run[rg][0] = m_run[rg][1] = kNegInf;
    l_run[rg][0] = l_run[rg][1] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int k0 = t * BK;
    if (t + 1 < n_tiles) {  // prefetch the next tile into the other stage
      const int k1 = k0 + BK;
      load_tile<D, C::THREADS>(sK + (st ^ 1) * BK * C::LD, C::LD, k + k1 * p.kv_rs, p.kv_rs, BK,
                               p.sk - k1);
      load_tile<D, C::THREADS>(sV + (st ^ 1) * BK * C::LD, C::LD, v + k1 * p.kv_rs, p.kv_rs, BK,
                               p.sk - k1);
      dg::cp_async_commit();
      dg::cp_async_wait<1>();
    } else {
      dg::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tK = sK + st * BK * C::LD;
    const bf16* tV = sV + st * BK * C::LD;

    float s[RG][BK / 8][4];
#pragma unroll
    for (int rg = 0; rg < RG; ++rg)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) s[rg][j][0] = s[rg][j][1] = s[rg][j][2] = s[rg][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < BK / 16; ++nb) {
        uint32_t kb[4];
        dg::ldmatrix_x4(kb, tK + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * C::LD +
                                kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int rg = 0; rg < RG; ++rg) {
          dg::mma_bf16_16816(s[rg][2 * nb], qf[rg][kk], kb[0], kb[1]);
          dg::mma_bf16_16816(s[rg][2 * nb + 1], qf[rg][kk], kb[2], kb[3]);
        }
      }
    }

    // grid position (u, v) of this lane's first key of the tile
    const int u_tile = (k0 + 2 * t4) / p.rel_w;
    const int v_tile = k0 + 2 * t4 - u_tile * p.rel_w;

    // base-2 online softmax in registers; lanes 4g..4g+3 share rows g and g+8
#pragma unroll
    for (int rg = 0; rg < RG; ++rg) {
      float mx[2] = {kNegInf, kNegInf};
      int ua = u_tile, va = v_tile;  // of key k0 + j*8 + 2*t4, stepped with j
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float rel[4] = {0.f, 0.f, 0.f, 0.f};
        const int key = k0 + j * 8 + 2 * t4;
        const int ql = row0 + rg * 16 + g;  // row of the slabs; + 8 for e >= 2
        int ub = ua, vb = va + 1;           // of key + 1
        if (vb == p.rel_w) {
          vb = 0;
          ++ub;
        }
        if (key < p.sk) {
          const float* bh = sBh + ua * C::LDB + ql;
          const float* bw = sBw + va * C::LDB + ql;
          rel[0] = bh[0] + bw[0];
          rel[2] = bh[8] + bw[8];
        }
        if (key + 1 < p.sk) {
          const float* bh = sBh + ub * C::LDB + ql;
          const float* bw = sBw + vb * C::LDB + ql;
          rel[1] = bh[0] + bw[0];
          rel[3] = bh[8] + bw[8];
        }
        va += 8;
        while (va >= p.rel_w) {
          va -= p.rel_w;
          ++ua;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = key + (e & 1) < p.sk ? s[rg][j][e] * p.scale_log2 + rel[e] : kNegInf;
          s[rg][j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[rg][r], mx[r]);
        alpha[r] = exp2f(m_run[rg][r] - m_new);
        m_run[rg][r] = m_new;
      }
      float rs[2] = {0.f, 0.f};  // this lane's share of the row sums
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f(s[rg][j][e] - m_run[rg][e >> 1]);
          s[rg][j][e] = pe;
          rs[e >> 1] += pe;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[rg][r] = l_run[rg][r] * alpha[r] + rs[r];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[rg][n][0] *= alpha[0];
        acc[rg][n][1] *= alpha[0];
        acc[rg][n][2] *= alpha[1];
        acc[rg][n][3] *= alpha[1];
      }
    }

    // acc += P V; P is already in A layout
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t pa[RG][4];
#pragma unroll
      for (int rg = 0; rg < RG; ++rg) {
        pa[rg][0] = dg::pack_bf16x2(s[rg][2 * ks][0], s[rg][2 * ks][1]);
        pa[rg][1] = dg::pack_bf16x2(s[rg][2 * ks][2], s[rg][2 * ks][3]);
        pa[rg][2] = dg::pack_bf16x2(s[rg][2 * ks + 1][0], s[rg][2 * ks + 1][1]);
        pa[rg][3] = dg::pack_bf16x2(s[rg][2 * ks + 1][2], s[rg][2 * ks + 1][3]);
      }
#pragma unroll
      for (int db = 0; db < D / 16; ++db) {
        uint32_t vb[4];
        dg::ldmatrix_x4_trans(vb, tV + (ks * 16 + (lane & 15)) * C::LD + db * 16 +
                                      (lane >> 4) * 8);
#pragma unroll
        for (int rg = 0; rg < RG; ++rg) {
          dg::mma_bf16_16816(acc[rg][2 * db], pa[rg], vb[0], vb[1]);
          dg::mma_bf16_16816(acc[rg][2 * db + 1], pa[rg], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // this stage is free again
  }

#pragma unroll
  for (int rg = 0; rg < RG; ++rg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[rg][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int qi = q0 + row0 + rg * 16 + g + r * 8;
      if (qi >= p.sq) continue;
      bf16* dst = o + qi * p.o_rs + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        dg::store_pair(dst + n * 8, acc[rg][n][2 * r] * inv, acc[rg][n][2 * r + 1] * inv);
    }
  }
}

template <int D, int NR, int RG, int BK>
int launch(const AttnParams& p, int batch, cudaStream_t stream) {
  using C = Cfg<D, NR, RG, BK>;
  const size_t bytes = C::bytes + C::rel_bytes(p.rel_h, p.rel_w);
  cudaError_t err = cudaFuncSetAttribute(flash_attn_relpos_kernel<D, NR, RG, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + C::BQ - 1) / C::BQ, p.heads, batch);
  flash_attn_relpos_kernel<D, NR, RG, BK><<<grid, C::THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Self-attention over a grid_h x grid_w token grid (n = grid_h * grid_w rows)
// with the decomposed relative-position bias; bias_h (batch*heads, grid_h, n)
// and bias_w (batch*heads, grid_w, n) are contiguous f32.
extern "C" int dg_flash_attention_relpos_bf16(
    const void* q, const void* k, const void* v, const void* bias_h,
    const void* bias_w, void* o, int batch, int heads, int grid_h, int grid_w,
    int d, int64_t q_bs, int64_t q_hs, int64_t q_rs, int64_t kv_bs,
    int64_t kv_hs, int64_t kv_rs, int64_t o_bs, int64_t o_hs, int64_t o_rs,
    float scale, void* stream) {
  if (grid_h < 1 || grid_w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n = grid_h * grid_w;
  AttnParams p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.heads = heads;
  p.sq = n;
  p.sk = n;
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
  p.rel_bh = static_cast<const float*>(bias_h);
  p.rel_bw = static_cast<const float*>(bias_w);
  p.rel_h = grid_h;
  p.rel_w = grid_w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 80) return launch<80, 4, 1, 64>(p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
