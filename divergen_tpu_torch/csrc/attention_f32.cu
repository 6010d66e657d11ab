// Float32 attention for the port's five attention kernels, forward and the
// window backward, for Hopper (sm_90a): q, k, v, the output and every product
// at float32 accuracy, as the Pallas kernels compute a float32 input (their
// dots run in the input's dtype).
//
// Replaces the float32 case of the Pallas TPU kernels of
// divergen_tpu/ops/pallas/flash_attention.py (flash_attention_packed,
// flash_attention, flash_attention_relpos) and window_attention.py
// (fused_window_attention_packed and fused_window_attention, forward and
// backward). Their bf16 cases run the bf16 bodies (flash_attention_sm90.cu,
// flash_attention_d512.cu, flash_attention_relpos_sm90.cu,
// window_attention.cu); the wrappers send float32 here and raise on any
// other dtype.
//
// The forward, per (batch b, head h) and query row r:
//     out[r] = softmax_k(scale (q_r . k_k) + bias(b, h, r, k)) v
// with the scale applied to the f32 score after the product, an online
// softmax over key tiles, and out = acc / max(l, 1e-30), as the TPU kernels.
// The bias is a template policy:
//   kNoBias;
//   kDense  (flash_attention): bias[b bs + h hs + r rs + k], f32;
//   kRelpos (flash_attention_relpos): bias_h_t[b h, k / W, r] +
//           bias_w_t[b h, k % W, r], the factors (B heads, H | W, N);
//   kWindow (window attention): bias[h, r, k] + mask[b % nW, r, k].
// q, k, v and out are read by strides (batch, head, row; unit channel
// stride), which covers the packed (B, N, 3C) projections of kernels 1 and 5,
// (BH, S, D) and heads-first views; k and v share strides.
//
// What bounds it: operations. The products run on the TF32 tensor cores in
// three passes (mma_sm90.cuh: each operand split into a big and a small tf32
// part, a_small b_big + a_big b_small + a_big b_big, float32-accurate),
// 494.7 / 3 = 165 TFLOP/s of float32 products against the 67 TFLOP/s of FMA
// that bounded the CUDA-core body this one replaced. One-pass TF32 (about
// 5e-4 relative) is not float32 and is not taken. The three passes of a step
// run over all of a tile's accumulators in turn, so that the products side
// by side are independent (an accumulator of its own for each pass was
// slower at d = 512: 18.49 against 17.34 ms at 16384 keys on an H100); a
// tile's P V starts from zero and is added to O in f32 (the tensor core's
// accumulation truncates: one accumulator over all keys drifted by 3e-5
// relative at 4096 keys, 1e-4 at 16384).
//
// Why mma.sync m16n8k8 and not wgmma: the split happens in registers, on
// fragments loaded from shared memory, for every operand, so one body serves
// every head dim and bias policy; and P V takes P straight from the S
// accumulator. wgmma's tf32 B operand must be K-major in shared memory: S = Q
// K^T fits, P V from V's natural (keys, d) rows would need V transposed and
// both halves of its split staged.
//
// Design (ops/attention_f32.py: TC_PLANS mirrors the plan, tested on the
// CPU in tests/test_torch_f32_plan.py):
//   * A block takes BQ query rows of one (b, h); warps split the rows (16 MT
//     each) and, at d = 512, the channels (kWarpsC groups of d / kWarpsC).
//     K and V tiles of BK keys come by cp.async (16 bytes a thread, rows
//     padded to d + 4 floats so that every fragment load is free of bank
//     conflicts, keys past Sk zero-filled), kStages deep: at d <= 80 the
//     tile two ahead is in flight behind the products, one barrier a tile.
//   * d <= 80: warps of 16 rows (four, BQ 64; three at d = 32, the window
//     policy's, so that n = 144 is three blocks of 48 rows and three tiles
//     of 48 keys), Q split once into registers for the whole key loop; a
//     tile's bias is loaded during the products of the tile before it.
//   * d = 512: 32 rows by eight warps of 64 channels each (O 32 x 64 a warp;
//     Q in shared memory, split as it is read: in registers it spilled), two
//     K/V stages of 16 keys. Each warp's share of S goes to shared memory,
//     warp w sums the w-th eighth of the eight shares in warp order, and
//     every warp reads the sum back: all eight hold the same S, run the
//     same softmax and feed P from their own registers (three barriers a
//     tile).
//   * P from the S accumulator: the tf32 A fragment holds columns t and t + 4
//     where the accumulator holds 2t and 2t + 1, so P V's k-slot t is key 2t
//     and slot t + 4 key 2t + 1 of each 8-key slab, and V's rows are read in
//     that order (ops/attention_f32.py: pv_slot_key). S, the bias and the mask
//     keep the keys' natural order.
//   * The bias is loaded before a tile's products (each quad reads 32
//     contiguous bytes of a row) and added to the scaled score; relpos keeps
//     the key's grid row and column by increments, no division per element.
//   * expf, not __expf: the fast one was 1.5-2 % quicker on an H100 and less
//     accurate.
//
// The window backward (kernels 5 and 6): a block takes one head and a chunk
// of consecutive windows; for each window q, k, v, do (n x 32) and the n x n
// scores sit in shared memory (n <= 144: 166 KB), P = softmax(S) is
// recomputed in place, dv = P^T do, ds = P (dp - rowsum(P dp)) with dp =
// do v^T in place of P, dq = scale ds k, dk = scale ds^T q; the block adds its
// windows' ds into a bias gradient in registers, and a second small kernel
// adds the chunks' partial sums in a fixed order (two runs, the same bits).
// Its products are float32 FMAs on the CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"  // cp.async, the tf32 split and m16n8k8 product

namespace {

constexpr float kNegInf = -1e30f;

enum BiasMode { kNoBias = 0, kDense = 1, kRelpos = 2, kWindow = 3 };

struct AttnArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  const float* bias;   // kDense: the bias; kRelpos: bias_h_t; kWindow: bias (heads, n, n)
  const float* bias2;  // kRelpos: bias_w_t; kWindow: mask (nw, n, n) or null
  int batch, heads, sq, sk;
  int64_t q_bs, q_hs, q_rs, kv_bs, kv_hs, kv_rs, o_bs, o_hs, o_rs;
  int64_t b_bs, b_hs, b_rs;  // kDense
  int gh, gw;                // kRelpos: the token grid
  int nw;                    // kWindow: windows of the mask
  float scale;
};

// the tile plan of head dim D (ops/attention_f32.py: TC_PLANS): warps by
// rows and by channels, 16-row m-tiles a warp, keys a tile, tiles in flight
template <int D>
struct Plan {
  static constexpr int kWarpsR = 4, kWarpsC = 1, kMT = 1, kBK = 32, kStages = 3;
};
// the window policy's d: n = 144 is three blocks of 48 rows and three tiles of 48 keys
template <>
struct Plan<32> {
  static constexpr int kWarpsR = 3, kWarpsC = 1, kMT = 1, kBK = 48, kStages = 3;
};
// Q in shared memory takes the third stage's room: raw in registers, split as
// it was read, with three stages, it spilled and took 28.57 against 16.95 ms
// at 16384 keys on an H100
template <>
struct Plan<512> {
  static constexpr int kWarpsR = 1, kWarpsC = 8, kMT = 2, kBK = 16, kStages = 2;
};

template <int D>
struct Tile : Plan<D> {
  typedef Plan<D> P;
  static constexpr int kWarps = P::kWarpsR * P::kWarpsC;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * P::kMT * P::kWarpsR;  // query rows a block
  static constexpr int kLD = D + 4;                     // floats a K or V row in shared memory
  static constexpr int kNT = P::kBK / 8;                // 8-key slabs a tile
  // with the channels split: Q in shared memory (not registers), the warps'
  // shares of S and their sum, in float4s
  static constexpr bool kSplitC = P::kWarpsC > 1;
  static constexpr int kQ = kSplitC ? kBQ * kLD : 0;
  static constexpr int kShare = kSplitC ? kWarps * P::kMT * kNT * 32 : 0;
  static constexpr int kSum = kSplitC ? P::kMT * kNT * 32 : 0;
  static constexpr int kSmem = (P::kStages * 2 * P::kBK * kLD + kQ + 4 * (kShare + kSum)) * 4;
  static_assert(D % (8 * P::kWarpsC) == 0 && P::kBK % 8 == 0, "whole fragments");
  static_assert(!kSplitC || (P::kWarpsR == 1 && kSum % P::kWarpsC == 0 &&
                             kSum / P::kWarpsC <= 32), "one row group; a lane per summed float4");
  static_assert(kSmem <= 232448, "a block's shared memory");
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D, int BIAS>
__global__ void __launch_bounds__(Tile<D>::kThreads) attn_f32_kernel(const AttnArgs p) {
  typedef Tile<D> T;
  constexpr int MT = T::kMT, NT = T::kNT, BK = T::kBK, LD = T::kLD, NS = T::kStages;
  constexpr int WC = T::kWarpsC, DW = D / WC;
  constexpr int KS = DW / 8;  // 8-channel steps of Q K^T a warp, and 8-channel tiles of its O
  constexpr bool kSplitQ = WC == 1;  // Q split once into registers; else in shared memory
  // channel tiles of P V taken at once: independent products side by side
  constexpr int CB = MT > 1 ? 2 : (KS % 4 == 0 ? 4 : 5);
  static_assert(KS % CB == 0, "whole channel blocks");
  extern __shared__ float4 smem4[];
  float* kv = reinterpret_cast<float*>(smem4);  // NS stages of [K | V], BK rows of LD each
  float* qs = kv + NS * 2 * BK * LD;            // WC > 1: the block's Q, BQ rows of LD
  float4* share = reinterpret_cast<float4*>(qs + T::kQ);  // WC > 1: each warp's S
  float4* ssum = share + T::kShare;                         // WC > 1: their sum

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / WC, cg = warp % WC;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * T::kBQ + 16 * MT * rg;  // the warp's first query row
  const int c0 = cg * DW;                               // the warp's first channel
  const float* qb = p.q + b * p.q_bs + h * p.q_hs;
  const float* kb = p.k + b * p.kv_bs + h * p.kv_hs;
  const float* vb = p.v + b * p.kv_bs + h * p.kv_hs;
  const int n_tiles = (p.sk + BK - 1) / BK;

  auto load_tile = [&](int j) {
    float* ks = kv + (j % NS) * 2 * BK * LD;
    float* vs = ks + BK * LD;
    const int k0 = j * BK;
    for (int i = tid; i < BK * (D / 4); i += T::kThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const bool valid = k0 + r < p.sk;
      const int64_t off = valid ? (k0 + r) * p.kv_rs + c : 0;
      dg::cp_async16(ks + r * LD + c, kb + off, valid);
      dg::cp_async16(vs + r * LD + c, vb + off, valid);
    }
  };
  if constexpr (!kSplitQ) {  // the block's Q rows, with the first tile
    const int q0 = blockIdx.x * T::kBQ;
    for (int i = tid; i < T::kBQ * (D / 4); i += T::kThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const bool valid = q0 + r < p.sq;
      dg::cp_async16(qs + r * LD + c, qb + (valid ? (q0 + r) * p.q_rs + c : 0), valid);
    }
  }
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    dg::cp_async_commit();
  }

  // d <= 80: Q's A fragments, rows row0 + 16 mt + g (+ 8), channels c0 + 8 ks
  // + t (+ 4), split once for the whole key loop
  uint32_t qh[kSplitQ ? MT : 1][kSplitQ ? KS : 1][4], ql[kSplitQ ? MT : 1][kSplitQ ? KS : 1][4];
  if constexpr (kSplitQ) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int ra = row0 + 16 * mt + g, rb = ra + 8;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int ch = c0 + 8 * ks + t;
        dg::tf32_split(ra < p.sq ? qb[ra * p.q_rs + ch] : 0.f, qh[mt][ks][0], ql[mt][ks][0]);
        dg::tf32_split(rb < p.sq ? qb[rb * p.q_rs + ch] : 0.f, qh[mt][ks][1], ql[mt][ks][1]);
        dg::tf32_split(ra < p.sq ? qb[ra * p.q_rs + ch + 4] : 0.f, qh[mt][ks][2], ql[mt][ks][2]);
        dg::tf32_split(rb < p.sq ? qb[rb * p.q_rs + ch + 4] : 0.f, qh[mt][ks][3], ql[mt][ks][3]);
      }
    }
  }

  float m_i[MT][2], l_i[MT][2], o[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_i[mt][0] = m_i[mt][1] = kNegInf;
    l_i[mt][0] = l_i[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < KS; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  }
  const int64_t bh = static_cast<int64_t>(b) * p.heads + h;
  int kh0 = 0, kw0 = 0;  // kRelpos: grid row and column of the tile's first key

  // a tile's bias: element (mt, n, 2 hh + e) is row row0 + 16 mt + g + 8 hh,
  // key k0 + 8 n + 2 t + e (relpos: key k0 is grid row kh0, column kw0)
  float bv[MT][NT][4];
  auto load_bias = [&](int k0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        bv[mt][n][0] = bv[mt][n][1] = bv[mt][n][2] = bv[mt][n][3] = 0.f;
    if constexpr (BIAS != kNoBias) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * n + 2 * t + e;
          int kh = kh0, kw = kw0 + 8 * n + 2 * t + e;
          if constexpr (BIAS == kRelpos) {
            while (kw >= p.gw) kw -= p.gw, ++kh;
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = row0 + 16 * mt + g + 8 * hh;
              if (r >= p.sq || key >= p.sk) continue;
              float v;
              if constexpr (BIAS == kDense) {
                v = p.bias[b * p.b_bs + h * p.b_hs + r * p.b_rs + key];
              } else if constexpr (BIAS == kRelpos) {
                v = p.bias[(bh * p.gh + kh) * p.sq + r] + p.bias2[(bh * p.gw + kw) * p.sq + r];
              } else {
                const int64_t rk = static_cast<int64_t>(r) * p.sk + key;
                v = p.bias[static_cast<int64_t>(h) * p.sq * p.sk + rk];
                if (p.bias2 != nullptr)
                  v += p.bias2[static_cast<int64_t>(b % p.nw) * p.sq * p.sk + rk];
              }
              bv[mt][n][2 * hh + e] = v;
            }
        }
    }
  };
  // d <= 80: a tile's bias is loaded while the tile before it is in its
  // products, hiding the latency (at d = 512 after the tile's S is summed;
  // the VAE, its main path, has no bias)
  if constexpr (WC == 1) load_bias(0);

  for (int j = 0; j < n_tiles; ++j) {
    dg::cp_async_wait<NS - 2>();  // tile j has landed
    __syncthreads();              // for every thread; and tile j - 1's buffer is free
    if (j + NS - 1 < n_tiles) load_tile(j + NS - 1);
    dg::cp_async_commit();
    const float* ks_t = kv + (j % NS) * 2 * BK * LD;
    const float* vs_t = ks_t + BK * LD;
    const int k0 = j * BK;

    // S = Q K^T over the warp's channels; the three passes of each 8-channel
    // step in turn over the tile's slabs, so that the products next to each
    // other are independent
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ah[MT][4], al[MT][4], kbig[NT][2], ksmall[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (kSplitQ) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ah[mt][e] = qh[mt][ks][e], al[mt][e] = ql[mt][ks][e];
        } else {
          const float* qr = qs + (16 * mt + g) * LD + c0 + 8 * ks + t;
          dg::tf32_split(qr[0], ah[mt][0], al[mt][0]);
          dg::tf32_split(qr[8 * LD], ah[mt][1], al[mt][1]);
          dg::tf32_split(qr[4], ah[mt][2], al[mt][2]);
          dg::tf32_split(qr[8 * LD + 4], ah[mt][3], al[mt][3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* kr = ks_t + (8 * n + g) * LD + c0 + 8 * ks + t;
        dg::tf32_split(kr[0], kbig[n][0], ksmall[n][0]);
        dg::tf32_split(kr[4], kbig[n][1], ksmall[n][1]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          dg::mma_tf32_1688(s[mt][n], al[mt], kbig[n][0], kbig[n][1]);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          dg::mma_tf32_1688(s[mt][n], ah[mt], ksmall[n][0], ksmall[n][1]);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          dg::mma_tf32_1688(s[mt][n], ah[mt], kbig[n][0], kbig[n][1]);
    }
    if constexpr (WC > 1) {
      // the warps' shares of S (each lane's fragments as float4s); warp w
      // sums the w-th WC-th of them in warp order, and every warp reads the
      // whole sum back into its accumulator layout
      constexpr int F = T::kSum, E = F / WC;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
          share[warp * F + (mt * NT + n) * 32 + lane] =
              make_float4(s[mt][n][0], s[mt][n][1], s[mt][n][2], s[mt][n][3]);
      __syncthreads();
      if (lane < E) {
        const int i = warp * E + lane;
        float4 a = share[i];
#pragma unroll
        for (int c = 1; c < WC; ++c) {
          const float4 u = share[c * F + i];
          a.x += u.x, a.y += u.y, a.z += u.z, a.w += u.w;
        }
        ssum[i] = a;
      }
      __syncthreads();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float4 a = ssum[(mt * NT + n) * 32 + lane];
          s[mt][n][0] = a.x, s[mt][n][1] = a.y, s[mt][n][2] = a.z, s[mt][n][3] = a.w;
        }
      load_bias(k0);
    }

    // scale, bias, the keys past Sk; the online softmax; P in place of S
    const bool tail = k0 + BK > p.sk;
    float alpha[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][n][2 * hh + e];
            x = fmaf(x, p.scale, bv[mt][n][2 * hh + e]);
            if (tail && k0 + 8 * n + 2 * t + e >= p.sk) x = kNegInf;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_i[mt][hh], mx);
        alpha[mt][hh] = expf(m_i[mt][hh] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][n][2 * hh + e];
            x = expf(x - m_new);
            sum += x;
          }
        // this thread's keys; the quad's sum at the end
        l_i[mt][hh] = l_i[mt][hh] * alpha[mt][hh] + sum;
        m_i[mt][hh] = m_new;
      }
    if constexpr (BIAS == kRelpos) {  // key k0 + BK's grid row and column
      kw0 += BK;
      while (kw0 >= p.gw) kw0 -= p.gw, ++kh0;
    }
    if constexpr (WC == 1) {
      if (j + 1 < n_tiles) load_bias(k0 + BK);
    }

    // O = alpha O + P V. Slab n's k-slot t is key 8 n + 2 t, slot t + 4 key
    // 8 n + 2 t + 1 (P's A fragment is the S accumulator as it stands). The
    // tile's P V goes into `pv` from zero, CB channel tiles at a time, and is
    // added to O in f32: the tensor core's accumulation truncates, and over
    // every key tile in one accumulator it drifted by 3e-5 relative at 4096
    // keys on an H100.
    uint32_t ph[NT][MT][4], pl[NT][MT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        dg::tf32_split(s[mt][n][0], ph[n][mt][0], pl[n][mt][0]);
        dg::tf32_split(s[mt][n][2], ph[n][mt][1], pl[n][mt][1]);
        dg::tf32_split(s[mt][n][1], ph[n][mt][2], pl[n][mt][2]);
        dg::tf32_split(s[mt][n][3], ph[n][mt][3], pl[n][mt][3]);
      }
#pragma unroll
    for (int cb = 0; cb < KS; cb += CB) {
      float pv[CB][MT][4];
#pragma unroll
      for (int c = 0; c < CB; ++c)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          pv[c][mt][0] = pv[c][mt][1] = pv[c][mt][2] = pv[c][mt][3] = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* vr = vs_t + (8 * n + 2 * t) * LD + c0 + g + 8 * cb;
        uint32_t vbig[CB][2], vsmall[CB][2];
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          dg::tf32_split(vr[8 * c], vbig[c][0], vsmall[c][0]);
          dg::tf32_split(vr[LD + 8 * c], vbig[c][1], vsmall[c][1]);
        }
#pragma unroll
        for (int c = 0; c < CB; ++c)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            dg::mma_tf32_1688(pv[c][mt], pl[n][mt], vbig[c][0], vbig[c][1]);
#pragma unroll
        for (int c = 0; c < CB; ++c)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            dg::mma_tf32_1688(pv[c][mt], ph[n][mt], vsmall[c][0], vsmall[c][1]);
#pragma unroll
        for (int c = 0; c < CB; ++c)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            dg::mma_tf32_1688(pv[c][mt], ph[n][mt], vbig[c][0], vbig[c][1]);
      }
#pragma unroll
      for (int c = 0; c < CB; ++c)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[mt][cb + c][e] = fmaf(o[mt][cb + c][e], alpha[mt][e >> 1], pv[c][mt][e]);
    }
  }
  dg::cp_async_wait<0>();  // no copy outlives the block

  float* ob = p.o + b * p.o_bs + h * p.o_hs;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_i[mt][hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l = fmaxf(l, 1e-30f);
      const int r = row0 + 16 * mt + g + 8 * hh;
      if (r >= p.sq) continue;
#pragma unroll
      for (int c = 0; c < KS; ++c)
        *reinterpret_cast<float2*>(ob + r * p.o_rs + c0 + 8 * c + 2 * t) =
            make_float2(o[mt][c][2 * hh] / l, o[mt][c][2 * hh + 1] / l);
    }
}

template <int D, int BIAS>
int launch_fwd(const AttnArgs& p, cudaStream_t stream) {
  typedef Tile<D> T;
  const cudaError_t err = cudaFuncSetAttribute(
      attn_f32_kernel<D, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + T::kBQ - 1) / T::kBQ, p.heads, p.batch);
  attn_f32_kernel<D, BIAS><<<grid, T::kThreads, T::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mode(const AttnArgs& p, int mode, cudaStream_t stream) {
  switch (mode) {
    case kNoBias: return launch_fwd<D, kNoBias>(p, stream);
    case kDense: return launch_fwd<D, kDense>(p, stream);
    case kRelpos: return launch_fwd<D, kRelpos>(p, stream);
    case kWindow: return launch_fwd<D, kWindow>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
int plan_field(int field) {
  typedef Tile<D> T;
  switch (field) {
    case 0: return T::kBQ;
    case 1: return T::kBK;
    case 2: return T::kWarpsR;
    case 3: return T::kWarpsC;
    case 4: return T::kStages;
    case 5: return T::kSmem;
    default: return -1;
  }
}

// ---- the window backward

constexpr int kWinD = 32;
constexpr int kWinMaxN = 144;
constexpr int kBwdThreads = 256;
constexpr int kWinLD = kWinD + 1;  // odd: a warp reading a column hits 32 banks
constexpr int kBiasAcc = (kWinMaxN * kWinMaxN + kBwdThreads - 1) / kBwdThreads;
constexpr int kRowSlots = (kWinMaxN + 31) / 32;  // keys a lane holds in a row pass

struct WinBwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* d_o;
  const float* bias;  // (heads, n, n)
  const float* mask;  // (nw, n, n) or null
  float* dq;
  float* dk;
  float* dv;
  float* dbias;    // (heads, n, n)
  float* partial;  // (chunks, heads, n, n) when chunks > 1
  int batch, heads, n, nw, chunks, per_chunk;
  int64_t q_bs, q_hs, q_rs, kv_bs, kv_hs, kv_rs, do_bs, do_hs, do_rs, g_bs, g_hs, g_rs;
  float scale;
};

constexpr int win_smem_bytes() {
  return static_cast<int>(sizeof(float)) *
         (4 * kWinMaxN * kWinLD + kWinMaxN * (kWinMaxN + 1));
}

// block (h, chunk): windows chunk * per_chunk .. of head h
__global__ void __launch_bounds__(kBwdThreads, 1) window_bwd_f32_kernel(const WinBwdArgs p) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kWinMaxN * kWinLD;
  float* vs = ks + kWinMaxN * kWinLD;
  float* dos = vs + kWinMaxN * kWinLD;
  float* ss = dos + kWinMaxN * kWinLD;  // n x (n + 1): S, then P, then ds
  const int n = p.n, lds = n + 1, nn = n * n;
  const int h = blockIdx.x, chunk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kBwdThreads / 32;
  float gacc[kBiasAcc];
#pragma unroll
  for (int t = 0; t < kBiasAcc; ++t) gacc[t] = 0.f;

  const int w_end = min(p.batch, (chunk + 1) * p.per_chunk);
  for (int b = chunk * p.per_chunk; b < w_end; ++b) {
    const float* qb = p.q + b * p.q_bs + h * p.q_hs;
    const float* kb = p.k + b * p.kv_bs + h * p.kv_hs;
    const float* vb = p.v + b * p.kv_bs + h * p.kv_hs;
    const float* dob = p.d_o + b * p.do_bs + h * p.do_hs;
    __syncthreads();  // the previous window's reads are done
    for (int i = tid; i < n * (kWinD / 4); i += kBwdThreads) {
      const int r = i / (kWinD / 4), c = (i % (kWinD / 4)) * 4;
      auto put = [&](float* dst, const float4 u) {
        float* cell = dst + r * kWinLD + c;
        cell[0] = u.x, cell[1] = u.y, cell[2] = u.z, cell[3] = u.w;
      };
      put(qs, load4(qb + r * p.q_rs + c));
      put(ks, load4(kb + r * p.kv_rs + c));
      put(vs, load4(vb + r * p.kv_rs + c));
      put(dos, load4(dob + r * p.do_rs + c));
    }
    __syncthreads();
    // S = scale q k^T + bias[h] + mask[b % nw]
    const float* bias_h = p.bias + static_cast<int64_t>(h) * nn;
    const float* mask_b =
        p.mask != nullptr ? p.mask + static_cast<int64_t>(b % p.nw) * nn : nullptr;
    for (int e = tid; e < nn; e += kBwdThreads) {
      const int i = e / n, j = e % n;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kWinD; ++d) s = fmaf(qs[i * kWinLD + d], ks[j * kWinLD + d], s);
      s = s * p.scale + bias_h[e];
      if (mask_b != nullptr) s += mask_b[e];
      ss[i * lds + j] = s;
    }
    __syncthreads();
    // P = softmax by rows, a warp a row
    for (int i = warp; i < n; i += kWarps) {
      float v[kRowSlots];
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < kRowSlots; ++t) {
        const int j = lane + 32 * t;
        v[t] = j < n ? ss[i * lds + j] : kNegInf;
        mx = fmaxf(mx, v[t]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kRowSlots; ++t) {
        v[t] = lane + 32 * t < n ? expf(v[t] - mx) : 0.f;
        sum += v[t];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
      for (int t = 0; t < kRowSlots; ++t) {
        const int j = lane + 32 * t;
        if (j < n) ss[i * lds + j] = v[t] / sum;
      }
    }
    __syncthreads();
    // dv = P^T do
    float* dvb = p.dv + b * p.g_bs + h * p.g_hs;
    for (int e = tid; e < n * kWinD; e += kBwdThreads) {
      const int j = e / kWinD, d = e % kWinD;
      float a = 0.f;
      for (int i = 0; i < n; ++i) a = fmaf(ss[i * lds + j], dos[i * kWinLD + d], a);
      dvb[j * p.g_rs + d] = a;
    }
    __syncthreads();
    // ds = P (dp - rowsum(P dp)), dp = do v^T; a warp a row, in place of P
    for (int i = warp; i < n; i += kWarps) {
      float pr[kRowSlots], dp[kRowSlots];
      float dsum = 0.f;
#pragma unroll
      for (int t = 0; t < kRowSlots; ++t) {
        const int j = lane + 32 * t;
        pr[t] = dp[t] = 0.f;
        if (j < n) {
          float a = 0.f;
#pragma unroll
          for (int d = 0; d < kWinD; ++d) a = fmaf(dos[i * kWinLD + d], vs[j * kWinLD + d], a);
          dp[t] = a;
          pr[t] = ss[i * lds + j];
          dsum = fmaf(pr[t], a, dsum);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
#pragma unroll
      for (int t = 0; t < kRowSlots; ++t) {
        const int j = lane + 32 * t;
        if (j < n) ss[i * lds + j] = pr[t] * (dp[t] - dsum);
      }
    }
    __syncthreads();
    // the bias gradient; dq = scale ds k, dk = scale ds^T q
#pragma unroll
    for (int t = 0; t < kBiasAcc; ++t) {
      const int e = tid + kBwdThreads * t;
      if (e < nn) gacc[t] += ss[(e / n) * lds + e % n];
    }
    float* dqb = p.dq + b * p.g_bs + h * p.g_hs;
    float* dkb = p.dk + b * p.g_bs + h * p.g_hs;
    for (int e = tid; e < n * kWinD; e += kBwdThreads) {
      const int r = e / kWinD, d = e % kWinD;
      float aq = 0.f, ak = 0.f;
      for (int j = 0; j < n; ++j) {
        aq = fmaf(ss[r * lds + j], ks[j * kWinLD + d], aq);
        ak = fmaf(ss[j * lds + r], qs[j * kWinLD + d], ak);
      }
      dqb[r * p.g_rs + d] = aq * p.scale;
      dkb[r * p.g_rs + d] = ak * p.scale;
    }
  }
  float* dst = p.chunks > 1 ? p.partial + (static_cast<int64_t>(chunk) * p.heads + h) * nn
                            : p.dbias + static_cast<int64_t>(h) * nn;
#pragma unroll
  for (int t = 0; t < kBiasAcc; ++t) {
    const int e = tid + kBwdThreads * t;
    if (e < nn) dst[e] = gacc[t];
  }
}

// dbias[h, e] = the chunks' partial sums in chunk order
__global__ void window_bias_sum_kernel(const float* __restrict__ partial,
                                       float* __restrict__ dbias, int chunks, int64_t per_chunk) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= per_chunk) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[c * per_chunk + e];
  dbias[e] = s;
}

}  // namespace

// Float32 attention: q, k, v, o (f32) at base + b * bs + h * hs + row * rs,
// unit channel stride, strides multiples of 4 and bases 16-byte aligned; k
// and v share strides. mode: 0 none, 1 dense bias (bias + b b_bs + h b_hs +
// r b_rs + key), 2 relative position (bias = bias_h_t (batch heads, gh, sq),
// bias2 = bias_w_t (batch heads, gw, sq), sq = sk = gh gw), 3 window (bias
// (heads, sq, sk), bias2 = mask (nw, sq, sk) or null). d: 32, 64, 80 or 512.
extern "C" int dg_attention_f32(const void* q, const void* k, const void* v, void* o,
                                const void* bias, const void* bias2, int mode, int d, int batch,
                                int heads, int sq, int sk, int64_t q_bs, int64_t q_hs,
                                int64_t q_rs, int64_t kv_bs, int64_t kv_hs, int64_t kv_rs,
                                int64_t o_bs, int64_t o_hs, int64_t o_rs, int64_t b_bs,
                                int64_t b_hs, int64_t b_rs, int gh, int gw, int nw, float scale,
                                void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || batch > 65535 || heads > 65535 ||
      (mode != kNoBias && bias == nullptr) || (mode == kRelpos && (bias2 == nullptr ||
      gh < 1 || gw < 1 || gh * gw != sq || sq != sk)) || (mode == kWindow && nw < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.bias = static_cast<const float*>(bias);
  p.bias2 = static_cast<const float*>(bias2);
  p.batch = batch;
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.q_bs = q_bs, p.q_hs = q_hs, p.q_rs = q_rs;
  p.kv_bs = kv_bs, p.kv_hs = kv_hs, p.kv_rs = kv_rs;
  p.o_bs = o_bs, p.o_hs = o_hs, p.o_rs = o_rs;
  p.b_bs = b_bs, p.b_hs = b_hs, p.b_rs = b_rs;
  p.gh = gh, p.gw = gw, p.nw = nw;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_mode<32>(p, mode, s);
    case 64: return launch_mode<64>(p, mode, s);
    case 80: return launch_mode<80>(p, mode, s);
    case 512: return launch_mode<512>(p, mode, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The forward's plan at head dim d (ops/attention_f32.py: TC_PLANS): field 0
// query rows a block, 1 keys a tile, 2 warps by rows, 3 warps by channels, 4
// tiles in flight, 5 shared-memory bytes; -1 for another d or field
extern "C" int dg_attention_f32_plan(int d, int field) {
  switch (d) {
    case 32: return plan_field<32>(field);
    case 64: return plan_field<64>(field);
    case 80: return plan_field<80>(field);
    case 512: return plan_field<512>(field);
    default: return -1;
  }
}

// The window backward on float32 tensors, the interface of
// dg_window_attention_bwd_bf16: q, k, v, d_o and dq, dk, dv (g strides) at
// base + b bs + h hs + row rs, head dim 32, 1 <= n <= 144; bias (heads, n, n),
// mask (nw, n, n) or null; dbias (heads, n, n); partial (chunks, heads, n, n)
// when chunks > 1. Block (h, chunk) takes windows chunk * per_chunk on.
extern "C" int dg_window_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* d_o, const void* bias,
    const void* mask, void* dq, void* dk, void* dv, void* dbias, void* partial, int batch,
    int heads, int n, int nw, int chunks, int per_chunk, int64_t q_bs, int64_t q_hs, int64_t q_rs,
    int64_t kv_bs, int64_t kv_hs, int64_t kv_rs, int64_t do_bs, int64_t do_hs, int64_t do_rs,
    int64_t g_bs, int64_t g_hs, int64_t g_rs, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || heads > 65535 || n < 1 || n > kWinMaxN || nw < 1 ||
      chunks < 1 || chunks > 65535 || per_chunk < 1 ||
      static_cast<int64_t>(chunks) * per_chunk < batch || (chunks > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  WinBwdArgs p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.d_o = static_cast<const float*>(d_o);
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.dbias = static_cast<float*>(dbias);
  p.partial = static_cast<float*>(partial);
  p.batch = batch, p.heads = heads, p.n = n, p.nw = nw;
  p.chunks = chunks, p.per_chunk = per_chunk;
  p.q_bs = q_bs, p.q_hs = q_hs, p.q_rs = q_rs;
  p.kv_bs = kv_bs, p.kv_hs = kv_hs, p.kv_rs = kv_rs;
  p.do_bs = do_bs, p.do_hs = do_hs, p.do_rs = do_rs;
  p.g_bs = g_bs, p.g_hs = g_hs, p.g_rs = g_rs;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int bytes = win_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(window_bwd_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_bwd_f32_kernel<<<dim3(heads, chunks), kBwdThreads, bytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const int64_t per = static_cast<int64_t>(heads) * n * n;
  window_bias_sum_kernel<<<static_cast<unsigned>((per + 255) / 256), 256, 0, s>>>(
      p.partial, p.dbias, chunks, per);
  return static_cast<int>(cudaGetLastError());
}

// The same on a fused (bn, n, 3C) float32 projection and its (bn, n, 3C)
// gradient, the interface of dg_window_attention_packed_bwd_bf16
extern "C" int dg_window_attention_packed_bwd_f32(
    const void* qkv, const void* d_o, const void* bias, const void* mask, void* dqkv,
    void* dbias, void* partial, int bn, int n, int heads, int nw, int chunks, int per_chunk,
    float scale, void* stream) {
  const int64_t c = static_cast<int64_t>(heads) * kWinD;
  const float* base = static_cast<const float*>(qkv);
  float* grad = static_cast<float*>(dqkv);
  return dg_window_attention_bwd_f32(
      base, base + c, base + 2 * c, d_o, bias, mask, grad, grad + c, grad + 2 * c, dbias, partial,
      bn, heads, n, nw, chunks, per_chunk, n * 3 * c, kWinD, 3 * c, n * 3 * c, kWinD, 3 * c,
      n * c, kWinD, c, n * 3 * c, kWinD, 3 * c, scale, stream);
}
