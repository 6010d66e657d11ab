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
//     tile). d = 128 the same way with four warps of 32 channels, three
//     stages.
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
// The window backward (kernels 5 and 6), head dims 32 and 64: the same
// three-pass products on mma.sync, P and ds through one shared-memory tile;
// its design is written beside it, further down.

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
// d 128 (head dims 81-128, padded): Q split into registers would take 128 of
// them a thread, so the channels are split over four warps, as at d = 512
template <>
struct Plan<128> {
  static constexpr int kWarpsR = 1, kWarpsC = 4, kMT = 2, kBK = 16, kStages = 3;
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

// ---- the window backward (kernels 5 and 6), on the tensor cores
//
// Per window b and head h, with n <= 144 tokens and head dim D (32 or 64):
//   p = softmax(scale q k^T + bias[h] + mask[b % nW]), dv = p^T do, dp = do v^T,
//   ds = p (dp - rowsum(p dp)), dq = scale ds k, dk = scale ds^T q,
//   dbias[h] = the f32 sum of ds over the windows.
// What bounds it: operations. Five products of 2 n^2 D a window and head, on
// m16n8k8 TF32 in three passes (small terms first), each pass over a group of
// independent accumulators before the next (a pass's products side by side
// do not wait on each other), and the long sums (over the 144 keys or
// queries of dv, dq, dk) in fresh accumulators of kGroup slabs added in f32.
// The operands are split by split_fast, not the forward's cvt.rna pair.
//
// A block takes one head and a chunk of consecutive windows
// (ops/window_attention.py: f32_backward_plan). Its shared memory holds q, k,
// v and do of one window (rows of D floats, 4-float chunks XOR-swizzled by the
// row, rows past n zero), one NP x NP f32 tile (rows NP + 8 floats apart),
// which holds bias + mask, then P, then ds, and the chunk's bias-gradient sum
// (ops/window_attention.py: f32_backward_layout). The tile and the sum take
// 166 KB at n = 144, so v shares q's room there (kSwap: v for steps 2-3, q
// read again for step 4); at D = 64 and n = 144 even that leaves no room for
// the sum, and it is kept in registers instead, kAcc floats a thread over the
// flat tile, with twelve warps (three idle in the products) so that a thread
// holds 54 of them, not 72. One warp a 16-row (or 16-key) tile: two, each
// taking half the keys or channels, spilled at 96 registers a thread and
// were slower (PERF.md §6, PR 16).
// Per window:
//   0. bias[h] + mask[b % nW] into the tile (float4 reads in order; the head's
//      bias cannot stay resident: no room beside the tile);
//   1. warp w, rows 16w..: S = q k^T in registers, scale and bias, the row
//      softmax by quads, P into the tile (rows past n zero);
//   2. warp w, keys 16w..: dv = P^T do, P^T read from the tile;
//   3. warp w, rows 16w..: dp = do v^T in registers, rowsum(P dp), ds into the
//      tile in place of P, dq = ds k with ds read back by float2 as the A
//      fragment in pv_slot_key order (k's rows read in that order);
//   4. every thread adds its elements of the tile to the bias-gradient sum;
//      warp w, keys 16w..: dk = ds^T q.
// The next window's k, v and do load during step 4, its q during step 0.
// A second small kernel adds the chunks' partial sums in a fixed order (two
// runs, the same bits).

constexpr int kWinMaxN = 144;
constexpr int kSmemLimit = 232448;  // shared memory a block can take
constexpr int kSmShared = 233472;   // of a multiprocessor, that blocks can take
constexpr int kBlockReserved = 1024;
constexpr int kSmWarps = 64;
constexpr int kSmBlocks = 32;

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// the body at NT 16-row tiles a window (n <= 16 NT) and head dim D
template <int NT, int D>
struct WinBwd {
  static constexpr int kNT = NT, kD = D;
  static constexpr int NP = 16 * NT;  // rows (and keys) of a window, padded
  static constexpr int kLD = NP + 8;  // 8 or 24 mod 32: conflict-free fragments
  static constexpr int kOp = NP * D;  // floats of q, k, v or do
  static constexpr int kTile = NP * kLD;
  static constexpr int kSum = NP * NP;
  static constexpr int bytes(int ops, bool sum) { return (ops * kOp + kTile + (sum ? kSum : 0)) * 4; }
  static constexpr bool kSumSmem = bytes(3, true) <= kSmemLimit;
  static constexpr bool kSwap = bytes(4, kSumSmem) > kSmemLimit;
  static constexpr int kSmem = bytes(kSwap ? 3 : 4, kSumSmem);
  static constexpr int kWarps = !kSumSmem && NT == 9 ? 12 : NT;  // warp w < NT: rows / keys 16w..
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kAcc = kSumSmem ? 1 : (NP * NP + kThreads - 1) / kThreads;
  static constexpr int kResident =
      cmin(cmin(kSmShared / (kSmem + kBlockReserved), kSmWarps / kWarps), kSmBlocks);
  static constexpr int kGroup = 6;  // 8-row slabs of a fresh accumulator
  static_assert(kSmem <= kSmemLimit, "a block's shared memory");
};

// the slabs of 8 keys a group of independent accumulators takes in
// rows_times_t: the largest divisor of m up to 7
__host__ __device__ constexpr int slab_group(int m) {
  int g = 7;
  while (m % g) --g;
  return g;
}

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
  float* partial;  // (chunks, heads, n, n), or dbias itself with one chunk
  int batch, heads, n, nw, per_chunk;
  int64_t q_bs, q_hs, q_rs, kv_bs, kv_hs, kv_rs, do_bs, do_hs, do_rs, g_bs, g_hs, g_rs;
  float scale;
};

// element (r, c) of a q, k, v or do tile, its rows D floats and the 4-float
// chunks of row r permuted by XOR with x(r):
//   kRowT false (k, v): x = r % 8; conflict-free reads of (rows g, columns t)
//     (S's and dp's B) and (rows 2t and 2t + 1, columns g) (dq's B);
//   kRowT true (q, do): x = 2 (r % 4) + (r / 4) % 2; conflict-free reads of
//     (rows g, columns t) (S's and dp's A) and (rows t and t + 4, columns g)
//     (dk's and dv's B).
template <int D, bool kRowT>
__device__ __forceinline__ int swz(int r, int c) {
  const int x = kRowT ? 2 * (r & 3) + ((r >> 2) & 1) : (r & 7);
  return r * D + (c ^ (x << 2));
}

// rows 0..NP-1 of one window's operand by cp.async, rows past n zero
template <int NP, int D, bool kRowT, int kThreads>
__device__ __forceinline__ void load_operand(float* dst, const float* src, int64_t rs, int n,
                                             int tid) {
  for (int i = tid; i < NP * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool valid = r < n;
    dg::cp_async16(dst + swz<D, kRowT>(r, c), src + (valid ? r * rs + c : 0), valid);
  }
}

// x = big + small for the TF32 tensor cores, which read the top 19 bits of an
// operand's register: big = x's bits plus half a TF32 unit, so that the bits
// read are x rounded to nearest, ties away (cvt.rna's result); small = x -
// tf32(x), exact, read truncated. Three integer and float operations in
// place of two cvt.rna, which cost this body a fifth of its time (PERF.md
// §6, PR 16); truncating small, not rounding it, costs at most 2^-21 |x|
// (ops/tf32x3.py: split_tf32_fast)
__device__ __forceinline__ void split_fast(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_fast(x[e], big[e], small[e]);
}

// acc[i] += a b[i] for M independent accumulators, in three TF32 passes, the
// small terms first; each pass over all M before the next
template <int M>
__device__ __forceinline__ void mma3_over(float (*acc)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const uint32_t (*bh)[2],
                                          const uint32_t (*bl)[2]) {
#pragma unroll
  for (int i = 0; i < M; ++i) dg::mma_tf32_1688(acc[i], al, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < M; ++i) dg::mma_tf32_1688(acc[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
  for (int i = 0; i < M; ++i) dg::mma_tf32_1688(acc[i], ah, bh[i][0], bh[i][1]);
}

// A (16 x 8) times acc's D/8 channel tiles of y: B of tile c is y at rows
// row(0) and row(1), columns 8c + g, split once; y's swizzle kRowT
template <int D, bool kRowT, typename Row>
__device__ __forceinline__ void times_channels(float (&acc)[D / 8][4], const float (&a)[4],
                                               const float* y, Row row, int g) {
  uint32_t ah[4], al[4], bh[D / 8][2], bl[D / 8][2];
  split4(a, ah, al);
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    split_fast(y[swz<D, kRowT>(row(0), 8 * c + g)], bh[c][0], bl[c][0]);
    split_fast(y[swz<D, kRowT>(row(1), 8 * c + g)], bh[c][1], bl[c][1]);
  }
  mma3_over<D / 8>(acc, ah, al, bh, bl);
}

// x^T y for this warp's 16 columns c0.. of the tile x (all NP rows) and y an
// operand read as (rows, channels): acc[c] is (columns c0 + g (+ 8), channels
// 8c + 2t (+ 1)); fresh accumulators of kGroup row slabs added in f32
template <int NT, int D, bool kRowT>
__device__ __forceinline__ void tile_t_times(float (&acc)[D / 8][4], const float* tile,
                                             const float* y, int c0, int g, int t) {
  typedef WinBwd<NT, D> W;
  constexpr int LD = W::kLD;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
#pragma unroll
  for (int g0 = 0; g0 < 2 * NT; g0 += W::kGroup) {
    float part[D / 8][4];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) part[c][0] = part[c][1] = part[c][2] = part[c][3] = 0.f;
#pragma unroll
    for (int kk = g0; kk < cmin(g0 + W::kGroup, 2 * NT); ++kk) {
      const float* x0 = tile + (8 * kk + t) * LD + c0 + g;
      const float a[4] = {x0[0], x0[8], x0[4 * LD], x0[4 * LD + 8]};
      times_channels<D, kRowT>(part, a, y, [&](int h) { return 8 * kk + t + 4 * h; }, g);
    }
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] += part[c][e];
  }
}

// x y^T for this warp's 16 rows r0.. of x and all NP rows of y, both
// operands (rows, channels): acc[j] is (rows r0 + g (+ 8), columns 8j + 2t (+ 1)).
// The 2 NT column slabs in groups of slab_group(2 NT), each group's B split
// once a channel step and its three passes taken over the group
template <int NT, int D, bool kRowTx>
__device__ __forceinline__ void rows_times_t(float (&acc)[2 * NT][4], const float* x,
                                             const float* y, int r0, int g, int t) {
  constexpr int G = slab_group(2 * NT);
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const int c = 8 * ks + t;
    const float a[4] = {x[swz<D, kRowTx>(r0 + g, c)], x[swz<D, kRowTx>(r0 + g + 8, c)],
                        x[swz<D, kRowTx>(r0 + g, c + 4)], x[swz<D, kRowTx>(r0 + g + 8, c + 4)]};
    uint32_t ah[4], al[4];
    split4(a, ah, al);
#pragma unroll
    for (int j0 = 0; j0 < 2 * NT; j0 += G) {
      uint32_t bh[G][2], bl[G][2];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        split_fast(y[swz<D, false>(8 * (j0 + j) + g, c)], bh[j][0], bl[j][0]);
        split_fast(y[swz<D, false>(8 * (j0 + j) + g, c + 4)], bh[j][1], bl[j][1]);
      }
      mma3_over<G>(acc + j0, ah, al, bh, bl);
    }
  }
}

// rows r0 + g and r0 + g + 8 of a (16, 8 D/8) accumulator, times `scale`, to
// dst + row rs (rows < n)
template <int D>
__device__ __forceinline__ void store_rows(float* dst, int64_t rs, const float (&acc)[D / 8][4],
                                           float scale, int r0, int n, int g, int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + g + 8 * hh;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(dst + r * rs + 8 * c + 2 * t) =
          make_float2(acc[c][2 * hh] * scale, acc[c][2 * hh + 1] * scale);
  }
}

// block i: head i % heads, windows (i / heads) * per_chunk ..
template <int NT, int D>
__global__ void __launch_bounds__(WinBwd<NT, D>::kThreads, WinBwd<NT, D>::kResident)
    window_bwd_tc_kernel(const WinBwdArgs p) {
  typedef WinBwd<NT, D> W;
  constexpr int NP = W::NP, LD = W::kLD, TH = W::kThreads;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // q; with kSwap v in steps 2-3
  float* ks = qs + W::kOp;
  float* dos = ks + W::kOp;
  float* vs = W::kSwap ? qs : dos + W::kOp;
  float* tile = dos + (W::kSwap ? 1 : 2) * W::kOp;
  float* sum = tile + W::kTile;  // kSumSmem: the chunk's bias gradient, NP x NP
  const int n = p.n;
  const int h = blockIdx.x % p.heads, chunk = blockIdx.x / p.heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b_first = chunk * p.per_chunk;
  const int count = min(p.batch, b_first + p.per_chunk) - b_first;  // >= 1: the entry checks
  const int nn = n * n;
  const float* bias_h = p.bias + static_cast<int64_t>(h) * nn;

  auto load_q = [&](int b) {
    load_operand<NP, D, true, TH>(qs, p.q + b * p.q_bs + h * p.q_hs, p.q_rs, n, tid);
  };
  auto load_kvdo = [&](int b, bool with_v) {
    const int64_t kv = b * p.kv_bs + h * p.kv_hs;
    load_operand<NP, D, false, TH>(ks, p.k + kv, p.kv_rs, n, tid);
    if (with_v) load_operand<NP, D, false, TH>(vs, p.v + kv, p.kv_rs, n, tid);
    load_operand<NP, D, true, TH>(dos, p.d_o + b * p.do_bs + h * p.do_hs, p.do_rs, n, tid);
  };

  float gacc[W::kAcc];  // !kSumSmem: this thread's elements of the sum
#pragma unroll
  for (int u = 0; u < W::kAcc; ++u) gacc[u] = 0.f;
  if constexpr (W::kSumSmem)
    for (int e = tid; e < W::kSum; e += TH) sum[e] = 0.f;

  load_q(b_first);
  load_kvdo(b_first, !W::kSwap);
  dg::cp_async_commit();
  for (int i = 0; i < count; ++i) {
    const int b = b_first + i;
    const int64_t g_off = b * p.g_bs + h * p.g_hs;
    const bool more = i + 1 < count;

    // ---- 0: bias[h] + mask[b % nW] into the tile (n x n of it)
    const float* mask_b = p.mask ? p.mask + static_cast<int64_t>(b % p.nw) * nn : nullptr;
    if ((n & 3) == 0) {  // rows of whole float4s
      constexpr int kBatch = 4;  // float4s of bias and of mask a thread issues a round
      const int n4 = nn / 4, w4 = n / 4;
      for (int e0 = tid; e0 < n4; e0 += kBatch * TH) {
        float4 x[kBatch], m[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * TH;
          x[u] = e < n4 ? load4(bias_h + 4 * e) : make_float4(0.f, 0.f, 0.f, 0.f);
          m[u] = e < n4 && mask_b ? load4(mask_b + 4 * e) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * TH;
          if (e < n4) {
            const int r = e / w4, c = 4 * (e - r * w4);
            *reinterpret_cast<float4*>(tile + r * LD + c) =
                make_float4(x[u].x + m[u].x, x[u].y + m[u].y, x[u].z + m[u].z, x[u].w + m[u].w);
          }
        }
      }
    } else {
      for (int r = warp; r < n; r += W::kWarps)
        for (int c = lane; c < n; c += 32)
          tile[r * LD + c] = bias_h[r * n + c] + (mask_b ? mask_b[r * n + c] : 0.f);
    }
    dg::cp_async_wait<0>();  // this window's q, k, (v,) do
    __syncthreads();

    // ---- 1: S, the softmax, P into the tile
    if (warp < NT) {
      const int r0 = 16 * warp;
      float s[2 * NT][4];
      rows_times_t<NT, D, true>(s, qs, ks, r0, g, t);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          // rows past n: no bias (their cells are stale), and P = 0 below
          const float2 bm =
              r0 + g + 8 * hh < n
                  ? *reinterpret_cast<const float2*>(tile + (r0 + g + 8 * hh) * LD + 8 * j + 2 * t)
                  : make_float2(0.f, 0.f);
          float x0 = fmaf(s[j][2 * hh], p.scale, bm.x);
          float x1 = fmaf(s[j][2 * hh + 1], p.scale, bm.y);
          if (8 * j + 2 * t >= n) x0 = kNegInf;
          if (8 * j + 2 * t + 1 >= n) x1 = kNegInf;
          s[j][2 * hh] = x0, s[j][2 * hh + 1] = x1;
          mx[hh] = fmaxf(mx[hh], fmaxf(x0, x1));
        }
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      }
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - mx[e >> 1]);
          rsum[e >> 1] += s[j][e];
        }
      float inv[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        rsum[hh] += __shfl_xor_sync(0xffffffffu, rsum[hh], 1);
        rsum[hh] += __shfl_xor_sync(0xffffffffu, rsum[hh], 2);
        inv[hh] = r0 + g + 8 * hh < n ? 1.f / rsum[hh] : 0.f;  // rows past n: P = 0
      }
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(tile + (r0 + g + 8 * hh) * LD + 8 * j + 2 * t) =
              make_float2(s[j][2 * hh] * inv[hh], s[j][2 * hh + 1] * inv[hh]);
    }
    __syncthreads();
    if constexpr (W::kSwap) {  // q's room is free until step 4: v
      load_operand<NP, D, false, TH>(vs, p.v + b * p.kv_bs + h * p.kv_hs, p.kv_rs, n, tid);
      dg::cp_async_commit();
    }

    // ---- 2: dv = P^T do
    if (warp < NT) {
      float acc[D / 8][4];
      tile_t_times<NT, D, true>(acc, tile, dos, 16 * warp, g, t);
      store_rows<D>(p.dv + g_off, p.g_rs, acc, 1.f, 16 * warp, n, g, t);
    }
    if constexpr (W::kSwap) dg::cp_async_wait<0>();
    __syncthreads();  // every read of P is done

    // ---- 3: dp, ds into the tile, dq = ds k
    if (warp < NT) {
      const int r0 = 16 * warp;
      float dp[2 * NT][4];
      rows_times_t<NT, D, true>(dp, dos, vs, r0, g, t);
      float delta[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 pr =
              *reinterpret_cast<const float2*>(tile + (r0 + g + 8 * hh) * LD + 8 * j + 2 * t);
          delta[hh] = fmaf(pr.x, dp[j][2 * hh], fmaf(pr.y, dp[j][2 * hh + 1], delta[hh]));
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        delta[hh] += __shfl_xor_sync(0xffffffffu, delta[hh], 1);
        delta[hh] += __shfl_xor_sync(0xffffffffu, delta[hh], 2);
      }
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float2* cell = reinterpret_cast<float2*>(tile + (r0 + g + 8 * hh) * LD + 8 * j + 2 * t);
          const float2 pr = *cell;
          *cell = make_float2(pr.x * (dp[j][2 * hh] - delta[hh]),
                              pr.y * (dp[j][2 * hh + 1] - delta[hh]));
        }
      __syncwarp();
      // dq: slab j's k-slot t is key 8j + 2t, slot t + 4 key 8j + 2t + 1 (one
      // float2 of ds a row), and k's rows are read in that order
      float acc[D / 8][4];
#pragma unroll
      for (int c = 0; c < D / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
#pragma unroll
      for (int g0 = 0; g0 < 2 * NT; g0 += W::kGroup) {
        float part[D / 8][4];
#pragma unroll
        for (int c = 0; c < D / 8; ++c) part[c][0] = part[c][1] = part[c][2] = part[c][3] = 0.f;
#pragma unroll
        for (int j = g0; j < cmin(g0 + W::kGroup, 2 * NT); ++j) {
          const float2 lo = *reinterpret_cast<const float2*>(tile + (r0 + g) * LD + 8 * j + 2 * t);
          const float2 hi =
              *reinterpret_cast<const float2*>(tile + (r0 + g + 8) * LD + 8 * j + 2 * t);
          const float a[4] = {lo.x, hi.x, lo.y, hi.y};
          times_channels<D, false>(part, a, ks, [&](int e) { return 8 * j + 2 * t + e; }, g);
        }
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[c][e] += part[c][e];
      }
      store_rows<D>(p.dq + g_off, p.g_rs, acc, p.scale, r0, n, g, t);
    }
    __syncthreads();  // ds is whole; k, v and do are free
    if constexpr (W::kSwap) {
      load_q(b);
      dg::cp_async_commit();
      if (more) load_kvdo(b + 1, false);
      dg::cp_async_commit();
    } else if (more) {
      load_kvdo(b + 1, true);
      dg::cp_async_commit();
    }

    // ---- 4: the bias-gradient sum; dk = ds^T q
    if constexpr (W::kSumSmem) {
      for (int e = tid; e < W::kSum; e += TH) sum[e] += tile[(e / NP) * LD + e % NP];
    } else {
#pragma unroll
      for (int u = 0; u < W::kAcc; ++u) {
        const int e = tid + u * TH;
        if (e < W::kSum) gacc[u] += tile[(e / NP) * LD + e % NP];
      }
    }
    if constexpr (W::kSwap) {
      dg::cp_async_wait<1>();  // q again
      __syncthreads();
    }
    if (warp < NT) {
      float acc[D / 8][4];
      tile_t_times<NT, D, true>(acc, tile, qs, 16 * warp, g, t);
      store_rows<D>(p.dk + g_off, p.g_rs, acc, p.scale, 16 * warp, n, g, t);
    }
    __syncthreads();  // the tile and q are free
    if (more) {
      load_q(b + 1);
      dg::cp_async_commit();
    }
  }

  float* out = p.partial + (static_cast<int64_t>(chunk) * p.heads + h) * nn;
  if constexpr (W::kSumSmem) {
    for (int e = tid; e < W::kSum; e += TH) {
      const int r = e / NP, c = e % NP;
      if (r < n && c < n) out[r * n + c] = sum[e];
    }
  } else {
#pragma unroll
    for (int u = 0; u < W::kAcc; ++u) {
      const int e = tid + u * TH;
      const int r = e / NP, c = e % NP;
      if (r < n && c < n) out[r * n + c] = gacc[u];
    }
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

// 16-row tiles of the body that takes n tokens (0: none)
int win_tiles(int n) {
  constexpr int kTiles[] = {1, 2, 4, 7, 9};
  for (int nt : kTiles)
    if (n <= 16 * nt) return nt;
  return 0;
}

template <int NT, int D>
int launch_win_bwd(const WinBwdArgs& p, int chunks, cudaStream_t s) {
  typedef WinBwd<NT, D> W;
  const cudaError_t err = cudaFuncSetAttribute(
      window_bwd_tc_kernel<NT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, W::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_bwd_tc_kernel<NT, D><<<chunks * p.heads, W::kThreads, W::kSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// f(WinBwd<NT, D>()) for the body of n tokens and head dim d; `none` without one
template <typename F>
int with_win_body(int n, int d, int none, F&& f) {
  const int nt = win_tiles(n);
#define DG_WIN_CASE(NT_, D_) \
  if (nt == NT_ && d == D_) return f(WinBwd<NT_, D_>());
  DG_WIN_CASE(1, 32) DG_WIN_CASE(2, 32) DG_WIN_CASE(4, 32) DG_WIN_CASE(7, 32) DG_WIN_CASE(9, 32)
  DG_WIN_CASE(1, 64) DG_WIN_CASE(2, 64) DG_WIN_CASE(4, 64) DG_WIN_CASE(7, 64) DG_WIN_CASE(9, 64)
#undef DG_WIN_CASE
  return none;
}

}  // namespace

// Float32 attention: q, k, v, o (f32) at base + b * bs + h * hs + row * rs,
// unit channel stride, strides multiples of 4 and bases 16-byte aligned; k
// and v share strides. mode: 0 none, 1 dense bias (bias + b b_bs + h b_hs +
// r b_rs + key), 2 relative position (bias = bias_h_t (batch heads, gh, sq),
// bias2 = bias_w_t (batch heads, gw, sq), sq = sk = gh gw), 3 window (bias
// (heads, sq, sk), bias2 = mask (nw, sq, sk) or null). d: 32, 64, 80, 128 or 512.
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
    case 128: return launch_mode<128>(p, mode, s);
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
    case 128: return plan_field<128>(field);
    case 512: return plan_field<512>(field);
    default: return -1;
  }
}

// The window backward on float32 tensors: q, k, v, d_o and dq, dk, dv (g
// strides) at base + b bs + h hs + row rs, unit channel stride, strides
// multiples of 4 and bases 16-byte aligned; k and v share strides. Head dim d
// 32 or 64, 1 <= n <= 144; bias (heads, n, n), mask (nw, n, n) or null; dbias
// (heads, n, n); partial (chunks, heads, n, n) when chunks > 1. Block i takes
// head i % heads and windows (i / heads) * per_chunk on
// (ops/window_attention.py: f32_backward_plan).
extern "C" int dg_window_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* d_o, const void* bias,
    const void* mask, void* dq, void* dk, void* dv, void* dbias, void* partial, int batch,
    int heads, int n, int d, int nw, int chunks, int per_chunk, int64_t q_bs, int64_t q_hs,
    int64_t q_rs, int64_t kv_bs, int64_t kv_hs, int64_t kv_rs, int64_t do_bs, int64_t do_hs,
    int64_t do_rs, int64_t g_bs, int64_t g_hs, int64_t g_rs, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || n < 1 || n > kWinMaxN || nw < 1 || chunks < 1 ||
      per_chunk < 1 || static_cast<int64_t>(chunks) * heads > 2147483647 ||
      static_cast<int64_t>(chunks) * per_chunk < batch ||
      static_cast<int64_t>(chunks - 1) * per_chunk >= batch || (chunks > 1 && partial == nullptr) ||
      (mask != nullptr && batch % nw))
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
  p.partial = static_cast<float*>(chunks > 1 ? partial : dbias);
  p.batch = batch, p.heads = heads, p.n = n, p.nw = nw, p.per_chunk = per_chunk;
  p.q_bs = q_bs, p.q_hs = q_hs, p.q_rs = q_rs;
  p.kv_bs = kv_bs, p.kv_hs = kv_hs, p.kv_rs = kv_rs;
  p.do_bs = do_bs, p.do_hs = do_hs, p.do_rs = do_rs;
  p.g_bs = g_bs, p.g_hs = g_hs, p.g_rs = g_rs;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = with_win_body(n, d, static_cast<int>(cudaErrorInvalidValue), [&](auto w) {
    return launch_win_bwd<decltype(w)::kNT, decltype(w)::kD>(p, chunks, s);
  });
  if (code != 0 || chunks == 1) return code;
  const int64_t per = static_cast<int64_t>(heads) * n * n;
  window_bias_sum_kernel<<<static_cast<unsigned>((per + 255) / 256), 256, 0, s>>>(
      p.partial, static_cast<float*>(dbias), chunks, per);
  return static_cast<int>(cudaGetLastError());
}

// The same on a fused (bn, n, 3C) float32 projection (C = heads d) and its
// (bn, n, 3C) gradient, do (bn, n, C)
extern "C" int dg_window_attention_packed_bwd_f32(
    const void* qkv, const void* d_o, const void* bias, const void* mask, void* dqkv,
    void* dbias, void* partial, int bn, int n, int heads, int d, int nw, int chunks,
    int per_chunk, float scale, void* stream) {
  const int64_t c = static_cast<int64_t>(heads) * d;
  const float* base = static_cast<const float*>(qkv);
  float* grad = static_cast<float*>(dqkv);
  return dg_window_attention_bwd_f32(
      base, base + c, base + 2 * c, d_o, bias, mask, grad, grad + c, grad + 2 * c, dbias, partial,
      bn, heads, n, d, nw, chunks, per_chunk, n * 3 * c, d, 3 * c, n * 3 * c, d, 3 * c, n * c, d,
      c, n * 3 * c, d, 3 * c, scale, stream);
}

// The backward body's shared-memory bytes at n tokens and head dim d
// (ops/window_attention.py: f32_backward_smem); -1 without a body
extern "C" int dg_window_attention_bwd_f32_smem(int n, int d) {
  return with_win_body(n, d, -1, [](auto w) { return decltype(w)::kSmem; });
}

// Its blocks resident on a multiprocessor, as the card reports them (shared
// memory, warps and registers); -1 without a body, or the CUDA error negated
extern "C" int dg_window_attention_bwd_f32_resident(int n, int d) {
  return with_win_body(n, d, -1, [](auto w) {
    typedef decltype(w) W;
    auto kernel = window_bwd_tc_kernel<W::kNT, W::kD>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::kSmem);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, W::kThreads, W::kSmem);
    return err == cudaSuccess ? blocks : -static_cast<int>(err);
  });
}
