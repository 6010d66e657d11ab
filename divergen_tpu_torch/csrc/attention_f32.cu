// Float32 attention for the port's five attention kernels, forward and the
// window backward, for Hopper (sm_90a): q, k, v, the output and every product
// in float32 on the CUDA cores (FMA), as the Pallas kernels compute a float32
// input (their dots run in the input's dtype).
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
// What bounds it: operations, at 67 TFLOP/s of f32 FMA. A simple body that is
// right: a block of 128 threads takes BQ query rows of one (b, h) and walks
// the keys in tiles of BK; q, k and v tiles go through shared memory, each
// thread holds a TR x TC patch of the scores and a TRo x TDo patch of the
// output, and the row statistics are reduced by shuffles. Head dims 32, 64,
// 80 (BQ = BK = 64) and 512 (BQ 16, BK 32).
//
// The window backward (kernels 5 and 6): a block takes one head and a chunk
// of consecutive windows; for each window q, k, v, do (n x 32) and the n x n
// scores sit in shared memory (n <= 144: 166 KB), P = softmax(S) is
// recomputed in place, dv = P^T do, ds = P (dp - rowsum(P dp)) with dp =
// do v^T in place of P, dq = scale ds k, dk = scale ds^T q; the block adds its
// windows' ds into a bias gradient in registers, and a second small kernel
// adds the chunks' partial sums in a fixed order (two runs, the same bits).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

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

template <int BIAS>
__device__ __forceinline__ float bias_at(const AttnArgs& p, int b, int h, int r, int c) {
  if constexpr (BIAS == kDense) {
    return p.bias[b * p.b_bs + h * p.b_hs + r * p.b_rs + c];
  } else if constexpr (BIAS == kRelpos) {
    const int64_t bh = static_cast<int64_t>(b) * p.heads + h;
    return p.bias[(bh * p.gh + c / p.gw) * p.sq + r] + p.bias2[(bh * p.gw + c % p.gw) * p.sq + r];
  } else if constexpr (BIAS == kWindow) {
    const int64_t rc = static_cast<int64_t>(r) * p.sk + c;
    float v = p.bias[static_cast<int64_t>(h) * p.sq * p.sk + rc];
    if (p.bias2 != nullptr) v += p.bias2[static_cast<int64_t>(b % p.nw) * p.sq * p.sk + rc];
    return v;
  } else {
    return 0.f;
  }
}

// tiles of the head dim D: BQ query rows, BK keys; scores TR x TC a thread
// (rows rg + RG i, keys cg + CG j), output TRo x TDo (rows ro + RGo i,
// channels dg + DG j)
template <int D>
struct Cfg {
  static constexpr int BQ = 64, BK = 64, TR = 4, TC = 8, DG = 16;
};
template <>
struct Cfg<512> {
  static constexpr int BQ = 16, BK = 32, TR = 2, TC = 2, DG = 32;
};

template <int D>
constexpr int smem_floats() {
  typedef Cfg<D> C;
  return (C::BQ + 2 * C::BK) * (D + 4) + C::BQ * (C::BK + 1) + 2 * C::BQ;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows [r0, r0 + rows) of a (rows, D) tile at base + r * rs into smem (row
// stride D + 4), zeros past `limit`
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base, int64_t rs, int r0,
                                          int rows, int limit) {
  for (int i = threadIdx.x; i < rows * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const float4 v = r0 + r < limit ? load4(base + (r0 + r) * rs + c) : make_float4(0, 0, 0, 0);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = v;
  }
}

template <int D, int BIAS>
__global__ void __launch_bounds__(kThreads) attn_f32_kernel(const AttnArgs p) {
  typedef Cfg<D> C;
  constexpr int BQ = C::BQ, BK = C::BK, TR = C::TR, TC = C::TC, DG = C::DG;
  constexpr int RG = BQ / TR, CG = BK / TC;  // score patch grid: RG x CG threads
  constexpr int RGo = kThreads / DG, TRo = BQ / RGo, TDo = D / DG;
  constexpr int LD = D + 4, LDP = BK + 1;
  static_assert(RG * CG == kThreads && CG <= 32 && (CG & (CG - 1)) == 0, "score patches");
  static_assert(RGo * TRo == BQ && TDo * DG == D, "output patches");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;
  float* ps = vs + BK * LD;
  float* row_a = ps + BQ * LDP;  // per row: the rescale of this tile, then 1 / l
  float* row_l = row_a + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const float* qb = p.q + b * p.q_bs + h * p.q_hs;
  const float* kb = p.k + b * p.kv_bs + h * p.kv_hs;
  const float* vb = p.v + b * p.kv_bs + h * p.kv_hs;
  load_tile<D>(qs, qb, p.q_rs, q0, BQ, p.sq);

  const int rg = tid / CG, cg = tid % CG;
  const int ro = tid / DG, dg = tid % DG;
  float m_i[TR], l_i[TR], acc[TRo][TDo];
#pragma unroll
  for (int i = 0; i < TR; ++i) m_i[i] = kNegInf, l_i[i] = 0.f;
#pragma unroll
  for (int i = 0; i < TRo; ++i)
#pragma unroll
    for (int j = 0; j < TDo; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.sk; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are read
    load_tile<D>(ks, kb, p.kv_rs, k0, BK, p.sk);
    load_tile<D>(vs, vb, p.kv_rs, k0, BK, p.sk);
    __syncthreads();
    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[TR], kv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) qv[i] = load4(qs + (rg + RG * i) * LD + d);
#pragma unroll
      for (int j = 0; j < TC; ++j) kv[j] = load4(ks + (cg + CG * j) * LD + d);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = q0 + rg + RG * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int c = k0 + cg + CG * j;
        if (c < p.sk) {
          s[i][j] *= p.scale;
          if (r < p.sq) s[i][j] += bias_at<BIAS>(p, b, h, r, c);
        } else {
          s[i][j] = kNegInf;
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = CG / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float e = expf(s[i][j] - m_new);
        sum += e;
        ps[(rg + RG * i) * LDP + cg + CG * j] = e;
      }
#pragma unroll
      for (int off = CG / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
      if (cg == 0) row_a[rg + RG * i] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TRo; ++i) {
      const float a = row_a[ro + RGo * i];
#pragma unroll
      for (int j = 0; j < TDo; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[TRo], vv[TDo];
#pragma unroll
      for (int i = 0; i < TRo; ++i) pv[i] = ps[(ro + RGo * i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < TDo; ++j) vv[j] = vs[kk * LD + dg + DG * j];
#pragma unroll
      for (int i = 0; i < TRo; ++i)
#pragma unroll
        for (int j = 0; j < TDo; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < TR; ++i) row_l[rg + RG * i] = fmaxf(l_i[i], 1e-30f);
  }
  __syncthreads();
  float* ob = p.o + b * p.o_bs + h * p.o_hs;
#pragma unroll
  for (int i = 0; i < TRo; ++i) {
    const int r = ro + RGo * i;
    if (q0 + r >= p.sq) continue;
    const float l = row_l[r];
#pragma unroll
    for (int j = 0; j < TDo; ++j) ob[(q0 + r) * p.o_rs + dg + DG * j] = acc[i][j] / l;
  }
}

template <int D, int BIAS>
int launch_fwd(const AttnArgs& p, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      attn_f32_kernel<D, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + Cfg<D>::BQ - 1) / Cfg<D>::BQ, p.heads, p.batch);
  attn_f32_kernel<D, BIAS><<<grid, kThreads, bytes, stream>>>(p);
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
