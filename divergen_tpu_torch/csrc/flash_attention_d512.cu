// Flash attention forward at head dim 512 for Hopper (sm_90a): bf16 q, k and v
// fed by TMA, products on wgmma (bf16 in, f32 sums), a base-2 softmax in f32
// registers, bf16 or f32 out.
//
// Replaces, at d = 512, the Pallas TPU kernel
// divergen_tpu/ops/pallas/flash_attention.py:flash_attention
// (_attn_kernel_main / _attn_bias_kernel): softmax(q k^T / sqrt(d) + bias) v
// over (BH, S, 512) q, k and v with an optional dense f32 (BH, Sq, Sk) bias,
// keys past Sk masked, f32 sums, the output in q's dtype. d = 512 is the VAE
// decoder's single-head mid attention (S = 16384 at 1024^2). The same body
// takes flash_attention_packed at d = 512: q, k and v read by TMA out of a
// fused (B, N, 3C) projection, head h of slot s at channel s*C + h*512.
//
// What bounds it on the H100: operations (4 d = 2048 bf16 tensor-core FLOP
// and one ex2 a score element, so the softmax is small beside the products),
// and in practice shared memory, which feeds the tensor cores. Three things
// stand in the way at d = 512:
//   * registers: a 64-row x 512-column f32 output is 256 registers a thread
//     of one warpgroup;
//   * shared memory: a 64-row Q tile is 64 KB, each key costs 2 KB of K and
//     V, and a wgmma m64n64k16 with both operands in shared memory reads 4 KB
//     for its 32 tensor clocks, all of the 128 bytes a clock the SM's shared
//     memory delivers;
//   * L2: every block reads all of K and V (32 MB at S = 16384) for its 64 q
//     rows.
//
// Design: a persistent grid of one block an SM walks the (64-row q tile,
// head, batch) work items, q tiles fastest, so that the blocks in flight
// read the same K and V out of L2. Each block has 1 + 2 warpgroups:
//   * Producer: one thread issues every TMA load. Q (64 rows x 512
//     channels) lands as 8 chunks of 64 channels (8 KB, one 128-byte
//     swizzled row each) on one barrier. Each of the 8 chunks of a K tile
//     (64 keys) and of a V tile has a buffer of its own with its own full
//     and empty mbarriers; the producer loads them in the order the
//     consumers take them (K_t, then V_{t-1}), each as soon as the one
//     consumer that reads its buffer is done with it. setmaxnreg gives the
//     producer's registers to the consumers.
//   * Two consumer warpgroups on the same 64 q rows; consumer c owns
//     channels [256 c, 256 c + 256): 4 chunks of Q, K and V, and 128 f32
//     registers of O a thread. It computes its share of the score tile,
//     S_c = Q_c K_c^T, on wgmma m64n64k16 (Q and K from shared memory,
//     K-major; 16 k-steps), writes it to shared memory (16 KB of f32) and
//     adds the other consumer's share: S = S_0 + S_1, the same bits in both,
//     so the same softmax in both. Then the online softmax in registers, O
//     rescaled, P_t rounded to bf16 in wgmma's register-A layout, and O +=
//     P_t V_c on wgmma m64n64k16 over its 4 V chunks (V MN-major: keys
//     along the rows), each a 64-column slice of O.
//   * Order (FlashAttention-3's intra-warpgroup overlap): tile t issues
//     S_t's products, then P_{t-1} V_{t-1}'s, and exchanges and softmaxes
//     S_t while P_{t-1} V_{t-1} runs; O is rescaled and P_t packed once it
//     is done. The first and the last tile are peeled off the loop. The
//     shares' exchange waits on a named barrier for both shares, and a
//     consumer writes its next share only after the other has read this
//     one (a second barrier, arrived on after the read and waited on before
//     the next write).
//   * Kept on numbers (an H100, device time at S = 16384, in turns with the
//     variant): S split by channels, 1.18 ms against 1.27 for each consumer
//     computing the whole S tile (1.5x the products, twice the shared
//     memory reads of Q and K); one block against a 2-block cluster that
//     multicasts K and V to both blocks (1.19 against 1.21: the SM's L2
//     reads halve, the coupling of the two blocks costs more); the overlap
//     (1.13 against 1.22); the split second barrier (1.09 against 1.13).
//   * Softmax (attn_sm90.cuh, shared with flash_attention_sm90.cu): base 2,
//     log2(e) folded into the scale, the running max in raw units, the row
//     max and sum over the four lanes of a quad, the sums kept per lane
//     until the end. With a bias the scores are scaled and biased first.
//   * Tails: TMA zero-fills rows past Sq and Sk; keys past Sk in the last K
//     tile are masked to -1e30; q rows past Sq are not stored.
// The maps are 3-D (channels, rows, batch), boxes (64, 64, 1), encoded on
// every call. The output is written from registers: bf16 pairs, or f32
// pairs for a float32 caller (whose q, k, v the wrapper rounds to bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_sm90.cuh"   // the softmax, P V, tensor maps (shared with flash_attention_sm90.cu)
#include "sm90_async.cuh"  // mbarriers, TMA, named barriers, descriptors, wgmma fences

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kD = 512;                  // head dim
constexpr int kCW = 64;                  // channels of a chunk: one 128-byte swizzled row
constexpr int kChunks = kD / kCW;        // chunks of a Q, K or V tile
constexpr int kRows = 64;                // q rows of a work item
constexpr int kBK = 64;                  // keys of a K or V tile
constexpr int kConsumers = 2;            // warpgroups splitting the channels
constexpr int kOwn = kChunks / kConsumers;  // chunks of a consumer
constexpr int kChunkBytes = kBK * kCW * 2;  // 8 KB, as is a 64-row chunk of Q
constexpr int kQBytes = kRows * kD * 2;
constexpr int kPartialBytes = kRows * kBK * 4;  // one consumer's share of S, f32
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 40;        // registers a thread after setmaxnreg (a 64K file)
constexpr int kConsumerRegs = 232;
// Q, K and V tiles, the two shares of S, + slack to align
constexpr int kSmem = 3 * kQBytes + kConsumers * kPartialBytes + 1024;
constexpr int kPartialBar = 1;           // named barriers kPartialBar .. + 2: the shares' exchange
static_assert(kRows == kBK && kQBytes == kChunks * kChunkBytes,
              "one map box serves the Q and the K/V tiles");
static_assert(kSmem + (4 * kChunks + 2) * 8 <= 232448, "the buffers fit a block's shared memory");
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536, "register file");

struct Args {
  const float* bias;  // may be null: (batch, heads, sq, sk) by the strides below, key stride 1
  void* o;            // TO
  int batch, heads, sq, sk;
  int q_c0, k_c0, v_c0, head_c;  // channel of head h of each slot: c0 + h * head_c
  int64_t o_bs, o_hs, o_rs;
  int64_t bias_bs, bias_hs, bias_rs;
  float scale_log2;  // softmax scale * log2(e)
};

// S = this consumer's (c's) share + the other's, through shared memory (in
// either order: the same bits in both consumers), as float4 at
// x[q * 128 + tid]. Barrier kPartialBar: both shares are written;
// kPartialBar + 1 + c: the other consumer has read c's last share (it
// arrives after its read; not after the block's last, which nobody awaits).
__device__ __forceinline__ void exchange(float (&s)[32], float* x_own, const float* x_other,
                                         int tid, int c, bool last) {
  float4* own = reinterpret_cast<float4*>(x_own);
  const float4* other = reinterpret_cast<const float4*>(x_other);
  dg::named_sync(kPartialBar + 1 + c, 2 * 128);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    own[q * 128 + tid] = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
  dg::named_sync(kPartialBar, 2 * 128);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 x = other[q * 128 + tid];
    s[4 * q] += x.x;
    s[4 * q + 1] += x.y;
    s[4 * q + 2] += x.z;
    s[4 * q + 3] += x.w;
  }
  if (!last) dg::named_arrive(kPartialBar + 2 - c, 2 * 128);
}

template <typename TO, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
    attn_d512_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, const Args a) {
  using Softmax = dg::AttnSoftmax<BIAS, kBK>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_q, empty_q, full[2 * kChunks], empty[2 * kChunks];
  // buffers start on 1024-byte boundaries of the shared window (the swizzle's atom):
  // Q's chunks, then K's and V's (chunk c of K in buffer c, of V in kChunks + c),
  // then the consumers' partial score tiles
  unsigned char* base = smem_raw + ((1024 - (dg::smem_addr(smem_raw) & 1023)) & 1023);
  auto tile_q = [&](int c) { return base + c * kChunkBytes; };
  auto buf = [&](int c) { return base + (kChunks + c) * kChunkBytes; };
  float* const partials = reinterpret_cast<float*>(base + 3 * kChunks * kChunkBytes);

  const int q_tiles = (a.sq + kRows - 1) / kRows;
  const int n_tiles = (a.sk + kBK - 1) / kBK;
  const int items = q_tiles * a.heads * a.batch;

  if (threadIdx.x == 0) {
    dg::mbar_init(&full_q, 1);
    dg::mbar_init(&empty_q, kConsumers);
    for (int c = 0; c < 2 * kChunks; ++c) {
      dg::mbar_init(&full[c], 1);
      dg::mbar_init(&empty[c], 1);  // the one consumer that reads the chunk
    }
    dg::mbar_init_fence();
  }
  __syncthreads();

  // this block's j-th item is w = blockIdx.x + j * gridDim.x: q tile w % q_tiles
  // of head (w / q_tiles) % heads of batch w / (q_tiles * heads). Its K/V
  // tile t is the block's n-th (n counts over its items); chunk buffers and
  // their barriers are in phase n & 1. The warpgroup index comes from lane
  // 0, so that the compiler knows it is the same in every thread of a warp.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == 0) {
      int n = 0;
      for (int w = blockIdx.x, j = 0; w < items; w += gridDim.x, ++j) {
        const int h = (w / q_tiles) % a.heads;
        const int b = w / (q_tiles * a.heads);
        dg::mbar_wait(&empty_q, (j & 1) ^ 1);  // the first item's passes
        dg::mbar_arrive_expect_tx(&full_q, kQBytes);
        for (int c = 0; c < kChunks; ++c)
          dg::tma_load_3d(tile_q(c), &map_q, &full_q, a.q_c0 + h * a.head_c + c * kCW,
                          (w % q_tiles) * kRows, b);
        // in the order the consumers take them: K_t, then V_{t-1}
        for (int t = 0; t <= n_tiles; ++t)
          for (int c = t < n_tiles ? 0 : kChunks; c < (t > 0 ? 2 : 1) * kChunks; ++c) {
            const bool v = c >= kChunks;
            const int tile = v ? t - 1 : t;
            dg::mbar_wait(&empty[c], ((n + tile) & 1) ^ 1);  // the first tile's pass
            dg::mbar_arrive_expect_tx(&full[c], kChunkBytes);
            dg::tma_load_3d(buf(c), v ? &map_v : &map_k, &full[c],
                            (v ? a.v_c0 : a.k_c0) + h * a.head_c + (c % kChunks) * kCW,
                            tile * kBK, b);
          }
        n += n_tiles;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid & 31;
    float* const x_own = partials + c * kRows * kBK;
    const float* const x_other = partials + (1 - c) * kRows * kBK;
    float o[kOwn][32], s[32];
    uint32_t p[16];  // P_t: bf16 pairs, 4 for each 16-key slice
    int n = 0;
    dg::named_arrive(kPartialBar + 2 - c, 2 * 128);  // the other's first share may go
    // this consumer's share of S = Q K^T of the block's m-th tile: its 256
    // channels, 4 chunks
    auto issue_s = [&](float (&acc)[32], int m) {
#pragma unroll
      for (int jj = 0; jj < kOwn; ++jj) {
        const int ch = c * kOwn + jj;
        dg::mbar_wait(&full[ch], m & 1);
        dg::fence_regs(acc);
        dg::wgmma_fence();
        const uint64_t dq = dg::sw128_desc(tile_q(ch));
        const uint64_t dk = dg::sw128_desc(buf(ch));
#pragma unroll
        for (int kk = 0; kk < kCW / 16; ++kk) dg::wgmma_qk(acc, dq + 2 * kk, dk + 2 * kk, jj | kk);
      }
    };
    // O += P V of the block's m-th tile over this consumer's 4 chunks of V:
    // its 256 columns
    auto issue_pv = [&](float (&acc)[kOwn][32], uint32_t (&pp)[16], int m) {
      dg::fence_regs(pp);
#pragma unroll
      for (int jj = 0; jj < kOwn; ++jj) {
        const int ch = kChunks + c * kOwn + jj;
        dg::mbar_wait(&full[ch], m & 1);
        dg::fence_regs(acc[jj]);
        dg::wgmma_fence();
        const uint64_t dv = dg::sw128_desc(buf(ch));
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          dg::wgmma_pv(acc[jj], pp + 4 * kk, dv + kk * ((16 * kCW * 2) >> 4));
      }
    };
    // this consumer's chunks of K (v = 0) or V (v = 1) are free again
    auto release = [&](int v) {
      if (tid == 0)
        for (int jj = 0; jj < kOwn; ++jj) dg::mbar_arrive(&empty[v * kChunks + c * kOwn + jj]);
    };
    for (int w = blockIdx.x, j = 0; w < items; w += gridDim.x, ++j) {
      const int q0 = (w % q_tiles) * kRows;
      const int h = (w / q_tiles) % a.heads;
      const int b = w / (q_tiles * a.heads);
      Softmax sm(a, q0 + (tid >> 5) * 16 + (lane >> 2), lane & 3, b, h);
#pragma unroll
      for (int jj = 0; jj < kOwn; ++jj)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[jj][e] = 0.f;
      dg::mbar_wait(&full_q, j & 1);
      // tile t: S_t's products, then P_{t-1} V_{t-1}'s; S_t's exchange and
      // softmax run under P_{t-1} V_{t-1}. The first and the last tile are
      // peeled off the loop.
      issue_s(s, n);
      dg::wgmma_commit();
      dg::wgmma_wait<0>();
      dg::fence_regs(s);
      release(0);
      const bool last_item = w + static_cast<int>(gridDim.x) >= items;
      exchange(s, x_own, x_other, tid, c, last_item && n_tiles == 1);
      sm.scores(s, 0);
      Softmax::pack(s, p);  // O is still 0: nothing to rescale
      for (int t = 1; t < n_tiles; ++t) {
        ++n;
        issue_s(s, n);
        dg::wgmma_commit();
        issue_pv(o, p, n - 1);
        dg::wgmma_commit();
        dg::wgmma_wait<1>();  // S_t is done; P_{t-1} V_{t-1} may still run
        dg::fence_regs(s);
        release(0);
        exchange(s, x_own, x_other, tid, c, last_item && t == n_tiles - 1);
        sm.scores(s, t);
        dg::wgmma_wait<0>();
#pragma unroll
        for (int jj = 0; jj < kOwn; ++jj) dg::fence_regs(o[jj]);
        dg::fence_regs(p);
        release(1);
        sm.rescale(o);
        Softmax::pack(s, p);
      }
      issue_pv(o, p, n);
      dg::wgmma_commit();
      dg::wgmma_wait<0>();
#pragma unroll
      for (int jj = 0; jj < kOwn; ++jj) dg::fence_regs(o[jj]);
      release(1);
      ++n;
      if (tid == 0) dg::mbar_arrive(&empty_q);  // its last Q K^T is done
      sm.store(o, static_cast<TO*>(a.o) + b * a.o_bs + h * a.o_hs + c * kOwn * kCW);
    }
  }
}

template <typename TO, bool BIAS>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, const Args& a,
           int blocks, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      attn_d512_kernel<TO, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_d512_kernel<TO, BIAS><<<blocks, kThreads, kSmem, stream>>>(mq, mk, mv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q rows of a work item (ops/flash_attention.py: D512_TILE)
extern "C" int dg_flash_attention_d512_rows() { return kRows; }

// Attention at head dim 512 over bf16 q, k and v, each read as a 3-D tensor
// of (width channels, rows, batch) with element strides row_stride (the
// width) and batch_stride; head h of a slot is channels c0 + h * head_c: the
// packed (B, N, 3C) projection is q = k = v = qkv, width 3C, c0 = 0, C, 2C,
// head_c = 512, heads = H; the (BH, S, 512) layout is width 512, c0 = 0,
// head_c = 0, heads = 1, batch = BH. o (TO: bf16, or f32 with out_f32) at
// o + b * o_bs + h * o_hs + row * o_rs; bias null or f32 with key stride 1.
// At most `blocks` persistent blocks (one an SM) walk the ceil(sq / kRows) *
// heads * batch work items. Pointers and strides must suit TMA: 16-byte
// aligned, strides multiples of 8.
extern "C" int dg_flash_attention_d512(
    const void* q, const void* k, const void* v, const void* bias, void* o, int batch,
    int heads, int sq, int sk, int64_t q_width, int64_t q_bs, int64_t kv_width, int64_t kv_bs,
    int q_c0, int k_c0, int v_c0, int head_c, int64_t o_bs, int64_t o_hs, int64_t o_rs,
    int64_t bias_bs, int64_t bias_hs, int64_t bias_rs, float scale, int out_f32, int blocks,
    void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  if (!dg::attn_tensor_map(&mq, q, q_width, sq, batch, q_width, q_bs, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k == q && kv_width == q_width && kv_bs == q_bs && sk == sq) {
    mk = mq;  // the packed projection: one map serves all three slots
  } else if (!dg::attn_tensor_map(&mk, k, kv_width, sk, batch, kv_width, kv_bs, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (v == k) {
    mv = mk;
  } else if (!dg::attn_tensor_map(&mv, v, kv_width, sk, batch, kv_width, kv_bs, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t items = static_cast<int64_t>((sq + kRows - 1) / kRows) * heads * batch;
  if (items < blocks) blocks = static_cast<int>(items);  // every block has an item
  Args a{};
  a.bias = static_cast<const float*>(bias);
  a.o = o;
  a.batch = batch;
  a.heads = heads;
  a.sq = sq;
  a.sk = sk;
  a.q_c0 = q_c0;
  a.k_c0 = k_c0;
  a.v_c0 = v_c0;
  a.head_c = head_c;
  a.o_bs = o_bs;
  a.o_hs = o_hs;
  a.o_rs = o_rs;
  a.bias_bs = bias_bs;
  a.bias_hs = bias_hs;
  a.bias_rs = bias_rs;
  a.scale_log2 = scale * dg::kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias != nullptr)
    return out_f32 ? launch<float, true>(mq, mk, mv, a, blocks, s)
                   : launch<bf16, true>(mq, mk, mv, a, blocks, s);
  return out_f32 ? launch<float, false>(mq, mk, mv, a, blocks, s)
                 : launch<bf16, false>(mq, mk, mv, a, blocks, s);
}
