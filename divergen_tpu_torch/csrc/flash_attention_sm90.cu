// Flash attention forward at head dim 64 for Hopper (sm_90a): bf16 q, k and v
// fed by TMA, products on wgmma (bf16 in, f32 sums), a base-2 softmax in f32
// registers, bf16 or f32 out.
//
// Replaces, at d = 64, two Pallas TPU kernels of
// divergen_tpu/ops/pallas/flash_attention.py:
//   * flash_attention_packed (_packed_kernel / _packed_kernel2): SDXL's
//     self-attention read straight out of a fused (B, N, 3C) QKV projection
//     and written to (B, N, C) with no transposes; head h of slot s is
//     channels [s*C + h*64, s*C + (h+1)*64);
//   * flash_attention (_attn_kernel_main / _attn_bias_kernel) at d = 64:
//     (BH, S, 64) q, k and v, an optional dense f32 (BH, Sq, Sk) bias.
// Head dims 512 (the VAE) and 80 (SAM's relative-position attention) run
// flash_attention_d512.cu and flash_attention_relpos_sm90.cu.
//
// What bounds it on the H100: operations, and two kinds at once. A score
// element costs 4 d = 256 bf16 tensor-core FLOP (its share of Q K^T and
// P V) and one ex2 on the SFU; the SM does about 4096 bf16 FLOP and 16 ex2 a
// clock, so at d = 64 the exps take as long as the products. A body that
// runs them one after the other cannot come within 2x of the tensor-core
// bound. Shared memory must not set the pace either: mma.sync with 16 rows
// a warp read every K and V tile once per warp.
//
// Design (FlashAttention-3's warp specialisation, ping-pong and
// intra-warpgroup overlap): a persistent grid of one block per SM walks the
// (kBQ q rows, head, batch) work items, q tiles fastest, so that the blocks
// in flight share K and V in L2. Each block has 1 + kConsumers warpgroups.
//   * Producer: one thread issues TMA loads: each item's Q tile (kBQ rows x
//     64 channels) into one of two Q buffers, then its K and V tiles of 128
//     keys (16 KB each) through a ring of kStages stages, running ahead into
//     the next item while the consumers finish this one. mbarriers say when
//     a buffer or stage is full (TMA's byte count) and when every consumer
//     is done with it. Every tile is 128 bytes wide and lands under the
//     128-byte swizzle, the layout wgmma's descriptors read. setmaxnreg
//     gives its registers to the consumers.
//   * Three consumer warpgroups, 64 q rows each (with two, the softmax of
//     one hid less of its time under the products of the other: on an
//     H100, 0.380 against 0.341 ms at SDXL's (4, 4096, 640, 10)). Per K
//     tile t: S_t = Q K_t^T on wgmma m64n128k16 (Q and K both K-major, from
//     shared memory; 64 f32 registers a thread), the online softmax in registers,
//     and O += P_t V_t on wgmma m64n64k16 with P from registers (the f32
//     score fragment of a 16-key slice, rounded to bf16 pairs, is wgmma's
//     register-A layout) and V as an MN-major operand (the descriptor's
//     transpose bit; keys along the rows), O in 32 f32 registers a thread.
//   * The consumers take turns on the tensor cores (a ring of named
//     barriers): turn t issues S_t, then P_{t-1} V_{t-1}, as two commit
//     groups, and passes the turn on. The softmax of S_t starts as soon as
//     S_t is done, under P_{t-1} V_{t-1} and the other warpgroups'
//     products; O is rescaled and P_t written once P_{t-1} V_{t-1} is done.
//     So one warpgroup's exps run under the others' products. An item's
//     first turn (S_0 alone) and last (its last P V alone) are peeled off
//     the loop: a product issued on a path that the compiler cannot prove
//     uniform makes it serialise every product (1.45x slower).
//   * Softmax: base 2, log2(e) folded into the scale; the running max in
//     raw units (one FFMA and one ex2 an element); row max and row sum over
//     the four lanes of a quad; the sums kept per lane until the end. With
//     a bias the scores are scaled and biased first and the max runs on
//     those.
//   * Tails: TMA zero-fills rows past N; keys past N in the last K tile are
//     masked to -1e30; q rows past N are not stored.
//   * The maps are 3-D (channels, rows, batch), boxes (64, kBQ or 128, 1).
//     The packed layout maps (3C, N, B) and reads head h of slot s at
//     channel s*C + h*64; the (BH, S, 64) layout maps (64, S, BH). Encoded
//     on every call.
// The output is written from registers: bf16 pairs, or f32 pairs for a
// float32 caller (whose q, k, v the wrapper rounds to bf16 first, as the
// mma.sync body did on load).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_sm90.cuh"   // the softmax, P V, tensor maps (shared with flash_attention_d512.cu)
#include "sm90_async.cuh"  // mbarriers, TMA, named barriers, descriptors, wgmma fences

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kD = 64;          // head dim: one 128-byte swizzled row
constexpr int kRows = 64;       // q rows per consumer warpgroup
constexpr int kConsumers = 3;   // warpgroups taking turns on the tensor cores
constexpr int kBQ = kRows * kConsumers;  // q rows per work item
constexpr int kBK = 128;        // keys per tile
constexpr int kStages = 4;      // K/V ring depth
constexpr int kThreads = 128 * (1 + kConsumers);
// registers a thread after setmaxnreg: producer, consumers (a 64K file)
constexpr int kProducerRegs = kConsumers == 2 ? 40 : 24;
constexpr int kConsumerRegs = kConsumers == 2 ? 232 : 160;
constexpr int kQBytes = kBQ * kD * 2;     // one Q buffer
constexpr int kTileBytes = kBK * kD * 2;  // one K or V tile
constexpr int kSmem = 2 * kQBytes + 2 * kStages * kTileBytes + 1024;  // + slack to align
constexpr int kTurnBar = 1;     // named barriers kTurnBar + c: consumer c's turn
constexpr int kTurnThreads = 256;  // a turn's barrier: the warpgroup passing it on, the one taking it
static_assert(kQBytes % 1024 == 0, "tiles stay on the swizzle's 1024-byte atoms");
static_assert(kSmem <= 232448, "the buffers fit a block's shared memory");
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

// S (64 x 128 f32 fragment) = Q (64 rows of the descriptor dq) K^T (the
// 128-key tile at tile_k): four k-steps of 16 channels (32 bytes)
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t dq, const void* tile_k) {
  const uint64_t dk = dg::sw128_desc(tile_k);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) dg::wgmma_qk(s, dq + 2 * kk, dk + 2 * kk, kk);
}

// O += P V: eight k-steps of 16 keys (16 rows of 128 bytes of the tile at tile_v)
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[32],
                                         const void* tile_v) {
  const uint64_t dv = dg::sw128_desc(tile_v, (kBK * kD * 2) >> 4);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    dg::wgmma_pv(o, p + 4 * kk, dv + kk * ((16 * kD * 2) >> 4));
}

template <typename TO, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
    attn_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, const Args a) {
  using Softmax = dg::AttnSoftmax<BIAS, kBK>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_q[2], empty_q[2], full[kStages], empty[kStages];
  // buffers start on 1024-byte boundaries of the shared window (the swizzle's atom)
  unsigned char* base = smem_raw + ((1024 - (dg::smem_addr(smem_raw) & 1023)) & 1023);
  auto tile_q = [&](int qb) { return base + qb * kQBytes; };
  auto tile_k = [&](int st) { return base + 2 * kQBytes + 2 * st * kTileBytes; };
  auto tile_v = [&](int st) { return base + 2 * kQBytes + (2 * st + 1) * kTileBytes; };

  const int n_tiles = (a.sk + kBK - 1) / kBK;
  const int q_tiles = (a.sq + kBQ - 1) / kBQ;
  const int items = q_tiles * a.heads * a.batch;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      dg::mbar_init(&full_q[i], 1);
      dg::mbar_init(&empty_q[i], kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      dg::mbar_init(&full[s], 1);
      dg::mbar_init(&empty[s], kConsumers);  // one arrival from each consumer
    }
    dg::mbar_init_fence();
  }
  __syncthreads();

  // this block's j-th item is w = blockIdx.x + j * gridDim.x: q tile w % q_tiles
  // of head (w / q_tiles) % heads of batch w / (q_tiles * heads); it uses Q
  // buffer j % 2, and its tile t is the (j * n_tiles + t)-th use of the ring
  // the warpgroup index, taken from lane 0 so that the compiler knows it is
  // the same in every thread of a warp
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // producer: one thread issues every load; the warpgroup gives up registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int w = blockIdx.x, j = 0; w < items; w += gridDim.x, ++j) {
        const int h = (w / q_tiles) % a.heads;
        const int b = w / (q_tiles * a.heads);
        const int qb = j & 1;
        dg::mbar_wait(&empty_q[qb], ((j >> 1) & 1) ^ 1);  // each buffer's first use passes
        dg::mbar_arrive_expect_tx(&full_q[qb], kQBytes);
        dg::tma_load_3d(tile_q(qb), &map_q, &full_q[qb], a.q_c0 + h * a.head_c,
                        (w % q_tiles) * kBQ, b);
        for (int t = 0; t < n_tiles; ++t) {
          dg::mbar_wait(&empty[stage], phase ^ 1);  // the first pass over the ring passes
          dg::mbar_arrive_expect_tx(&full[stage], 2 * kTileBytes);
          dg::tma_load_3d(tile_k(stage), &map_k, &full[stage], a.k_c0 + h * a.head_c, t * kBK,
                          b);
          dg::tma_load_3d(tile_v(stage), &map_v, &full[stage], a.v_c0 + h * a.head_c, t * kBK,
                          b);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid & 31;
    const int next_bar = kTurnBar + (c + 1) % kConsumers;
    if (c == kConsumers - 1) dg::named_arrive(kTurnBar, kTurnThreads);  // consumer 0 goes first

    float o[32], s[64];
    uint32_t p[32];  // P of the previous tile: bf16 pairs, 4 for each 16-key slice
    for (int w = blockIdx.x, j = 0; w < items; w += gridDim.x, ++j) {
      const int q0 = (w % q_tiles) * kBQ;
      const int h = (w / q_tiles) % a.heads;
      const int b = w / (q_tiles * a.heads);
      const int qb = j & 1;
      // the last consumer's last turn of the block's last item is the last of all
      const bool pass_last = c != kConsumers - 1 || w + static_cast<int>(gridDim.x) < items;
      Softmax sm(a, q0 + c * kRows + (tid >> 5) * 16 + (lane >> 2), lane & 3, b, h);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      const uint64_t dq = dg::sw128_desc(tile_q(qb) + c * kRows * kD * 2);
      dg::mbar_wait(&full_q[qb], (j >> 1) & 1);

      // turn t issues S_t (t < n_tiles), then P_{t-1} V_{t-1} (t > 0); the
      // first and the last turn are peeled off the loop
      const int use0 = j * n_tiles;
      dg::mbar_wait(&full[use0 % kStages], (use0 / kStages) & 1);
      dg::named_sync(kTurnBar + c, kTurnThreads);
      dg::fence_regs(s);
      dg::wgmma_fence();
      issue_qk(s, dq, tile_k(use0 % kStages));
      dg::wgmma_commit();
      dg::named_arrive(next_bar, kTurnThreads);
      dg::wgmma_wait<0>();
      dg::fence_regs(s);
      sm.scores(s, 0);
      Softmax::pack(s, p);  // O is still 0: nothing to rescale
      for (int t = 1; t < n_tiles; ++t) {
        const int use = use0 + t;
        const int prev = (use - 1) % kStages;
        dg::mbar_wait(&full[use % kStages], (use / kStages) & 1);
        dg::named_sync(kTurnBar + c, kTurnThreads);
        dg::fence_regs(o);
        dg::fence_regs(s);
        dg::fence_regs(p);
        dg::wgmma_fence();
        issue_qk(s, dq, tile_k(use % kStages));
        dg::wgmma_commit();
        issue_pv(o, p, tile_v(prev));
        dg::wgmma_commit();
        dg::named_arrive(next_bar, kTurnThreads);
        dg::wgmma_wait<1>();  // S_t is done; P_{t-1} V_{t-1} may still run
        dg::fence_regs(s);
        sm.scores(s, t);
        dg::wgmma_wait<0>();  // P_{t-1} V_{t-1} is done: O and P are free
        dg::fence_regs(o);
        dg::fence_regs(p);
        if (tid == 0) dg::mbar_arrive(&empty[prev]);  // K and V of tile t - 1 are done
        sm.rescale(o);
        Softmax::pack(s, p);
      }
      const int last = (use0 + n_tiles - 1) % kStages;
      dg::named_sync(kTurnBar + c, kTurnThreads);
      dg::fence_regs(o);
      dg::fence_regs(p);
      dg::wgmma_fence();
      issue_pv(o, p, tile_v(last));
      dg::wgmma_commit();
      if (pass_last) dg::named_arrive(next_bar, kTurnThreads);
      dg::wgmma_wait<0>();
      dg::fence_regs(o);
      if (tid == 0) {
        dg::mbar_arrive(&empty[last]);
        dg::mbar_arrive(&empty_q[qb]);  // its last Q K^T is done
      }
      sm.store(o, static_cast<TO*>(a.o) + b * a.o_bs + h * a.o_hs);
    }
  }
}

template <typename TO, bool BIAS>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, const Args& a,
           int blocks, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      attn_sm90_kernel<TO, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_sm90_kernel<TO, BIAS><<<blocks, kThreads, kSmem, stream>>>(mq, mk, mv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q rows of a work item (ops/flash_attention.py: SM90_TILE)
extern "C" int dg_flash_attention_sm90_rows() { return kBQ; }

// Attention at head dim 64 over bf16 q, k and v, each read as a 3-D tensor of
// (width channels, rows, batch) with element strides row_stride (the width)
// and batch_stride; head h of a slot is channels c0 + h * head_c: the packed
// (B, N, 3C) projection is q = k = v = qkv, width 3C, c0 = 0, C, 2C,
// head_c = 64, heads = H; the (BH, S, 64) layout is width 64, c0 = 0,
// head_c = 0, heads = 1, batch = BH. o (TO: bf16, or f32 with out_f32) at
// o + b * o_bs + h * o_hs + row * o_rs; bias null or f32 with key stride 1.
// At most `blocks` persistent blocks (one an SM) walk the ceil(sq / kBQ) *
// heads * batch work items. Pointers and strides must suit TMA: 16-byte aligned, strides
// multiples of 8.
extern "C" int dg_flash_attention_sm90(
    const void* q, const void* k, const void* v, const void* bias, void* o, int batch,
    int heads, int sq, int sk, int64_t q_width, int64_t q_bs, int64_t kv_width, int64_t kv_bs,
    int q_c0, int k_c0, int v_c0, int head_c, int64_t o_bs, int64_t o_hs, int64_t o_rs,
    int64_t bias_bs, int64_t bias_hs, int64_t bias_rs, float scale, int out_f32, int blocks,
    void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  if (!dg::attn_tensor_map(&mq, q, q_width, sq, batch, q_width, q_bs, kBQ))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kBQ == kBK && k == q && kv_width == q_width && kv_bs == q_bs && sk == sq) {
    mk = mq;  // the packed projection: one map serves all three slots
  } else if (!dg::attn_tensor_map(&mk, k, kv_width, sk, batch, kv_width, kv_bs, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (v == k) {
    mv = mk;
  } else if (!dg::attn_tensor_map(&mv, v, kv_width, sk, batch, kv_width, kv_bs, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t items = static_cast<int64_t>((sq + kBQ - 1) / kBQ) * heads * batch;
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
