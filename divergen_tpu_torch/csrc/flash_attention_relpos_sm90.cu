// Flash attention forward with the decomposed relative-position bias of
// ViTDet and SAM, for Hopper (sm_90a): bf16 q, k and v fed by TMA, products
// on wgmma (bf16 in, f32 sums), a base-2 softmax in f32 registers, bf16 out,
// head dim 80 (SAM ViT-H's global attention).
//
// Replaces the Pallas TPU kernel flash_attention_relpos (_relpos_kernel) of
// divergen_tpu/ops/pallas/flash_attention.py: global self-attention over an
// H x W token grid, softmax(q k^T / sqrt(d) + bias) v with
// bias[q, k = (u, v)] = Bh[u, q] + Bw[v, q], given as the two f32 factors
// (BH, H, N) and (BH, W, N). The (N, N) bias never exists in memory. The TPU
// kernel computes its score tile transposed so that both bias broadcasts run
// along sublanes; that does not carry over.
//
// What bounds it on the H100: operations. A score element costs 4 d = 320
// bf16 tensor-core FLOP (about 0.078 SM clocks at 4096 FLOP a clock) and one
// ex2 (0.0625 clocks at 16 a clock); the bias add, the max and the sum fall
// on the FP32 pipe. So the exps must run under the products, as in kernel 1.
//
// Design (kernel 1's, flash_attention_sm90.cu, at d = 80): a persistent grid
// of at most one block an SM walks the (kBQ q rows, head, batch) items, q
// tiles fastest. One producer thread issues TMA loads of each item's Q tile
// into one of two buffers and of 128-key K and V tiles through a ring of
// kStages stages, on mbarriers. Two consumer warpgroups of 64 q rows each
// take turns on the tensor cores (named barriers): turn t issues S_t = Q K_t^T
// and then P_{t-1} V_{t-1}; the softmax of S_t runs under P_{t-1} V_{t-1}
// and the other warpgroup's products.
//   * d = 80 is not a 128-byte row. Every Q, K and V tile is two TMA boxes:
//     channels 0-63 under the 128-byte swizzle and channels 64-79 under the
//     32-byte swizzle, each the layout a wgmma descriptor reads. Q K^T is
//     four k-steps on the first part and one on the second (m64n128k16);
//     P V is an n = 64 and an n = 16 product on the two parts of V
//     (MN-major), so O is 32 + 8 f32 registers a thread. Nothing is padded.
//   * The bias starts the accumulator: S is set to (Bh + Bw) sqrt(d) before
//     Q K^T accumulates onto it, so the raw scores carry it and the softmax
//     runs on them as on unbiased ones (max in raw units, one FFMA and one
//     ex2 an element). Slots that hold no key start at -1e30, which masks
//     them.
//     - Register path (W <= 64; SAM at 1024² has W = 64): a K tile is G =
//       128 / W' whole grid rows of W' slots, W' = W rounded up to 8, 16, 32
//       or 64: K and V are read through a map that splits the keys into H
//       grid rows of W, TMA zero-fills the slots past W and the bias masks
//       them (attention does not depend on the order of the keys; at W = W'
//       the slots are 128 consecutive keys, and the 64 x 2-row boxes took as
//       long as one run of 128 rows). The 32 slots a thread holds meet the
//       same grid columns v in every tile: Bw sqrt(d)
//       of its two q rows stays in registers for the whole item (32 at
//       W = 64), and a tile needs Bh of G grid rows for each row, loaded a
//       tile ahead (4 loads a thread a tile at W = 64).
//     - General path (W > 64): slot s of tile t is key t 128 + s; each key's
//       (u, v) is found from its index and both factors are read through L1
//       for every element. No factor is staged in shared memory, so the body
//       takes any H, W >= 1: the slabs of an item's q rows for every grid the
//       mma.sync body took (H + W <= 647) would not fit beside the Q buffers
//       and the ring.
//   * Registers: three consumers at 160 registers a thread cannot hold S
//     (64), O (40), P (32) and Bw (32) at 128-key tiles; two at 232 can.
//     Three consumers on 64-key tiles (8 stages) were slower at SAM's shape,
//     and two on 64-key tiles slower still.
//   * Tails: TMA zero-fills rows past N; q rows past N are not stored.
//   * q, k and v are read through rank-5 maps of (80 channels, v, u, heads,
//     batch) at the wrapper's strides (q and the general path's k and v
//     with one run of N rows), the last four ordered by stride (a fused
//     projection's heads lie inside its rows). Encoded on every call.
// The output is written from registers as bf16 pairs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_sm90.cuh"   // wgmma Q K^T and P V, the softmax, dg::ex2
#include "sm90_async.cuh"  // mbarriers, TMA, named barriers, descriptors, wgmma fences

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kD = 80;   // head dim
constexpr int kDA = 64;  // channels 0-63: 128-byte rows, 128-byte swizzle
constexpr int kDB = 16;  // channels 64-79: 32-byte rows, 32-byte swizzle
constexpr int kRows = 64;       // q rows per consumer warpgroup
constexpr int kConsumers = 2;   // warpgroups taking turns on the tensor cores
constexpr int kBQ = kRows * kConsumers;  // q rows per work item
constexpr int kBK = 128;        // keys per tile
constexpr int kStages = 4;      // K/V ring depth
constexpr int kThreads = 128 * (1 + kConsumers);
// registers a thread after setmaxnreg: producer, consumers (a 64K file)
constexpr int kProducerRegs = kConsumers == 2 ? 40 : 24;
constexpr int kConsumerRegs = kConsumers == 2 ? 232 : 160;
constexpr int kQPartA = kBQ * kDA * 2;  // bytes of the two parts of a Q buffer
constexpr int kQBytes = kQPartA + kBQ * kDB * 2;
constexpr int kTilePartA = kBK * kDA * 2;  // ... of a K or V tile
constexpr int kTilePartB = kBK * kDB * 2;
constexpr int kTileBytes = kTilePartA + kTilePartB;
constexpr int kSmem = 2 * kQBytes + 2 * kStages * kTileBytes + 1024;  // + slack to align
constexpr int kTurnBar = 1;        // named barriers kTurnBar + c: consumer c's turn
constexpr int kTurnThreads = 256;  // the warpgroup passing a turn on and the one taking it
static_assert(kQPartA % 1024 == 0 && kQBytes % 1024 == 0 && kTileBytes % 1024 == 0,
              "parts stay on the 128-byte swizzle's 1024-byte atoms");
static_assert(kSmem <= 232448, "the buffers fit a block's shared memory");
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536, "register file");

struct Args {
  const float* bh;  // (batch * heads, grid_h, n) f32
  const float* bw;  // (batch * heads, grid_w, n) f32
  bf16* o;
  int batch, heads, n, grid_h, grid_w;
  // the map dimensions of (v, u, head, batch) of q's and of k's and v's maps
  int q_at[4], kv_at[4];
  int64_t o_bs, o_hs, o_rs;
  float scale_log2;  // softmax scale * log2(e)
  float sqrt_d;      // the factors' multiplier: raw scores carry the bias times sqrt(d)
};

// the box at channel c0 of the given (v, u, head, batch), at the map
// dimensions `at` gives them
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                        const int (&at)[4], int v, int u, int h, int b) {
  auto coord = [&](int dim) { return at[0] == dim ? v : at[1] == dim ? u : at[2] == dim ? h : b; };
  dg::tma_load_5d(dst, map, bar, c0, coord(1), coord(2), coord(3), coord(4));
}

// S (64 x kBK, started from the bias) += Q K^T: four k-steps of 16 channels
// on the 128-byte part, one on the 32-byte part
__device__ __forceinline__ void issue_qk(float (&s)[kBK / 2], uint64_t dqa, uint64_t dqb,
                                         const unsigned char* tile_k) {
  const uint64_t dka = dg::sw128_desc(tile_k);
  const uint64_t dkb = dg::sw32_desc(tile_k + kTilePartA);
#pragma unroll
  for (int kk = 0; kk < kDA / 16; ++kk) dg::wgmma_qk(s, dqa + 2 * kk, dka + 2 * kk, 1);
  dg::wgmma_qk(s, dqb, dkb, 1);
}

// O += P V: kBK / 16 k-steps of 16 keys, each an n = 64 product on channels
// 0-63 (16 rows of 128 bytes) and an n = 16 one on 64-79 (16 rows of 32)
__device__ __forceinline__ void issue_pv(float (&o)[32], float (&o2)[8],
                                         const uint32_t (&p)[kBK / 4],
                                         const unsigned char* tile_v) {
  const uint64_t dva = dg::sw128_desc(tile_v, kTilePartA >> 4);
  const uint64_t dvb = dg::sw32_desc(tile_v + kTilePartA, kTilePartB >> 4);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    dg::wgmma_pv(o, p + 4 * kk, dva + kk * ((16 * kDA * 2) >> 4));
    dg::wgmma_pv16(o2, p + 4 * kk, dvb + kk * ((16 * kDB * 2) >> 4));
  }
}

// The bias a consumer thread starts S_t from, times sqrt(d): element
// s[4 j + 2 r + x] is row `row` + 8 r and slot 8 j + 2 t4 + x of K tile t
// (the wgmma fragment); -1e30 for a slot that holds no key, 0 for rows past n.
// M > 0: the register path, for W <= 64. A K tile's slots are G = kBK / W'
// whole grid rows of W' = 8 M slots (W' = W rounded up to 8, 16, 32 or 64;
// TMA zero-fills slots v >= W), so slot 8 j + 2 t4 + x of every tile is grid
// column v = 8 (j mod M) + 2 t4 + x of grid row t G + j / M: Bw of its M
// column groups stays in registers for the item (with PAD, W < W': -1e30 at
// v >= W), Bh of the tile's grid rows is loaded a tile ahead (-1e30 past H).
// M = 0: the general path (W > 64), where slot s of tile t is key t kBK + s.
// PAD is a template flag because the select it adds at v >= W, run once an
// item, slowed the main shape (W = W' = 64) by 6 %, and an additive mask by
// 42 % (NVIDIA H100 80GB HBM3, 700 W; tools/attention_ab.py --relpos).
template <int M, bool PAD>
struct RelposBias {
  static constexpr int kGridRows = M > 0 ? kBK / 8 / M : 1;  // G
  const float* fh;  // Bh of this (batch, head): Bh[u, q] at fh[u n + q]
  const float* fw;
  const int n, grid_h, grid_w, row, t4;
  const bool ok[2];  // rows row and row + 8 are inside the grid
  const float sqrt_d;
  float bw[M > 0 ? 4 * M : 1];  // Bw sqrt(d) of column group j < M, as s[4 j + 2 r + x]
  float bh[2][kGridRows];       // Bh sqrt(d) of the tile's grid rows: [r][u - t G]

  __device__ __forceinline__ RelposBias(const Args& a, int b, int h, int row_, int t)
      : fh(a.bh + (static_cast<int64_t>(b) * a.heads + h) * a.grid_h * a.n),
        fw(a.bw + (static_cast<int64_t>(b) * a.heads + h) * a.grid_w * a.n),
        n(a.n), grid_h(a.grid_h), grid_w(a.grid_w), row(row_), t4(t),
        ok{row_ < a.n, row_ + 8 < a.n}, sqrt_d(a.sqrt_d) {}

  __device__ __forceinline__ float factor(const float* f, int idx, int r) const {
    return ok[r] ? f[static_cast<int64_t>(idx) * n + row + 8 * r] * sqrt_d : 0.f;
  }

  // register path: Bw for the item, Bh for tile 0
  __device__ __forceinline__ void load_item() {
#pragma unroll
    for (int j = 0; j < M; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = 8 * j + 2 * t4 + (e & 1);
        if constexpr (PAD) {
          bw[4 * j + e] = v < grid_w ? factor(fw, v, e >> 1) : dg::kAttnNegInf;
        } else {
          bw[4 * j + e] = factor(fw, v, e >> 1);
        }
      }
    load_rows(0);
  }

  // register path: Bh of the grid rows of tile t, -1e30 past the grid
  __device__ __forceinline__ void load_rows(int t) {
#pragma unroll
    for (int x = 0; x < kGridRows; ++x) {
      const int u = kGridRows * t + x;
#pragma unroll
      for (int r = 0; r < 2; ++r) bh[r][x] = u < grid_h ? factor(fh, u, r) : dg::kAttnNegInf;
    }
  }

  // S_t's start; the register path then loads the next tile's Bh
  __device__ __forceinline__ void start(float (&s)[kBK / 2], int t) {
    if constexpr (M > 0) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 * j + e] = bh[e >> 1][j / M] + bw[4 * (j % M) + e];
      load_rows(t + 1);
    } else {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const int key = t * kBK + 8 * j + 2 * t4;
        int u = key / grid_w;
        int v = key - u * grid_w;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          if (x == 1 && ++v == grid_w) v = 0, ++u;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            s[4 * j + 2 * r + x] =
                key + x < n ? factor(fh, u, r) + factor(fw, v, r) : dg::kAttnNegInf;
        }
      }
    }
  }
};

// M: the register path's W' / 8, or 0 for the general path; PAD: W < W'
// (RelposBias)
template <int M, bool PAD>
__global__ void __launch_bounds__(kThreads, 1)
    relpos_sm90_kernel(const __grid_constant__ CUtensorMap map_qa,
                       const __grid_constant__ CUtensorMap map_qb,
                       const __grid_constant__ CUtensorMap map_ka,
                       const __grid_constant__ CUtensorMap map_kb,
                       const __grid_constant__ CUtensorMap map_va,
                       const __grid_constant__ CUtensorMap map_vb, const Args a) {
  using Softmax = dg::AttnSoftmax<false, kBK>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_q[2], empty_q[2], full[kStages], empty[kStages];
  // buffers start on 1024-byte boundaries of the shared window (the swizzle's atom)
  unsigned char* base = smem_raw + ((1024 - (dg::smem_addr(smem_raw) & 1023)) & 1023);
  auto tile_q = [&](int qb) { return base + qb * kQBytes; };
  auto tile_k = [&](int st) { return base + 2 * kQBytes + 2 * st * kTileBytes; };
  auto tile_v = [&](int st) { return base + 2 * kQBytes + (2 * st + 1) * kTileBytes; };

  // K tiles: of G grid rows on the register path, of kBK keys on the general one
  constexpr int kGridRows = RelposBias<M, PAD>::kGridRows;
  const int n_tiles = M > 0 ? (a.grid_h + kGridRows - 1) / kGridRows : (a.n + kBK - 1) / kBK;
  const int q_tiles = (a.n + kBQ - 1) / kBQ;
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
  // buffer j % 2, and its tile t is the (j * n_tiles + t)-th use of the ring.
  // The warpgroup index comes from lane 0, so that the compiler knows it is
  // the same in every thread of a warp.
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
        const int q0 = (w % q_tiles) * kBQ;
        tma_box(tile_q(qb), &map_qa, &full_q[qb], 0, a.q_at, q0, 0, h, b);
        tma_box(tile_q(qb) + kQPartA, &map_qb, &full_q[qb], kDA, a.q_at, q0, 0, h, b);
        for (int t = 0; t < n_tiles; ++t) {
          dg::mbar_wait(&empty[stage], phase ^ 1);  // the first pass over the ring passes
          dg::mbar_arrive_expect_tx(&full[stage], 2 * kTileBytes);
          unsigned char* tk = tile_k(stage);
          unsigned char* tv = tile_v(stage);
          const int v0 = M > 0 ? 0 : t * kBK, u0 = M > 0 ? t * kGridRows : 0;
          tma_box(tk, &map_ka, &full[stage], 0, a.kv_at, v0, u0, h, b);
          tma_box(tk + kTilePartA, &map_kb, &full[stage], kDA, a.kv_at, v0, u0, h, b);
          tma_box(tv, &map_va, &full[stage], 0, a.kv_at, v0, u0, h, b);
          tma_box(tv + kTilePartA, &map_vb, &full[stage], kDA, a.kv_at, v0, u0, h, b);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid & 31;
    const int t4 = lane & 3;
    const int next_bar = kTurnBar + (c + 1) % kConsumers;
    if (c == kConsumers - 1) dg::named_arrive(kTurnBar, kTurnThreads);  // consumer 0 goes first

    float o[32], o2[8], s[kBK / 2];
    uint32_t p[kBK / 4];  // P of the previous tile: bf16 pairs, 4 for each 16-key slice
    for (int w = blockIdx.x, j = 0; w < items; w += gridDim.x, ++j) {
      const int q0 = (w % q_tiles) * kBQ;
      const int h = (w / q_tiles) % a.heads;
      const int b = w / (q_tiles * a.heads);
      const int qb = j & 1;
      // the last consumer's last turn of the block's last item is the last of all
      const bool pass_last = c != kConsumers - 1 || w + static_cast<int>(gridDim.x) < items;
      const int row = q0 + c * kRows + (tid >> 5) * 16 + (lane >> 2);
      // the keys the softmax masks by index: none on the register path, whose
      // start masks its empty slots
      Softmax sm(row, t4, a.n, M > 0 ? n_tiles * kBK : a.n, a.o_rs, a.scale_log2);
      RelposBias<M, PAD> bias(a, b, h, row, t4);
      if constexpr (M > 0) bias.load_item();
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) o2[i] = 0.f;
      const uint64_t dqa = dg::sw128_desc(tile_q(qb) + c * kRows * kDA * 2);
      const uint64_t dqb = dg::sw32_desc(tile_q(qb) + kQPartA + c * kRows * kDB * 2);

      // turn t issues S_t (t < n_tiles), then P_{t-1} V_{t-1} (t > 0); the
      // first and the last turn are peeled off the loop
      const int use0 = j * n_tiles;
      bias.start(s, 0);
      dg::mbar_wait(&full_q[qb], (j >> 1) & 1);
      dg::mbar_wait(&full[use0 % kStages], (use0 / kStages) & 1);
      dg::named_sync(kTurnBar + c, kTurnThreads);
      dg::fence_regs(s);
      dg::wgmma_fence();
      issue_qk(s, dqa, dqb, tile_k(use0 % kStages));
      dg::wgmma_commit();
      dg::named_arrive(next_bar, kTurnThreads);
      dg::wgmma_wait<0>();
      dg::fence_regs(s);
      sm.scores(s, 0);
      Softmax::pack(s, p);  // O is still 0: nothing to rescale
      for (int t = 1; t < n_tiles; ++t) {
        const int use = use0 + t;
        const int prev = (use - 1) % kStages;
        bias.start(s, t);
        dg::mbar_wait(&full[use % kStages], (use / kStages) & 1);
        dg::named_sync(kTurnBar + c, kTurnThreads);
        dg::fence_regs(o);
        dg::fence_regs(o2);
        dg::fence_regs(s);
        dg::fence_regs(p);
        dg::wgmma_fence();
        issue_qk(s, dqa, dqb, tile_k(use % kStages));
        dg::wgmma_commit();
        issue_pv(o, o2, p, tile_v(prev));
        dg::wgmma_commit();
        dg::named_arrive(next_bar, kTurnThreads);
        dg::wgmma_wait<1>();  // S_t is done; P_{t-1} V_{t-1} may still run
        dg::fence_regs(s);
        sm.scores(s, t);
        dg::wgmma_wait<0>();  // P_{t-1} V_{t-1} is done: O and P are free
        dg::fence_regs(o);
        dg::fence_regs(o2);
        dg::fence_regs(p);
        if (tid == 0) dg::mbar_arrive(&empty[prev]);  // K and V of tile t - 1 are done
        sm.rescale(o);
#pragma unroll
        for (int i = 0; i < 8; ++i) o2[i] *= sm.alpha[(i >> 1) & 1];
        Softmax::pack(s, p);
      }
      const int last = (use0 + n_tiles - 1) % kStages;
      dg::named_sync(kTurnBar + c, kTurnThreads);
      dg::fence_regs(o);
      dg::fence_regs(o2);
      dg::fence_regs(p);
      dg::wgmma_fence();
      issue_pv(o, o2, p, tile_v(last));
      dg::wgmma_commit();
      if (pass_last) dg::named_arrive(next_bar, kTurnThreads);
      dg::wgmma_wait<0>();
      dg::fence_regs(o);
      dg::fence_regs(o2);
      if (tid == 0) {
        dg::mbar_arrive(&empty[last]);
        dg::mbar_arrive(&empty_q[qb]);  // its last Q K^T is done
      }
      // O / l to rows row and row + 8: channels 0-63 from o, 64-79 from o2
      bf16* out = a.o + b * a.o_bs + h * a.o_hs;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = sm.l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / fmaxf(l, 1e-30f);
        const int qi = row + 8 * r;
        if (qi >= a.n) continue;
        bf16* dst = out + qi * a.o_rs + 2 * t4;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          dg::store_pair(dst + 8 * jj, o[4 * jj + 2 * r] * inv, o[4 * jj + 2 * r + 1] * inv);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          dg::store_pair(dst + kDA + 8 * jj, o2[4 * jj + 2 * r] * inv,
                         o2[4 * jj + 2 * r + 1] * inv);
      }
    }
  }
}

// A rank-5 bf16 map over (80 channels, v, u, heads, batch): the rows split
// into ext_u runs of ext_v (u at stride ext_v rs), heads at hs and batch at
// bs (element strides), read in boxes of (box_c channels, box_v, box_u) under
// the given swizzle, zeros past its edges (a box may be wider than the grid).
// Dimensions 1-4 go in order of stride, those of extent 1 and box 1 last
// with the stride of a packed tensor (a head stride may be 0); `at` says
// which map dimension v, u, the head and the batch became. A box lands in
// shared memory in the order of the map's dimensions, so the slots of a K
// tile are u-major only because u's stride is W times v's. False if the
// encoder refuses it.
bool relpos_map(CUtensorMap* map, int (&at)[4], const void* ptr, int ext_v, int ext_u, int heads,
                int batch, int64_t rs, int64_t hs, int64_t bs, int box_c, int box_v, int box_u,
                CUtensorMapSwizzle swizzle) {
  const dg::EncodeTiledFn encode = dg::encode_tiled();
  if (encode == nullptr) return false;
  const int64_t ext[4] = {ext_v, ext_u, heads, batch};
  const int64_t str[4] = {rs, rs * ext_v, hs, bs};
  const int64_t boxes[4] = {box_v, box_u, 1, 1};
  auto last = [&](int x) { return ext[x] == 1 && boxes[x] == 1; };
  auto before = [&](int x, int y) {  // x goes before y
    return last(x) != last(y) ? last(y) : str[x] < str[y];
  };
  int order[4] = {0, 1, 2, 3};
  for (int i = 1; i < 4; ++i)
    for (int j = i; j > 0 && before(order[j], order[j - 1]); --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  cuuint64_t dims[5] = {kD, 1, 1, 1, 1};
  cuuint64_t strides[4];
  cuuint32_t box[5] = {static_cast<cuuint32_t>(box_c), 1, 1, 1, 1};
  const cuuint32_t steps[5] = {1, 1, 1, 1, 1};
  uint64_t packed = kD * sizeof(bf16);  // the stride a dimension of extent 1 takes
  for (int i = 0; i < 4; ++i) {
    const int o = order[i];
    dims[i + 1] = static_cast<cuuint64_t>(ext[o]);
    strides[i] = last(o) ? packed : static_cast<cuuint64_t>(str[o]) * sizeof(bf16);  // bytes
    packed = strides[i] * ext[o];
    box[i + 1] = static_cast<cuuint32_t>(boxes[o]);
    at[o] = i + 1;
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int M, bool PAD>
int launch(const CUtensorMap (&m)[6], const Args& a, int blocks, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      relpos_sm90_kernel<M, PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  relpos_sm90_kernel<M, PAD><<<blocks, kThreads, kSmem, stream>>>(m[0], m[1], m[2], m[3], m[4],
                                                                  m[5], a);
  return static_cast<int>(cudaGetLastError());
}

// the register path of W' = 8 M slots a grid row, padded or not
template <int M>
int launch_reg(bool pad, const CUtensorMap (&m)[6], const Args& a, int blocks,
               cudaStream_t stream) {
  return pad ? launch<M, true>(m, a, blocks, stream) : launch<M, false>(m, a, blocks, stream);
}

}  // namespace

// q rows of a work item and the dynamic shared memory of a block
// (ops/flash_attention.py: RELPOS_TILE, relpos_smem)
extern "C" int dg_flash_attention_relpos_rows() { return kBQ; }
extern "C" int dg_flash_attention_relpos_smem() { return kSmem; }

// Self-attention over a grid_h x grid_w token grid (n = grid_h * grid_w rows)
// with the decomposed relative-position bias; bias_h (batch*heads, grid_h, n)
// and bias_w (batch*heads, grid_w, n) are contiguous f32. q, k, v and o are
// bf16 at base + b * bs + h * hs + row * rs (element strides; k and v share
// theirs), channels contiguous; pointers 16-byte aligned, strides multiples
// of 8. At most one block an SM (of the current device) walks the
// ceil(n / kBQ) * heads * batch work items.
extern "C" int dg_flash_attention_relpos_bf16(
    const void* q, const void* k, const void* v, const void* bias_h,
    const void* bias_w, void* o, int batch, int heads, int grid_h, int grid_w,
    int d, int64_t q_bs, int64_t q_hs, int64_t q_rs, int64_t kv_bs,
    int64_t kv_hs, int64_t kv_rs, int64_t o_bs, int64_t o_hs, int64_t o_rs,
    float scale, void* stream) {
  const int64_t n64 = static_cast<int64_t>(grid_h) * grid_w;
  if (d != kD || batch < 1 || heads < 1 || grid_h < 1 || grid_w < 1 || n64 >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(n64);
  // the register path's slots a grid row (W' = W rounded up to 8, 16, 32 or
  // 64), or 0 for the general path
  int slot_w = 0;
  for (int w = 8; w <= 64 && slot_w == 0; w *= 2)
    if (grid_w <= w) slot_w = w;
  Args a{};
  CUtensorMap m[6];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const bool is_q = i == 0;
    int(&at)[4] = is_q ? a.q_at : a.kv_at;
    const int64_t bs = is_q ? q_bs : kv_bs, hs = is_q ? q_hs : kv_hs, rs = is_q ? q_rs : kv_rs;
    // q: kBQ rows; k, v: G grid rows of W' slots, or kBK rows
    const bool grid = !is_q && slot_w > 0;
    const int ext_v = grid ? grid_w : n, ext_u = grid ? grid_h : 1;
    const int box_v = is_q ? kBQ : grid ? slot_w : kBK, box_u = grid ? kBK / slot_w : 1;
    if (!relpos_map(&m[2 * i], at, ptrs[i], ext_v, ext_u, heads, batch, rs, hs, bs, kDA, box_v,
                    box_u, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !relpos_map(&m[2 * i + 1], at, ptrs[i], ext_v, ext_u, heads, batch, rs, hs, bs, kDB,
                    box_v, box_u, CU_TENSOR_MAP_SWIZZLE_32B))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t items = static_cast<int64_t>((n + kBQ - 1) / kBQ) * heads * batch;
  if (items >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(items < sms ? items : sms);
  a.bh = static_cast<const float*>(bias_h);
  a.bw = static_cast<const float*>(bias_w);
  a.o = static_cast<bf16*>(o);
  a.batch = batch;
  a.heads = heads;
  a.n = n;
  a.grid_h = grid_h;
  a.grid_w = grid_w;
  a.o_bs = o_bs;
  a.o_hs = o_hs;
  a.o_rs = o_rs;
  a.scale_log2 = scale * dg::kLog2e;
  a.sqrt_d = 1.f / scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (slot_w) {
    case 64: return launch_reg<8>(slot_w > grid_w, m, a, blocks, s);
    case 32: return launch_reg<4>(slot_w > grid_w, m, a, blocks, s);
    case 16: return launch_reg<2>(slot_w > grid_w, m, a, blocks, s);
    case 8: return launch_reg<1>(slot_w > grid_w, m, a, blocks, s);
    default: return launch<0, false>(m, a, blocks, s);
  }
}
