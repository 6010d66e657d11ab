// What the wgmma + TMA attention bodies share (flash_attention_sm90.cu at
// head dim 64, flash_attention_d512.cu at head dim 512,
// flash_attention_relpos_sm90.cu at head dim 80): the base-2 exp, the
// Q K^T products on wgmma m64n128k16 and m64n64k16, the P V products on
// wgmma m64n64k16 and m64n16k16 with P from registers, the online softmax of
// a consumer warpgroup's 64 q rows over K tiles of BK keys, and, on the
// host, the 3-D tensor maps of q, k and v.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "gn_moments.cuh"  // dg::store_pair
#include "mma_sm90.cuh"    // dg::pack_bf16x2
#include "sm90_async.cuh"  // dg::encode_tiled

namespace dg {

constexpr float kAttnNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define DG_F8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128 f32) = [d +] A (64 x 16 bf16, K-major, descriptor a) B^T, B
// (128 x 16 bf16, K-major, descriptor b); scale_d = 0 overwrites d.
// Fragment of d: thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4
// + {0, 8}, columns 8 j + 2 (t % 4) + {0, 1}, as d[4 j + {0, 1}] (row + 0),
// d[4 j + {2, 3}] (row + 8).
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : DG_F8(0), DG_F8(8), DG_F8(16), DG_F8(24), DG_F8(32), DG_F8(40), DG_F8(48), DG_F8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// The same with n = 64 (B 64 x 16): d 32 registers
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DG_F8(0), DG_F8(8), DG_F8(16), DG_F8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef DG_F8

// d (64 x 64 f32) += A (64 x 16 bf16 from registers) B, B (16 x 64 bf16,
// MN-major: N contiguous, descriptor b). A fragment, per warp of 16 rows
// (g = lane / 4, t = lane % 4): a[0] (row g, k 2t..2t+1), a[1] (row g + 8,
// k 2t..), a[2] (row g, k 2t+8..), a[3] (row g + 8, k 2t+8..), low half
// the lower k. Fragment of d: thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 + {0, 8}, columns 8 j + 2 (t % 4) + {0, 1}, as
// d[4 j + {0, 1}] (row + 0), d[4 j + {2, 3}] (row + 8).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 16 f32) += A (64 x 16 bf16 from registers) B, B (16 x 16 bf16,
// MN-major, descriptor b): the fragments of wgmma_pv with j < 2
__device__ __forceinline__ void wgmma_pv16(float (&d)[8], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The online softmax of one thread's two rows (row0 and row0 + 8; the four
// lanes of a quad share them) over K tiles of BK keys, the score tile in the
// wgmma fragment above (BK / 2 registers): base 2, the running max in raw
// units (biased scores are scaled first), the sums kept per lane. O is kept
// as 64-column chunks of that fragment, 32 registers each.
template <bool BIAS, int BK>
struct AttnSoftmax {
  const int row0, t4, sq, sk;
  const float* bias;  // this (batch, head)'s rows, BIAS only
  const int64_t bias_rs, o_rs;
  const float scale_log2;
  const float mult;  // raw scores are scaled inside the exponent, biased ones before
  float m_run[2] = {kAttnNegInf, kAttnNegInf}, l_run[2] = {0.f, 0.f}, alpha[2] = {0.f, 0.f};

  // a: the kernel's arguments (sq, sk, bias and its strides, o_rs, scale_log2)
  template <typename Args>
  __device__ __forceinline__ AttnSoftmax(const Args& a, int row, int t, int b, int h)
      : row0(row), t4(t), sq(a.sq), sk(a.sk),
        bias(BIAS ? a.bias + b * a.bias_bs + h * a.bias_hs : nullptr), bias_rs(a.bias_rs),
        o_rs(a.o_rs), scale_log2(a.scale_log2), mult(BIAS ? 1.f : a.scale_log2) {}

  // without a bias of its own (a caller that starts S from its bias): sq and
  // sk, the output's row stride, the softmax scale times log2(e)
  __device__ __forceinline__ AttnSoftmax(int row, int t, int sq_, int sk_, int64_t o_rs_,
                                         float scale_log2_)
      : row0(row), t4(t), sq(sq_), sk(sk_), bias(nullptr), bias_rs(0), o_rs(o_rs_),
        scale_log2(scale_log2_), mult(scale_log2_) {
    static_assert(!BIAS, "a bias policy reads its bias through the kernel's arguments");
  }

  // S_t -> exp2 of its scores less the new running max, in place; alpha and
  // the row sums updated
  __device__ __forceinline__ void scores(float (&s)[BK / 2], int t) {
    const int k0 = t * BK;
    if (BIAS || k0 + BK > sk) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * t4 + (e & 1);
          const int qi = row0 + (e >> 1) * 8;
          float x = s[4 * j + e];
          if (key >= sk) {
            x = kAttnNegInf;
          } else if (BIAS) {
            x *= scale_log2;
            if (qi < sq) x += bias[qi * bias_rs + key] * kLog2e;
          }
          s[4 * j + e] = x;
        }
    }
    float mx[2] = {kAttnNegInf, kAttnNegInf};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = ex2((m_run[r] - m_new) * mult);
      m_run[r] = m_new;
      neg_m[r] = -m_new * mult;
    }
    float rs[2] = {0.f, 0.f};  // this lane's share of the row sums
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(fmaf(s[4 * j + e], mult, neg_m[e >> 1]));
        s[4 * j + e] = pe;
        rs[e >> 1] += pe;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
  }

  // O *= alpha
  template <int N>
  __device__ __forceinline__ void rescale(float (&o)[N][32]) const {
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[n][4 * j] *= alpha[0];
        o[n][4 * j + 1] *= alpha[0];
        o[n][4 * j + 2] *= alpha[1];
        o[n][4 * j + 3] *= alpha[1];
      }
  }
  __device__ __forceinline__ void rescale(float (&o)[32]) const {
    rescale(reinterpret_cast<float (&)[1][32]>(o));
  }

  // P_t (bf16 pairs) as the A fragments of P V: slice kk is score columns
  // 16 kk .. 16 kk + 15, i.e. fragments 2 kk and 2 kk + 1
  __device__ __forceinline__ static void pack(const float (&s)[BK / 2], uint32_t (&p)[BK / 4]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      p[4 * kk] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
      p[4 * kk + 1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
      p[4 * kk + 2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
      p[4 * kk + 3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
    }
  }

  // O / l to rows row0 and row0 + 8 of out (row stride o_rs), chunk n at
  // column 64 n; rows past sq skipped
  template <typename TO, int N>
  __device__ __forceinline__ void store(const float (&o)[N][32], TO* out) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int qi = row0 + 8 * r;
      if (qi >= sq) continue;
      TO* dst = out + qi * o_rs + 2 * t4;
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          store_pair(dst + 64 * n + 8 * j, o[n][4 * j + 2 * r] * inv,
                     o[n][4 * j + 2 * r + 1] * inv);
    }
  }
  template <typename TO>
  __device__ __forceinline__ void store(const float (&o)[32], TO* out) const {
    store(reinterpret_cast<const float (&)[1][32]>(o), out);
  }
};

// A 3-D bf16 map over (width channels, rows, batch) with the given element
// strides of a row and of a batch, read in boxes of (64, box_rows, 1) under
// the 128-byte swizzle, zeros past its edges; false if the encoder refuses it
inline bool attn_tensor_map(CUtensorMap* map, const void* ptr, int64_t width, int64_t rows,
                            int64_t batch, int64_t row_stride, int64_t batch_stride,
                            int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride) * 2,
                                 static_cast<cuuint64_t>(batch_stride) * 2};  // bytes
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace dg
