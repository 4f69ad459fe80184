// bf16 tensor-core products for NVIDIA Hopper (sm_90a): `mma.sync` m16n8k16
// fragments loaded with `ldmatrix`, shared by the bf16 flash-attention
// kernels of this directory: the forward (flash_attention_bf16.cu), dQ and
// dK/dV (flash_attention_bwd_bf16.cu).
//
// What the bf16 kernels compute is what the TPU kernels compute for bf16
// inputs: every input is exact in float32, every product and sum is
// float32, and only the outputs are rounded to bf16. A bf16 x bf16 product
// is exact in float32, so a product of two bf16 operands (Q K^T, dO V^T,
// K Q^T, V dO^T) runs as one bf16 `mma.sync` with a float32 accumulator.
// A float32 operand computed in the kernel (P, dS and their transposes)
// is split into three bf16 parts, hi = bf16(x), mid = bf16(x - hi) and
// lo = bf16(x - hi - mid) (each difference exact in float32), which hold
// all of its 24 significand bits (|x - hi - mid - lo| <= 2^-24 |x|), and
// goes through three products. Fewer parts are not float32-accurate: one
// (2^-8) moves about a third of the bf16 outputs by an ulp, and two
// (2^-16) leave a few outputs where the sum cancels more than an ulp from
// the float32 result (tests/test_torch_bf16.py emulates all three).
//
// Fragments of `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` (PTX
// ISA; the layouts of CUTLASS's SM80_16x8x16_F32BF16BF16F32_TN), with
// g = lane / 4 and t = lane % 4, two bf16 per 32-bit register, the lower
// column or row in the low half:
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1),
//                     a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..2t+9)
//   B (16 x 8, col):  b0 (2t..2t+1, g), b1 (2t+8..2t+9, g)
//   C (16 x 8):       c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// The accumulator fragments of two neighbouring 8-column groups are, column
// for column, the A fragment of a 16-deep product (FlashAttention-2's
// register reuse): P feeds P V, and dS feeds dS K, with no data movement.
//
// `ldmatrix` loads four 8 x 8 bf16 matrices from shared memory, each lane
// giving one row's address; plain, lane l gets row l / 4, columns 2(l % 4)
// and 2(l % 4) + 1 of each matrix; with .trans, column l / 4 of rows
// 2(l % 4) and 2(l % 4) + 1. A tiles and the B tiles of X^T (X stored
// [n][k]: K in Q K^T) load plain; B tiles stored [k][n] (V in P V, K in
// dS K, Q and dO in dS^T Q and P^T dO) load with .trans, so no operand is
// transposed in memory.
//
// Shared-memory rows are padded to DH + 8 bf16 (16 bytes): the eight row
// addresses of an ldmatrix then fall on eight distinct 16-byte bank groups.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "mma_tf32x3.cuh"  // cp.async

namespace gordo_bf16 {

using bf16 = __nv_bfloat16;
using gordo_mma::cp_async16;
using gordo_mma::cp_async4;
using gordo_mma::cp_async_commit;
using gordo_mma::cp_async_wait;

// d += a * b
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_address(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_address(p)));
}

// A fragment of a row-major [m][k] tile: `s` points at (row 0, column k0)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld, int lane) {
  ldmatrix_x4(a, s + (lane % 16) * ld + 8 * (lane / 16));
}

// B fragments of two 8-column groups of B = X^T, X stored [n][k] (K in
// Q K^T): `s` points at (n n0, k k0); b[0] covers n0 .. n0 + 7, b[1]
// n0 + 8 .. n0 + 15
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[2][2], const bf16* s, int ld,
                                          int lane) {
  uint32_t r[4];
  ldmatrix_x4(r, s + (lane % 8 + 8 * (lane / 16)) * ld + 8 * ((lane / 8) % 2));
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// B fragments of two 8-column groups of a tile stored [k][n] (V in P V):
// `s` points at (k k0, n n0)
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[2][2], const bf16* s, int ld,
                                          int lane) {
  uint32_t r[4];
  ldmatrix_x4_trans(r, s + (lane % 8 + 8 * ((lane / 8) % 2)) * ld + 8 * (lane / 16));
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) as three bf16 pairs, hi + mid + lo, x0 in the low half of each
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

struct SplitA {
  uint32_t hi[4], mid[4], lo[4];
};

// the accumulator fragments of 8-column groups c0 (columns 0..7) and c1
// (8..15) as a split A fragment of 16 columns
__device__ __forceinline__ SplitA acc_to_a(const float (&c0)[4], const float (&c1)[4]) {
  SplitA a;
  split2(c0[0], c0[1], a.hi[0], a.mid[0], a.lo[0]);
  split2(c0[2], c0[3], a.hi[1], a.mid[1], a.lo[1]);
  split2(c1[0], c1[1], a.hi[2], a.mid[2], a.lo[2]);
  split2(c1[2], c1[3], a.hi[3], a.mid[3], a.lo[3]);
  return a;
}

// acc (16 rows x 8N columns) += A (16 rows of `a_rows`, [row][LD]) times
// B^T (8N rows of `b_rows`, [col][LD]), over DH: S = Q K^T, dP = dO V^T
// and their transposes. Products of bf16 are exact; each 16-deep step goes
// into a fresh accumulator that is added to acc in float32 (see
// product_nn): P = exp(S * scale - lse) and dS = P * (dP - D) carry S's
// and dP's absolute errors, and a running accumulator's truncations left
// dQ further from a float64 reference than plain float32 is.
template <int DH, int LD, int N>
__device__ __forceinline__ void product_nt(float (&acc)[N][4], const bf16* a_rows,
                                           const bf16* b_rows, int lane) {
  static_assert(N % 2 == 0, "8-column groups come in pairs");
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    load_a(a, a_rows + 16 * kk, LD, lane);
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      uint32_t b[2][2];
      load_b_nk(b, b_rows + 16 * j * LD + 16 * kk, LD, lane);
      float f0[4] = {0.f, 0.f, 0.f, 0.f}, f1[4] = {0.f, 0.f, 0.f, 0.f};
      mma(f0, a, b[0]);
      mma(f1, a, b[1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[2 * j][e] += f0[e];
        acc[2 * j + 1][e] += f1[e];
      }
    }
  }
}

// acc (16 rows x DH) += X (16 rows x 8N, float32 accumulator fragments
// `x`, split in three) times the 8N rows of `rows` ([row][LD]): O += P V,
// dQ += dS K, dV += P^T dO, dK += dS^T Q. Each 8-column group of acc takes
// the tile's terms in a fresh accumulator, smallest parts first, that is
// added to acc in float32: the tensor core rounds its sums toward zero, and
// a running accumulator would shrink by up to an ulp at every mma.
template <int DH, int LD, int N>
__device__ __forceinline__ void product_nn(float (&acc)[DH / 8][4], const float (&x)[N][4],
                                           const bf16* rows, int lane) {
  static_assert(N % 2 == 0, "8-row groups come in pairs");
  SplitA a[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = acc_to_a(x[2 * i], x[2 * i + 1]);
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) {
    float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      uint32_t b[2][2];
      load_b_kn(b, rows + 16 * i * LD + 16 * n, LD, lane);
      mma(p0, a[i].lo, b[0]);
      mma(p1, a[i].lo, b[1]);
      mma(p0, a[i].mid, b[0]);
      mma(p1, a[i].mid, b[1]);
      mma(p0, a[i].hi, b[0]);
      mma(p1, a[i].hi, b[1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * n][e] += p0[e];
      acc[2 * n + 1][e] += p1[e];
    }
  }
}

// issue the copy of rows [r0, r0 + ROWS) of a (t, DH) bf16 matrix into
// shared memory with row stride DH + 8, by THREADS threads, 16 bytes each;
// rows at or past t are zero-filled. Does not commit.
template <int ROWS, int DH, int THREADS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int r0, int t) {
  constexpr int C8 = DH / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * C8; i += THREADS) {
    const int r = i / C8;
    const int c = i - r * C8;
    const bool in = r0 + r < t;
    const bf16* from = src + (in ? static_cast<size_t>(r0 + r) * DH + 8 * c : 0);
    cp_async16(dst + r * (DH + 8) + 8 * c, from, in);
  }
}

// a + sum of the products of the eight bf16 pairs of a and b, in float32
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const uint32_t av[4] = {a.x, a.y, a.z, a.w};
  const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[i]));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv[i]));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

// the two floats as one bf16 pair, rounded to nearest, x0 first in memory
__device__ __forceinline__ __nv_bfloat162 to_bf16x2(float x0, float x1) {
  return __floats2bfloat162_rn(x0, x1);
}

}  // namespace gordo_bf16
