// Float32-accurate tensor-core products for NVIDIA Hopper (sm_90a):
// 3xTF32 `mma.sync` fragments and `cp.async` tile loads, shared by the
// flash-attention kernels of this directory: the forward
// (flash_attention.cu), dQ and dK/dV (flash_attention_bwd.cu). Every
// product of the three runs on the tensor cores through this header.
//
// 3xTF32 (CUTLASS's OpMultiplyAddFastF32): each float32 operand x is split
// into big = tf32(x), rounded to nearest with ties away from zero, and
// small = x - big, of which the tensor core reads the top 19 bits; a product
// a*b is accumulated as small_a*big_b + big_a*small_b + big_a*big_b, the
// small terms first. big + small holds 22 of float32's 24 significand bits,
// and the dropped small_a*small_b term is ~2^-22 of the product, so the
// result is close to a float32 FMA chain; one TF32 pass keeps ~3 decimal
// digits. The tensor cores do TF32 at 495 TFLOP/s (H100 SXM, data sheet), so
// 3xTF32 runs at up to 165 TFLOP/s of float32-accurate work, against
// 67 TFLOP/s on the CUDA cores. mma.sync reaches about 320 TFLOP/s of
// TF32 on an NVIDIA H100 80GB HBM3 at 700 W (scripts/mma_throughput.py), so
// a third of that is its practical 3xTF32 ceiling.
//
// The tensor core rounds each sum toward zero. A running accumulator that
// every mma rounds shrinks by up to an ulp per step, and those errors add up
// with one sign; so products go into a fresh accumulator that is added to
// the running one in float32, rounded to nearest (mma_3xtf32_sum).
//
// Fragments of `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32` (PTX
// ISA; the layouts of CUTLASS's SM80_16x8x8_F32TF32TF32F32_TN), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
//
// Chaining two products without a transpose: a product's sum runs over its
// k index in any order, so the k index of a second product may be permuted.
// Taking k = t for column 2t and k = t + 4 for column 2t + 1 of each 8-column
// group turns an accumulator fragment (c0, c1, c2, c3) into the A fragment
// (c0, c2, c1, c3) of the next product, with no data movement, provided the
// B operand is read with the same permutation: b0 from row 2t and b1 from
// row 2t + 1 (`load_b_kn_paired`). This is how P goes from the score
// product into P V (forward), dS into dS K (dQ), and P^T and dS^T into
// P^T dO and dS^T Q (dK/dV).
//
// Shared-memory rows are padded to DH + 4 floats (DH a multiple of 16):
// the A loads and the "col" B loads (thread reads row g, column t) and the
// paired B loads (row 2t, column g) then fall on 32 distinct banks.
//
// Why mma.sync and not wgmma yet: TF32 wgmma takes both operands K-major
// only. V in P V, K in dS K, and dO and Q in P^T dO and dS^T Q, are
// N-major in their natural layout and would need a transposing pass
// through shared memory; mma.sync fragments are loaded by hand in any
// layout. wgmma and TMA come with the bf16 kernels.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "head_dim.cuh"

namespace gordo_mma {

// x rounded to TF32, to nearest with ties away from zero, as
// `cvt.rna.tf32.f32` does for finite x; two integer instructions where the
// conversion instruction compiles to a longer sequence on this card
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// small = x - big is exact; the tensor core reads its top 19 bits, which
// rounds it toward zero: an error below 2^-23 |x| with the sign of small,
// which is that of a rounding residual, not of x
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

struct FragA {
  uint32_t big[4], small[4];
};

struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b, a fresh accumulator
__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// d += sum over i of a[i] * b[i] (N k-steps), float32-accurate: the small
// terms of every k-step first, then the big * big terms, in a fresh
// accumulator that is added to d in float32. The tensor core rounds each
// sum toward zero, so a running accumulator would shrink by up to an ulp at
// every mma; here only the N big * big steps round at the partial sum's
// magnitude, and d itself is rounded to nearest.
template <int N>
__device__ __forceinline__ void mma_3xtf32_sum(float (&d)[4], const FragA (&a)[N],
                                               const FragB (&b)[N]) {
  float p[4];
  mma_tf32_fresh(p, a[0].small, b[0].big);
  mma_tf32(p, a[0].big, b[0].small);
#pragma unroll
  for (int i = 1; i < N; ++i) {
    mma_tf32(p, a[i].small, b[i].big);
    mma_tf32(p, a[i].big, b[i].small);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(p, a[i].big, b[i].big);
  d[0] += p[0];
  d[1] += p[1];
  d[2] += p[2];
  d[3] += p[3];
}

// d += a * b, float32-accurate (one k-step)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a,
                                           const FragB& b) {
  const FragA as[1] = {a};
  const FragB bs[1] = {b};
  mma_3xtf32_sum<1>(d, as, bs);
}

__device__ __forceinline__ FragA split_a(float x0, float x1, float x2, float x3) {
  FragA f;
  split(x0, f.big[0], f.small[0]);
  split(x1, f.big[1], f.small[1]);
  split(x2, f.big[2], f.small[2]);
  split(x3, f.big[3], f.small[3]);
  return f;
}

__device__ __forceinline__ FragB split_b(float x0, float x1) {
  FragB f;
  split(x0, f.big[0], f.small[0]);
  split(x1, f.big[1], f.small[1]);
  return f;
}

// A fragment of a row-major [m][k] tile: `s` points at (row 0, column k0)
__device__ __forceinline__ FragA load_a(const float* s, int ld, int g, int t) {
  return split_a(s[g * ld + t], s[(g + 8) * ld + t], s[g * ld + t + 4],
                 s[(g + 8) * ld + t + 4]);
}

// "col" B fragment of a tile stored [n][k] (K for Q K^T): `s` points at
// (n 0, k k0)
__device__ __forceinline__ FragB load_b_nk(const float* s, int ld, int g, int t) {
  return split_b(s[g * ld + t], s[g * ld + t + 4]);
}

// B fragment of a tile stored [k][n] (V for P V), k permuted as the A
// fragment from `acc_to_a`: `s` points at (k k0, n n0)
__device__ __forceinline__ FragB load_b_kn_paired(const float* s, int ld, int g,
                                                  int t) {
  return split_b(s[2 * t * ld + g], s[(2 * t + 1) * ld + g]);
}

// an accumulator fragment as the A fragment of the next product (see above)
__device__ __forceinline__ FragA acc_to_a(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// cp.async: 16 bytes from global to shared memory, or 16 zero bytes when
// `fill` is false (src-size 0: nothing is read from `src`)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(fill ? 16 : 0));
}

// as above, 4 bytes
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(fill ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// issue the copy of rows [r0, r0 + ROWS) of a (t, dh) float32 matrix into
// shared memory with row stride DH + 4, by THREADS threads: DH is the
// kernel's head-dim class, dh <= DH the matrix's own (a multiple of 4, so
// that each 16-byte chunk lies wholly inside or outside a row); rows at or
// past t and columns at or past dh are zero-filled. Does not commit.
template <int ROWS, int DH, int THREADS>
__device__ __forceinline__ void load_tile_async(float* dst, const float* src, int r0, int t,
                                                int dh) {
  constexpr int D4 = DH / 4;
  for (int i = threadIdx.x; i < ROWS * D4; i += THREADS) {
    const int r = i / D4;
    const int c4 = i - r * D4;
    const bool in = r0 + r < t && 4 * c4 < dh;
    const float* from = src + (in ? static_cast<size_t>(r0 + r) * dh + 4 * c4 : 0);
    cp_async16(dst + r * (DH + 4) + 4 * c4, from, in);
  }
}

// The head-dim classes of the float32 kernels (head_dim.cuh): 32-column
// classes (a whole number of the 16-column steps that S = Q K^T takes two
// k8 steps at a time, and a row stride of DH + 4 floats that keeps the
// fragment loads conflict-free)
inline int head_dim_class(int dh) { return gordo_flash::head_dim_class<32>(dh); }

template <typename Fn>
cudaError_t with_head_dim_class(int dh, Fn&& fn) {
  return gordo_flash::with_head_dim_class<32>(dh, fn);
}

using gordo_flash::has_padded_dims;
using gordo_flash::head_dim;

// Classes 128 and 256 also have an exact instantiation for the dh that
// fills them: it takes 0.94x the padded one's time in dQ at 128, 0.90x in
// dQ and 0.94x in the forward at 256 (H100, scripts/torch_flash_ab.py;
// PERF.md); at 96 it was within 2.5% either way. Every other dh runs padded.
template <int DH, typename Fn>
auto with_instantiation(int dh, Fn&& fn) {
  return gordo_flash::with_instantiation<DH, DH == 128 || DH == 256>(dh, fn);
}

}  // namespace gordo_mma
