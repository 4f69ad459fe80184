// Flash-attention backward for NVIDIA Hopper (sm_90a), float32-accurate on
// the tensor cores: two kernels, dQ and dK/dV, launched one after the other
// on one stream.
//
// Replaces the two TPU kernels of `_flash_backward` in
// gordo_tpu/ops/pallas_kernels/flash_attention.py:
// - flash_bwd_dq_f32 replaces `_flash_dq_kernel`: for each 64-row query
//   tile, loop over key tiles up to the diagonal, recompute
//   P = exp(S - lse), D = rowsum(dO * O), dS = P * (dO V^T - D) and
//   accumulate dQ += dS K * scale;
// - flash_bwd_dkv_f32 replaces `_flash_dkv_kernel`: for each 64-row key
//   tile, loop over query tiles from the diagonal on, and accumulate
//   dV += P^T dO and dK += dS^T Q * scale.
// Both read lse as (BH, T) float32, the layout the forward kernel writes.
// Each output element is written by exactly one block, with no atomics,
// so two runs give bit-identical results.
//
// What bounds them on this card: at the training shape (BH 128, T 512,
// dh 64, causal) dQ does 6*dh FLOP and dK/dV 8*dh FLOP for each of the
// 16.8 M visible (query, key) pairs (6.5e9 and 8.6e9 FLOP), against
// ~0.1 GB of q/k/v/o/dO/lse in and gradients out: ~60-70 FLOP per byte,
// so both are bound by arithmetic: 0.039 ms and 0.052 ms in 3xTF32 on the
// tensor cores (165 TFLOP/s, mma_tf32x3.cuh), against 0.096 ms and
// 0.128 ms as float32 FMAs on the CUDA cores (67 TFLOP/s published). Every
// product of both runs on the tensor cores in 3xTF32 mma.sync.
//
// What the two share:
// - one block of 4 warps per (bh, 64-row tile), each warp one m16 strip of
//   16 rows; the other side's rows come in tiles double-buffered with
//   cp.async (tile j + 1 loads while tile j computes), rows at or past T
//   zero-filled;
// - every shared-memory row is padded to dh + 4 floats, so every fragment
//   load is conflict-free; a product's result feeds the next product
//   straight from its accumulator fragments (mma_tf32x3.cuh), so P, dS
//   and their transposes never leave registers;
// - each product's terms go into a fresh accumulator that is added in
//   float32 (mma_3xtf32_sum): two k-steps at a time for the score-shaped
//   products (S, dP and their transposes);
// - under causal masking the tile loop ends (dQ) or starts (dK/dV) at the
//   diagonal, a warp whose rows all lie on the masked side of a tile skips
//   it, only tiles that cross the diagonal or T are masked, and the blocks
//   with the most work are scheduled first. The ragged tail is zero-filled
//   and masked, so any T >= 1 works; dh is 16, 32, 64 or 128 (a template
//   parameter).
//
// dQ (flash_bwd_dq_f32):
// - each warp owns 16 query rows. Q and dO of the block's 64 rows are
//   loaded once; while they land, each thread reads the lse of its two
//   rows (g and g + 8 of its warp's strip) and computes their
//   D = rowsum(dO * O) from global memory, so O is read once and not kept;
// - K and V tiles of 32 key rows (16 at dh 128, where more would not fit
//   the registers) are double-buffered;
// - per tile: S = Q K^T and dP = dO V^T, K and V as "col" B fragments, in
//   one loop so that their chains of dependent mma instructions interleave
//   (the kernel waits on latency more than it issues); P = exp(S * scale -
//   lse), natural exponentials as the reference and the forward; dS =
//   P * (dP - D) in registers; dQ += dS K, dS's accumulator fragments as A
//   fragments and K's B fragments read from its [key][dh] tile in the
//   matching key order, the tile's keys in one fresh sum per 8 columns of
//   dQ as dK/dV sums; scale is applied once at the store;
// - at dh 64, three blocks share an SM (68 KB of shared memory each).
//   Splitting Q and dO into TF32 big and small parts once per block, or
//   each K/V tile once per stage, saves split instructions but costs
//   resident blocks, and was slower (scripts/torch_dq_variants.py).
//
// dK/dV (flash_bwd_dkv_f32):
// - each warp owns 16 key rows. K and V are loaded once; Q, dO and lse
//   tiles of 32 query rows (8 at dh 128, where more would not fit the
//   registers) are double-buffered, and O's tile goes through one buffer
//   into D;
// - it computes on the transposed problem, so that no product needs a
//   transpose in registers: S^T = K Q^T * scale, masked, P^T =
//   exp(S^T - lse); dV += P^T dO; dP^T = V dO^T; dS^T = P^T * (dP^T - D),
//   with D = rowsum(dO * O) recomputed per query tile as the TPU kernel
//   does; dK += dS^T Q * scale; dV and dK sum one query tile per fresh sum;
// - at dh 64, the training shape, two blocks share an SM (77 KB of shared
//   memory each), and the kernel asks the register allocator for that
//   (flash_bwd_dkv_f32_dh64): it then keeps more products in flight.
// Shared memory: dQ 20 / 36 / 68 / 99 KB, dK/dV 23 / 41 / 77 / 87 KB at
// dh 16 / 32 / 64 / 128. Above 48 KB only through the dynamic-size
// attribute.

#include <cuda_runtime.h>
#include <limits.h>

#include "mma_tf32x3.cuh"

namespace {

using namespace gordo_mma;

constexpr int TILE = 64;      // a block's query rows (dQ) or key rows (dK/dV)
constexpr int THREADS = 128;  // 4 warps, 16 rows each

// acc (16 rows x 8N columns) += A (16 rows of `a_rows`, [row][DH]) times
// B^T (8N rows of `b_rows`, [col][DH]): S^T = K Q^T and dP^T = V dO^T,
// two k-steps per fresh sum
template <int DH, int N>
__device__ __forceinline__ void product_nt(float (&acc)[N][4], const float* a_rows,
                                           const float* b_rows, int g, int tq) {
  constexpr int LD = DH + 4;
#pragma unroll 2
  for (int kk = 0; kk < DH / 8; kk += 2) {
    const FragA a[2] = {load_a(a_rows + 8 * kk, LD, g, tq),
                        load_a(a_rows + 8 * kk + 8, LD, g, tq)};
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const FragB b[2] = {load_b_nk(b_rows + 8 * n * LD + 8 * kk, LD, g, tq),
                          load_b_nk(b_rows + 8 * n * LD + 8 * kk + 8, LD, g, tq)};
      mma_3xtf32_sum<2>(acc[n], a, b);
    }
  }
}

// acc (16 rows x DH) += X (16 rows x 8N, accumulator fragments `x`) times
// the 8N rows of `rows` ([row][DH]): dQ += dS K, dV += P^T dO and dK +=
// dS^T Q; the 8N rows in one fresh sum per 8 output columns
template <int DH, int N>
__device__ __forceinline__ void product_nn(float (&acc)[DH / 8][4], const float (&x)[N][4],
                                           const float* rows, int g, int tq) {
  constexpr int LD = DH + 4;
  FragA a[N];
#pragma unroll
  for (int n = 0; n < N; ++n) a[n] = acc_to_a(x[n]);
#pragma unroll
  for (int m = 0; m < DH / 8; ++m) {
    FragB b[N];
#pragma unroll
    for (int n = 0; n < N; ++n) b[n] = load_b_kn_paired(rows + 8 * n * LD + 8 * m, LD, g, tq);
    mma_3xtf32_sum<N>(acc[m], a, b);
  }
}

// --- dQ ---

template <int DH>
struct Dq {
  // key rows per double-buffered K/V tile: 16 at dh 128 keeps the dQ
  // accumulators and the S and dP tiles in registers
  static constexpr int BK = DH == 128 ? 16 : 32;
  static constexpr int LD = DH + 4;         // shared-memory row stride
  static constexpr int Q = 0;               // Q, then dO: [TILE][LD] each
  static constexpr int KV = 2 * TILE * LD;  // [stage][K, V][BK][LD]
  static constexpr int SMEM_FLOATS = KV + 4 * BK * LD;
};

// this thread's part of rowsum(dO * O) of `row` (0 at or past t): float4
// columns tq, tq + 4, ...; the four threads of a quad hold one row's parts
template <int DH>
__device__ __forceinline__ float row_dot_part(const float* o, const float* dout, int row,
                                              int t, int tq) {
  float d = 0.f;
  if (row < t) {
    const float4* o4 = reinterpret_cast<const float4*>(o + static_cast<size_t>(row) * DH);
    const float4* g4 = reinterpret_cast<const float4*>(dout + static_cast<size_t>(row) * DH);
#pragma unroll
    for (int c = tq; c < DH / 4; c += 4) {
      const float4 a = o4[c];
      const float4 b = g4[c];
      d = fmaf(a.x, b.x, d);
      d = fmaf(a.y, b.y, d);
      d = fmaf(a.z, b.z, d);
      d = fmaf(a.w, b.w, d);
    }
  }
  return d;
}

// the sum over the four threads of a quad, the same bits in each
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ lse, const float* __restrict__ dout,
                 float* __restrict__ dq, int t, int n_tiles, float scale, int causal) {
  using C = Dq<DH>;
  constexpr int LD = C::LD;
  constexpr int BK = C::BK;
  constexpr int NT = BK / 8;  // 8-key column groups of S, dP and dS
  constexpr int OT = DH / 8;  // 8-column groups of dQ
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int tq = threadIdx.x % 4;
  // heaviest causal tiles (the last query rows) go first
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x % n_tiles);
  const size_t bh = blockIdx.x / n_tiles;
  const int q0 = tile * TILE;
  const int w0 = q0 + 16 * warp;  // the warp's first query row
  const size_t base = bh * static_cast<size_t>(t) * DH;
  const float* kb = k + base;
  const float* vb = v + base;

  int n_k_tiles = (t + BK - 1) / BK;
  if (causal) n_k_tiles = min(n_k_tiles, (q0 + TILE + BK - 1) / BK);

  load_tile_async<TILE, DH, THREADS>(smem + C::Q, q + base, q0, t);
  load_tile_async<TILE, DH, THREADS>(smem + C::Q + TILE * LD, dout + base, q0, t);
  load_tile_async<BK, DH, THREADS>(smem + C::KV, kb, 0, t);
  load_tile_async<BK, DH, THREADS>(smem + C::KV + BK * LD, vb, 0, t);
  cp_async_commit();
  // while the tiles land: lse and D of the thread's rows w0 + g + 8 h, h
  // the accumulator fragment's half
  float lse_r[2], d_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w0 + g + 8 * h;
    lse_r[h] = row < t ? lse[bh * t + row] : 0.f;
    d_r[h] = quad_sum(row_dot_part<DH>(o + base, dout + base, row, t, tq));
  }
  const float* qw = smem + C::Q + 16 * warp * LD;
  const float* gw = qw + TILE * LD;  // the warp's dO rows

  float acc[OT][4];
#pragma unroll
  for (int m = 0; m < OT; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int stage = kt & 1;
    cp_async_wait<0>();
    // tile kt has landed, and every warp is done with the other stage
    __syncthreads();
    if (kt + 1 < n_k_tiles) {
      float* next = smem + C::KV + (stage ^ 1) * 2 * BK * LD;
      load_tile_async<BK, DH, THREADS>(next, kb, (kt + 1) * BK, t);
      load_tile_async<BK, DH, THREADS>(next + BK * LD, vb, (kt + 1) * BK, t);
      cp_async_commit();
    }
    const float* ks = smem + C::KV + stage * 2 * BK * LD;
    const float* vs = ks + BK * LD;
    const int k0 = kt * BK;
    if (causal && w0 + 15 < k0) continue;  // warp-uniform: all masked

    // S = Q K^T and dP = dO V^T in one loop, so that their chains of
    // dependent mma instructions interleave; two k-steps per fresh sum
    float s[NT][4], ds[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = ds[n][e] = 0.f;
    }
#pragma unroll 2
    for (int kk = 0; kk < DH / 8; kk += 2) {
      const FragA aq[2] = {load_a(qw + 8 * kk, LD, g, tq), load_a(qw + 8 * kk + 8, LD, g, tq)};
      const FragA ag[2] = {load_a(gw + 8 * kk, LD, g, tq), load_a(gw + 8 * kk + 8, LD, g, tq)};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* kn = ks + 8 * n * LD + 8 * kk;
        const float* vn = vs + 8 * n * LD + 8 * kk;
        const FragB bk[2] = {load_b_nk(kn, LD, g, tq), load_b_nk(kn + 8, LD, g, tq)};
        const FragB bv[2] = {load_b_nk(vn, LD, g, tq), load_b_nk(vn + 8, LD, g, tq)};
        mma_3xtf32_sum<2>(s[n], aq, bk);
        mma_3xtf32_sum<2>(ds[n], ag, bv);
      }
    }
    // P = exp(S * scale - lse), 0 where masked; dS = P * (dP - D)
    const bool mask = k0 + BK > t || (causal && k0 + BK - 1 > w0);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        float p = expf(s[n][e] * scale - lse_r[h]);
        if (mask) {
          const int key = k0 + 8 * n + 2 * tq + (e & 1);
          if (!(key < t && (!causal || key <= w0 + g + 8 * h))) p = 0.f;
        }
        ds[n][e] = p * (ds[n][e] - d_r[h]);
      }
    }
    product_nn<DH>(acc, ds, ks, g, tq);  // dQ += dS K (times scale below)
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w0 + g + 8 * h;
    if (row >= t) continue;
    float* dst = dq + base + static_cast<size_t>(row) * DH + 2 * tq;
#pragma unroll
    for (int m = 0; m < OT; ++m) {
      *reinterpret_cast<float2*>(dst + 8 * m) =
          make_float2(acc[m][2 * h] * scale, acc[m][2 * h + 1] * scale);
    }
  }
}

// --- dK/dV ---

template <int DH>
struct Dkv {
  // query rows per double-buffered tile: 8 at dh 128 keeps the
  // accumulators in registers
  static constexpr int BQ = DH == 128 ? 8 : 32;
  static constexpr int LD = DH + 4;          // shared-memory row stride
  static constexpr int KV = 0;               // K, then V: [TILE][LD] each
  static constexpr int Q = 2 * TILE * LD;    // [stage][Q, dO][BQ][LD]
  static constexpr int O = Q + 4 * BQ * LD;  // [BQ][LD]
  static constexpr int LSE = O + BQ * LD;    // [stage][BQ]
  static constexpr int D = LSE + 2 * BQ;     // [BQ]
  static constexpr int SMEM_FLOATS = D + BQ;
};

// issue the loads of query tile q0: Q and dO into `stage`, O, and lse
template <int DH>
__device__ __forceinline__ void load_query_tile(float* smem, int stage,
                                                const float* q, const float* dout,
                                                const float* o, const float* lse,
                                                int q0, int t) {
  using C = Dkv<DH>;
  constexpr int BQ = C::BQ;
  float* qs = smem + C::Q + stage * 2 * BQ * C::LD;
  load_tile_async<BQ, DH, THREADS>(qs, q, q0, t);
  load_tile_async<BQ, DH, THREADS>(qs + BQ * C::LD, dout, q0, t);
  load_tile_async<BQ, DH, THREADS>(smem + C::O, o, q0, t);
  if (threadIdx.x < BQ) {
    const int row = q0 + static_cast<int>(threadIdx.x);
    cp_async4(smem + C::LSE + stage * BQ + threadIdx.x, lse + (row < t ? row : 0),
              row < t);
  }
  cp_async_commit();
}

template <int DH>
__device__ __forceinline__ void dkv_body(const float* __restrict__ q,
                                         const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         const float* __restrict__ o,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ dout,
                                         float* __restrict__ dk, float* __restrict__ dv,
                                         int t, int n_tiles, float scale, int causal) {
  using C = Dkv<DH>;
  constexpr int LD = C::LD;
  constexpr int BQ = C::BQ;
  constexpr int NT = BQ / 8;      // 8-query column groups
  constexpr int OT = DH / 8;      // 8-column groups of dK and dV
  constexpr int TPR = THREADS / BQ;  // threads per row computing D
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int tq = threadIdx.x % 4;
  // under causal masking the first key tiles see the most queries: first
  const int tile = static_cast<int>(blockIdx.x % n_tiles);
  const size_t bh = blockIdx.x / n_tiles;
  const int k0 = tile * TILE;
  const int w0 = k0 + 16 * warp;  // the warp's first key row
  const size_t base = bh * static_cast<size_t>(t) * DH;
  const float* qb = q + base;
  const float* gb = dout + base;
  const float* ob = o + base;
  const float* lb = lse + bh * t;

  const int n_q_tiles = (t + BQ - 1) / BQ;
  const int first = causal ? k0 / BQ : 0;  // the diagonal tile
  load_tile_async<TILE, DH, THREADS>(smem + C::KV, k + base, k0, t);
  load_tile_async<TILE, DH, THREADS>(smem + C::KV + TILE * LD, v + base, k0, t);
  load_query_tile<DH>(smem, 0, qb, gb, ob, lb, first * BQ, t);
  const float* kw = smem + C::KV + 16 * warp * LD;
  const float* vw = kw + TILE * LD;
  float* d_s = smem + C::D;

  float dk_acc[OT][4], dv_acc[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  for (int qt = first; qt < n_q_tiles; ++qt) {
    const int stage = (qt - first) & 1;
    const int q0 = qt * BQ;
    const float* qs = smem + C::Q + stage * 2 * BQ * LD;
    const float* dos = qs + BQ * LD;
    const float* lse_s = smem + C::LSE + stage * BQ;
    cp_async_wait<0>();
    // tile qt has landed; every warp is done with tile qt - 1 (D, the
    // other stage)
    __syncthreads();
    {  // D = rowsum(dO * O), TPR threads per row; rows past t are zero
      const int r = threadIdx.x / TPR;
      const int part = threadIdx.x % TPR;
      const float* orow = smem + C::O + r * LD;
      const float* grow = dos + r * LD;
      float d = 0.f;
#pragma unroll
      for (int c = 4 * part; c < DH; c += 4 * TPR) {
        const float4 a = *reinterpret_cast<const float4*>(orow + c);
        const float4 b = *reinterpret_cast<const float4*>(grow + c);
        d = fmaf(a.x, b.x, d);
        d = fmaf(a.y, b.y, d);
        d = fmaf(a.z, b.z, d);
        d = fmaf(a.w, b.w, d);
      }
#pragma unroll
      for (int lane = 1; lane < TPR; lane *= 2) d += __shfl_xor_sync(0xffffffffu, d, lane);
      if (part == 0) d_s[r] = d;
    }
    __syncthreads();  // D is written and the O buffer is free
    if (qt + 1 < n_q_tiles) {
      load_query_tile<DH>(smem, stage ^ 1, qb, gb, ob, lb, q0 + BQ, t);
    }
    if (causal && q0 + BQ - 1 < w0) continue;  // warp-uniform: all masked

    // S^T = K Q^T (keys x queries), then P^T = exp(S^T * scale - lse), 0
    // where masked
    float p[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
    product_nt<DH>(p, kw, qs, g, tq);
    const bool mask = q0 + BQ > t || (causal && w0 + 15 > q0);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * tq + (e & 1);
        float x = expf(p[n][e] * scale - lse_s[col]);
        if (mask) {
          const int query = q0 + col;
          const int key = w0 + g + (e < 2 ? 0 : 8);
          if (!(query < t && (!causal || key <= query))) x = 0.f;
        }
        p[n][e] = x;
      }
    }
    product_nn<DH>(dv_acc, p, dos, g, tq);  // dV += P^T dO
    // dP^T = V dO^T, then dS^T = P^T * (dP^T - D)
    float ds[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
    product_nt<DH>(ds, vw, dos, g, tq);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[n][e] = p[n][e] * (ds[n][e] - d_s[8 * n + 2 * tq + (e & 1)]);
      }
    }
    product_nn<DH>(dk_acc, ds, qs, g, tq);  // dK += dS^T Q (times scale below)
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = w0 + g + 8 * half;
    if (key >= t) continue;
    float* dkr = dk + base + static_cast<size_t>(key) * DH + 2 * tq;
    float* dvr = dv + base + static_cast<size_t>(key) * DH + 2 * tq;
#pragma unroll
    for (int m = 0; m < OT; ++m) {
      *reinterpret_cast<float2*>(dkr + 8 * m) =
          make_float2(dk_acc[m][2 * half] * scale, dk_acc[m][2 * half + 1] * scale);
      *reinterpret_cast<float2*>(dvr + 8 * m) =
          make_float2(dv_acc[m][2 * half], dv_acc[m][2 * half + 1]);
    }
  }
}

#define DKV_PARAMS                                                             \
  const float *__restrict__ q, const float *__restrict__ k,                   \
      const float *__restrict__ v, const float *__restrict__ o,               \
      const float *__restrict__ lse, const float *__restrict__ dout,          \
      float *__restrict__ dk, float *__restrict__ dv, int t, int n_tiles,     \
      float scale, int causal

template <int DH>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_f32(DKV_PARAMS) {
  dkv_body<DH>(q, k, v, o, lse, dout, dk, dv, t, n_tiles, scale, causal);
}

// dh 64, the training shape, with two resident blocks per SM asked of the
// register allocator (the hint makes the other head dims' code worse)
__global__ void __launch_bounds__(THREADS, 2) flash_bwd_dkv_f32_dh64(DKV_PARAMS) {
  dkv_body<64>(q, k, v, o, lse, dout, dk, dv, t, n_tiles, scale, causal);
}

#undef DKV_PARAMS

template <int DH>
constexpr auto dkv_kernel() {
  if constexpr (DH == 64) {
    return flash_bwd_dkv_f32_dh64;
  } else {
    return flash_bwd_dkv_f32<DH>;
  }
}

// let `kernel` take `smem` bytes of dynamic shared memory: above 48 KB
// only through the attribute
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// one block per (bh, 64-row tile)
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int bh, int t, int smem, unsigned* n_blocks,
                    int* n_tiles) {
  *n_tiles = (t + TILE - 1) / TILE;
  const long long blocks = static_cast<long long>(bh) * *n_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  *n_blocks = static_cast<unsigned>(blocks);
  return allow_smem(kernel, smem);
}

template <int DH>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* o, const float* lse, const float* dout,
                      float* dq, int bh, int t, float scale, int causal,
                      cudaStream_t stream) {
  const int smem = Dq<DH>::SMEM_FLOATS * static_cast<int>(sizeof(float));
  unsigned n_blocks;
  int n_tiles;
  const cudaError_t err =
      prepare(flash_bwd_dq_f32<DH>, bh, t, smem, &n_blocks, &n_tiles);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32<DH><<<n_blocks, THREADS, smem, stream>>>(
      q, k, v, o, lse, dout, dq, t, n_tiles, scale, causal);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* o, const float* lse, const float* dout,
                       float* dk, float* dv, int bh, int t, float scale,
                       int causal, cudaStream_t stream) {
  const int smem = Dkv<DH>::SMEM_FLOATS * static_cast<int>(sizeof(float));
  unsigned n_blocks;
  int n_tiles;
  const cudaError_t err =
      prepare(dkv_kernel<DH>(), bh, t, smem, &n_blocks, &n_tiles);
  if (err != cudaSuccess) return err;
  const auto kernel = dkv_kernel<DH>();
  kernel<<<n_blocks, THREADS, smem, stream>>>(
      q, k, v, o, lse, dout, dk, dv, t, n_tiles, scale, causal);
  return cudaGetLastError();
}

// `kernel`'s dynamic shared memory (`smem_floats` floats, in bytes) and its
// resident blocks per SM
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int smem_floats, int* smem, int* blocks_per_sm) {
  *smem = smem_floats * static_cast<int>(sizeof(float));
  const cudaError_t err = allow_smem(kernel, *smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, THREADS,
                                                       *smem);
}

template <int DH>
cudaError_t dq_occupancy(int* smem, int* blocks_per_sm) {
  return occupancy(flash_bwd_dq_f32<DH>, Dq<DH>::SMEM_FLOATS, smem, blocks_per_sm);
}

template <int DH>
cudaError_t dkv_occupancy(int* smem, int* blocks_per_sm) {
  return occupancy(dkv_kernel<DH>(), Dkv<DH>::SMEM_FLOATS, smem, blocks_per_sm);
}

}  // namespace

// q, k, v, o, dout, dq: (bh, t, dh) contiguous float32, 16-byte aligned;
// lse: (bh, t) float32 from the forward. Launches on `stream` and does not
// synchronise. Returns the CUDA error code of the launch (0 on success).
extern "C" int gordo_flash_attention_backward_dq_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, int bh, int t, int dh,
    float scale, int causal, void* stream) {
  if (bh <= 0 || t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* lf = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(dout);
  float* dqf = static_cast<float*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 16: err = launch_dq<16>(qf, kf, vf, of, lf, gf, dqf, bh, t, scale, causal, s); break;
    case 32: err = launch_dq<32>(qf, kf, vf, of, lf, gf, dqf, bh, t, scale, causal, s); break;
    case 64: err = launch_dq<64>(qf, kf, vf, of, lf, gf, dqf, bh, t, scale, causal, s); break;
    case 128: err = launch_dq<128>(qf, kf, vf, of, lf, gf, dqf, bh, t, scale, causal, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// As above, writing dk and dv: (bh, t, dh) contiguous float32.
extern "C" int gordo_flash_attention_backward_dkv_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dk, void* dv, int bh, int t,
    int dh, float scale, int causal, void* stream) {
  if (bh <= 0 || t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* lf = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(dout);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 16: err = launch_dkv<16>(qf, kf, vf, of, lf, gf, dkf, dvf, bh, t, scale, causal, s); break;
    case 32: err = launch_dkv<32>(qf, kf, vf, of, lf, gf, dkf, dvf, bh, t, scale, causal, s); break;
    case 64: err = launch_dkv<64>(qf, kf, vf, of, lf, gf, dkf, dvf, bh, t, scale, causal, s); break;
    case 128: err = launch_dkv<128>(qf, kf, vf, of, lf, gf, dkf, dvf, bh, t, scale, causal, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The dQ kernel's dynamic shared memory (bytes) and resident blocks per SM
// at head dim `dh`, for reports. Returns the CUDA error code.
extern "C" int gordo_flash_attention_backward_dq_f32_occupancy(int dh, int* smem_bytes,
                                                              int* blocks_per_sm) {
  switch (dh) {
    case 16: return static_cast<int>(dq_occupancy<16>(smem_bytes, blocks_per_sm));
    case 32: return static_cast<int>(dq_occupancy<32>(smem_bytes, blocks_per_sm));
    case 64: return static_cast<int>(dq_occupancy<64>(smem_bytes, blocks_per_sm));
    case 128: return static_cast<int>(dq_occupancy<128>(smem_bytes, blocks_per_sm));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As above, for the dK/dV kernel.
extern "C" int gordo_flash_attention_backward_dkv_f32_occupancy(int dh, int* smem_bytes,
                                                               int* blocks_per_sm) {
  switch (dh) {
    case 16: return static_cast<int>(dkv_occupancy<16>(smem_bytes, blocks_per_sm));
    case 32: return static_cast<int>(dkv_occupancy<32>(smem_bytes, blocks_per_sm));
    case 64: return static_cast<int>(dkv_occupancy<64>(smem_bytes, blocks_per_sm));
    case 128: return static_cast<int>(dkv_occupancy<128>(smem_bytes, blocks_per_sm));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
