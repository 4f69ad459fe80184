// Flash-attention backward for NVIDIA Hopper (sm_90a), float32: two kernels,
// dQ and dK/dV, launched one after the other on one stream.
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
// so both are bound by arithmetic: 0.096 ms and 0.128 ms as float32 FMAs
// on the CUDA cores (67 TFLOP/s published), 0.039 ms and 0.052 ms in
// 3xTF32 on the tensor cores (165 TFLOP/s, mma_tf32x3.cuh).
//
// dQ, on the CUDA cores (right and simple first):
// - a block of 256 threads stages 64-row tiles in shared memory and
//   computes the 64x64 S and dP tiles together, each thread a 4x4
//   sub-tile, reading float4s from rows padded by 4 floats (no bank
//   conflicts; one operand is a broadcast within each quarter warp);
// - dS goes to shared memory, and each thread then accumulates a 4-row
//   slice of dQ in registers, an outer product per key that reuses each
//   shared-memory load for 4 FMAs or more;
// - under causal masking the key loop stops at the diagonal tile, and the
//   query tiles with the most work are scheduled first.
//
// dK/dV, on the tensor cores in 3xTF32 mma.sync:
// - one block of 4 warps per (bh, 64-row key tile); each warp owns 16 key
//   rows. K and V are loaded once; Q, dO and lse tiles of 32 query rows (8
//   at dh 128, where more would not fit the registers) are double-buffered
//   with cp.async, and O's tile goes through one buffer into D;
// - it computes on the transposed problem, so that no product needs a
//   transpose in registers: S^T = K Q^T * scale, masked, P^T =
//   exp(S^T - lse); dV += P^T dO; dP^T = V dO^T; dS^T = P^T * (dP^T - D),
//   with D = rowsum(dO * O) recomputed per query tile as the TPU kernel
//   does; dK += dS^T Q * scale. P^T and dS^T feed the next product straight
//   from their accumulator fragments (mma_tf32x3.cuh), every shared-memory
//   row is padded to dh + 4 floats and every fragment load is conflict-free;
//   each product's terms go into a fresh accumulator that is added in
//   float32 (mma_3xtf32_sum): two k-steps of S^T and dP^T at a time, one
//   query tile of dV and dK;
// - at dh 64, the training shape, two blocks share an SM (77 KB of shared
//   memory each), and the kernel asks the register allocator for that
//   (flash_bwd_dkv_f32_dh64): it then keeps more products in flight;
// - under causal masking the query loop starts at the diagonal tile, a warp
//   whose keys all lie past a query tile skips it, and the key tiles with
//   the most work are scheduled first.
// The ragged tail (T not a multiple of the tile) is zero-filled and masked,
// so any T >= 1 works; dh is 16, 32, 64 or 128 (a template parameter).
// Shared memory: dQ 4 tiles of 64 x (dh + 4) floats plus two 64 x 68
// score tiles, 38-152 KB; dK/dV 23 / 41 / 77 / 87 KB at dh 16 / 32 / 64 / 128.
// Above 48 KB only through the dynamic-size attribute.

#include <cuda_runtime.h>
#include <limits.h>

#include "mma_tf32x3.cuh"

namespace {

constexpr int TILE = 64;      // query rows and key rows of a tile
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 sub-tile
constexpr int PAD = 4;        // floats of row padding: float4-aligned rows
constexpr int LDP = TILE + PAD;  // row stride of the P / dS tiles

template <int DH>
constexpr int smem_floats() {
  return 4 * TILE * (DH + PAD) + 2 * TILE * LDP + 2 * TILE;
}

// rows [r0, r0 + TILE) of a (t, DH) matrix into shared memory with row
// stride DH + PAD; rows at or past t are zero
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0,
                                          int t) {
  constexpr int D4 = DH / 4;
  for (int i = threadIdx.x; i < TILE * D4; i += THREADS) {
    const int r = i / D4;
    const int c4 = i - r * D4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < t) {
      x = reinterpret_cast<const float4*>(src +
                                          static_cast<size_t>(r0 + r) * DH)[c4];
    }
    *reinterpret_cast<float4*>(dst + r * (DH + PAD) + 4 * c4) = x;
  }
}

// lse and D = rowsum(dO * O) of rows [r0, r0 + TILE): four threads per
// row, summed with warp shuffles; rows at or past t get 0
template <int DH>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* d_s,
                                               const float* lse, const float* o,
                                               const float* dout, int r0,
                                               int t) {
  const int r = threadIdx.x / 4;
  const int part = threadIdx.x % 4;
  const int row = r0 + r;
  float d = 0.f;
  if (row < t) {
    const float4* o4 = reinterpret_cast<const float4*>(
        o + static_cast<size_t>(row) * DH);
    const float4* g4 = reinterpret_cast<const float4*>(
        dout + static_cast<size_t>(row) * DH);
#pragma unroll
    for (int c = part; c < DH / 4; c += 4) {
      const float4 a = o4[c];
      const float4 b = g4[c];
      d = fmaf(a.x, b.x, d);
      d = fmaf(a.y, b.y, d);
      d = fmaf(a.z, b.z, d);
      d = fmaf(a.w, b.w, d);
    }
  }
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  if (part == 0) {
    d_s[r] = d;
    lse_s[r] = row < t ? lse[row] : 0.f;
  }
}

// acc[i][j] = dot(x row xr[i], y row yr[j]) over DH, rows of stride DH + PAD
template <int DH>
__device__ __forceinline__ void tile_dots(const float* x, const float* y,
                                          const int (&xr)[4],
                                          const int (&yr)[4],
                                          float (&acc)[4][4]) {
  constexpr int LD = DH + PAD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 4
  for (int c = 0; c < DH; c += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(x + xr[i] * LD + c);
      b[i] = *reinterpret_cast<const float4*>(y + yr[i] * LD + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
    }
  }
}

// N consecutive floats from shared memory, as wide as alignment allows
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      out[i] = x.x;
      out[i + 1] = x.y;
      out[i + 2] = x.z;
      out[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x;
    out[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// 4 rows x N columns of a register tile to global rows row0 .. row0 + 3
// of a (t, DH) matrix, times `mul`; rows at or past t are skipped
template <int DH, int N>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[4][N],
                                           int row0, int col0, int t,
                                           float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row0 + i >= t) continue;
    float* p = dst + static_cast<size_t>(row0 + i) * DH + col0;
#pragma unroll
    for (int c = 0; c < N; ++c) p[c] = acc[i][c] * mul;
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ lse, const float* __restrict__ dout,
                 float* __restrict__ dq, int t, int n_tiles, float scale,
                 int causal) {
  constexpr int LD = DH + PAD;
  constexpr int CPT = DH / 16;  // dQ columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [TILE][LD]
  float* dos = qs + TILE * LD;                  // [TILE][LD]
  float* ks = dos + TILE * LD;                  // [TILE][LD]
  float* vs = ks + TILE * LD;                   // [TILE][LD]
  float* dst = vs + TILE * LD;                  // dS^T: [key][query], LDP
  float* lse_s = dst + TILE * LDP;              // [TILE]
  float* d_s = lse_s + TILE;                    // [TILE]

  // heaviest causal tiles (the last query rows) go first
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x % n_tiles);
  const size_t bh = blockIdx.x / n_tiles;
  const int q0 = tile * TILE;
  const size_t base = bh * static_cast<size_t>(t) * DH;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_tile<DH>(qs, q + base, q0, t);
  load_tile<DH>(dos, dout + base, q0, t);
  load_row_stats<DH>(lse_s, d_s, lse + bh * t, o + base, dout + base, q0, t);

  // score sub-tile: query rows 4ty + i, key rows tx + 16j of the tile
  const int rq[4] = {4 * ty, 4 * ty + 1, 4 * ty + 2, 4 * ty + 3};
  const int rk[4] = {tx, tx + 16, tx + 32, tx + 48};
  // dQ slice: query rows 4ty + i, columns tx * CPT ...
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  int n_k_tiles = n_tiles;
  if (causal) n_k_tiles = min(n_k_tiles, tile + 1);
  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // q/dO/stats are written; the last tile is consumed
    load_tile<DH>(ks, k + base, k0, t);
    load_tile<DH>(vs, v + base, k0, t);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dots<DH>(qs, ks, rq, rk, s);
    tile_dots<DH>(dos, vs, rq, rk, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + rk[j];
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int query = q0 + rq[i];
        const bool live = key < t && (!causal || key <= query);
        const float p = live ? expf(s[i][j] * scale - lse_s[rq[i]]) : 0.f;
        ds[i] = p * (dp[i][j] - d_s[rq[i]]);
      }
      *reinterpret_cast<float4*>(dst + rk[j] * LDP + 4 * ty) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dQ += dS K over this tile's keys
#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      const float4 w = *reinterpret_cast<const float4*>(dst + c * LDP + 4 * ty);
      float kr[CPT];
      load_vec<CPT>(ks + c * LD + tx * CPT, kr);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        acc[0][cc] = fmaf(w.x, kr[cc], acc[0][cc]);
        acc[1][cc] = fmaf(w.y, kr[cc], acc[1][cc]);
        acc[2][cc] = fmaf(w.z, kr[cc], acc[2][cc]);
        acc[3][cc] = fmaf(w.w, kr[cc], acc[3][cc]);
      }
    }
  }
  store_rows<DH, CPT>(dq + base, acc, q0 + 4 * ty, tx * CPT, t, scale);
}

// --- dK/dV on the tensor cores (3xTF32 mma.sync, mma_tf32x3.cuh) ---

constexpr int DKV_KEYS = 64;  // key rows per block, 16 per warp
constexpr int DKV_THREADS = 128;

template <int DH>
struct Dkv {
  // query rows per double-buffered tile: 8 at dh 128 keeps the
  // accumulators in registers
  static constexpr int BQ = DH == 128 ? 8 : 32;
  static constexpr int LD = DH + 4;  // shared-memory row stride
  static constexpr int KV = 0;       // K, then V: [DKV_KEYS][LD] each
  static constexpr int Q = 2 * DKV_KEYS * LD;  // [stage][Q, dO][BQ][LD]
  static constexpr int O = Q + 4 * BQ * LD;    // [BQ][LD]
  static constexpr int LSE = O + BQ * LD;      // [stage][BQ]
  static constexpr int D = LSE + 2 * BQ;       // [BQ]
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
  gordo_mma::load_tile_async<BQ, DH, DKV_THREADS>(qs, q, q0, t);
  gordo_mma::load_tile_async<BQ, DH, DKV_THREADS>(qs + BQ * C::LD, dout, q0, t);
  gordo_mma::load_tile_async<BQ, DH, DKV_THREADS>(smem + C::O, o, q0, t);
  if (threadIdx.x < BQ) {
    const int row = q0 + static_cast<int>(threadIdx.x);
    gordo_mma::cp_async4(smem + C::LSE + stage * BQ + threadIdx.x,
                         lse + (row < t ? row : 0), row < t);
  }
  gordo_mma::cp_async_commit();
}

// acc (16 rows x BQ columns) += A (16 rows of `a_rows`, [row][DH]) times
// B^T (BQ rows of `b_rows`, [col][DH]): S^T = K Q^T and dP^T = V dO^T,
// two k-steps per fresh sum
template <int DH>
__device__ __forceinline__ void product_nt(float (&acc)[Dkv<DH>::BQ / 8][4],
                                           const float* a_rows, const float* b_rows,
                                           int g, int tq) {
  using namespace gordo_mma;
  constexpr int LD = Dkv<DH>::LD;
#pragma unroll 2
  for (int kk = 0; kk < DH / 8; kk += 2) {
    const FragA a[2] = {load_a(a_rows + 8 * kk, LD, g, tq),
                        load_a(a_rows + 8 * kk + 8, LD, g, tq)};
#pragma unroll
    for (int n = 0; n < Dkv<DH>::BQ / 8; ++n) {
      const FragB b[2] = {load_b_nk(b_rows + 8 * n * LD + 8 * kk, LD, g, tq),
                          load_b_nk(b_rows + 8 * n * LD + 8 * kk + 8, LD, g, tq)};
      mma_3xtf32_sum<2>(acc[n], a, b);
    }
  }
}

// acc (16 rows x DH) += X (16 rows x BQ, accumulator fragments `x`) times
// the BQ rows of `rows` ([row][DH]): dV += P^T dO and dK += dS^T Q
template <int DH>
__device__ __forceinline__ void product_nn(float (&acc)[DH / 8][4],
                                           const float (&x)[Dkv<DH>::BQ / 8][4],
                                           const float* rows, int g, int tq) {
  using namespace gordo_mma;
  constexpr int LD = Dkv<DH>::LD;
  constexpr int NT = Dkv<DH>::BQ / 8;
  FragA a[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) a[n] = acc_to_a(x[n]);
#pragma unroll
  for (int m = 0; m < DH / 8; ++m) {
    FragB b[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) b[n] = load_b_kn_paired(rows + 8 * n * LD + 8 * m, LD, g, tq);
    mma_3xtf32_sum<NT>(acc[m], a, b);
  }
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
  using namespace gordo_mma;
  using C = Dkv<DH>;
  constexpr int LD = C::LD;
  constexpr int BQ = C::BQ;
  constexpr int NT = BQ / 8;      // 8-query column groups
  constexpr int OT = DH / 8;      // 8-column groups of dK and dV
  constexpr int TPR = DKV_THREADS / BQ;  // threads per row computing D
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int tq = threadIdx.x % 4;
  // under causal masking the first key tiles see the most queries: first
  const int tile = static_cast<int>(blockIdx.x % n_tiles);
  const size_t bh = blockIdx.x / n_tiles;
  const int k0 = tile * DKV_KEYS;
  const int w0 = k0 + 16 * warp;  // the warp's first key row
  const size_t base = bh * static_cast<size_t>(t) * DH;
  const float* qb = q + base;
  const float* gb = dout + base;
  const float* ob = o + base;
  const float* lb = lse + bh * t;

  const int n_q_tiles = (t + BQ - 1) / BQ;
  const int first = causal ? k0 / BQ : 0;  // the diagonal tile
  load_tile_async<DKV_KEYS, DH, DKV_THREADS>(smem + C::KV, k + base, k0, t);
  load_tile_async<DKV_KEYS, DH, DKV_THREADS>(smem + C::KV + DKV_KEYS * LD, v + base,
                                             k0, t);
  load_query_tile<DH>(smem, 0, qb, gb, ob, lb, first * BQ, t);
  const float* kw = smem + C::KV + 16 * warp * LD;
  const float* vw = kw + DKV_KEYS * LD;
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
__global__ void __launch_bounds__(DKV_THREADS) flash_bwd_dkv_f32(DKV_PARAMS) {
  dkv_body<DH>(q, k, v, o, lse, dout, dk, dv, t, n_tiles, scale, causal);
}

// dh 64, the training shape, with two resident blocks per SM asked of the
// register allocator (the hint makes the other head dims' code worse)
__global__ void __launch_bounds__(DKV_THREADS, 2) flash_bwd_dkv_f32_dh64(DKV_PARAMS) {
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

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int bh, int t, int smem, unsigned* n_blocks,
                    int* n_tiles) {
  *n_tiles = (t + TILE - 1) / TILE;
  const long long blocks = static_cast<long long>(bh) * *n_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  *n_blocks = static_cast<unsigned>(blocks);
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  return cudaSuccess;
}

template <int DH>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* o, const float* lse, const float* dout,
                      float* dq, int bh, int t, float scale, int causal,
                      cudaStream_t stream) {
  const int smem = smem_floats<DH>() * static_cast<int>(sizeof(float));
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
  kernel<<<n_blocks, DKV_THREADS, smem, stream>>>(
      q, k, v, o, lse, dout, dk, dv, t, n_tiles, scale, causal);
  return cudaGetLastError();
}

template <int DH>
cudaError_t dkv_occupancy(int* smem, int* blocks_per_sm) {
  *smem = Dkv<DH>::SMEM_FLOATS * static_cast<int>(sizeof(float));
  if (*smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dkv_kernel<DH>(), cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, dkv_kernel<DH>(), DKV_THREADS, *smem);
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

// The dK/dV kernel's dynamic shared memory (bytes) and resident blocks per
// SM at head dim `dh`, for reports. Returns the CUDA error code.
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
