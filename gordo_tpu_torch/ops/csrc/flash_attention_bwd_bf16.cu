// Flash-attention backward for bf16 inputs on NVIDIA Hopper (sm_90a), on
// the tensor cores in bf16 with float32 sums: two kernels, dQ and dK/dV,
// launched one after the other on one stream.
//
// Replaces the two TPU kernels of `_flash_backward` in
// gordo_tpu/ops/pallas_kernels/flash_attention.py for bf16 q, k, v, o and
// dO (as the JAX package sends them under `compute_dtype: bfloat16`); lse
// is float32, from the forward:
// - flash_bwd_dq_bf16 replaces `_flash_dq_kernel`: for each 64-row query
//   tile, loop over key tiles up to the diagonal, recompute
//   P = exp(S - lse), D = rowsum(dO * O), dS = P * (dP - D) with
//   dP = dO V^T, and accumulate dQ += dS K * scale;
// - flash_bwd_dkv_bf16 replaces `_flash_dkv_kernel`: for each 128-row key
//   tile, loop over query tiles from the diagonal on, and accumulate
//   dV += P^T dO and dK += dS^T Q * scale.
// As the TPU kernels do, they compute in float32 and write dq, dk and dv in
// bf16; D is taken from the stored bf16 O, recomputed per query tile.
// Products of two bf16 operands (S, dP and their transposes) are exact
// products with float32 sums; P and dS, float32, are split into three bf16
// operands that hold all their bits. Each output element is written by
// exactly one thread, with no atomics, so two runs give bit-identical
// results.
//
// What bounds them on this card: at the training shape (BH 128, T 512,
// dh 64, causal) dQ moves q/k/v/o/dO/dQ at 2 bytes and lse at 4 (50.6 MB,
// 15.1 us at 3.35 TB/s) and does 10 dh FLOP per visible (query, key) pair
// (S and dP once, dS K for each of dS's three parts: 1.1e10 FLOP, 10.9 us
// at 989 TFLOP/s of bf16); dK/dV moves 7 tensors (59.0 MB, 17.6 us) and
// does 16 dh FLOP per pair (S^T and dP^T once, P^T dO and dS^T Q three
// times: 1.7e10 FLOP, 17.4 us). Both are bound by bytes and products
// alike, and at these sizes a launch costs about as much.
//
// dQ (mma_bf16.cuh; the design of the float32 kernels in
// flash_attention_bwd.cu with bf16 fragments): one block of 4 warps per
// (bh, 64-row query tile), each warp an m16 strip of mma.sync; Q and dO of
// the block's rows are loaded once, K and V tiles of 32 key rows are
// double-buffered with cp.async, rows at or past T zero-filled; each
// thread reads the lse and computes D of its two rows from global memory
// while they land; every operand fragment is loaded with ldmatrix
// (transposed where the product needs it), so P and dS never leave
// registers; S and dP sum each 16-deep step in a fresh accumulator.
//
// dK/dV (wgmma_bf16.cuh), the same design as the bf16 forward
// (flash_attention_bf16.cu): wgmma, the only path to the tensor cores' full
// rate, and TMA, which moves tiles without the compute threads:
// - one producer warpgroup (one thread issues TMA loads; setmaxnreg gives
//   its registers to the consumers) and two consumer warpgroups of 64 key
//   rows each that share every Q/dO/O tile; K and V are loaded once;
// - Q, dO and O tiles of 64 query rows (32 at dh 128) come through a ring
//   of two stages with full and empty mbarriers, from the diagonal on,
//   through 3-D tensor maps (dh, T, BH) that zero-fill rows at or past T
//   of each head;
// - S^T = K Q^T and dP^T = V dO^T are SS products (all four operands
//   K-major, as stored); while they run the consumers compute D from the
//   shared O and dO tiles and read the lse;
// - P^T and dS^T stay in registers: split in three by truncation, they are
//   the A operands of the RS products dV += P^T dO and dK += dS^T Q, with
//   dO and Q as MN-major B operands, so nothing is transposed in memory;
// - S^T and dP^T each sum a tile's k16 steps in one chain; dV sums over the
//   whole query loop in its own accumulator, dK a query tile at a time in a
//   fresh one added in float32: the fastest choices on the card, each held
//   to the gates, beside their alternatives in
//   scripts/torch_bf16_variants.py;
// - the tiles that see the most queries are scheduled first, and only the
//   tiles that cross the diagonal or T are masked.
// Any T >= 1 works; dh is 16, 32, 64 or 128 (a template parameter).

#include <cuda_runtime.h>
#include <limits.h>

#include <chrono>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

using namespace gordo_bf16;

constexpr int TILE = 64;      // a dQ block's query rows
constexpr int THREADS = 128;  // dQ: 4 warps, 16 rows each

// --- dQ ---

template <int DH>
struct Dq {
  static constexpr int BK = 32;             // key rows per K/V tile
  static constexpr int LD = DH + 8;         // shared-memory row stride
  static constexpr int Q = 0;               // Q, then dO: [TILE][LD] each
  static constexpr int KV = 2 * TILE * LD;  // [stage][K, V][BK][LD]
  static constexpr int SMEM_BYTES = (KV + 4 * BK * LD) * static_cast<int>(sizeof(bf16));
};

// this thread's part of rowsum(dO * O) of `row` (0 at or past t), in
// float32: 16-byte chunks tq, tq + 4, ...; the four threads of a quad hold
// one row's parts
template <int DH>
__device__ __forceinline__ float row_dot_part(const bf16* o, const bf16* dout, int row,
                                              int t, int tq) {
  float d = 0.f;
  if (row < t) {
    const uint4* o8 = reinterpret_cast<const uint4*>(o + static_cast<size_t>(row) * DH);
    const uint4* g8 = reinterpret_cast<const uint4*>(dout + static_cast<size_t>(row) * DH);
#pragma unroll
    for (int c = tq; c < DH / 8; c += 4) d = dot8(o8[c], g8[c], d);
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
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const float* __restrict__ lse, const bf16* __restrict__ dout,
                  bf16* __restrict__ dq, int t, int n_tiles, float scale, int causal) {
  using C = Dq<DH>;
  constexpr int LD = C::LD;
  constexpr int BK = C::BK;
  constexpr int NT = BK / 8;  // 8-key column groups of S, dP and dS
  constexpr int OT = DH / 8;  // 8-column groups of dQ
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  // heaviest causal tiles (the last query rows) go first
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x % n_tiles);
  const size_t bh = blockIdx.x / n_tiles;
  const int q0 = tile * TILE;
  const int w0 = q0 + 16 * warp;  // the warp's first query row
  const size_t base = bh * static_cast<size_t>(t) * DH;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

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
  const bf16* qw = smem + C::Q + 16 * warp * LD;
  const bf16* gw = qw + TILE * LD;  // the warp's dO rows

  float acc[OT][4];
#pragma unroll
  for (int m = 0; m < OT; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int stage = kt & 1;
    cp_async_wait<0>();
    // tile kt has landed, and every warp is done with the other stage
    __syncthreads();
    if (kt + 1 < n_k_tiles) {
      bf16* next = smem + C::KV + (stage ^ 1) * 2 * BK * LD;
      load_tile_async<BK, DH, THREADS>(next, kb, (kt + 1) * BK, t);
      load_tile_async<BK, DH, THREADS>(next + BK * LD, vb, (kt + 1) * BK, t);
      cp_async_commit();
    }
    const bf16* ks = smem + C::KV + stage * 2 * BK * LD;
    const bf16* vs = ks + BK * LD;
    const int k0 = kt * BK;
    if (causal && w0 + 15 < k0) continue;  // warp-uniform: all masked

    // S = Q K^T and dP = dO V^T
    float s[NT][4], ds[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = ds[n][e] = 0.f;
    }
    product_nt<DH, LD>(s, qw, ks, lane);
    product_nt<DH, LD>(ds, gw, vs, lane);
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
    product_nn<DH, LD>(acc, ds, ks, lane);  // dQ += dS K (times scale below)
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w0 + g + 8 * h;
    if (row >= t) continue;
    bf16* dst = dq + base + static_cast<size_t>(row) * DH + 2 * tq;
#pragma unroll
    for (int m = 0; m < OT; ++m) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * m) =
          to_bf16x2(acc[m][2 * h] * scale, acc[m][2 * h + 1] * scale);
    }
  }
}

// --- dK/dV: warp-specialised, TMA-fed, wgmma (wgmma_bf16.cuh) ---

namespace dkv {

using namespace gordo_wgmma;

constexpr int BLOCK_N = 128;  // key rows of a block, 64 per consumer
constexpr int CONSUMERS = 2;  // consumer warpgroups
using R = Regs<CONSUMERS>;
constexpr int THREADS = R::THREADS;
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Dkv {
  using T = Tile<DH>;
  // query rows of a Q/dO/O tile: 32 at dh 128 keeps the consumers'
  // accumulators in registers
  static constexpr int BQ = DH == 128 ? 32 : 64;
  static constexpr int STAGES = 2;
  static constexpr int KV_BYTES = BLOCK_N * DH * 2;  // K or V
  static constexpr int Q_BYTES = BQ * DH * 2;        // one of Q, dO, O
  // byte offsets from the 1024-aligned base of shared memory
  static constexpr int K = 0;
  static constexpr int V = K + KV_BYTES;
  static constexpr int Q = V + KV_BYTES;              // [STAGES][Q, dO, O]
  // float [CONSUMERS][2][D, lse * log2(e)][BQ]: each consumer's copy of
  // the tile's D and lse, double-buffered
  static constexpr int D = Q + STAGES * 3 * Q_BYTES;
  static constexpr int BARS = D + CONSUMERS * 2 * 2 * BQ * 4;
  // kv_full, full[STAGES], empty[STAGES]; 1024 bytes of alignment slack
  static constexpr int SMEM_BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

// One block per (bh, 128-row key tile), the tiles that see the most
// queries under causal masking first. The producer loads K and V once,
// then Q, dO and O tiles of BQ rows from the diagonal on through a ring of
// two stages; each consumer warpgroup runs, per query tile, S^T = K Q^T and
// dP^T = V dO^T (SS), computes D = rowsum(dO O) of the tile from shared
// memory while they run, then P^T = exp(S^T scale - lse) and
// dS^T = P^T (dP^T - D) in registers, and dV += P^T dO, dK += dS^T Q (RS,
// three parts each, dO and Q MN-major). dK and dV of a key are written by
// exactly one thread, with no atomics.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap o_map,
                   const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int t, int bh_count,
                   float scale, int causal) {
  using C = Dkv<DH>;
  using L = typename C::T;
  constexpr int BQ = C::BQ;
  constexpr int STAGES = C::STAGES;
  constexpr int NC = BQ / 16;  // k-chunks of P^T and dS^T
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  const int tile = static_cast<int>(blockIdx.x) / bh_count;
  const int bh = static_cast<int>(blockIdx.x) - tile * bh_count;
  const int k0 = tile * BLOCK_N;
  const int n_q_tiles = (t + BQ - 1) / BQ;
  const int first = causal ? k0 / BQ : 0;  // the first query tile that sees a key

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // producer: one thread issues every load
    setmaxnreg_dec<R::PRODUCER>();
    if (threadIdx.x != 128 * CONSUMERS) return;
    mbar_arrive_expect_tx(kv_full, 2 * C::KV_BYTES);
#pragma unroll
    for (int p = 0; p < L::PANELS; ++p) {
      const int off = p * BLOCK_N * L::RB;
      tma_load_3d(smem + C::K + off, &k_map, kv_full, p * L::COLS, k0, bh);
      tma_load_3d(smem + C::V + off, &v_map, kv_full, p * L::COLS, k0, bh);
    }
    Ring<STAGES> ring;
    for (int qt = first; qt < n_q_tiles; ++qt, ring.advance()) {
      const int s = ring.stage;
      mbar_wait(&empty[s], ring.phase ^ 1);
      mbar_arrive_expect_tx(&full[s], 3 * C::Q_BYTES);
      uint8_t* stage = smem + C::Q + s * 3 * C::Q_BYTES;
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p) {
        const int off = p * BQ * L::RB;
        tma_load_3d(stage + off, &q_map, &full[s], p * L::COLS, qt * BQ, bh);
        tma_load_3d(stage + C::Q_BYTES + off, &do_map, &full[s], p * L::COLS, qt * BQ, bh);
        tma_load_3d(stage + 2 * C::Q_BYTES + off, &o_map, &full[s], p * L::COLS, qt * BQ, bh);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns key rows k0 + 64 wg .. k0 + 64 wg + 63
  setmaxnreg_inc<R::CONSUMER>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int tq = tid % 4;
  const int kw0 = k0 + 64 * wg;
  const int key0 = kw0 + 16 * warp + g;  // this thread's key rows: key0, key0 + 8
  const float scale_log2 = scale * LOG2E;
  const float* lse_h = lse + static_cast<size_t>(bh) * t;
  float* d_s = reinterpret_cast<float*>(smem + C::D) + wg * 4 * BQ;
  const uint32_t k_tile = smem_u32(smem + C::K);
  const uint32_t v_tile = smem_u32(smem + C::V);
  const auto ka = [&](int kk) { return L::k_major(k_tile, BLOCK_N, 64 * wg, kk); };
  const auto va = [&](int kk) { return L::k_major(v_tile, BLOCK_N, 64 * wg, kk); };

  float dka[DH / 2], dva[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(kv_full, 0);

  Ring<STAGES> ring;
  for (int qt = first, done = 0; qt < n_q_tiles; ++qt, ring.advance()) {
    const int s = ring.stage;
    const int q0 = qt * BQ;
    mbar_wait(&full[s], ring.phase);
    // warpgroup-uniform: keys past T, or every query before the keys
    if (kw0 < t && !(causal && q0 + BQ - 1 < kw0)) {
      const uint8_t* stage = smem + C::Q + s * 3 * C::Q_BYTES;
      const uint32_t q_tile = smem_u32(stage);
      const uint32_t do_tile = q_tile + C::Q_BYTES;
      const auto qb = [&](int kk) { return L::k_major(q_tile, BQ, 0, kk); };
      const auto gb = [&](int kk) { return L::k_major(do_tile, BQ, 0, kk); };
      float sa[BQ / 2], dp[BQ / 2];  // S^T and dP^T, 64 keys x BQ queries
      fence_regs(sa);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) Wgmma<BQ>::ss(sa, ka(kk), qb(kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) Wgmma<BQ>::ss(dp, va(kk), gb(kk), kk > 0);
      wgmma_commit();
      // while they run: D of the tile's queries from the shared O and dO
      // tiles, TPR threads a row, and their lse
      float* d_tile = d_s + (done & 1) * 2 * BQ;  // D, then lse * log2(e)
      {
        constexpr int TPR = 128 / BQ;
        const int r = tid / TPR;
        float d = 0.f;
#pragma unroll
        for (int ch = tid % TPR; ch < DH / 8; ch += TPR) {
          const uint32_t at = L::offset(BQ, r, 8 * ch);
          d = dot8(*reinterpret_cast<const uint4*>(stage + 2 * C::Q_BYTES + at),
                   *reinterpret_cast<const uint4*>(stage + C::Q_BYTES + at), d);
        }
#pragma unroll
        for (int step = 1; step < TPR; step *= 2) d += __shfl_xor_sync(0xffffffffu, d, step);
        if (tid % TPR == 0) d_tile[r] = d;
        if (tid < BQ) d_tile[BQ + tid] = q0 + tid < t ? lse_h[q0 + tid] * LOG2E : 0.f;
      }
      named_barrier(1 + wg, 128);  // D and lse of the tile are written
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(dp);

      // P^T = exp(S^T scale - lse), 0 where masked; dS^T = P^T (dP^T - D)
      const bool mask = q0 + BQ > t || (causal && kw0 + 63 > q0);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int col = 8 * (i / 4) + 2 * tq + (i & 1);
        float p = exp2_approx(fmaf(sa[i], scale_log2, -d_tile[BQ + col]));
        if (mask) {
          const int key = key0 + ((i & 2) ? 8 : 0);
          if (!(q0 + col < t && (!causal || key <= q0 + col))) p = 0.f;
        }
        sa[i] = p;
        dp[i] = p * (dp[i] - d_tile[col]);
      }
      const auto gmn = [&](int c) { return L::mn_major(do_tile, BQ, c); };
      const auto qmn = [&](int c) { return L::mn_major(q_tile, BQ, c); };
      // dV += P^T dO, in dV's own accumulator
      uint32_t pa[NC][3][4];
      split_to_a<NC>(sa, pa);
      fence_regs(dva);
      wgmma_fence();
      rs_product<DH, NC>(dva, pa, gmn, true);
      wgmma_commit();
      // dK += dS^T Q (times scale below), in a fresh accumulator added in
      // float32, once dV's product has read P^T's parts: the consumers'
      // registers hold one split operand at a time
      wgmma_wait<0>();
      fence_regs(dva);
      fence_split(pa);
      uint32_t da[NC][3][4];
      split_to_a<NC>(dp, da);
      {
        float f[DH / 2];
        rs_fresh<DH, NC>(f, da, qmn);
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) dka[i] += f[i];
      }
      fence_split(da);
      ++done;
    }
    mbar_arrive_warp(&empty[s]);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key0 + 8 * half;
    if (key >= t) continue;
    const size_t row = (static_cast<size_t>(bh) * t + key) * DH + 2 * tq;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int i = 4 * n + 2 * half;
      *reinterpret_cast<__nv_bfloat162*>(dk + row + 8 * n) =
          __floats2bfloat162_rn(dka[i] * scale, dka[i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + 8 * n) =
          __floats2bfloat162_rn(dva[i], dva[i + 1]);
    }
  }
}

// the five tensor maps of q, k, v, o, dO
template <int DH>
cudaError_t encode(CUtensorMap (&maps)[5], const bf16* q, const bf16* k, const bf16* v,
                   const bf16* o, const bf16* dout, int bh, int t) {
  constexpr int BQ = Dkv<DH>::BQ;
  cudaError_t err = encode_rows(&maps[0], q, bh, t, DH, BQ);
  if (err == cudaSuccess) err = encode_rows(&maps[1], k, bh, t, DH, BLOCK_N);
  if (err == cudaSuccess) err = encode_rows(&maps[2], v, bh, t, DH, BLOCK_N);
  if (err == cudaSuccess) err = encode_rows(&maps[3], o, bh, t, DH, BQ);
  if (err == cudaSuccess) err = encode_rows(&maps[4], dout, bh, t, DH, BQ);
  return err;
}

template <int DH>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                   const float* lse, const bf16* dout, bf16* dk, bf16* dv, int bh, int t,
                   float scale, int causal, cudaStream_t stream) {
  const long long n_blocks = static_cast<long long>(bh) * ((t + BLOCK_N - 1) / BLOCK_N);
  if (n_blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  constexpr int smem = Dkv<DH>::SMEM_BYTES;
  CUtensorMap maps[5];
  int sms;
  cudaError_t err = encode<DH>(maps, q, k, v, o, dout, bh, t);
  if (err == cudaSuccess) err = prepare_kernel<flash_bwd_dkv_bf16<DH>>(smem, R::LAUNCH, &sms);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_bf16<DH><<<static_cast<unsigned>(n_blocks), THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], lse, dk, dv, t, bh, scale, causal);
  return cudaGetLastError();
}

template <int DH>
cudaError_t occupancy(int* smem, int* blocks_per_sm) {
  *smem = Dkv<DH>::SMEM_BYTES;
  int sms;
  const cudaError_t err = prepare_kernel<flash_bwd_dkv_bf16<DH>>(*smem, R::LAUNCH, &sms);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, flash_bwd_dkv_bf16<DH>,
                                                       THREADS, *smem);
}

}  // namespace dkv

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
cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                      const float* lse, const bf16* dout, bf16* dq, int bh, int t,
                      float scale, int causal, cudaStream_t stream) {
  const int smem = Dq<DH>::SMEM_BYTES;
  unsigned n_blocks;
  int n_tiles;
  const cudaError_t err = prepare(flash_bwd_dq_bf16<DH>, bh, t, smem, &n_blocks, &n_tiles);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_bf16<DH><<<n_blocks, THREADS, smem, stream>>>(
      q, k, v, o, lse, dout, dq, t, n_tiles, scale, causal);
  return cudaGetLastError();
}

// `kernel`'s dynamic shared memory (`bytes`) and its resident blocks per SM
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int bytes, int* smem, int* blocks_per_sm) {
  *smem = bytes;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, THREADS,
                                                       bytes);
}

template <int DH>
cudaError_t dq_occupancy(int* smem, int* blocks_per_sm) {
  return occupancy(flash_bwd_dq_bf16<DH>, Dq<DH>::SMEM_BYTES, smem, blocks_per_sm);
}

}  // namespace

// q, k, v, o, dout, dq: (bh, t, dh) contiguous bf16, 16-byte aligned; lse:
// (bh, t) float32 from the forward. Launches on `stream` and does not
// synchronise. Returns the CUDA error code of the launch (0 on success).
extern "C" int gordo_flash_attention_backward_dq_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* dq, int bh, int t, int dh, float scale, int causal,
    void* stream) {
  if (bh <= 0 || t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(o);
  const float* lf = static_cast<const float*>(lse);
  const bf16* gb = static_cast<const bf16*>(dout);
  bf16* dqb = static_cast<bf16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 16: err = launch_dq<16>(qb, kb, vb, ob, lf, gb, dqb, bh, t, scale, causal, s); break;
    case 32: err = launch_dq<32>(qb, kb, vb, ob, lf, gb, dqb, bh, t, scale, causal, s); break;
    case 64: err = launch_dq<64>(qb, kb, vb, ob, lf, gb, dqb, bh, t, scale, causal, s); break;
    case 128: err = launch_dq<128>(qb, kb, vb, ob, lf, gb, dqb, bh, t, scale, causal, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// As above, writing dk and dv: (bh, t, dh) contiguous bf16.
extern "C" int gordo_flash_attention_backward_dkv_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* dk, void* dv, int bh, int t, int dh, float scale,
    int causal, void* stream) {
  if (bh <= 0 || t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(o);
  const float* lf = static_cast<const float*>(lse);
  const bf16* gb = static_cast<const bf16*>(dout);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 16: err = dkv::launch<16>(qb, kb, vb, ob, lf, gb, dkb, dvb, bh, t, scale, causal, s); break;
    case 32: err = dkv::launch<32>(qb, kb, vb, ob, lf, gb, dkb, dvb, bh, t, scale, causal, s); break;
    case 64: err = dkv::launch<64>(qb, kb, vb, ob, lf, gb, dkb, dvb, bh, t, scale, causal, s); break;
    case 128: err = dkv::launch<128>(qb, kb, vb, ob, lf, gb, dkb, dvb, bh, t, scale, causal, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The dQ kernel's dynamic shared memory (bytes) and resident blocks per SM
// at head dim `dh`, for reports. Returns the CUDA error code.
extern "C" int gordo_flash_attention_backward_dq_bf16_occupancy(int dh, int* smem_bytes,
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
extern "C" int gordo_flash_attention_backward_dkv_bf16_occupancy(int dh, int* smem_bytes,
                                                                int* blocks_per_sm) {
  switch (dh) {
    case 16: return static_cast<int>(dkv::occupancy<16>(smem_bytes, blocks_per_sm));
    case 32: return static_cast<int>(dkv::occupancy<32>(smem_bytes, blocks_per_sm));
    case 64: return static_cast<int>(dkv::occupancy<64>(smem_bytes, blocks_per_sm));
    case 128: return static_cast<int>(dkv::occupancy<128>(smem_bytes, blocks_per_sm));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The host time of encoding the dK/dV kernel's five tensor maps at
// (bh, t, dh), the mean over `reps` encodings, in microseconds, for reports;
// the maps point at `base` and are not used. Returns the CUDA error code.
extern "C" int gordo_flash_attention_backward_dkv_bf16_encode_us(const void* base, int bh, int t,
                                                                int dh, int reps, float* us) {
  if (reps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* p = static_cast<const bf16*>(base);
  CUtensorMap maps[5];
  const auto start = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    cudaError_t err;
    switch (dh) {
      case 16: err = dkv::encode<16>(maps, p, p, p, p, p, bh, t); break;
      case 32: err = dkv::encode<32>(maps, p, p, p, p, p, bh, t); break;
      case 64: err = dkv::encode<64>(maps, p, p, p, p, p, bh, t); break;
      case 128: err = dkv::encode<128>(maps, p, p, p, p, p, bh, t); break;
      default: err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const std::chrono::duration<double, std::micro> spent = std::chrono::steady_clock::now() - start;
  *us = static_cast<float>(spent.count() / reps);
  return 0;
}
