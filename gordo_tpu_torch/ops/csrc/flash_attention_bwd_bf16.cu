// Flash-attention backward for bf16 inputs on NVIDIA Hopper (sm_90a), on
// the tensor cores in bf16 with float32 sums: two kernels, dQ and dK/dV,
// launched one after the other on one stream.
//
// Replaces the two TPU kernels of `_flash_backward` in
// gordo_tpu/ops/pallas_kernels/flash_attention.py for bf16 q, k, v, o and
// dO (as the JAX package sends them under `compute_dtype: bfloat16`); lse
// is float32, from the forward:
// - flash_bwd_dq_bf16 replaces `_flash_dq_kernel`: for each 64-row query
//   slice, loop over key tiles up to the diagonal, recompute
//   P = exp(S - lse), D = rowsum(dO * O), dS = P * (dP - D) with
//   dP = dO V^T, and accumulate dQ += dS K * scale;
// - flash_bwd_dkv_bf16 replaces `_flash_dkv_kernel`: for each 128-row key
//   tile, loop over query tiles from the diagonal on, and accumulate
//   dV += P^T dO and dK += dS^T Q * scale.
// As the TPU kernels do, they compute in float32 and write dq, dk and dv in
// bf16; D is taken from the stored bf16 O. Products of two bf16 operands
// (S, dP and their transposes) are exact products with float32 sums; P and
// dS, float32, are split into three bf16 operands that hold all their bits
// (wgmma_bf16.cuh). Each output element is written by exactly one thread,
// with no atomics, so two runs give bit-identical results.
//
// What bounds them on this card: at the training shape (BH 128, T 512,
// dh 64, causal) dQ moves q/k/v/o/dO/dQ at 2 bytes and lse at 4 (50.6 MB,
// 15.1 us at 3.35 TB/s) and does 10 dh FLOP per visible (query, key) pair
// (S and dP once, dS K for each of dS's three parts: 1.1e10 FLOP, 10.9 us
// at 989 TFLOP/s of bf16); dK/dV moves 7 tensors (59.0 MB, 17.6 us) and
// does 16 dh FLOP per pair (S^T and dP^T once, P^T dO and dS^T Q three
// times: 1.7e10 FLOP, 17.4 us). Both are bound by bytes and products
// alike, and at these sizes a launch costs about as much. Beside the
// products, each score costs an exponential and the split of dS about
// eleven integer and float instructions.
//
// Both run on wgmma, the only path to the tensor cores' full rate, fed by
// TMA, which moves tiles without the compute threads, in warp-specialised
// blocks (wgmma_bf16.cuh): one producer warpgroup (one thread issues TMA
// loads; setmaxnreg gives its registers to the consumers) and two consumer
// warpgroups of 64 rows each that share every tile the producer loads,
// through rings of stages with full and empty mbarriers and 3-D tensor
// maps (dh, T, BH) that zero-fill rows at or past T of each head. Only the
// tiles that cross the diagonal or T are masked.
//
// dQ, on the design of the bf16 forward (flash_attention_bf16.cu):
// - one persistent block per SM walks over the (bh, 128-row query tile)
//   work in the forward's order; Q and dO of the tile are loaded once, into
//   one of two buffers, so the next work's load runs under this one;
// - K and V tiles of 64 keys (32 from dh 192 on, for registers and shared
//   memory, where the Q and dO buffer is single) come through a ring of
//   three stages; a warpgroup skips the key tiles past its diagonal;
// - D = rowsum(dO O) is the diagonal of dO O^T, an SS product over the
//   work's O, which comes through the ring as one more stage: summed on
//   the tensor cores as dP is, D cancels dP exactly where the float64
//   result does (a query that sees one key, whose O is that key's V; D
//   from float32 fmas left such dQ elements up to 1.9e-6 off 0, outside
//   the gate's 1e-6);
// - S = Q K^T and dP = dO V^T are SS products (all four operands K-major,
//   as stored), each summing a tile's k16 steps in one chain; while the
//   first run, each thread reads the lse of its two rows;
// - dS stays in registers: split in three by truncation, it is the A
//   operand of the RS product dQ += dS K, with the same K tile as the
//   MN-major B operand (two descriptors of one tile, nothing transposed),
//   summed over the whole key loop in dQ's own accumulator;
// - the loop is software-pipelined: S and dP of key tile j are issued with
//   dS K of tile j - 1 behind them, and tile j's dS is computed while that
//   product is on the tensor cores.
// The chain depths, the D product, the ring's depth and the schedule were
// held to the gates and timed on the card against their alternatives,
// which are patches in scripts/torch_bf16_variants.py (PERF.md section 6).
//
// dK/dV, the same design with the roles of queries and keys exchanged:
// - one block per 128-row key tile; K and V are loaded once, and Q, dO and
//   O tiles of 64 query rows (32 from dh 128 on) come through a ring of two
//   stages, from the diagonal on;
// - D = rowsum(dO O): from dh 128 on (32-query tiles) the diagonal of
//   O dO^T on the tensor cores, summed as dP^T is, as dQ takes it; below,
//   float32 fmas over the shared tiles;
// - above dh 128 the dK and dV accumulators of all columns would not fit
//   the registers: a key tile is split over blocks of 64 columns each (128
//   at dh 256; DC), each of which computes the whole S^T and dP^T;
// - S^T = K Q^T and dP^T = V dO^T are SS products; while they run the
//   consumers read the lse (and below dh 128 compute D);
// - P^T and dS^T stay in registers: split in three by truncation, they are
//   the A operands of the RS products dV += P^T dO and dK += dS^T Q, with
//   dO and Q as MN-major B operands, so nothing is transposed in memory;
// - S^T and dP^T each sum a tile's k16 steps in one chain (S^T from dh 192
//   on one chain a 64-column panel, added in float32: a longer chain's
//   truncations reached dV beyond the gate); dV sums over the
//   whole query loop in its own accumulator, dK a query tile at a time in a
//   fresh one added in float32 (from 128 columns a block in its own too:
//   the fresh one spilled): the fastest choices on the card, each held to
//   the gates, beside their alternatives in scripts/torch_bf16_variants.py
//   (and at the wide dims in scripts/torch_bf16_dkv_layouts.py);
// - the tiles that see the most queries are scheduled first.
// Any T >= 1 works; dh is 16, 32 or any multiple of 8 from 64 to 256, each
// run by the instantiation of its class (wgmma_bf16.cuh: whole 64-column
// panels, the columns past dh zero-filled by TMA and not stored, the scale
// the caller's 1/sqrt(dh)).

#include <cuda_runtime.h>
#include <limits.h>

#include <chrono>

#include "wgmma_bf16.cuh"

namespace {

using namespace gordo_wgmma;

// --- dQ: persistent, warp-specialised, TMA-fed, wgmma (wgmma_bf16.cuh) ---

namespace dq {

// consumer warpgroups, 64 query rows each: a work's O takes the slots of
// the K/V ring, one consumer's rows in each of the two slots of a stage (in
// both slots of its own stage at 32-key tiles)
constexpr int CONSUMERS = 2;
using R = Regs<CONSUMERS>;
constexpr int THREADS = R::THREADS;
constexpr int BLOCK_M = 64 * CONSUMERS;  // query rows of a work tile

template <int DH>
struct Dq {
  using T = Tile<DH>;
  // key rows of a K/V tile: from dh 192 on, 32 keep dQ, S, dP and dS's
  // parts in the consumers' registers
  static constexpr int BN = DH >= 192 ? 32 : 64;
  static constexpr int O_STAGES = BLOCK_M / (2 * BN);  // ring stages of a work's O
  // Q and dO buffers: two, so that the next work's load runs under this
  // one, where shared memory holds them
  static constexpr int Q_BUFS = DH >= 192 ? 1 : 2;
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = BLOCK_M * DH * 2;  // Q or dO of a work tile
  static constexpr int KV_BYTES = BN * DH * 2;      // one K or V tile
  // byte offsets from the 1024-aligned base of shared memory
  static constexpr int Q = 0;                          // [Q_BUFS][Q, dO]
  static constexpr int K = Q + 2 * Q_BUFS * Q_BYTES;   // [STAGES]
  static constexpr int V = K + STAGES * KV_BYTES;      // [STAGES]
  static constexpr int BARS = V + STAGES * KV_BYTES;
  // q_full[2], q_empty[2], full[STAGES], empty[STAGES]; 1024 bytes of
  // alignment slack
  static constexpr int SMEM_BYTES = BARS + 8 * (4 + 2 * STAGES) + 1024;
  static_assert(SMEM_BYTES <= 232448, "above a block's 227 KB of shared memory");
};

// The producer loads each work's Q and dO once, then, through the ring,
// its O (rows 0..63 in a stage's K slot, 64..127 in its V slot; at 32-key
// tiles rows 0..63 in the first stage, 64..127 in the second) and its K/V
// tiles up to the diagonal. Consumer warpgroup wg owns query rows
// 64 wg .. 64 wg + 63 of a work tile: it takes D = rowsum(dO O) of its
// rows from the diagonal of dO O^T (SS, summed as dP is, so that dP - D
// is exactly 0 where it is in float64: a query that sees one key, whose O
// is that key's V); then per key tile it runs S = Q K^T and
// dP = dO V^T (SS), P = exp(S scale - lse) and dS = P (dP - D) in
// registers, and dQ += dS K (RS, three parts, K MN-major). dQ of a query
// is written by exactly one thread, with no atomics.
template <int DH, bool PADDED>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const __grid_constant__ CUtensorMap o_map,
                  const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                  bf16* __restrict__ dq, int t, int dh_in, int bh_count, int n_q_tiles,
                  float scale, int causal) {
  const int dh = head_dim<DH, PADDED>(dh_in);
  using C = Dq<DH>;
  using L = typename C::T;
  constexpr int BN = C::BN;
  constexpr int STAGES = C::STAGES;
  constexpr int Q_BUFS = C::Q_BUFS;
  constexpr int NC = BN / 16;  // k-chunks of dS
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::BARS);  // [2]
  uint64_t* q_empty = q_full + 2;                                   // [2]
  uint64_t* full = q_full + 4;
  uint64_t* empty = full + STAGES;
  const int n_work = bh_count * n_q_tiles;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], 4 * CONSUMERS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // warp-uniform, as the compiler can see
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == CONSUMERS) {
    // producer: one thread issues every load; work j's Q and dO go to
    // buffer j % Q_BUFS
    setmaxnreg_dec<R::PRODUCER>();
    if (threadIdx.x != 128 * CONSUMERS) return;
    Ring<STAGES> ring;
    for (int w = blockIdx.x, j = 0; w < n_work; w += gridDim.x, ++j) {
      int bh, qt;
      schedule(w, n_q_tiles, gridDim.x, &bh, &qt);
      const int q0 = qt * BLOCK_M;
      const int n_kt = key_tiles(q0 + BLOCK_M, t, BN, causal);
      const int b = j % Q_BUFS;
      uint8_t* q_tile = smem + C::Q + b * 2 * C::Q_BYTES;
      mbar_wait(&q_empty[b], ((j / Q_BUFS) & 1) ^ 1);
      mbar_arrive_expect_tx(&q_full[b], 2 * C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p) {
        const int off = p * BLOCK_M * L::RB;
        tma_load_3d(q_tile + off, &q_map, &q_full[b], p * L::COLS, q0, bh);
        tma_load_3d(q_tile + C::Q_BYTES + off, &do_map, &q_full[b], p * L::COLS, q0, bh);
      }
      // O of the work's rows, 2 BN rows a stage: BN in its K slot, BN in its V slot
      for (int os = 0; os < C::O_STAGES; ++os, ring.advance()) {
        const int s = ring.stage;
        const int r0 = q0 + 2 * BN * os;
        mbar_wait(&empty[s], ring.phase ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p) {
          const int off = s * C::KV_BYTES + p * BN * L::RB;
          tma_load_3d(smem + C::K + off, &o_map, &full[s], p * L::COLS, r0, bh);
          tma_load_3d(smem + C::V + off, &o_map, &full[s], p * L::COLS, r0 + BN, bh);
        }
      }
      for (int kt = 0; kt < n_kt; ++kt, ring.advance()) {
        const int s = ring.stage;
        mbar_wait(&empty[s], ring.phase ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p) {
          const int off = s * C::KV_BYTES + p * BN * L::RB;
          tma_load_3d(smem + C::K + off, &k_map, &full[s], p * L::COLS, kt * BN, bh);
          tma_load_3d(smem + C::V + off, &v_map, &full[s], p * L::COLS, kt * BN, bh);
        }
      }
    }
    return;
  }

  // consumers. The loop is software-pipelined: at key tile kt a warpgroup
  // issues S and dP of tile kt and, behind them, dS K of tile kt - 1,
  // computes tile kt's dS while that product is on the tensor cores, and
  // splits it once the product has read the last tile's.
  setmaxnreg_inc<R::CONSUMER>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int tq = tid % 4;
  const float scale_log2 = scale * LOG2E;
  const uint32_t k_slot = smem_u32(smem + C::K);
  const uint32_t v_slot = smem_u32(smem + C::V);
  Ring<STAGES> ring;
  for (int w = blockIdx.x, j = 0; w < n_work; w += gridDim.x, ++j) {
    int bh, qt;
    schedule(w, n_q_tiles, gridDim.x, &bh, &qt);
    const int q0 = qt * BLOCK_M;
    const int w0 = q0 + 64 * wg;  // the warpgroup's first query row
    const int n_kt = key_tiles(q0 + BLOCK_M, t, BN, causal);
    const int mine = w0 < t ? key_tiles(w0 + 64, t, BN, causal) : 0;
    const int row0 = w0 + 16 * warp + g;
    const int row1 = row0 + 8;
    const int b = j % Q_BUFS;
    const uint32_t q_tile = smem_u32(smem + C::Q + b * 2 * C::Q_BYTES);
    const uint32_t do_tile = q_tile + C::Q_BYTES;
    const size_t base = static_cast<size_t>(bh) * t;

    float acc[DH / 2];  // dQ of the warpgroup's rows (times scale below)
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float sc[BN / 2];       // S, then P, of the current tile (64 x BN)
    float dp[BN / 2];       // dP, then dS
    uint32_t a[NC][3][4];   // dS of the pending tile, split
    int pending = 0;        // the stage of the pending tile
    float lse0 = 0.f, lse1 = 0.f;  // lse * log2(e) of rows row0, row1
    float d0 = 0.f, d1 = 0.f;      // their D
    mbar_wait(&q_full[b], (j / Q_BUFS) & 1);
    if (mine == 0) mbar_arrive_warp(&q_empty[b]);
    // D from the work's O, in the stage that holds this warpgroup's rows:
    // at 64-key tiles the first, its K slot for warpgroup 0 and V slot for
    // 1; at 32-key tiles stage wg, its K slot holding rows 0..31 of the
    // warpgroup's and its V slot rows 32..63 (a second product, into sc)
    for (int os = 0; os < C::O_STAGES; ++os, ring.advance()) {
      const int s = ring.stage;
      mbar_wait(&full[s], ring.phase);
      if (mine > 0 && os == wg * C::O_STAGES / CONSUMERS) {
        const uint32_t o_tile =
            (C::O_STAGES == 1 && wg == 1 ? v_slot : k_slot) + s * C::KV_BYTES;
        fence_regs(dp);
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          Wgmma<BN>::ss(dp, L::k_major(do_tile, BLOCK_M, 64 * wg, kk),
                        L::k_major(o_tile, BN, 0, kk), kk > 0);
        }
        if constexpr (BN == 32) {
#pragma unroll
          for (int kk = 0; kk < DH / 16; ++kk) {
            Wgmma<BN>::ss(sc, L::k_major(do_tile, BLOCK_M, 64 * wg, kk),
                          L::k_major(v_slot + s * C::KV_BYTES, BN, 0, kk), kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dp);
        fence_regs(sc);
        // (r, r), r = 16 warp + g + 8 h, is column g of column group
        // 2 warp + h of the slot's rows (2 (warp % 2) + h, in sc for warps
        // 2 and 3, at 32-key tiles), held by lane 4 g + g / 2 of the quad
        float diag0 = 0.f, diag1 = 0.f;
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          const int c = 8 * (w4 % (BN / 16));
          if (w4 == warp && BN == 32 && w4 >= 2) {
            diag0 = (g & 1) ? sc[c + 1] : sc[c];
            diag1 = (g & 1) ? sc[c + 7] : sc[c + 6];
          } else if (w4 == warp) {
            diag0 = (g & 1) ? dp[c + 1] : dp[c];
            diag1 = (g & 1) ? dp[c + 7] : dp[c + 6];
          }
        }
        d0 = __shfl_sync(0xffffffffu, diag0, 4 * g + g / 2);
        d1 = __shfl_sync(0xffffffffu, diag1, 4 * g + g / 2);
      }
      mbar_arrive_warp(&empty[s]);
    }

    // S = Q K^T and dP = dO V^T of the tile in stage s: issued, not waited for
    const auto issue_sdp = [&](int s) {
      const uint32_t k_tile = k_slot + s * C::KV_BYTES;
      const uint32_t v_tile = v_slot + s * C::KV_BYTES;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        Wgmma<BN>::ss(sc, L::k_major(q_tile, BLOCK_M, 64 * wg, kk),
                      L::k_major(k_tile, BN, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        Wgmma<BN>::ss(dp, L::k_major(do_tile, BLOCK_M, 64 * wg, kk),
                      L::k_major(v_tile, BN, 0, kk), kk > 0);
      }
      wgmma_commit();
    };
    // dQ += dS K of the pending tile, summed in dQ's own accumulator:
    // issued, not waited for
    const auto issue_dq = [&]() {
      const uint32_t k_tile = k_slot + pending * C::KV_BYTES;
      const auto k_desc = [&](int c) { return L::mn_major(k_tile, BN, c); };
      fence_regs(acc);
      wgmma_fence();
      rs_product<DH, NC>(acc, a, k_desc, true);
      wgmma_commit();
    };
    // after its wait: free the pending tile's dS and stage
    const auto retire_dq = [&]() {
      fence_regs(acc);
      fence_split(a);
      mbar_arrive_warp(&empty[pending]);
    };
    // P = exp(S scale - lse) of key tile kt, 0 where masked, in sc
    const auto probabilities = [&](int kt) {
      const int k0 = kt * BN;
      const bool mask = k0 + BN > t || (causal && k0 + BN - 1 > w0);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const bool second = (i & 2) != 0;  // row1's element
        float p = exp2_approx(fmaf(sc[i], scale_log2, second ? -lse1 : -lse0));
        if (mask) {
          const int key = k0 + 8 * (i / 4) + 2 * tq + (i & 1);
          if (!(key < t && (!causal || key <= (second ? row1 : row0)))) p = 0.f;
        }
        sc[i] = p;
      }
    };
    // dS = P (dP - D), in dp
    const auto score_grads = [&]() {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) dp[i] = sc[i] * (dp[i] - ((i & 2) ? d1 : d0));
    };
    // one key tile kt (>= 1): S and dP of kt and dS K of the pending tile
    // on the tensor cores, kt's dS meanwhile, then its split
    int kt = 0;
    const auto step = [&]() {
      const int s = ring.stage;
      mbar_wait(&full[s], ring.phase);
      issue_sdp(s);
      issue_dq();
      wgmma_wait<1>();
      fence_regs(sc);
      fence_regs(dp);
      if (kt == mine - 1) mbar_arrive_warp(&q_empty[b]);  // the last read of Q and dO
      probabilities(kt);
      score_grads();
      wgmma_wait<0>();
      retire_dq();
      split_to_a<NC>(dp, a);
      pending = s;
      ++kt;
      ring.advance();
    };

    if (mine > 0) {  // warpgroup-uniform; every step waits for all it issues
      pending = ring.stage;
      mbar_wait(&full[pending], ring.phase);
      issue_sdp(pending);
      // while S and dP run: the lse of the thread's rows
      lse0 = row0 < t ? lse[base + row0] * LOG2E : 0.f;
      lse1 = row1 < t ? lse[base + row1] * LOG2E : 0.f;
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      if (mine == 1) mbar_arrive_warp(&q_empty[b]);
      probabilities(0);
      score_grads();
      split_to_a<NC>(dp, a);
      kt = 1;
      ring.advance();
      while (kt < mine) step();
      issue_dq();  // the last pending product
      wgmma_wait<0>();
      retire_dq();
    }
    for (; kt < n_kt; ++kt, ring.advance()) {  // tiles past this warpgroup's diagonal
      const int s = ring.stage;
      mbar_wait(&full[s], ring.phase);
      mbar_arrive_warp(&empty[s]);
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row1 : row0;
      if (row >= t) continue;
      bf16* dst = dq + (base + row) * dh + 2 * tq;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        if (8 * n >= dh) break;
        const int i = 4 * n + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
      }
    }
  }
}

// the five tensor maps of q, k, v, o, dO (o in K/V tile boxes), of head dim
// dh in the boxes of class DH
template <int DH>
cudaError_t encode(CUtensorMap (&maps)[5], const bf16* q, const bf16* k, const bf16* v,
                   const bf16* o, const bf16* dout, int bh, int t, int dh) {
  constexpr int BN = Dq<DH>::BN;
  cudaError_t err = encode_rows(&maps[0], q, bh, t, dh, BLOCK_M);
  if (err == cudaSuccess) err = encode_rows(&maps[1], k, bh, t, dh, BN);
  if (err == cudaSuccess) err = encode_rows(&maps[2], v, bh, t, dh, BN);
  if (err == cudaSuccess) err = encode_rows(&maps[3], o, bh, t, dh, BN);
  if (err == cudaSuccess) err = encode_rows(&maps[4], dout, bh, t, dh, BLOCK_M);
  return err;
}

// one block per SM (or per work tile, if fewer)
template <int DH, bool PADDED>
cudaError_t launch_as(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                      const float* lse, const bf16* dout, bf16* dq, int bh, int t, int dh,
                      float scale, int causal, cudaStream_t stream) {
  const int n_q_tiles = (t + BLOCK_M - 1) / BLOCK_M;
  const long long n_work = static_cast<long long>(bh) * n_q_tiles;
  if (n_work > INT_MAX) return cudaErrorInvalidConfiguration;
  constexpr int smem = Dq<DH>::SMEM_BYTES;
  CUtensorMap maps[5];
  int sms;
  cudaError_t err = encode<DH>(maps, q, k, v, o, dout, bh, t, dh);
  if (err == cudaSuccess) {
    err = prepare_kernel<flash_bwd_dq_bf16<DH, PADDED>>(smem, R::LAUNCH, &sms);
  }
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(n_work < sms ? n_work : sms);
  flash_bwd_dq_bf16<DH, PADDED><<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], lse, dq, t, dh, bh, n_q_tiles, scale, causal);
  return cudaGetLastError();
}

// the class's instantiation for dh (with_instantiation)
template <int DH>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                   const float* lse, const bf16* dout, bf16* dq, int bh, int t, int dh,
                   float scale, int causal, cudaStream_t stream) {
  return with_instantiation<DH>(dh, [&](auto padded) {
    return launch_as<DH, decltype(padded)::value>(q, k, v, o, lse, dout, dq, bh, t, dh, scale,
                                                  causal, stream);
  });
}

// of the instantiation that runs dh = DH
template <int DH>
cudaError_t occupancy(int* smem, int* blocks_per_sm) {
  *smem = Dq<DH>::SMEM_BYTES;
  return with_instantiation<DH>(DH, [&](auto padded) {
    constexpr auto kernel = flash_bwd_dq_bf16<DH, decltype(padded)::value>;
    int sms;
    const cudaError_t err = prepare_kernel<kernel>(*smem, R::LAUNCH, &sms);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, THREADS, *smem);
  });
}

}  // namespace dq

// --- dK/dV: warp-specialised, TMA-fed, wgmma (wgmma_bf16.cuh) ---

namespace dkv {

constexpr int BLOCK_N = 128;  // key rows of a block, 64 per consumer
constexpr int CONSUMERS = 2;  // consumer warpgroups
using R = Regs<CONSUMERS>;
constexpr int THREADS = R::THREADS;

template <int DH>
struct Dkv {
  using T = Tile<DH>;
  // query rows of a Q/dO/O tile: 32 from dh 128 on keeps the consumers'
  // accumulators in registers (and, above 128, shared memory in bounds)
  static constexpr int BQ = DH >= 128 ? 32 : 64;
  // dK and dV columns a block sums: above dh 128 a share of them, for
  // registers (one 64-column panel at dh 192; two at 256, where the
  // accumulators fit beside each other without dK's fresh one)
  static constexpr int DC = DH == 256 ? 128 : DH > 128 ? 64 : DH;
  static constexpr int SLICES = DH / DC;
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
  static_assert(SMEM_BYTES <= 232448, "above a block's 227 KB of shared memory");
};

// One block per (bh, 128-row key tile, DC-column slice of dK and dV), the
// tiles that see the most queries under causal masking first. The producer
// loads K and V once, then Q, dO and O tiles of BQ rows from the diagonal on
// through a ring of two stages; each consumer warpgroup runs, per query
// tile, S^T = K Q^T and dP^T = V dO^T (SS), computes D = rowsum(dO O) of
// the tile from shared memory while they run, then P^T = exp(S^T scale - lse) and
// dS^T = P^T (dP^T - D) in registers, and dV += P^T dO, dK += dS^T Q (RS,
// three parts each, dO and Q MN-major). dK and dV of a key are written by
// exactly one thread, with no atomics.
template <int DH, bool PADDED>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap o_map,
                   const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int t, int dh_in,
                   int bh_count,
                   float scale, int causal) {
  const int dh = head_dim<DH, PADDED>(dh_in);
  using C = Dkv<DH>;
  using L = typename C::T;
  constexpr int BQ = C::BQ;
  constexpr int DC = C::DC;
  constexpr int STAGES = C::STAGES;
  constexpr int NC = BQ / 16;  // k-chunks of P^T and dS^T
  // k16 steps of one S^T chain: from dh 192 on a 64-column panel's, the
  // panels' chains added in float32. The tensor cores truncate the running
  // sum at every step, and P = exp(S - lse) carries the error into dV: one
  // chain of 16 steps left a dV element (a key seen by all 512 queries)
  // 1.17x the gate's one ulp + 1e-6 off float64 at dh 256, BH 4,096
  constexpr int S_STEPS = DH > 128 ? 4 : DH / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  // block (tile SLICES + slice) bh_count + bh
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const int slice = static_cast<int>(blockIdx.x / bh_count % C::SLICES);
  const int tile = static_cast<int>(blockIdx.x / bh_count / C::SLICES);
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

  float dka[DC / 2], dva[DC / 2];  // dK and dV of the block's columns
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dka[i] = dva[i] = 0.f;
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
      for (int kk = 0; kk < S_STEPS; ++kk) Wgmma<BQ>::ss(sa, ka(kk), qb(kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) Wgmma<BQ>::ss(dp, va(kk), gb(kk), kk > 0);
      wgmma_commit();
      float* d_tile = d_s + (done & 1) * 2 * BQ;  // D, then lse * log2(e)
      if constexpr (BQ == 32) {
        // D = rowsum(dO O) as the diagonal of O dO^T, summed on the tensor
        // cores as dP^T is, so that dP^T - D is exactly 0 where it is in
        // float64 (a query that sees one key, whose O is that key's V):
        // from dh 128 on, float32 fmas left such dK elements above the
        // gate's 1e-6. The A operand's 64 rows start 32 rows before the O
        // tile (the dO tile's last rows), so that its rows 32..63 are the
        // tile's: D of query j is element (32 + j, j), held by warps 2, 3.
        const uint32_t o_rows = q_tile + 2 * C::Q_BYTES - (64 - BQ) * L::RB;
        float dd[BQ / 2];
        fence_regs(dd);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          Wgmma<BQ>::ss(dd, L::k_major(o_rows, BQ, 0, kk), gb(kk), kk > 0);
        }
        wgmma_commit();
        if (tid < BQ) d_tile[BQ + tid] = q0 + tid < t ? lse_h[q0 + tid] * LOG2E : 0.f;
        wgmma_wait<0>();
        fence_regs(dd);
        float diag0 = 0.f, diag1 = 0.f;
#pragma unroll
        for (int w4 = 2; w4 < 4; ++w4) {
          if (w4 == warp) {
            const int c = 8 * (w4 - 2);
            diag0 = (g & 1) ? dd[c + 1] : dd[c];
            diag1 = (g & 1) ? dd[c + 7] : dd[c + 6];
          }
        }
        if (warp >= 2 && tq == g / 2) {
          d_tile[16 * (warp - 2) + g] = diag0;
          d_tile[16 * (warp - 2) + g + 8] = diag1;
        }
      } else {
        // while they run: D of the tile's queries from the shared O and dO
        // tiles, TPR threads a row, and their lse
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
      if constexpr (S_STEPS < DH / 16) {
        // S^T's other 64-column panels, each in a fresh chain added in float32
        float sb[BQ / 2];
#pragma unroll
        for (int kk0 = S_STEPS; kk0 < DH / 16; kk0 += S_STEPS) {
          fence_regs(sb);
          wgmma_fence();
#pragma unroll
          for (int kk = kk0; kk < kk0 + S_STEPS; ++kk) {
            Wgmma<BQ>::ss(sb, ka(kk), qb(kk), kk > kk0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sb);
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i) sa[i] += sb[i];
        }
      }

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
      // the block's columns of dO and Q: from panel slice DC / 64 on
      const uint32_t panel = slice * (DC / L::COLS) * BQ * L::RB;
      const auto gmn = [&](int c) { return L::mn_major(do_tile + panel, BQ, c); };
      const auto qmn = [&](int c) { return L::mn_major(q_tile + panel, BQ, c); };
      // dV += P^T dO, in dV's own accumulator
      uint32_t pa[NC][3][4];
      split_to_a<NC>(sa, pa);
      fence_regs(dva);
      wgmma_fence();
      rs_product<DC, NC>(dva, pa, gmn, true);
      wgmma_commit();
      // dK += dS^T Q (times scale below), once dV's product has read P^T's
      // parts (the consumers' registers hold one split operand at a time):
      // up to 64 columns in a fresh accumulator added in float32, wider in
      // dK's own, whose registers a fresh one would spill
      wgmma_wait<0>();
      fence_regs(dva);
      fence_split(pa);
      uint32_t da[NC][3][4];
      split_to_a<NC>(dp, da);
      if constexpr (DC > 64) {
        fence_regs(dka);
        wgmma_fence();
        rs_product<DC, NC>(dka, da, qmn, true);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dka);
      } else {
        float f[DC / 2];
        rs_fresh<DC, NC>(f, da, qmn);
#pragma unroll
        for (int i = 0; i < DC / 2; ++i) dka[i] += f[i];
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
    const size_t row = (static_cast<size_t>(bh) * t + key) * dh + slice * DC + 2 * tq;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      if (slice * DC + 8 * n >= dh) break;
      const int i = 4 * n + 2 * half;
      *reinterpret_cast<__nv_bfloat162*>(dk + row + 8 * n) =
          __floats2bfloat162_rn(dka[i] * scale, dka[i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + 8 * n) =
          __floats2bfloat162_rn(dva[i], dva[i + 1]);
    }
  }
}

// the five tensor maps of q, k, v, o, dO, of head dim dh in the boxes of
// class DH
template <int DH>
cudaError_t encode(CUtensorMap (&maps)[5], const bf16* q, const bf16* k, const bf16* v,
                   const bf16* o, const bf16* dout, int bh, int t, int dh) {
  constexpr int BQ = Dkv<DH>::BQ;
  cudaError_t err = encode_rows(&maps[0], q, bh, t, dh, BQ);
  if (err == cudaSuccess) err = encode_rows(&maps[1], k, bh, t, dh, BLOCK_N);
  if (err == cudaSuccess) err = encode_rows(&maps[2], v, bh, t, dh, BLOCK_N);
  if (err == cudaSuccess) err = encode_rows(&maps[3], o, bh, t, dh, BQ);
  if (err == cudaSuccess) err = encode_rows(&maps[4], dout, bh, t, dh, BQ);
  return err;
}

template <int DH, bool PADDED>
cudaError_t launch_as(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                      const float* lse, const bf16* dout, bf16* dk, bf16* dv, int bh, int t,
                      int dh, float scale, int causal, cudaStream_t stream) {
  const long long n_blocks =
      static_cast<long long>(bh) * ((t + BLOCK_N - 1) / BLOCK_N) * Dkv<DH>::SLICES;
  if (n_blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  constexpr int smem = Dkv<DH>::SMEM_BYTES;
  CUtensorMap maps[5];
  int sms;
  cudaError_t err = encode<DH>(maps, q, k, v, o, dout, bh, t, dh);
  if (err == cudaSuccess) {
    err = prepare_kernel<flash_bwd_dkv_bf16<DH, PADDED>>(smem, R::LAUNCH, &sms);
  }
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_bf16<DH, PADDED><<<static_cast<unsigned>(n_blocks), THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], lse, dk, dv, t, dh, bh, scale, causal);
  return cudaGetLastError();
}

// the class's instantiation for dh (with_instantiation)
template <int DH>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                   const float* lse, const bf16* dout, bf16* dk, bf16* dv, int bh, int t,
                   int dh, float scale, int causal, cudaStream_t stream) {
  return with_instantiation<DH>(dh, [&](auto padded) {
    return launch_as<DH, decltype(padded)::value>(q, k, v, o, lse, dout, dk, dv, bh, t, dh,
                                                  scale, causal, stream);
  });
}

// of the instantiation that runs dh = DH
template <int DH>
cudaError_t occupancy(int* smem, int* blocks_per_sm) {
  *smem = Dkv<DH>::SMEM_BYTES;
  return with_instantiation<DH>(DH, [&](auto padded) {
    constexpr auto kernel = flash_bwd_dkv_bf16<DH, decltype(padded)::value>;
    int sms;
    const cudaError_t err = prepare_kernel<kernel>(*smem, R::LAUNCH, &sms);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, THREADS, *smem);
  });
}

}  // namespace dkv

}  // namespace

// q, k, v, o, dout, dq: (bh, t, dh) contiguous bf16, 16-byte aligned; lse:
// (bh, t) float32 from the forward; dh 16, 32 or a multiple of 8 from 64 to
// 256. Launches on `stream` and does not synchronise. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int gordo_flash_attention_backward_dq_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* dq, int bh, int t, int dh, float scale, int causal,
    void* stream) {
  if (bh <= 0 || t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_head_dim_class(dh, [&](auto c) {
    return dq::launch<decltype(c)::value>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(o), static_cast<const float*>(lse),
        static_cast<const bf16*>(dout), static_cast<bf16*>(dq), bh, t, dh, scale, causal,
        static_cast<cudaStream_t>(stream));
  }));
}

// As above, writing dk and dv: (bh, t, dh) contiguous bf16.
extern "C" int gordo_flash_attention_backward_dkv_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* dk, void* dv, int bh, int t, int dh, float scale,
    int causal, void* stream) {
  if (bh <= 0 || t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_head_dim_class(dh, [&](auto c) {
    return dkv::launch<decltype(c)::value>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(o), static_cast<const float*>(lse),
        static_cast<const bf16*>(dout), static_cast<bf16*>(dk), static_cast<bf16*>(dv), bh, t,
        dh, scale, causal, static_cast<cudaStream_t>(stream));
  }));
}

// The dQ kernel's dynamic shared memory (bytes) and resident blocks per SM
// for head dim `dh` (its class's), for reports. Returns the CUDA error code.
extern "C" int gordo_flash_attention_backward_dq_bf16_occupancy(int dh, int* smem_bytes,
                                                               int* blocks_per_sm) {
  return static_cast<int>(with_head_dim_class(dh, [&](auto c) {
    return dq::occupancy<decltype(c)::value>(smem_bytes, blocks_per_sm);
  }));
}

// As above, for the dK/dV kernel.
extern "C" int gordo_flash_attention_backward_dkv_bf16_occupancy(int dh, int* smem_bytes,
                                                                int* blocks_per_sm) {
  return static_cast<int>(with_head_dim_class(dh, [&](auto c) {
    return dkv::occupancy<decltype(c)::value>(smem_bytes, blocks_per_sm);
  }));
}

// The host time of encoding the dQ kernel's five tensor maps at (bh, t, dh),
// the mean over `reps` encodings, in microseconds, for reports; the maps
// point at `base` and are not used. Returns the CUDA error code.
extern "C" int gordo_flash_attention_backward_dq_bf16_encode_us(const void* base, int bh, int t,
                                                               int dh, int reps, float* us) {
  if (reps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* p = static_cast<const bf16*>(base);
  CUtensorMap maps[5];
  const auto start = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    const cudaError_t err = with_head_dim_class(dh, [&](auto c) {
      return dq::encode<decltype(c)::value>(maps, p, p, p, p, p, bh, t, dh);
    });
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const std::chrono::duration<double, std::micro> spent = std::chrono::steady_clock::now() - start;
  *us = static_cast<float>(spent.count() / reps);
  return 0;
}

// As above, for the dK/dV kernel's five tensor maps.
extern "C" int gordo_flash_attention_backward_dkv_bf16_encode_us(const void* base, int bh, int t,
                                                                int dh, int reps, float* us) {
  if (reps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* p = static_cast<const bf16*>(base);
  CUtensorMap maps[5];
  const auto start = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    const cudaError_t err = with_head_dim_class(dh, [&](auto c) {
      return dkv::encode<decltype(c)::value>(maps, p, p, p, p, p, bh, t, dh);
    });
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const std::chrono::duration<double, std::micro> spent = std::chrono::steady_clock::now() - start;
  *us = static_cast<float>(spent.count() / reps);
  return 0;
}
