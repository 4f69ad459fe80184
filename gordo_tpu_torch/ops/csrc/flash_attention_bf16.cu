// Flash-attention forward for bf16 inputs on NVIDIA Hopper (sm_90a):
// warp-specialised, TMA-fed, wgmma on the tensor cores in bf16 with float32
// sums.
//
// Replaces the TPU kernel `_flash_kernel` of
// gordo_tpu/ops/pallas_kernels/flash_attention.py (launched by
// `_flash_forward`) for bf16 q, k and v, as the JAX package sends them under
// `compute_dtype: bfloat16`: the TPU kernel upcasts them to float32,
// computes in float32 and writes the output in bf16 and the per-row
// logsumexp in float32. So does this kernel: S = Q K^T is bf16 x bf16
// (exact products) with float32 sums, the online softmax runs in float32
// registers, and O += P V takes P split into three bf16 parts
// (wgmma_bf16.cuh), which hold all of its float32 bits. The logsumexp is
// stored as (BH, T) float32, without the TPU's 128-lane replication; the
// backward kernels read it as exp(S - lse).
//
// What bounds it on this card: at the serving shape (BH 4096, T 512, dh 64,
// causal) it reads q, k, v and writes out at 2 bytes and lse at 4, 1.08e9
// bytes, 0.32 ms at 3.35 TB/s; its 8 dh FLOP for each of the BH T (T + 1) / 2
// visible (query, key) pairs (2 dh for S, 6 dh for P V, once per part of
// P) are 2.75e11 FLOP, 0.28 ms at 989 TFLOP/s of bf16. Beside them, each
// score costs an exponential (16 a clock per SM) and the split of P about
// eleven integer and float instructions, so at dh 64 the issue slots of
// the softmax and split, not memory, are what the tensor cores wait on.
// What its design does about that:
// - wgmma, the only path to the full tensor-core rate: S = Q K^T is an SS
//   product (Q and K both K-major in shared memory), O += P V an RS
//   product with P's three parts in registers and V as an MN-major B
//   operand, so V is never transposed;
// - one producer warpgroup (one thread issues TMA loads; setmaxnreg gives
//   its registers to the consumers) and three consumer warpgroups of 64
//   query rows (two from dh 128 on, for registers) that share every K/V
//   tile: three warps on each SM sub-partition to hide the softmax's
//   latency;
// - a ring of three 64-key K/V stages with full and empty mbarriers (two
//   at dh 192, for shared memory; 32-key stages at 256, for registers and
//   shared memory), and two Q buffers, so that the next work's loads run
//   under this one's compute;
// - one persistent block per SM walks over the (bh, query tile) work: the
//   query tiles of a head run side by side on neighbouring SMs (K and V
//   come from L2 after the first), and each SM cycles through the light
//   and heavy causal tiles;
// - a 3-D tensor map (dh, T, BH) per input, so TMA zero-fills the rows at
//   or past T of each head;
// - a software-pipelined consumer loop: S of key tile j is issued with
//   P V of tile j - 1 behind it, and tile j's softmax runs while P V is on
//   the tensor cores; a warpgroup skips the key tiles past its diagonal;
// - exp2 (one MUFU.EX2) with log2(e) folded into the scale, the mask only
//   on tiles that cross the diagonal or T, the same NEG_INF and
//   max(l, 1e-30) as the reference, lse written in natural log; the
//   running max moves on only when a row's grows by more than 2^8, so O
//   is rarely rescaled;
// - P split by truncation (byte permutes, masks and adds, no conversions),
//   and P V summed in O's own accumulator over the whole loop (held to the
//   gates on the card; a tile at a time in a fresh accumulator was slower,
//   scripts/torch_bf16_variants.py).
// The layout (CONSUMERS, BN, STAGES) was timed on the card against its
// alternatives (PERF.md section 6) at dh 64; any T >= 1 works, causal or
// not; dh is 16, 32 or any multiple of 8 from 64 to 256, each run by the
// instantiation of its class (wgmma_bf16.cuh: whole 64-column panels, the
// columns past dh zero-filled by TMA and not stored, the scale the caller's
// 1/sqrt(dh)).

#include <cuda_runtime.h>
#include <limits.h>

#include <chrono>

#include "wgmma_bf16.cuh"

namespace {

using namespace gordo_wgmma;

constexpr float NEG_INF = -1e30f;  // the mask value of the reference
constexpr float LN2 = 0.6931471805599453f;
// the growth of a row's max (log2 units) that rescales O and l (a rescale
// on every growth was ~3% slower on the card, PERF.md section 6)
constexpr float RESCALE = 8.f;

template <int DH>
struct Fwd {
  using T = Tile<DH>;
  // consumer warpgroups, 64 query rows each: three keep more warps in
  // flight on each SM sub-partition; from dh 128 on, two for registers
  static constexpr int CONSUMERS = DH >= 128 ? 2 : 3;
  using R = Regs<CONSUMERS>;
  static constexpr int THREADS = R::THREADS;
  static constexpr int BLOCK_M = 64 * CONSUMERS;  // query rows of a work tile
  // key rows of a K/V tile: at dh 256, 32 keep O, S and P's parts in the
  // consumers' registers
  static constexpr int BN = DH == 256 ? 32 : 64;
  static constexpr int STAGES = DH == 192 ? 2 : 3;  // dh 192: shared memory
  static constexpr int Q_BYTES = BLOCK_M * DH * 2;
  static constexpr int KV_BYTES = BN * DH * 2;  // one K or V tile
  // byte offsets from the 1024-aligned base of shared memory
  static constexpr int Q = 0;                        // [2]: two works' Q
  static constexpr int K = Q + 2 * Q_BYTES;          // [STAGES]
  static constexpr int V = K + STAGES * KV_BYTES;    // [STAGES]
  static constexpr int BARS = V + STAGES * KV_BYTES;
  // q_full[2], q_empty[2], full[STAGES], empty[STAGES]; 1024 bytes of
  // alignment slack
  static constexpr int SMEM_BYTES = BARS + 8 * (4 + 2 * STAGES) + 1024;
  static_assert(SMEM_BYTES <= 232448, "above a block's 227 KB of shared memory");
};

template <int DH, bool PADDED>
__global__ void __launch_bounds__(Fwd<DH>::THREADS, 1)
flash_forward_bf16(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out,
                   float* __restrict__ lse, int t, int dh_in, int bh_count, int n_q_tiles,
                   float scale_log2, int causal) {
  const int dh = head_dim<DH, PADDED>(dh_in);
  using C = Fwd<DH>;
  using L = typename C::T;
  constexpr int CONSUMERS = C::CONSUMERS;
  constexpr int BLOCK_M = C::BLOCK_M;
  constexpr int BN = C::BN;
  constexpr int NC = BN / 16;  // k-chunks of P
  constexpr int STAGES = C::STAGES;
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

  // warp-uniform, as the compiler can see, so shared addresses built from
  // it can stay in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == CONSUMERS) {
    // producer: one thread issues every load; work j's Q goes to buffer j % 2
    setmaxnreg_dec<C::R::PRODUCER>();
    if (threadIdx.x != 128 * CONSUMERS) return;
    Ring<STAGES> ring;
    for (int w = blockIdx.x, j = 0; w < n_work; w += gridDim.x, ++j) {
      int bh, qt;
      schedule(w, n_q_tiles, gridDim.x, &bh, &qt);
      const int q0 = qt * BLOCK_M;
      const int n_kt = key_tiles(q0 + BLOCK_M, t, BN, causal);
      const int b = j & 1;
      mbar_wait(&q_empty[b], ((j >> 1) & 1) ^ 1);
      mbar_arrive_expect_tx(&q_full[b], C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p) {
        tma_load_3d(smem + C::Q + b * C::Q_BYTES + p * BLOCK_M * L::RB, &q_map, &q_full[b],
                    p * L::COLS, q0, bh);
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

  // consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63 of a tile.
  // The loop is software-pipelined: at key tile kt it issues S = Q K_kt
  // and, behind it, P V of tile kt - 1, runs tile kt's softmax while that
  // product is on the tensor cores, and splits its P once the product has
  // read the last tile's.
  setmaxnreg_inc<C::R::CONSUMER>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int tq = tid % 4;
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
    const int b = j & 1;
    const uint32_t q_tile = smem_u32(smem + C::Q + b * C::Q_BYTES);

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF;  // running max of rows row0, row1 (log2 units)
    float l0 = 0.f, l1 = 0.f;          // this thread's part of their denominators
    float sc[BN / 2];                  // S, then P, of the current tile (64 x BN)
    float c0, c1;                      // the rescale of O that goes with it
    uint32_t a[NC][3][4];                 // P of the pending tile, split
    float corr0 = 0.f, corr1 = 0.f;       // the rescale that goes with the pending
    int pending = 0;                      // the stage of the pending tile
    mbar_wait(&q_full[b], (j >> 1) & 1);
    if (mine == 0) mbar_arrive_warp(&q_empty[b]);

    // S = Q K^T of the tile in stage s into sc: issued, not waited for
    const auto issue_s = [&](int s) {
      const uint32_t k_tile = smem_u32(smem + C::K + s * C::KV_BYTES);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        Wgmma<BN>::ss(sc, L::k_major(q_tile, BLOCK_M, 64 * wg, kk),
                      L::k_major(k_tile, BN, 0, kk), kk > 0);
      }
      wgmma_commit();
    };
    // O = O corr + P V of the pending tile, summed in O's own accumulator:
    // issued, not waited for
    const auto issue_pv = [&]() {
      const uint32_t v_tile = smem_u32(smem + C::V + pending * C::KV_BYTES);
      const auto v_desc = [&](int c) { return L::mn_major(v_tile, BN, c); };
      if (__any_sync(0xffffffffu, corr0 != 1.f || corr1 != 1.f)) {
#pragma unroll
        for (int i = 0; i < DH / 2; i += 4) {
          o[i] *= corr0;
          o[i + 1] *= corr0;
          o[i + 2] *= corr1;
          o[i + 3] *= corr1;
        }
      }
      fence_regs(o);
      wgmma_fence();
      rs_product<DH, NC>(o, a, v_desc, true);
      wgmma_commit();
    };
    // after its wait: free the pending tile's P and stage
    const auto retire_pv = [&]() {
      fence_regs(o);
      fence_split(a);
      mbar_arrive_warp(&empty[pending]);
    };
    // online softmax of tile kt in log2 units (x = S * scale * log2(e)):
    // sc becomes P, m and l move on, (c0, c1) rescale the O before it
    const auto softmax = [&](int kt) {
      const int k0 = kt * BN;
      if (k0 + BN > t || (causal && k0 + BN - 1 > w0)) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + 2 * tq + (i & 1);
          const int row = (i & 2) ? row1 : row0;
          if (!(key < t && (!causal || key <= row))) sc[i] = NEG_INF;
        }
      }
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int i = 0; i < BN / 2; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
      }
      // every row of a warpgroup that gets here has seen key 0 (in this
      // tile or an earlier one), so the new max is finite and masked
      // exponentials are 0. The max moves on only where a row's grows by
      // more than RESCALE (and then for the whole warp): P stays below
      // 2^RESCALE, and O and l keep sharing the max they were summed at.
      mx0 = quad_max(mx0) * scale_log2;
      mx1 = quad_max(mx1) * scale_log2;
      c0 = c1 = 1.f;
      if (__any_sync(0xffffffffu, mx0 > m0 + RESCALE || mx1 > m1 + RESCALE)) {
        const float mn0 = fmaxf(m0, mx0);
        const float mn1 = fmaxf(m1, mx1);
        c0 = exp2_approx(m0 - mn0);
        c1 = exp2_approx(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
      }
      const float mn0 = m0, mn1 = m1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 2; i += 4) {
        sc[i] = exp2_approx(fmaf(sc[i], scale_log2, -mn0));
        sc[i + 1] = exp2_approx(fmaf(sc[i + 1], scale_log2, -mn0));
        sc[i + 2] = exp2_approx(fmaf(sc[i + 2], scale_log2, -mn1));
        sc[i + 3] = exp2_approx(fmaf(sc[i + 3], scale_log2, -mn1));
        sum0 += sc[i] + sc[i + 1];
        sum1 += sc[i + 2] + sc[i + 3];
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
      // the softmax stays ahead of the wait for the pending product in
      // program order, which it is meant to overlap
      fence_regs(sc);
      asm volatile("" : "+f"(l0), "+f"(l1), "+f"(c0), "+f"(c1));
    };
    // one key tile kt (>= 1): S of kt and P V of the pending tile on the
    // tensor cores, kt's softmax meanwhile, then the split of its P
    int kt = 0;
    const auto step = [&]() {
      const int s = ring.stage;
      mbar_wait(&full[s], ring.phase);
      issue_s(s);
      issue_pv();
      wgmma_wait<1>();
      fence_regs(sc);
      if (kt == mine - 1) mbar_arrive_warp(&q_empty[b]);  // the last read of Q
      softmax(kt);
      wgmma_wait<0>();
      retire_pv();
      split_to_a<NC>(sc, a);
      corr0 = c0;
      corr1 = c1;
      pending = s;
      ++kt;
      ring.advance();
    };
    // the last pending product
    const auto finish = [&]() {
      issue_pv();
      wgmma_wait<0>();
      retire_pv();
    };

    if (mine > 0) {  // warpgroup-uniform; every step waits for all it issues
      pending = ring.stage;
      mbar_wait(&full[pending], ring.phase);
      issue_s(pending);
      wgmma_wait<0>();
      fence_regs(sc);
      if (mine == 1) mbar_arrive_warp(&q_empty[b]);
      softmax(0);
      split_to_a<NC>(sc, a);
      corr0 = c0;
      corr1 = c1;
      kt = 1;
      ring.advance();
      while (kt < mine) step();
      finish();
    }
    for (; kt < n_kt; ++kt, ring.advance()) {  // tiles past this warpgroup's diagonal
      const int s = ring.stage;
      mbar_wait(&full[s], ring.phase);
      mbar_arrive_warp(&empty[s]);
    }

    const float d0 = fmaxf(quad_sum(l0), 1e-30f);
    const float d1 = fmaxf(quad_sum(l1), 1e-30f);
    const float inv0 = 1.f / d0, inv1 = 1.f / d1;
    const size_t base = static_cast<size_t>(bh) * t;
    if (row0 < t) {
      bf16* dst = out + (base + row0) * dh + 2 * tq;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        if (8 * n >= dh) break;
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      }
      if (tq == 0) lse[base + row0] = m0 * LN2 + logf(d0);
    }
    if (row1 < t) {
      bf16* dst = out + (base + row1) * dh + 2 * tq;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        if (8 * n >= dh) break;
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
      }
      if (tq == 0) lse[base + row1] = m1 * LN2 + logf(d1);
    }
  }
}

// the three tensor maps of q, k, v, of head dim dh in the boxes of class DH
template <int DH>
cudaError_t encode(CUtensorMap (&maps)[3], const bf16* q, const bf16* k, const bf16* v, int bh,
                   int t, int dh) {
  cudaError_t err = encode_rows(&maps[0], q, bh, t, dh, Fwd<DH>::BLOCK_M);
  if (err == cudaSuccess) err = encode_rows(&maps[1], k, bh, t, dh, Fwd<DH>::BN);
  if (err == cudaSuccess) err = encode_rows(&maps[2], v, bh, t, dh, Fwd<DH>::BN);
  return err;
}

// one block per SM (or per work tile, if fewer)
template <int DH, bool PADDED>
cudaError_t launch_as(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse, int bh,
                      int t, int dh, float scale, int causal, cudaStream_t stream) {
  using C = Fwd<DH>;
  const int n_q_tiles = (t + C::BLOCK_M - 1) / C::BLOCK_M;
  const long long n_work = static_cast<long long>(bh) * n_q_tiles;
  if (n_work > INT_MAX) return cudaErrorInvalidConfiguration;
  CUtensorMap maps[3];
  int sms;
  cudaError_t err = encode<DH>(maps, q, k, v, bh, t, dh);
  if (err == cudaSuccess) {
    err = prepare_kernel<flash_forward_bf16<DH, PADDED>>(C::SMEM_BYTES, C::R::LAUNCH, &sms);
  }
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(n_work < sms ? n_work : sms);
  flash_forward_bf16<DH, PADDED><<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(
      maps[0], maps[1], maps[2], out, lse, t, dh, bh, n_q_tiles, scale * LOG2E, causal);
  return cudaGetLastError();
}

// the class's instantiation for dh (with_instantiation)
template <int DH>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse, int bh,
                   int t, int dh, float scale, int causal, cudaStream_t stream) {
  return with_instantiation<DH>(dh, [&](auto padded) {
    return launch_as<DH, decltype(padded)::value>(q, k, v, out, lse, bh, t, dh, scale, causal,
                                                  stream);
  });
}

// of the instantiation that runs dh = DH
template <int DH>
cudaError_t occupancy(int* smem, int* blocks_per_sm) {
  using C = Fwd<DH>;
  *smem = C::SMEM_BYTES;
  return with_instantiation<DH>(DH, [&](auto padded) {
    constexpr auto kernel = flash_forward_bf16<DH, decltype(padded)::value>;
    int sms;
    const cudaError_t err = prepare_kernel<kernel>(*smem, C::R::LAUNCH, &sms);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, C::THREADS,
                                                         *smem);
  });
}

}  // namespace

// q, k, v, out: (bh, t, dh) contiguous bf16, 16-byte aligned; lse: (bh, t)
// float32; dh 16, 32 or a multiple of 8 from 64 to 256. Launches on
// `stream` and does not synchronise. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int gordo_flash_attention_forward_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse, int bh,
    int t, int dh, float scale, int causal, void* stream) {
  if (bh <= 0 || t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_head_dim_class(dh, [&](auto c) {
    return launch<decltype(c)::value>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), static_cast<float*>(lse), bh, t, dh, scale, causal,
        static_cast<cudaStream_t>(stream));
  }));
}

// The head-dim class whose instantiations of the three bf16 kernels run
// dh (head_dim.cuh), or 0 where they take no dh, for reports
extern "C" int gordo_flash_attention_bf16_head_dim_class(int dh) {
  return head_dim_class(dh);
}

// The kernel's dynamic shared memory (bytes) and resident blocks per SM for
// head dim `dh` (its class's), for reports. Returns the CUDA error code.
extern "C" int gordo_flash_attention_forward_bf16_occupancy(int dh, int* smem_bytes,
                                                           int* blocks_per_sm) {
  return static_cast<int>(with_head_dim_class(dh, [&](auto c) {
    return occupancy<decltype(c)::value>(smem_bytes, blocks_per_sm);
  }));
}

// The host time of encoding the forward's three tensor maps at (bh, t, dh),
// the mean over `reps` encodings, in microseconds, for reports; the maps
// point at `base` and are not used. Returns the CUDA error code.
extern "C" int gordo_flash_attention_forward_bf16_encode_us(const void* base, int bh, int t,
                                                           int dh, int reps, float* us) {
  if (reps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* p = static_cast<const bf16*>(base);
  CUtensorMap maps[3];
  const auto start = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    const cudaError_t err = with_head_dim_class(dh, [&](auto c) {
      return encode<decltype(c)::value>(maps, p, p, p, bh, t, dh);
    });
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const std::chrono::duration<double, std::micro> spent = std::chrono::steady_clock::now() - start;
  *us = static_cast<float>(spent.count() / reps);
  return 0;
}
