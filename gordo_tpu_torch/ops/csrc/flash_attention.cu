// Flash-attention forward for NVIDIA Hopper (sm_90a), float32-accurate on
// the tensor cores.
//
// Replaces the TPU kernel `_flash_kernel` of
// gordo_tpu/ops/pallas_kernels/flash_attention.py (launched by
// `_flash_forward`): blockwise self-attention with an online softmax, scale
// 1/sqrt(dh), an optional causal mask, writing the output and the per-row
// logsumexp. The logsumexp is stored as (BH, T) float32, without the TPU's
// 128-lane replication; the backward kernels read it.
//
// What bounds it on this card: at the serving shape (BH 4096, T 512, dh 64,
// causal) the work is 4*dh FLOP for each of the BH*T*(T+1)/2 visible
// (query, key) pairs, 1.4e11 FLOP, against 2.2e9 bytes of q/k/v/out/lse:
// ~64 FLOP per byte, so it is bound by arithmetic. Both products run on the
// tensor cores in 3xTF32 (mma_tf32x3.cuh), float32-accurate at up to
// 165 TFLOP/s, against 67 TFLOP/s of float32 FMAs on the CUDA cores.
//
// Design:
// - one block of 4 warps per (bh, 64-row query tile); each warp owns 16
//   query rows, one m16 strip of mma.sync.m16n8k8;
// - Q stays in shared memory and its fragments are split per use: kept in
//   registers they cost more than the warps they crowd out;
// - K and V tiles of 32 rows are double-buffered in shared memory with
//   cp.async: tile j + 1 loads while tile j computes; rows at or past T are
//   zero-filled. Shared memory is 15 / 27 / 51 / 99 KB at dh 16 / 32 / 64 /
//   128 (rows padded to dh + 4 floats), 195 KB at 256; at dh 64 registers,
//   not shared memory, hold an SM to three blocks;
// - head dims: each class DH (16, 32, and the multiples of 32 from 64 to
//   256, mma_tf32x3.cuh) takes every dh % 8 == 0 up to it with its tiles:
//   the loads zero-fill the columns at or past dh, which add nothing to S,
//   give zero columns of O, and are not stored; the scale is the caller's
//   1/sqrt(dh);
// - S = Q K^T * scale goes into float32 accumulator fragments (16 x 32 per
//   warp), and the online softmax runs on them in registers: row max by
//   __shfl_xor within each quad, running max and denominator as the
//   reference has them (NEG_INF mask, max(l, 1e-30), natural exponentials,
//   so that lse matches the backward's exp(S - lse));
// - P feeds O += P V straight from its accumulator fragments, with V's B
//   fragments read in the matching key order (see mma_tf32x3.cuh), so P
//   never leaves registers; the terms of two k-steps of S, and of one
//   8-key step of O, are summed in a fresh accumulator and added to S or O
//   in float32 (mma_3xtf32_sum);
// - under causal masking the key loop stops at the diagonal tile, a warp
//   whose rows all lie before a key tile skips it, only tiles that cross
//   the diagonal or T are masked, and the query tiles with the most work
//   are scheduled first; any T >= 1 works; dh is 16, 32 or any multiple of
//   8 from 64 to 256.

#include <cuda_runtime.h>
#include <limits.h>

#include "mma_tf32x3.cuh"

namespace {

using namespace gordo_mma;

constexpr int BLOCK_M = 64;  // query rows per block, 16 per warp
constexpr int BLOCK_N = 32;  // key rows per K/V tile
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;  // the mask value of the reference

template <int DH>
struct Fwd {
  static constexpr int LD = DH + 4;                   // shared-memory row stride
  static constexpr int TILE = BLOCK_N * LD;           // one K or V tile
  static constexpr int Q = 4 * TILE;                  // after [stage][K, V]
  static constexpr int SMEM_FLOATS = Q + BLOCK_M * LD;
};

template <int DH, bool PADDED>
__global__ void __launch_bounds__(THREADS)
flash_forward_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int t, int dh_in, int n_q_tiles, float scale,
                  int causal) {
  const int dh = head_dim<DH, PADDED>(dh_in);
  using C = Fwd<DH>;
  constexpr int LD = C::LD, TILE = C::TILE;
  constexpr int KSTEPS = DH / 8;     // k-steps of S = Q K^T
  constexpr int NT = BLOCK_N / 8;    // 8-key column groups of S
  constexpr int OT = DH / 8;         // 8-column groups of O
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // [stage][K, V][BLOCK_N][LD]
  float* qs = smem + C::Q;                        // [BLOCK_M][LD]

  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int tq = threadIdx.x % 4;
  // heaviest causal tiles (the last query rows) go first
  const int tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x % n_q_tiles);
  const size_t bh = blockIdx.x / n_q_tiles;
  const int q0 = tile * BLOCK_M;
  const int w0 = q0 + 16 * warp;  // the warp's first query row
  const int row0 = w0 + g;
  const int row1 = row0 + 8;
  const size_t base = bh * static_cast<size_t>(t) * dh;
  const float* kb = k + base;
  const float* vb = v + base;

  int n_k_tiles = (t + BLOCK_N - 1) / BLOCK_N;
  if (causal) n_k_tiles = min(n_k_tiles, (q0 + BLOCK_M + BLOCK_N - 1) / BLOCK_N);

  load_tile_async<BLOCK_M, DH, THREADS>(qs, q + base, q0, t, dh);
  load_tile_async<BLOCK_N, DH, THREADS>(smem, kb, 0, t, dh);
  load_tile_async<BLOCK_N, DH, THREADS>(smem + TILE, vb, 0, t, dh);
  cp_async_commit();
  const float* qw = qs + 16 * warp * LD;

  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max of rows row0, row1
  float l0 = 0.f, l1 = 0.f;          // this thread's part of the denominators

  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int stage = kt & 1;
    cp_async_wait<0>();
    // tile kt has landed, and every warp is done with the other stage
    __syncthreads();
    if (kt + 1 < n_k_tiles) {
      float* next = smem + (stage ^ 1) * 2 * TILE;
      load_tile_async<BLOCK_N, DH, THREADS>(next, kb, (kt + 1) * BLOCK_N, t, dh);
      load_tile_async<BLOCK_N, DH, THREADS>(next + TILE, vb, (kt + 1) * BLOCK_N, t, dh);
      cp_async_commit();
    }
    const float* ks = smem + stage * 2 * TILE;
    const float* vs = ks + TILE;
    const int k0 = kt * BLOCK_N;
    if (causal && w0 + 15 < k0) continue;  // warp-uniform: all masked

    // S = Q K^T, two k-steps per fresh sum
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; kk += 2) {
      const FragA a[2] = {load_a(qw + 8 * kk, LD, g, tq), load_a(qw + 8 * kk + 8, LD, g, tq)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const FragB b[2] = {load_b_nk(ks + 8 * j * LD + 8 * kk, LD, g, tq),
                            load_b_nk(ks + 8 * j * LD + 8 * kk + 8, LD, g, tq)};
        mma_3xtf32_sum<2>(s[j], a, b);
      }
    }

    // online softmax on the fragments
    const bool mask = k0 + BLOCK_N > t || (causal && k0 + BLOCK_N - 1 > w0);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (mask) {
          const int key = k0 + 8 * j + 2 * tq + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (!(key < t && (!causal || key <= row))) x = NEG_INF;
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every row of a warp that gets here sees key k0 (its first row is at
    // or past k0), so the new max is finite and masked exponentials are 0
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float corr0 = expf(m0 - mn0);
    const float corr1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= corr0;
    l1 *= corr1;
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      o[n][0] *= corr0;
      o[n][1] *= corr0;
      o[n][2] *= corr1;
      o[n][3] *= corr1;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // O += P V, one fresh sum per 8 keys: O is what the backward reads
    // through D = rowsum(dO * O), so it gets the fewest roundings
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const FragA a = acc_to_a(s[j]);
#pragma unroll
      for (int n = 0; n < OT; ++n) {
        mma_3xtf32(o[n], a, load_b_kn_paired(vs + 8 * j * LD + 8 * n, LD, g, tq));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
  if (row0 < t) {
    float* dst = out + base + static_cast<size_t>(row0) * dh + 2 * tq;
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      if (8 * n < dh) {
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][0] / d0, o[n][1] / d0);
      }
    }
    if (tq == 0) lse[bh * static_cast<size_t>(t) + row0] = m0 + logf(d0);
  }
  if (row1 < t) {
    float* dst = out + base + static_cast<size_t>(row1) * dh + 2 * tq;
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      if (8 * n < dh) {
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][2] / d1, o[n][3] / d1);
      }
    }
    if (tq == 0) lse[bh * static_cast<size_t>(t) + row1] = m1 + logf(d1);
  }
}

// the class's instantiation for dh (with_instantiation)
template <int DH>
auto forward_kernel(int dh) {
  return with_instantiation<DH>(dh, [](auto padded) {
    return flash_forward_f32<DH, decltype(padded)::value>;
  });
}

// the kernel's dynamic shared memory in bytes, allowed above 48 KB
template <int DH, typename Kernel>
cudaError_t prepare(Kernel kernel, int* smem) {
  *smem = Fwd<DH>::SMEM_FLOATS * static_cast<int>(sizeof(float));
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   float* lse, int bh, int t, int dh, float scale, int causal,
                   cudaStream_t stream) {
  const int n_q_tiles = (t + BLOCK_M - 1) / BLOCK_M;
  const long long n_blocks = static_cast<long long>(bh) * n_q_tiles;
  if (n_blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const auto kernel = forward_kernel<DH>(dh);
  int smem;
  const cudaError_t err = prepare<DH>(kernel, &smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(n_blocks), THREADS, smem, stream>>>(
      q, k, v, out, lse, t, dh, n_q_tiles, scale, causal);
  return cudaGetLastError();
}

template <int DH>
cudaError_t occupancy(int* smem, int* blocks_per_sm) {
  const auto kernel = forward_kernel<DH>(DH);
  const cudaError_t err = prepare<DH>(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, THREADS, *smem);
}

}  // namespace

// q, k, v, out: (bh, t, dh) contiguous float32, 16-byte aligned;
// lse: (bh, t) float32; dh 16, 32 or a multiple of 8 from 64 to 256.
// Launches on `stream` and does not synchronise. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int gordo_flash_attention_forward_f32(
    const void* q, const void* k, const void* v, void* out, void* lse, int bh,
    int t, int dh, float scale, int causal, void* stream) {
  if (bh <= 0 || t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_head_dim_class(dh, [&](auto c) {
    return launch<decltype(c)::value>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), static_cast<float*>(lse), bh,
        t, dh, scale, causal, static_cast<cudaStream_t>(stream));
  }));
}

// The head-dim class whose instantiations of the three float32 kernels run
// dh (head_dim.cuh), or 0 where they take no dh, for reports
extern "C" int gordo_flash_attention_f32_head_dim_class(int dh) {
  return head_dim_class(dh);
}

// The forward kernel's dynamic shared memory (bytes) and resident blocks per
// SM for head dim `dh` (its class's), for reports. Returns the CUDA error
// code.
extern "C" int gordo_flash_attention_forward_f32_occupancy(int dh, int* smem_bytes,
                                                          int* blocks_per_sm) {
  return static_cast<int>(with_head_dim_class(dh, [&](auto c) {
    return occupancy<decltype(c)::value>(smem_bytes, blocks_per_sm);
  }));
}
