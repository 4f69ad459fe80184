// Flash-attention forward for bf16 inputs on NVIDIA Hopper (sm_90a), on
// the tensor cores in bf16 with float32 sums.
//
// Replaces the TPU kernel `_flash_kernel` of
// gordo_tpu/ops/pallas_kernels/flash_attention.py (launched by
// `_flash_forward`) for bf16 q, k and v, as the JAX package sends them under
// `compute_dtype: bfloat16`: the TPU kernel upcasts them to float32,
// computes in float32 and writes the output in bf16 and the per-row
// logsumexp in float32. So does this kernel (mma_bf16.cuh): S = Q K^T is one
// bf16 mma per 16-deep step (bf16 products are exact in float32), the
// online softmax runs in float32 registers, and O += P V takes P split into
// three bf16 parts. The logsumexp is stored as (BH, T) float32, without the
// TPU's 128-lane replication; the backward kernels read it.
//
// What bounds it on this card: at the serving shape (BH 4096, T 512, dh 64,
// causal) it reads q, k, v and writes out at 2 bytes and lse at 4, 1.08e9
// bytes, 0.32 ms at 3.35 TB/s; its 8*dh FLOP for each of the
// BH*T*(T+1)/2 visible (query, key) pairs (2*dh for S, 6*dh for P V done
// for each of P's three parts) are 2.75e11 FLOP, 0.28 ms at 989 TFLOP/s of
// bf16. So it is bound by bytes, as long as the mma.sync issue rate keeps
// up; the design is the float32 kernel's (flash_attention.cu) with bf16
// fragments, kept simple:
// - one block of 4 warps per (bh, 64-row query tile); each warp owns 16
//   query rows, one m16 strip of mma.sync.m16n8k16;
// - Q stays in shared memory and its fragments are loaded with ldmatrix
//   per use; K and V tiles of 64 rows (32 at dh 128) are double-buffered in
//   shared memory with cp.async: tile j + 1 loads while tile j computes;
//   rows at or past T are zero-filled;
// - S goes into float32 accumulator fragments and the online softmax runs
//   on them in registers: row max by __shfl_xor within each quad, the same
//   NEG_INF mask, max(l, 1e-30) and natural exponentials as the float32
//   kernel, so that lse matches the backward's exp(S - lse);
// - P feeds O += P V straight from its accumulator fragments, split in
//   three, with V's B fragments loaded transposed by ldmatrix;
// - under causal masking the key loop stops at the diagonal tile, a warp
//   whose rows all lie before a key tile skips it, only tiles that cross
//   the diagonal or T are masked, and the query tiles with the most work
//   are scheduled first; any T >= 1 works.

#include <cuda_runtime.h>
#include <limits.h>

#include "mma_bf16.cuh"

namespace {

using namespace gordo_bf16;

constexpr int BLOCK_M = 64;  // query rows per block, 16 per warp
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;  // the mask value of the reference

template <int DH>
struct Fwd {
  static constexpr int BN = DH == 128 ? 32 : 64;  // key rows per K/V tile
  static constexpr int LD = DH + 8;               // shared-memory row stride
  static constexpr int TILE = BN * LD;            // one K or V tile
  static constexpr int Q = 4 * TILE;              // after [stage][K, V]
  static constexpr int SMEM_BYTES = (Q + BLOCK_M * LD) * static_cast<int>(sizeof(bf16));
};

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_forward_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out,
                   float* __restrict__ lse, int t, int n_q_tiles, float scale,
                   int causal) {
  using C = Fwd<DH>;
  constexpr int LD = C::LD, TILE = C::TILE, BN = C::BN;
  constexpr int NT = BN / 8;  // 8-key column groups of S
  constexpr int OT = DH / 8;  // 8-column groups of O
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);  // [stage][K, V][BN][LD]
  bf16* qs = smem + C::Q;                       // [BLOCK_M][LD]

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  // heaviest causal tiles (the last query rows) go first
  const int tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x % n_q_tiles);
  const size_t bh = blockIdx.x / n_q_tiles;
  const int q0 = tile * BLOCK_M;
  const int w0 = q0 + 16 * warp;  // the warp's first query row
  const int row0 = w0 + g;
  const int row1 = row0 + 8;
  const size_t base = bh * static_cast<size_t>(t) * DH;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  int n_k_tiles = (t + BN - 1) / BN;
  if (causal) n_k_tiles = min(n_k_tiles, (q0 + BLOCK_M + BN - 1) / BN);

  load_tile_async<BLOCK_M, DH, THREADS>(qs, q + base, q0, t);
  load_tile_async<BN, DH, THREADS>(smem, kb, 0, t);
  load_tile_async<BN, DH, THREADS>(smem + TILE, vb, 0, t);
  cp_async_commit();
  const bf16* qw = qs + 16 * warp * LD;

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
      bf16* next = smem + (stage ^ 1) * 2 * TILE;
      load_tile_async<BN, DH, THREADS>(next, kb, (kt + 1) * BN, t);
      load_tile_async<BN, DH, THREADS>(next + TILE, vb, (kt + 1) * BN, t);
      cp_async_commit();
    }
    const bf16* ks = smem + stage * 2 * TILE;
    const bf16* vs = ks + TILE;
    const int k0 = kt * BN;
    if (causal && w0 + 15 < k0) continue;  // warp-uniform: all masked

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    product_nt<DH, LD>(s, qw, ks, lane);  // S = Q K^T

    // online softmax on the fragments
    const bool mask = k0 + BN > t || (causal && k0 + BN - 1 > w0);
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
    // every row of a warp that gets here has seen key 0 (in this tile or
    // an earlier one), so the new max is finite and masked exponentials
    // are 0
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
    product_nn<DH, LD>(o, s, vs, lane);  // O += P V
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
  if (row0 < t) {
    bf16* dst = out + base + static_cast<size_t>(row0) * DH + 2 * tq;
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = to_bf16x2(o[n][0] / d0, o[n][1] / d0);
    }
    if (tq == 0) lse[bh * static_cast<size_t>(t) + row0] = m0 + logf(d0);
  }
  if (row1 < t) {
    bf16* dst = out + base + static_cast<size_t>(row1) * DH + 2 * tq;
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = to_bf16x2(o[n][2] / d1, o[n][3] / d1);
    }
    if (tq == 0) lse[bh * static_cast<size_t>(t) + row1] = m1 + logf(d1);
  }
}

// the kernel's dynamic shared memory in bytes, allowed above 48 KB
template <int DH>
cudaError_t prepare(int* smem) {
  *smem = Fwd<DH>::SMEM_BYTES;
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(flash_forward_bf16<DH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

template <int DH>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse,
                   int bh, int t, float scale, int causal, cudaStream_t stream) {
  const int n_q_tiles = (t + BLOCK_M - 1) / BLOCK_M;
  const long long n_blocks = static_cast<long long>(bh) * n_q_tiles;
  if (n_blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  int smem;
  const cudaError_t err = prepare<DH>(&smem);
  if (err != cudaSuccess) return err;
  flash_forward_bf16<DH><<<static_cast<unsigned>(n_blocks), THREADS, smem, stream>>>(
      q, k, v, out, lse, t, n_q_tiles, scale, causal);
  return cudaGetLastError();
}

template <int DH>
cudaError_t occupancy(int* smem, int* blocks_per_sm) {
  const cudaError_t err = prepare<DH>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_forward_bf16<DH>, THREADS, *smem);
}

}  // namespace

// q, k, v, out: (bh, t, dh) contiguous bf16, 16-byte aligned; lse: (bh, t)
// float32. Launches on `stream` and does not synchronise. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int gordo_flash_attention_forward_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse, int bh,
    int t, int dh, float scale, int causal, void* stream) {
  if (bh <= 0 || t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(out);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 16: err = launch<16>(qb, kb, vb, ob, lf, bh, t, scale, causal, s); break;
    case 32: err = launch<32>(qb, kb, vb, ob, lf, bh, t, scale, causal, s); break;
    case 64: err = launch<64>(qb, kb, vb, ob, lf, bh, t, scale, causal, s); break;
    case 128: err = launch<128>(qb, kb, vb, ob, lf, bh, t, scale, causal, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The kernel's dynamic shared memory (bytes) and resident blocks per SM at
// head dim `dh`, for reports. Returns the CUDA error code.
extern "C" int gordo_flash_attention_forward_bf16_occupancy(int dh, int* smem_bytes,
                                                           int* blocks_per_sm) {
  switch (dh) {
    case 16: return static_cast<int>(occupancy<16>(smem_bytes, blocks_per_sm));
    case 32: return static_cast<int>(occupancy<32>(smem_bytes, blocks_per_sm));
    case 64: return static_cast<int>(occupancy<64>(smem_bytes, blocks_per_sm));
    case 128: return static_cast<int>(occupancy<128>(smem_bytes, blocks_per_sm));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
