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
// - flash_bwd_dkv_bf16 replaces `_flash_dkv_kernel`: for each 64-row key
//   tile, loop over query tiles from the diagonal on, and accumulate
//   dV += P^T dO and dK += dS^T Q * scale.
// As the TPU kernels do, they compute in float32 and write dq, dk and dv in
// bf16; D is taken from the stored bf16 O. Products of two bf16 operands
// (S, dP and their transposes) are one bf16 mma each; P and dS, float32,
// are split into three bf16 operands (mma_bf16.cuh). Each output element
// is written by exactly one block, with no atomics, so two runs give
// bit-identical results.
//
// What bounds them on this card: at the training shape (BH 128, T 512,
// dh 64, causal) dQ moves q/k/v/o/dO/dQ at 2 bytes and lse at 4 (50.6 MB,
// 15.1 us at 3.35 TB/s) and does 10*dh FLOP per visible (query, key) pair
// (S and dP once, dS K for each of dS's three parts: 1.1e10 FLOP, 10.9 us
// at 989 TFLOP/s of bf16); dK/dV moves 7 tensors (59.0 MB, 17.6 us) and
// does 16*dh FLOP per pair (S^T and dP^T once, P^T dO and dS^T Q three
// times: 1.7e10 FLOP, 17.4 us). Both are bound by bytes, and at these
// sizes a launch costs about as much. The design is the float32 kernels'
// (flash_attention_bwd.cu) with bf16 fragments, kept simple:
// - one block of 4 warps per (bh, 64-row tile), each warp one m16 strip of
//   16 rows; the other side's rows come in tiles double-buffered with
//   cp.async (tile j + 1 loads while tile j computes), rows at or past T
//   zero-filled; every operand fragment is loaded from shared memory with
//   ldmatrix, transposed where the product needs it, so P, dS and their
//   transposes never leave registers;
// - under causal masking the tile loop ends (dQ) or starts (dK/dV) at the
//   diagonal, a warp whose rows all lie on the masked side of a tile skips
//   it, only tiles that cross the diagonal or T are masked, and the blocks
//   with the most work are scheduled first. Any T >= 1 works; dh is 16,
//   32, 64 or 128 (a template parameter).
// dQ: Q and dO of the block's 64 rows are loaded once; each thread reads
// the lse and computes D of its two rows from global memory while they
// land; K and V tiles of 32 key rows are double-buffered.
// dK/dV: K and V are loaded once; Q, dO and lse tiles of 32 query rows (16
// at dh 128, where more would not fit the registers) are double-buffered,
// and O's tile goes through one buffer into D, recomputed per query tile
// as the TPU kernel does.

#include <cuda_runtime.h>
#include <limits.h>

#include "mma_bf16.cuh"

namespace {

using namespace gordo_bf16;

constexpr int TILE = 64;      // a block's query rows (dQ) or key rows (dK/dV)
constexpr int THREADS = 128;  // 4 warps, 16 rows each

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

// --- dK/dV ---

template <int DH>
struct Dkv {
  // query rows per double-buffered tile: 16 at dh 128 keeps the
  // accumulators in registers
  static constexpr int BQ = DH == 128 ? 16 : 32;
  static constexpr int LD = DH + 8;          // shared-memory row stride
  static constexpr int KV = 0;               // K, then V: [TILE][LD] each
  static constexpr int Q = 2 * TILE * LD;    // [stage][Q, dO][BQ][LD]
  static constexpr int O = Q + 4 * BQ * LD;  // [BQ][LD]
  // float32 after the bf16 tiles (a multiple of 16 bytes): lse [stage][BQ],
  // then D [BQ]
  static constexpr int FLOATS = (O + BQ * LD) * static_cast<int>(sizeof(bf16)) / 4;
  static constexpr int LSE = FLOATS;
  static constexpr int D = LSE + 2 * BQ;
  static constexpr int SMEM_BYTES = (D + BQ) * 4;
};

// issue the loads of query tile q0: Q and dO into `stage`, O, and lse
template <int DH>
__device__ __forceinline__ void load_query_tile(bf16* smem, int stage, const bf16* q,
                                                const bf16* dout, const bf16* o,
                                                const float* lse, int q0, int t) {
  using C = Dkv<DH>;
  constexpr int BQ = C::BQ;
  bf16* qs = smem + C::Q + stage * 2 * BQ * C::LD;
  load_tile_async<BQ, DH, THREADS>(qs, q, q0, t);
  load_tile_async<BQ, DH, THREADS>(qs + BQ * C::LD, dout, q0, t);
  load_tile_async<BQ, DH, THREADS>(smem + C::O, o, q0, t);
  if (threadIdx.x < BQ) {
    const int row = q0 + static_cast<int>(threadIdx.x);
    float* fs = reinterpret_cast<float*>(smem);
    cp_async4(fs + C::LSE + stage * BQ + threadIdx.x, lse + (row < t ? row : 0), row < t);
  }
  cp_async_commit();
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ o,
                   const float* __restrict__ lse, const bf16* __restrict__ dout,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int t, int n_tiles,
                   float scale, int causal) {
  using C = Dkv<DH>;
  constexpr int LD = C::LD;
  constexpr int BQ = C::BQ;
  constexpr int NT = BQ / 8;         // 8-query column groups
  constexpr int OT = DH / 8;         // 8-column groups of dK and dV
  constexpr int TPR = THREADS / BQ;  // threads per row computing D
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  float* fs = reinterpret_cast<float*>(smem4);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  // under causal masking the first key tiles see the most queries: first
  const int tile = static_cast<int>(blockIdx.x % n_tiles);
  const size_t bh = blockIdx.x / n_tiles;
  const int k0 = tile * TILE;
  const int w0 = k0 + 16 * warp;  // the warp's first key row
  const size_t base = bh * static_cast<size_t>(t) * DH;
  const bf16* qb = q + base;
  const bf16* gb = dout + base;
  const bf16* ob = o + base;
  const float* lb = lse + bh * t;

  const int n_q_tiles = (t + BQ - 1) / BQ;
  const int first = causal ? k0 / BQ : 0;  // the diagonal tile
  load_tile_async<TILE, DH, THREADS>(smem + C::KV, k + base, k0, t);
  load_tile_async<TILE, DH, THREADS>(smem + C::KV + TILE * LD, v + base, k0, t);
  load_query_tile<DH>(smem, 0, qb, gb, ob, lb, first * BQ, t);
  const bf16* kw = smem + C::KV + 16 * warp * LD;
  const bf16* vw = kw + TILE * LD;
  float* d_s = fs + C::D;

  float dk_acc[OT][4], dv_acc[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  for (int qt = first; qt < n_q_tiles; ++qt) {
    const int stage = (qt - first) & 1;
    const int q0 = qt * BQ;
    const bf16* qs = smem + C::Q + stage * 2 * BQ * LD;
    const bf16* dos = qs + BQ * LD;
    const float* lse_s = fs + C::LSE + stage * BQ;
    cp_async_wait<0>();
    // tile qt has landed; every warp is done with tile qt - 1 (D, the
    // other stage)
    __syncthreads();
    {  // D = rowsum(dO * O), TPR threads per row; rows past t are zero
      const int r = threadIdx.x / TPR;
      const int part = threadIdx.x % TPR;
      const uint4* orow = reinterpret_cast<const uint4*>(smem + C::O + r * LD);
      const uint4* grow = reinterpret_cast<const uint4*>(dos + r * LD);
      float d = 0.f;
#pragma unroll
      for (int c = part; c < DH / 8; c += TPR) d = dot8(orow[c], grow[c], d);
#pragma unroll
      for (int step = 1; step < TPR; step *= 2) d += __shfl_xor_sync(0xffffffffu, d, step);
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
    product_nt<DH, LD>(p, kw, qs, lane);
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
    product_nn<DH, LD>(dv_acc, p, dos, lane);  // dV += P^T dO
    // dP^T = V dO^T, then dS^T = P^T * (dP^T - D)
    float ds[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
    product_nt<DH, LD>(ds, vw, dos, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[n][e] = p[n][e] * (ds[n][e] - d_s[8 * n + 2 * tq + (e & 1)]);
      }
    }
    product_nn<DH, LD>(dk_acc, ds, qs, lane);  // dK += dS^T Q (times scale below)
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = w0 + g + 8 * half;
    if (key >= t) continue;
    bf16* dkr = dk + base + static_cast<size_t>(key) * DH + 2 * tq;
    bf16* dvr = dv + base + static_cast<size_t>(key) * DH + 2 * tq;
#pragma unroll
    for (int m = 0; m < OT; ++m) {
      *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * m) =
          to_bf16x2(dk_acc[m][2 * half] * scale, dk_acc[m][2 * half + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * m) =
          to_bf16x2(dv_acc[m][2 * half], dv_acc[m][2 * half + 1]);
    }
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

template <int DH>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                       const float* lse, const bf16* dout, bf16* dk, bf16* dv, int bh,
                       int t, float scale, int causal, cudaStream_t stream) {
  const int smem = Dkv<DH>::SMEM_BYTES;
  unsigned n_blocks;
  int n_tiles;
  const cudaError_t err =
      prepare(flash_bwd_dkv_bf16<DH>, bh, t, smem, &n_blocks, &n_tiles);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_bf16<DH><<<n_blocks, THREADS, smem, stream>>>(
      q, k, v, o, lse, dout, dk, dv, t, n_tiles, scale, causal);
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

template <int DH>
cudaError_t dkv_occupancy(int* smem, int* blocks_per_sm) {
  return occupancy(flash_bwd_dkv_bf16<DH>, Dkv<DH>::SMEM_BYTES, smem, blocks_per_sm);
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
    case 16: err = launch_dkv<16>(qb, kb, vb, ob, lf, gb, dkb, dvb, bh, t, scale, causal, s); break;
    case 32: err = launch_dkv<32>(qb, kb, vb, ob, lf, gb, dkb, dvb, bh, t, scale, causal, s); break;
    case 64: err = launch_dkv<64>(qb, kb, vb, ob, lf, gb, dkb, dvb, bh, t, scale, causal, s); break;
    case 128: err = launch_dkv<128>(qb, kb, vb, ob, lf, gb, dkb, dvb, bh, t, scale, causal, s); break;
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
    case 16: return static_cast<int>(dkv_occupancy<16>(smem_bytes, blocks_per_sm));
    case 32: return static_cast<int>(dkv_occupancy<32>(smem_bytes, blocks_per_sm));
    case 64: return static_cast<int>(dkv_occupancy<64>(smem_bytes, blocks_per_sm));
    case 128: return static_cast<int>(dkv_occupancy<128>(smem_bytes, blocks_per_sm));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
