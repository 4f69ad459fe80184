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
// far above the fp32 ridge, so both are bound by float32 FMA throughput
// on the CUDA cores (67 TFLOP/s published): 0.096 ms and 0.128 ms. The
// tensor cores are not used: their float32 path is TF32, which keeps
// ~3 decimal digits and would not hold the float32 reference.
//
// What the design does about it (right and simple first; wgmma/TMA later):
// - one thread per row, as in the forward, would not fit: a dQ row needs
//   q, dO and its accumulator, a dK/dV row k, v and two accumulators. So
//   a block of 256 threads stages 64-row tiles in shared memory and
//   computes the 64x64 S and dP tiles together, each thread a 4x4
//   sub-tile, reading float4s from rows padded by 4 floats (no bank
//   conflicts; one operand is a broadcast within each quarter warp);
// - P and dS go to shared memory, and each thread then accumulates a
//   4-row slice of dQ (or of dK and dV) in registers, an outer product per
//   key (or query) that reuses each shared-memory load for 4 FMAs or more;
// - under causal masking the dQ key loop stops at the diagonal tile and
//   the dK/dV query loop starts there; the tiles with the most work are
//   scheduled first;
// - the ragged tail (T not a multiple of 64) is zero-filled and masked, so
//   any T >= 1 works; dh is 16, 32, 64 or 128 (a template parameter).
// Shared memory is 4 tiles of 64 x (dh + 4) floats plus two 64 x 68 score
// tiles: 38-152 KB, above 48 KB only through the dynamic-size attribute.

#include <cuda_runtime.h>
#include <limits.h>

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

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ lse, const float* __restrict__ dout,
                  float* __restrict__ dk, float* __restrict__ dv, int t,
                  int n_tiles, float scale, int causal) {
  constexpr int LD = DH + PAD;
  constexpr int CPT = DH / 16;  // dK / dV columns per thread
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [TILE][LD]
  float* vs = ks + TILE * LD;                   // [TILE][LD]
  float* qs = vs + TILE * LD;                   // [TILE][LD]
  float* dos = qs + TILE * LD;                  // [TILE][LD]
  float* ps = dos + TILE * LD;                  // P: [query][key], LDP
  float* dss = ps + TILE * LDP;                 // dS: [query][key], LDP
  float* lse_s = dss + TILE * LDP;              // [TILE]
  float* d_s = lse_s + TILE;                    // [TILE]

  // under causal masking the first key tiles see the most queries: first
  const int tile = static_cast<int>(blockIdx.x % n_tiles);
  const size_t bh = blockIdx.x / n_tiles;
  const int k0 = tile * TILE;
  const size_t base = bh * static_cast<size_t>(t) * DH;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_tile<DH>(ks, k + base, k0, t);
  load_tile<DH>(vs, v + base, k0, t);

  // score sub-tile: query rows tx + 16i, key rows 4ty + j of the tile
  const int rq[4] = {tx, tx + 16, tx + 32, tx + 48};
  const int rk[4] = {4 * ty, 4 * ty + 1, 4 * ty + 2, 4 * ty + 3};
  // dK / dV slices: key rows 4ty + j, columns tx * CPT ...
  float dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dk_acc[j][c] = 0.f;
      dv_acc[j][c] = 0.f;
    }
  }

  for (int qt = causal ? tile : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();  // k/v are written; the last tile is consumed
    load_tile<DH>(qs, q + base, q0, t);
    load_tile<DH>(dos, dout + base, q0, t);
    load_row_stats<DH>(lse_s, d_s, lse + bh * t, o + base, dout + base, q0, t);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dots<DH>(qs, ks, rq, rk, s);
    tile_dots<DH>(dos, vs, rq, rk, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int query = q0 + rq[i];
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + rk[j];
        const bool live = query < t && key < t && (!causal || key <= query);
        p[j] = live ? expf(s[i][j] * scale - lse_s[rq[i]]) : 0.f;
        ds[j] = p[j] * (dp[i][j] - d_s[rq[i]]);
      }
      *reinterpret_cast<float4*>(ps + rq[i] * LDP + 4 * ty) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dss + rq[i] * LDP + 4 * ty) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over this tile's queries
#pragma unroll 2
    for (int r = 0; r < TILE; ++r) {
      const float4 pw = *reinterpret_cast<const float4*>(ps + r * LDP + 4 * ty);
      const float4 sw = *reinterpret_cast<const float4*>(dss + r * LDP + 4 * ty);
      float gr[CPT], qr[CPT];
      load_vec<CPT>(dos + r * LD + tx * CPT, gr);
      load_vec<CPT>(qs + r * LD + tx * CPT, qr);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        dv_acc[0][c] = fmaf(pw.x, gr[c], dv_acc[0][c]);
        dv_acc[1][c] = fmaf(pw.y, gr[c], dv_acc[1][c]);
        dv_acc[2][c] = fmaf(pw.z, gr[c], dv_acc[2][c]);
        dv_acc[3][c] = fmaf(pw.w, gr[c], dv_acc[3][c]);
        dk_acc[0][c] = fmaf(sw.x, qr[c], dk_acc[0][c]);
        dk_acc[1][c] = fmaf(sw.y, qr[c], dk_acc[1][c]);
        dk_acc[2][c] = fmaf(sw.z, qr[c], dk_acc[2][c]);
        dk_acc[3][c] = fmaf(sw.w, qr[c], dk_acc[3][c]);
      }
    }
  }
  store_rows<DH, CPT>(dk + base, dk_acc, k0 + 4 * ty, tx * CPT, t, scale);
  store_rows<DH, CPT>(dv + base, dv_acc, k0 + 4 * ty, tx * CPT, t, 1.f);
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
  const int smem = smem_floats<DH>() * static_cast<int>(sizeof(float));
  unsigned n_blocks;
  int n_tiles;
  const cudaError_t err =
      prepare(flash_bwd_dkv_f32<DH>, bh, t, smem, &n_blocks, &n_tiles);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_f32<DH><<<n_blocks, THREADS, smem, stream>>>(
      q, k, v, o, lse, dout, dk, dv, t, n_tiles, scale, causal);
  return cudaGetLastError();
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
