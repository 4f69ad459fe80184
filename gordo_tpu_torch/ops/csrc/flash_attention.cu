// Flash-attention forward for NVIDIA Hopper (sm_90a), float32.
//
// Replaces the TPU kernel `_flash_kernel` of
// gordo_tpu/ops/pallas_kernels/flash_attention.py (launched by
// `_flash_forward`): blockwise self-attention with an online softmax, scale
// 1/sqrt(dh), an optional causal mask, writing the output and the per-row
// logsumexp. The logsumexp is stored as (BH, T) float32, without the TPU's
// 128-lane replication; the backward kernels of a later slice read it.
//
// What bounds it on this card: at the serving shape (BH 4096, T 512, dh 64,
// causal) the work is 4*dh FLOP for each of the BH*T*(T+1)/2 visible
// (query, key) pairs, 1.4e11 FLOP, against 2.2e9 bytes of q/k/v/out/lse.
// That is ~64 FLOP per byte, far above the card's fp32 ridge, so the kernel
// is bound by float32 FMA throughput on the CUDA cores (67 TFLOP/s
// published). The tensor cores are not used: their float32 path is TF32,
// which keeps ~3 decimal digits and would not hold the float32 reference.
//
// What the design does about it (simple and right first; wgmma/TMA later):
// - one thread block per (bh, 64-row query tile), one thread per query row:
//   the row's q and its float32 accumulator live in registers, together
//   with the running max and denominator of the online softmax;
// - K/V tiles of 64 rows are staged through shared memory, and every thread
//   of the block reads the same K/V element at once (a broadcast, no bank
//   conflicts) as float4, so one shared-memory load feeds four FMAs;
// - keys are scored 16 at a time before one softmax rescale, which gives 16
//   independent FMA chains per thread and amortises the rescale;
// - under causal masking the key loop stops at the diagonal tile, and the
//   query tiles with the most work are scheduled first;
// - the ragged tail (T not a multiple of 64) is masked, so any T >= 1 works.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int BLOCK_M = 64;  // query rows per block, one thread each
constexpr int BLOCK_N = 64;  // key/value rows per shared-memory tile
constexpr int CHUNK = 16;    // keys scored before one softmax rescale
constexpr float NEG_INF = -1e30f;  // the mask value of the reference

template <int DH>
__global__ void __launch_bounds__(BLOCK_M)
flash_forward_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int t, int n_q_tiles, float scale,
                  int causal) {
  constexpr int D4 = DH / 4;
  extern __shared__ float4 smem[];
  float4* ks = smem;                 // [BLOCK_N][D4]
  float4* vs = smem + BLOCK_N * D4;  // [BLOCK_N][D4]

  // heaviest causal tiles (the last query rows) go first
  const int tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x % n_q_tiles);
  const size_t bh = blockIdx.x / n_q_tiles;
  const int q0 = tile * BLOCK_M;
  const int row = q0 + static_cast<int>(threadIdx.x);
  const bool valid = row < t;
  const size_t base4 = bh * static_cast<size_t>(t) * D4;  // in float4 units

  float qr[DH];
  float acc[DH];
  {
    const float4* src = reinterpret_cast<const float4*>(q) + base4 +
                        static_cast<size_t>(valid ? row : 0) * D4;
#pragma unroll
    for (int i = 0; i < D4; ++i) {
      const float4 x = valid ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[4 * i + 0] = x.x;
      qr[4 * i + 1] = x.y;
      qr[4 * i + 2] = x.z;
      qr[4 * i + 3] = x.w;
    }
  }
#pragma unroll
  for (int i = 0; i < DH; ++i) acc[i] = 0.f;
  float m = NEG_INF;
  float l = 0.f;

  int n_k_tiles = (t + BLOCK_N - 1) / BLOCK_N;
  if (causal) {
    n_k_tiles = min(n_k_tiles, (q0 + BLOCK_M + BLOCK_N - 1) / BLOCK_N);
  }
  const float4* k4 = reinterpret_cast<const float4*>(k) + base4;
  const float4* v4 = reinterpret_cast<const float4*>(v) + base4;

  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int k0 = kt * BLOCK_N;
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < BLOCK_N * D4; i += BLOCK_M) {
      const int r = i / D4;
      const bool in = k0 + r < t;
      const size_t off = static_cast<size_t>(k0) * D4 + i;
      ks[i] = in ? k4[off] : make_float4(0.f, 0.f, 0.f, 0.f);
      vs[i] = in ? v4[off] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();

    // keys of this tile: [k0, k0 + n_tile); this row sees [k0, k0 + n_keys)
    const int n_tile = min(BLOCK_N, t - k0);
    const int n_keys = causal ? min(n_tile, row - k0 + 1) : n_tile;

    for (int j0 = 0; j0 < n_tile; j0 += CHUNK) {
      float s[CHUNK];
      float m_chunk = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        const float4* kr = ks + (j0 + jj) * D4;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < D4; ++i) {
          const float4 kk = kr[i];
          dot = fmaf(qr[4 * i + 0], kk.x, dot);
          dot = fmaf(qr[4 * i + 1], kk.y, dot);
          dot = fmaf(qr[4 * i + 2], kk.z, dot);
          dot = fmaf(qr[4 * i + 3], kk.w, dot);
        }
        s[jj] = (j0 + jj < n_keys) ? dot * scale : NEG_INF;
        m_chunk = fmaxf(m_chunk, s[jj]);
      }
      const float m_new = fmaxf(m, m_chunk);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        const float p = (j0 + jj < n_keys) ? expf(s[jj] - m_new) : 0.f;
        l += p;
        const float4* vr = vs + (j0 + jj) * D4;
#pragma unroll
        for (int i = 0; i < D4; ++i) {
          const float4 vv = vr[i];
          acc[4 * i + 0] = fmaf(p, vv.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
        }
      }
      m = m_new;
    }
  }

  if (valid) {
    const float denom = fmaxf(l, 1e-30f);
    float4* dst = reinterpret_cast<float4*>(out) + base4 +
                  static_cast<size_t>(row) * D4;
#pragma unroll
    for (int i = 0; i < D4; ++i) {
      dst[i] = make_float4(acc[4 * i + 0] / denom, acc[4 * i + 1] / denom,
                           acc[4 * i + 2] / denom, acc[4 * i + 3] / denom);
    }
    lse[bh * static_cast<size_t>(t) + row] = m + logf(denom);
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   float* lse, int bh, int t, float scale, int causal,
                   cudaStream_t stream) {
  const int n_q_tiles = (t + BLOCK_M - 1) / BLOCK_M;
  const long long n_blocks = static_cast<long long>(bh) * n_q_tiles;
  if (n_blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const int smem = 2 * BLOCK_N * DH * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_forward_f32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  flash_forward_f32<DH><<<static_cast<unsigned>(n_blocks), BLOCK_M, smem,
                          stream>>>(q, k, v, out, lse, t, n_q_tiles, scale,
                                    causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: (bh, t, dh) contiguous float32, 16-byte aligned;
// lse: (bh, t) float32. Launches on `stream` and does not synchronise.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int gordo_flash_attention_forward_f32(
    const void* q, const void* k, const void* v, void* out, void* lse, int bh,
    int t, int dh, float scale, int causal, void* stream) {
  if (bh <= 0 || t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 16: err = launch<16>(qf, kf, vf, of, lf, bh, t, scale, causal, s); break;
    case 32: err = launch<32>(qf, kf, vf, of, lf, bh, t, scale, causal, s); break;
    case 64: err = launch<64>(qf, kf, vf, of, lf, bh, t, scale, causal, s); break;
    case 128: err = launch<128>(qf, kf, vf, of, lf, bh, t, scale, causal, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
