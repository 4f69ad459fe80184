// The LSTM recurrence for NVIDIA Hopper (sm_90a): a forward kernel and a
// backward kernel, each for float32 and bf16 inputs, summing in float32.
//
// Replaces no Pallas kernel. The JAX package runs its LSTM layer
// (`_apply_lstm`, gordo_tpu/ops/nn.py:205) as one `lax.scan`, which XLA
// compiles into one program with a fused loop body. Run eagerly, the same
// loop launches about ten kernels a time step forward and twice that
// backward, each waiting on the host. The port splits the layer as cuDNN
// does: the input projection Zx = X kernel + bias of every step is one
// large matmul (ops/nn.py), and these kernels run the recurrence over all
// time steps in one launch each:
//
//   forward   z_t = Zx_t + h_{t-1} R           (R = recurrent_kernel, U x 4U)
//             i, f, g, o = rec(z_i), rec(z_f), act(z_g), rec(z_o)
//             c_t = f c_{t-1} + i g,   h_t = o act(c_t)
//   backward  from dh (every step, or the last) the gate gradients dZ of
//             every step, with dh_{t-1} += dz_t R^T and dc_{t-1} = dc_t f_t
//
// The weight gradients (sum_t h_{t-1}^T dz_t, X^T dZ, sum dZ) and dX stay
// torch matmuls over the stored tensors (ops/lstm.py), so neither kernel
// needs atomics and the backward is bit-identical when run twice.
//
// Rounding follows the JAX code: c and h are carried in float32; under
// bf16 the product takes h rounded to bf16 (h.astype(x.dtype)), the gate
// pre-activation is rounded to bf16 and then taken to float32, and so are
// dZ and the recurrent term of dh in the backward.
//
// What bounds it on this card. The steps are sequential: a step is one
// product of (batch rows x U) by (U x 4U) and a cell, and the next step
// needs all of it. The product's FLOP at the tensor cores' rate take
// nanoseconds at every shape the repo runs (U 64 x 64 rows: 2 MFLOP), so a
// step's time is its chain: the product's fragment loads and dependent mma,
// the cell's transcendentals, the exchange of h (backward: dz) between the
// threads that compute it and those that read it, the barrier, and the
// latency of the next step's inputs. Only the stacked fleet steps come near
// the launch's bytes (Zx in; h, z, c out). The design, by what it does about
// each:
// - The product on the tensor cores, "swap-AB": R's gate columns (backward:
//   R's unit rows, over dz's gate columns) are the M side of the mma and
//   the batch rows the N side, so a tile of 8 to 32 rows needs no padding.
//   bf16 runs `mma.sync` m16n8k16 (the operands are exact as the JAX code
//   rounds them), two accumulator chains; float32 runs 3xTF32 `mma.sync`
//   m16n8k8 (mma_tf32x3.cuh), a fresh accumulator every k8 step added in
//   float32, as the float32 flash kernels do. wgmma would need 64-row tiles
//   of one warpgroup, against 16 rows a warp here, on a chain this short.
// - R on chip for the whole sequence, in fragment order: each CTA of a
//   thread-block cluster (1 to 16 CTAs, lstm_plan.cuh) owns U / cluster
//   units and holds their rows of the product in shared memory as each
//   lane's A fragments (float32 already split into TF32 big and small), so
//   a k step's A is one or two 16-byte loads and no split. At U 256 a
//   cluster of 16 holds float32 R as 16 x 128 KiB of fragments. Each step
//   every CTA writes its units' h (dz) into every CTA of the cluster through
//   DSMEM, into a double buffer, and the cluster's barrier (__syncthreads
//   without one) ends the step. Where even 16 CTAs cannot hold R (U 512 in
//   float32) each CTA reads its slice from L2 once a step (the STREAM
//   route: 0.11-0.49x the legacy route's time there, 0.98x for the float32
//   backward over 256 rows; scripts/torch_lstm_ab.py --stream on an H100).
// - The cell in the product's epilogue: the forward's rows are R's columns
//   gate-interleaved (lstm_plan.cuh `interleaved_column`: blocks of 8
//   units, i f g o), so the thread that holds the accumulators of (unit,
//   row) holds all four gates, keeps c in registers for all T steps and
//   writes h itself; the backward's thread holds dh of (unit, row) and
//   keeps dc in registers. With a k split, 2 (forward) or 4 (backward) warps
//   share a tile: each sums its part of K, the parts meet in shared memory
//   after one more barrier, and each warp finishes its share of the cells,
//   so a step's chain is shorter where few rows leave SMs idle.
// - Nothing from device memory on the step's chain: a thread loads its
//   cells' Zx (backward: z, c_{t-1} and dout) one to three steps ahead into
//   a register ring; the stores of z, c, h and dz are not waited for.
// - A plan that fills the card (lstm_plan.cuh): the cluster, row tile (8,
//   16, 32) and k split with the most CTAs within one wave of 132 SMs; the
//   fleet step (64 x 64 rows, U 64) runs 128 CTAs of 32 rows without a
//   cluster, a served request (2,048 windows) 128 of 16 rows, the default
//   width (32 rows, U 256) 4 row tiles x 16 CTAs.
// - The LEGACY route: the first port's CUDA-core kernels (a block per
//   (machine, tile of 1 to 8 rows) that owns all 4U gate columns, R in
//   shared memory where it fits, else through L2, two barriers a step) run
//   below U 8 (examples/config.yaml's compressor-b: U 2 and 3, padded to 16
//   here), for U <= 64 over at most 132 rows (M B), where their block a row
//   beats the tensor-core step (scripts/torch_lstm_ab.py), and where no
//   tensor-core route holds the buffers (U near 1,000 and above).
// The activations are a switch on compile-time codes: every name of
// ops/nn.py's ACTIVATIONS, gelu in its tanh form as jax.nn.gelu. The
// factories' (tanh, sigmoid) pair is compiled as constants (read at run
// time, the same pair took 0.92-1.89x the time in the legacy kernels on an
// H100: scripts/torch_lstm_act_variants.py). Any other pair reads its codes
// from the arguments (a uniform branch).
// Training stores z (float32), c (float32) and h (the input dtype) of every
// step for the backward; serving stores nothing but the output.

//
// The build compiles this file in parts, at once (ops/_build.py PARTS), and
// links them into one library: GORDO_PART 0 holds the legacy kernels, the
// plan's dispatch and the C entry points, parts 1-8 the tensor-core kernels
// of one input type, activation pair and direction each (tc_route, the
// costliest code to compile). Without GORDO_PART the file is one
// translation unit of all of it, as nvcc compiles it alone.
#ifndef GORDO_PART
#define GORDO_PART -1
#endif

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

#include <cstdint>
#include <mutex>

#include "lstm_plan.cuh"
#include "mma_tf32x3.cuh"

namespace cg = cooperative_groups;

namespace gordo_lstm {

struct FwdArgs {
  const void* zx;   // (M, B, T, 4U)
  const void* rk;   // (M, U, 4U)
  void* out;        // (M, B, T, U) with return_sequences, else (M, B, U)
  void* h_save;     // (M, B, T, U) or null
  float* z_save;    // (M, B, T, 4U) or null
  float* c_save;    // (M, B, T, U) or null
  int m, b, t, u, bt, act, rec, return_sequences;
};

struct BwdArgs {
  const void* dout;    // (M, B, T, U) with return_sequences, else (M, B, U)
  const float* z;      // (M, B, T, 4U)
  const float* c;      // (M, B, T, U)
  const void* rkt;     // (M, 4U, U): recurrent_kernel transposed
  void* dz;            // (M, B, T, 4U)
  int m, b, t, u, bt, act, rec, return_sequences;
};

}  // namespace gordo_lstm

namespace {

using namespace gordo_lstm;

// the order of ACTIVATION_CODES in gordo_tpu_torch/ops/activations.py
enum Act {
  LINEAR = 0, TANH, RELU, SIGMOID, ELU, SELU, SOFTPLUS, SOFTSIGN, SWISH, GELU,
  LEAKY_RELU, EXPONENTIAL, HARD_SIGMOID, N_ACTS, DYNAMIC = -1
};

constexpr float SELU_SCALE = 1.0507009873554804934193349852946f;
constexpr float SELU_ALPHA = 1.6732632423543772848170429916717f;
constexpr float GELU_K = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float GELU_C = 0.044715f;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float act_value(int code, float x) {
  switch (code) {
    case LINEAR: return x;
    case TANH: return tanhf(x);
    case RELU: return fmaxf(x, 0.f);
    case SIGMOID: return sigmoid(x);
    case ELU: return x > 0.f ? x : expm1f(x);
    case SELU: return SELU_SCALE * (x > 0.f ? x : SELU_ALPHA * expm1f(x));
    case SOFTPLUS: return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
    case SOFTSIGN: return x / (1.f + fabsf(x));
    case SWISH: return x * sigmoid(x);
    case GELU: return 0.5f * x * (1.f + tanhf(GELU_K * (x + GELU_C * x * x * x)));
    case LEAKY_RELU: return x >= 0.f ? x : 0.01f * x;
    case EXPONENTIAL: return expf(x);
    case HARD_SIGMOID: return fminf(fmaxf(x + 3.f, 0.f), 6.f) / 6.f;
    default: return 0.f;
  }
}

// the derivative at x, with the JAX package's choices at the kinks
__device__ __forceinline__ float act_grad(int code, float x) {
  switch (code) {
    case LINEAR: return 1.f;
    case TANH: { const float t = tanhf(x); return 1.f - t * t; }
    case RELU: return x > 0.f ? 1.f : 0.f;
    case SIGMOID: { const float s = sigmoid(x); return s * (1.f - s); }
    case ELU: return x > 0.f ? 1.f : expf(x);
    case SELU: return SELU_SCALE * (x > 0.f ? 1.f : SELU_ALPHA * expf(x));
    case SOFTPLUS: return sigmoid(x);
    case SOFTSIGN: { const float d = 1.f + fabsf(x); return 1.f / (d * d); }
    case SWISH: { const float s = sigmoid(x); return s * (1.f + x * (1.f - s)); }
    case GELU: {
      const float t = tanhf(GELU_K * (x + GELU_C * x * x * x));
      return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * GELU_K * (1.f + 3.f * GELU_C * x * x);
    }
    case LEAKY_RELU: return x >= 0.f ? 1.f : 0.01f;
    case EXPONENTIAL: return expf(x);
    case HARD_SIGMOID: return (x > -3.f && x < 3.f) ? (1.f / 6.f) : 0.f;
    default: return 0.f;
  }
}

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and back: the identity for float32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
}

// ------------------------------------------------------------ the legacy route
template <typename T, int BT, int ACT, int REC>
__global__ void __launch_bounds__(LEGACY_THREADS)
legacy_forward(const T* __restrict__ zx, const T* __restrict__ rk, T* __restrict__ out,
             T* __restrict__ h_save, float* __restrict__ z_save, float* __restrict__ c_save,
             int b_total, int t_len, int u, int r_in_smem, int return_sequences,
             int act_arg, int rec_arg) {
  const int act = ACT >= 0 ? ACT : act_arg;
  const int rec = REC >= 0 ? REC : rec_arg;
  extern __shared__ float4 smem4[];
  const int g4 = 4 * u;
  float* h_s = reinterpret_cast<float*>(smem4);  // [BT][U], h rounded to T
  float* c_s = h_s + BT * u;                     // [BT][U]
  float* z_s = c_s + BT * u;                     // [BT][4U]
  T* r_s = reinterpret_cast<T*>(z_s + BT * g4);  // [U][4U] when r_in_smem
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b0 = blockIdx.x * BT;
  const int nb = min(BT, b_total - b0);
  const long long row0 = static_cast<long long>(blockIdx.y) * b_total + b0;
  const T* r = rk + static_cast<long long>(blockIdx.y) * u * g4;
  if (r_in_smem) {
    for (int e = tid; e < u * g4; e += nt) r_s[e] = r[e];
    r = r_s;
  }
  for (int p = tid; p < BT * u; p += nt) {
    h_s[p] = 0.f;
    c_s[p] = 0.f;
  }
  __syncthreads();
  for (int t = 0; t < t_len; ++t) {
    // z_t = Zx_t + h_{t-1} R: a thread per gate column, BT rows each
    for (int j = tid; j < g4; j += nt) {
      float zin[BT], acc[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        zin[b] = b < nb ? to_float<T>(zx[((row0 + b) * t_len + t) * g4 + j]) : 0.f;
        acc[b] = 0.f;
      }
      for (int k = 0; k < u; ++k) {
        const float w = to_float<T>(r[static_cast<long long>(k) * g4 + j]);
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[b] = fmaf(h_s[b * u + k], w, acc[b]);
      }
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        if (b < nb) {
          const float z = round_to<T>(zin[b] + acc[b]);
          z_s[b * g4 + j] = z;
          if (z_save) z_save[((row0 + b) * t_len + t) * g4 + j] = z;
        }
      }
    }
    __syncthreads();
    // the cell, over (row, unit) pairs
    for (int p = tid; p < nb * u; p += nt) {
      const int b = p / u, k = p - b * u;
      const float* zb = z_s + b * g4;
      const float i = act_value(rec, zb[k]);
      const float f = act_value(rec, zb[u + k]);
      const float g = act_value(act, zb[2 * u + k]);
      const float o = act_value(rec, zb[3 * u + k]);
      const float c = f * c_s[p] + i * g;
      const T h = from_float<T>(o * act_value(act, c));
      c_s[p] = c;
      h_s[p] = to_float<T>(h);
      const long long step = (row0 + b) * t_len + t;
      if (c_save) c_save[step * u + k] = c;
      if (h_save) h_save[step * u + k] = h;
      if (return_sequences) {
        out[step * u + k] = h;
      } else if (t == t_len - 1) {
        out[(row0 + b) * u + k] = h;
      }
    }
    __syncthreads();
  }
}

template <typename T, int BT, int ACT, int REC>
__global__ void __launch_bounds__(LEGACY_THREADS)
legacy_backward(const T* __restrict__ dout, const float* __restrict__ z_save,
              const float* __restrict__ c_save, const T* __restrict__ rkt,
              T* __restrict__ dz_out, int b_total, int t_len, int u, int r_in_smem,
              int return_sequences, int act_arg, int rec_arg) {
  const int act = ACT >= 0 ? ACT : act_arg;
  const int rec = REC >= 0 ? REC : rec_arg;
  extern __shared__ float4 smem4[];
  const int g4 = 4 * u;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int parts = legacy_parts(u, nt);
  float* dc_s = reinterpret_cast<float*>(smem4);  // [BT][U]
  float* dz_s = dc_s + BT * u;                    // [BT][4U], dz rounded to T
  float* part_s = dz_s + BT * g4;                 // [parts][BT][U], dz R^T partial sums
  T* rt_s = reinterpret_cast<T*>(part_s + parts * BT * u);  // [4U][U] when r_in_smem
  const int b0 = blockIdx.x * BT;
  const int nb = min(BT, b_total - b0);
  const long long row0 = static_cast<long long>(blockIdx.y) * b_total + b0;
  const T* rt = rkt + static_cast<long long>(blockIdx.y) * g4 * u;
  if (r_in_smem) {
    for (int e = tid; e < g4 * u; e += nt) rt_s[e] = rt[e];
    rt = rt_s;
  }
  for (int p = tid; p < BT * u; p += nt) dc_s[p] = 0.f;
  for (int p = tid; p < BT * g4; p += nt) dz_s[p] = 0.f;
  for (int p = tid; p < parts * BT * u; p += nt) part_s[p] = 0.f;
  __syncthreads();
  // the sums over j of dz_t R^T split into `parts` ranges of gate columns
  const int span = (g4 + parts - 1) / parts;
  for (int t = t_len - 1; t >= 0; --t) {
    // the cell's gradients, over (row, unit) pairs
    for (int p = tid; p < nb * u; p += nt) {
      const int b = p / u, k = p - b * u;
      const long long step = (row0 + b) * t_len + t;
      float rec_dh = 0.f;
      for (int q = 0; q < parts; ++q) rec_dh += part_s[(q * BT + b) * u + k];
      float dh = round_to<T>(rec_dh);
      if (return_sequences) {
        dh += to_float<T>(dout[step * u + k]);
      } else if (t == t_len - 1) {
        dh += to_float<T>(dout[(row0 + b) * u + k]);
      }
      const float* zb = z_save + step * g4;
      const float zi = zb[k], zf = zb[u + k], zg = zb[2 * u + k], zo = zb[3 * u + k];
      const float i = act_value(rec, zi), f = act_value(rec, zf);
      const float g = act_value(act, zg), o = act_value(rec, zo);
      const float c = c_save[step * u + k];
      const float c_prev = t > 0 ? c_save[(step - 1) * u + k] : 0.f;
      const float d_o = dh * act_value(act, c);
      const float dc = dc_s[p] + dh * o * act_grad(act, c);
      dc_s[p] = dc * f;
      const float dz[4] = {dc * g * act_grad(rec, zi), dc * c_prev * act_grad(rec, zf),
                           dc * i * act_grad(act, zg), d_o * act_grad(rec, zo)};
      T* dzo = dz_out + step * g4;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        const T v = from_float<T>(dz[gate]);
        dz_s[b * g4 + gate * u + k] = to_float<T>(v);
        dzo[gate * u + k] = v;
      }
    }
    __syncthreads();
    // dz_t R^T: thread (part, unit k) sums its range of gate columns
    for (int q = tid; q < parts * u; q += nt) {
      const int part = q / u, k = q - part * u;
      const int j0 = part * span, j1 = min(g4, j0 + span);
      float acc[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = 0.f;
      for (int j = j0; j < j1; ++j) {
        const float w = to_float<T>(rt[static_cast<long long>(j) * u + k]);
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[b] = fmaf(dz_s[b * g4 + j], w, acc[b]);
      }
#pragma unroll
      for (int b = 0; b < BT; ++b) part_s[(part * BT + b) * u + k] = acc[b];
    }
    __syncthreads();
  }
}


// ------------------------------------------------------------ the tensor-core routes
// The cell's activations: tanh and sigmoid (the factories' pair) from one
// MUFU.EX2 and one reciprocal each, within ~1e-7 of tanhf and the exact
// sigmoid; every other name as act_value and act_grad compute it
__device__ __forceinline__ float fast_sigmoid(float x) { return __frcp_rn(1.f + __expf(-x)); }

__device__ __forceinline__ float fast_tanh(float x) {
  const float t = __expf(-2.f * fabsf(x));
  return copysignf((1.f - t) * __frcp_rn(1.f + t), x);
}

__device__ __forceinline__ float cell_value(int code, float x) {
  return code == TANH ? fast_tanh(x) : code == SIGMOID ? fast_sigmoid(x) : act_value(code, x);
}

__device__ __forceinline__ float cell_grad(int code, float x) {
  if (code == TANH) {
    const float t = fast_tanh(x);
    return 1.f - t * t;
  }
  if (code == SIGMOID) {
    const float s = fast_sigmoid(x);
    return s * (1.f - s);
  }
  return act_grad(code, x);
}

// d += a b: one m16n8k16 bf16 product with float32 sums (fragment layouts as
// in mma_tf32x3.cuh, k doubled: a0a1 (g, 2q..2q+1), a2a3 (g + 8, 2q..),
// a4a5 (g, 2q + 8..), a6a7 (g + 8, 2q + 8..); b0b1 (k 2q.., n g), b2b3
// (k 2q + 8.., n g); the lower half of a register holds the lower k)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// the product's k step: 3xTF32 m16n8k8 for float32, m16n8k16 for bf16
template <typename T>
constexpr int K_STEP = sizeof(T) == 4 ? 8 : 16;

// A lane's A fragment of one m16 tile and k step as held in shared memory:
// float32 its four values split into TF32 big and small (two 16-byte
// loads), bf16 its four pairs (one 16-byte load)
struct FragF32 {
  uint4 big, small;
};
template <typename T>
using Frag = typename std::conditional<sizeof(T) == 4, FragF32, uint4>::type;

// The forward's A rows: row p of the CTA is interleaved position q0 + p
// (R's column interleaved_column(u, q0 + p)), k a unit of h; zero for
// padded units
template <typename T>
struct FwdR {
  const T* r;  // (U, 4U) of this machine
  int u, q0;
  __device__ __forceinline__ T elem(int p, int k) const {
    const int col = interleaved_column(u, q0 + p);
    return k < u && col >= 0 ? r[static_cast<long long>(k) * 4 * u + col] : from_float<T>(0.f);
  }
  __device__ __forceinline__ float at(int p, int k) const { return to_float<T>(elem(p, k)); }
  __device__ __forceinline__ uint32_t pair(int p, int k) const {
    return pack(elem(p, k), elem(p, k + 1));
  }
};

// The backward's A rows: row m is unit u0 + m of R, column j gate column
// (j / up) of unit j % up; zero for padded units
template <typename T>
struct BwdR {
  const T* rt;  // (4U, U) of this machine: R transposed
  int u, up, u0;
  __device__ __forceinline__ T elem(int m, int j) const {
    const int gate = j / up, v = j - gate * up;
    return v < u && u0 + m < u ? rt[(static_cast<long long>(gate) * u + v) * u + u0 + m]
                               : from_float<T>(0.f);
  }
  __device__ __forceinline__ float at(int m, int j) const { return to_float<T>(elem(m, j)); }
  __device__ __forceinline__ uint32_t pair(int m, int j) const {
    return pack(elem(m, j), elem(m, j + 1));
  }
};

// lane (g, q)'s A fragment of m16 tile mt at k step kk, read from R
template <typename Src>
__device__ __forceinline__ gordo_mma::FragA frag32(const Src& src, int mt, int kk, int g, int q) {
  const int r = mt * 16, k = kk * 8;
  return gordo_mma::split_a(src.at(r + g, k + q), src.at(r + g + 8, k + q),
                            src.at(r + g, k + q + 4), src.at(r + g + 8, k + q + 4));
}

template <typename Src>
__device__ __forceinline__ void frag16(const Src& src, int mt, int kk, int g, int q,
                                       uint32_t (&a)[4]) {
  const int r = mt * 16, k = kk * 16;
  a[0] = src.pair(r + g, k + 2 * q);
  a[1] = src.pair(r + g + 8, k + 2 * q);
  a[2] = src.pair(r + g, k + 2 * q + 8);
  a[3] = src.pair(r + g + 8, k + 2 * q + 8);
}

// The A operand held in shared memory in fragment order: lane l's fragment
// of m16 tile mt at k step kk at f[(mt kk_n + kk) 32 + l], loaded once
template <typename T>
struct HeldA {
  const Frag<T>* f;
  int kk_n;
  __device__ __forceinline__ gordo_mma::FragA a32(int mt, int kk, int lane, int, int) const {
    const FragF32 x = f[(mt * kk_n + kk) * 32 + lane];
    gordo_mma::FragA a;
    a.big[0] = x.big.x, a.big[1] = x.big.y, a.big[2] = x.big.z, a.big[3] = x.big.w;
    a.small[0] = x.small.x, a.small[1] = x.small.y, a.small[2] = x.small.z;
    a.small[3] = x.small.w;
    return a;
  }
  __device__ __forceinline__ void a16(int mt, int kk, int lane, int, int, uint32_t (&a)[4]) const {
    const uint4 x = f[(mt * kk_n + kk) * 32 + lane];
    a[0] = x.x, a[1] = x.y, a[2] = x.z, a[3] = x.w;
  }
};

// The A operand read from device memory at every step (the STREAM route)
template <typename Src>
struct StreamedA {
  Src src;
  __device__ __forceinline__ gordo_mma::FragA a32(int mt, int kk, int, int g, int q) const {
    return frag32(src, mt, kk, g, q);
  }
  __device__ __forceinline__ void a16(int mt, int kk, int, int g, int q, uint32_t (&a)[4]) const {
    frag16(src, mt, kk, g, q, a);
  }
};

// the held fragments of `mtiles` m16 tiles over kk_n k steps, from R
template <typename T, typename Src>
__device__ __forceinline__ void fill_held(Frag<T>* f, int mtiles, int kk_n, const Src& src) {
  for (int e = threadIdx.x; e < mtiles * kk_n * 32; e += blockDim.x) {
    const int lane = e % 32, kk = (e / 32) % kk_n, mt = e / 32 / kk_n;
    if constexpr (sizeof(T) == 4) {
      const gordo_mma::FragA a = frag32(src, mt, kk, lane / 4, lane % 4);
      f[e] = FragF32{make_uint4(a.big[0], a.big[1], a.big[2], a.big[3]),
                     make_uint4(a.small[0], a.small[1], a.small[2], a.small[3])};
    } else {
      uint32_t a[4];
      frag16(src, mt, kk, lane / 4, lane % 4, a);
      f[e] = make_uint4(a[0], a[1], a[2], a[3]);
    }
  }
}

// acc[i][n] = A[m16 tile mt[i]] B[b0[n] .. + 8]^T over k steps [kk0, kk1),
// B the shared-memory rows (batch rows) of h or dz, by K, row stride bs.
// float32: 3xTF32, each k8 step in a fresh accumulator added in float32
template <int MT, int NT, typename A>
__device__ __forceinline__ void product(float (&acc)[MT][NT][4], const A& a, const int (&mt)[MT],
                                        const float* b, int bs, const int (&b0)[NT], int kk0,
                                        int kk1, int lane) {
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
    }
  }
#pragma unroll 4
  for (int kk = kk0; kk < kk1; ++kk) {
    gordo_mma::FragA fa[MT];
    gordo_mma::FragB fb[NT];
#pragma unroll
    for (int i = 0; i < MT; ++i) fa[i] = a.a32(mt[i], kk, lane, g, q);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* bp = b + (b0[n] + g) * bs + kk * 8 + q;
      fb[n] = gordo_mma::split_b(bp[0], bp[4]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int n = 0; n < NT; ++n) gordo_mma::mma_3xtf32(acc[i][n], fa[i], fb[n]);
    }
  }
}

// one k16 step of the bf16 product into d
template <int MT, int NT, typename A>
__device__ __forceinline__ void bf16_step(float (&d)[MT][NT][4], const A& a, const int (&mt)[MT],
                                          const __nv_bfloat16* b, int bs, const int (&b0)[NT],
                                          int kk, int lane) {
  const int g = lane / 4, q = lane % 4;
  uint32_t fa[MT][4], fb[NT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) a.a16(mt[i], kk, lane, g, q, fa[i]);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const __nv_bfloat16* bp = b + (b0[n] + g) * bs + kk * 16 + 2 * q;
    fb[n][0] = *reinterpret_cast<const uint32_t*>(bp);
    fb[n][1] = *reinterpret_cast<const uint32_t*>(bp + 8);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_bf16(d[i][n], fa[i], fb[n]);
  }
}

// bf16: m16n8k16, the even and the odd k16 steps in two float32 chains
// added at the end
template <int MT, int NT, typename A>
__device__ __forceinline__ void product(float (&acc)[MT][NT][4], const A& a, const int (&mt)[MT],
                                        const __nv_bfloat16* b, int bs, const int (&b0)[NT],
                                        int kk0, int kk1, int lane) {
  float odd[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = odd[i][n][e] = 0.f;
    }
  }
  int kk = kk0;
#pragma unroll 2
  for (; kk + 2 <= kk1; kk += 2) {
    bf16_step(acc, a, mt, b, bs, b0, kk, lane);
    bf16_step(odd, a, mt, b, bs, b0, kk + 1, lane);
  }
  if (kk < kk1) bf16_step(acc, a, mt, b, bs, b0, kk, lane);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] += odd[i][n][e];
    }
  }
}

// v into element e of the shared buffer `buf` of every CTA of the cluster
// (this CTA's address of it; DSMEM for the others)
template <typename T>
__device__ __forceinline__ void to_cluster(T* buf, int e, T v, int cluster) {
  if (cluster == 1) {
    buf[e] = v;
    return;
  }
  cg::cluster_group cl = cg::this_cluster();
  for (int r = 0; r < cluster; ++r) cl.map_shared_rank(buf, r)[e] = v;
}

// the end of a step: every write of the step's buffer visible to every
// thread that reads it in the next (release and acquire at cluster scope)
__device__ __forceinline__ void step_barrier(int cluster) {
  if (cluster > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// The k parts' partial sums of a tile: part kp of KS writes its N
// accumulators (a lane's, float) into red, lane-minor; after a barrier,
// sum(j) adds accumulator j of every part in the order 0 .. KS - 1
template <int KS, int N>
struct Partials {
  float* red;  // [warps][N][32]
  int tile, lane;
  __device__ __forceinline__ void put(int kp, const float (&x)[N]) const {
#pragma unroll
    for (int j = 0; j < N; ++j) red[((tile * KS + kp) * N + j) * 32 + lane] = x[j];
  }
  __device__ __forceinline__ float sum(int j) const {
    float s = 0.f;
#pragma unroll
    for (int kp = 0; kp < KS; ++kp) s += red[((tile * KS + kp) * N + j) * 32 + lane];
    return s;
  }
};

// The forward: grid (row tiles x cluster, M), cluster (cluster, 1, 1). A
// CTA of `rows` batch rows owns units [rank uc, (rank + 1) uc) of the
// padded Up = padded_units(u). A tile is a unit block (its two m16 tiles: i
// and f, g and o of 8 units) x NTW n-tiles; KS warps share it, each summing
// 1 / KS of K = Up and finishing 1 / KS of its cells (cell_of). A step's Zx
// is loaded DEPTH steps ahead into a register ring of DEPTH + 1 (the fewer
// steps the more cells a thread holds: 128 registers at 512 threads).
template <typename T, int ACT, int REC, int NTW, int KS, bool HELD>
__global__ void __launch_bounds__(MAX_THREADS)
tc_forward(const T* __restrict__ zx, const T* __restrict__ rk, T* __restrict__ out,
           T* __restrict__ h_save, float* __restrict__ z_save, float* __restrict__ c_save,
           int b_total, int t_len, int u, int rows, int cluster, int return_sequences,
           int act_arg, int rec_arg) {
  constexpr int SLOTS = 2 * NTW / KS;  // a thread's cells
  constexpr int DEPTH = 4 - SLOTS + (SLOTS == 4), RING = DEPTH + 1;  // 3, 2 or 1
  const int act = ACT >= 0 ? ACT : act_arg;
  const int rec = REC >= 0 ? REC : rec_arg;
  const int up = padded_units(u), uc = up / cluster, g4 = 4 * u, kk_n = up / K_STEP<T>;
  const int ks = row_stride(up, static_cast<int>(sizeof(T)));
  const int rank = blockIdx.x % cluster, tile_row = blockIdx.x / cluster;
  extern __shared__ float4 smem4[];
  Frag<T>* frag = reinterpret_cast<Frag<T>*>(smem4);  // [uc / 4][kk_n][32] when HELD
  T* h_s = reinterpret_cast<T*>(frag + (HELD ? uc / 4 * kk_n * 32 : 0));  // [2][rows][ks]
  float* red = reinterpret_cast<float*>(h_s + 2 * rows * ks);             // KS > 1
  const T* r = rk + static_cast<long long>(blockIdx.y) * u * g4;
  const FwdR<T> src{r, u, 4 * rank * uc};
  const int tid = threadIdx.x;
  for (int e = tid; e < 2 * rows * ks; e += blockDim.x) h_s[e] = from_float<T>(0.f);
  if (HELD) fill_held<T>(frag, uc / 4, kk_n, src);
  const int warp = tid / 32, lane = tid % 32, q = lane % 4;
  const int kp = warp % KS, tile = warp / KS, blocks = uc / UNIT_BLOCK;
  const int mt[2] = {(tile % blocks) * 2, (tile % blocks) * 2 + 1};
  int b0[NTW];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) b0[nt] = ((tile / blocks) * NTW + nt) * 8;
  const int kk_part = kk_n / KS, kk0 = kp * kk_part;
  const Partials<KS, 8 * NTW> partials{red, tile, lane};
  // the thread's cells: one unit, SLOTS rows (grow: the row's index in
  // (M B), -1 past the batch or for a padded unit)
  int unit = 0;
  long long grow[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    int row;
    cell_of(0, uc, rows, NTW, KS, rank, tile_row, warp, lane, s, &unit, &row);
    grow[s] = row < b_total && unit < u ? static_cast<long long>(blockIdx.y) * b_total + row : -1;
  }
  float c[SLOTS], zin[RING][SLOTS][4];
  auto load_zx = [&](float (&z)[SLOTS][4], int t) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const T* p = zx + (grow[s] * t_len + t) * g4 + unit;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) z[s][gate] = grow[s] >= 0 ? to_float<T>(p[gate * u]) : 0.f;
    }
  };
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) c[s] = 0.f;
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    if (d < t_len) load_zx(zin[d], d);
  }
  step_barrier(cluster);  // R and the zeroed buffers in place; every CTA of the cluster running
  for (int t0 = 0; t0 < t_len; t0 += RING) {
#pragma unroll
    for (int d = 0; d < RING; ++d) {
      const int t = t0 + d;
      if (t >= t_len) break;
      if (t + DEPTH < t_len) load_zx(zin[(d + DEPTH) % RING], t + DEPTH);
      const T* h_prev = h_s + (t & 1) * rows * ks;
      T* h_next = h_s + ((t + 1) & 1) * rows * ks;
      float acc[2][NTW][4] = {};
      if (t > 0) {  // h_{-1} = 0
        if (HELD) {
          product(acc, HeldA<T>{frag, kk_n}, mt, h_prev, ks, b0, kk0, kk0 + kk_part, lane);
        } else {
          product(acc, StreamedA<FwdR<T>>{src}, mt, h_prev, ks, b0, kk0, kk0 + kk_part, lane);
        }
        if (KS > 1) {
          partials.put(kp, reinterpret_cast<const float(&)[8 * NTW]>(acc));
          __syncthreads();
        }
      }
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        // cell (n-tile nt, row rr): i and f in m16 tile 0, g and o in tile
        // 1, at accumulators (tile, nt, rr) and (tile, nt, 2 + rr)
        const int cell = kp * SLOTS + s, nt = cell / 2, rr = cell % 2;
        float pre[4] = {acc[0][s / 2][s % 2], acc[0][s / 2][2 + s % 2], acc[1][s / 2][s % 2],
                        acc[1][s / 2][2 + s % 2]};
        if (KS > 1 && t > 0) {
          pre[0] = partials.sum(nt * 4 + rr);
          pre[1] = partials.sum(nt * 4 + 2 + rr);
          pre[2] = partials.sum(NTW * 4 + nt * 4 + rr);
          pre[3] = partials.sum(NTW * 4 + nt * 4 + 2 + rr);
        }
        const float zi = round_to<T>(zin[d][s][0] + pre[0]);
        const float zf = round_to<T>(zin[d][s][1] + pre[1]);
        const float zg = round_to<T>(zin[d][s][2] + pre[2]);
        const float zo = round_to<T>(zin[d][s][3] + pre[3]);
        const float cc = cell_value(rec, zf) * c[s] + cell_value(rec, zi) * cell_value(act, zg);
        c[s] = cc;
        const T h = from_float<T>(cell_value(rec, zo) * cell_value(act, cc));
        if (grow[s] >= 0) {
          const long long step = grow[s] * t_len + t;
          if (z_save) {
            float* zs = z_save + step * g4 + unit;
            zs[0] = zi;
            zs[u] = zf;
            zs[2 * u] = zg;
            zs[3 * u] = zo;
          }
          if (c_save) c_save[step * u + unit] = cc;
          if (h_save) h_save[step * u + unit] = h;
          if (return_sequences) {
            out[step * u + unit] = h;
          } else if (t == t_len - 1) {
            out[grow[s] * u + unit] = h;
          }
        }
        to_cluster(h_next, (((tile / blocks) * NTW + nt) * 8 + 2 * q + rr) * ks + unit,
                   grow[s] >= 0 ? h : from_float<T>(0.f), cluster);
      }
      step_barrier(cluster);
    }
  }
}

// The backward: grid and cluster as the forward's. A CTA owns units [rank
// uc, (rank + 1) uc); a tile is an m16 tile of them x one n-tile, shared by
// KS = 4 / SLOTS warps (2 or 4) that each sum their part of the product
// dh = dz_{t+1} R^T
// over every gate column j = gate Up + unit (which each CTA writes for its
// own units into every CTA's dz buffer) and finish SLOTS of its cells. A
// step's z, c_{t-1} and dout are loaded DEPTH steps ahead into a register
// ring (as the forward's); c_t is the step before's c_{t-1}.
template <typename T, int ACT, int REC, int SLOTS, bool HELD>
__global__ void __launch_bounds__(MAX_THREADS)
tc_backward(const T* __restrict__ dout, const float* __restrict__ z_save,
            const float* __restrict__ c_save, const T* __restrict__ rkt,
            T* __restrict__ dz_out, int b_total, int t_len, int u, int rows, int cluster,
            int return_sequences, int act_arg, int rec_arg) {
  constexpr int KS = 4 / SLOTS, DEPTH = SLOTS == 1 ? 3 : 2, RING = DEPTH + 1;
  const int act = ACT >= 0 ? ACT : act_arg;
  const int rec = REC >= 0 ? REC : rec_arg;
  const int up = padded_units(u), uc = up / cluster, g4 = 4 * u, kd = 4 * up;
  const int kk_n = kd / K_STEP<T>;
  const int ks = row_stride(kd, static_cast<int>(sizeof(T)));
  const int rank = blockIdx.x % cluster, tile_row = blockIdx.x / cluster;
  extern __shared__ float4 smem4[];
  Frag<T>* frag = reinterpret_cast<Frag<T>*>(smem4);  // [uc / 16][kk_n][32] when HELD
  T* dz_s = reinterpret_cast<T*>(frag + (HELD ? uc / 16 * kk_n * 32 : 0));  // [2][rows][ks]
  float* red = reinterpret_cast<float*>(dz_s + 2 * rows * ks);             // KS > 1
  const T* rt = rkt + static_cast<long long>(blockIdx.y) * g4 * u;
  const BwdR<T> src{rt, u, up, rank * uc};
  const int tid = threadIdx.x;
  for (int e = tid; e < 2 * rows * ks; e += blockDim.x) dz_s[e] = from_float<T>(0.f);
  if (HELD) fill_held<T>(frag, uc / 16, kk_n, src);
  const int warp = tid / 32, lane = tid % 32, q = lane % 4;
  const int kp = warp % KS, tile = warp / KS, tiles = uc / UNIT_TILE;
  const int mt[1] = {tile % tiles};
  const int b0[1] = {(tile / tiles) * 8};
  const int kk_part = kk_n / KS, kk0 = kp * kk_part;
  const Partials<KS, 4> partials{red, tile, lane};
  // the thread's cells: SLOTS of units (g, g + 8) x rows (2q, 2q + 1), in
  // the accumulator's order from cell kp SLOTS
  int units[SLOTS];
  long long grow[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    int row;
    cell_of(1, uc, rows, 1, KS, rank, tile_row, warp, lane, s, &units[s], &row);
    grow[s] = row < b_total && units[s] < u
                  ? static_cast<long long>(blockIdx.y) * b_total + row : -1;
  }
  // a step's inputs of a cell: z (4 gates), c_{t-1}, dout_t
  float in[RING][SLOTS][6], c_t[SLOTS];
  auto load_in = [&](float (&x)[SLOTS][6], int t) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const long long step = grow[s] * t_len + t;
      const bool on = grow[s] >= 0;
      const float* zb = z_save + step * g4 + units[s];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) x[s][gate] = on ? zb[gate * u] : 0.f;
      x[s][4] = on && t > 0 ? c_save[(step - 1) * u + units[s]] : 0.f;
      x[s][5] = !on ? 0.f
                : return_sequences ? to_float<T>(dout[step * u + units[s]])
                : t == t_len - 1   ? to_float<T>(dout[grow[s] * u + units[s]])
                                   : 0.f;
    }
  };
  float dc[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    dc[s] = 0.f;
    c_t[s] = grow[s] >= 0 ? c_save[(grow[s] * t_len + t_len - 1) * u + units[s]] : 0.f;
  }
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    if (d < t_len) load_in(in[d], t_len - 1 - d);
  }
  step_barrier(cluster);
  for (int n0 = 0; n0 < t_len; n0 += RING) {
#pragma unroll
    for (int d = 0; d < RING; ++d) {
      const int n = n0 + d, t = t_len - 1 - n;
      if (n >= t_len) break;
      if (n + DEPTH < t_len) load_in(in[(d + DEPTH) % RING], t - DEPTH);
      const T* dz_prev = dz_s + (n & 1) * rows * ks;
      T* dz_next = dz_s + ((n + 1) & 1) * rows * ks;
      float acc[1][1][4] = {};
      if (n > 0) {  // dz_T = 0
        if (HELD) {
          product(acc, HeldA<T>{frag, kk_n}, mt, dz_prev, ks, b0, kk0, kk0 + kk_part, lane);
        } else {
          product(acc, StreamedA<BwdR<T>>{src}, mt, dz_prev, ks, b0, kk0, kk0 + kk_part, lane);
        }
        if (KS > 1) {
          partials.put(kp, acc[0][0]);
          __syncthreads();
        }
      }
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int cell = kp * SLOTS + s;
        // without a k split the thread's own accumulator (cell s)
        const float rec_dh = KS > 1 && n > 0 ? partials.sum(cell) : acc[0][0][s];
        const float dh = round_to<T>(rec_dh) + in[d][s][5];
        const float zi = in[d][s][0], zf = in[d][s][1], zg = in[d][s][2], zo = in[d][s][3];
        const float ig = cell_value(rec, zi), f = cell_value(rec, zf);
        const float gg = cell_value(act, zg), o = cell_value(rec, zo);
        const float c = c_t[s], c_prev = in[d][s][4];
        c_t[s] = c_prev;
        const float d_o = dh * cell_value(act, c);
        const float dcv = dc[s] + dh * o * cell_grad(act, c);
        dc[s] = dcv * f;
        const float dz[4] = {dcv * gg * cell_grad(rec, zi), dcv * c_prev * cell_grad(rec, zf),
                             dcv * ig * cell_grad(act, zg), d_o * cell_grad(rec, zo)};
        const int e = (b0[0] + 2 * q + cell % 2) * ks + units[s];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          const T v = from_float<T>(dz[gate]);
          if (grow[s] >= 0) dz_out[(grow[s] * t_len + t) * g4 + gate * u + units[s]] = v;
          to_cluster(dz_next, e + gate * up, grow[s] >= 0 ? v : from_float<T>(0.f), cluster);
        }
      }
      step_barrier(cluster);
    }
  }
}

// ------------------------------------------------------------ launches
template <typename T, int BT, int ACT, int REC>
cudaError_t launch_legacy(const FwdArgs& a, const Plan& p, cudaStream_t stream) {
  auto kernel = legacy_forward<T, BT, ACT, REC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.b + BT - 1) / BT, a.m);
  kernel<<<grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(a.zx), static_cast<const T*>(a.rk), static_cast<T*>(a.out),
      static_cast<T*>(a.h_save), a.z_save, a.c_save, a.b, a.t, a.u, p.r_in_smem,
      a.return_sequences, a.act, a.rec);
  return cudaGetLastError();
}

template <typename T, int BT, int ACT, int REC>
cudaError_t launch_legacy(const BwdArgs& a, const Plan& p, cudaStream_t stream) {
  auto kernel = legacy_backward<T, BT, ACT, REC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.b + BT - 1) / BT, a.m);
  kernel<<<grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(a.dout), a.z, a.c, static_cast<const T*>(a.rkt),
      static_cast<T*>(a.dz), a.b, a.t, a.u, p.r_in_smem, a.return_sequences, a.act, a.rec);
  return cudaGetLastError();
}

// the legacy batch tile's instantiation
template <typename T, int ACT, int REC, typename Args>
cudaError_t by_tile(const Args& a, const Plan& p, cudaStream_t s) {
  switch (p.rows) {
    case 1: return launch_legacy<T, 1, ACT, REC>(a, p, s);
    case 2: return launch_legacy<T, 2, ACT, REC>(a, p, s);
    case 4: return launch_legacy<T, 4, ACT, REC>(a, p, s);
    case 8: return launch_legacy<T, 8, ACT, REC>(a, p, s);
    default: return cudaErrorInvalidValue;
  }
}

// a tensor-core kernel on grid (row tiles x cluster, M) in clusters of
// p.cluster CTAs along x
template <typename... Params, typename... Args>
cudaError_t launch_tc(void (*kernel)(Params...), const Plan& p, int b, int m,
                      cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  if (p.cluster > PORTABLE_CLUSTER) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(((b + p.rows - 1) / p.rows) * p.cluster, m);
  config.blockDim = dim3(p.threads);
  config.dynamicSmemBytes = p.smem;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = p.cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = p.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int ACT, int REC, int NTW, int KS, bool HELD>
cudaError_t tc_instance(const FwdArgs& a, const Plan& p, cudaStream_t s) {
  return launch_tc(tc_forward<T, ACT, REC, NTW, KS, HELD>, p, a.b, a.m, s,
                   static_cast<const T*>(a.zx), static_cast<const T*>(a.rk),
                   static_cast<T*>(a.out), static_cast<T*>(a.h_save), a.z_save, a.c_save, a.b,
                   a.t, a.u, p.rows, p.cluster, a.return_sequences, a.act, a.rec);
}

// the plan's layout; STREAM is built in one (lstm_plan.cuh)
template <typename T, int ACT, int REC, bool HELD>
cudaError_t by_layout(const FwdArgs& a, const Plan& p, cudaStream_t s) {
  if constexpr (HELD) {
    if (p.tiles_a_warp == 2) return tc_instance<T, ACT, REC, 2, 1, true>(a, p, s);
    if (p.ksplit == 2) return tc_instance<T, ACT, REC, 1, 2, true>(a, p, s);
  }
  return tc_instance<T, ACT, REC, 1, 1, HELD>(a, p, s);
}

template <typename T, int ACT, int REC, int SLOTS, bool HELD>
cudaError_t tc_instance(const BwdArgs& a, const Plan& p, cudaStream_t s) {
  return launch_tc(tc_backward<T, ACT, REC, SLOTS, HELD>, p, a.b, a.m, s,
                   static_cast<const T*>(a.dout), a.z, a.c, static_cast<const T*>(a.rkt),
                   static_cast<T*>(a.dz), a.b, a.t, a.u, p.rows, p.cluster, a.return_sequences,
                   a.act, a.rec);
}

template <typename T, int ACT, int REC, bool HELD>
cudaError_t by_layout(const BwdArgs& a, const Plan& p, cudaStream_t s) {
  if constexpr (HELD) {
    if (p.ksplit == 4) return tc_instance<T, ACT, REC, 1, true>(a, p, s);
  }
  return tc_instance<T, ACT, REC, 2, HELD>(a, p, s);
}

template <typename T, int ACT, int REC, typename Args>
cudaError_t by_route(const Args& a, const Plan& p, cudaStream_t s) {
  return p.r_in_smem ? by_layout<T, ACT, REC, true>(a, p, s)
                     : by_layout<T, ACT, REC, false>(a, p, s);
}

// registers, local (spilled) bytes and the most threads of one kernel
cudaError_t attributes(const void* kernel, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = attr.maxThreadsPerBlock;
  return err;
}

// of one direction's kernels, so that each direction compiles apart
template <typename T, int ACT, int REC, bool BACKWARD>
cudaError_t tc_attributes(int tiles_a_warp, int ksplit, int held, int* out) {
  const void* kernel = nullptr;
  if (!held) {  // STREAM: one layout a direction
    if (tiles_a_warp != 1 || ksplit != (BACKWARD ? 2 : 1)) return cudaErrorInvalidValue;
    if constexpr (BACKWARD) {
      kernel = reinterpret_cast<const void*>(tc_backward<T, ACT, REC, 2, false>);
    } else {
      kernel = reinterpret_cast<const void*>(tc_forward<T, ACT, REC, 1, 1, false>);
    }
  } else if constexpr (BACKWARD) {
    if (ksplit != 2 && ksplit != 4) return cudaErrorInvalidValue;
    kernel = reinterpret_cast<const void*>(ksplit == 4 ? tc_backward<T, ACT, REC, 1, true>
                                                       : tc_backward<T, ACT, REC, 2, true>);
  } else {
    kernel = reinterpret_cast<const void*>(tiles_a_warp == 2 ? tc_forward<T, ACT, REC, 2, 1, true>
                                           : ksplit == 2     ? tc_forward<T, ACT, REC, 1, 2, true>
                                                             : tc_forward<T, ACT, REC, 1, 1, true>);
  }
  return attributes(kernel, out);
}

}  // namespace

namespace gordo_lstm {

// A launch on the tensor-core route of the plan, and the attributes of a
// tensor-core instantiation (tc_attributes), for one input type, activation
// pair and direction: each direction of each pair compiles in a part of its
// own
template <typename T, int ACT, int REC, typename Args>
cudaError_t tc_route(const Args& a, const Plan& p, cudaStream_t s);
template <typename T, int ACT, int REC, bool BACKWARD>
cudaError_t tc_direction_attributes(int tiles_a_warp, int ksplit, int held, int* out);

#if GORDO_PART != 0
template <typename T, int ACT, int REC, typename Args>
cudaError_t tc_route(const Args& a, const Plan& p, cudaStream_t s) {
  return by_route<T, ACT, REC>(a, p, s);
}

template <typename T, int ACT, int REC, bool BACKWARD>
cudaError_t tc_direction_attributes(int tiles_a_warp, int ksplit, int held, int* out) {
  return tc_attributes<T, ACT, REC, BACKWARD>(tiles_a_warp, ksplit, held, out);
}
#endif

#if GORDO_PART <= 0
template <typename T, int ACT, int REC>
cudaError_t tc_kernel_attributes(int backward, int tiles_a_warp, int ksplit, int held, int* out) {
  return backward ? tc_direction_attributes<T, ACT, REC, true>(tiles_a_warp, ksplit, held, out)
                  : tc_direction_attributes<T, ACT, REC, false>(tiles_a_warp, ksplit, held, out);
}
#endif

#define GORDO_TC_FORWARD(T, ACT, REC)                                                       \
  template cudaError_t tc_route<T, ACT, REC, FwdArgs>(const FwdArgs&, const Plan&,          \
                                                      cudaStream_t);                        \
  template cudaError_t tc_direction_attributes<T, ACT, REC, false>(int, int, int, int*);
#define GORDO_TC_BACKWARD(T, ACT, REC)                                                      \
  template cudaError_t tc_route<T, ACT, REC, BwdArgs>(const BwdArgs&, const Plan&,          \
                                                      cudaStream_t);                        \
  template cudaError_t tc_direction_attributes<T, ACT, REC, true>(int, int, int, int*);
#if GORDO_PART == 1
GORDO_TC_FORWARD(float, TANH, SIGMOID)
#elif GORDO_PART == 2
GORDO_TC_BACKWARD(float, TANH, SIGMOID)
#elif GORDO_PART == 3
GORDO_TC_FORWARD(float, DYNAMIC, DYNAMIC)
#elif GORDO_PART == 4
GORDO_TC_BACKWARD(float, DYNAMIC, DYNAMIC)
#elif GORDO_PART == 5
GORDO_TC_FORWARD(__nv_bfloat16, TANH, SIGMOID)
#elif GORDO_PART == 6
GORDO_TC_BACKWARD(__nv_bfloat16, TANH, SIGMOID)
#elif GORDO_PART == 7
GORDO_TC_FORWARD(__nv_bfloat16, DYNAMIC, DYNAMIC)
#elif GORDO_PART == 8
GORDO_TC_BACKWARD(__nv_bfloat16, DYNAMIC, DYNAMIC)
#endif
#undef GORDO_TC_FORWARD
#undef GORDO_TC_BACKWARD

}  // namespace gordo_lstm

#if GORDO_PART <= 0
namespace {

template <typename Args>
cudaError_t check(const Args& a) {
  if (a.m <= 0 || a.b <= 0 || a.t <= 0 || a.u <= 0) return cudaErrorInvalidValue;
  if (a.m > 65535 || (a.b + a.bt - 1) / a.bt > INT_MAX) return cudaErrorInvalidConfiguration;
  if (a.act < 0 || a.act >= N_ACTS || a.rec < 0 || a.rec >= N_ACTS) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// A launch sets its kernel's dynamic shared memory size to its plan's
// (cudaFuncSetAttribute: the kernel's, not the launch's) and launches under
// this lock, so a concurrent launch of the same instantiation at another
// plan's size (another U, or row tile) cannot set a smaller size in between
// (the launch then failed with cudaErrorInvalidValue: a served model's
// layers under concurrent requests)
std::mutex launch_lock;

// the plan's route; the activation pair: (tanh, sigmoid) as constants, any
// other pair from the arguments
template <typename T, typename Args>
cudaError_t dispatch(const Args& a, cudaStream_t s, bool backward) {
  cudaError_t err = check(a);
  if (err != cudaSuccess) return err;
  Plan p;
  if (plan(a.m, a.b, a.u, a.bt, static_cast<int>(sizeof(T)), backward, gordo_lstm::forced,
           &p) != PLAN_OK) {
    return cudaErrorInvalidValue;
  }
  const bool constants = a.act == TANH && a.rec == SIGMOID;
  const std::lock_guard<std::mutex> guard(launch_lock);
  if (p.route == LEGACY) {
    return constants ? by_tile<T, TANH, SIGMOID>(a, p, s) : by_tile<T, DYNAMIC, DYNAMIC>(a, p, s);
  }
  return constants ? tc_route<T, TANH, SIGMOID>(a, p, s) : tc_route<T, DYNAMIC, DYNAMIC>(a, p, s);
}

FwdArgs fwd_args(const void* zx, const void* rk, void* out, void* h_save, void* z_save,
                 void* c_save, int m, int b, int t, int u, int bt, int act, int rec,
                 int return_sequences) {
  return FwdArgs{zx, rk, out, h_save, static_cast<float*>(z_save),
                 static_cast<float*>(c_save), m, b, t, u, bt, act, rec, return_sequences};
}

BwdArgs bwd_args(const void* dout, const void* z, const void* c, const void* rkt, void* dz,
                 int m, int b, int t, int u, int bt, int act, int rec, int return_sequences) {
  return BwdArgs{dout, static_cast<const float*>(z), static_cast<const float*>(c), rkt, dz,
                 m, b, t, u, bt, act, rec, return_sequences};
}

}  // namespace

// Forward over M stacked layers: zx (M, B, T, 4U) and rk (M, U, 4U) in the
// input dtype, contiguous; out (M, B, T, U) with return_sequences, else
// (M, B, U). h_save (M, B, T, U, input dtype), z_save (M, B, T, 4U,
// float32) and c_save (M, B, T, U, float32) are written when not null (a
// training forward). bt is the legacy route's batch tile (1, 2, 4 or 8);
// act and rec the codes of the activations. Launches on `stream`, does not
// synchronise, and returns the CUDA error code of the launch (0 on success).
extern "C" int gordo_lstm_forward_f32(const void* zx, const void* rk, void* out, void* h_save,
                                      void* z_save, void* c_save, int m, int b, int t, int u,
                                      int bt, int act, int rec, int return_sequences,
                                      void* stream) {
  return static_cast<int>(dispatch<float>(
      fwd_args(zx, rk, out, h_save, z_save, c_save, m, b, t, u, bt, act, rec,
               return_sequences),
      static_cast<cudaStream_t>(stream), false));
}

extern "C" int gordo_lstm_forward_bf16(const void* zx, const void* rk, void* out, void* h_save,
                                       void* z_save, void* c_save, int m, int b, int t, int u,
                                       int bt, int act, int rec, int return_sequences,
                                       void* stream) {
  return static_cast<int>(dispatch<__nv_bfloat16>(
      fwd_args(zx, rk, out, h_save, z_save, c_save, m, b, t, u, bt, act, rec,
               return_sequences),
      static_cast<cudaStream_t>(stream), false));
}

// Backward: dout (M, B, T, U) with return_sequences, else (M, B, U), in the
// input dtype; z (M, B, T, 4U) and c (M, B, T, U) float32 from the training
// forward; rkt (M, 4U, U), the recurrent kernel transposed, in the input
// dtype. Writes dz (M, B, T, 4U) in the input dtype.
extern "C" int gordo_lstm_backward_f32(const void* dout, const void* z, const void* c,
                                       const void* rkt, void* dz, int m, int b, int t, int u,
                                       int bt, int act, int rec, int return_sequences,
                                       void* stream) {
  return static_cast<int>(dispatch<float>(
      bwd_args(dout, z, c, rkt, dz, m, b, t, u, bt, act, rec, return_sequences),
      static_cast<cudaStream_t>(stream), true));
}

extern "C" int gordo_lstm_backward_bf16(const void* dout, const void* z, const void* c,
                                        const void* rkt, void* dz, int m, int b, int t, int u,
                                        int bt, int act, int rec, int return_sequences,
                                        void* stream) {
  return static_cast<int>(dispatch<__nv_bfloat16>(
      bwd_args(dout, z, c, rkt, dz, m, b, t, u, bt, act, rec, return_sequences),
      static_cast<cudaStream_t>(stream), true));
}

// The built tensor-core instantiation's registers, local memory bytes (its
// spills) and most threads a block, in out[0..2]: the forward (tiles_a_warp
// 1 with ksplit 1 or 2, or tiles_a_warp 2) or the backward (ksplit 2 or 4)
// with R held, or either streamed (forward ksplit 1, backward 2), float32
// or bf16, the (tanh, sigmoid) constants or the run-time pair.
extern "C" int gordo_lstm_kernel_attributes(int backward, int bf16, int constants,
                                            int tiles_a_warp, int ksplit, int held, int* out) {
  using Of = cudaError_t (*)(int, int, int, int, int*);
  const Of of = bf16 ? (constants ? &tc_kernel_attributes<__nv_bfloat16, TANH, SIGMOID>
                                  : &tc_kernel_attributes<__nv_bfloat16, DYNAMIC, DYNAMIC>)
                     : (constants ? &tc_kernel_attributes<float, TANH, SIGMOID>
                                  : &tc_kernel_attributes<float, DYNAMIC, DYNAMIC>);
  return static_cast<int>(of(backward, tiles_a_warp, ksplit, held, out));
}
#endif  // GORDO_PART
