// The LSTM recurrence for NVIDIA Hopper (sm_90a): a forward kernel and a
// backward kernel, each for float32 and bf16 inputs, computing in float32.
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
// What bounds it on this card: the steps are sequential, so a block does
// U x 4U multiply-adds per row and step between two barriers. At the bench
// fleet's shape (64 machines x 64 windows x 144 steps, U 64) that is 19
// GFLOP against 0.6 GB of Zx: operations, at the CUDA cores' float32 rate
// (there is no tensor-core path yet; ROADMAP.md). The design:
// - one block per (machine, tile of BT batch rows), BT in {1, 2, 4, 8}
//   chosen by the wrapper so that there are enough blocks; a block owns all
//   4U gate columns of its rows, so a step needs no sync between blocks;
// - R (and R^T in the backward) is copied to shared memory once when it
//   fits beside the step buffers (U 64: 64 KB in float32); otherwise (the
//   factory default U 256: 1 MB) it is read through L2 every step;
// - forward: a thread owns gate columns j and keeps BT sums; h of the
//   previous step is read from shared memory (a broadcast), R by column
//   (consecutive threads, consecutive addresses); the cell update then
//   runs over (row, unit) pairs with c in shared memory;
// - backward: the cell's gradients over (row, unit) pairs, then dz R^T with
//   the 4U-long sums split over groups of threads into partial sums in
//   shared memory, added in a fixed order by the next step's cell pass;
// - the activations are a switch on compile-time codes: every name of
//   ops/nn.py's ACTIVATIONS, gelu in its tanh form as jax.nn.gelu. The
//   factories' (tanh, sigmoid) pair is compiled as constants: read at run
//   time, the same pair takes 0.92-1.89x the time on an H100 at bench.py's
//   LSTM shapes (scripts/torch_lstm_act_variants.py). Any other pair reads
//   its codes from the arguments (a uniform branch).
// Training stores z (float32), c (float32) and h (the input dtype) of every
// step for the backward; serving stores nothing but the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

namespace {

// the order of ACTIVATION_CODES in gordo_tpu_torch/ops/activations.py
enum Act {
  LINEAR = 0, TANH, RELU, SIGMOID, ELU, SELU, SOFTPLUS, SOFTSIGN, SWISH, GELU,
  LEAKY_RELU, EXPONENTIAL, HARD_SIGMOID, N_ACTS, DYNAMIC = -1
};

constexpr int MAX_THREADS = 256;
constexpr int MAX_SMEM = 232448;  // the most dynamic shared memory a block takes
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

// threads of a block for U units: one per gate column up to MAX_THREADS
__host__ __device__ __forceinline__ int threads_for(int u) {
  const int cols = ((4 * u + 31) / 32) * 32;
  return cols < MAX_THREADS ? cols : MAX_THREADS;
}

// groups of threads that split the backward's 4U-long sums of dz R^T
__host__ __device__ __forceinline__ int parts_for(int u, int nt) {
  return u >= nt ? 1 : nt / u;
}

// dynamic shared memory of the step buffers, without R
// (forward: h, c, z; backward: dc, dz and the partial sums of dz R^T)
long long buffer_bytes(int u, int bt, int backward) {
  if (!backward) return 4 * 6LL * bt * u;
  return 4 * (5LL + parts_for(u, threads_for(u))) * bt * u;
}

struct Plan {
  int threads, smem, r_in_smem;
};

// the launch's plan; an error, with the step buffers' bytes in p->smem
// (saturated at INT_MAX), where those alone exceed MAX_SMEM
cudaError_t plan(int u, int bt, int elem_bytes, int backward, Plan* p) {
  const long long base = buffer_bytes(u, bt, backward);
  const long long r_bytes = static_cast<long long>(u) * 4 * u * elem_bytes;
  p->threads = threads_for(u);
  p->r_in_smem = base + r_bytes <= MAX_SMEM;
  p->smem = static_cast<int>(p->r_in_smem ? base + r_bytes : (base < INT_MAX ? base : INT_MAX));
  return base > MAX_SMEM ? cudaErrorInvalidValue : cudaSuccess;
}

struct FwdArgs {
  const void* zx;   // (M, B, T, 4U)
  const void* rk;   // (M, U, 4U)
  void* out;        // (M, B, T, U) with return_sequences, else (M, B, U)
  void* h_save;     // (M, B, T, U) or null
  float* z_save;    // (M, B, T, 4U) or null
  float* c_save;    // (M, B, T, U) or null
  int m, b, t, u, bt, act, rec, return_sequences;
};

template <typename T, int BT, int ACT, int REC>
__global__ void __launch_bounds__(MAX_THREADS)
lstm_forward(const T* __restrict__ zx, const T* __restrict__ rk, T* __restrict__ out,
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

struct BwdArgs {
  const void* dout;    // (M, B, T, U) with return_sequences, else (M, B, U)
  const float* z;      // (M, B, T, 4U)
  const float* c;      // (M, B, T, U)
  const void* rkt;     // (M, 4U, U): recurrent_kernel transposed
  void* dz;            // (M, B, T, 4U)
  int m, b, t, u, bt, act, rec, return_sequences;
};

template <typename T, int BT, int ACT, int REC>
__global__ void __launch_bounds__(MAX_THREADS)
lstm_backward(const T* __restrict__ dout, const float* __restrict__ z_save,
              const float* __restrict__ c_save, const T* __restrict__ rkt,
              T* __restrict__ dz_out, int b_total, int t_len, int u, int r_in_smem,
              int return_sequences, int act_arg, int rec_arg) {
  const int act = ACT >= 0 ? ACT : act_arg;
  const int rec = REC >= 0 ? REC : rec_arg;
  extern __shared__ float4 smem4[];
  const int g4 = 4 * u;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int parts = parts_for(u, nt);
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

template <typename T, int BT, int ACT, int REC>
cudaError_t launch(const FwdArgs& a, const Plan& p, cudaStream_t stream) {
  auto kernel = lstm_forward<T, BT, ACT, REC>;
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
cudaError_t launch(const BwdArgs& a, const Plan& p, cudaStream_t stream) {
  auto kernel = lstm_backward<T, BT, ACT, REC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.b + BT - 1) / BT, a.m);
  kernel<<<grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(a.dout), a.z, a.c, static_cast<const T*>(a.rkt),
      static_cast<T*>(a.dz), a.b, a.t, a.u, p.r_in_smem, a.return_sequences, a.act, a.rec);
  return cudaGetLastError();
}

// the batch tile's instantiation
template <typename T, int ACT, int REC, typename Args>
cudaError_t by_tile(const Args& a, const Plan& p, cudaStream_t s) {
  switch (a.bt) {
    case 1: return launch<T, 1, ACT, REC>(a, p, s);
    case 2: return launch<T, 2, ACT, REC>(a, p, s);
    case 4: return launch<T, 4, ACT, REC>(a, p, s);
    case 8: return launch<T, 8, ACT, REC>(a, p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Args>
cudaError_t check(const Args& a) {
  if (a.m <= 0 || a.b <= 0 || a.t <= 0 || a.u <= 0) return cudaErrorInvalidValue;
  if (a.m > 65535 || (a.b + a.bt - 1) / a.bt > INT_MAX) return cudaErrorInvalidConfiguration;
  if (a.act < 0 || a.act >= N_ACTS || a.rec < 0 || a.rec >= N_ACTS) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// the activation pair: (tanh, sigmoid) as constants, any other pair from
// the arguments
template <typename T, typename Args>
cudaError_t dispatch(const Args& a, cudaStream_t s, bool backward) {
  cudaError_t err = check(a);
  if (err != cudaSuccess) return err;
  Plan p;
  err = plan(a.u, a.bt, static_cast<int>(sizeof(T)), backward, &p);
  if (err != cudaSuccess) return err;
  if (a.act == TANH && a.rec == SIGMOID) return by_tile<T, TANH, SIGMOID>(a, p, s);
  return by_tile<T, DYNAMIC, DYNAMIC>(a, p, s);
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
// training forward). bt is the batch tile (1, 2, 4 or 8); act and rec the
// codes of the activations. Launches on `stream`, does not synchronise,
// and returns the CUDA error code of the launch (0 on success).
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

// The plan of a launch, checked before it by the wrapper and given in
// reports: threads a block, dynamic shared memory (bytes) and whether the
// recurrent kernel is held in it (else read through L2 every step).
// Returns the CUDA error code: nonzero where the step buffers alone exceed
// the shared memory a block takes, their bytes then in smem_bytes.
extern "C" int gordo_lstm_plan(int u, int bt, int elem_bytes, int backward, int* threads,
                               int* smem_bytes, int* r_in_smem) {
  Plan p;
  const cudaError_t err = plan(u, bt, elem_bytes, backward, &p);
  *threads = p.threads;
  *smem_bytes = p.smem;
  *r_in_smem = p.r_in_smem;
  return static_cast<int>(err);
}
