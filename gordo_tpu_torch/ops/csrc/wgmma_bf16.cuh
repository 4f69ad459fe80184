// Hopper (sm_90a) building blocks of the warp-specialised bf16 flash-attention
// kernels of this directory: the forward (flash_attention_bf16.cu), dQ and
// dK/dV (flash_attention_bwd_bf16.cu). Inline PTX throughout (PTX ISA 8.x).
//
// - wgmma.mma_async m64nNk16, bf16 x bf16 -> float32, N = 16, 32, 64 or 128,
//   in SS form (A and B from shared memory, both K-major) and RS form (A
//   from registers, B from shared memory MN-major: trans-b = 1), with the
//   fence / commit_group / wait_group that order them.
// - Shared-memory matrix descriptors for tiles that TMA writes with its
//   32-, 64- or 128-byte swizzle (`Tile`).
// - mbarriers (init, arrive, arrive.expect_tx, try_wait.parity) and the TMA
//   load of a 3-D box (cp.async.bulk.tensor), with the host-side encoding
//   of its CUtensorMap through the runtime's driver entry point (no libcuda
//   link).
// - setmaxnreg and named barriers for the warp-specialised block, and the
//   order in which a persistent block walks over (head, query tile) work.
// - The float32-to-A-fragment split of P and dS into three bf16 parts, and
//   the float32 dot product of bf16 rows (D = rowsum(dO O)).
//
// Every input is exact in float32 and every product and sum is float32, as
// in the TPU kernels: a bf16 x bf16 product is exact, so S, dP and their
// transposes are one bf16 product with float32 sums; P and dS, float32,
// go through three bf16 products, one per part of their split, which hold
// all 24 of their significand bits (two parts leave outputs more than a
// bf16 ulp off where the sum cancels, one moves a third of them:
// tests/test_torch_bf16.py emulates all three).
//
// Layouts (PTX ISA, "Matrix fragments for wgmma" and "Shared memory matrix
// layout"; CUTLASS's SM90 GMMA traits give the same):
// - The m64nN float32 accumulator: warp w of the warpgroup holds rows
//   16w .. 16w + 15; in each 8-column group j, with g = lane / 4 and
//   t = lane % 4, d[4j] = (g, 8j + 2t), d[4j + 1] = (g, 8j + 2t + 1),
//   d[4j + 2] = (g + 8, 8j + 2t), d[4j + 3] = (g + 8, 8j + 2t + 1): the
//   m16n8 C fragment of mma.sync.
// - The RS A fragment of m64k16, per warp: a0 = (g, 2t..2t+1),
//   a1 = (g + 8, 2t..2t+1), a2 = (g, 2t+8..2t+9), a3 = (g + 8, 2t+8..2t+9):
//   the m16k16 A fragment of mma.sync. So accumulator groups 2c and 2c + 1
//   (columns 16c .. 16c + 15) are the A fragment of k-chunk c, and P (or
//   dS) feeds the next product without leaving registers.
//
// The tensor core rounds its float32 sums toward zero. A chain of wgmma
// into one accumulator truncates at every k16 step; the kernels choose per
// product how deep a chain runs before its result is added in float32 (a
// tile's k16 steps, or the whole loop's in the output's own accumulator;
// PERF.md section 6 has the card's gates per choice).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace gordo_wgmma {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- register allocation and named barriers ---

// A warp-specialised block of one producer warpgroup and CONSUMERS
// consumer warpgroups, one block per SM, is built with LAUNCH registers a
// thread (__launch_bounds__(THREADS, 1)); setmaxnreg then moves the
// producer's down to PRODUCER and the consumers' up to CONSUMER, within the
// block's 65,536: 128 x 24 + 256 x 240 with two consumers, 128 x 24 +
// 384 x 160 with three.
template <int CONSUMERS>
struct Regs {
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int LAUNCH = 65536 / THREADS / 8 * 8;
  static constexpr int PRODUCER = 24;
  static constexpr int CONSUMER = (LAUNCH * (CONSUMERS + 1) - PRODUCER) / CONSUMERS / 8 * 8;
};

constexpr int MAX_DEVICES = 64;

// Before a warp-specialised kernel's first launch on a device: allow it
// `smem` bytes of dynamic shared memory, and refuse it if it was built with
// fewer than `launch_regs` registers a thread (the consumers'
// setmaxnreg.inc waits for registers the producer releases, and would wait
// forever). Done once per device; every call gives the device's SM count
// in `sms`.
template <auto KERNEL>
cudaError_t prepare_kernel(int smem, int launch_regs, int* sms) {
  static std::atomic<int> ready[MAX_DEVICES];  // the SM count once prepared
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < MAX_DEVICES) {
    *sms = ready[device].load(std::memory_order_acquire);
    if (*sms > 0) return cudaSuccess;
  }
  err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, KERNEL);
  if (err == cudaSuccess && attr.numRegs < launch_regs) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device < MAX_DEVICES) {
    ready[device].store(*sms, std::memory_order_release);
  }
  return err;
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// barrier `id` (1..15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- persistent scheduling ---

// the key tiles of `bn` rows that query rows [0, row_end) see
__device__ __forceinline__ int key_tiles(int row_end, int t, int bn, int causal) {
  const int all = (t + bn - 1) / bn;
  return causal ? min(all, (row_end + bn - 1) / bn) : all;
}

// Work item w of bh * n_q_tiles: head w / n_q_tiles, so that the query
// tiles of a head run at once on neighbouring SMs (K and V come from L2
// after the first); within a head the tiles rotate by the round the head
// falls in, so that each SM, taking every grid-th item, cycles through
// light and heavy causal tiles.
__device__ __forceinline__ void schedule(int w, int n_q_tiles, int grid, int* bh, int* qt) {
  const int h = w / n_q_tiles;
  const int slot = w - h * n_q_tiles;
  const long long round = static_cast<long long>(h) * n_q_tiles / grid;
  *bh = h;
  *qt = n_q_tiles - 1 - static_cast<int>((slot + round) % n_q_tiles);
}

// --- mbarriers ---

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after every mbar_init, before any thread uses the barriers
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival for the calling warp, once all its lanes are done with what
// the barrier guards (barriers that consumers release count warps)
__device__ __forceinline__ void mbar_arrive_warp(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed. A wait longer than
// ten seconds means the pipeline's protocol is broken: trap, so that the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t start = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - start > 10000000000ull) __trap();
  }
}

// A position in a ring of STAGES buffers: the stage, and the parity of the
// round it is in (the phase its full barrier completes)
template <int STAGES>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// --- TMA ---

// copy the box at coordinates (c0, c1, c2) (innermost first) of `map` into
// shared memory at `dst`, completing `bytes` of `bar`'s transactions;
// out-of-bounds elements are written as zeros
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver, through the runtime: null if the
// driver lacks it
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a contiguous (bh, t, dh) bf16 tensor as a 3-D tensor
// (dh, t, bh), innermost first, in boxes of `box_rows` rows by
// min(dh, 64) columns, swizzled at the box's row width (32, 64 or 128
// bytes). Rows at or past t of a head, and heads past bh, load as zeros.
// Returns 0 or a CUDA error code.
inline cudaError_t encode_rows(CUtensorMap* map, const void* base, int bh, int t, int dh,
                               int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int cols = dh < 64 ? dh : 64;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dh) * 2,
                                 static_cast<cuuint64_t>(t) * dh * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// --- shared-memory tiles and their wgmma descriptors ---

// A tile of `rows` rows of a (.., dh) bf16 matrix as TMA writes it: in
// panels of min(dh, 64) columns (two at dh 128), each panel `rows` rows of
// RB = 2 min(dh, 64) bytes, the 16-byte chunks of row r XOR-swizzled by
// bits of r (the 32/64/128-byte swizzle of CUTLASS's GMMA layout atoms).
// Tiles start at multiples of 1024 bytes, so the swizzle, which TMA and
// wgmma both take from address bits, agrees between them.
template <int DH>
struct Tile {
  static constexpr int COLS = DH < 64 ? DH : 64;  // columns of a panel
  static constexpr int RB = 2 * COLS;             // bytes of a panel's row
  static constexpr int PANELS = DH / COLS;
  static constexpr int STEPS_PER_PANEL = RB / 32;  // k16 steps along a row
  // descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;

  __device__ static uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
           (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (LAYOUT << 62);
  }

  // K-major operand (the rows are M or N, the dh columns are K): rows
  // r0 .. r0 + 63 (or the N rows of B) of a tile of `rows` rows at shared
  // address `tile`, columns 16 kk .. 16 kk + 15. Consecutive 8-row groups
  // are 8 RB bytes apart; the leading offset is unused when swizzled. With
  // rows, r0 and kk known at compile time, the descriptor is the tile's
  // plus a constant (an address below 256 KB never carries out of its field).
  __device__ static uint64_t k_major(uint32_t tile, int rows, int r0, int kk) {
    const uint32_t offset = (kk / STEPS_PER_PANEL) * rows * RB + r0 * RB +
                            (kk % STEPS_PER_PANEL) * 32;
    return desc(tile, 16, 8 * RB) + (offset >> 4);
  }

  // MN-major B operand (the tile's rows are K, the dh columns are N): rows
  // 16 c .. 16 c + 15 of a tile of `rows` rows. 8-row groups along K are
  // 8 RB bytes apart; column panels along N are `rows` RB bytes apart.
  __device__ static uint64_t mn_major(uint32_t tile, int rows, int c) {
    return desc(tile, rows * RB, 8 * RB) + ((c * 16 * RB) >> 4);
  }

  // the shared byte offset of element (r, col) within the tile
  __device__ static uint32_t offset(int rows, int r, int col) {
    const uint32_t a = (col / COLS) * rows * RB + r * RB + (col % COLS) * 2;
    return a ^ ((a >> 3) & ((RB / 16 - 1) << 4));
  }
};

// --- wgmma ---

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers written or read by wgmma in flight: keep the compiler from
// moving other accesses across the fence (CUTLASS's warpgroup_fence_operand)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define GORDO_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define GORDO_D8(i) GORDO_D4(i), GORDO_D4(i + 4)
#define GORDO_D16(i) GORDO_D8(i), GORDO_D8(i + 8)
#define GORDO_D32(i) GORDO_D16(i), GORDO_D16(i + 16)
#define GORDO_D64(i) GORDO_D32(i), GORDO_D32(i + 32)
#define GORDO_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define GORDO_R16 GORDO_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define GORDO_R32 \
  GORDO_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define GORDO_R64                                                                            \
  GORDO_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "  \
            "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, " \
            "%63"

// d (64 x N, float32) = A B + (scale_d ? d : 0), bf16 operands; ss: A and B
// K-major in shared memory (descriptors); rs: A from registers (a, the
// m64k16 fragment), B MN-major in shared memory
template <int N>
struct Wgmma;

#define GORDO_WGMMA(N, REGS, OUTS, SS_OPS, SS_SCALE, RS_OPS, RS_SCALE)                         \
  template <>                                                                                \
  struct Wgmma<N> {                                                                          \
    __device__ static void ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {       \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SS_SCALE ", 0;\n"                     \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS          \
                   "}, " SS_OPS ", p, 1, 1, 0, 0;\n}\n"                                      \
                   : OUTS                                                                    \
                   : "l"(a), "l"(b), "r"(scale_d));                                          \
    }                                                                                        \
    __device__ static void rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,          \
                              int scale_d) {                                                 \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " RS_SCALE ", 0;\n"                     \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS          \
                   "}, " RS_OPS ", p, 1, 1, 1;\n}\n"                                         \
                   : OUTS                                                                    \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));      \
    }                                                                                        \
  };

GORDO_WGMMA(16, GORDO_R8, GORDO_D8(0), "%8, %9", "%10", "{%8, %9, %10, %11}, %12", "%13")
GORDO_WGMMA(32, GORDO_R16, GORDO_D16(0), "%16, %17", "%18", "{%16, %17, %18, %19}, %20", "%21")
GORDO_WGMMA(64, GORDO_R32, GORDO_D32(0), "%32, %33", "%34", "{%32, %33, %34, %35}, %36", "%37")
GORDO_WGMMA(128, GORDO_R64, GORDO_D64(0), "%64, %65", "%66", "{%64, %65, %66, %67}, %68",
            "%69")

#undef GORDO_WGMMA
#undef GORDO_D4
#undef GORDO_D8
#undef GORDO_D16
#undef GORDO_D32
#undef GORDO_D64
#undef GORDO_R8
#undef GORDO_R16
#undef GORDO_R32
#undef GORDO_R64

// 2^x in one MUFU.EX2 (ex2.approx.ftz: relative error below 2^-22; 0 for
// x below -126, as the masked scores need)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --- the three-part split ---

// x's bf16 truncation (its low 16 bits cleared), exact in float32
__device__ __forceinline__ float truncate_bf16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

// the bf16 pair of the truncations of x0 (low half) and x1 (high half)
__device__ __forceinline__ uint32_t pack_high(float x0, float x1) {
  return __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
}

// (x0, x1) as three bf16 pairs, hi + mid + lo, x0 in the low half of each:
// hi = trunc(x), mid = trunc(x - hi), lo = x - hi - mid, every difference
// exact in float32 and lo within bf16's 8 significant bits, so
// hi + mid + lo == x exactly (outside float32's subnormals). The split
// costs a byte permute, two masks and two adds a part.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = pack_high(x0, x1);
  const float r0 = x0 - truncate_bf16(x0), r1 = x1 - truncate_bf16(x1);
  mid = pack_high(r0, r1);
  lo = pack_high(r0 - truncate_bf16(r0), r1 - truncate_bf16(r1));
}

// The accumulator x (64 x 16 NC columns, float32) as RS A fragments of NC
// k-chunks, three parts each: a[c][0] lo, a[c][1] mid, a[c][2] hi
template <int NC>
__device__ __forceinline__ void split_to_a(const float (&x)[8 * NC], uint32_t (&a)[NC][3][4]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      split3(x[8 * c + 2 * r], x[8 * c + 2 * r + 1], a[c][2][r], a[c][1][r], a[c][0][r]);
    }
  }
}

// Issue acc (64 x N) (+)= X B over the NC k-chunks of a split X (a, from
// split_to_a), the B descriptor of chunk c from db(c): the lo parts of
// every chunk first, then mid, then hi, so that the truncating sum grows
// with its terms. `accumulate` false starts from zero. Does not commit.
template <int N, int NC, typename DescB>
__device__ __forceinline__ void rs_product(float (&acc)[N / 2], const uint32_t (&a)[NC][3][4],
                                           DescB db, bool accumulate) {
#pragma unroll
  for (int part = 0; part < 3; ++part) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      Wgmma<N>::rs(acc, a[c][part], db(c), accumulate || part > 0 || c > 0);
    }
  }
}

// f (64 x N) = X B (rs_product into the fresh accumulator f), waited for:
// a tile's chain, to be added in float32
template <int N, int NC, typename DescB>
__device__ __forceinline__ void rs_fresh(float (&f)[N / 2], const uint32_t (&a)[NC][3][4],
                                         DescB db) {
  fence_regs(f);
  wgmma_fence();
  rs_product<N, NC>(f, a, db, false);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(f);
}

template <int NC>
__device__ __forceinline__ void fence_split(uint32_t (&a)[NC][3][4]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int part = 0; part < 3; ++part) fence_regs(a[c][part]);
  }
}

// acc + the sum of the products of the eight bf16 pairs of a and b, in
// float32
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const uint32_t av[4] = {a.x, a.y, a.z, a.w};
  const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[i]));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv[i]));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

// the sum over the four threads of a quad (an accumulator row's holders)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

}  // namespace gordo_wgmma
