"""
Tensor-core throughput of ``mma.sync`` on one NVIDIA GPU: TF32 m16n8k8 (the
instruction of the port's 3xTF32 kernels) and bf16 m16n8k16 for reference.

    python3 scripts/mma_throughput.py      # from the repo root, on the card

Each warp runs CHAINS independent accumulator chains of ITERS dependent
``mma.sync`` instructions on register operands, with 4, 8 or 16 warps per
SM (132 SMs); FLOP/s = 2 * m * n * k per instruction over the CUDA-event
time. One chain shows the instruction's latency, several its throughput.
Builds its kernel with nvcc into ``build/mma_throughput/``. Prints the
card's name and power limit and one JSON line.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ITERS = 4096
SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
template <int CHAINS, int BF16>
__global__ void bench(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i) & 0xffffe000u;
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + threadIdx.x * 1e-3f + i) & 0xffffe000u;
  float acc[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (BF16) {
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else {
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      }
    }
  }
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  if (s == 1234.5f) out[0] = s;  // keeps the chains alive
}
template <int C, int B>
int go(int blocks, int iters, float* out, cudaStream_t s) {
  bench<C, B><<<blocks, 128, 0, s>>>(out, iters);
  return (int)cudaGetLastError();
}
extern "C" int launch_bench(int chains, int bf16, int blocks, int iters, void* out, void* stream) {
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (chains * 2 + bf16) {
    case 2: return go<1, 0>(blocks, iters, o, s);   case 3: return go<1, 1>(blocks, iters, o, s);
    case 4: return go<2, 0>(blocks, iters, o, s);   case 5: return go<2, 1>(blocks, iters, o, s);
    case 8: return go<4, 0>(blocks, iters, o, s);   case 9: return go<4, 1>(blocks, iters, o, s);
    case 16: return go<8, 0>(blocks, iters, o, s);  case 17: return go<8, 1>(blocks, iters, o, s);
  }
  return -1;
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_throughput: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from gordo_tpu_torch.ops import _build

    card = chip_smoke._card()
    print(card, flush=True)
    out_dir = REPO / "build" / "mma_throughput"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "bench.cu").write_text(SOURCE)
    lib_path = out_dir / "libbench.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(out_dir / "bench.cu")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib_path)).launch_bench
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p]
    out = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    results = []
    for bf16, (m, n, k) in ((0, (16, 8, 8)), (1, (16, 8, 16))):
        for warps_per_sm in (4, 8, 16):
            for chains in (1, 2, 4, 8):
                blocks = 132 * warps_per_sm // 4

                def run():
                    if fn(chains, bf16, blocks, ITERS, out.data_ptr(), stream) != 0:
                        raise RuntimeError("mma benchmark launch failed")

                ms = chip_smoke._time_ms(run, 5)
                flop = blocks * 4 * ITERS * chains * 2 * m * n * k
                results.append({"instruction": "bf16 m16n8k16" if bf16 else "tf32 m16n8k8",
                                "warps_per_sm": warps_per_sm, "chains": chains, "ms": ms,
                                "tflop_per_s": flop / ms / 1e9})
                print(f"{results[-1]['instruction']}: {warps_per_sm} warps/SM, {chains} "
                      f"chains: {results[-1]['tflop_per_s']:.1f} TFLOP/s", flush=True)
    print(json.dumps({"card": card, "mma_sync": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
