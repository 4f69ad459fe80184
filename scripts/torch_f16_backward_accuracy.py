"""
The fp16 backward kernels against the float64 twin at the serving and
fleet shapes, this tree's source beside a variant whose dK/dV takes
D = rowsum(dO O) by float32 fmas at dh 64 (as the bf16 kernel does) instead
of on the tensor cores, on one NVIDIA GPU.

    python3 scripts/torch_f16_backward_accuracy.py [SEEDS]   # from the repo root

Each side's fp16 parts of ``flash_attention_bwd_bf16.cu`` (GORDO_PART 2
and 3) are compiled apart and stand in for the wrappers' dQ and dK/dV
kernels. For SEEDS seeds (8 by default; BH 1,024 for the first, 4,096 for
the rest, T 512, dh 64, causal, dO at unit scale or, every fourth seed,
at 1e-4): per output, the largest ratio of an element's error against
the float64 twin rounded to fp16 to chip_smoke.py's fp16 gate (one ulp, at
least fp16's least subnormal, plus 1e-6 times dO's scale), and the
elements above 0.9 and above 1 of it, summed over the seeds; then each
side's dQ and dK/dV times at BH 4,096 and 128 (CUDA events). Prints the
card's name and power limit and one line a seed.
"""

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
VARIANTS = {"source": [], "fma_d": [("      if constexpr (BQ == 32 || Elem<E>::SCALED) {",
                                     "      if constexpr (BQ == 32) {")]}


def _compile(name: str, out: Path) -> dict:
    from gordo_tpu_torch.ops import _build

    text = (_build.CSRC / "flash_attention_bwd_bf16.cu").read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the patch no longer applies")
        text = text.replace(old, new)
    where = out / name
    where.mkdir(parents=True, exist_ok=True)
    (where / "source.cu").write_text(text)
    for header in _build.CSRC.glob("*.cuh"):
        (where / header.name).write_text(header.read_text())
    libs = {}
    for part in (2, 3):
        lib = where / f"part{part}.so"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, f"-DGORDO_PART={part}", "-o",
                        str(lib), str(where / "source.cu")], check=True, capture_output=True)
        libs[part] = ctypes.CDLL(str(lib))
    return libs


def _c(lib, symbol: str, n_pointers: int):
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_f16_backward_accuracy: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from gordo_tpu_torch.ops import _build, flash_attention as fa

    print(cs._card(), flush=True)
    seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    _build.build_all()
    out = REPO / "build" / "f16_backward_accuracy"
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda n: _compile(n, out), VARIANTS)))
    worst = {name: {key: [0.0, 0, 0] for key in ("dq", "dk", "dv")} for name in VARIANTS}
    times = {}
    for seed in range(seeds):
        bh, scale = (1024 if seed == 0 else 4096), (1e-4 if seed % 4 == 3 else 1.0)
        g = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v, do = (torch.randn((bh, 512, 64), device="cuda", generator=g) for _ in range(4))
        q, k, v, do = (x.half() for x in (q, k, v, do * scale))
        o, lse = fa.flash_attention_forward(q, k, v, True)
        exact = cs._plain_in_parts(fa.flash_attention_backward_plain, (q, k, v, o, lse, do),
                                   True, bh // 256, torch.float64)
        for name, libs in built.items():
            dq_fn = _c(libs[2], "gordo_flash_attention_backward_dq_f16", 7)
            dkv_fn = _c(libs[3], "gordo_flash_attention_backward_dkv_f16", 8)
            fa._f16_dq_kernel, fa._f16_dkv_kernel = (lambda: dq_fn), (lambda: dkv_fn)
            inputs = (q, k, v, o, lse, do)
            got = (fa.launch_dq(*inputs, True), *fa.launch_dkv(*inputs, True))
            for key, a, ref in zip(("dq", "dk", "dv"), got, exact):
                a, b = a.float(), ref.half().float()
                bound = torch.clamp(cs.F16_ULP * torch.maximum(a.abs(), b.abs()),
                                    min=cs.F16_SUBNORMAL) + 1e-6 * scale
                ratio = (a - b).abs() / bound
                entry = worst[name][key]
                entry[0] = max(entry[0], ratio.max().item())
                entry[1] += int((ratio > 0.9).sum())
                entry[2] += int((ratio > 1).sum())
            if seed == 1:
                small = [x[:128].contiguous() for x in (q, k, v, o, lse, do)]
                times[name] = {
                    "dq_4096": cs._time_ms(lambda: fa.launch_dq(q, k, v, o, lse, do, True), 20),
                    "dkv_4096": cs._time_ms(lambda: fa.launch_dkv(q, k, v, o, lse, do, True), 20),
                    "dq_128": cs._time_ms(lambda: fa.launch_dq(*small, True), 100),
                    "dkv_128": cs._time_ms(lambda: fa.launch_dkv(*small, True), 100)}
        print(f"seed {seed} (BH {bh}, dO x{scale:g}): " + "; ".join(
            f"{name} " + ", ".join(f"{key} worst {w[0]:.3f}, >0.9 {w[1]}, >1 {w[2]}"
                                  for key, w in entries.items())
            for name, entries in worst.items()), flush=True)
    print("times (ms): " + "; ".join(f"{name} " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
                                     for name, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
