"""
The six flash kernels of this tree against those of another tree, on one
NVIDIA GPU, in turns (other, source, source, other) by CUDA events.

    python3 scripts/torch_flash_ab.py --other CSRC [--dh 64 ...]   # from the repo root

``CSRC`` is a copy of ``gordo_tpu_torch/ops/csrc`` from another commit
(e.g. unpacked from ``git archive <commit> gordo_tpu_torch/ops/csrc`` under
``build/``); both trees' flash sources are compiled with the port's nvcc
flags into ``build/flash_ab/<side>/`` and put in place of the wrappers'
kernels in turn; each side's build is timed (the two built at once, each
source in its own nvcc, as the port builds). At each head dim (default 64,
the main paths'): the forward at BH 4,096 (a 1,024-window predict's 4
heads), and the forward, dQ and dK/dV at BH 128 (a training step) and
1,024 (a fleet step of 8), T 512, causal, float32 and bf16; each side's
outputs are compared too
(equal bits, or the largest difference). Prints the card's name and power
limit, each time and the ratio of the medians (source / other), and one
JSON line.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "flash_ab"
STEMS = ("flash_attention", "flash_attention_bwd", "flash_attention_bf16",
         "flash_attention_bwd_bf16")
# wrapper getter -> (source stem, C symbol)
GETTERS = {"_kernel": ("flash_attention", "gordo_flash_attention_forward_f32"),
           "_dq_kernel": ("flash_attention_bwd", "gordo_flash_attention_backward_dq_f32"),
           "_dkv_kernel": ("flash_attention_bwd", "gordo_flash_attention_backward_dkv_f32"),
           "_bf16_kernel": ("flash_attention_bf16", "gordo_flash_attention_forward_bf16"),
           "_bf16_dq_kernel": ("flash_attention_bwd_bf16",
                               "gordo_flash_attention_backward_dq_bf16"),
           "_bf16_dkv_kernel": ("flash_attention_bwd_bf16",
                                "gordo_flash_attention_backward_dkv_bf16")}
SHAPES = ((("forward",), 4096), (("forward", "dq", "dkv"), 128),
          (("forward", "dq", "dkv"), 1024))


def _build_side(side: str, csrc: Path) -> tuple:
    """``({source stem: library path}, seconds)``"""
    from gordo_tpu_torch.ops import _build as build

    started = time.perf_counter()
    out = OUT / side
    out.mkdir(parents=True, exist_ok=True)
    for path in [*csrc.glob("*.cuh"), *(csrc / f"{stem}.cu" for stem in STEMS)]:
        (out / path.name).write_text(path.read_text())
    procs = {stem: subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                                     str(out / f"lib{stem}.so"), str(out / f"{stem}.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for stem in STEMS}
    for stem, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{side}: nvcc failed on {stem}.cu\n{log}")
    return {stem: out / f"lib{stem}.so" for stem in STEMS}, time.perf_counter() - started


def _functions(libs: dict) -> dict:
    from gordo_tpu_torch.ops import flash_attention as fa

    functions = {}
    for getter, (stem, symbol) in GETTERS.items():
        fn = getattr(ctypes.CDLL(str(libs[stem])), symbol)
        fn.argtypes, fn.restype = getattr(fa, getter)().argtypes, ctypes.c_int
        functions[getter] = fn
    return functions


def _use(functions: dict) -> None:
    from gordo_tpu_torch.ops import flash_attention as fa

    for getter, fn in functions.items():
        setattr(fa, getter, lambda fn=fn: fn)


def main(argv) -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--other", type=Path, required=True)
    parser.add_argument("--dh", type=int, nargs="*", default=[64])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from gordo_tpu_torch.ops import _build
    from gordo_tpu_torch.ops import flash_attention as fa

    card = cs._card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()  # the wrappers' own kernels, whose argtypes the sides take
    with ThreadPoolExecutor(2) as pool:
        built = dict(zip(("source", "other"), pool.map(
            lambda side: _build_side(side, REPO / "gordo_tpu_torch" / "ops" / "csrc"
                                     if side == "source" else args.other.resolve()),
            ("source", "other"))))
    build_s = {side: seconds for side, (_, seconds) in built.items()}
    print(f"flash sources built in {build_s['source']:.1f} s (source) and "
          f"{build_s['other']:.1f} s (other), at once", flush=True)
    sides = {side: _functions(libs) for side, (libs, _) in built.items()}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    result = {}
    for dh in args.dh:
        for dtype in (torch.float32, torch.bfloat16):
            for kernels, bh in SHAPES:
                q, k, v, do = (torch.randn((bh, 512, dh), device="cuda", generator=g).to(dtype)
                               for _ in range(4))
                o, lse = fa.flash_attention_forward(q, k, v, True)
                calls = {"forward": lambda: fa.flash_attention_forward(q, k, v, True),
                         "dq": lambda: fa.launch_dq(q, k, v, o, lse, do, True),
                         "dkv": lambda: fa.launch_dkv(q, k, v, o, lse, do, True)}
                for kernel in kernels:
                    turns, outputs = {"other": [], "source": []}, {}
                    for side in ("other", "source", "source", "other"):
                        _use(sides[side])
                        outputs[side] = calls[kernel]()
                        turns[side].append(cs._time_ms(calls[kernel], 20 if bh > 128 else 100))
                    got, ref = (outputs[s] if isinstance(outputs[s], tuple) else (outputs[s],)
                                for s in ("source", "other"))
                    diff = max((a.float() - b.float()).abs().max().item()
                               for a, b in zip(got, ref))
                    ratio = statistics.median(turns["source"]) / statistics.median(turns["other"])
                    key = f"{kernel} {str(dtype).split('.')[-1]} ({bh}, 512, {dh})"
                    result[key] = {**turns, "source_over_other": ratio, "max_abs_diff": diff}
                    print(f"{key} causal on {card}: other {turns['other']} ms, source "
                          f"{turns['source']} ms, source / other {ratio:.4f}; outputs differ "
                          f"by at most {diff:.3e}", flush=True)
                del q, k, v, do, o, lse
                torch.cuda.empty_cache()
    print(json.dumps({"card": card, "build_s": build_s, "flash_ab": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
