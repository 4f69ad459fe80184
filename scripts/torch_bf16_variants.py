"""
The bf16 flash-attention kernels against variants of their shared header
``gordo_tpu_torch/ops/csrc/mma_bf16.cuh``, on one NVIDIA GPU.

    python3 scripts/torch_bf16_variants.py [VARIANT ...]   # from the repo root

A variant is the header with a few text replacements (``VARIANTS``): P and
dS in two bf16 parts (hi + mid) or in one (hi) instead of three, or S and
dP summed in one running accumulator instead of a fresh one per 16-deep
step. Each variant's copy of the kernel sources is compiled into
``build/bf16_variants/<name>/`` with the port's nvcc flags, all at once;
its forward, dQ and dK/dV then take the place of the wrappers' kernels.
For the source's kernels and each variant, over SEEDS inputs at the
training shape (BH 128 x T 512 x dh 64, causal): the elements of out, dq,
dk and dv outside ``chip_smoke.py``'s one-ulp gate against the plain twin
(elements exactly 0 in float64 held to |x| <= 1e-6), the share that differ
from the twin at all, the largest error against the float64 plain result
relative to its largest entry (the twin's own beside it), and the times at
the training and serving shapes in turns with the source's kernels
(source, variant, variant, source). Prints the card's name and power limit,
a line per variant and one JSON line.
"""

import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "gordo_tpu_torch" / "ops" / "csrc"
OUT = REPO / "build" / "bf16_variants"
SEEDS = 4
SOURCES = ("flash_attention_bf16", "flash_attention_bwd_bf16")

_LO = """      mma(p0, a[i].lo, b[0]);
      mma(p1, a[i].lo, b[1]);
"""
_MID = """      mma(p0, a[i].mid, b[0]);
      mma(p1, a[i].mid, b[1]);
"""
# name -> [(text of mma_bf16.cuh, its replacement)]; each text must occur once
VARIANTS = {
    "two_parts": [(_LO, "")],
    "one_part": [(_LO + _MID, "")],
    "running_sum": [("""      float f0[4] = {0.f, 0.f, 0.f, 0.f}, f1[4] = {0.f, 0.f, 0.f, 0.f};
      mma(f0, a, b[0]);
      mma(f1, a, b[1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[2 * j][e] += f0[e];
        acc[2 * j + 1][e] += f1[e];
      }""", """      mma(acc[2 * j], a, b[0]);
      mma(acc[2 * j + 1], a, b[1]);""")],
}


def _build(name: str, patches) -> dict:
    """Compile the bf16 sources with the patched header; returns
    ``{source stem: library path}``."""
    from gordo_tpu_torch.ops import _build

    out = OUT / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for path in CSRC.glob("*.cuh"):
        (out / path.name).write_text(path.read_text())
    header = (out / "mma_bf16.cuh").read_text()
    for old, new in patches:
        if header.count(old) != 1:
            raise ValueError(f"{name}: a patch does not apply to mma_bf16.cuh")
        header = header.replace(old, new)
    (out / "mma_bf16.cuh").write_text(header)
    libs = {}
    for stem in SOURCES:
        (out / f"{stem}.cu").write_text((CSRC / f"{stem}.cu").read_text())
        libs[stem] = out / f"lib{stem}.so"
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(libs[stem]),
                               str(out / f"{stem}.cu")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed on {stem}.cu\n{proc.stdout}{proc.stderr}")
    return libs


def _kernels(libs: dict) -> dict:
    """The variant's C functions, typed as the wrappers' own."""
    from gordo_tpu_torch.ops import flash_attention as fa

    kernels = {}
    for key, stem, symbol, like in (
            ("forward", "flash_attention_bf16", "gordo_flash_attention_forward_bf16",
             fa._bf16_kernel),
            ("dq", "flash_attention_bwd_bf16", "gordo_flash_attention_backward_dq_bf16",
             fa._bf16_dq_kernel),
            ("dkv", "flash_attention_bwd_bf16", "gordo_flash_attention_backward_dkv_bf16",
             fa._bf16_dkv_kernel)):
        fn = getattr(ctypes.CDLL(str(libs[stem])), symbol)
        fn.argtypes, fn.restype = like().argtypes, ctypes.c_int
        kernels[key] = fn
    return kernels


def _use(kernels: dict) -> None:
    from gordo_tpu_torch.ops import flash_attention as fa

    fa._bf16_kernel = lambda: kernels["forward"]
    fa._bf16_dq_kernel = lambda: kernels["dq"]
    fa._bf16_dkv_kernel = lambda: kernels["dkv"]


def _errors(got, ref, exact) -> tuple:
    """(elements outside the one-ulp gate, share that differ, error
    against float64 relative to its largest entry)."""
    import torch

    a, b = got.float(), ref.float()
    zero = exact == 0
    ok = (a - b).abs() <= 2.0 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-6
    ok = torch.where(zero, a.abs() <= 1e-6, ok)
    share = ((a != b) & ~zero).float().mean().item()
    f64 = ((got.double() - exact).abs().max() / exact.abs().max().clamp_min(1.0)).item()
    return int((~ok).sum()), share, f64


def main(names) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_bf16_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from gordo_tpu_torch.ops import flash_attention as fa

    card = chip_smoke._card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    names = ["source"] + (names or list(VARIANTS))
    patches = {"source": [], **VARIANTS}
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(lambda n: _build(n, patches[n]), names)))
    kernels = {name: _kernels(libs) for name, libs in built.items()}

    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    cases = []
    for _ in range(SEEDS):
        q, k, v, do = (torch.randn(chip_smoke.TRAIN_SHAPE, device="cuda", generator=g).bfloat16()
                       for _ in range(4))
        cases.append((q, k, v, do))
    report = {}
    for name in names:
        _use(kernels[name])
        stats = {key: [0, 0.0, 0.0, 0.0] for key in ("out", "dq", "dk", "dv")}
        for q, k, v, do in cases:
            out, lse = fa.flash_attention_forward(q, k, v, True)
            grads = fa.flash_attention_backward(q, k, v, out, lse, do, True)
            ref_out, _ = fa.flash_attention_forward_plain(q, k, v, True)
            exact_out, _ = fa.flash_attention_forward_plain(*(x.double() for x in (q, k, v)), True)
            refs = fa.flash_attention_backward_plain(q, k, v, out, lse, do, True)
            exact = fa.flash_attention_backward_plain(
                *(x.double() for x in (q, k, v, out, lse, do)), True)
            for key, got, ref, ref64 in zip(stats, (out, *grads), (ref_out, *refs),
                                            (exact_out, *exact)):
                bad, share, f64 = _errors(got, ref, ref64)
                plain64 = _errors(ref, ref, ref64)[2]
                s = stats[key]
                stats[key] = [s[0] + bad, max(s[1], share), max(s[2], f64), max(s[3], plain64)]
        report[name] = {key: dict(zip(("outside_gate", "share_differing", "f64_rel_err",
                                       "plain_f64_rel_err"), s)) for key, s in stats.items()}
        print(f"{name}: " + "; ".join(
            f"{key} {s[0]} outside the gate, share {s[1]:.2e}, vs float64 {s[2]:.2e} "
            f"(plain {s[3]:.2e})" for key, s in stats.items()), flush=True)

    serve = [torch.randn(chip_smoke.SERVE_SHAPE, device="cuda", generator=g).bfloat16()
             for _ in range(3)]
    q, k, v, do = cases[0]
    out, lse = fa.flash_attention_forward(q, k, v, True)
    timers = {
        "forward_serving": lambda: fa.flash_attention_forward(*serve, True),
        "forward": lambda: fa.flash_attention_forward(q, k, v, True),
        "dq": lambda: fa.launch_dq(q, k, v, out, lse, do, True),
        "dkv": lambda: fa.launch_dkv(q, k, v, out, lse, do, True),
    }
    for name in names[1:]:
        times = {}
        for key, fn in timers.items():
            iters = 20 if key == "forward_serving" else 100
            turns = []
            for turn in ("source", name, name, "source"):
                _use(kernels[turn])
                turns.append(chip_smoke._time_ms(fn, iters))
            times[key] = {"source_ms": (turns[0] + turns[3]) / 2,
                          "variant_ms": (turns[1] + turns[2]) / 2}
        report[name]["times"] = times
        print(f"{name} on {card}: " + ", ".join(
            f"{key} {t['variant_ms']:.4f} ms (source {t['source_ms']:.4f})"
            for key, t in times.items()), flush=True)
    print(json.dumps({"card": card, "shape": list(chip_smoke.TRAIN_SHAPE), "seeds": SEEDS,
                      "variants": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
