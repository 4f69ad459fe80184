"""
Time variants of the LSTM recurrence kernels against those of
``gordo_tpu_torch/ops/csrc/lstm_recurrence.cu``, on one NVIDIA GPU.

    python3 scripts/torch_lstm_variants.py [VARIANT ...]   # from the repo root

A variant is the source with a few text replacements (``VARIANTS`` below,
each text occurring once); each is written with the headers to
``build/lstm_variants/<name>/``, compiled with the port's nvcc flags (all
at once, an nvcc each), loaded with ctypes and put in the place of the
wrapper's kernels (``lstm._kernel``). Most variants cut a part of the work
away (the product, the cell's math, the loads of the next step's inputs,
the stores) to show what a step's time is made of; their outputs are
wrong and only timed. For each variant at each of SHAPES, float32 and
bf16, the forward (serving) and the backward in turns with the source
(source, variant, variant, source) by CUDA events, and the variant's error
against the twin. Prints the card's name and power limit, a line per
variant and shape and one JSON line.
"""

import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "gordo_tpu_torch" / "ops" / "csrc"
SOURCE = CSRC / "lstm_recurrence.cu"
OUT = REPO / "build" / "lstm_variants"
# (label, M, B, T, U), on the tensor-core routes: lstm_ae_144 served, its
# fleet step, the default width
SHAPES = (("served", 1, 2048, 144, 64), ("fleet step", 64, 64, 144, 64),
          ("default width", 1, 32, 144, 256))

VARIANTS = {
    # no recurrent product: the steps' chain without the mma
    "no_product": [("    if (t > 0) {  // h_{-1} = 0", "    if (false) {"),
                   ("    if (n > 0) {  // dz_T = 0", "    if (false) {")],
    # the cell's activations as a multiply: the steps without its math
    "no_cell_math": [
        ("  return code == TANH ? fast_tanh(x) : code == SIGMOID ? fast_sigmoid(x) : "
         "act_value(code, x);", "  return 0.5f * x;"),
        ("  if (code == TANH) {\n    const float t = fast_tanh(x);",
         "  if (code >= 0) return 0.25f;\n  if (code == TANH) {\n    const float t = fast_tanh(x);")],
    # no loads of the next step's inputs (Zx; backward z, c, dout)
    "no_loads": [
        ("z[s][gate] = grow[s] >= 0 ? to_float<T>(p[gate * u]) : 0.f;",
         "z[s][gate] = 0.f;"),
        ("x[s][gate] = on ? zb[gate * u] : 0.f;", "x[s][gate] = 0.f;"),
        ("      x[s][4] = on && t > 0 ? c_save[(step - 1) * u + units[s]] : 0.f;",
         "      x[s][4] = 0.f;"),
        ("      x[s][5] = !on ? 0.f\n", "      x[s][5] = true ? 0.f\n")],
    # the step's CTA barrier a warp's (without a cluster: the barrier's cost)
    "no_step_barrier": [("  } else {\n    __syncthreads();\n  }\n}", "  } else {\n    __syncwarp();\n  }\n}")],
    # no stores to device memory (z, c, h, the output; dz)
    "no_stores": [("        if (grow[s] >= 0) {\n          const long long step = grow[s] * t_len + t;",
                   "        if (false) {\n          const long long step = grow[s] * t_len + t;"),
                  ("          if (grow[s] >= 0) dz_out[", "          if (false) dz_out[")],
}


def _apply(text: str, patches) -> str:
    for old, new in patches:
        if text.count(old) != 1:
            raise ValueError(f"patch text occurs {text.count(old)} times: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _build_variant(name: str, text: str) -> Path:
    from gordo_tpu_torch.ops import _build as build

    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    (out / SOURCE.name).write_text(text)
    lib = out / "liblstm_recurrence.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(out / SOURCE.name)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    return lib


def main(argv) -> int:
    import torch

    names = argv or list(VARIANTS)
    if not torch.cuda.is_available():
        print("torch_lstm_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from gordo_tpu_torch.ops import _build, lstm

    card = cs._card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    source = SOURCE.read_text()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(
            lambda name: _build_variant(name, _apply(source, VARIANTS[name])), names)))
    own = lstm._kernel
    sides = {name: {(backward, dtype): lstm.bind(ctypes.CDLL(str(lib)), backward, dtype)
                    for backward in (False, True) for dtype in lstm.DTYPES}
             for name, lib in libs.items()}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 16)
    result = {}
    for label, m, b, t, u in SHAPES:
        for dtype in lstm.DTYPES:
            zx, rk = cs._lstm_inputs(m, b, t, u, dtype, g)
            lstm._kernel = own
            out, (z, c, _) = lstm.lstm_recurrence_forward(zx, rk, "tanh", "sigmoid", True, True)
            dout = torch.randn(out.shape, device="cuda", generator=g).to(dtype)
            calls = {"forward": lambda: lstm.lstm_recurrence_forward(zx, rk, "tanh", "sigmoid",
                                                                    True, False)[0],
                     "backward": lambda: lstm.lstm_recurrence_backward(dout, z, c, rk, "tanh",
                                                                      "sigmoid", True)}
            ref = {kind: call() for kind, call in calls.items()}
            for kind in calls:
                for name in names:
                    turns = {"source": [], name: []}
                    for side in ("source", name, name, "source"):
                        lstm._kernel = (own if side == "source" else
                                        lambda backward, dtype, f=sides[name]: f[backward, dtype])
                        if side == name:
                            err = cs._rel_err(calls[kind](), ref[kind])
                        turns[side].append(cs._time_ms(calls[kind], 20))
                    key = f"{kind} {str(dtype).split('.')[-1]} {label} ({m}, {b}, {t}, {u}) {name}"
                    ratio = statistics.median(turns[name]) / statistics.median(turns["source"])
                    result[key] = {**turns, "variant_over_source": ratio, "rel_err": err}
                    print(f"{key} on {card}: source {turns['source']} ms, variant {turns[name]} "
                          f"ms, variant / source {ratio:.3f}, off the source's output by "
                          f"{err:.2e}", flush=True)
            lstm._kernel = own
            del zx, rk, out, z, c, dout, ref
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "lstm_variants": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
