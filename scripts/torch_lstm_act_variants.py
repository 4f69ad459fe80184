"""
The LSTM recurrence kernels (``gordo_tpu_torch/ops/csrc/lstm_recurrence.cu``)
with the activation pair compiled as constants against the pair read from
the arguments at run time, on one NVIDIA GPU.

    python3 scripts/torch_lstm_act_variants.py   # from the repo root

The source's ``dispatch`` launches an instantiation with (tanh, sigmoid) as
compile-time constants for that pair, and one that reads the activation
codes at run time for any other pair, on every route. The variant
``runtime_codes`` takes the constant instantiations out (``VARIANTS``;
``tests/test_torch_build.py`` checks on the CPU that its text applies), so
that (tanh, sigmoid) too reads its codes at run time. Both builds compile
into ``build/lstm_variants/<name>/`` with the port's nvcc flags, at once.

At ``SHAPES`` (bench.py's lstm_ae_144 alone and as a 64-machine fleet
step, U 64 and 32), in float32 and bf16: the serving forward, the
training forward and the backward of each build, in ROUNDS alternating
turns (source, variant, ...; CALLS calls a turn), each side's median turn
in ms a call, and whether the two builds' outputs are bit-identical.
Prints the card's name and power limit, a line per shape and one JSON
line, also written to ``chiprun_out/lstm_act_variants.json``.
"""

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "gordo_tpu_torch" / "ops" / "csrc"
SOURCE = "lstm_recurrence.cu"
OUT = REPO / "build" / "lstm_variants"
ROUNDS = 5  # timed turns of each side
CALLS = 20  # calls a turn
# (label, machines M, batch B, steps T, units U)
SHAPES = (("lstm_ae_144", 1, 64, 144, 64), ("lstm_ae_144", 1, 64, 144, 32),
          ("lstm_ae_144 fleet step", 64, 64, 144, 64),
          ("lstm_ae_144 fleet step", 64, 64, 144, 32))

# name -> [(its text in SOURCE, the replacement)]; each text must occur once
VARIANTS = {
    "runtime_codes": [(
        "  const bool constants = a.act == TANH && a.rec == SIGMOID;\n",
        "  const bool constants = false;\n")],
}


def _build(name: str, patches) -> Path:
    """Compile SOURCE with the patches applied; returns the library."""
    from gordo_tpu_torch.ops import _build

    out = OUT / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    text = (CSRC / SOURCE).read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise ValueError(f"{name}: a patch does not apply to {SOURCE}")
        text = text.replace(old, new)
    (out / SOURCE).write_text(text)
    for header in CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    lib = out / "liblstm_recurrence.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(out / SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    return lib


def _runs(lstm, m: int, b: int, t: int, u: int, dtype):
    """The three launches on seeded inputs at one shape: name -> a call
    that returns its output."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(13)
    zx = (0.5 * torch.randn((m, b, t, 4 * u), device="cuda", generator=g)).to(dtype)
    rk = (torch.randn((m, u, 4 * u), device="cuda", generator=g) / u ** 0.5).to(dtype)
    out, (z, c, _) = lstm.lstm_recurrence_forward(zx, rk, "tanh", "sigmoid", True, True)
    dout = torch.randn(out.shape, device="cuda", generator=g).to(dtype)
    return {
        "forward": lambda: lstm.lstm_recurrence_forward(zx, rk, "tanh", "sigmoid", True,
                                                        False)[0],
        "training_forward": lambda: lstm.lstm_recurrence_forward(zx, rk, "tanh", "sigmoid",
                                                                 True, True)[1][0],
        "backward": lambda: lstm.lstm_recurrence_backward(dout, z, c, rk, "tanh", "sigmoid",
                                                          True),
    }


def _turn_ms(fn) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CALLS


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_lstm_act_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from gordo_tpu_torch.ops import lstm

    card = chip_smoke._card()
    print(card, flush=True)
    patches = {"source": [], **VARIANTS}
    with ThreadPoolExecutor(len(patches)) as pool:
        libs = dict(zip(patches, pool.map(lambda n: _build(n, patches[n]), patches)))
    kernels = {name: {(backward, dtype): lstm.bind(ctypes.CDLL(str(lib)), backward, dtype)
                      for backward in (False, True) for dtype in lstm.DTYPES}
               for name, lib in libs.items()}
    original = lstm._kernel
    rows = []
    try:
        for label, m, b, t, u in SHAPES:
            for dtype in lstm.DTYPES:
                lstm._kernel = lambda backward, dt: kernels["source"][backward, dt]
                runs = _runs(lstm, m, b, t, u, dtype)
                for kind, fn in runs.items():
                    outs, turns = {}, {name: [] for name in kernels}
                    for name in kernels:
                        lstm._kernel = lambda backward, dt, n=name: kernels[n][backward, dt]
                        outs[name] = fn().clone()
                    for _ in range(ROUNDS):
                        for name in kernels:
                            lstm._kernel = lambda backward, dt, n=name: kernels[n][backward, dt]
                            turns[name].append(_turn_ms(fn))
                    ms = {name: statistics.median(turns[name]) for name in kernels}
                    row = {"label": label, "shape": [m, b, t, u],
                           "dtype": str(dtype).replace("torch.", ""), "kind": kind,
                           "source_ms": ms["source"], "runtime_codes_ms": ms["runtime_codes"],
                           "runtime_over_source": ms["runtime_codes"] / ms["source"],
                           "identical": torch.equal(outs["source"], outs["runtime_codes"]),
                           "turns": turns}
                    rows.append(row)
                    print(f"{label} M {m} B {b} T {t} U {u} {row['dtype']} {kind} on {card}: "
                          f"constants {ms['source']:.4f} ms, run-time codes "
                          f"{ms['runtime_codes']:.4f} ms ({row['runtime_over_source']:.3f}x), "
                          f"identical {row['identical']}", flush=True)
                del runs
    finally:
        lstm._kernel = original
    result = {"card": card, "rounds": ROUNDS, "calls": CALLS, "rows": rows}
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "lstm_act_variants.json").write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps({"lstm_act_variants": [{k: v for k, v in r.items() if k != "turns"}
                                            for r in rows]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
