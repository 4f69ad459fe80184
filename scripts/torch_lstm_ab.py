"""
The LSTM recurrence kernels of this tree against those of another tree, on
one NVIDIA GPU, in turns (other, source, source, other) by CUDA events.

    python3 scripts/torch_lstm_ab.py --other CSRC [--iters N] [--check-only] [--sweep]   # from the repo root
    python3 scripts/torch_lstm_ab.py --stream [--iters N]

``CSRC`` is a copy of ``gordo_tpu_torch/ops/csrc`` from another commit
(e.g. unpacked from ``git archive <commit> gordo_tpu_torch/ops/csrc`` under
``build/``). Both trees' ``lstm_recurrence.cu`` (with their headers) are
compiled with the port's nvcc flags into ``build/lstm_ab/<side>/``, at
once, and put in place of the wrapper's kernels in turn
(``lstm._kernel``); the two entry points take the same arguments. At every
shape of ``chip_smoke.LSTM_SHAPES`` (the served shapes included: one and
two stacked models over 2,048 windows), float32 and bf16, each side's forward
(serving: nothing saved, return_sequences) and backward are held against
the plain twins (chip_smoke's tolerances, relative to the largest entry),
then timed in turns; cuDNN's ``torch.nn.LSTM`` is timed beside them at M 1
(a yardstick: the port never calls it). Prints the card's name and power
limit, the source's plan at each shape, each time, the ratio of the
medians (source / other), and one JSON line.

``--sweep`` then times this tree's kernels (the wrapper's own build) at
each shape under every plan the CUDA source can launch there, forced with
``lstm.set_route``: the legacy route, and the held-R route at each cluster
size, row tile and k split, each held against the twins too. It is how the plan's
rule (csrc/lstm_plan.cuh) was chosen; it prints each time and one JSON
line of them.

``--stream`` (no ``--other``) times this tree's kernels at the widths where
the plan streams R from L2 (``STREAM_SHAPES``: float32 U 512, bf16 U 768),
its own route against the legacy route forced, in turns (legacy, stream,
stream, legacy), forward and backward, each held against the twins.
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
OUT = REPO / "build" / "lstm_ab"
STEM = "lstm_recurrence"
# (M, B, T, U) in float32 and bf16 where the plan streams R: wider than any
# LSTM factory's layer (at most U 256), at the default width's batch and at
# eight times it
STREAM_SHAPES = (("float32", 1, 32, 144, 512), ("float32", 1, 256, 144, 512),
                 ("bfloat16", 1, 32, 144, 768))


def _build_side(side: str, csrc: Path) -> tuple:
    """``(library path, seconds, nvcc output)``"""
    from gordo_tpu_torch.ops import _build as build

    started = time.perf_counter()
    out = OUT / side
    out.mkdir(parents=True, exist_ok=True)
    for path in [*csrc.glob("*.cuh"), csrc / f"{STEM}.cu"]:
        (out / path.name).write_text(path.read_text())
    lib = out / f"lib{STEM}.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(out / f"{STEM}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{side}: nvcc failed on {STEM}.cu\n{proc.stdout}{proc.stderr}")
    return lib, time.perf_counter() - started, proc.stdout + proc.stderr


def _functions(lib: Path) -> dict:
    from gordo_tpu_torch.ops import lstm

    loaded = ctypes.CDLL(str(lib))
    return {(backward, dtype): lstm.bind(loaded, backward, dtype)
            for backward in (False, True) for dtype in lstm.DTYPES}


def _use(functions: dict) -> None:
    from gordo_tpu_torch.ops import lstm

    lstm._kernel = lambda backward, dtype: functions[backward, dtype]


def main(argv) -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--other", type=Path)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--check-only", action="store_true")
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--stream", action="store_true")
    args = parser.parse_args(argv)
    if (args.other is None) != args.stream:
        parser.error("give --other CSRC, or --stream alone")
    if not torch.cuda.is_available():
        print("torch_lstm_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from gordo_tpu_torch.ops import _build, lstm

    card = cs._card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()  # the wrapper's own library: its plan and checks
    tol = {torch.float32: cs.TOL_LSTM_REL, torch.bfloat16: cs.TOL_BF16_MODEL_REL}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 15)
    if args.stream:
        failures = stream_ab(card, args.iters, tol, g)
        if failures:
            print(f"torch_lstm_ab: off the twins at {failures}", file=sys.stderr)
        return 1 if failures else 0
    with ThreadPoolExecutor(2) as pool:
        built = dict(zip(("source", "other"), pool.map(
            lambda side: _build_side(side, REPO / "gordo_tpu_torch" / "ops" / "csrc"
                                     if side == "source" else args.other.resolve()),
            ("source", "other"))))
    build_s = {side: seconds for side, (_, seconds, _) in built.items()}
    print(f"{STEM}.cu built in {build_s['source']:.1f} s (source) and {build_s['other']:.1f} s "
          f"(other), at once", flush=True)
    for line in built["source"][2].splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"  source: {line.strip()}")
    sides = {side: _functions(lib) for side, (lib, _, _) in built.items()}
    own_kernel = lstm._kernel
    result, failures = {}, []
    for label, m, b, t, u in cs.LSTM_SHAPES:
        for dtype in tol:
            name = str(dtype).split(".")[-1]
            zx, rk = cs._lstm_inputs(m, b, t, u, dtype, g)
            calls = {"forward": lambda: lstm.lstm_recurrence_forward(zx, rk, "tanh", "sigmoid",
                                                                    True, False)[0]}
            _use(sides["source"])
            out, (z, c, _) = lstm.lstm_recurrence_forward(zx, rk, "tanh", "sigmoid", True, True)
            dout = torch.randn(out.shape, device="cuda", generator=g).to(dtype)
            calls["backward"] = lambda: lstm.lstm_recurrence_backward(dout, z, c, rk, "tanh",
                                                                     "sigmoid", True)
            ref = {"forward": lstm.lstm_recurrence_forward_plain(zx, rk, "tanh", "sigmoid",
                                                                 True, False)[0],
                   "backward": lstm.lstm_recurrence_backward_plain(dout, z, c, rk, "tanh",
                                                                   "sigmoid", True)}
            cudnn = cs._cudnn_lstm_ms(b, t, u, dtype, args.iters) if m == 1 and not \
                args.check_only else {"forward": None, "backward": None}
            for kind in ("forward", "backward"):
                key = f"{kind} {name} {label} ({m}, {b}, {t}, {u})"
                turns, errors = {"other": [], "source": []}, {}
                for side in ("other", "source", "source", "other"):
                    _use(sides[side])
                    got = calls[kind]()
                    torch.cuda.synchronize()
                    errors[side] = cs._rel_err(got, ref[kind])
                    if not args.check_only:
                        turns[side].append(cs._time_ms(calls[kind], args.iters))
                entry = {"rel_err": errors, "plan": lstm.kernel_plan(m, b, u, dtype,
                                                                      kind == "backward")}
                if not args.check_only:
                    entry.update(turns)
                    entry["source_over_other"] = (statistics.median(turns["source"])
                                                  / statistics.median(turns["other"]))
                    entry["cudnn_ms"] = cudnn[kind]
                result[key] = entry
                print(f"{key} on {card}: {entry}", flush=True)
                if not all(err <= tol[dtype] for err in errors.values()):
                    failures.append(key)
            del zx, rk, out, z, c, dout, ref
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "build_s": build_s, "lstm_ab": result,
                      "failures": failures}))
    if args.sweep:
        lstm._kernel = own_kernel
        failures += sweep(card, args.iters, tol, g)
    if failures:
        print(f"torch_lstm_ab: off the twins at {failures}", file=sys.stderr)
        return 1
    return 0


def sweep(card: str, iters: int, tol: dict, g) -> list:
    """Every plan the source can launch at each of LSTM_SHAPES (U >= 8),
    forced, held against the twins and timed; returns the failures."""
    import itertools

    import torch

    import chip_smoke as cs
    from gordo_tpu_torch.ops import lstm

    result, failures = {}, []
    for label, m, b, t, u in cs.LSTM_SHAPES:
        for dtype in tol:
            name = str(dtype).split(".")[-1]
            zx, rk = cs._lstm_inputs(m, b, t, u, dtype, g)
            out, (z, c, _) = lstm.lstm_recurrence_forward(zx, rk, "tanh", "sigmoid", True, True)
            dout = torch.randn(out.shape, device="cuda", generator=g).to(dtype)
            calls = {"forward": lambda: lstm.lstm_recurrence_forward(zx, rk, "tanh", "sigmoid",
                                                                    True, False)[0],
                     "backward": lambda: lstm.lstm_recurrence_backward(dout, z, c, rk, "tanh",
                                                                      "sigmoid", True)}
            ref = {"forward": lstm.lstm_recurrence_forward_plain(zx, rk, "tanh", "sigmoid",
                                                                 True, False)[0],
                   "backward": lstm.lstm_recurrence_backward_plain(dout, z, c, rk, "tanh",
                                                                   "sigmoid", True)}
            for kind in ("forward", "backward"):
                key = f"{kind} {name} {label} ({m}, {b}, {t}, {u})"
                times = {}
                for route, cluster, rows, ksplit in [("legacy", None, None, None)] + [
                        ("cluster", *plan) for plan in itertools.product(
                            (1, 2, 4, 8, 16), (8, 16, 32), (1, 2, 4))]:
                    lstm.set_route(route, cluster, rows, ksplit)
                    try:
                        plan = lstm.kernel_plan(m, b, u, dtype, kind == "backward")
                    except RuntimeError:
                        continue
                    finally:
                        lstm.set_route(None)
                    lstm.set_route(route, cluster, rows, ksplit)
                    # the other direction's plan may refuse the forcing: not checked
                    limits, lstm.check_launch_limits = lstm.check_launch_limits, (
                        lambda *args: None)
                    try:
                        err = cs._rel_err(calls[kind](), ref[kind])
                        ms = cs._time_ms(calls[kind], iters)
                    finally:
                        lstm.check_launch_limits = limits
                        lstm.set_route(None)
                    times["legacy" if route == "legacy" else
                          f"cluster {cluster} rows {rows} ksplit {ksplit}"] = {
                        "ms": ms, "rel_err": err, "threads": plan["threads"],
                        "tiles_a_warp": plan["tiles_a_warp"], "route": plan["route"]}
                    if err > tol[dtype]:
                        failures.append(f"{key} {route} cluster {cluster} rows {rows} ksplit "
                                        f"{ksplit}")
                own = lstm.kernel_plan(m, b, u, dtype, kind == "backward")
                result[key] = {"plan": own, "forced": times}
                ranked = sorted(times.items(), key=lambda item: item[1]["ms"])
                print(f"sweep {key} on {card}: the plan's (cluster {own['cluster']} rows "
                      f"{own['rows']} ksplit {own['ksplit']}); fastest first: "
                      + "; ".join(f"{k} {v['ms']:.4f} ms" for k, v in ranked), flush=True)
            del zx, rk, out, z, c, dout, ref
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "lstm_plan_sweep": result, "failures": failures}))
    return failures


def stream_ab(card: str, iters: int, tol: dict, g) -> list:
    """At each of STREAM_SHAPES, the plan's STREAM route against the legacy
    route forced, in turns, forward (serving) and backward, each held
    against the twins; returns the failures."""
    import torch

    import chip_smoke as cs
    from gordo_tpu_torch.ops import lstm

    result, failures = {}, []
    for name, m, b, t, u in STREAM_SHAPES:
        dtype = getattr(torch, name)
        zx, rk = cs._lstm_inputs(m, b, t, u, dtype, g)
        out, (z, c, _) = lstm.lstm_recurrence_forward(zx, rk, "tanh", "sigmoid", True, True)
        dout = torch.randn(out.shape, device="cuda", generator=g).to(dtype)
        calls = {"forward": lambda: lstm.lstm_recurrence_forward(zx, rk, "tanh", "sigmoid",
                                                                True, False)[0],
                 "backward": lambda: lstm.lstm_recurrence_backward(dout, z, c, rk, "tanh",
                                                                  "sigmoid", True)}
        ref = {"forward": lstm.lstm_recurrence_forward_plain(zx, rk, "tanh", "sigmoid",
                                                             True, False)[0],
               "backward": lstm.lstm_recurrence_backward_plain(dout, z, c, rk, "tanh",
                                                               "sigmoid", True)}
        for kind in ("forward", "backward"):
            key = f"{kind} {name} ({m}, {b}, {t}, {u})"
            plan = lstm.kernel_plan(m, b, u, dtype, kind == "backward")
            turns, errors = {"legacy": [], "stream": []}, {}
            for route in ("legacy", "stream", "stream", "legacy"):
                lstm.set_route("legacy" if route == "legacy" else None)
                try:
                    errors[route] = cs._rel_err(calls[kind](), ref[kind])
                    turns[route].append(cs._time_ms(calls[kind], iters))
                finally:
                    lstm.set_route(None)
            entry = {"plan": plan, "rel_err": errors, **turns,
                     "stream_over_legacy": (statistics.median(turns["stream"])
                                            / statistics.median(turns["legacy"]))}
            result[key] = entry
            print(f"stream {key} on {card}: {entry}", flush=True)
            if plan["route"] != "stream" or not all(e <= tol[dtype] for e in errors.values()):
                failures.append(key)
        del zx, rk, out, z, c, dout, ref
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "lstm_stream_ab": result, "failures": failures}))
    return failures


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
