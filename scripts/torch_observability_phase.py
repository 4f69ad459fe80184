"""
``chip_smoke.py``'s telemetry and observability phase alone, on one NVIDIA
GPU: after the kernels and the native codec are built, a seeded
``transformer-ae-512`` artifact and its bf16 twin are written as the
batcher phases write theirs (``write_artifact``), and
``observability_path`` runs over them: both lanes with every knob on and
their gates, the busy seconds against a ``torch.profiler`` trace, the
device trace and a burst profile under load, the JSON logs, the knobs'
overhead and the profiled ``batch-build``. A quicker way than the whole
smoke run to iterate on the telemetry plane. After the phase it prints the
largest idle gaps between the kernels on the dispatcher's stream in the
profiled burst the busy-seconds gate reads (:func:`kernel_gaps`).

    python3 scripts/torch_observability_phase.py        # from the repo root
    python3 scripts/torch_observability_phase.py --overhead-rounds 3 --overhead-requests 12

With ``--overhead-rounds N`` it then measures the knobs' overhead over a
longer window than the smoke's (N rounds of off, on, on, off turns of 16
users x ``--overhead-requests`` requests each, on the default lane) and
prints the medians of the like turns beside their spread.

    python3 scripts/torch_observability_phase.py --contention 0 1 4x1 --burst-requests 1 3

With ``--contention`` it runs no phase: it serves the float32 model on the
default lane with every knob on and, for each contention setting and each
burst size, profiles one burst as the smoke's busy gate does
(``_obs_busy_burst``) while Python threads compete for the interpreter
lock: ``N`` is N threads that compute without pause, ``NxM`` N threads
that compute 0.5 ms and sleep M ms in turn. It prints the busy seconds
against the kernel union, the burst's latencies and the largest idle gaps
on the dispatcher's stream: how far the busy reading (CUDA events around
each fused forward) counts the device's wait for launches the host paces.

It prints the phase's gates and numbers as ``chip_smoke.py`` does; the
last line is one JSON object of its results. A failed gate raises.
"""

import argparse
import concurrent.futures
import json
import shutil
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def kernel_gaps(trace: dict, symbol: str, top: int = 8) -> None:
    """Print the largest idle gaps between consecutive kernels on the
    stream that ran ``symbol``, each with the kernels around it, the device
    memcpy/memset events and the CUDA runtime calls inside it."""
    events = trace["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    stream = next(e["args"].get("stream") for e in kernels if symbol in e["name"])
    mine = sorted((e for e in kernels if e["args"].get("stream") == stream),
                  key=lambda e: e["ts"])
    gaps = sorted(((b["ts"] - (a["ts"] + a["dur"]), a, b) for a, b in zip(mine, mine[1:])),
                  key=lambda g: -g[0])[:top]
    device = [e for e in events if e.get("cat") in ("gpu_memcpy", "gpu_memset")]
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    for gap, before, after in gaps:
        lo, hi = before["ts"] + before["dur"], after["ts"]
        inside = sorted({e["name"] for e in device + runtime
                         if e["ts"] < hi and e["ts"] + e.get("dur", 0) > lo})
        print(f"  gap {gap / 1e3:.3f} ms after {before['name'][:60]!r} before "
              f"{after['name'][:60]!r}; during it: {inside[:12]}", flush=True)
    on_stream = [e for e in device if e["args"].get("stream") == stream]
    print(f"  {len(on_stream)} memcpy/memset events on the stream, "
          f"{sum(e['dur'] for e in on_stream) / 1e3:.3f} ms", flush=True)


def _hogs(setting: str, stop: threading.Event) -> list:
    """Threads that hold the interpreter lock in Python code: ``N`` without
    pause, ``NxM`` 0.5 ms at a time with M ms of sleep between."""
    count, _, nap_ms = setting.partition("x")
    nap = float(nap_ms or 0) / 1e3

    def hog():
        while not stop.is_set():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.0005:
                sum(range(200))
            if nap:
                time.sleep(nap)

    threads = [threading.Thread(target=hog, daemon=True) for _ in range(int(count))]
    for thread in threads:
        thread.start()
    return threads


def busy_under_contention(card: str, root: Path, settings: list, requests: list) -> dict:
    """The busy burst of the smoke's gate under each contention setting and
    burst size (module docstring)."""
    collection = root / "contention" / "1"
    collection.mkdir(parents=True)
    (collection / cs.OBS_MODELS[0]).symlink_to(root / "batcher" / "float32" / "1" / "batcher-m0")
    body = cs._rect_body(cs._series(cs.FULL_ROWS, 120000, cs.np.random.RandomState(cs.SEED + 17)))
    bodies = {cs.OBS_MODELS[0]: body}
    cs._obs_knobs_on()
    served = cs._ObsServer(collection, "default", "cuda")
    out = {}
    try:
        for _ in range(2):  # warm
            cs._obs_traffic(served.base, bodies, models=cs.OBS_MODELS[:1], requests=1)
        for setting in settings:
            for n in requests:
                stop = threading.Event()
                threads = _hogs(setting, stop)
                try:
                    burst = cs._obs_busy_burst(served, bodies, root, requests=n)
                finally:
                    stop.set()
                    for thread in threads:
                        thread.join()
                key = f"hogs {setting}, {n} request(s) a user"
                out[key] = {k: v for k, v in burst.items() if k != "trace"}
                print(f"busy under contention on {card}: {key}: busy {burst['busy_s']:.6f} s, "
                      f"kernel union {burst['kernel_union_s']:.6f} s, rel diff "
                      f"{burst['rel_diff']:.4f}, latency {burst['latency']}", flush=True)
                with open(burst["trace"]) as fh:
                    kernel_gaps(json.load(fh), "flash_forward_f32", top=3)
    finally:
        served.close()
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--overhead-rounds", type=int, default=0)
    parser.add_argument("--overhead-requests", type=int, default=cs.OBS_REQUESTS)
    parser.add_argument("--contention", nargs="*", default=None)
    parser.add_argument("--burst-requests", nargs="*", type=int, default=[cs.OBS_BUSY_REQUESTS])
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("torch_observability_phase: no CUDA device", file=sys.stderr)
        return 2
    from gordo_tpu_torch import native
    from gordo_tpu_torch.ops import _build

    card = cs._card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native_build = pool.submit(native.load)
        _build.build_all()
        native_build.result()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    root = cs.REPO / "build" / "observability_phase"
    shutil.rmtree(root, ignore_errors=True)
    for dtype, extra in (("float32", {}), ("bfloat16", {"compute_dtype": "bfloat16"})):
        collection = root / "batcher" / dtype / "1"
        collection.mkdir(parents=True)
        cs.write_artifact(collection, name="batcher-m0", seed=cs.SEED + 100, **extra)
    if args.contention is not None:
        out = busy_under_contention(card, root, args.contention or ["0"], args.burst_requests)
        print(card)
        print(json.dumps({"busy_under_contention": out}, default=str))
        return 0
    out = cs.observability_path(card, root / "observability", root / "batcher")
    with open(root / "observability" / "busy_burst_trace.json") as fh:
        kernel_gaps(json.load(fh), "flash_forward_f32")
    if args.overhead_rounds:
        collection = root / "overhead" / "1"
        collection.mkdir(parents=True)
        for model, dtype in zip(cs.OBS_MODELS, ("float32", "bfloat16")):
            (collection / model).symlink_to(root / "batcher" / dtype / "1" / "batcher-m0")
        bodies = {model: cs._rect_body(cs._series(cs.FULL_ROWS, 120000,
                                                  cs.np.random.RandomState(cs.SEED + 17)))
                  for model in cs.OBS_MODELS}
        out["long_overhead"] = cs._obs_overhead(card, collection, bodies, "cuda",
                                                rounds=args.overhead_rounds,
                                                requests=args.overhead_requests)
    print(card)
    print(json.dumps({"observability": out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
