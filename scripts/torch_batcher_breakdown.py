"""
Where one fused batcher call spends its time, against the direct predicts
it replaces, on one NVIDIA GPU.

    python3 scripts/torch_batcher_breakdown.py [float32|bfloat16] [MODELS]   # from the repo root

Loads MODELS (8 unless given) ``transformer-ae-512`` models with seeded
weights (``chip_smoke.py``'s ``CONFIG``) at the given compute dtype
(float32 unless named) and predicts one 1,535-row input per model (1,024
windows each) two ways: direct, one after another, and as one fused call
of the cross-model batcher (the inputs queued at once, as
``chip_smoke.py``'s pipeline check queues them). Each way is timed on the
host clock (medians over REPS after a warm-up) and run once under
``torch.profiler`` for its device time by kernel group, its launches and
the device's busy share; the fused lanes are held against the direct
answers. Prints the card's name and power limit and one JSON line.
"""

import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
REPS = 3


def profiled(fn) -> dict:
    """``fn`` once under torch.profiler: device ms and launches by kernel
    group, and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torch_request_breakdown import _kernel_group

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        events = prof.key_averages()
    except RuntimeError as exc:  # the profiler could not trace the card
        return {"profiler": f"not measured: {exc}"}
    device_ms, launches = {}, {}
    for event in events:
        if event.device_type == torch.autograd.DeviceType.CUDA:
            group = _kernel_group(event.key)
            device_ms[group] = device_ms.get(group, 0.0) + event.self_device_time_total / 1e3
            launches[group] = launches.get(group, 0) + event.count
    busy = sum(device_ms.values())
    return {"wall_ms": wall_ms, "device_ms_by_kernel": device_ms or "not measured",
            "launches_by_kernel": launches,
            "device_busy_share": busy / wall_ms if busy else "not measured"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_batcher_breakdown: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "scripts"))
    import chip_smoke
    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.ops.nn import init_model_params
    from gordo_tpu_torch.server import batcher

    card = chip_smoke._card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = sys.argv[1] if len(sys.argv) > 1 else "float32"
    n_models = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    estimators = []
    for m in range(n_models):
        est = TransformerAutoEncoder(**chip_smoke.CONFIG, compute_dtype=dtype)
        spec = est.build_spec(len(chip_smoke.TAGS), len(chip_smoke.TAGS))
        est.load_params(spec, init_model_params(spec, torch.Generator().manual_seed(m)), "cuda")
        estimators.append(est)
    rng = np.random.RandomState(1)
    inputs = [chip_smoke._series(chip_smoke.FULL_ROWS, 2000 * m, rng).astype(np.float32)
              for m in range(n_models)]

    def direct():
        return [est.predict(X) for est, X in zip(estimators, inputs)]

    def fused():
        return chip_smoke._queued(batcher.CrossModelBatcher(), list(zip(estimators, inputs)))

    result = {"compute_dtype": dtype, "models": n_models, "card": card}
    answers = {}
    for name, fn in (("direct", direct), ("fused", fused)):
        answers[name] = fn()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        result[name] = {"wall_ms_median": statistics.median(walls), "wall_ms": walls,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                        **profiled(fn)}
        print(f"{name} ({dtype}, {n_models} x 1,024 windows) on {card}: {result[name]}",
              flush=True)
    result["fused_vs_direct_max_rel"] = chip_smoke._max_rel(answers["fused"], answers["direct"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
