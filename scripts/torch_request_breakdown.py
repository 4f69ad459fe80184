"""
Where one anomaly request of the PyTorch/CUDA port spends its time, on
one NVIDIA GPU.

    python3 scripts/torch_request_breakdown.py [float32|bfloat16]   # from the repo root

Writes the ``transformer-ae-512`` artifact of ``chip_smoke.py`` at the given
compute dtype (float32 unless named), loads it
as the port's server does, and times the stages of a 1,535-row anomaly
request in-process (no HTTP): JSON parse, frame decode, ``anomaly_raw``
(the model predict and the scores around it), the model predict alone
(host to device, forward, device to host), and the response encode
(``to_dict`` + JSON). One predict runs under
``torch.profiler`` to split its device time by kernel. Prints the card's
name and power limit and one JSON line of medians over the repetitions.
"""

import json
import statistics
import sys
import time
from datetime import datetime, timezone
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
REPS = 5


def _kernel_group(name: str) -> str:
    if "flash_forward" in name:
        return "flash_attention"
    if any(key in name.lower() for key in ("gemm", "cutlass", "nvjet")):
        return "matmul"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "copy"
    return "other"


def profiled_predict(detector, values) -> dict:
    """One predict under torch.profiler: device time by kernel group and
    the device's busy share of the predict's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            detector.base_estimator.predict(values)
            wall_ms = 1e3 * (time.perf_counter() - t0)
        events = prof.key_averages()
    except RuntimeError as exc:  # the profiler could not trace the card
        return {"profiler": f"not measured: {exc}"}
    device_ms = {}
    for event in events:
        if event.device_type == torch.autograd.DeviceType.CUDA:
            group = _kernel_group(event.key)
            device_ms[group] = device_ms.get(group, 0.0) + event.self_device_time_total / 1e3
    busy = sum(device_ms.values())
    return {
        "profiled_predict_wall_ms": wall_ms,
        "device_ms_by_kernel": device_ms or "not measured (no device events)",
        "device_busy_share": busy / wall_ms if busy else "not measured",
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_request_breakdown: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from gordo_tpu_torch.server.server import ModelEntry
    from gordo_tpu_torch.server.views import extract_X_y

    card = chip_smoke._card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = sys.argv[1] if len(sys.argv) > 1 else "float32"
    collection = REPO / "build" / "request_breakdown" / dtype
    collection.mkdir(parents=True, exist_ok=True)
    chip_smoke.write_artifact(collection, compute_dtype=dtype)
    entry = ModelEntry(str(collection / "transformer-ae-512"), "cuda")
    detector = entry.detector
    values = chip_smoke._series(1535, 8192, np.random.RandomState(1))
    body = json.dumps(chip_smoke._payload(values, datetime(2020, 1, 1, tzinfo=timezone.utc)))

    stages = {k: [] for k in ("parse", "decode", "predict", "anomaly_raw", "encode", "total")}
    for _ in range(REPS + 1):  # the first repetition warms up and is dropped
        t0 = time.perf_counter()
        payload = json.loads(body)
        t1 = time.perf_counter()
        X, y = extract_X_y(payload, entry.tags, entry.target_tags)
        t2 = time.perf_counter()
        detector.base_estimator.predict(X.values)
        t3 = time.perf_counter()
        frame = detector.anomaly_raw(X, y, frequency=entry.frequency)
        t4 = time.perf_counter()
        json.dumps({"data": frame.to_dict()}, allow_nan=False)
        t5 = time.perf_counter()
        # a served request is parse + decode + anomaly_raw (which predicts
        # again) + encode; the lone predict is timed for its share
        for key, dt in (("parse", t1 - t0), ("decode", t2 - t1), ("predict", t3 - t2),
                        ("anomaly_raw", t4 - t3), ("encode", t5 - t4),
                        ("total", t5 - t0 - (t3 - t2))):
            stages[key].append(1e3 * dt)
    result = {f"{k}_ms": statistics.median(v[1:]) for k, v in stages.items()}

    result.update(profiled_predict(detector, X.values), compute_dtype=dtype, card=card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
