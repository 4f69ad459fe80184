"""
Where one training step of the PyTorch/CUDA port spends its time, on one
NVIDIA GPU.

    python3 scripts/torch_train_breakdown.py [float32|bfloat16] [MACHINES]   # from the repo root

Builds ``chip_smoke.py``'s ``transformer-ae-512`` model (seeded weights,
attention through the flash kernels) at the given compute dtype (float32
unless named; bfloat16 is ``transformer-ae-512-bf16``) and its 6,144
training rows, runs
warm-up steps of ``ops/train.py``'s epoch function (Adam, MSE, batch 32;
with MACHINES above 1, the fleet trainer's stacked step of that many
machines, ``run_masked_epoch`` on a ``StackedTransformerModel``),
then times STEPS steps on the host clock (ending in a synchronise) and runs
STEPS more under ``torch.profiler`` to split the device time by kernel
group: fp32 matmuls, the flash forward, dQ and dK/dV kernels, the
optimizer's kernels, copies and other kernels. Prints the card's name and
power limit and one JSON line.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
WARMUP, STEPS = 10, 50


def _kernel_group(name: str) -> str:
    lower = name.lower()
    for key, group in (("flash_forward", "flash_forward"), ("flash_bwd_dq", "flash_dq"),
                       ("flash_bwd_dkv", "flash_dkv"), ("multi_tensor", "optimizer"),
                       ("adam", "optimizer"), ("gemm", "matmul"), ("cutlass", "matmul"),
                       ("nvjet", "matmul"),
                       ("memcpy", "copy"), ("memset", "copy")):
        if key in lower:
            return group
    return "other"


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_train_breakdown: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.models.scaler import MinMaxScaler
    from gordo_tpu_torch.ops import train
    from gordo_tpu_torch.ops.nn import (
        StackedTransformerModel, TransformerModel, init_model_params, stack_params,
    )
    from gordo_tpu_torch.ops.predict import n_train_samples

    card = chip_smoke._card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(chip_smoke.SEED)
    rows = np.concatenate([chip_smoke._series(4096, 0, rng), chip_smoke._series(2048, 4096, rng)])
    dtype = sys.argv[1] if len(sys.argv) > 1 else "float32"
    machines = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    spec = TransformerAutoEncoder(**chip_smoke.CONFIG, compute_dtype=dtype).build_spec(8, 8)
    params = [init_model_params(spec, torch.Generator().manual_seed(chip_smoke.SEED + m))
              for m in range(machines)]
    X = torch.as_tensor(MinMaxScaler().fit(rows).transform(rows), dtype=torch.float32,
                        device="cuda")
    order = torch.randperm(n_train_samples(spec, len(rows)),
                           generator=torch.Generator().manual_seed(chip_smoke.SEED))
    batch = chip_smoke.BATCH
    if machines == 1:
        model = TransformerModel(spec, params[0], torch.device("cuda"))
    else:
        model = StackedTransformerModel(spec, stack_params(
            [[{k: v.numpy() for k, v in p.items()} for p in machine] for machine in params]),
            torch.device("cuda"))
        X = X.expand(machines, *X.shape).contiguous()
    optimizer = train.make_optimizer(spec.optimizer, model.parameters())

    def steps(n: int, first: int) -> None:
        if machines == 1:
            train.run_epoch(model, optimizer, X, X, order[first * batch:(first + n) * batch],
                            batch)
            return
        # the stacked step takes each machine's live samples as a prefix:
        # the rows of these n steps' windows, in each machine's own order
        rows_n = X[:, first * batch:(first + n) * batch + spec.lookback_window - 1]
        orders = torch.stack([torch.randperm(n * batch) for _ in range(machines)])
        train.run_masked_epoch(model, optimizer, rows_n, rows_n, orders, n * batch, batch)

    steps(WARMUP, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(STEPS, WARMUP)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / STEPS

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(STEPS, WARMUP + STEPS)
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    device_ms, kernels = {}, []
    for event in prof.key_averages():
        # user annotations (``Optimizer.step#Adam.step``) span the kernels
        # they enclose on the device timeline: counting them would count twice
        if (event.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(event, "is_user_annotation", False)
                and not event.key.startswith("Optimizer.")):
            ms = event.self_device_time_total / 1e3
            group = _kernel_group(event.key)
            device_ms[group] = device_ms.get(group, 0.0) + ms
            kernels.append((ms / STEPS, event.count / STEPS, group, event.key[:90]))
    per_step = {k: v / STEPS for k, v in sorted(device_ms.items(), key=lambda kv: -kv[1])}
    busy = sum(per_step.values())
    result = {
        "config": "transformer-ae-512", "compute_dtype": dtype, "batch": batch,
        "machines": machines,
        "steps": STEPS,
        "step_ms": step_ms, "profiled_step_ms": profiled_ms,
        "device_ms_per_step_by_kernel": per_step or "not measured (no device events)",
        # the profiler slows the host, not the kernels: the device's share of
        # an unprofiled step is its kernel time over that step's time
        "device_busy_share_of_step": busy / step_ms if busy else "not measured",
        "kernel_launches_per_step": sum(k[1] for k in kernels),
        "top_kernels_ms_launches_per_step": sorted(kernels, reverse=True)[:15],
        "card": card,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
