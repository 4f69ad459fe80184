"""
Where examples/config.yaml's compressor-b build spends its time, on one
NVIDIA GPU: the machine (``chip_smoke.LSTM_EXAMPLE_MACHINE``: an
LSTMAutoEncoder, six LSTM layers of 2-3 units, lookback 24, 3 epochs at
batch 1) built by ``ModelBuilder`` on the card, with every ``fit_arrays``
call and every epoch timed on the host clock (after a synchronize), then
``torch.profiler`` over STEPS training steps of its spec: device busy
share and the top operations by host and device time.

    python3 scripts/torch_lstm_build_breakdown.py   # from the repo root

Prints the card's name and power limit, the fits (samples, epochs,
seconds, ms a step), the phases, the profile's tables, and one JSON line.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

STEPS = 100


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_lstm_build_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from gordo_tpu_torch.builder import ModelBuilder
    from gordo_tpu_torch.machine import Machine
    from gordo_tpu_torch.models import models
    from gordo_tpu_torch.ops import _build, train
    from gordo_tpu_torch.ops.nn import TransformerModel, init_model_params

    card = cs._card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    fits, epochs = [], []
    fit_arrays, run_epoch = train.fit_arrays, train.run_epoch

    def timed_fit(model, X, y, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fit_arrays(model, X, y, **kwargs)
        torch.cuda.synchronize()
        fits.append({"rows": len(X), "epochs": out.epochs_trained,
                     "seconds": time.perf_counter() - t0})
        return out

    def timed_epoch(model, optimizer, X, y, order, batch_size):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_epoch(model, optimizer, X, y, order, batch_size)
        epochs.append({"samples": len(order), "seconds": time.perf_counter() - t0})
        return out

    models.fit_arrays = timed_fit
    train.run_epoch = timed_epoch
    try:
        machine = Machine.from_config(cs.LSTM_EXAMPLE_MACHINE, "breakdown")
        t0 = time.perf_counter()
        model, machine = ModelBuilder(machine, "cuda").build()
        seconds = time.perf_counter() - t0
    finally:
        models.fit_arrays = fit_arrays
        train.run_epoch = run_epoch
    phases = machine.metadata.build_metadata.phases
    for f in fits:
        f["epoch_seconds"] = [e["seconds"] for e in epochs[:f["epochs"]]]
        f["steps"] = sum(e["samples"] for e in epochs[:f["epochs"]])
        f["ms_per_step"] = 1e3 * sum(f["epoch_seconds"]) / max(f["steps"], 1)
        del epochs[:f["epochs"]]
        print(f"fit of {f['rows']} rows: {f['epochs']} epochs, {f['steps']} steps, "
              f"{f['seconds']:.2f} s ({f['ms_per_step']:.3f} ms a step in its epochs)",
              flush=True)
    print(f"compressor-b build on {card}: {seconds:.2f} s, phases {phases}", flush=True)

    spec = model.base_estimator.steps[-1][1].spec_
    net = TransformerModel(spec, init_model_params(spec, torch.Generator().manual_seed(0)),
                           torch.device("cuda"))
    optimizer = train.make_optimizer(spec.optimizer, net.parameters())
    X = torch.rand((STEPS + 64, spec.n_features), device="cuda")
    run_epoch(net, optimizer, X, X, torch.arange(8), 1)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run_epoch(net, optimizer, X, X, torch.arange(STEPS), 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    device_us = sum(getattr(e, "self_device_time_total", 0) for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    busy = device_us / 1e6 / wall
    print(f"{STEPS} steps of compressor-b's spec under the profiler on {card}: "
          f"{1e3 * wall / STEPS:.3f} ms a step, device busy {busy:.1%}", flush=True)
    print(events.table(sort_by="self_cpu_time_total", row_limit=15), flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=10), flush=True)
    print(card)
    print(json.dumps({"lstm_build_breakdown": {
        "seconds": seconds, "phases": phases, "fits": fits,
        "profiled_ms_per_step": 1e3 * wall / STEPS, "device_busy": busy}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
