"""
Device telemetry sampler: memory, duty cycle, param-bank residency, MFU;
the port's counterpart of ``gordo_tpu/observability/device.py``. It runs on
demand (no background thread): as a shard-flush sampler and at
``/metrics`` and ``/debug/vars`` time.

- **Device memory** into ``gordo_server_device_memory_bytes{device,stat}``,
  the JAX stat names filled from torch for every ``i <
  torch.cuda.device_count()``: ``bytes_in_use`` is
  ``torch.cuda.memory_stats(i)["allocated_bytes.all.current"]`` (what
  ``torch.cuda.memory_allocated(i)`` reads), ``peak_bytes_in_use`` is
  ``["allocated_bytes.all.peak"]``, and ``bytes_limit`` is
  ``torch.cuda.mem_get_info(i)[1]``, the card's total memory. No series on
  a process without CUDA, as the JAX package has none on the CPU.
- **Param-bank residency** from the cross-model batcher's banks: the sum of
  ``nbytes`` over every bank's device tensors, and the used share of their
  slots.
- **Program cache**: ``PROGRAM_CACHE_ENTRIES`` stays 0. The JAX batcher
  counts its compiled stacked-apply programs there; the port's fused call
  is eager torch over hand-written kernels and compiles no program.
- **Dispatcher duty cycle** (``gordo_server_device_busy_ratio``): the
  batcher adds each fused call's busy seconds to
  ``gordo_server_device_busy_seconds_total``, on the card from CUDA events
  around the call's forward on the dispatcher's stream (server/batcher.py),
  on the CPU from the host clock; this sampler differentiates the counter
  over the sampling interval, adding the host seconds of the call in
  flight, as the JAX sampler does.
- **Online MFU** (``gordo_server_device_mfu``): the batcher's achieved
  forward FLOPs (ops/flops.py) differentiated over the interval and
  divided by the card's peak (``flops.serving_peak_flops``).

Peek-only (never creates a batcher) and best-effort: a sampling failure
never fails a scrape or a request.
"""

import threading
import time
from typing import Any, Dict, Optional

# the JAX stat names and the torch.cuda.memory_stats keys they are read from
# (bytes_limit comes from torch.cuda.mem_get_info instead)
_MEMORY_STATS = (("bytes_in_use", "allocated_bytes.all.current"),
                 ("peak_bytes_in_use", "allocated_bytes.all.peak"))

_lock = threading.Lock()
# previous (monotonic, busy_seconds, flops) sample for rate derivation
_last_sample: Optional[Dict[str, float]] = None


def _sample_memory() -> None:
    import torch

    from . import metrics as metric_catalog

    if not torch.cuda.is_available():
        return
    for index in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(index)
        for stat, key in _MEMORY_STATS:
            metric_catalog.DEVICE_MEMORY.labels(device=str(index), stat=stat).set(
                float(stats.get(key, 0)))
        metric_catalog.DEVICE_MEMORY.labels(device=str(index), stat="bytes_limit").set(
            float(torch.cuda.mem_get_info(index)[1]))


def _sample_batcher() -> float:
    """Param-bank and program-cache gauges; returns the host seconds of the
    device call in flight (0.0 between calls) for the duty-cycle sampler."""
    from ..server import batcher as batcher_mod
    from . import metrics as metric_catalog

    metric_catalog.PROGRAM_CACHE_ENTRIES.set(0)
    batcher = batcher_mod.peek_batcher()
    if batcher is None:
        return 0.0
    total_bytes = 0.0
    used = 0
    capacity = 0
    for bank in list(batcher._banks.values()):
        used += len(bank)
        capacity += bank.capacity
        stacked = bank.stacked
        if stacked is not None:
            for layer in stacked:
                for tensor in layer.values():
                    total_bytes += float(tensor.nbytes)
    metric_catalog.PARAM_BANK_BYTES.set(total_bytes)
    metric_catalog.PARAM_BANK_OCCUPANCY.set((used / capacity) if capacity else 0.0)
    return batcher.device_call_stuck_s()


def _sample_rates(inflight_s: float) -> None:
    """Differentiate the busy-seconds and achieved-FLOPs counters over the
    interval since the previous sample into the duty-cycle and online-MFU
    gauges."""
    global _last_sample
    from . import metrics as metric_catalog

    now = time.monotonic()
    busy = metric_catalog.DEVICE_BUSY_SECONDS.value() + inflight_s
    flops = metric_catalog.DEVICE_FLOPS.value()
    with _lock:
        last = _last_sample
        _last_sample = {"t": now, "busy": busy, "flops": flops}
    if last is None:
        return
    dt = now - last["t"]
    if dt <= 0.01:
        return  # scrape storm: keep the previous ratio rather than divide
    ratio = max(0.0, busy - last["busy"]) / dt
    metric_catalog.DEVICE_BUSY_RATIO.set(min(ratio, 1.0))
    from ..ops import flops as flops_mod

    peak, _source = flops_mod.serving_peak_flops()
    if peak:
        metric_catalog.DEVICE_MFU.set(max(0.0, flops - last["flops"]) / dt / peak)


def sample() -> None:
    """Refresh every device-telemetry gauge (best-effort per section)."""
    inflight = 0.0
    try:
        inflight = _sample_batcher()
    except Exception:  # noqa: BLE001 — sampling must not fail the caller
        pass
    try:
        _sample_memory()
    except Exception:  # noqa: BLE001
        pass
    try:
        _sample_rates(inflight)
    except Exception:  # noqa: BLE001
        pass


def snapshot() -> Dict[str, Any]:
    """Device-telemetry dict for /debug/vars (gauges refreshed first)."""
    sample()
    from ..ops import flops as flops_mod
    from . import metrics as metric_catalog

    peak, source = flops_mod.serving_peak_flops()
    return {
        "busy_ratio": metric_catalog.DEVICE_BUSY_RATIO.value(),
        "busy_seconds_total": metric_catalog.DEVICE_BUSY_SECONDS.value(),
        "achieved_flops_total": metric_catalog.DEVICE_FLOPS.value(),
        "online_mfu": metric_catalog.DEVICE_MFU.value(),
        "peak_flops": peak,
        "peak_source": source,
        "param_bank_bytes": metric_catalog.PARAM_BANK_BYTES.value(),
        "param_bank_occupancy": metric_catalog.PARAM_BANK_OCCUPANCY.value(),
        "program_cache_entries": metric_catalog.PROGRAM_CACHE_ENTRIES.value(),
    }


def install_shard_hooks() -> None:
    """Register the sampler with the shared-telemetry shard machinery so
    every flush ships fresh device gauges."""
    from . import shared

    shared.register_sampler(sample)


def reset_for_tests() -> None:
    global _last_sample
    with _lock:
        _last_sample = None
