"""
Analytic FLOPs accounting per :class:`~gordo_tpu_torch.models.spec.ModelSpec`:
the port's counterpart of ``gordo_tpu/ops/flops.py``, by the same layer walk,
so the achieved-FLOPs counter and the online MFU of the serving batcher
(server/batcher.py, observability/device.py) count what the JAX package
counts.

Conventions (standard accounting, matmul-dominated):
- a matmul of (m, k) x (k, n) costs 2*m*k*n FLOPs
- backward pass costs ~2x forward (grad wrt inputs + grad wrt weights)
- elementwise work (activations, norms, residuals) is ignored

The denominator is the card's, one per card as in the JAX package: its
dense bf16 matrix peak, whatever dtype the model computes in (the hardest
denominator). ``GORDO_TPU_PEAK_FLOPS`` overrides the table; an unknown card
(or the CPU) falls back to the measured throughput of a float32
``torch.matmul`` GEMM on the device.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

from ..models.spec import (
    DenseLayer,
    LSTMLayer,
    ModelSpec,
    MoEBlock,
    PoolLayer,
    PositionalEncoding,
    TCNBlock,
    TransformerBlock,
)
from .nn import layer_out_dim


def forward_flops_per_sample(spec: ModelSpec) -> float:
    """FLOPs of one forward pass for one sample.

    For windowed models a "sample" is one lookback window of T =
    ``spec.lookback_window`` timesteps; for dense models it is one row.
    """
    T = max(int(spec.lookback_window), 1)
    windowed = T > 1
    in_dim = spec.n_features
    total = 0.0
    seq = windowed  # whether the current tensor still has a time axis
    for layer in spec.layers:
        steps = T if seq else 1
        if isinstance(layer, DenseLayer):
            total += 2.0 * in_dim * layer.units * steps
        elif isinstance(layer, LSTMLayer):
            # 4 gates, each an (in + hidden) x hidden matmul per timestep
            total += 8.0 * (in_dim * layer.units + layer.units**2) * T
            seq = layer.return_sequences
        elif isinstance(layer, TransformerBlock):
            d, ff = layer.d_model, layer.ff_dim
            # QKVO projections: 4 d x d matmuls per token
            total += 8.0 * d * d * T
            # scores (T x d x T) + weighted values (T x T x d), per sequence
            total += 4.0 * T * T * d
            # FFN: d->ff->d per token
            total += 4.0 * d * ff * T
        elif isinstance(layer, MoEBlock):
            d = layer.d_model
            total += 8.0 * d * d * T + 4.0 * T * T * d
            # router + top-1 expert FFN per token
            total += 2.0 * d * layer.num_experts * T
            total += 4.0 * d * layer.expert_dim * T
        elif isinstance(layer, TCNBlock):
            # two causal dilated convs (+ a possible 1x1 residual projection)
            k, f = layer.kernel_size, layer.filters
            total += 2.0 * k * in_dim * f * T + 2.0 * k * f * f * T
            if in_dim != f:
                total += 2.0 * in_dim * f * T
        elif isinstance(layer, (PoolLayer, PositionalEncoding)):
            if isinstance(layer, PoolLayer):
                seq = False
        in_dim = layer_out_dim(layer, in_dim)
    return total


def training_flops_per_sample(spec: ModelSpec) -> float:
    """Forward + backward (~2x forward); remat re-runs forward once more."""
    mult = 4.0 if spec.remat else 3.0
    return mult * forward_flops_per_sample(spec)


def n_windows(spec: ModelSpec, n_rows: int) -> int:
    """Output rows for an input of ``n_rows`` (``ModelSpec.output_offset``)."""
    return max(n_rows - spec.output_offset, 0)


def cv_build_flops(spec: ModelSpec, n_rows: int, epochs: int, n_splits: int = 3) -> float:
    """Total FLOPs of one machine build: ``n_splits`` TimeSeriesSplit fold
    trainings and fold predictions, then the full fit. TimeSeriesSplit on N
    rows yields train sizes k*N/(n_splits+1) and test size N/(n_splits+1)
    per fold."""
    fwd = forward_flops_per_sample(spec)
    train = training_flops_per_sample(spec)
    fold = n_rows // (n_splits + 1)
    total = 0.0
    for k in range(1, n_splits + 1):
        total += train * n_windows(spec, k * fold) * epochs
        total += fwd * n_windows(spec, fold)
    total += train * n_windows(spec, n_rows) * epochs
    return total


# dense bf16 tensor-core peak FLOP/s per card, by torch.cuda.get_device_name()
# substring: the H100 SXM5's 989.4 TFLOP/s (NVIDIA H100 Tensor Core GPU
# datasheet, "BF16 Tensor Core", the figure without sparsity), under the name
# the card reports. MFU is always reported against it, float32 models included.
_PEAK_BF16 = {
    "H100 80GB HBM3": 989.4e12,
}


def _listed_peak(device_name: str) -> Tuple[Optional[float], Optional[str]]:
    """``(peak, source)`` from env ``GORDO_TPU_PEAK_FLOPS`` (``env``) or the
    table (``table``); ``(None, None)`` for an unknown card."""
    env = os.environ.get("GORDO_TPU_PEAK_FLOPS")
    if env:
        try:
            return float(env), "env"
        except ValueError:
            pass
    for key, peak in _PEAK_BF16.items():
        if key.lower() in (device_name or "").lower():
            return peak, "table"
    return None, None


def chip_peak_flops(device_name: str) -> Optional[float]:
    """Peak bf16 FLOP/s for a ``torch.cuda.get_device_name()`` string, or
    None when unknown (override with env ``GORDO_TPU_PEAK_FLOPS``)."""
    return _listed_peak(device_name)[0]


# ------------------------------------------------- measured-peak fallback
# an unknown card (or the CPU) has no table entry: the best-of-3 throughput
# of a float32 GEMM on the serving device stands in, measured once a process
_GEMM_N = 1024

# in-process memo: None = not measured yet, 0.0 = measurement failed
_measured_peak: Optional[float] = None


def measured_peak_flops(device=None) -> Optional[float]:
    """Best-of-3 float32 ``torch.matmul`` throughput on ``device`` (the
    card unless torch has none), synchronised around each GEMM; None when
    the measurement fails."""
    global _measured_peak
    if _measured_peak is not None:
        return _measured_peak or None
    try:
        import torch

        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        device = torch.device(device)

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        a = torch.ones((_GEMM_N, _GEMM_N), dtype=torch.float32, device=device)
        b = torch.ones((_GEMM_N, _GEMM_N), dtype=torch.float32, device=device)
        torch.matmul(a, b)
        sync()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            torch.matmul(a, b)
            sync()
            best = min(best, time.perf_counter() - t0)
        _measured_peak = 2.0 * float(_GEMM_N) ** 3 / max(best, 1e-9)
        return _measured_peak
    except Exception:  # noqa: BLE001 — a peak estimate is never worth a crash
        _measured_peak = 0.0
        return None


def peak_flops_with_source(device_name: str) -> Tuple[Optional[float], Optional[str]]:
    """``(peak FLOP/s, source)``: ``env`` (``GORDO_TPU_PEAK_FLOPS``), ``table``
    (a known card) or ``measured`` (the GEMM fallback); ``(None, None)`` only
    when even the measurement failed."""
    peak, source = _listed_peak(device_name)
    if peak:
        return peak, source
    peak = measured_peak_flops()
    if peak:
        return peak, "measured"
    return None, None


def serving_peak_flops() -> Tuple[Optional[float], Optional[str]]:
    """``peak_flops_with_source`` for the process's serving card (device 0),
    or the CPU's measured GEMM where torch has no card."""
    try:
        import torch

        name = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    except Exception:  # noqa: BLE001 — no device, no peak
        return None, None
    return peak_flops_with_source(name)


def mfu(total_flops: float, wall_sec: float, device_name: str, n_devices: int = 1
        ) -> Optional[float]:
    """Model FLOPs utilization against the host's aggregate peak (card peak
    x device count)."""
    value, _source = mfu_with_source(total_flops, wall_sec, device_name, n_devices)
    return value


def mfu_with_source(total_flops: float, wall_sec: float, device_name: str,
                    n_devices: int = 1) -> Tuple[Optional[float], Optional[str]]:
    """``(mfu, peak_source)``, so an MFU against a measured peak is never
    taken for one against a datasheet."""
    peak, source = peak_flops_with_source(device_name)
    if not peak or wall_sec <= 0:
        return None, source
    return total_flops / wall_sec / (peak * max(n_devices, 1)), source


def spec_param_count(spec: ModelSpec) -> int:
    """Parameter count by the same layer walk (used for sanity checks)."""
    in_dim = spec.n_features
    total = 0
    for layer in spec.layers:
        if isinstance(layer, DenseLayer):
            total += in_dim * layer.units + layer.units
        elif isinstance(layer, LSTMLayer):
            total += 4 * (in_dim * layer.units + layer.units**2 + layer.units)
        elif isinstance(layer, TransformerBlock):
            d = layer.d_model
            total += 4 * d * d + 2 * d * layer.ff_dim
        elif isinstance(layer, MoEBlock):
            d = layer.d_model
            total += 4 * d * d
            total += d * layer.num_experts
            total += layer.num_experts * 2 * d * layer.expert_dim
        elif isinstance(layer, TCNBlock):
            k, f = layer.kernel_size, layer.filters
            total += k * in_dim * f + k * f * f
        in_dim = layer_out_dim(layer, in_dim)
    return total
