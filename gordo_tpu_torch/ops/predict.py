"""
Serving-time prediction: the port's counterpart of ``n_train_samples``,
``pad_for_predict`` and ``predict_fn`` in ``gordo_tpu/ops/train.py``.

Requests are padded to a power-of-two count of windows, as the JAX package
pads them (there to bound its compiled programs; here it keeps the kernel
shapes of a model to a few buckets). The windows are gathered on the
device, and the forward pass runs under ``torch.inference_mode()``.
"""

from typing import Callable, Tuple

import numpy as np
import torch

from ..models.spec import ModelSpec


def n_train_samples(spec: ModelSpec, n_rows: int) -> int:
    """Number of samples (windows) obtainable from n_rows rows."""
    if spec.lookback_window <= 1 and spec.lookahead == 0:
        return n_rows
    return max(n_rows - spec.lookback_window + 1 - spec.lookahead, 0)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def pad_for_predict(spec: ModelSpec, X) -> Tuple[np.ndarray, int, int]:
    """``(X_pad, n_pad, n_keep)``: the input padded with zero rows, the
    power-of-two count of outputs computed, and how many leading outputs
    are real."""
    X = np.asarray(X, np.float32)
    n_out = n_train_samples(spec, len(X))
    if n_out <= 0:
        raise ValueError(
            f"Need at least {spec.lookback_window + spec.lookahead} rows, got {len(X)}"
        )
    if spec.lookback_window <= 1 and spec.lookahead == 0:
        n_pad = _next_pow2(len(X))
        X_pad = np.zeros((n_pad, X.shape[1]), np.float32)
        X_pad[: len(X)] = X
        return X_pad, n_pad, len(X)
    n_pad = _next_pow2(n_out)
    rows_needed = max(n_pad + spec.lookback_window - 1 + spec.lookahead, len(X))
    X_pad = np.zeros((rows_needed, X.shape[1]), np.float32)
    X_pad[: len(X)] = X
    return X_pad, n_pad, n_out


def unfold_windows(spec: ModelSpec, x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Padded rows (..., rows, D) as (..., n_pad, L, D) windows, a view:
    window i is rows i .. i+L-1, the layout of ``X[idx[:, None] + window]``
    in the JAX package. A spec without windows takes the rows as they are."""
    if spec.lookback_window <= 1 and spec.lookahead == 0:
        return x
    return x.unfold(-2, spec.lookback_window, 1)[..., :n_pad, :, :].transpose(-1, -2)


def predict_padded(model: torch.nn.Module, X_pad: np.ndarray, n_pad: int) -> np.ndarray:
    """The model's (n_pad, outputs) on padded rows, in float32 on the host."""
    device = next(model.parameters()).device
    with torch.inference_mode():
        x = unfold_windows(model.spec, torch.from_numpy(X_pad).to(device), n_pad)
        return model(x).cpu().numpy()


def predict_fn(model: torch.nn.Module) -> Callable[[np.ndarray], np.ndarray]:
    """A predictor ``f(X) -> np.ndarray`` for a model whose parameters
    stay resident on its device between calls."""
    spec: ModelSpec = model.spec

    def predict(X: np.ndarray) -> np.ndarray:
        X_pad, n_pad, n_keep = pad_for_predict(spec, X)
        return predict_padded(model, X_pad, n_pad)[:n_keep]

    return predict
