"""
Windowed Transformer estimators: the port's counterparts of
``TransformerAutoEncoder`` and ``TransformerForecast`` in
``gordo_tpu/models/models.py``.

An estimator holds its spec and a :class:`~gordo_tpu_torch.ops.nn.TransformerModel`
whose parameters stay on the device; ``predict`` takes and returns numpy.
Training comes with the training slice: ``fit`` raises.
"""

import dataclasses
from typing import Any, Dict

import numpy as np

from .. import resolve_device
from ..ops.nn import TransformerModel
from ..ops.predict import predict_fn
from .factories import FACTORIES
from .spec import ModelSpec

_PARALLEL_KWARGS = (
    "tensor_parallel", "pipeline_parallel", "expert_parallel", "data_parallel"
)
# estimator kwargs that are fit arguments or spec-level knobs, never factory kwargs
_NON_FACTORY_KWARGS = (
    "batch_size", "epochs", "verbose", "callbacks", "validation_split", "shuffle",
    "compute_dtype", "remat", *_PARALLEL_KWARGS,
)


class WindowedSequenceEstimator:
    """Many-to-one windowed estimator over a registered factory ``kind``."""

    factory_type = ""
    lookahead = 0

    def __init__(self, kind: str = "transformer_model", lookback_window: int = 144,
                 **kwargs):
        if kind not in FACTORIES:
            raise ValueError(
                f"kind: {kind} is not an available model for type: {self.factory_type}!"
            )
        if lookback_window < 2:
            raise ValueError(
                f"{type(self).__name__} requires lookback_window >= 2, "
                f"got {lookback_window}"
            )
        self.kind = kind
        self.kwargs: Dict[str, Any] = {"lookback_window": int(lookback_window), **kwargs}

    @property
    def lookback_window(self) -> int:
        return self.kwargs["lookback_window"]

    @property
    def output_offset(self) -> int:
        """Rows the model's output is shorter than its input by."""
        return self.lookback_window - 1 + self.lookahead

    def build_spec(self, n_features: int, n_features_out: int) -> ModelSpec:
        for knob in _PARALLEL_KWARGS:
            if int(self.kwargs.get(knob) or 0) > 1:
                raise NotImplementedError(
                    f"{knob} is not ported yet: see the ring attention / parallel "
                    f"axes item of ROADMAP.md queue A"
                )
        kwargs = {k: v for k, v in self.kwargs.items() if k not in _NON_FACTORY_KWARGS}
        spec = FACTORIES[self.kind](
            n_features=n_features, n_features_out=n_features_out,
            lookahead=self.lookahead, **kwargs,
        )
        compute_dtype = self.kwargs.get("compute_dtype")
        if compute_dtype:
            spec = dataclasses.replace(spec, compute_dtype=str(compute_dtype))
        return spec

    def load_params(self, spec: ModelSpec, params, device=None):
        """Place ``params`` (JAX package layout) for ``spec`` on ``device``
        (``cuda`` unless ``"cpu"`` is named)."""
        self.spec_ = spec
        self.module_ = TransformerModel(spec, params, resolve_device(device))
        self._predict = predict_fn(self.module_)
        return self

    def fit(self, X, y, **kwargs):
        raise NotImplementedError(
            "training is not ported yet: see the training item of ROADMAP.md queue A"
        )

    def predict(self, X) -> np.ndarray:
        if not hasattr(self, "module_"):
            raise AttributeError(f"This {type(self).__name__} has no parameters yet")
        X = np.asarray(X, np.float32)
        if X.ndim == 1:
            X = X.reshape(-1, 1)
        return self._predict(X)


class TransformerAutoEncoder(WindowedSequenceEstimator):
    """Windowed Transformer-encoder reconstructor (lookahead 0)."""

    factory_type = "TransformerAutoEncoder"
    lookahead = 0


class TransformerForecast(WindowedSequenceEstimator):
    """Windowed Transformer one-step forecaster (lookahead 1)."""

    factory_type = "TransformerForecast"
    lookahead = 1


ESTIMATORS = {
    cls.__name__: cls for cls in (TransformerAutoEncoder, TransformerForecast)
}
