"""
Windowed Transformer estimators: the port's counterparts of
``TransformerAutoEncoder`` and ``TransformerForecast`` in
``gordo_tpu/models/models.py``.

An estimator holds its spec and a :class:`~gordo_tpu_torch.ops.nn.TransformerModel`
whose parameters stay on the device; ``fit`` trains it there
(ops/train.py), ``predict`` takes and returns numpy. The device is
``cuda`` unless the estimator is made with ``device="cpu"``.
"""

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops.nn import TransformerModel, init_model_params
from ..ops.predict import predict_fn
from ..ops.train import fit_arrays
from .base import explained_variance_score
from .factories import FACTORIES
from .pretty import EstimatorRepr
from .spec import ModelSpec

_PARALLEL_KWARGS = (
    "tensor_parallel", "pipeline_parallel", "expert_parallel", "data_parallel"
)
# estimator kwargs that are fit arguments or spec-level knobs, never factory kwargs
_FIT_KWARGS = ("batch_size", "epochs", "verbose", "callbacks", "validation_split", "shuffle")
_NON_FACTORY_KWARGS = (*_FIT_KWARGS, "compute_dtype", "remat", *_PARALLEL_KWARGS)


class WindowedSequenceEstimator(EstimatorRepr):
    """Many-to-one windowed estimator over a registered factory ``kind``.
    Its repr is the JAX estimator's: the device is where it runs, not one
    of its parameters."""

    factory_type = ""
    lookahead = 0

    def __init__(self, kind: str = "transformer_model", lookback_window: int = 144,
                 device=None, batch_size: int = 32, **kwargs):
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
        self.device = device
        self.kwargs: Dict[str, Any] = {
            "lookback_window": int(lookback_window), "batch_size": int(batch_size), **kwargs
        }
        self.history: Optional[Dict[str, Any]] = None

    def get_params(self, deep=False) -> Dict[str, Any]:
        return {"kind": self.kind, "device": self.device, **self.kwargs}

    def repr_params(self) -> Dict[str, Any]:
        return {"kind": self.kind, **self.kwargs}

    def repr_defaults(self) -> Dict[str, Any]:
        # the JAX estimator's __init__(kind, lookback_window=144,
        # batch_size=32, **kwargs): its kind has no default
        return {"lookback_window": 144, "batch_size": 32}

    @classmethod
    def from_definition(cls, definition: dict, device=None):
        """The estimator of a definition's arguments, on ``device``.
        Callbacks stay definitions until ``fit`` builds them."""
        definition = dict(definition)
        return cls(definition.pop("kind"), device=device, **definition)

    def into_definition(self) -> dict:
        """The definition's arguments: the kind and every keyword argument
        (the device is where the estimator runs, not what it is)."""
        return {**self.kwargs, "kind": self.kind}

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
        self.device = device
        self.spec_ = spec
        self.module_ = TransformerModel(spec, params, resolve_device(device))
        self._predict = predict_fn(self.module_)
        return self

    def fit(self, X, y, **kwargs):
        """Train from fresh parameters on (X, y): the seed is drawn from the
        global numpy RNG, as the JAX estimator draws it, and seeds both the
        initialisation and the per-epoch shuffles."""
        X, y = _as_2d(X), _as_2d(y)
        spec = self.build_spec(X.shape[1], y.shape[1])
        fit_args = {k: v for k, v in self.kwargs.items() if k in _FIT_KWARGS}
        fit_args.update({k: v for k, v in kwargs.items() if k in _FIT_KWARGS})
        callbacks = fit_args.get("callbacks") or []
        if any(isinstance(cb, (dict, str)) for cb in callbacks):
            from ..serializer.from_definition import build_callbacks

            callbacks = build_callbacks(callbacks)
        batch_size = int(fit_args.get("batch_size", 32))
        seed = int(np.random.randint(0, 2**31 - 1))
        generator = torch.Generator().manual_seed(seed)
        self.load_params(spec, init_model_params(spec, generator), self.device)
        result = fit_arrays(
            self.module_, X, y,
            epochs=int(fit_args.get("epochs", 1)),
            batch_size=batch_size,
            shuffle=bool(fit_args.get("shuffle", True)),
            validation_split=float(fit_args.get("validation_split", 0.0) or 0.0),
            generator=generator,
            callbacks=callbacks,
        )
        self.history = dict(result.history)
        self.history["params"] = {
            "epochs": result.epochs_trained,
            "batch_size": batch_size,
            "metrics": list(result.history.keys()),
        }
        return self

    def predict(self, X) -> np.ndarray:
        if not hasattr(self, "module_"):
            raise AttributeError(f"This {type(self).__name__} has no parameters yet")
        return self._predict(_as_2d(X))

    def score(self, X, y) -> float:
        """Explained variance of the output against the last rows of y."""
        out = self.predict(X)
        return explained_variance_score(_as_2d(y)[-len(out):], out)

    def get_metadata(self) -> Dict[str, Any]:
        """The training history, and the forecast steps (the lookahead), as
        the JAX estimator reports them."""
        metadata = {"history": dict(self.history)} if self.history is not None else {}
        metadata["forecast_steps"] = self.lookahead
        return metadata


def _as_2d(data) -> np.ndarray:
    arr = np.asarray(data, np.float32)
    return arr.reshape(-1, 1) if arr.ndim == 1 else arr


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
