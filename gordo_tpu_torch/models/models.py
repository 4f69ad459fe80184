"""
The port's estimators: the counterparts of ``AutoEncoder``,
``RawModelRegressor``, ``LSTMAutoEncoder``, ``LSTMForecast``,
``TransformerAutoEncoder``, ``TransformerForecast``, ``TCNAutoEncoder`` and
``TCNForecast`` in ``gordo_tpu/models/models.py``, on the
``BaseJaxEstimator`` contract (``fit``, ``predict``, ``score``,
``get_params``, definitions, metadata).

An estimator holds its spec and a :class:`~gordo_tpu_torch.ops.nn.TransformerModel`
(any spec of Dense, LSTM, positional-encoding, Transformer-block, TCN and
pool layers)
whose parameters stay on the device; ``fit`` trains it there
(ops/train.py), ``predict`` takes and returns numpy: through the
cross-model batcher when it is on (server/batcher.py), which fuses
concurrent predicts of one spec into one device call, else direct. The
device is ``cuda`` unless the estimator is made with ``device="cpu"``.
``AutoEncoder`` and ``RawModelRegressor`` are unwindowed (output offset 0,
one output row per input row) unless a raw config names a lookback; the
LSTM, Transformer and TCN estimators are windowed (many-to-one over
``lookback_window`` rows).
"""

import dataclasses
from pprint import pformat
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..ops.nn import TransformerModel, init_model_params
from ..ops.predict import predict_fn
from ..ops.train import fit_arrays
from ..server.batcher import maybe_submit
from .base import explained_variance_score
from .factories import FACTORIES
from .pretty import EstimatorRepr
from .spec import DenseLayer, LSTMLayer, ModelSpec, OptimizerSpec

_PARALLEL_KWARGS = (
    "tensor_parallel", "pipeline_parallel", "expert_parallel", "data_parallel"
)
# estimator kwargs that are fit arguments or spec-level knobs, never factory kwargs
_FIT_KWARGS = ("batch_size", "epochs", "verbose", "callbacks", "validation_split", "shuffle")
_NON_FACTORY_KWARGS = (*_FIT_KWARGS, "compute_dtype", "remat", *_PARALLEL_KWARGS)


class BaseEstimator(EstimatorRepr):
    """The fit/predict machinery shared by every estimator of the port, over
    the factories filed under its ``factory_type``. Its repr is the JAX
    estimator's: the device is where it runs, not one of its parameters."""

    factory_type = ""
    lookahead = 0

    def __init__(self, kind, device=None, **kwargs):
        self.kind = self._check_kind(kind)
        self.device = device
        self.kwargs: Dict[str, Any] = kwargs
        self.history: Optional[Dict[str, Any]] = None

    def _check_kind(self, kind):
        if kind not in FACTORIES[self.factory_type]:
            raise ValueError(
                f"kind: {kind} is not an available model for type: {self.factory_type}!"
            )
        return kind

    def get_params(self, deep=False) -> Dict[str, Any]:
        return {"kind": self.kind, "device": self.device, **self.kwargs}

    def repr_params(self) -> Dict[str, Any]:
        return {"kind": self.kind, **self.kwargs}

    def repr_defaults(self) -> Dict[str, Any]:
        # the JAX estimator's __init__(kind, **kwargs): no defaults
        return {}

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
        return 1

    @property
    def output_offset(self) -> int:
        """Rows the model's output is shorter than its input by."""
        return max(self.lookback_window - 1 + self.lookahead, 0)

    def _factory_kwargs(self) -> Dict[str, Any]:
        return {k: v for k, v in self.kwargs.items() if k not in _NON_FACTORY_KWARGS}

    def _build_spec(self, n_features: int, n_features_out: int) -> ModelSpec:
        return FACTORIES[self.factory_type][self.kind](
            n_features=n_features, n_features_out=n_features_out, **self._factory_kwargs())

    def build_spec(self, n_features: int, n_features_out: int) -> ModelSpec:
        for knob in _PARALLEL_KWARGS:
            if int(self.kwargs.get(knob) or 0) > 1:
                raise NotImplementedError(
                    f"{knob} is not ported yet: see the ring attention / parallel "
                    f"axes item of ROADMAP.md queue A"
                )
        spec = self._build_spec(n_features, n_features_out)
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
        X = _as_2d(X)
        batched = maybe_submit(self.spec_, self.module_, X)
        if batched is not None:
            return batched
        return self._predict(X)

    def score(self, X, y) -> float:
        """Explained variance of the output against the last rows of y
        (all of them for an unwindowed model)."""
        out = self.predict(X)
        return explained_variance_score(_as_2d(y)[-len(out):], out)

    def get_metadata(self) -> Dict[str, Any]:
        """The training history, as the JAX estimator reports it."""
        return {"history": dict(self.history)} if self.history is not None else {}


def _as_2d(data) -> np.ndarray:
    arr = np.asarray(data, np.float32)
    return arr.reshape(-1, 1) if arr.ndim == 1 else arr


class AutoEncoder(BaseEstimator):
    """Dense autoencoder over a feedforward factory ``kind``; its output has
    as many rows as its input."""

    factory_type = "AutoEncoder"


class RawModelRegressor(AutoEncoder):
    """An arbitrary stack of Dense and LSTM layers from a raw config dict
    ``kind`` (``{"spec": {"layers": [{"Dense": {...}}, {"LSTM": {...}},
    ...]}, "compile": {...}}``, with an optional ``lookback_window``), as
    the JAX ``RawModelRegressor`` reads it. LSTM layers need a
    ``lookback_window`` of 2 or more: unwindowed, the model is refused when
    it is made (ops/nn.py ``check_windowed``)."""

    _expected_keys = ("spec", "compile")

    def _check_kind(self, kind):
        if not isinstance(kind, dict):
            raise ValueError("RawModelRegressor kind must be a config dict")
        return kind

    def __repr__(self):
        return f"{type(self).__name__}(kind: {pformat(self.kind)})"

    @staticmethod
    def _parse_layer(layer_def) -> Union[DenseLayer, LSTMLayer]:
        if not isinstance(layer_def, dict) or len(layer_def) != 1:
            raise ValueError(f"Invalid layer definition: {layer_def!r}")
        name = next(iter(layer_def))
        kwargs = dict(layer_def[name] or {})
        short = name.rsplit(".", 1)[-1]
        if short == "Dense":
            return DenseLayer(units=int(kwargs["units"]),
                              activation=kwargs.get("activation", "linear"))
        if short == "LSTM":
            return LSTMLayer(units=int(kwargs["units"]),
                             activation=kwargs.get("activation", "tanh"),
                             return_sequences=bool(kwargs.get("return_sequences", False)))
        raise ValueError(f"Unsupported raw layer type: {name!r}")

    def _build_spec(self, n_features: int, n_features_out: int) -> ModelSpec:
        if not all(k in self.kind for k in self._expected_keys):
            raise ValueError(
                f"Expected spec to have keys: {self._expected_keys}, "
                f"but found {list(self.kind)}"
            )
        spec_def = self.kind["spec"]
        if isinstance(spec_def, dict) and "layers" not in spec_def:
            # the reference's {Sequential: {layers: [...]}} nesting
            inner = next(iter(spec_def.values()))
            spec_def = inner if isinstance(inner, dict) else {"layers": inner}
        layers = tuple(self._parse_layer(layer) for layer in spec_def["layers"])
        compile_kwargs = dict(self.kind.get("compile") or {})
        return ModelSpec(
            layers=layers,
            n_features=n_features,
            n_features_out=layers[-1].units,
            lookback_window=int(self.kind.get("lookback_window", 1)),
            optimizer=OptimizerSpec.create(str(compile_kwargs.get("optimizer", "Adam")),
                                           compile_kwargs.get("optimizer_kwargs")),
            loss=compile_kwargs.get("loss", "mse"),
        )


class LSTMBaseEstimator(BaseEstimator):
    """Many-to-one windowed estimator over a registered factory ``kind``:
    its output is ``len(X) - lookback_window + 1 - lookahead`` rows. The
    JAX package's defaults: ``lookback_window`` 1 and ``batch_size`` 1. At
    lookback 1 and no lookahead (an ``LSTMAutoEncoder`` left at its
    defaults) the spec is unwindowed, and its LSTM layers are refused with
    a ValueError naming ``lookback_window`` when the model is made (the JAX
    package fails there too, inside its scan)."""

    def __init__(self, kind, lookback_window: int = 1, device=None, batch_size: int = 1,
                 **kwargs):
        super().__init__(kind, device, lookback_window=int(lookback_window),
                         batch_size=int(batch_size), **kwargs)

    def repr_defaults(self) -> Dict[str, Any]:
        # the JAX estimator's __init__(kind, lookback_window=1, batch_size=1,
        # **kwargs): its kind has no default
        return {"lookback_window": 1, "batch_size": 1}

    @property
    def lookback_window(self) -> int:
        return self.kwargs["lookback_window"]

    def _factory_kwargs(self) -> Dict[str, Any]:
        return {**super()._factory_kwargs(), "lookahead": self.lookahead}

    def get_metadata(self) -> Dict[str, Any]:
        """The training history, and the forecast steps (the lookahead), as
        the JAX estimator reports them."""
        return {**super().get_metadata(), "forecast_steps": self.lookahead}


class LSTMAutoEncoder(LSTMBaseEstimator):
    """Windowed stacked-LSTM reconstructor (lookahead 0)."""

    factory_type = "LSTMAutoEncoder"
    lookahead = 0


class LSTMForecast(LSTMBaseEstimator):
    """Windowed stacked-LSTM one-step forecaster (lookahead 1)."""

    factory_type = "LSTMForecast"
    lookahead = 1


class WindowedSequenceEstimator(LSTMBaseEstimator):
    """The base of the sequence models whose layers need a real time axis
    (Transformer, TCN): the default window is 144 rows and the batch 32,
    and windows below 2 are refused when the estimator is made."""

    def __init__(self, kind: str = "transformer_model", lookback_window: int = 144,
                 device=None, batch_size: int = 32, **kwargs):
        if lookback_window < 2:
            raise ValueError(
                f"{type(self).__name__} requires lookback_window >= 2, "
                f"got {lookback_window}"
            )
        super().__init__(kind, lookback_window, device, batch_size, **kwargs)

    def repr_defaults(self) -> Dict[str, Any]:
        # the JAX estimator's __init__(kind, lookback_window=144,
        # batch_size=32, **kwargs): its kind has no default
        return {"lookback_window": 144, "batch_size": 32}


class TransformerAutoEncoder(WindowedSequenceEstimator):
    """Windowed Transformer-encoder reconstructor (lookahead 0)."""

    factory_type = "TransformerAutoEncoder"
    lookahead = 0


class TransformerForecast(WindowedSequenceEstimator):
    """Windowed Transformer one-step forecaster (lookahead 1)."""

    factory_type = "TransformerForecast"
    lookahead = 1


class TCNAutoEncoder(WindowedSequenceEstimator):
    """Windowed temporal-convolutional reconstructor (lookahead 0)."""

    factory_type = "TCNAutoEncoder"
    lookahead = 0


class TCNForecast(WindowedSequenceEstimator):
    """Windowed temporal-convolutional one-step forecaster (lookahead 1)."""

    factory_type = "TCNForecast"
    lookahead = 1


ESTIMATORS = {
    cls.__name__: cls
    for cls in (AutoEncoder, RawModelRegressor, LSTMAutoEncoder, LSTMForecast,
                TransformerAutoEncoder, TransformerForecast, TCNAutoEncoder, TCNForecast)
}
