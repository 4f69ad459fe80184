"""
Carry a model across from the JAX package, numpy in.

``params_from_numpy`` takes the parameter layout that the JAX estimators
pickle (``BaseJaxEstimator.__getstate__``: a list with one
``{"kernel", "bias", "wq", ...}`` dict of numpy arrays per layer);
``spec_from_dataclass`` reads a spec dataclass with the JAX package's
field names; ``estimator_from_arrays`` builds a port estimator of any
family (a Transformer, an LSTM, a TCN, or the layers of an
``AutoEncoder`` or a ``RawModelRegressor``) on those parameters, and ``detector_from_arrays`` a
port detector from them and the scaler arrays and thresholds. Nothing here
imports the JAX package: unpickling a JAX artifact is the caller's job.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.anomaly.diff import DiffBasedAnomalyDetector
from ..models.models import ESTIMATORS, BaseEstimator, LSTMBaseEstimator
from ..models.scaler import MinMaxScaler, Pipeline
from ..models.spec import ModelSpec, spec_from_dict, spec_to_dict


def spec_from_dataclass(spec) -> ModelSpec:
    """A port spec from any spec dataclass with the same field names and
    layer class names (the JAX package's ModelSpec)."""
    return spec_from_dict(spec_to_dict(spec))


def params_from_numpy(spec: ModelSpec, layers: Sequence[Dict[str, np.ndarray]]
                      ) -> List[Dict[str, torch.Tensor]]:
    """Float32 CPU tensors in the same layout, checked against the spec's
    layer count."""
    if len(layers) != len(spec.layers):
        raise ValueError(f"{len(layers)} parameter dicts for {len(spec.layers)} layers")
    return [
        {name: torch.from_numpy(np.array(value, np.float32)) for name, value in p.items()}
        for p in layers
    ]


def estimator_from_arrays(spec: ModelSpec, layers: Sequence[Dict[str, np.ndarray]],
                          estimator: str = "TransformerAutoEncoder",
                          kind="transformer_model", estimator_kwargs: Optional[dict] = None,
                          device=None) -> BaseEstimator:
    """A port estimator of class ``estimator`` (by name) with these
    parameters for ``spec`` on ``device``; a windowed one takes the spec's
    lookback window unless ``estimator_kwargs`` names one."""
    cls = ESTIMATORS[estimator]
    kwargs = dict(estimator_kwargs or {})
    if issubclass(cls, LSTMBaseEstimator):
        kwargs.setdefault("lookback_window", spec.lookback_window)
    return cls(kind, **kwargs).load_params(spec, params_from_numpy(spec, layers), device)


def detector_from_arrays(
    spec: ModelSpec,
    layers: Sequence[Dict[str, np.ndarray]],
    input_min: np.ndarray,
    input_scale: np.ndarray,
    output_min: np.ndarray,
    output_scale: np.ndarray,
    estimator: str = "TransformerAutoEncoder",
    kind="transformer_model",
    estimator_kwargs: Optional[dict] = None,
    feature_thresholds: Optional[np.ndarray] = None,
    aggregate_threshold: Optional[float] = None,
    require_thresholds: bool = True,
    window: Optional[int] = None,
    smoothing_method: Optional[str] = None,
    device=None,
) -> DiffBasedAnomalyDetector:
    """A port ``DiffBasedAnomalyDetector`` over ``Pipeline[MinMaxScaler,
    estimator]`` computing what the JAX detector with these arrays
    computes. ``input_*`` are the pipeline scaler's ``min_``/``scale_``,
    ``output_*`` the detector scaler's."""
    model = estimator_from_arrays(spec, layers, estimator, kind, estimator_kwargs, device)
    return DiffBasedAnomalyDetector(
        base_estimator=Pipeline([
            ("scaler", MinMaxScaler(input_min, input_scale)),
            ("estimator", model),
        ]),
        scaler=MinMaxScaler(output_min, output_scale),
        require_thresholds=require_thresholds,
        window=window,
        smoothing_method=smoothing_method,
        feature_thresholds=feature_thresholds,
        aggregate_threshold=aggregate_threshold,
    )
