"""
A min-max scaler and a minimal pipeline, in numpy.

``MinMaxScaler.transform`` is ``X * scale_ + min_``, the formula the JAX
package's serve path applies to a fitted sklearn MinMaxScaler
(``gordo_tpu/models/utils.py`` ``fast_transform``); ``fit`` computes
``scale_`` and ``min_`` as sklearn does.
``Pipeline.fit`` fits each transform step on X and transforms X through
it, then fits the last step on the transformed X and the raw y, as the
sklearn pipeline of the JAX package does; ``pipeline_predict`` walks a
pipeline's steps as that package's serve path does.
"""

from typing import List, Tuple

import numpy as np

from .pretty import EstimatorRepr


class MinMaxScaler(EstimatorRepr):
    """sklearn's ``MinMaxScaler``: ``transform`` maps each column's fitted
    range onto ``feature_range`` (clipped to it if ``clip``); ``copy`` is
    accepted for sklearn's signature (the port never scales in place).
    ``feature_range`` is kept as it was given, as sklearn keeps it, so the
    repr shows it as sklearn's does."""

    def __init__(self, min_=None, scale_=None, *, feature_range=(0, 1), copy=True,
                 clip=False):
        self.min_ = None if min_ is None else np.asarray(min_, np.float64)
        self.scale_ = None if scale_ is None else np.asarray(scale_, np.float64)
        self.feature_range = feature_range
        self.copy = copy
        self.clip = clip

    def get_params(self, deep=False) -> dict:
        # constructor settings only: a clone is unfitted
        return {"clip": self.clip, "copy": self.copy, "feature_range": self.feature_range}

    def fit(self, X) -> "MinMaxScaler":
        X = np.asarray(X, np.float64)
        data_min = np.nanmin(X, axis=0)
        data_range = np.nanmax(X, axis=0) - data_min
        # a constant column scales by 1, as sklearn's _handle_zeros_in_scale
        data_range[data_range < 10 * np.finfo(np.float64).eps] = 1.0
        low, high = self.feature_range
        self.scale_ = (high - low) / data_range
        self.min_ = low - data_min * self.scale_
        return self

    def transform(self, X) -> np.ndarray:
        if self.scale_ is None:
            raise AttributeError("MinMaxScaler is not fitted")
        out = np.asarray(X, np.float64) * self.scale_ + self.min_
        return np.clip(out, *self.feature_range) if self.clip else out


class Pipeline(EstimatorRepr):
    """Transform steps followed by one estimator: ``[(name, step), ...]``.
    ``memory``, ``verbose`` and ``transform_input`` are sklearn's
    constructor settings, kept for its definitions; the port caches nothing."""

    def __init__(self, steps: List[Tuple[str, object]], memory=None, verbose=False,
                 transform_input=None):
        self.steps = list(steps)
        self.memory = memory
        self.verbose = verbose
        self.transform_input = transform_input

    def get_params(self, deep=False) -> dict:
        return {"memory": self.memory, "steps": self.steps,
                "transform_input": self.transform_input, "verbose": self.verbose}

    def fit(self, X, y) -> "Pipeline":
        self.steps[-1][1].fit(_through_transforms(self.steps, X, fit=True), y)
        return self

    def predict(self, X) -> np.ndarray:
        return pipeline_predict(self, X)

    def score(self, X, y) -> float:
        return self.steps[-1][1].score(_through_transforms(self.steps, X), y)


def _through_transforms(steps, X, fit: bool = False):
    """X through every step but the last, fitting each first if ``fit``."""
    for _, transformer in steps[:-1]:
        if transformer is None or isinstance(transformer, str):
            continue  # 'passthrough' placeholders
        if fit:
            transformer.fit(X)
        X = transformer.transform(X)
    return X


def pipeline_predict(model, values: np.ndarray) -> np.ndarray:
    """Walk a pipeline's steps (transform chain + final predict); any other
    model predicts as-is."""
    steps = getattr(model, "steps", None)
    if not isinstance(steps, list) or not steps:
        return model.predict(values)
    return steps[-1][1].predict(_through_transforms(steps, values))
