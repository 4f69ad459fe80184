"""
A min-max scaler and a minimal pipeline, in numpy.

``MinMaxScaler.transform`` is ``X * scale_ + min_``, the formula the JAX
package's serve path applies to a fitted sklearn MinMaxScaler
(``gordo_tpu/models/utils.py`` ``fast_transform``); ``fit`` computes
``scale_`` and ``min_`` as sklearn does for the range (0, 1).
``Pipeline.fit`` fits each transform step on X and transforms X through
it, then fits the last step on the transformed X and the raw y, as the
sklearn pipeline of the JAX package does; ``pipeline_predict`` walks a
pipeline's steps as that package's serve path does.
"""

from typing import List, Tuple

import numpy as np


class MinMaxScaler:
    def __init__(self, min_=None, scale_=None):
        self.min_ = None if min_ is None else np.asarray(min_, np.float64)
        self.scale_ = None if scale_ is None else np.asarray(scale_, np.float64)

    def get_params(self, deep=False) -> dict:
        return {}  # fitted state only: a clone is unfitted

    def __repr__(self) -> str:
        return "MinMaxScaler()"

    def fit(self, X) -> "MinMaxScaler":
        X = np.asarray(X, np.float64)
        data_min = np.nanmin(X, axis=0)
        data_range = np.nanmax(X, axis=0) - data_min
        # a constant column scales by 1, as sklearn's _handle_zeros_in_scale
        data_range[data_range < 10 * np.finfo(np.float64).eps] = 1.0
        self.scale_ = 1.0 / data_range
        self.min_ = -data_min * self.scale_
        return self

    def transform(self, X) -> np.ndarray:
        if self.scale_ is None:
            raise AttributeError("MinMaxScaler is not fitted")
        return np.asarray(X, np.float64) * self.scale_ + self.min_


class Pipeline:
    """Transform steps followed by one estimator: ``[(name, step), ...]``."""

    def __init__(self, steps: List[Tuple[str, object]]):
        self.steps = list(steps)

    def get_params(self, deep=False) -> dict:
        return {"steps": self.steps}

    def __repr__(self) -> str:
        return f"Pipeline(steps={self.steps!r})"

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
