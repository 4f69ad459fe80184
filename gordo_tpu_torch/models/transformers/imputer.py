"""
``InfImputer``, the port's copy of ``gordo_tpu/models/transformers/imputer.py``:
fill +-inf values per feature, either by each feature's observed maximum
(minimum) nudged up (down) by ``delta``, or by the dtype's extremes when
``strategy='extremes'``; explicit fill values apply first.
"""

from typing import Optional

import numpy as np

from ..pretty import EstimatorRepr


class InfImputer(EstimatorRepr):
    fitted_attributes = ("_posinf_fill_values", "_neginf_fill_values")

    def __init__(self, inf_fill_value: Optional[float] = None,
                 neg_inf_fill_value: Optional[float] = None, strategy: str = "minmax",
                 delta: float = 2.0):
        self.inf_fill_value = inf_fill_value
        self.neg_inf_fill_value = neg_inf_fill_value
        self.strategy = strategy
        self.delta = delta

    def get_params(self, deep=False) -> dict:
        return {"inf_fill_value": self.inf_fill_value,
                "neg_inf_fill_value": self.neg_inf_fill_value,
                "strategy": self.strategy, "delta": self.delta}

    def fit(self, X, y=None) -> "InfImputer":
        X = np.asarray(X)
        if self.strategy == "minmax":
            masked = np.ma.masked_invalid(X)
            self._posinf_fill_values = masked.max(axis=0).filled(0.0) + self.delta
            self._neginf_fill_values = masked.min(axis=0).filled(0.0) - self.delta
        elif self.strategy == "extremes":
            info = np.finfo(X.dtype if X.dtype.kind == "f" else np.float64)
            self._posinf_fill_values = np.repeat(info.max, X.shape[1])
            self._neginf_fill_values = np.repeat(info.min, X.shape[1])
        else:
            raise ValueError(f"Unknown strategy: {self.strategy!r}")
        return self

    def transform(self, X, y=None) -> np.ndarray:
        X = np.asarray(X)
        X = X.copy().astype(np.float64 if X.dtype.kind != "f" else X.dtype)
        if self.inf_fill_value is not None:
            X[np.isposinf(X)] = self.inf_fill_value
        if self.neg_inf_fill_value is not None:
            X[np.isneginf(X)] = self.neg_inf_fill_value
        if hasattr(self, "_posinf_fill_values"):
            for i in range(X.shape[1]):
                col = X[:, i]
                col[np.isposinf(col)] = self._posinf_fill_values[i]
                col[np.isneginf(col)] = self._neginf_fill_values[i]
        return X
