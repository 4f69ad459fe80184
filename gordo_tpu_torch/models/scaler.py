"""
The scikit-learn preprocessing steps that the JAX package's definitions
name, in numpy, and a minimal pipeline and feature union.

``MinMaxScaler.transform`` is ``X * scale_ + min_``, the formula the JAX
package's serve path applies to a fitted sklearn MinMaxScaler
(``gordo_tpu/models/utils.py`` ``fast_transform``); ``fit`` computes
``scale_`` and ``min_`` as sklearn does. ``StandardScaler``,
``RobustScaler``, ``FunctionTransformer`` and ``PCA`` fit and transform as
sklearn's do (``PCA`` by a numpy SVD with sklearn's sign rule, so that its
components agree in sign).
``Pipeline.fit`` fits each transform step on X and transforms X through
it, then fits the last step on the transformed X and the raw y, as the
sklearn pipeline of the JAX package does; ``pipeline_predict`` walks a
pipeline's steps as that package's serve path does. ``FeatureUnion``
concatenates its transformers' outputs.

Each transformer names its fitted attributes in ``fitted_attributes``, the
state the artifact stores (serializer/serializer.py).
"""

from typing import Callable, List, Optional, Tuple

import numpy as np
from scipy.special import ndtri

from .pretty import EstimatorRepr

_TINY = 10 * np.finfo(np.float64).eps


def _handle_zeros_in_scale(scale: np.ndarray) -> np.ndarray:
    """A scale below 10 eps taken as 1, as sklearn's ``_handle_zeros_in_scale``."""
    scale = np.array(scale, np.float64)
    scale[scale < _TINY] = 1.0
    return scale


class MinMaxScaler(EstimatorRepr):
    fitted_attributes = ("min_", "scale_")

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
        # a constant column scales by 1
        data_range = _handle_zeros_in_scale(np.nanmax(X, axis=0) - data_min)
        low, high = self.feature_range
        self.scale_ = (high - low) / data_range
        self.min_ = low - data_min * self.scale_
        return self

    def transform(self, X) -> np.ndarray:
        if self.scale_ is None:
            raise AttributeError("MinMaxScaler is not fitted")
        out = np.asarray(X, np.float64) * self.scale_ + self.min_
        return np.clip(out, *self.feature_range) if self.clip else out


class StandardScaler(EstimatorRepr):
    """sklearn's ``StandardScaler``: ``(X - mean_) / scale_``, the scale the
    population standard deviation (a constant column's taken as 1)."""

    fitted_attributes = ("mean_", "var_", "scale_")

    def __init__(self, *, copy=True, with_mean=True, with_std=True):
        self.copy = copy
        self.with_mean = with_mean
        self.with_std = with_std
        self.mean_ = self.var_ = self.scale_ = None

    def get_params(self, deep=False) -> dict:
        return {"copy": self.copy, "with_mean": self.with_mean, "with_std": self.with_std}

    def fit(self, X, y=None) -> "StandardScaler":
        X = np.asarray(X, np.float64)
        self.mean_ = np.nanmean(X, axis=0) if self.with_mean else None
        if self.with_std:
            self.var_ = np.nanvar(X, axis=0)
            self.scale_ = _handle_zeros_in_scale(np.sqrt(self.var_))
        else:
            self.var_ = self.scale_ = None
        return self

    def transform(self, X) -> np.ndarray:
        out = np.array(X, np.float64)
        if self.mean_ is not None:
            out -= self.mean_
        if self.scale_ is not None:
            out /= self.scale_
        return out


class RobustScaler(EstimatorRepr):
    """sklearn's ``RobustScaler``: ``(X - center_) / scale_``, the median
    and the ``quantile_range`` interquartile span (linear interpolation, NaN
    skipped; a span below 10 eps taken as 1), divided by the normal
    distribution's span over that range when ``unit_variance``."""

    fitted_attributes = ("center_", "scale_")

    def __init__(self, *, with_centering=True, with_scaling=True,
                 quantile_range=(25.0, 75.0), copy=True, unit_variance=False):
        self.with_centering = with_centering
        self.with_scaling = with_scaling
        self.quantile_range = quantile_range
        self.copy = copy
        self.unit_variance = unit_variance
        self.center_ = self.scale_ = None

    def get_params(self, deep=False) -> dict:
        return {"copy": self.copy, "quantile_range": self.quantile_range,
                "unit_variance": self.unit_variance, "with_centering": self.with_centering,
                "with_scaling": self.with_scaling}

    def fit(self, X, y=None) -> "RobustScaler":
        X = np.asarray(X, np.float64)
        q_min, q_max = self.quantile_range
        if not 0 <= q_min <= q_max <= 100:
            raise ValueError(f"Invalid quantile range: {self.quantile_range}")
        self.center_ = np.nanmedian(X, axis=0) if self.with_centering else None
        self.scale_ = None
        if self.with_scaling:
            low, high = np.nanpercentile(X, [q_min, q_max], axis=0)
            self.scale_ = _handle_zeros_in_scale(high - low)
            if self.unit_variance:
                self.scale_ = self.scale_ / (ndtri(q_max / 100.0) - ndtri(q_min / 100.0))
        return self

    def transform(self, X) -> np.ndarray:
        out = np.array(X, np.float64)
        if self.center_ is not None:
            out -= self.center_
        if self.scale_ is not None:
            out /= self.scale_
        return out


class FunctionTransformer(EstimatorRepr):
    """sklearn's ``FunctionTransformer``: ``func(X, **kw_args)``, the
    identity without a ``func``; it fits nothing."""

    fitted_attributes = ()

    def __init__(self, func: Optional[Callable] = None, inverse_func=None, *, validate=False,
                 accept_sparse=False, check_inverse=True, feature_names_out=None,
                 kw_args=None, inv_kw_args=None):
        self.func = func
        self.inverse_func = inverse_func
        self.validate = validate
        self.accept_sparse = accept_sparse
        self.check_inverse = check_inverse
        self.feature_names_out = feature_names_out
        self.kw_args = kw_args
        self.inv_kw_args = inv_kw_args

    def get_params(self, deep=False) -> dict:
        return {"accept_sparse": self.accept_sparse, "check_inverse": self.check_inverse,
                "feature_names_out": self.feature_names_out, "func": self.func,
                "inv_kw_args": self.inv_kw_args, "inverse_func": self.inverse_func,
                "kw_args": self.kw_args, "validate": self.validate}

    def fit(self, X, y=None) -> "FunctionTransformer":
        return self

    def transform(self, X) -> np.ndarray:
        X = np.asarray(X, np.float64) if self.validate else X
        return X if self.func is None else self.func(X, **(self.kw_args or {}))


class PCA(EstimatorRepr):
    """sklearn's ``PCA`` by a full SVD of the centred data: the components
    are the leading right singular vectors, each signed so that its largest
    entry in magnitude is positive (sklearn's ``svd_flip`` on ``Vt``), the
    explained variance ``S**2 / (n - 1)``. ``n_components``: an int, None
    (all), or a float in (0, 1), the smallest count whose cumulative ratio
    of explained variance exceeds it. ``transform`` projects the centred
    data (divided by the root of the explained variance when ``whiten``)."""

    fitted_attributes = ("mean_", "components_", "explained_variance_",
                         "explained_variance_ratio_", "singular_values_")

    def __init__(self, n_components=None, *, copy=True, whiten=False, svd_solver="auto",
                 tol=0.0, iterated_power="auto", n_oversamples=10,
                 power_iteration_normalizer="auto", random_state=None):
        self.n_components = n_components
        self.copy = copy
        self.whiten = whiten
        self.svd_solver = svd_solver
        self.tol = tol
        self.iterated_power = iterated_power
        self.n_oversamples = n_oversamples
        self.power_iteration_normalizer = power_iteration_normalizer
        self.random_state = random_state
        self.mean_ = self.components_ = self.explained_variance_ = None
        self.explained_variance_ratio_ = self.singular_values_ = None

    def get_params(self, deep=False) -> dict:
        return {"copy": self.copy, "iterated_power": self.iterated_power,
                "n_components": self.n_components, "n_oversamples": self.n_oversamples,
                "power_iteration_normalizer": self.power_iteration_normalizer,
                "random_state": self.random_state, "svd_solver": self.svd_solver,
                "tol": self.tol, "whiten": self.whiten}

    def fit(self, X, y=None) -> "PCA":
        X = np.asarray(X, np.float64)
        n_samples, n_features = X.shape
        self.mean_ = X.mean(axis=0)
        _, S, Vt = np.linalg.svd(X - self.mean_, full_matrices=False)
        signs = np.sign(Vt[np.arange(len(Vt)), np.argmax(np.abs(Vt), axis=1)])
        Vt *= signs[:, None]
        variance = S ** 2 / (n_samples - 1)
        ratio = variance / variance.sum()
        n = self.n_components
        if n is None:
            n = min(n_samples, n_features)
        elif isinstance(n, float) and 0 < n < 1:
            n = int(np.searchsorted(np.cumsum(ratio), n, side="right")) + 1
        elif not isinstance(n, (int, np.integer)) or isinstance(n, bool):
            raise NotImplementedError(f"PCA(n_components={n!r}) is not ported")
        self.components_ = Vt[:n]
        self.explained_variance_ = variance[:n]
        self.explained_variance_ratio_ = ratio[:n]
        self.singular_values_ = S[:n]
        return self

    def transform(self, X) -> np.ndarray:
        out = (np.asarray(X, np.float64) - self.mean_) @ self.components_.T
        if self.whiten:
            out /= np.sqrt(self.explained_variance_)
        return out


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


class FeatureUnion(EstimatorRepr):
    """sklearn's ``FeatureUnion``: each transformer of ``transformer_list``
    (``[(name, transformer), ...]``; ``"drop"`` skips one, ``"passthrough"``
    passes X) fitted on X, their outputs side by side, each times its
    ``transformer_weights`` entry where it has one."""

    fitted_attributes = ()  # its transformers hold the state

    def __init__(self, transformer_list: List[Tuple[str, object]], *, n_jobs=None,
                 transformer_weights=None, verbose=False, verbose_feature_names_out=True):
        self.transformer_list = list(transformer_list)
        self.n_jobs = n_jobs
        self.transformer_weights = transformer_weights
        self.verbose = verbose
        self.verbose_feature_names_out = verbose_feature_names_out

    def get_params(self, deep=False) -> dict:
        return {"n_jobs": self.n_jobs, "transformer_list": self.transformer_list,
                "transformer_weights": self.transformer_weights, "verbose": self.verbose,
                "verbose_feature_names_out": self.verbose_feature_names_out}

    def fit(self, X, y=None) -> "FeatureUnion":
        for _, transformer in self.transformer_list:
            if not isinstance(transformer, str):
                transformer.fit(X)
        return self

    def transform(self, X) -> np.ndarray:
        weights = self.transformer_weights or {}
        parts = []
        for name, transformer in self.transformer_list:
            if transformer == "drop":
                continue
            out = np.asarray(X if transformer == "passthrough" else transformer.transform(X),
                             np.float64)
            parts.append(out * weights[name] if name in weights else out)
        return np.hstack(parts)


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
