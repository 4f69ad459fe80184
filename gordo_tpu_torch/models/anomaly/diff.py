"""
Diff-based anomaly detection in numpy: the port's counterpart of
``DiffBasedAnomalyDetector`` in ``gordo_tpu/models/anomaly/diff.py``.

The detector wraps a base estimator (a pipeline ending in a windowed
Transformer) and scores anomalies as the scaled and unscaled difference
between the model output and the target, with optional smoothing and,
when thresholds are present, confidence columns. ``fit`` trains the base
estimator and fits the scaler on y; ``cross_validate`` trains a fresh copy
per ``TimeSeriesSplit`` fold, scores it (with the builder's per-tag
scorers when it is given them) and sets the thresholds from the folds'
rolling error statistics, the last fold's being the final ones.
"""

import time
from datetime import timedelta
from typing import Dict, Optional

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from .. import utils as model_utils
from ..base import clone
from ..pretty import EstimatorRepr
from ..scaler import MinMaxScaler, pipeline_predict


class TimeSeriesSplit:
    """``sklearn.model_selection.TimeSeriesSplit`` (no gap, no maximum
    train size): fold i trains on every row before its test span, and the
    ``n_splits`` test spans of ``n // (n_splits + 1)`` rows end the data."""

    def __init__(self, n_splits: int = 3):
        self.n_splits = n_splits

    def split(self, X, y=None):
        n = len(X)
        test_size = n // (self.n_splits + 1)
        if self.n_splits + 1 > n or test_size < 1:
            raise ValueError(
                f"Cannot have number of folds={self.n_splits + 1} greater than "
                f"the number of samples={n}."
            )
        indices = np.arange(n)
        for start in range(n - self.n_splits * test_size, n, test_size):
            yield indices[:start], indices[start:start + test_size]


def shuffled_order(n: int) -> np.ndarray:
    """The row order of ``sklearn.utils.shuffle(..., random_state=0)``."""
    order = np.arange(n)
    np.random.RandomState(0).shuffle(order)
    return order


def cross_validate(estimator, X, y, cv=None, scoring=None) -> dict:
    """sklearn's ``cross_validate(..., return_estimator=True)``: an unfitted
    copy of ``estimator`` trained on each fold of ``cv``
    (``TimeSeriesSplit(3)`` by default) and scored on the fold's test span.
    Returns ``estimator``, ``fit_time``, ``score_time`` and ``test_score``
    (the estimator's own ``score``), one entry per fold, and for each
    ``name: metric`` of ``scoring``, ``test_{name}``: ``metric(y_test,
    prediction)`` over one prediction per fold."""
    X, y = np.asarray(X, np.float64), np.asarray(y, np.float64)
    splitter = cv if cv is not None else TimeSeriesSplit(n_splits=3)
    scoring = scoring or {}
    out = {"estimator": [], "fit_time": [], "score_time": [], "test_score": [],
           **{f"test_{name}": [] for name in scoring}}
    for train_idx, test_idx in splitter.split(X, y):
        model = clone(estimator)
        started = time.perf_counter()
        model.fit(X[train_idx], y[train_idx])
        fitted = time.perf_counter()
        out["test_score"].append(model.score(X[test_idx], y[test_idx]))
        if scoring:
            pred = model.predict(X[test_idx])
            for name, metric in scoring.items():
                out[f"test_{name}"].append(metric(y[test_idx], pred))
        out["score_time"].append(time.perf_counter() - fitted)
        out["fit_time"].append(fitted - started)
        out["estimator"].append(model)
    return {key: value if key == "estimator" else np.asarray(value)
            for key, value in out.items()}


def _rolling_floor_peak(values: np.ndarray, window: int):
    """Max over the span of the rolling minimum, as pandas'
    ``rolling(window).min().max()``: a spike-tolerant ceiling for 'normal'
    error. A scalar for a 1-D metric, one value per column for a 2-D one;
    NaN where the span is shorter than the window."""
    if len(values) < window:
        return np.full(values.shape[1:], np.nan) if values.ndim > 1 else float("nan")
    peak = np.nanmax(_rolling(values, window, np.min), axis=0)
    return float(peak) if values.ndim == 1 else peak


def _rolling(values: np.ndarray, window: int, reduce) -> np.ndarray:
    """pandas ``rolling(window).<reduce>()`` along axis 0: NaN for the
    first ``window - 1`` rows."""
    out = np.full(values.shape, np.nan)
    if len(values) >= window:
        out[window - 1:] = reduce(sliding_window_view(values, window, axis=0), axis=-1)
    return out


def _ewm_mean(values: np.ndarray, span: float) -> np.ndarray:
    """pandas ``ewm(span=span).mean()`` with ``adjust=True``: the weighted
    mean of all rows so far with weights (1 - alpha)**age."""
    decay = 1.0 - 2.0 / (span + 1.0)
    out = np.empty(values.shape)
    num = np.zeros(values.shape[1:])
    den = 0.0
    for i, row in enumerate(values):
        num = row + decay * num
        den = 1.0 + decay * den
        out[i] = num / den
    return out


def _by_column(per_fold: Dict[str, np.ndarray]) -> Dict[int, Dict[str, float]]:
    """``{fold: per-column values}`` as ``{column: {fold: value}}``, the
    layout of ``DataFrame.from_dict(per_fold, orient="index").to_dict()``."""
    columns: Dict[int, Dict[str, float]] = {}
    for label, values in per_fold.items():
        for col, value in enumerate(np.asarray(values).tolist()):
            columns.setdefault(col, {})[label] = value
    return columns


class DiffBasedAnomalyDetector(EstimatorRepr):
    def __init__(
        self,
        base_estimator,
        scaler: Optional[MinMaxScaler] = None,
        require_thresholds: bool = True,
        shuffle: bool = False,
        window: Optional[int] = None,
        smoothing_method: Optional[str] = None,
        feature_thresholds: Optional[np.ndarray] = None,
        aggregate_threshold: Optional[float] = None,
    ):
        self.base_estimator = base_estimator
        self.scaler = scaler if scaler is not None else MinMaxScaler()
        self.require_thresholds = require_thresholds
        self.shuffle = shuffle
        self.window = window
        self.smoothing_method = smoothing_method
        if self.window is not None and self.smoothing_method is None:
            self.smoothing_method = "smm"
        self.feature_thresholds_ = (
            None if feature_thresholds is None
            else np.asarray(feature_thresholds, np.float64)
        )
        self.aggregate_threshold_ = (
            None if aggregate_threshold is None else float(aggregate_threshold)
        )
        # set by cross_validate (or read back from an artifact)
        self.smooth_feature_thresholds_: Optional[np.ndarray] = None
        self.smooth_aggregate_threshold_: Optional[float] = None
        self.feature_thresholds_per_fold_: Optional[Dict[str, np.ndarray]] = None
        self.aggregate_thresholds_per_fold_: Optional[Dict[str, float]] = None
        self.smooth_feature_thresholds_per_fold_: Optional[Dict[str, np.ndarray]] = None
        self.smooth_aggregate_thresholds_per_fold_: Optional[Dict[str, float]] = None

    def get_params(self, deep=False) -> dict:
        """The JAX detector's parameters (``require_thresholds`` is not one)."""
        params = {
            "base_estimator": self.base_estimator,
            "scaler": self.scaler,
            "shuffle": self.shuffle,
        }
        if self.window is not None:
            params["window"] = self.window
            params["smoothing_method"] = self.smoothing_method
        return params

    @classmethod
    def from_definition(cls, definition: dict, device=None) -> "DiffBasedAnomalyDetector":
        """The detector of a definition's arguments, its estimators on ``device``."""
        from ...serializer.from_definition import load_params_from_definition

        return cls(**load_params_from_definition(definition, device))

    def fit(self, X, y) -> "DiffBasedAnomalyDetector":
        """Train the base estimator (on rows shuffled as
        ``sklearn.utils.shuffle(random_state=0)`` orders them when
        ``shuffle``), then fit the scaler on y for the error scaling."""
        X, y = np.asarray(X, np.float64), np.asarray(y, np.float64)
        if self.shuffle:
            order = shuffled_order(len(X))
            self.base_estimator.fit(X[order], y[order])
        else:
            self.base_estimator.fit(X, y)
        self.scaler.fit(y)
        return self

    def score(self, X, y) -> float:
        return self.base_estimator.score(X, y)

    def cross_validate(self, *, X, y, cv=None, scoring=None) -> dict:
        """:func:`cross_validate` of this detector (``TimeSeriesSplit(3)`` by
        default), which also sets the thresholds from each fold model's
        errors on its test span (:meth:`set_thresholds`)."""
        X, y = np.asarray(X, np.float64), np.asarray(y, np.float64)
        splitter = cv if cv is not None else TimeSeriesSplit(n_splits=3)
        out = cross_validate(self, X, y, cv=splitter, scoring=scoring)
        fold_errors = []
        for model, (_, test_idx) in zip(out["estimator"], splitter.split(X, y)):
            pred = np.asarray(model.predict(X[test_idx]), np.float64)
            truth = y[test_idx[-len(pred):]]  # windowed models emit fewer rows
            scaled = model.scaler.transform(pred) - model.scaler.transform(truth)
            fold_errors.append((np.square(scaled).mean(axis=1), np.abs(truth - pred)))
        self.set_thresholds(fold_errors)
        return out

    def set_thresholds(self, fold_errors) -> None:
        """The thresholds from each fold model's errors on its test span,
        ``fold_errors`` a ``(scaled point MSE, absolute error per tag)`` pair
        per fold: the max of their ``rolling(6)`` minimum and, when
        smoothing is set, of their ``rolling(window)`` minimum. The last
        fold's are the final thresholds. The fleet trainer sets its
        detectors' thresholds here too."""
        agg, tag, smooth_agg, smooth_tag = {}, {}, {}, {}
        for fold, (point_mse, abs_err) in enumerate(fold_errors):
            label = f"fold-{fold}"
            agg[label] = _rolling_floor_peak(point_mse, 6)
            tag[label] = _rolling_floor_peak(abs_err, 6)
            if self.window is not None:
                smooth_agg[label] = _rolling_floor_peak(point_mse, self.window)
                smooth_tag[label] = _rolling_floor_peak(abs_err, self.window)

        self.aggregate_thresholds_per_fold_ = agg
        self.feature_thresholds_per_fold_ = tag
        self.smooth_aggregate_thresholds_per_fold_ = smooth_agg
        self.smooth_feature_thresholds_per_fold_ = smooth_tag
        last = f"fold-{len(fold_errors) - 1}"
        self.aggregate_threshold_ = agg.get(last)
        self.feature_thresholds_ = tag.get(last)
        self.smooth_aggregate_threshold_ = smooth_agg.get(last)
        self.smooth_feature_thresholds_ = smooth_tag.get(last)

    def predict(self, X) -> np.ndarray:
        return pipeline_predict(self.base_estimator, np.asarray(X, np.float64))

    def get_metadata(self) -> dict:
        """The thresholds, per fold and final, and the smoothing settings,
        with the JAX detector's keys; then the base estimator's metadata
        where it has any, else its description."""
        metadata = {}
        for key, value, as_json in (
            ("feature-thresholds", self.feature_thresholds_, np.ndarray.tolist),
            ("aggregate-threshold", self.aggregate_threshold_, float),
            ("feature-thresholds-per-fold", self.feature_thresholds_per_fold_, _by_column),
            ("aggregate-thresholds-per-fold", self.aggregate_thresholds_per_fold_, dict),
            ("window", self.window, None),
            ("smoothing-method", self.smoothing_method, None),
            ("smooth-feature-thresholds", self.smooth_feature_thresholds_, np.ndarray.tolist),
            ("smooth-aggregate-threshold", self.smooth_aggregate_threshold_, float),
            ("smooth-feature-thresholds-per-fold", self.smooth_feature_thresholds_per_fold_,
             _by_column),
            ("smooth-aggregate-thresholds-per-fold",
             self.smooth_aggregate_thresholds_per_fold_, dict),
        ):
            if as_json is None:  # always reported, None included
                metadata[key] = value
            elif value is not None:
                metadata[key] = as_json(value)
        if hasattr(self.base_estimator, "get_metadata"):
            metadata.update(self.base_estimator.get_metadata())
        else:
            metadata.update({
                "scaler": str(self.scaler),
                "base_estimator": str(self.base_estimator),
                "shuffle": self.shuffle,
            })
        return metadata

    def _smoothing(self, metric: np.ndarray) -> np.ndarray:
        if self.smoothing_method == "smm":
            return _rolling(metric, self.window, np.median)
        if self.smoothing_method == "sma":
            return _rolling(metric, self.window, np.mean)
        if self.smoothing_method == "ewma":
            return _ewm_mean(metric, self.window)
        raise ValueError(f"Unknown smoothing method {self.smoothing_method!r}")

    def anomaly_raw(self, X: model_utils.Frame, y: model_utils.Frame,
                    frequency: Optional[timedelta] = None) -> model_utils.RawFrame:
        """The anomaly frame's column groups: model-input/-output,
        tag-anomaly-{scaled,unscaled}, total-anomaly-{scaled,unscaled},
        smooth-* variants and the confidence columns."""
        if self.require_thresholds and (
            self.feature_thresholds_ is None and self.aggregate_threshold_ is None
        ):
            raise AttributeError(
                f"`require_thresholds={self.require_thresholds}` however "
                f"`.cross_validate` needs to be called in order to calculate "
                f"these thresholds before calling `.anomaly`"
            )
        X_arr = np.asarray(X.values, np.float64)
        model_output = np.asarray(pipeline_predict(self.base_estimator, X_arr))
        n = len(model_output)

        model_input = X_arr[-n:]
        y_all = np.asarray(y.values, np.float64)
        y_arr = y_all[-n:]
        index = X.index[-n:]

        # the whole y is scaled, then its last n rows kept
        out_scaled = self.scaler.transform(model_output)
        y_scaled = self.scaler.transform(y_all)[-n:]
        tag_anomaly_scaled = np.abs(out_scaled - y_scaled)
        total_anomaly_scaled = np.square(tag_anomaly_scaled).mean(axis=1)
        tag_anomaly_unscaled = np.abs(model_output - y_arr)
        total_anomaly_unscaled = np.square(tag_anomaly_unscaled).mean(axis=1)

        in_names = [str(c) for c in X.columns]
        out_names = (
            [str(c) for c in y.columns]
            if model_output.shape[1] == len(y.columns)
            else [str(i) for i in range(model_output.shape[1])]
        )
        groups = [
            ("model-input", in_names, model_input),
            ("model-output", out_names, model_output),
        ]

        def add_block(top, values):
            values = np.asarray(values)
            if values.ndim == 1:
                groups.append((top, ("",), values[:, None]))
            else:
                groups.append((top, out_names, values))

        add_block("tag-anomaly-scaled", tag_anomaly_scaled)
        add_block("total-anomaly-scaled", total_anomaly_scaled)
        add_block("tag-anomaly-unscaled", tag_anomaly_unscaled)
        add_block("total-anomaly-unscaled", total_anomaly_unscaled)

        if self.window is not None and self.smoothing_method is not None:
            smoothed = {
                "smooth-tag-anomaly-scaled": tag_anomaly_scaled,
                "smooth-total-anomaly-scaled": total_anomaly_scaled,
                "smooth-tag-anomaly-unscaled": tag_anomaly_unscaled,
                "smooth-total-anomaly-unscaled": total_anomaly_unscaled,
            }
            for top, raw in smoothed.items():
                add_block(top, self._smoothing(raw))

        if self.feature_thresholds_ is not None:
            add_block("anomaly-confidence", tag_anomaly_unscaled / self.feature_thresholds_)
        if self.aggregate_threshold_ is not None:
            add_block(
                "total-anomaly-confidence", total_anomaly_scaled / self.aggregate_threshold_
            )
        return model_utils.RawFrame(groups, index, frequency)
