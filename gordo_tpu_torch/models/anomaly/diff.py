"""
Diff-based anomaly detection in numpy: the port's counterparts of
``DiffBasedAnomalyDetector`` and ``DiffBasedKFCVAnomalyDetector`` in
``gordo_tpu/models/anomaly/diff.py``, with sklearn's ``TimeSeriesSplit``
and ``KFold``.

The detector wraps a base estimator (by default a feedforward hourglass
``AutoEncoder``, usually inside a pipeline) and scores anomalies as the
scaled and unscaled difference between the model output and the target,
with optional smoothing and, when thresholds are present, confidence
columns. ``fit`` trains the base estimator and fits the scaler on y;
``cross_validate`` trains a fresh copy per ``TimeSeriesSplit`` fold, scores
it (with the builder's per-tag scorers when it is given them) and sets the
thresholds from the folds' rolling error statistics, the last fold's being
the final ones. The KFCV detector takes shuffled ``KFold`` folds instead,
scatters each fold model's predictions back onto its test rows, and takes
its thresholds as a percentile of the smoothed errors over all rows.
"""

import time
from datetime import timedelta
from typing import Dict, Optional

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from .. import utils as model_utils
from ..base import clone
from ..models import AutoEncoder
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


class KFold:
    """``sklearn.model_selection.KFold``: ``n_splits`` consecutive folds of
    the indices (the first ``n % n_splits`` one row longer), after the
    indices are shuffled by ``np.random.RandomState(random_state)`` (the
    global numpy RNG when it is None) if ``shuffle``. Each split yields the
    train and the test indices, both in ascending order, as sklearn's do."""

    def __init__(self, n_splits: int = 5, *, shuffle: bool = False, random_state=None):
        if not shuffle and random_state is not None:
            raise ValueError(
                "Setting a random_state has no effect since shuffle is False. You should "
                "leave random_state to its default (None), or set shuffle=True."
            )
        self.n_splits = int(n_splits)
        self.shuffle = shuffle
        self.random_state = random_state

    def get_params(self, deep=False) -> dict:
        return {"n_splits": self.n_splits, "random_state": self.random_state,
                "shuffle": self.shuffle}

    def __repr__(self) -> str:
        return "KFold(" + ", ".join(f"{k}={v!r}" for k, v in self.get_params().items()) + ")"

    def get_n_splits(self, X=None, y=None, groups=None) -> int:
        return self.n_splits

    def split(self, X, y=None, groups=None):
        n = len(X)
        if self.n_splits > n:
            raise ValueError(
                f"Cannot have number of splits n_splits={self.n_splits} greater than the "
                f"number of samples: n_samples={n}."
            )
        indices = np.arange(n)
        if self.shuffle:
            rng = (np.random.mtrand._rand if self.random_state is None
                   else np.random.RandomState(self.random_state))
            rng.shuffle(indices)
        sizes = np.full(self.n_splits, n // self.n_splits)
        sizes[: n % self.n_splits] += 1
        start = 0
        for size in sizes:
            test = np.zeros(n, bool)
            test[indices[start:start + size]] = True
            yield np.flatnonzero(~test), np.flatnonzero(test)
            start += size


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
        base_estimator=None,
        scaler: Optional[MinMaxScaler] = None,
        require_thresholds: bool = True,
        shuffle: bool = False,
        window: Optional[int] = None,
        smoothing_method: Optional[str] = None,
        feature_thresholds: Optional[np.ndarray] = None,
        aggregate_threshold: Optional[float] = None,
    ):
        self.base_estimator = (base_estimator if base_estimator is not None
                               else AutoEncoder(kind="feedforward_hourglass"))
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
        """The detector of a definition's arguments, its estimators (the
        default one too) on ``device``."""
        from ...serializer.from_definition import load_params_from_definition

        params = load_params_from_definition(definition, device)
        if params.get("base_estimator") is None:
            params["base_estimator"] = AutoEncoder(kind="feedforward_hourglass", device=device)
        return cls(**params)

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


class DiffBasedKFCVAnomalyDetector(DiffBasedAnomalyDetector):
    """The KFold variant: ``cross_validate`` takes ``KFold(5, shuffle=True,
    random_state=0)`` folds by default and needs a base estimator without
    an output offset; every row is a test row once, and the thresholds are
    the ``threshold_percentile`` quantile (linear, NaN skipped, as pandas'
    ``quantile``) of the smoothed scaled MSE per row and of the smoothed
    absolute error per tag."""

    def __init__(
        self,
        base_estimator=None,
        scaler: Optional[MinMaxScaler] = None,
        require_thresholds: bool = True,
        shuffle: bool = True,
        window: int = 144,
        smoothing_method: str = "smm",
        threshold_percentile: float = 0.99,
        feature_thresholds: Optional[np.ndarray] = None,
        aggregate_threshold: Optional[float] = None,
    ):
        super().__init__(base_estimator, scaler, require_thresholds, shuffle, window,
                         smoothing_method, feature_thresholds, aggregate_threshold)
        self.smoothing_method = smoothing_method
        self.threshold_percentile = threshold_percentile

    def get_params(self, deep=False) -> dict:
        return {
            "base_estimator": self.base_estimator,
            "scaler": self.scaler,
            "window": self.window,
            "smoothing_method": self.smoothing_method,
            "shuffle": self.shuffle,
            "threshold_percentile": self.threshold_percentile,
        }

    def get_metadata(self) -> dict:
        """The final thresholds, then the base estimator's metadata where it
        has any, else its description, with the JAX detector's keys."""
        metadata = {}
        if self.feature_thresholds_ is not None:
            metadata["feature-thresholds"] = self.feature_thresholds_.tolist()
        if self.aggregate_threshold_ is not None:
            metadata["aggregate-threshold"] = self.aggregate_threshold_
        if hasattr(self.base_estimator, "get_metadata"):
            metadata.update(self.base_estimator.get_metadata())
        else:
            metadata.update({
                "scaler": str(self.scaler),
                "base_estimator": str(self.base_estimator),
                "shuffle": self.shuffle,
                "window": self.window,
                "smoothing-method": self.smoothing_method,
                "threshold-percentile": self.threshold_percentile,
            })
        return metadata

    def estimator_offset(self) -> int:
        """The output offset of the (pipelined) base estimator."""
        steps = getattr(self.base_estimator, "steps", None)
        estimator = steps[-1][1] if steps else self.base_estimator
        return int(getattr(estimator, "output_offset", 0) or 0)

    def cross_validate(self, *, X, y, cv=None, scoring=None) -> dict:
        """:func:`cross_validate` over the folds, then each fold model's
        predictions and scaled MSE written onto its test rows, and the
        thresholds taken from them."""
        offset = self.estimator_offset()
        if offset:
            raise ValueError(
                f"DiffBasedKFCVAnomalyDetector requires an offset-free base estimator (got "
                f"lookback/lookahead offset {offset}); use DiffBasedAnomalyDetector for "
                f"windowed models"
            )
        X, y = np.asarray(X, np.float64), np.asarray(y, np.float64)
        cv = cv if cv is not None else KFold(n_splits=5, shuffle=True, random_state=0)
        out = cross_validate(self, X, y, cv=cv, scoring=scoring)
        self.set_fold_thresholds(y, [
            (test_idx, model.predict(X[test_idx]), model.scaler)
            for (_, test_idx), model in zip(cv.split(X, y), out["estimator"])])
        return out

    def set_fold_thresholds(self, y: np.ndarray, folds) -> None:
        """The thresholds from the folds' predictions, ``folds`` a ``(test
        rows, predictions of them, y scaler)`` triple per fold, the scaler
        fitted on the fold's train targets: the predictions and their scaled
        MSE are written onto their test rows (rows no fold visits stay 0 and
        NaN), then smoothed, and the percentile taken. The fleet trainer
        sets its KFCV detectors' thresholds here too."""
        y = np.asarray(y, np.float64)
        y_pred = np.zeros_like(y)
        y_val_mse = np.full(len(y), np.nan)
        for test_idx, pred, scaler in folds:
            y_pred[test_idx] = pred
            scaled = scaler.transform(y_pred[test_idx]) - scaler.transform(y[test_idx])
            y_val_mse[test_idx] = np.square(scaled).mean(axis=1)
        self.aggregate_threshold_ = float(self._threshold(y_val_mse))
        self.feature_thresholds_ = self._threshold(np.abs(y - y_pred))

    def _threshold(self, metric: np.ndarray):
        return np.nanquantile(self._smoothing(metric), self.threshold_percentile, axis=0)
