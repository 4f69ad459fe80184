"""
Diff-based anomaly scoring in numpy: the port's counterpart of
``DiffBasedAnomalyDetector.anomaly_raw`` in
``gordo_tpu/models/anomaly/diff.py``.

The detector wraps a base estimator (a pipeline ending in a windowed
Transformer) and scores anomalies as the scaled and unscaled difference
between the model output and the target, with optional smoothing and,
when thresholds are present, confidence columns. The thresholds are data
read from the artifact; computing them (cross-validation) comes with the
training slice.
"""

from datetime import timedelta
from typing import Optional

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from .. import utils as model_utils
from ..scaler import MinMaxScaler, pipeline_predict


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


class DiffBasedAnomalyDetector:
    def __init__(
        self,
        base_estimator,
        scaler: MinMaxScaler,
        require_thresholds: bool = True,
        window: Optional[int] = None,
        smoothing_method: Optional[str] = None,
        feature_thresholds: Optional[np.ndarray] = None,
        aggregate_threshold: Optional[float] = None,
    ):
        self.base_estimator = base_estimator
        self.scaler = scaler
        self.require_thresholds = require_thresholds
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
