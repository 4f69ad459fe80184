"""
The splitter's options and the build's two savings
(``gordo_tpu_torch/models/anomaly/diff.py``, ``builder/build_model.py``):

- ``TimeSeriesSplit(n_splits, gap, test_size, max_train_size)`` gives
  sklearn's folds over a grid of the options, and refuses what sklearn
  refuses with its exception class; the fleet planner sends a splitter with
  an option to the serial builder, as the JAX planner does, and the serial
  builder builds it;
- cross-validation predicts each fold's test span once: the scorers and
  the thresholds share that prediction, and the scores and thresholds are
  those of separate predicts of the fold models (the parent's three), to
  the bit;
- ``model_offset`` from the final estimator's ``output_offset`` equals
  ``len(X) - len(model.predict(X))`` for every family, inside a pipeline
  and a detector.
"""

import itertools

import numpy as np
import pytest
from sklearn.model_selection import TimeSeriesSplit as SkTimeSeriesSplit

from gordo_tpu_torch.builder import ModelBuilder
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.models import models
from gordo_tpu_torch.models.anomaly import diff
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector, TimeSeriesSplit
from gordo_tpu_torch.models.scaler import MinMaxScaler, Pipeline
from gordo_tpu_torch.models.utils import Frame
from gordo_tpu_torch.parallel import batch_trainer as bt

GRID = list(itertools.product([2, 3, 5], [0, 1, 7], [None, 1, 9], [None, 5, 40]))


@pytest.mark.parametrize("n", [10, 60, 257])
def test_time_series_split_options_match_sklearn(n):
    X = np.zeros((n, 1))
    for n_splits, gap, test_size, max_train_size in GRID:
        kwargs = dict(n_splits=n_splits, gap=gap, test_size=test_size,
                      max_train_size=max_train_size)
        try:
            expected = list(SkTimeSeriesSplit(**kwargs).split(X))
        except ValueError as exc:
            with pytest.raises(ValueError, match=str(exc).split(" ")[0]):
                list(TimeSeriesSplit(**kwargs).split(X))
            continue
        got = list(TimeSeriesSplit(**kwargs).split(X))
        assert len(got) == len(expected), kwargs
        for (a, b), (c, d) in zip(got, expected):
            np.testing.assert_array_equal(a, c, err_msg=str(kwargs))
            np.testing.assert_array_equal(b, d, err_msg=str(kwargs))
    assert repr(TimeSeriesSplit(3, gap=2)) == repr(SkTimeSeriesSplit(3, gap=2))


def _machine(cv: dict) -> Machine:
    return Machine.from_config({
        "name": "m",
        "dataset": {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00+00:00",
                    "train_end_date": "2020-01-02T00:00:00+00:00", "tags": ["a", "b"]},
        "model": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {
            "base_estimator": {"gordo_tpu.models.models.AutoEncoder": {
                "kind": "feedforward_hourglass", "epochs": 1}}}},
        "evaluation": {"cv": cv, "seed": 0}}, "proj")


@pytest.mark.parametrize("options", [{"gap": 4}, {"test_size": 30}, {"max_train_size": 50}])
def test_splitter_options_go_to_the_serial_builder_which_builds_them(options):
    cv = {"sklearn.model_selection.TimeSeriesSplit": {"n_splits": 3, **options}}
    machine = _machine(cv)
    assert bt._plan_machine(machine) is None
    assert bt._plan_machine(_machine({"sklearn.model_selection.TimeSeriesSplit": {
        "n_splits": 3}})) is not None
    _, built = ModelBuilder(machine, device="cpu").build()
    splits = built.metadata.build_metadata.model.cross_validation.splits
    expected = list(SkTimeSeriesSplit(n_splits=3, **options).split(np.zeros((144, 1))))
    for fold, (train, test) in enumerate(expected, start=1):
        assert splits[f"fold-{fold}-n-train"] == len(train)
        assert splits[f"fold-{fold}-n-test"] == len(test)


class _Counting(models.BaseEstimator):
    """A deterministic windowed regressor (least squares, output from the
    ``lookback``-th row) that counts its predicts."""

    predicts = 0

    def __init__(self, lookback: int = 4):
        self.lookback = lookback

    def get_params(self, deep=False):
        return {"lookback": self.lookback}

    @property
    def output_offset(self) -> int:
        return self.lookback - 1

    def fit(self, X, y, **kwargs):
        self.coef_ = np.linalg.lstsq(np.asarray(X), np.asarray(y), rcond=None)[0]
        return self

    def predict(self, X):
        type(self).predicts += 1
        return (np.asarray(X) @ self.coef_)[self.lookback - 1:]


@pytest.mark.parametrize("window", [None, 5])
def test_one_predict_per_fold_gives_the_separate_predicts_scores_and_thresholds(window):
    rng = np.random.RandomState(2)
    X = rng.rand(300, 3)
    y = X @ rng.rand(3, 3) + 0.05 * rng.rand(300, 3)
    scoring = ModelBuilder.build_metrics_dict(
        ModelBuilder.metrics_from_list(None), Frame(y, ["a", "b", "c"], range(300)))
    detector = DiffBasedAnomalyDetector(base_estimator=_Counting(), scaler=MinMaxScaler(),
                                        window=window)
    _Counting.predicts = 0
    out = detector.cross_validate(X=X, y=y, scoring=scoring)
    assert _Counting.predicts == 3  # one a fold
    # the parent's way: each fold model predicted apart for the scores and the thresholds
    reference = DiffBasedAnomalyDetector(base_estimator=_Counting(), scaler=MinMaxScaler(),
                                         window=window)
    fold_errors = []
    for model, (_, test) in zip(out["estimator"], TimeSeriesSplit(3).split(X)):
        pred = model.predict(X[test])
        for name, scorer in scoring.items():
            assert scorer(y[test], pred) == out[f"test_{name}"][len(fold_errors)], name
        truth = y[test[-len(pred):]]
        scaled = model.scaler.transform(pred) - model.scaler.transform(truth)
        fold_errors.append((np.square(scaled).mean(axis=1), np.abs(truth - pred)))
    reference.set_thresholds(fold_errors)
    np.testing.assert_array_equal(detector.feature_thresholds_, reference.feature_thresholds_)
    assert detector.aggregate_threshold_ == reference.aggregate_threshold_
    if window:
        np.testing.assert_array_equal(detector.smooth_feature_thresholds_,
                                      reference.smooth_feature_thresholds_)


def test_kfcv_predicts_each_fold_once(monkeypatch):
    X = np.random.RandomState(3).rand(60, 2)
    detector = diff.DiffBasedKFCVAnomalyDetector(
        base_estimator=_Counting(lookback=1), scaler=MinMaxScaler(), window=4)
    _Counting.predicts = 0
    detector.cross_validate(X=X, y=X, scoring={"m": lambda a, b: float(np.mean(a - b))})
    assert _Counting.predicts == 5


@pytest.mark.parametrize("estimator", [
    models.TransformerAutoEncoder(kind="transformer_model", lookback_window=12, d_model=8,
                                  num_heads=2, ff_dim=16, num_blocks=1, device="cpu"),
    models.LSTMAutoEncoder(kind="lstm_hourglass", lookback_window=7, device="cpu"),
    models.LSTMForecast(kind="lstm_hourglass", lookback_window=5, device="cpu"),
    models.AutoEncoder(kind="feedforward_hourglass", device="cpu"),
])
def test_model_offset_from_the_spec_is_the_predicts(estimator):
    X = np.random.RandomState(4).rand(40, 3)
    detector = DiffBasedAnomalyDetector(
        base_estimator=Pipeline([("scaler", MinMaxScaler()), ("model", estimator)]))
    detector.fit(X, X)
    for model in (detector, detector.base_estimator, estimator):
        assert ModelBuilder._determine_offset(model) == len(X) - len(model.predict(X))
    assert ModelBuilder._determine_offset(MinMaxScaler()) == 0
