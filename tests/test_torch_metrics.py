"""
Metrics by name (``gordo_tpu_torch/models/metrics.py``): every regression
metric of ``sklearn.metrics._regression.__ALL__`` against sklearn's, on one
and on several outputs, with each ``multioutput``, signed and positive
data: the same value (RTOL: float64 sums in another order) or the same
exception class; then the builder's named scorers, per tag and in
aggregate, against the JAX builder's on the same targets and a windowed
model's shorter prediction, a scaler too; a scorer that raises is a NaN
fold score in both builders' CV, as sklearn's ``cross_validate`` makes it.
"""

import warnings

import numpy as np
import pytest
import sklearn.metrics
import sklearn.metrics._regression as sk_regression

from gordo_tpu.builder import ModelBuilder as JaxModelBuilder
from gordo_tpu_torch.builder import ModelBuilder
from gordo_tpu_torch.models import metrics
from gordo_tpu_torch.models.anomaly.diff import cross_validate
from gordo_tpu_torch.models.utils import Frame

RTOL = 1e-12
NAMES = list(sk_regression.__ALL__)


def test_every_sklearn_regression_metric_is_ported():
    assert list(metrics.REGRESSION_METRICS) == NAMES


def _data(kind: str, outputs: int):
    rng = np.random.RandomState(outputs + len(kind))
    y = rng.randn(60, outputs)
    pred = y + 0.3 * rng.randn(60, outputs)
    if kind == "positive":
        y, pred = np.abs(y) + 0.1, np.abs(pred) + 0.1
    if kind == "constant":
        y[:, 0] = 2.0
    return y, pred


def _same(ours, theirs, label):
    if isinstance(theirs, Exception):
        assert isinstance(ours, type(theirs)) or (
            isinstance(theirs, ValueError) and isinstance(ours, ValueError)), (label, ours, theirs)
        return
    assert not isinstance(ours, Exception), (label, ours)
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=1e-15, err_msg=label)


def _call(func, *args, **kwargs):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return func(*args, **kwargs)
    except Exception as exc:  # noqa: BLE001 -- compared as the outcome
        return exc


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", ["signed", "positive", "constant"])
@pytest.mark.parametrize("outputs", [1, 3])
def test_metric_matches_sklearn(name, kind, outputs):
    y, pred = _data(kind, outputs)
    ours, theirs = metrics.REGRESSION_METRICS[name], getattr(sklearn.metrics, name)
    for args in ((y, pred), (y[:, 0], pred[:, 0]), (y[:1], pred[:1])):
        _same(_call(ours, *args), _call(theirs, *args), f"{name} {args[0].shape}")
    if "multioutput" in ours.__code__.co_varnames:
        for multioutput in ("raw_values", "uniform_average", np.arange(1.0, outputs + 1)):
            _same(_call(ours, y, pred, multioutput=multioutput),
                  _call(theirs, y, pred, multioutput=multioutput), f"{name} {multioutput}")
    if name in ("r2_score", "explained_variance_score"):
        _same(_call(ours, y, pred, multioutput="variance_weighted"),
              _call(theirs, y, pred, multioutput="variance_weighted"), name)
    bad = y.copy()
    bad[0, 0] = np.nan
    _same(_call(ours, bad, pred), _call(theirs, bad, pred), f"{name} NaN")
    _same(_call(ours, y, pred[:-1]), _call(theirs, y, pred[:-1]), f"{name} lengths")


def test_metric_options_match_sklearn():
    y, pred = _data("positive", 2)
    for power in (-1, 0, 1, 1.5, 2, 3, 0.5):
        for name in ("mean_tweedie_deviance", "d2_tweedie_score"):
            _same(_call(getattr(metrics, name), y[:, 0], pred[:, 0], power=power),
                  _call(getattr(sklearn.metrics, name), y[:, 0], pred[:, 0], power=power),
                  f"{name} {power}")
    for alpha in (0.1, 0.5, 0.9):
        for name in ("mean_pinball_loss", "d2_pinball_score"):
            _same(_call(getattr(metrics, name), y, pred, alpha=alpha),
                  _call(getattr(sklearn.metrics, name), y, pred, alpha=alpha),
                  f"{name} {alpha}")


@pytest.mark.parametrize("scaler", [None, "sklearn.preprocessing.MinMaxScaler"])
def test_named_scorers_match_the_jax_builders(scaler):
    names = [f"sklearn.metrics.{n}" if i % 2 else n for i, n in enumerate(NAMES)]
    ours = ModelBuilder.metrics_from_list(names)
    theirs = JaxModelBuilder.metrics_from_list(names)
    assert [f.__name__ for f in ours] == [f.__name__ for f in theirs] == NAMES
    rng = np.random.RandomState(5)
    y = np.abs(rng.randn(80, 3)) + 0.5
    pred = y[-60:] + 0.2 * rng.randn(60, 3)  # a windowed model's 60 rows
    import pandas as pd

    tags = ["a", "b c", "d"]
    our_scorers = ModelBuilder.build_metrics_dict(ours, Frame(y, tags, range(80)), scaler)
    their_scorers = JaxModelBuilder.build_metrics_dict(theirs, pd.DataFrame(y, columns=tags),
                                                      scaler)
    assert list(our_scorers) == list(their_scorers)
    for name, scorer in our_scorers.items():
        _same(_call(scorer, y, pred), _call(their_scorers[name]._score_func, y, pred), name)


class _Fixed:
    """An estimator whose prediction is its input's first column, twice."""

    def get_params(self, deep=False):
        return {}

    def fit(self, X, y):
        return self

    def predict(self, X):
        return np.asarray(X)[:, :1].repeat(2, axis=1)


def test_a_raising_scorer_is_a_nan_fold_score():
    X = np.abs(np.random.RandomState(1).randn(40, 2)) + 1.0
    y = X.copy()
    y[:, 1] = -y[:, 1]  # a log of a value below -1 raises
    scoring = ModelBuilder.build_metrics_dict(
        ModelBuilder.metrics_from_list(["mean_squared_log_error", "max_error"]),
        Frame(y, ["p", "q"], range(40)))
    with pytest.warns(UserWarning, match="Scoring failed"):
        out = cross_validate(_Fixed(), X, y, scoring=scoring)
    assert np.all(np.isfinite(out["test_mean-squared-log-error-p"]))
    assert np.all(np.isnan(out["test_mean-squared-log-error-q"]))
    assert np.all(np.isnan(out["test_mean-squared-log-error"]))
    assert np.all(np.isnan(out["test_max-error"]))  # several outputs
    assert np.all(np.isfinite(out["test_max-error-q"]))
