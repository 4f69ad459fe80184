"""
What the JAX package takes from scikit-learn for fitting and scoring, in
numpy: ``clone`` (an unfitted copy from the constructor parameters, as
``sklearn.base.clone`` makes one) and ``explained_variance_score`` (the
estimators' ``score``).
"""

import copy

import numpy as np


def clone(estimator):
    """An unfitted copy: ``type(estimator)(**params)`` with every parameter
    that is itself an estimator (or a list of ``(name, estimator)`` steps)
    cloned, and every other parameter deep-copied."""
    params = {}
    for name, value in estimator.get_params(deep=False).items():
        if hasattr(value, "get_params"):
            value = clone(value)
        elif isinstance(value, list) and all(
            isinstance(step, tuple) and len(step) == 2 for step in value
        ):
            value = [
                (key, clone(step) if hasattr(step, "get_params") else copy.deepcopy(step))
                for key, step in value
            ]
        else:
            value = copy.deepcopy(value)
        params[name] = value
    return type(estimator)(**params)


def explained_variance_score(y_true, y_pred) -> float:
    """``sklearn.metrics.explained_variance_score`` with uniform averaging
    over outputs: 1 - Var(y - y_pred) / Var(y) per column, 1 where both
    variances are 0 and 0 where only Var(y) is."""
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    if y_true.ndim == 1:
        y_true, y_pred = y_true[:, None], y_pred.reshape(-1, 1)
    diff = y_true - y_pred
    numerator = np.mean((diff - diff.mean(axis=0)) ** 2, axis=0)
    denominator = np.mean((y_true - y_true.mean(axis=0)) ** 2, axis=0)
    scores = np.ones(y_true.shape[1])
    valid = (denominator != 0) & (numerator != 0)
    scores[valid] = 1.0 - numerator[valid] / denominator[valid]
    scores[(numerator != 0) & (denominator == 0)] = 0.0
    return float(scores.mean())
