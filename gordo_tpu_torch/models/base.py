"""
What the JAX package takes from scikit-learn for fitting and scoring, in
numpy: ``clone`` (an unfitted copy from the constructor parameters, as
``sklearn.base.clone`` makes one), ``explained_variance_score`` (the
estimators' ``score``) and the other default build metrics, ``r2_score``,
``mean_squared_error`` and ``mean_absolute_error``, each averaged uniformly
over outputs. ``extract_metadata`` gathers a model's metadata.
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


def _targets(y_true, y_pred):
    """Float64 (n_samples, n_outputs) views of a target and a prediction."""
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    if y_true.ndim == 1:
        return y_true[:, None], y_pred.reshape(-1, 1)
    return y_true, y_pred


def _uniform_score(numerator: np.ndarray, denominator: np.ndarray) -> float:
    """The mean over outputs of 1 - numerator / denominator, 1 where both
    are 0 and 0 where only the denominator is (sklearn's finite scores)."""
    scores = np.ones(len(numerator))
    valid = (denominator != 0) & (numerator != 0)
    scores[valid] = 1.0 - numerator[valid] / denominator[valid]
    scores[(numerator != 0) & (denominator == 0)] = 0.0
    return float(scores.mean())


def explained_variance_score(y_true, y_pred) -> float:
    """``sklearn.metrics.explained_variance_score`` with uniform averaging
    over outputs: 1 - Var(y - y_pred) / Var(y) per column."""
    y_true, y_pred = _targets(y_true, y_pred)
    diff = y_true - y_pred
    numerator = np.mean((diff - diff.mean(axis=0)) ** 2, axis=0)
    denominator = np.mean((y_true - y_true.mean(axis=0)) ** 2, axis=0)
    return _uniform_score(numerator, denominator)


def r2_score(y_true, y_pred) -> float:
    """``sklearn.metrics.r2_score`` with uniform averaging over outputs:
    1 - SS_res / SS_tot per column."""
    y_true, y_pred = _targets(y_true, y_pred)
    numerator = np.sum((y_true - y_pred) ** 2, axis=0)
    denominator = np.sum((y_true - y_true.mean(axis=0)) ** 2, axis=0)
    return _uniform_score(numerator, denominator)


def mean_squared_error(y_true, y_pred) -> float:
    """``sklearn.metrics.mean_squared_error``, averaged over outputs."""
    y_true, y_pred = _targets(y_true, y_pred)
    return float(np.mean(np.mean((y_true - y_pred) ** 2, axis=0)))


def mean_absolute_error(y_true, y_pred) -> float:
    """``sklearn.metrics.mean_absolute_error``, averaged over outputs."""
    y_true, y_pred = _targets(y_true, y_pred)
    return float(np.mean(np.mean(np.abs(y_pred - y_true), axis=0)))


def extract_metadata(model) -> dict:
    """The model's metadata as the JAX ``ModelBuilder`` gathers it
    (``_extract_metadata_from_model``): a pipeline's is its last step's; a
    model's own ``get_metadata``, updated with that of every attribute that
    is a pipeline or has metadata."""
    steps = getattr(model, "steps", None)
    if isinstance(steps, list) and steps:
        return extract_metadata(steps[-1][1])
    metadata = dict(model.get_metadata()) if hasattr(model, "get_metadata") else {}
    for value in vars(model).values():
        if hasattr(value, "steps") or hasattr(value, "get_metadata"):
            metadata.update(extract_metadata(value))
    return metadata
