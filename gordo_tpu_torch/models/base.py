"""
What the JAX package takes from scikit-learn for fitting and scoring, in
numpy: ``clone`` (an unfitted copy from the constructor parameters, as
``sklearn.base.clone`` makes one), ``explained_variance_score`` (the
estimators' ``score``) and the other default build metrics, ``r2_score``,
``mean_squared_error`` and ``mean_absolute_error`` (models/metrics.py has
them and the rest of sklearn's regression metrics).
``extract_metadata`` gathers a model's metadata.
"""

import copy

from .metrics import (  # noqa: F401 -- the default build metrics, by their old place
    explained_variance_score, mean_absolute_error, mean_squared_error, r2_score,
)


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
