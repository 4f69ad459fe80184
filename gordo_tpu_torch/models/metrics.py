"""
The regression metrics of ``sklearn.metrics`` in numpy, by sklearn's names,
formulas and checks (its ``sklearn.metrics._regression.__ALL__``), so that a
machine's ``evaluation.metrics`` may name any of them in either package.

Each takes ``(y_true, y_pred)``, 1-D or (n_samples, n_outputs), and where
sklearn's does, ``multioutput``: ``"raw_values"`` (one score an output),
``"uniform_average"`` (the default) or an array of output weights, and for
``r2_score`` and ``explained_variance_score`` also ``"variance_weighted"``.
Inputs sklearn refuses are refused with its exception class, ValueError:
unequal shapes, no rows, a NaN or an infinity, values outside a metric's
domain (a log of a value at most -1, a deviance's non-positive
prediction), and several outputs where a metric takes one (``max_error``,
the Tweedie deviances and ``d2_tweedie_score``). ``r2_score`` and the D²
scores of fewer than two rows are NaN.
"""

from typing import Union

import numpy as np

Multioutput = Union[str, np.ndarray, list]


def _targets(y_true, y_pred, multioutput=None):
    """Float64 (n_samples, n_outputs) arrays of a target and a prediction,
    checked as sklearn's ``_check_reg_targets`` checks them; and whether
    they hold several outputs."""
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    if y_true.ndim == 1:
        y_true = y_true.reshape(-1, 1)
    if y_pred.ndim == 1:
        y_pred = y_pred.reshape(-1, 1)
    if len(y_true) != len(y_pred):
        raise ValueError(
            f"Found input variables with inconsistent numbers of samples: "
            f"[{len(y_true)}, {len(y_pred)}]")
    if y_true.shape[1] != y_pred.shape[1]:
        raise ValueError(
            f"y_true and y_pred have different number of output "
            f"({y_true.shape[1]}!={y_pred.shape[1]})")
    if len(y_true) == 0:
        raise ValueError("Found array with 0 sample(s) (shape=(0,)) while a minimum of 1 "
                         "is required.")
    for arr in (y_true, y_pred):
        if not np.all(np.isfinite(arr)):
            raise ValueError("Input contains NaN or infinity.")
    if not isinstance(multioutput, str) and multioutput is not None:
        weights = np.asarray(multioutput, np.float64)
        if y_true.shape[1] == 1:
            raise ValueError("Custom weights are useful only in multi-output cases.")
        if len(weights) != y_true.shape[1]:
            raise ValueError(
                f"There must be equally many custom weights ({len(weights)}) as outputs "
                f"({y_true.shape[1]}).")
    return y_true, y_pred, y_true.shape[1] > 1


def _combine(output_errors: np.ndarray, multioutput: Multioutput):
    """Per-output values as ``multioutput`` asks: the array itself, their
    mean, or their average weighted by the given weights."""
    if isinstance(multioutput, str):
        if multioutput == "raw_values":
            return output_errors
        if multioutput != "uniform_average":
            raise ValueError(f"Invalid multioutput {multioutput!r}")
        return float(np.average(output_errors))
    return float(np.average(output_errors, weights=np.asarray(multioutput, np.float64)))


def _fraction_explained(numerator: np.ndarray, denominator: np.ndarray,
                        multioutput: Multioutput):
    """1 - numerator / denominator per output, made finite as sklearn's
    ``force_finite`` makes it (1 where the numerator is 0, 0 where only the
    denominator is), then combined; ``"variance_weighted"`` weighs the
    outputs by the denominator (uniformly when it is 0 everywhere)."""
    scores = np.ones(len(numerator))
    valid = (denominator != 0) & (numerator != 0)
    scores[valid] = 1.0 - numerator[valid] / denominator[valid]
    scores[(numerator != 0) & (denominator == 0)] = 0.0
    if isinstance(multioutput, str) and multioutput == "variance_weighted":
        if not np.any(denominator != 0):
            return float(np.average(scores))
        return float(np.average(scores, weights=denominator))
    return _combine(scores, multioutput)


def explained_variance_score(y_true, y_pred, *, multioutput="uniform_average"):
    """1 - Var(y - y_pred) / Var(y) per output."""
    y_true, y_pred, _ = _targets(y_true, y_pred, multioutput)
    diff = y_true - y_pred
    numerator = np.average((diff - np.average(diff, axis=0)) ** 2, axis=0)
    denominator = np.average((y_true - np.average(y_true, axis=0)) ** 2, axis=0)
    return _fraction_explained(numerator, denominator, multioutput)


def r2_score(y_true, y_pred, *, multioutput="uniform_average"):
    """1 - SS_res / SS_tot per output; NaN for fewer than two rows."""
    y_true, y_pred, _ = _targets(y_true, y_pred, multioutput)
    if len(y_pred) < 2:
        return float("nan")
    numerator = np.sum((y_true - y_pred) ** 2, axis=0)
    denominator = np.sum((y_true - np.average(y_true, axis=0)) ** 2, axis=0)
    return _fraction_explained(numerator, denominator, multioutput)


def mean_squared_error(y_true, y_pred, *, multioutput="uniform_average"):
    y_true, y_pred, _ = _targets(y_true, y_pred, multioutput)
    return _combine(np.average((y_true - y_pred) ** 2, axis=0), multioutput)


def root_mean_squared_error(y_true, y_pred, *, multioutput="uniform_average"):
    y_true, y_pred, _ = _targets(y_true, y_pred)  # sklearn checks no weights here
    return _combine(np.sqrt(np.average((y_true - y_pred) ** 2, axis=0)), multioutput)


def mean_absolute_error(y_true, y_pred, *, multioutput="uniform_average"):
    y_true, y_pred, _ = _targets(y_true, y_pred, multioutput)
    return _combine(np.average(np.abs(y_pred - y_true), axis=0), multioutput)


def median_absolute_error(y_true, y_pred, *, multioutput="uniform_average"):
    y_true, y_pred, _ = _targets(y_true, y_pred, multioutput)
    return _combine(np.median(np.abs(y_pred - y_true), axis=0), multioutput)


def mean_absolute_percentage_error(y_true, y_pred, *, multioutput="uniform_average"):
    """|y_pred - y| / max(|y|, float64 eps), averaged over the rows."""
    y_true, y_pred, _ = _targets(y_true, y_pred, multioutput)
    mape = np.abs(y_pred - y_true) / np.maximum(np.abs(y_true), np.finfo(np.float64).eps)
    return _combine(np.average(mape, axis=0), multioutput)


def _log1p_targets(y_true, y_pred, name: str, multioutput):
    y_true, y_pred, _ = _targets(y_true, y_pred, multioutput)
    if np.any(y_true <= -1) or np.any(y_pred <= -1):
        raise ValueError(f"{name} cannot be used when targets contain values less than or "
                         f"equal to -1.")
    return np.log1p(y_true), np.log1p(y_pred)


def mean_squared_log_error(y_true, y_pred, *, multioutput="uniform_average"):
    y_true, y_pred = _log1p_targets(y_true, y_pred, "Mean Squared Logarithmic Error",
                                    multioutput)
    return mean_squared_error(y_true, y_pred, multioutput=multioutput)


def root_mean_squared_log_error(y_true, y_pred, *, multioutput="uniform_average"):
    y_true, y_pred = _log1p_targets(y_true, y_pred, "Root Mean Squared Logarithmic Error",
                                    multioutput)
    return root_mean_squared_error(y_true, y_pred, multioutput=multioutput)


def max_error(y_true, y_pred):
    y_true, y_pred, multi = _targets(y_true, y_pred)
    if multi:
        raise ValueError("Multioutput not supported in max_error")
    return float(np.max(np.abs(y_true - y_pred)))


def _pinball(y_true, y_pred, alpha: float) -> np.ndarray:
    diff = y_true - y_pred
    sign = (diff >= 0).astype(diff.dtype)
    return np.average(alpha * sign * diff - (1 - alpha) * (1 - sign) * diff, axis=0)


def mean_pinball_loss(y_true, y_pred, *, alpha=0.5, multioutput="uniform_average"):
    y_true, y_pred, _ = _targets(y_true, y_pred, multioutput)
    return _combine(_pinball(y_true, y_pred, alpha), multioutput)


def d2_pinball_score(y_true, y_pred, *, alpha=0.5, multioutput="uniform_average"):
    """1 - pinball loss / the pinball loss of y's own ``alpha`` quantile
    (sklearn's averaged inverted CDF) per output."""
    y_true, y_pred, _ = _targets(y_true, y_pred, multioutput)
    if len(y_pred) < 2:
        return float("nan")
    quantile = np.quantile(y_true, alpha, axis=0, method="averaged_inverted_cdf")
    numerator = _pinball(y_true, y_pred, alpha)
    denominator = _pinball(y_true, np.broadcast_to(quantile, y_true.shape), alpha)
    return _fraction_explained(numerator, denominator, multioutput)


def d2_absolute_error_score(y_true, y_pred, *, multioutput="uniform_average"):
    return d2_pinball_score(y_true, y_pred, alpha=0.5, multioutput=multioutput)


def _tweedie(y_true: np.ndarray, y_pred, power: float) -> float:
    p = power
    with np.errstate(divide="ignore", invalid="ignore"):
        if p < 0:
            dev = 2 * (np.power(np.where(y_true > 0, y_true, 0.0), 2 - p) / ((1 - p) * (2 - p))
                       - y_true * np.power(y_pred, 1 - p) / (1 - p)
                       + np.power(y_pred, 2 - p) / (2 - p))
        elif p == 0:
            dev = (y_true - y_pred) ** 2
        elif p == 1:
            ratio = y_true / y_pred
            dev = 2 * (np.where(y_true == 0, 0.0, y_true * np.log(ratio)) - y_true + y_pred)
        elif p == 2:
            dev = 2 * (np.log(y_pred / y_true) + y_true / y_pred - 1)
        else:
            dev = 2 * (np.power(y_true, 2 - p) / ((1 - p) * (2 - p))
                       - y_true * np.power(y_pred, 1 - p) / (1 - p)
                       + np.power(y_pred, 2 - p) / (2 - p))
    return float(np.average(dev))


def mean_tweedie_deviance(y_true, y_pred, *, power=0):
    """The mean Tweedie deviance of ``power`` (0 normal, 1 Poisson, 2 gamma;
    powers in (0, 1) are refused), each power's domain checked."""
    if 0 < power < 1:
        raise ValueError(f"The 'power' parameter of mean_tweedie_deviance must be a float in "
                         f"the range (-inf, 0.0] or a float in the range [1.0, inf). Got "
                         f"{power} instead.")
    y_true, y_pred, multi = _targets(y_true, y_pred)
    if multi:
        raise ValueError("Multioutput not supported in mean_tweedie_deviance")
    message = f"Mean Tweedie deviance error with power={power} can only be used on "
    if power < 0 and np.any(y_pred <= 0):
        raise ValueError(message + "strictly positive y_pred.")
    if 1 <= power < 2 and (np.any(y_true < 0) or np.any(y_pred <= 0)):
        raise ValueError(message + "non-negative y and strictly positive y_pred.")
    if power >= 2 and (np.any(y_true <= 0) or np.any(y_pred <= 0)):
        raise ValueError(message + "strictly positive y and y_pred.")
    return _tweedie(y_true, y_pred, power)


def mean_poisson_deviance(y_true, y_pred):
    return mean_tweedie_deviance(y_true, y_pred, power=1)


def mean_gamma_deviance(y_true, y_pred):
    return mean_tweedie_deviance(y_true, y_pred, power=2)


def d2_tweedie_score(y_true, y_pred, *, power=0):
    """1 - deviance / the deviance of y's mean, one output."""
    y_true, y_pred, multi = _targets(y_true, y_pred)
    if multi:
        raise ValueError("Multioutput not supported in d2_tweedie_score")
    if len(y_pred) < 2:
        return float("nan")
    y_true, y_pred = y_true[:, 0], y_pred[:, 0]
    numerator = mean_tweedie_deviance(y_true, y_pred, power=power)
    denominator = _tweedie(y_true, np.average(y_true), power)
    return 1 - numerator / denominator


# sklearn.metrics._regression.__ALL__, in its order
REGRESSION_METRICS = {f.__name__: f for f in (
    max_error, mean_absolute_error, mean_squared_error, mean_squared_log_error,
    median_absolute_error, mean_absolute_percentage_error, mean_pinball_loss, r2_score,
    root_mean_squared_log_error, root_mean_squared_error, explained_variance_score,
    mean_tweedie_deviance, mean_poisson_deviance, mean_gamma_deviance, d2_tweedie_score,
    d2_pinball_score, d2_absolute_error_score)}
