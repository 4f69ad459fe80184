"""
Layer-dimension math of the hourglass factories: the port's copy of
``gordo_tpu/models/factories/utils.py``.
"""

import math
from typing import Tuple


def hourglass_calc_dims(
    compression_factor: float, encoding_layers: int, n_features: int
) -> Tuple[int, ...]:
    """
    Linearly-interpolated encoder layer sizes from ``n_features`` down to
    ``ceil(compression_factor * n_features)``.

    >>> hourglass_calc_dims(0.5, 3, 10)
    (8, 7, 5)
    >>> hourglass_calc_dims(0.2, 3, 10)
    (7, 5, 2)
    >>> hourglass_calc_dims(0.5, 1, 10)
    (5,)
    """
    if not (1 >= compression_factor >= 0):
        raise ValueError("compression_factor must be 0 <= compression_factor <= 1")
    if encoding_layers < 1:
        raise ValueError("encoding_layers must be >= 1")
    smallest_layer = max(min(math.ceil(compression_factor * n_features), n_features), 1)
    average_slope = (n_features - smallest_layer) / encoding_layers
    return tuple(
        round(n_features - (i * average_slope)) for i in range(1, encoding_layers + 1)
    )


def check_dim_func_len(prefix: str, dim: Tuple[int, ...], func: Tuple[str, ...]):
    """Layer dims and activations must be of one length."""
    if len(dim) != len(func):
        raise ValueError(
            f"The length (i.e. the number of network layers) of {prefix}_dim "
            f"({len(dim)}) and {prefix}_func ({len(func)}) must be equal."
        )
