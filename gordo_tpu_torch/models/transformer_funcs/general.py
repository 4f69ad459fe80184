"""
Functions for ``FunctionTransformer``: the port's copy of
``gordo_tpu/models/transformer_funcs/general.py``.

>>> import numpy as np
>>> multiply_by(np.array([1.0, 2.0]), factor=2)
array([2., 4.])
"""


def multiply_by(X, factor: float = 1.0):
    """Multiply the input by a constant factor."""
    return X * factor
