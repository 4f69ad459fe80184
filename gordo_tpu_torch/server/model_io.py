"""
Model output extraction: the port's counterpart of
``gordo_tpu/server/model_io.py``.
"""

import logging

import numpy as np

from ..models.scaler import pipeline_predict

logger = logging.getLogger(__name__)


def get_model_output(model, X) -> np.ndarray:
    """The model's output on X's values: its predict (through a pipeline's
    transforms), or its transform when it has no predict; always a
    contiguous host array."""
    values = np.asarray(getattr(X, "values", X))
    if hasattr(model, "predict"):
        output = pipeline_predict(model, values)
    else:
        logger.debug("Model has no predict, falling back to transform")
        output = model.transform(values)
    return np.ascontiguousarray(output)
