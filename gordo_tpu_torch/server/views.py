"""
The route handlers without pandas: request decode, the base and anomaly
cores and their response bodies, and the listings, the port's counterparts
of ``base_prediction_core``, ``anomaly_prediction_core``, ``model_list``,
``revision_list`` and ``download_model`` in ``gordo_tpu/server/views.py``
with the frame helpers of ``gordo_tpu/server/utils.py``.

Request frames arrive as ``{tag: {iso_timestamp: value}}`` dicts or as
plain 2-D lists; timestamps are parsed with
``datetime.fromisoformat`` and rows sorted by time. Columns are checked as
``verify_dataframe`` checks them. The response is
``{"data": ..., "time-seconds": "..."}`` (the server adds ``revision``),
with the ``smooth-*`` blocks dropped unless ``all_columns`` is given.
"""

import logging
import math
import os
import timeit
from datetime import datetime
from typing import List, Optional, Tuple

import numpy as np

from .. import serializer
from ..models.utils import Frame, make_base_raw
from .model_io import get_model_output

logger = logging.getLogger(__name__)

DELETED_FROM_RESPONSE_COLUMNS = (
    "smooth-tag-anomaly-scaled",
    "smooth-total-anomaly-scaled",
    "smooth-tag-anomaly-unscaled",
    "smooth-total-anomaly-unscaled",
)


class BadDataFrame(ValueError):
    """A request payload that cannot be coerced to the expected shape."""


def _parse_index(labels: list) -> list:
    """ISO timestamps as datetimes, else integer row labels; anything else
    raises ValueError."""
    try:
        return [datetime.fromisoformat(label) for label in labels]
    except (TypeError, ValueError):
        return [int(label) for label in labels]


def _float(value) -> float:
    return math.nan if value is None else float(value)


def decode_frame(data) -> Frame:
    """One request frame (X or y), sorted by its index."""
    if isinstance(data, dict) and any(isinstance(v, dict) for v in data.values()):
        columns = list(data)
        labels: dict = {}
        for column in data.values():
            labels.update(dict.fromkeys(column))
        labels = list(labels)
        values = [[_float(data[c].get(label)) for c in columns] for label in labels]
    elif isinstance(data, list) and all(isinstance(row, list) for row in data):
        width = len(data[0]) if data else 0
        if any(len(row) != width for row in data):
            raise BadDataFrame("rows of a 2-D payload differ in length")
        columns = list(range(width))
        labels = list(range(len(data)))
        values = [[_float(v) for v in row] for row in data]
    else:
        raise BadDataFrame(f"Cannot read a frame from a {type(data).__name__}")
    index = _parse_index(labels)
    try:
        order = sorted(range(len(index)), key=index.__getitem__)
    except TypeError as exc:  # naive and aware timestamps mixed
        raise BadDataFrame(str(exc)) from None
    array = np.asarray(values, np.float64).reshape(len(labels), len(columns))
    return Frame(array[order], columns, [index[i] for i in order])


def verify_frame(frame: Frame, expected_columns: List[str]) -> Frame:
    """Unlabelled data of the right width is taken as ordered; labelled
    data is selected down to the expected columns."""
    if not all(col in frame.columns for col in expected_columns):
        if len(frame.columns) != len(expected_columns):
            raise BadDataFrame(
                f"Unexpected features: was expecting {expected_columns} "
                f"length of {len(expected_columns)}, but got {frame.columns} "
                f"length of {len(frame.columns)}"
            )
        return Frame(frame.values, expected_columns, frame.index)
    cols = [frame.columns.index(col) for col in expected_columns]
    return Frame(frame.values[:, cols], expected_columns, frame.index)


def extract_X_y(payload, tags: List[str], target_tags: List[str]
                ) -> Tuple[Frame, Optional[Frame]]:
    if not isinstance(payload, dict) or "X" not in payload:
        raise BadDataFrame('Cannot predict without "X"')
    X = verify_frame(decode_frame(payload["X"]), tags)
    y = payload.get("y")
    if y is not None:
        y = verify_frame(decode_frame(y), target_tags)
    return X, y


def anomaly_prediction_core(model, payload, tags: List[str], target_tags: List[str],
                            frequency, all_columns: bool) -> Tuple[int, dict]:
    """``(status, body)`` of one anomaly request against ``model`` (a
    DiffBasedAnomalyDetector)."""
    start_time = timeit.default_timer()
    try:
        X, y = extract_X_y(payload, tags, target_tags)
    except ValueError as exc:
        return 400, {"message": str(exc)}
    if y is None:
        return 400, {"message": "Cannot perform anomaly detection without 'y'"}
    try:
        frame = model.anomaly_raw(X, y, frequency=frequency)
    except AttributeError as exc:
        return 422, {"message": f"Model is not complete; cannot compute anomalies: {exc}"}
    if not all_columns:
        drop = [c for c in frame.top_levels() if c in DELETED_FROM_RESPONSE_COLUMNS]
        frame = frame.drop_top_level(drop)
    return 200, {
        "data": frame.to_dict(),
        "time-seconds": f"{timeit.default_timer() - start_time:.4f}",
    }


def base_prediction_core(model, payload, tags: List[str], target_tags: List[str],
                         frequency) -> Tuple[int, dict]:
    """``(status, body)`` of one base request against ``model``: the
    ``model-input`` and ``model-output`` blocks. A ValueError of the
    predict is answered 400 with its message, any other error 400 with a
    generic one, as the JAX package answers them."""
    try:
        X, _ = extract_X_y(payload, tags, target_tags)
    except ValueError as exc:
        return 400, {"message": str(exc)}
    start = timeit.default_timer()
    try:
        output = get_model_output(model, X)
    except ValueError as err:
        logger.error("Failed to predict: %s", err, exc_info=True)
        return 400, {"error": f"ValueError: {err}"}
    except Exception:  # noqa: BLE001 -- answered 400, as the JAX server does
        logger.exception("Failed to predict")
        return 400, {"error": "Something unexpected happened; check your input data"}
    data = make_base_raw(tags, X.values, output, target_tags, X.index, frequency)
    return 200, {
        "data": data.to_dict(),
        "time-seconds": f"{timeit.default_timer() - start:.4f}",
    }


def model_list(collection_dir: str) -> dict:
    """Every entry of the collection directory, sorted."""
    try:
        return {"models": sorted(os.listdir(collection_dir))}
    except FileNotFoundError:
        return {"models": []}


def revision_list(collection_dir: str, current_revision: str) -> dict:
    """The served revision and every sibling of the collection directory."""
    try:
        available = sorted(os.listdir(os.path.join(collection_dir, "..")))
    except FileNotFoundError:
        logger.error("Attempted to list directories above %s", collection_dir, exc_info=True)
        available = [current_revision]
    return {"latest": current_revision, "available-revisions": available}


def download_model(model_dir: str) -> bytes:
    """The artifact of ``model_dir`` as the bytes ``serializer.loads`` takes."""
    return serializer.dumps(model_dir)
