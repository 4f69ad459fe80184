"""
The route handlers without pandas: request decode, the base and anomaly
cores and their response bodies, and the listings, the port's counterparts
of ``base_prediction_core``, ``anomaly_prediction_core``, ``model_list``,
``revision_list`` and ``download_model`` in ``gordo_tpu/server/views.py``
with the frame helpers of ``gordo_tpu/server/utils.py``.

Request frames arrive as ``{tag: {iso_timestamp: value}}`` dicts, or in
the other layouts ``pd.DataFrame(data)`` reads: plain 2-D lists, column
dicts of lists (``{tag: [value, ...]}``) and lists of records
(``[{tag: value}, ...]``), the last three with row numbers for an index;
timestamps are parsed with ``datetime.fromisoformat`` and rows sorted by
time. Columns are checked as
``verify_dataframe`` checks them. The response is
``{"data": ..., "time-seconds": "..."}`` (the server adds ``revision``),
with the ``smooth-*`` blocks dropped unless ``all_columns`` is given.

Resilience (server/resilience.py), as the JAX views apply it: the cores
take the model's circuit breaker (None when breakers are off) and record
each predict's outcome into it; the predict phase fires the
``serve_predict`` fault site (util/faults.py; the base route also
``serve_poison_nan``), checks the request's deadline (``preflight``, a 504
when spent) and, on the base route, the output's finiteness
(``GORDO_TPU_VALIDATE_OUTPUT``: a 500 that the breaker counts). A
``NonFiniteDataError`` raised by the batcher's per-rider guard is answered
the same way on either route; the anomaly frame itself is not checked
(its rolling smoothing yields NaN legitimately).

Drift detection (observability/drift.py), as the JAX views feed it: with
``GORDO_TPU_DRIFT_DETECT`` open, each successful predict records one
reconstruction-error statistic for its model (:func:`_record_drift_stat`):
the base core the mean absolute error of the output against the input's
target columns, the anomaly core the mean of the frame's
``total-anomaly-unscaled`` block. Every lane answers through these cores,
so every lane feeds it, batched riders included; a failure of the
statistic never fails the request, and with the gate closed nothing is
computed.

With the native codec on for a request (server/fast_codec.py), its body is
parsed natively where the strict grammar takes it (:func:`decode_request`)
and its response's ``"data"`` is rendered by the template encoder
(:func:`response_bytes`); both give what the dict path gives, byte for
byte, and every other body or frame takes the dict path.
"""

import contextlib
import json
import logging
import math
import os
import timeit
from datetime import datetime
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import serializer
from ..models.utils import Frame, RawFrame, make_base_raw
from ..observability import drift
from ..util import faults
from . import fast_codec, resilience
from .model_io import get_model_output

logger = logging.getLogger(__name__)

DELETED_FROM_RESPONSE_COLUMNS = (
    "smooth-tag-anomaly-scaled",
    "smooth-total-anomaly-scaled",
    "smooth-tag-anomaly-unscaled",
    "smooth-total-anomaly-unscaled",
)


PARQUET_REFUSAL = ("format=parquet is not supported by this server: it needs pyarrow, "
                   "which is not installed; ask for JSON (no format argument)")


class BadDataFrame(ValueError):
    """A request payload that cannot be coerced to the expected shape."""


@contextlib.contextmanager
def _phase(timings: Optional[Dict[str, float]], name: str):
    """Time one request phase into ``timings`` (the Server-Timing header's
    entries), also when it raises."""
    started = timeit.default_timer()
    try:
        yield
    finally:
        if timings is not None:
            timings[name] = timings.get(name, 0.0) + timeit.default_timer() - started


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
    elif isinstance(data, dict) and all(isinstance(v, list) for v in data.values()):
        # {tag: [value, ...]}, the lists of one length
        if len({len(v) for v in data.values()}) > 1:
            raise BadDataFrame("All arrays must be of the same length")
        columns = list(data)
        labels = list(range(len(next(iter(data.values()), []))))
        values = [[_float(column[i]) for column in data.values()] for i in labels]
    elif isinstance(data, list) and data and all(isinstance(row, dict) for row in data):
        # records: the columns in the order of their first appearance
        columns = list(dict.fromkeys(key for row in data for key in row))
        labels = list(range(len(data)))
        values = [[_float(row.get(c)) for c in columns] for row in data]
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


def decode_request(body: Optional[bytes], tags: List[str], target_tags: List[str],
                   fast: bool) -> Tuple[Frame, Optional[Frame]]:
    """``(X, y)`` of a request body, checked against the tags: parsed
    natively when ``fast`` and the strict grammar takes the body, else by
    ``json`` and :func:`extract_X_y` (a body that is not JSON, or was not
    sent as JSON, ``body`` None, has no X)."""
    if body is None:
        raise BadDataFrame('Cannot predict without "X"')
    if fast:
        parsed = fast_codec.decode_body_xy(body)
        if parsed is not None:
            X, y = parsed
            fast_codec.count("NATIVE_PARSES", 1 if y is None else 2)
            return verify_frame(X, tags), None if y is None else verify_frame(y, target_tags)
    try:
        payload = fast_codec.loads(body or b"null")
    except ValueError:
        payload = None
    if fast:
        # the catalog counts the frames the dict path decodes, as the JAX
        # views count theirs: none for a body that is not JSON
        fast_codec.count("PARSE_FALLBACKS", sum(
            isinstance(payload, dict) and payload.get(key) is not None for key in ("X", "y")))
    return extract_X_y(payload, tags, target_tags)


def _without_nan(value):
    """``value`` with every non-finite float replaced by None, as
    ``simplejson.dumps(..., ignore_nan=True)`` writes it."""
    if isinstance(value, float):
        return value if math.isfinite(value) else None
    if isinstance(value, dict):
        return {key: _without_nan(v) for key, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_without_nan(v) for v in value]
    return value


def json_text(body) -> str:
    """``body`` as JSON, with null for every non-finite float."""
    try:
        return json.dumps(body, allow_nan=False)
    except ValueError:
        return json.dumps(_without_nan(body), allow_nan=False)


def response_bytes(body: dict, fast: bool) -> bytes:
    """The JSON of a response body whose ``"data"`` may be a
    :class:`RawFrame`: its fragment from the template encoder when ``fast``
    and the encoder takes the frame, spliced before the other fields;
    otherwise ``json`` of ``to_dict()``. The bytes are the same either way."""
    raw = body.get("data")
    if not isinstance(raw, RawFrame):
        return json_text(body).encode()
    rest = {key: value for key, value in body.items() if key != "data"}
    if fast:
        fragment = fast_codec.encode_raw(raw)
        if fragment is not None:
            fast_codec.count("NATIVE_ENCODES")
            return fast_codec.splice_response_body(fragment, json_text(rest)).encode()
        fast_codec.count("ENCODE_FALLBACKS")
    return json_text({"data": raw.to_dict(), **rest}).encode()


def _record_drift_stat(name: str, stat_fn) -> None:
    """Feed one reconstruction-error observation of model ``name`` to the
    drift detector. Computed only when the detector's gate is open, and
    never allowed to fail the request."""
    if not drift.enabled():
        return
    try:
        stat = stat_fn()
        if stat is not None:
            drift.observe(name, float(stat))
    except Exception:  # noqa: BLE001 -- detection is advisory
        logger.debug("drift stat computation failed for %r", name, exc_info=True)


def _base_reconstruction_stat(tags: List[str], target_tags: List[str], X: np.ndarray, output):
    """Mean absolute reconstruction error of a base predict: |output - the
    input's target columns|, aligned to the output's last rows for a
    windowed model. When the output does not map onto input columns, the
    mean |output|: any stable per-request scalar supports shift detection."""
    out = np.asarray(output, dtype=float)
    if out.ndim != 2 or out.size == 0:
        return None
    offset = len(X) - len(out)
    if offset >= 0 and out.shape[1] == len(target_tags):
        try:
            cols = [tags.index(tag) for tag in target_tags]
        except ValueError:
            cols = None
        if cols is not None:
            target = np.asarray(X, dtype=float)[offset:, cols]
            if target.shape == out.shape:
                return float(np.nanmean(np.abs(out - target)))
    return float(np.nanmean(np.abs(out)))


def _anomaly_total_stat(frame: RawFrame):
    """The mean of the anomaly frame's ``total-anomaly-unscaled`` block, the
    calibrated per-point reconstruction error every diff-based detector
    emits."""
    for top, _subs, values in frame.groups:
        if top == "total-anomaly-unscaled":
            return float(np.nanmean(np.asarray(values, dtype=float)))
    return None


def anomaly_prediction_core(model, body: Optional[bytes], tags: List[str],
                            target_tags: List[str], frequency, all_columns: bool,
                            fast: bool = False, timings: Optional[Dict[str, float]] = None,
                            name: str = "", breaker=None) -> Tuple[int, dict]:
    """``(status, body)`` of one anomaly request (its body's bytes, None
    when it was not sent as JSON) against ``model`` (a detector) named
    ``name``, the frame unencoded in ``"data"``; ``fast`` parses the body
    natively where it can. The decode and predict phases are timed into
    ``timings``; the predict's outcome goes to ``breaker``. An error the
    predict does not map to a status is recorded and re-raised (the
    server's 500)."""
    start_time = timeit.default_timer()
    try:
        with _phase(timings, "decode"):
            X, y = decode_request(body, tags, target_tags, fast)
    except ValueError as exc:
        return 400, {"message": str(exc)}
    if y is None:
        return 400, {"message": "Cannot perform anomaly detection without 'y'"}
    try:
        with _phase(timings, "predict"):
            faults.fault_point("serve_predict", machine=name)
            resilience.check_deadline("preflight")
            frame = model.anomaly_raw(X, y, frequency=frequency)
    except resilience.DeadlineExceeded as exc:
        logger.warning("Deadline exceeded predicting %r: %s", name, exc)
        return 504, {"error": str(exc)}
    except AttributeError as exc:
        return 422, {"message": f"Model is not complete; cannot compute anomalies: {exc}"}
    except faults.NonFiniteDataError as exc:
        resilience.record_breaker_failure(breaker, exc)
        logger.error("Non-finite output predicting %r: %s", name, exc)
        return 500, {"error": str(exc)}
    except Exception as exc:
        resilience.record_breaker_failure(breaker, exc)
        raise
    resilience.record_breaker_success(breaker)
    # before the smoothing blocks are dropped off the frame
    _record_drift_stat(name, lambda: _anomaly_total_stat(frame))
    if not all_columns:
        drop = [c for c in frame.top_levels() if c in DELETED_FROM_RESPONSE_COLUMNS]
        frame = frame.drop_top_level(drop)
    return 200, {
        "data": frame,
        "time-seconds": f"{timeit.default_timer() - start_time:.4f}",
    }


def base_prediction_core(model, body: Optional[bytes], tags: List[str],
                         target_tags: List[str], frequency, fast: bool = False,
                         timings: Optional[Dict[str, float]] = None, name: str = "",
                         breaker=None) -> Tuple[int, dict]:
    """``(status, body)`` of one base request against ``model`` named
    ``name``: the ``model-input`` and ``model-output`` blocks, unencoded in
    ``"data"``. A ValueError of the predict is answered 400 with its
    message, any other error 400 with a generic one, as the JAX package
    answers them; a spent deadline 504 and a non-finite output 500. The
    decode and predict phases are timed into ``timings``; the predict's
    outcome goes to ``breaker``."""
    try:
        with _phase(timings, "decode"):
            X, _ = decode_request(body, tags, target_tags, fast)
    except ValueError as exc:
        return 400, {"message": str(exc)}
    start = timeit.default_timer()
    try:
        with _phase(timings, "predict"):
            faults.fault_point("serve_predict", machine=name)
            X = faults.maybe_poison(name, X, site="serve_poison_nan")
            # the decode may have eaten the whole budget: fail before compute
            resilience.check_deadline("preflight")
            output = get_model_output(model, X)
            resilience.check_output_finite(output, name)
    except resilience.DeadlineExceeded as err:
        logger.warning("Deadline exceeded predicting %r: %s", name, err)
        return 504, {"error": str(err)}
    except faults.NonFiniteDataError as err:
        # a model fault (a poisoned artifact), not the client's data: 500,
        # and the breaker counts it
        resilience.record_breaker_failure(breaker, err)
        logger.error("Non-finite output predicting %r: %s", name, err)
        return 500, {"error": str(err)}
    except ValueError as err:
        logger.error("Failed to predict: %s", err, exc_info=True)
        return 400, {"error": f"ValueError: {err}"}
    except Exception as err:  # noqa: BLE001 -- answered 400, as the JAX server does
        resilience.record_breaker_failure(breaker, err)
        logger.exception("Failed to predict")
        return 400, {"error": "Something unexpected happened; check your input data"}
    resilience.record_breaker_success(breaker)
    _record_drift_stat(name, lambda: _base_reconstruction_stat(tags, target_tags, X.values,
                                                               output))
    data = make_base_raw(tags, X.values, output, target_tags, X.index, frequency)
    return 200, {
        "data": data,
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
