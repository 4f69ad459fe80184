"""
The serving codec's native lane: the port's counterpart of
``gordo_tpu/server/fast_codec.py``, on the port's :class:`Frame` and
:class:`RawFrame` instead of pandas.

- decode: :func:`decode_body_xy` parses a request body in one native pass
  (``native.parse_xy``, ``native.parse_columns``) straight from the socket
  bytes into float64 frames, for the rectangular ``{"X": [[...]], "y":
  [[...]]}`` and the flat column-dict ``{"X": {tag: {key: value}}}``
  bodies. Every other body returns None and takes ``json`` and
  ``views.decode_frame``, which give the same frames for the bodies the
  native lane takes.
- encode: :func:`encode_raw` renders a response's ``"data"`` from a
  :class:`RawFrame` with the native template encoder: the JSON structure
  (braces, keys, the start/end columns) is built once per response
  signature as a byte template with a slot per float, and the floats are
  formatted in C as ``repr`` formats them. The first render of each
  template is compared byte for byte with the dict path
  (``json.dumps`` of ``RawFrame.to_dict()``); a mismatch poisons the native
  encoder for the process, and every later response takes the dict path.
  :func:`splice_response_body` joins the fragment and the rest of the body
  with the separators ``json.dumps`` writes.

Gate: ``GORDO_TPU_FAST_CODEC`` (on unless ``0``/``false``/``no``); with it
on, a request with the header ``X-Gordo-Codec: pandas`` takes the dict
path (the JAX package's name for its pandas path).

Counting: :func:`count` feeds the catalog's ``gordo_server_fast_codec_total``
and ``gordo_server_fast_codec_fallback_total`` (``op`` ``decode`` or
``encode``; a native parse counts once a frame, X and y, as the JAX views
count it), and the module attributes below, which tests read per run
(``POISONINGS`` has no catalog series).
"""

import functools
import json
import logging
import os
import threading
from datetime import datetime
from typing import Optional

import numpy as np

from .. import native
from ..models.utils import Frame, RawFrame, timestamp_columns
from ..observability import metrics as metric_catalog

logger = logging.getLogger(__name__)

# json.dumps' own string escaper: template keys are written as it writes them
_escape = json.encoder.encode_basestring_ascii

# request bodies parsed natively, responses encoded natively, requests of the
# codec that took the dict path (parse or encode), and native-encoder poisonings
NATIVE_PARSES = 0
NATIVE_ENCODES = 0
PARSE_FALLBACKS = 0
ENCODE_FALLBACKS = 0
POISONINGS = 0
COUNTERS = ("NATIVE_PARSES", "NATIVE_ENCODES", "PARSE_FALLBACKS", "ENCODE_FALLBACKS",
            "POISONINGS")
_count_lock = threading.Lock()
# each attribute's catalog series (None: the attribute alone)
_SERIES = {
    "NATIVE_PARSES": metric_catalog.FAST_CODEC.labels(op="decode"),
    "NATIVE_ENCODES": metric_catalog.FAST_CODEC.labels(op="encode"),
    "PARSE_FALLBACKS": metric_catalog.FAST_CODEC_FALLBACK.labels(op="decode"),
    "ENCODE_FALLBACKS": metric_catalog.FAST_CODEC_FALLBACK.labels(op="encode"),
    "POISONINGS": None,
}


def count(name: str, frames: int = 1) -> None:
    """Add one to the counter ``name`` (one of :data:`COUNTERS`), and
    ``frames`` to its catalog series."""
    with _count_lock:
        globals()[name] += 1
    series = _SERIES[name]
    if series is not None and frames:
        series.inc(frames)


def loads(body):
    """A JSON request body (bytes, bytearray, memoryview or str) parsed by
    the standard library's C decoder; ValueError if it is not JSON."""
    if isinstance(body, memoryview):
        body = bytes(body)
    return json.loads(body)


def enabled() -> bool:
    """``GORDO_TPU_FAST_CODEC``: on unless set to 0, false or no."""
    return os.environ.get("GORDO_TPU_FAST_CODEC", "1").lower() not in ("0", "false", "no")


def request_enabled(headers) -> bool:
    """Whether this request takes the native lane: the gate, less a request
    that asks for the dict path with ``X-Gordo-Codec: pandas``. With the
    gate off no header turns the lane on."""
    if not enabled():
        return False
    return (headers.get("X-Gordo-Codec") or "").lower() != "pandas"


# ------------------------------------------------------------------ decode
def _sorted_frame(values: np.ndarray, columns, labels) -> Optional[Frame]:
    """The frame ``views.decode_frame`` makes of these labels: ISO
    timestamps, else integers, rows sorted by them; None where it would
    raise (the dict path then gives the error)."""
    try:
        index = [datetime.fromisoformat(label) for label in labels]
    except (TypeError, ValueError):
        try:
            index = [int(label) for label in labels]
        except (TypeError, ValueError):
            return None
    try:
        order = sorted(range(len(index)), key=index.__getitem__)
    except TypeError:  # naive and aware timestamps mixed
        return None
    return Frame(values[order], columns, [index[i] for i in order])


def decode_body_xy(body):
    """``(X, y)`` frames of a request body in one native pass (y None when
    the body has none), or None when the body is of neither strict grammar.
    The rectangular body gives frames with integer columns and rows, as
    ``decode_frame`` reads a list of lists; the column-dict body gives the
    columns in the body's order and the rows sorted by their parsed keys."""
    if not isinstance(body, (bytes, bytearray, memoryview)):
        return None
    parsed = native.parse_xy(body)
    if parsed is not None:
        X, y = parsed
        if X.shape[0] == 0 or (y is not None and y.shape[0] == 0):
            return None  # decode_frame reads an empty list as zero columns
        frames = [None if a is None else Frame(a, range(a.shape[1]), range(a.shape[0]))
                  for a in (X, y)]
        return frames[0], frames[1]
    cols = native.parse_columns(body)
    if cols is None:
        return None
    values, names, keys = cols
    X = _sorted_frame(values, names, keys)
    return None if X is None else (X, None)


# ------------------------------------------------------------------ encode
def _index_keys(index) -> list:
    """Row keys as ``RawFrame.to_dict`` writes them: ``str`` of each time,
    else the labels themselves (JSON writes an integer key as its digits)."""
    if index and all(isinstance(ts, datetime) for ts in index):
        return [str(ts) for ts in index]
    return list(index)


def _build_template(sig: tuple, keys: tuple, start, end):
    """(template bytes, chunk lengths) for the groups ``sig = ((top, (sub,
    ...)), ...)`` over the row ``keys`` (strings); ``start``/``end`` are
    the time columns' values (None where a row has none). Every column
    repeats one run of row-key chunks, so the chunks are built per row once
    and per column only where a column opens."""
    esc_keys = [_escape(k) for k in keys]

    def _obj(col) -> str:
        return "{" + ", ".join(
            f"{ek}: " + ("null" if v is None else _escape(v)) for ek, v in zip(esc_keys, col)
        ) + "}"

    first = f"{esc_keys[0]}: "
    rest = [f", {ek}: " for ek in esc_keys[1:]]
    chunks: list = []  # static text; chunks[i] precedes value i
    lead = f'{{"start": {{"": {_obj(start)}}}, "end": {{"": {_obj(end)}}}'
    for top, subs in sig:
        lead += f", {_escape(top)}: {{"
        for j, sub in enumerate(subs):
            if j:
                lead += ", "
            chunks.append(f"{lead}{_escape(sub)}: {{{first}")
            chunks.extend(rest)
            lead = "}"  # closes the column
        lead += "}"  # closes the group
    chunks.append(lead + "}")  # after the last value
    # ASCII text, so a chunk's bytes are its characters
    return ("".join(chunks).encode("ascii"),
            np.fromiter(map(len, chunks), np.int32, len(chunks)))


@functools.lru_cache(maxsize=64)
def _run_template(sig: tuple, first: int, n: int):
    """The template of a response over the integer rows first..first+n-1
    (no times): every such response of one signature shares it."""
    keys = tuple(str(i) for i in range(first, first + n))
    return _build_template(sig, keys, (None,) * n, (None,) * n)


_native_checked: set = set()
_native_poisoned = False


def _dict_fragment(raw: RawFrame) -> str:
    """The dict path's ``"data"``: ``json.dumps`` of ``to_dict()``, whose
    non-finite values are already None."""
    return json.dumps(raw.to_dict())


def encode_raw(raw: RawFrame) -> Optional[str]:
    """The response's ``"data"`` JSON, byte-identical to the dict path's,
    from the native template encoder; None where the frame is not of the
    template's shape (float groups of string names over unique rows, no
    group named start or end, none repeated or empty) or the encoder is
    poisoned, and the caller takes the dict path."""
    global _native_poisoned
    if _native_poisoned:
        return None
    index = raw.index
    keys = _index_keys(index)
    if not keys or len(set(keys)) != len(keys):
        return None
    sig_items, blocks = [], []
    for top, subs, values in raw.groups:
        values = np.asarray(values)
        if (type(top) is not str or values.ndim != 2 or values.dtype.kind != "f"
                or values.shape != (len(keys), len(subs)) or len(subs) == 0
                or any(type(sub) is not str for sub in subs)):
            return None
        sig_items.append((top, tuple(subs)))
        blocks.append(values)
    tops = [top for top, _ in sig_items]
    if not tops or len(set(tops)) != len(tops) or "start" in tops or "end" in tops:
        return None
    sig = tuple(sig_items)
    if all(type(k) is int for k in keys) and keys == list(range(keys[0], keys[0] + len(keys))):
        template, pre_lens = _run_template(sig, keys[0], len(keys))
        shape_key = (sig, keys[0], len(keys))
    else:
        start, end = timestamp_columns(index, raw.frequency)
        template, pre_lens = _build_template(sig, tuple(str(k) for k in keys), start, end)
        shape_key = (sig, len(keys), "keyed")
    # column by column within each group, as the template nests its keys
    values = np.concatenate([v.T.astype(np.float64, copy=False).ravel() for v in blocks])
    rendered = native.encode_template(template, pre_lens, values)
    if rendered is None:
        return None
    fragment = rendered.decode("ascii")
    if shape_key not in _native_checked:
        # the first render of a template: byte-compared with the dict path
        _native_checked.add(shape_key)
        if fragment != _dict_fragment(raw):
            _native_poisoned = True
            count("POISONINGS")
            logger.error("native template encoder disagrees with the dict path for %r "
                         "(%d rows); native encode is off for this process", tops, len(keys))
            return None
    return fragment


def splice_response_body(data_fragment: str, rest_json: str) -> str:
    """``{"data": <fragment>, <rest...>}`` from the encoded fragment and the
    JSON of the body's other fields, with ``json.dumps``' separators."""
    if rest_json == "{}":
        return '{"data": ' + data_fragment + "}"
    return '{"data": ' + data_fragment + ", " + rest_json[1:]
