"""
Request and response frames without pandas.

:class:`Frame` is a decoded request frame (values, tag columns, time
index). :class:`RawFrame` is the port's counterpart of the JAX package's
``RawFrame`` (``gordo_tpu/models/utils.py``): named column groups over one
index, whose :meth:`RawFrame.to_dict` emits exactly the layout of
``dataframe_to_dict`` (``gordo_tpu/server/utils.py``) applied to the
assembled response frame: ``start``/``end`` time columns, then one
``{top: {sub: {index_key: value}}}`` block per group. :func:`make_base_raw`
makes the base route's groups. :meth:`RawFrame.from_dict` reads that layout
back, as the JAX client's ``dataframe_from_dict`` reads a response, and
:meth:`RawFrame.concat` joins a client's batches, as ``pd.concat(frames)
.sort_index()`` does.
"""

import functools
import math
import re
from datetime import datetime, timedelta, tzinfo
from typing import List, Optional, Sequence

import numpy as np


class Frame:
    """A 2-D float block with tag columns and a row index: datetimes, or
    integers for unlabelled rows, or a datetime64[ns] array in UTC read in
    the time zone ``tz`` (a dataset's frames)."""

    __slots__ = ("values", "columns", "index", "tz")

    def __init__(self, values: np.ndarray, columns: Sequence[str], index: Sequence,
                 tz: Optional[tzinfo] = None):
        self.values = np.asarray(values, np.float64)
        self.columns = list(columns)
        self.index = index if isinstance(index, np.ndarray) else list(index)
        self.tz = tz
        if self.values.shape != (len(self.index), len(self.columns)):
            raise ValueError(
                f"values of shape {self.values.shape} for {len(self.index)} rows "
                f"and {len(self.columns)} columns"
            )

    def to_dict(self) -> dict:
        """``{column: {index key: value}}``, the layout ``dataframe_to_dict``
        gives a frame with one level of columns: a request body's X or y."""
        keys = [index_label(self, row) for row in range(len(self.index))]
        return {column: dict(zip(keys, values))
                for column, values in zip(self.columns, self.values.T.tolist())}


def _is_time_index(index) -> bool:
    return bool(index) and all(isinstance(ts, datetime) for ts in index)


def timestamp_columns(index, frequency: Optional[timedelta]):
    """('start', 'end') isoformat column values for a response frame."""
    if not _is_time_index(index):
        return [None] * len(index), [None] * len(index)
    start = [ts.isoformat() for ts in index]
    if frequency is None:
        return start, [None] * len(index)
    return start, [(ts + frequency).isoformat() for ts in index]


_TICKS = {
    "D": timedelta(days=1), "H": timedelta(hours=1), "h": timedelta(hours=1),
    "T": timedelta(minutes=1), "min": timedelta(minutes=1),
    "S": timedelta(seconds=1), "s": timedelta(seconds=1),
    "L": timedelta(milliseconds=1), "ms": timedelta(milliseconds=1),
    "U": timedelta(microseconds=1), "us": timedelta(microseconds=1),
}


def parse_resolution(resolution: str) -> timedelta:
    """A fixed-length pandas offset alias ("10min", "10T", "1H", "30s") as
    a timedelta."""
    match = re.fullmatch(r"\s*(\d*)\s*([A-Za-z]+)\s*", str(resolution))
    if not match or match.group(2) not in _TICKS:
        raise ValueError(f"Unsupported resolution {resolution!r}")
    return int(match.group(1) or 1) * _TICKS[match.group(2)]


def index_label(frame: Frame, row: int) -> str:
    """Row ``row``'s time as ``str(pd.Timestamp)`` renders it, in the
    frame's time zone: ``"2020-01-01 00:00:00+00:00"``."""
    ts = frame.index[row]
    if isinstance(ts, np.datetime64):
        us = int(ts.astype("datetime64[us]").astype(np.int64))
        ts = datetime.fromtimestamp(us // 1_000_000, frame.tz).replace(microsecond=us % 1_000_000)
    return str(ts)


def _json_value(x):
    return x if isinstance(x, float) and math.isfinite(x) else None


class RawFrame:
    """Named column groups over one shared index: ``groups`` is a list of
    ``(top_name, sub_names, values)`` with values shaped
    ``(n_rows, len(sub_names))``; scalar groups use ``sub_names ("",)``."""

    __slots__ = ("groups", "index", "frequency")

    def __init__(self, groups, index, frequency: Optional[timedelta] = None):
        self.groups = groups
        self.index = list(index)
        self.frequency = frequency

    def __len__(self) -> int:
        return len(self.index)

    def top_levels(self) -> List[str]:
        return [top for top, _, _ in self.groups]

    @classmethod
    def from_dict(cls, data: dict) -> "RawFrame":
        """The frame of a ``dataframe_to_dict`` layout (what :meth:`to_dict`
        writes), as the JAX client's ``dataframe_from_dict`` reads a
        response's ``data``: index keys as tz-aware times where every one is
        an ISO timestamp, else as integers; rows sorted by index; null as
        NaN. The ``start`` and ``end`` blocks give the frequency back (None
        where ``end`` is null); every other block is a group of floats."""
        columns = [(top, sub, column) for top, block in data.items()
                   for sub, column in block.items()]
        if not columns:
            raise ValueError("a frame without columns")
        keys = list(columns[0][2])
        if any(list(column) != keys for _, _, column in columns):
            raise ValueError("the columns of a frame must share their index keys")
        try:
            index = [datetime.fromisoformat(key) for key in keys]
        except (TypeError, ValueError):
            index = [int(key) for key in keys]
        frequency = None
        times = data.get("start", {}).get(""), data.get("end", {}).get("")
        if times[0] is not None and times[1] is not None and keys and None not in (
                times[0][keys[0]], times[1][keys[0]]):
            gaps = {datetime.fromisoformat(times[1][k]) - datetime.fromisoformat(times[0][k])
                    for k in keys}
            if len(gaps) != 1:
                raise ValueError(f"end - start varies over the rows: {sorted(gaps)[:3]}")
            frequency = gaps.pop()
        groups = []
        for top, block in data.items():
            if top in ("start", "end"):
                continue
            values = np.array([[np.nan if v is None else v for v in column.values()]
                               for column in block.values()], np.float64).T
            groups.append((top, list(block), values.reshape(len(keys), len(block))))
        return cls(groups, index, frequency).sort_index()

    def sort_index(self) -> "RawFrame":
        """The rows in the order of the index (stable among equal keys)."""
        order = sorted(range(len(self.index)), key=self.index.__getitem__)
        return RawFrame([(top, subs, values[order]) for top, subs, values in self.groups],
                        [self.index[i] for i in order], self.frequency)

    @classmethod
    def concat(cls, frames: Sequence["RawFrame"]) -> "RawFrame":
        """The rows of ``frames``, all of one layout, sorted by index."""
        layout = [(top, list(subs)) for top, subs, _ in frames[0].groups]
        if any([(top, list(subs)) for top, subs, _ in f.groups] != layout for f in frames):
            raise ValueError("frames of different columns cannot be joined")
        groups = [(top, subs, np.concatenate([f.groups[g][2] for f in frames]))
                  for g, (top, subs) in enumerate(layout)]
        return cls(groups, [ts for f in frames for ts in f.index],
                   frames[0].frequency).sort_index()

    def drop_top_level(self, names) -> "RawFrame":
        dropped = set(names)
        return RawFrame(
            [g for g in self.groups if g[0] not in dropped], self.index, self.frequency
        )

    def to_dict(self) -> dict:
        """The ``dataframe_to_dict`` layout. Index keys are ``str(timestamp)``
        (as pandas renders a DatetimeIndex) or the integer row labels;
        non-finite values become ``None`` (JSON null)."""
        if _is_time_index(self.index):
            keys = [str(ts) for ts in self.index]
        else:
            keys = list(self.index)
        start, end = timestamp_columns(self.index, self.frequency)
        out = {"start": {"": dict(zip(keys, start))}, "end": {"": dict(zip(keys, end))}}
        for top, subs, values in self.groups:
            block = out.setdefault(top, {})
            columns = np.asarray(values, np.float64).T.tolist()
            for sub, column in zip(subs, columns):
                block[sub] = dict(zip(keys, map(_json_value, column)))
        return out


def metric_wrapper(metric, scaler=None):
    """``metric`` made to take a model output shorter than y (a windowed
    model's: it is held against the last rows of y), with y and the output
    first scaled by ``scaler`` where one is given."""

    @functools.wraps(metric)
    def _wrapper(y_true, y_pred):
        if scaler:
            y_true = scaler.transform(y_true)
            y_pred = scaler.transform(y_pred)
        return metric(y_true[-len(y_pred):], y_pred)

    return _wrapper


def make_base_raw(tags: Sequence[str], model_input: np.ndarray, model_output: np.ndarray,
                  target_tag_list: Optional[Sequence[str]] = None, index=None,
                  frequency: Optional[timedelta] = None) -> RawFrame:
    """The base route's response groups, ``model-input`` and
    ``model-output``, as the JAX package's ``make_base_raw`` makes them:
    the input's last rows aligned to the output's length, the index's tail
    (row numbers without one), and the tags as sub-columns where the widths
    match them (else the column numbers)."""
    target_tag_list = target_tag_list if target_tag_list is not None else tags
    model_output = np.asarray(model_output)
    n = len(model_output)
    model_input = np.asarray(model_input)[-n:, :]
    index = list(index)[-n:] if index is not None else range(n)
    groups = []
    for top, values, names in (("model-input", model_input, tags),
                               ("model-output", model_output, target_tag_list)):
        if values.shape[1] == len(names):
            subs = [str(name) for name in names]
        else:
            subs = [str(i) for i in range(values.shape[1])]
        groups.append((top, subs, values))
    return RawFrame(groups, index, frequency)
