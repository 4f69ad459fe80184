"""
Datasets without pandas: the port's counterpart of the registry,
``InsufficientDataError``, ``TimeSeriesDataset`` and ``RandomDataset`` in
``gordo_tpu/dataset/datasets.py``.

``get_data`` joins every tag and target tag on one time grid: each series
is resampled as pandas' ``resample(resolution).agg(method)`` does, the
columns are joined on the union of their grids, gaps are filled as pandas'
``interpolate(method="linear", limit=k)`` fills them, rows that still hold
a NaN are dropped, and the ``row_filter`` (a pandas query expression,
dataset/row_filter.py) keeps its rows. X and y come back as :class:`Frame` s
with a datetime64[ns] (UTC) index and the time zone to read it in.

A fixed resolution ("10min", "1h", "D") buckets from the midnight of the
first sample's day in the index's own time zone, closed and labelled on the
left, by the native library's one-pass kernel (native/``gordo_resample``),
as the JAX dataset's native path does. A calendar one buckets on local
calendar edges, in numpy: ``W`` (``W-SUN``) and ``W-MON`` ... ``W-SAT``
weeks labelled by their last day, ``MS`` months labelled by their first and
``ME`` months by their last day. Other aliases are refused by name. The
interpolation limit is ``interpolation_limit`` over the resolution where
pandas reads the resolution as a ``Timedelta`` (a number and a fixed unit),
else over the median spacing of the joined grid, as the JAX dataset takes it.
"""

import abc
import re
import time
from datetime import date, datetime, time as clock, timedelta, tzinfo
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import native
from ..models.utils import Frame
from .data_provider import (
    GordoBaseDataProvider, RandomDataProvider, Series, datetime_ns, resolution_ns,
)
from .row_filter import RowFilter
from .sensor_tag import normalize_sensor_tags

_DATASET_REGISTRY: Dict[str, type] = {}
_DAY_NS = 86_400 * 1_000_000_000
AGGREGATIONS = ("mean", "min", "max", "sum", "count", "median")


class InsufficientDataError(ValueError):
    """Raised when fewer rows survive joining/filtering than the threshold."""


def register_dataset(cls):
    _DATASET_REGISTRY[cls.__name__] = cls
    return cls


class GordoBaseDataset(abc.ABC):
    @abc.abstractmethod
    def get_data(self) -> Tuple[Frame, Frame]:
        """Return (X, y) frames indexed by timestamp."""

    @abc.abstractmethod
    def get_metadata(self) -> dict:
        """Return dataset build metadata (row counts, durations, tag list...)."""

    @classmethod
    def from_dict(cls, config: dict) -> "GordoBaseDataset":
        config = dict(config)
        kind = config.pop("type", "TimeSeriesDataset").rsplit(".", 1)[-1]
        if kind not in _DATASET_REGISTRY:
            raise ValueError(
                f"Unknown dataset type {kind!r}; available: {sorted(_DATASET_REGISTRY)}"
            )
        return _DATASET_REGISTRY[kind](**config)

    def to_dict(self) -> dict:
        out = dict(getattr(self, "_init_kwargs", {}))
        out["type"] = type(self).__name__
        return out


def _parse_dt(value: Union[str, datetime]) -> datetime:
    ts = value if isinstance(value, datetime) else datetime.fromisoformat(str(value))
    if ts.tzinfo is None:
        raise ValueError(f"Datetime {value!r} must be timezone-aware")
    return ts


_CALENDAR = re.compile(r"\s*(?:(W)(?:-(SUN|MON|TUE|WED|THU|FRI|SAT))?|(MS)|(ME))\s*")
_WEEKDAYS = ("MON", "TUE", "WED", "THU", "FRI", "SAT", "SUN")
_FIXED_TIMEDELTA = re.compile(r"\s*\d+\s*[A-Za-z]+\s*")


def bucket_of(resolution: str) -> Union[int, str]:
    """A dataset resolution as its bucket: nanoseconds for a fixed alias, the
    alias itself for a calendar one (module docstring); ValueError for what
    neither is."""
    try:
        return resolution_ns(resolution)
    except ValueError:
        if _CALENDAR.fullmatch(str(resolution)):
            return str(resolution).strip()
        raise ValueError(f"Unsupported resolution {resolution!r}: a fixed alias "
                         f"('10min', '1h', 'D') or W, W-<day>, MS or ME") from None


def _month_start(day: date, months: int = 0) -> date:
    index = day.year * 12 + day.month - 1 + months
    return date(index // 12, index % 12 + 1, 1)


def calendar_edges(first_ns: int, last_ns: int, alias: str, tz: tzinfo
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The buckets of a calendar alias that cover [first_ns, last_ns]:
    their edges (one more than buckets, UTC nanoseconds of local midnights)
    and their labels, as pandas' resample bins and labels them."""
    week, anchor, month_start, month_end = _CALENDAR.fullmatch(alias).groups()
    first = datetime.fromtimestamp(first_ns // 1_000_000_000, tz).date()
    last = datetime.fromtimestamp(last_ns // 1_000_000_000, tz).date()
    if week:
        weekday = _WEEKDAYS.index(anchor or "SUN")
        start = first + timedelta(days=(weekday - first.weekday()) % 7 - 6)
        n = (last - start).days // 7 + 1
        days = [start + timedelta(days=7 * k) for k in range(n + 1)]
        labels = [d + timedelta(days=6) for d in days[:-1]]
    else:
        months = (last.year - first.year) * 12 + last.month - first.month + 1
        days = [_month_start(first, k) for k in range(months + 1)]
        labels = (days[:-1] if month_start
                  else [d - timedelta(days=1) for d in days[1:]])
    edges = np.array([_local_ns(d, tz) for d in days], np.int64)
    return edges, np.array([_local_ns(d, tz) for d in labels], np.int64)


def _local_ns(day: date, tz: tzinfo) -> int:
    """UTC nanoseconds of ``day``'s midnight in ``tz``."""
    return datetime_ns(datetime.combine(day, clock(0), tzinfo=tz))


def resample(series: Series, bucket: Union[int, str], methods: Sequence[str]
             ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """``series.resample(resolution).agg(method)`` for each of ``methods``, as
    pandas computes it: ``(grid, [column per method])``, the grid from the
    first sample's bucket to the last one's, in datetime64[ns] UTC. Empty
    buckets give NaN, but 0 for ``sum`` and ``count``. ``bucket`` is
    :func:`bucket_of`'s: nanoseconds, whose origin is the midnight of the
    first sample's day where the index's time zone has it (for a fixed
    offset that the bucket does not divide this moves every bucket edge),
    aggregated by the native kernel; or a calendar alias."""
    unknown = [m for m in methods if m not in AGGREGATIONS]
    if unknown:
        raise ValueError(f"Unsupported aggregation methods {unknown}; ported: {AGGREGATIONS}")
    ts = np.asarray(series.index, "datetime64[ns]").view(np.int64)
    values = np.asarray(series.values, np.float64)
    if len(ts) == 0:
        return np.empty(0, "datetime64[ns]"), [np.empty(0) for _ in methods]
    if np.any(ts[1:] < ts[:-1]):
        order = np.argsort(ts, kind="stable")
        ts, values = ts[order], values[order]
    if isinstance(bucket, str):
        edges, labels = calendar_edges(int(ts[0]), int(ts[-1]), bucket, series.tz)
        pos = np.searchsorted(edges, ts, side="right") - 1
        first, last = pos[0], pos[-1]
        return (labels[first:last + 1].view("datetime64[ns]"),
                _aggregate(pos - first, values, int(last - first + 1), methods))
    first = datetime.fromtimestamp(int(ts[0]) // 1_000_000_000, series.tz)
    offset_ns = first.utcoffset() // timedelta(microseconds=1) * 1_000
    local = int(ts[0]) + offset_ns
    origin = local - local % _DAY_NS - offset_ns
    b0, b1 = (int(ts[0]) - origin) // bucket, (int(ts[-1]) - origin) // bucket
    n = b1 - b0 + 1
    start = origin + bucket * b0
    grid = (start + bucket * np.arange(n, dtype=np.int64)).view("datetime64[ns]")
    return grid, list(native.resample(ts, values, start, bucket, n, methods))


def _aggregate(pos: np.ndarray, values: np.ndarray, n: int, methods: Sequence[str]
               ) -> List[np.ndarray]:
    """Each of ``methods`` over the values of each bucket ``pos`` assigns,
    NaNs skipped (the calendar buckets' numpy path)."""
    valid = ~np.isnan(values)
    pos, vals = pos[valid], values[valid]
    count = np.bincount(pos, minlength=n)
    columns = []
    for method in methods:
        if method == "count":
            col = count.astype(np.float64)
        elif method in ("sum", "mean"):
            col = np.bincount(pos, weights=vals, minlength=n)
            if method == "mean":
                col = np.divide(col, count, out=np.full(n, np.nan), where=count > 0)
        elif method in ("min", "max"):
            col = np.full(n, np.nan)
            (np.fmin if method == "min" else np.fmax).at(col, pos, vals)
        else:  # median: the middle of each bucket's sorted values
            ordered = np.append(vals[np.lexsort((vals, pos))], np.nan)
            starts = np.cumsum(count) - count
            upper = ordered[np.where(count > 0, starts + count // 2, -1)]
            lower = ordered[np.where(count > 0, starts + (count - 1) // 2, -1)]
            col = (lower + upper) / 2
        columns.append(col)
    return columns


def interpolate_linear(values: np.ndarray, limit: int) -> np.ndarray:
    """pandas ``interpolate(method="linear", limit=limit)`` along axis 0 of
    a 2-D array: each NaN is interpolated between its neighbours by row
    position (after the last valid value it takes that value), at most
    ``limit`` into each run of NaNs, and leading NaNs stay."""
    out = np.array(values, np.float64)
    rows = np.arange(len(out))
    for column in out.T:
        invalid = np.isnan(column)
        if invalid.all() or not invalid.any():
            continue
        filled = np.interp(rows[invalid], rows[~invalid], column[~invalid])
        # a NaN's place in its run: preserved past the limit, and before the first value
        run = np.cumsum(invalid) - np.maximum.accumulate(np.where(~invalid, np.cumsum(invalid), 0))
        keep = (run[invalid] > limit) | (rows[invalid] < np.argmax(~invalid))
        column[invalid] = np.where(keep, np.nan, filled)
    return out


def _join(grids: List[np.ndarray], columns: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Columns on their grids joined on the union of the grids (the outer
    join of ``pd.DataFrame({name: series})``), NaN where one lacks a row."""
    index = np.unique(np.concatenate(grids)) if grids else np.empty(0, "datetime64[ns]")
    table = np.full((len(index), len(columns)), np.nan)
    for j, (grid, column) in enumerate(zip(grids, columns)):
        table[np.searchsorted(index, grid), j] = column
    return index, table


@register_dataset
class TimeSeriesDataset(GordoBaseDataset):
    """Join per-tag series onto a resampled grid and emit (X, y)."""

    def __init__(
        self,
        train_start_date: Union[str, datetime],
        train_end_date: Union[str, datetime],
        tag_list: Optional[List] = None,
        tags: Optional[List] = None,
        target_tag_list: Optional[List] = None,
        data_provider: Optional[Union[dict, GordoBaseDataProvider]] = None,
        resolution: str = "10min",
        row_filter: str = "",
        aggregation_methods: Union[str, List[str]] = "mean",
        n_samples_threshold: int = 0,
        asset: Optional[str] = None,
        interpolation_method: str = "linear_interpolation",
        interpolation_limit: str = "8h",
        **kwargs,
    ):
        tags = tags if tags is not None else tag_list
        if not tags:
            raise ValueError("TimeSeriesDataset requires a non-empty 'tags' list")
        self.train_start_date = _parse_dt(train_start_date)
        self.train_end_date = _parse_dt(train_end_date)
        if self.train_start_date >= self.train_end_date:
            raise ValueError(
                f"train_start_date ({self.train_start_date}) must be before "
                f"train_end_date ({self.train_end_date})"
            )
        self.asset = asset
        self.tag_list = normalize_sensor_tags(tags, asset=asset)
        self.target_tag_list = (
            normalize_sensor_tags(target_tag_list, asset=asset)
            if target_tag_list else list(self.tag_list)
        )
        if isinstance(data_provider, GordoBaseDataProvider):
            self.data_provider = data_provider
        elif isinstance(data_provider, dict):
            self.data_provider = GordoBaseDataProvider.from_dict(data_provider)
        elif data_provider is None:
            self.data_provider = RandomDataProvider()
        else:
            raise ValueError(f"Invalid data_provider: {data_provider!r}")
        self.resolution = resolution
        self.row_filter = row_filter
        self.aggregation_methods = aggregation_methods
        self.n_samples_threshold = n_samples_threshold
        self.interpolation_method = interpolation_method
        self.interpolation_limit = interpolation_limit
        self._metadata: dict = {}
        # both checked now, before any data is read
        self._bucket = bucket_of(resolution)
        self._row_filter = (
            RowFilter(row_filter, self._column_names(
                list(dict.fromkeys(self.tag_list + self.target_tag_list))))
            if row_filter else None
        )

        self._init_kwargs = dict(
            train_start_date=self.train_start_date.isoformat(),
            train_end_date=self.train_end_date.isoformat(),
            tags=[t.to_json() for t in self.tag_list],
            target_tag_list=[t.to_json() for t in self.target_tag_list],
            data_provider=self.data_provider.to_dict(),
            resolution=resolution,
            row_filter=row_filter,
            aggregation_methods=aggregation_methods,
            n_samples_threshold=n_samples_threshold,
            asset=asset,
            interpolation_method=interpolation_method,
            interpolation_limit=interpolation_limit,
        )

    def _column_names(self, tags) -> List[str]:
        if isinstance(self.aggregation_methods, (list, tuple)):
            return [f"{t.name}_{m}" for t in tags for m in self.aggregation_methods]
        return [t.name for t in tags]

    def _join_series(self):
        """(index, table, column names, time zone) of every tag after the
        resample, the join, the interpolation, the dropping of NaN rows and
        the row filter."""
        t0 = time.monotonic()
        all_tags = list(dict.fromkeys(self.tag_list + self.target_tag_list))
        methods = (
            [self.aggregation_methods] if isinstance(self.aggregation_methods, str)
            else list(self.aggregation_methods)
        )
        grids, columns, tz = [], [], self.train_start_date.tzinfo
        for series in self.data_provider.load_series(
            self.train_start_date, self.train_end_date, all_tags
        ):
            grid, resampled = resample(series, self._bucket, methods)
            grids.extend([grid] * len(resampled))
            columns.extend(resampled)
            tz = series.tz
        index, table = _join(grids, columns)
        if self.interpolation_method == "linear_interpolation":
            table = interpolate_linear(table, self._interpolation_limit(index))
        keep = ~np.isnan(table).any(axis=1)
        index, table = index[keep], table[keep]
        if self._row_filter is not None:
            keep = self._row_filter.mask(table)
            index, table = index[keep], table[keep]
        self._metadata["query_duration_sec"] = time.monotonic() - t0
        return index, table, self._column_names(all_tags), tz

    def _interpolation_limit(self, index: np.ndarray) -> int:
        """``interpolation_limit`` in buckets: over the resolution where
        pandas reads it as a Timedelta (a number and a fixed unit), else over
        the median spacing of the joined grid; 1 where that is not positive."""
        if _FIXED_TIMEDELTA.fullmatch(str(self.resolution)) and isinstance(self._bucket, int):
            step = self._bucket
        else:
            diffs = np.diff(index.view(np.int64))
            step = float(np.median(diffs)) if len(diffs) else 0.0
        if step <= 0:
            return 1
        return max(int(resolution_ns(self.interpolation_limit) / step), 1)

    def get_data(self) -> Tuple[Frame, Frame]:
        index, table, names, tz = self._join_series()
        if len(index) <= self.n_samples_threshold:
            raise InsufficientDataError(
                f"Only {len(index)} rows after joining/filtering; "
                f"threshold is {self.n_samples_threshold}"
            )

        def frame(tags):
            cols = self._column_names(tags)
            return Frame(table[:, [names.index(c) for c in cols]], cols, index, tz)

        X, y = frame(self.tag_list), frame(self.target_tag_list)
        self._metadata["dataset_meta"] = {
            "row_count": int(len(index)),
            "x_hist": {},
            "tag_loading_metadata": {
                "tags": {t.name: t.to_json() for t in self.tag_list},
            },
        }
        return X, y

    def get_metadata(self) -> dict:
        meta = {
            "train_start_date": self.train_start_date.isoformat(),
            "train_end_date": self.train_end_date.isoformat(),
            "tag_list": [t.to_json() for t in self.tag_list],
            "target_tag_list": [t.to_json() for t in self.target_tag_list],
            "resolution": self.resolution,
            "row_filter": self.row_filter,
        }
        meta.update(self._metadata)
        return meta


@register_dataset
class RandomDataset(TimeSeriesDataset):
    """TimeSeriesDataset pinned to the deterministic RandomDataProvider."""

    def __init__(self, train_start_date, train_end_date, tag_list=None, tags=None, **kwargs):
        kwargs.pop("data_provider", None)
        super().__init__(
            train_start_date=train_start_date,
            train_end_date=train_end_date,
            tag_list=tag_list,
            tags=tags,
            data_provider=RandomDataProvider(),
            **kwargs,
        )
