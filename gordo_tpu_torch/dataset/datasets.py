"""
Datasets without pandas: the port's counterpart of the registry,
``InsufficientDataError``, ``TimeSeriesDataset`` and ``RandomDataset`` in
``gordo_tpu/dataset/datasets.py``, with a numpy resample in place of the
JAX package's host C++ one (``gordo_tpu/native``).

``get_data`` joins every tag and target tag on one time grid: each series
is resampled as pandas' ``resample(resolution).agg(method)`` does (buckets
closed and labelled on the left from the midnight of the first sample's
day in the index's own time zone, NaNs skipped), the columns are joined on
the union of their grids, gaps are filled as pandas'
``interpolate(method="linear", limit=k)`` fills them, and rows that still
hold a NaN are dropped. X and y come back as :class:`Frame` s with a
datetime64[ns] (UTC) index and the time zone to read it in.
"""

import abc
import time
from datetime import datetime, timedelta
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..models.utils import Frame
from .data_provider import (
    GordoBaseDataProvider, RandomDataProvider, Series, resolution_ns,
)
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


def resample(series: Series, bucket_ns: int, methods: Sequence[str]
             ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """``series.resample(bucket).agg(method)`` for each of ``methods``, as
    pandas computes it: ``(grid, [column per method])``. The grid runs from
    the first sample's bucket to the last one's, in datetime64[ns] UTC. Empty
    buckets give NaN, but 0 for ``sum`` and ``count``. The origin is the
    midnight of the first sample's day where the index's time zone has it,
    which for a fixed offset that the bucket does not divide moves every
    bucket edge."""
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
    first = datetime.fromtimestamp(int(ts[0]) // 1_000_000_000, series.tz)
    offset_ns = first.utcoffset() // timedelta(microseconds=1) * 1_000
    local = int(ts[0]) + offset_ns
    origin = local - local % _DAY_NS - offset_ns
    buckets = (ts - origin) // bucket_ns
    n = int(buckets[-1] - buckets[0] + 1)
    grid = (origin + bucket_ns * np.arange(buckets[0], buckets[-1] + 1)).view("datetime64[ns]")

    valid = ~np.isnan(values)
    pos, vals = (buckets - buckets[0])[valid], values[valid]
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
    return grid, columns


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
        if row_filter:
            raise NotImplementedError(
                "row_filter (a pandas query expression) is not ported yet: see the "
                "'Training, the rest of the build path' item of ROADMAP.md queue A"
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
        resample, the join, the interpolation and the dropping of NaN rows."""
        t0 = time.monotonic()
        all_tags = list(dict.fromkeys(self.tag_list + self.target_tag_list))
        methods = (
            [self.aggregation_methods] if isinstance(self.aggregation_methods, str)
            else list(self.aggregation_methods)
        )
        bucket = resolution_ns(self.resolution)
        grids, columns, tz = [], [], self.train_start_date.tzinfo
        for series in self.data_provider.load_series(
            self.train_start_date, self.train_end_date, all_tags
        ):
            grid, resampled = resample(series, bucket, methods)
            grids.extend([grid] * len(resampled))
            columns.extend(resampled)
            tz = series.tz
        index, table = _join(grids, columns)
        if self.interpolation_method == "linear_interpolation":
            limit = max(resolution_ns(self.interpolation_limit) // bucket, 1)
            table = interpolate_linear(table, limit)
        keep = ~np.isnan(table).any(axis=1)
        self._metadata["query_duration_sec"] = time.monotonic() - t0
        return index[keep], table[keep], self._column_names(all_tags), tz

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
