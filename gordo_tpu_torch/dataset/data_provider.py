"""
Data providers without pandas: the port's counterpart of the registry,
``GordoBaseDataProvider`` and ``RandomDataProvider`` in
``gordo_tpu/dataset/data_provider.py``.

A provider yields one :class:`Series` per tag. ``RandomDataProvider``'s
values are bit-identical to the JAX package's: the same per-tag seed, the
same ``RandomState`` draws in the same order and the same sum over the
three sines. The Influx, Parquet and DataLake providers are not ported:
see the 'Training, the rest of the build path' item of ROADMAP.md queue A.
"""

import abc
import zlib
from datetime import datetime, timedelta, timezone, tzinfo
from typing import Iterable, List, NamedTuple

import numpy as np

from ..models.utils import parse_resolution
from .sensor_tag import SensorTag

_PROVIDER_REGISTRY = {}
_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)
_US = 1_000  # nanoseconds


class Series(NamedTuple):
    """One tag's samples: ``index`` is datetime64[ns] in UTC, ascending;
    ``tz`` is the time zone it is read in (a pandas index's ``tz``)."""

    index: np.ndarray
    values: np.ndarray
    name: str
    tz: tzinfo


def datetime_ns(ts: datetime) -> int:
    """A timezone-aware datetime as nanoseconds since the epoch, exactly."""
    delta = ts - _EPOCH
    return (delta.days * 86_400 + delta.seconds) * 1_000_000_000 + delta.microseconds * _US


def resolution_ns(resolution: str) -> int:
    """A fixed-length pandas offset alias ("10min", "1H") in nanoseconds."""
    return parse_resolution(resolution) // timedelta(microseconds=1) * _US


def date_range_ns(start: datetime, end: datetime, resolution: str) -> np.ndarray:
    """``pd.date_range(start, end, freq=resolution, inclusive="left")`` as
    datetime64[ns] in UTC: start, start + step, ... while before end."""
    start_ns, end_ns = datetime_ns(start), datetime_ns(end)
    step = resolution_ns(resolution)
    n = max(-(-(end_ns - start_ns) // step), 0)
    return (start_ns + step * np.arange(n, dtype=np.int64)).view("datetime64[ns]")


def register_data_provider(cls):
    """Class decorator: register a provider under its class name for from_dict."""
    _PROVIDER_REGISTRY[cls.__name__] = cls
    return cls


class GordoBaseDataProvider(abc.ABC):
    @abc.abstractmethod
    def load_series(self, train_start_date: datetime, train_end_date: datetime,
                    tag_list: List[SensorTag], dry_run: bool = False) -> Iterable[Series]:
        """Yield one series per tag covering [train_start_date, train_end_date)."""

    @classmethod
    def from_dict(cls, config: dict) -> "GordoBaseDataProvider":
        config = dict(config)
        kind = config.pop("type", "RandomDataProvider").rsplit(".", 1)[-1]
        if kind not in _PROVIDER_REGISTRY:
            raise ValueError(
                f"Unknown data provider type {kind!r}; "
                f"available: {sorted(_PROVIDER_REGISTRY)}"
            )
        return _PROVIDER_REGISTRY[kind](**config)

    def to_dict(self) -> dict:
        out = dict(getattr(self, "_init_kwargs", {}))
        out["type"] = type(self).__name__
        return out


@register_data_provider
class RandomDataProvider(GordoBaseDataProvider):
    """Deterministic synthetic sensor data: per tag, a sine mixture plus
    noise and an offset on a fixed grid, seeded from the tag's name."""

    def __init__(self, min_size: int = 100, max_size: int = 300,
                 resolution: str = "10min", seed: int = 0, **kwargs):
        self.min_size = min_size
        self.max_size = max_size
        self.resolution = resolution
        self.seed = seed
        self._init_kwargs = dict(
            min_size=min_size, max_size=max_size, resolution=resolution, seed=seed
        )

    def _tag_seed(self, tag: SensorTag) -> int:
        return (zlib.crc32(tag.name.encode()) ^ self.seed) & 0x7FFFFFFF

    def load_series(self, train_start_date: datetime, train_end_date: datetime,
                    tag_list: List[SensorTag], dry_run: bool = False) -> Iterable[Series]:
        index = date_range_ns(train_start_date, train_end_date, self.resolution)
        n = len(index)
        if n == 0:
            return
        t = np.arange(n, dtype=np.float64)
        for tag in tag_list:
            rng = np.random.RandomState(self._tag_seed(tag))
            freqs = rng.uniform(0.001, 0.05, size=3)
            amps = rng.uniform(0.5, 2.0, size=3)
            phases = rng.uniform(0, 2 * np.pi, size=3)
            base = sum(a * np.sin(2 * np.pi * f * t + p) for f, a, p in zip(freqs, amps, phases))
            noise = rng.normal(0, 0.1, size=n)
            offset = rng.uniform(-10, 10)
            yield Series(index, base + noise + offset, tag.name, train_start_date.tzinfo)
