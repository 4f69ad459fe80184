"""
The data layer without pandas: sensor tags, data providers and time-series
datasets, the port's counterpart of ``gordo_tpu/dataset``.
"""

from .data_provider import GordoBaseDataProvider, RandomDataProvider, Series
from .datasets import GordoBaseDataset, InsufficientDataError, RandomDataset, TimeSeriesDataset
from .sensor_tag import SensorTag, normalize_sensor_tag, normalize_sensor_tags

__all__ = [
    "SensorTag",
    "normalize_sensor_tag",
    "normalize_sensor_tags",
    "GordoBaseDataProvider",
    "RandomDataProvider",
    "Series",
    "GordoBaseDataset",
    "TimeSeriesDataset",
    "RandomDataset",
    "InsufficientDataError",
]
