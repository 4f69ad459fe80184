"""
The port's data layer (gordo_tpu_torch/dataset) against the JAX package's
and pandas on the CPU: sensor tags; RandomDataProvider and RandomDataset
bit-identical to the JAX ones for a UTC and a +01:00 start; the numpy
resample against pandas' ``resample(...).agg(method)`` and the linear
interpolation against pandas' ``interpolate(limit=k)`` on gapped series
(rtol 1e-12: the same sums in another order); and a whole
TimeSeriesDataset over gapped data against the JAX dataset.
"""

from datetime import datetime

import numpy as np
import pandas as pd
import pytest

from gordo_tpu.dataset import RandomDataset as JaxRandomDataset
from gordo_tpu.dataset import TimeSeriesDataset as JaxTimeSeriesDataset
from gordo_tpu.dataset.data_provider import GordoBaseDataProvider as JaxProvider
from gordo_tpu.dataset.data_provider import RandomDataProvider as JaxRandomDataProvider
from gordo_tpu.dataset.sensor_tag import normalize_sensor_tag as jax_normalize_sensor_tag
from gordo_tpu_torch.dataset import (
    GordoBaseDataset,
    InsufficientDataError,
    RandomDataProvider,
    RandomDataset,
    SensorTag,
    Series,
    TimeSeriesDataset,
)
from gordo_tpu_torch.dataset.data_provider import GordoBaseDataProvider
from gordo_tpu_torch.dataset.datasets import AGGREGATIONS, interpolate_linear, resample
from gordo_tpu_torch.dataset.sensor_tag import (
    SensorTagNormalizationError,
    normalize_sensor_tag,
    to_list_of_strings,
)
from gordo_tpu_torch.models.utils import index_label

RTOL = 1e-12  # float64 on both sides, sums in another order
TAGS = [f"tag-{i}" for i in range(4)]
STARTS = {"utc": ("2020-01-01T00:00:00+00:00", "2020-01-03T00:00:00+00:00"),
          "plus-one": ("2020-01-01T00:00:00+01:00", "2020-01-03T00:00:00+01:00")}


def _ns(index: pd.DatetimeIndex) -> np.ndarray:
    return index.as_unit("ns").asi8


@pytest.mark.parametrize("tag", ["tag-a", {"name": "tag-a", "asset": "x"}, ["tag-a", "x"],
                                 ("tag-a",), SensorTag("tag-a", "y")])
def test_sensor_tags_normalize_like_jax(tag):
    ours = normalize_sensor_tag(tag, asset="default")
    theirs = jax_normalize_sensor_tag(tag if not isinstance(tag, SensorTag) else tag.name,
                                      asset=tag.asset if isinstance(tag, SensorTag) else "default")
    assert ours.to_json() == theirs.to_json()
    assert to_list_of_strings([ours]) == ["tag-a"]


@pytest.mark.parametrize("tag", [{"asset": "x"}, [], 3])
def test_bad_sensor_tags_raise(tag):
    with pytest.raises(SensorTagNormalizationError):
        normalize_sensor_tag(tag)


@pytest.mark.parametrize("span", sorted(STARTS))
def test_random_data_provider_is_bit_identical_to_jax(span):
    start, end = (datetime.fromisoformat(s) for s in STARTS[span])
    tags = [SensorTag(t) for t in TAGS]
    ours = list(RandomDataProvider(seed=3).load_series(start, end, tags))
    theirs = list(JaxRandomDataProvider(seed=3).load_series(start, end, tags))
    assert len(ours) == len(theirs) == len(TAGS)
    for series, expected in zip(ours, theirs):
        np.testing.assert_array_equal(series.values, expected.to_numpy())
        np.testing.assert_array_equal(series.index.view(np.int64), _ns(expected.index))
        assert series.tz.utcoffset(start) == expected.index.tz.utcoffset(start)
    assert RandomDataProvider(seed=3).to_dict() == JaxRandomDataProvider(seed=3).to_dict()


@pytest.mark.parametrize("span", sorted(STARTS))
def test_random_dataset_is_bit_identical_to_jax(span):
    config = {"type": "RandomDataset", "train_start_date": STARTS[span][0],
              "train_end_date": STARTS[span][1], "tags": TAGS[:3],
              "target_tag_list": TAGS[1:], "resolution": "10min"}
    ours, theirs = GordoBaseDataset.from_dict(config), JaxRandomDataset.from_dict(config)
    (X, y), (jX, jy) = ours.get_data(), theirs.get_data()
    for frame, expected in ((X, jX), (y, jy)):
        np.testing.assert_array_equal(frame.values, expected.to_numpy())
        assert frame.columns == list(expected.columns)
        np.testing.assert_array_equal(frame.index.view(np.int64), _ns(expected.index))
    assert [index_label(X, i) for i in (0, 1, len(jX) - 1)] == [
        str(jX.index[i]) for i in (0, 1, len(jX) - 1)]
    meta, jax_meta = ours.get_metadata(), theirs.get_metadata()
    for m in (meta, jax_meta):
        m.pop("query_duration_sec")
    assert meta == jax_meta
    assert ours.to_dict() == theirs.to_dict()


def _gapped_series(tz: str, seed: int) -> pd.Series:
    """Minute samples with dropped minutes, one long gap and NaN values."""
    rng = np.random.RandomState(seed)
    index = pd.date_range(f"2020-01-01T03:17:00{tz}", periods=3000, freq="1min")
    keep = rng.rand(len(index)) > 0.3
    keep[500:700] = False
    values = rng.randn(keep.sum()) + 10.0
    values[rng.rand(len(values)) < 0.1] = np.nan
    return pd.Series(values, index=index[keep])


def _port_series(series: pd.Series, name: str = "x") -> Series:
    return Series(_ns(series.index).view("datetime64[ns]"), series.to_numpy(), name,
                  series.index[0].to_pydatetime().tzinfo)


@pytest.mark.parametrize("method", AGGREGATIONS)
@pytest.mark.parametrize("tz", ["+00:00", "+01:00"])
@pytest.mark.parametrize("resolution", ["7min", "10min", "1h"])
def test_resample_matches_pandas(method, tz, resolution):
    # a +01:00 index starts its buckets at its own midnight (23:00 UTC):
    # 7-minute buckets then have other edges than in UTC
    series = _gapped_series(tz, seed=len(resolution))
    grid, (column,) = resample(_port_series(series), pd.Timedelta(resolution).value, [method])
    expected = series.resample(resolution).agg(method)
    np.testing.assert_array_equal(grid.view(np.int64), _ns(expected.index))
    np.testing.assert_allclose(column, expected.to_numpy(np.float64), rtol=RTOL, atol=0)
    assert np.isnan(column).any() == expected.isna().any()


@pytest.mark.parametrize("limit", [1, 2, 3, 8, 100])
def test_interpolation_matches_pandas(limit):
    rng = np.random.RandomState(limit)
    frame = pd.DataFrame(rng.randn(300, 3))
    frame[rng.rand(300, 3) < 0.4] = np.nan
    frame.iloc[:5, 0] = np.nan  # leading NaNs stay
    frame.iloc[-7:, 1] = np.nan  # trailing NaNs take the last value, up to the limit
    frame.iloc[100:130, 2] = np.nan
    np.testing.assert_array_equal(interpolate_linear(frame.to_numpy(), limit),
                                  frame.interpolate(method="linear", limit=limit).to_numpy())


class _GappedPort(GordoBaseDataProvider):
    def load_series(self, train_start_date, train_end_date, tag_list, dry_run=False):
        for i, tag in enumerate(tag_list):
            yield _port_series(_gapped_series("+00:00", seed=i), tag.name)


class _GappedJax(JaxProvider):
    def load_series(self, train_start_date, train_end_date, tag_list, dry_run=False):
        for i, tag in enumerate(tag_list):
            yield _gapped_series("+00:00", seed=i).rename(tag.name)


@pytest.mark.parametrize("methods", ["mean", ["mean", "max", "count"]])
@pytest.mark.parametrize("interpolation_limit", ["10min", "1h", "8h"])
def test_time_series_dataset_matches_jax_on_gapped_data(methods, interpolation_limit):
    config = dict(train_start_date="2020-01-01T00:00:00+00:00",
                  train_end_date="2020-01-04T00:00:00+00:00", tags=TAGS[:2],
                  target_tag_list=TAGS[1:3], resolution="10min",
                  aggregation_methods=methods, interpolation_limit=interpolation_limit)
    X, y = TimeSeriesDataset(data_provider=_GappedPort(), **config).get_data()
    jX, jy = JaxTimeSeriesDataset(data_provider=_GappedJax(), **config).get_data()
    for frame, expected in ((X, jX), (y, jy)):
        assert frame.columns == list(expected.columns)
        np.testing.assert_array_equal(frame.index.view(np.int64), _ns(expected.index))
        np.testing.assert_allclose(frame.values, expected.to_numpy(np.float64), rtol=RTOL, atol=0)


def test_dataset_refusals():
    config = dict(train_start_date=STARTS["utc"][0], train_end_date=STARTS["utc"][1], tags=TAGS)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RandomDataset(row_filter="`tag-0` > 0", **config)
    with pytest.raises(InsufficientDataError):
        RandomDataset(n_samples_threshold=288, **config).get_data()
    assert len(RandomDataset(n_samples_threshold=287, **config).get_data()[0].values) == 288
    with pytest.raises(ValueError, match="timezone-aware"):
        RandomDataset(train_start_date="2020-01-01T00:00:00", train_end_date=STARTS["utc"][1],
                      tags=TAGS)
    with pytest.raises(ValueError, match="before"):
        RandomDataset(train_start_date=STARTS["utc"][1], train_end_date=STARTS["utc"][0],
                      tags=TAGS)
    with pytest.raises(ValueError, match="Unknown dataset type"):
        GordoBaseDataset.from_dict({"type": "ParquetDataset", **config})
    with pytest.raises(ValueError, match="Unknown data provider type"):
        TimeSeriesDataset(data_provider={"type": "InfluxDataProvider"}, **config)
