"""
The dataset's resample on calendar resolutions and the native library's
data-layer kernels (``gordo_tpu_torch/dataset/datasets.py``,
``gordo_tpu_torch/native``) against the JAX package and pandas:

- each calendar alias (``W``, ``W-MON``, ``W-THU``, ``MS``, ``ME``) and the
  day (``D``, ``1D``) on hourly samples with gaps and NaNs, in UTC and a
  fixed offset, gives the JAX dataset's grid and values (RTOL: float64 sums
  in another order); an alias the JAX dataset refuses the port refuses;
- ``native.resample`` gives pandas' ``resample(...).agg(method)`` and the
  JAX package's own native kernel's output for each aggregation;
- ``native.rolling_min_max`` gives pandas' ``rolling(w).min().max()`` and
  the JAX fleet trainer's ``_rolling_min_max`` exactly.
"""

import numpy as np
import pandas as pd
import pytest

from gordo_tpu import native as jax_native
from gordo_tpu.dataset import TimeSeriesDataset as JaxTimeSeriesDataset
from gordo_tpu.dataset.data_provider import GordoBaseDataProvider as JaxProvider
from gordo_tpu.parallel.batch_trainer import BatchedModelBuilder as JaxBatchedModelBuilder
from gordo_tpu_torch import native
from gordo_tpu_torch.dataset import Series, TimeSeriesDataset
from gordo_tpu_torch.dataset.data_provider import GordoBaseDataProvider
from gordo_tpu_torch.dataset.datasets import AGGREGATIONS, bucket_of, resample

RTOL = 1e-12
TAGS = ["tag-0", "tag-1"]


def _hourly(tz: str, seed: int) -> pd.Series:
    """Hourly samples over 100 days with dropped hours, a dropped week and NaNs."""
    rng = np.random.RandomState(seed)
    index = pd.date_range(f"2020-01-03T05:00:00{tz}", periods=2400, freq="1h")
    keep = rng.rand(len(index)) > 0.2
    keep[900:1100] = False
    values = rng.randn(keep.sum()) + 5.0
    values[rng.rand(len(values)) < 0.1] = np.nan
    return pd.Series(values, index=index[keep])


def _port(series: pd.Series, name: str) -> Series:
    return Series(series.index.tz_convert("UTC").as_unit("ns").asi8.view("datetime64[ns]"),
                  series.to_numpy(), name, series.index[0].to_pydatetime().tzinfo)


def _providers(tz: str):
    class Port(GordoBaseDataProvider):
        def load_series(self, start, end, tags, dry_run=False):
            for i, tag in enumerate(tags):
                yield _port(_hourly(tz, i), tag.name)

    class Jax(JaxProvider):
        def load_series(self, start, end, tags, dry_run=False):
            for i, tag in enumerate(tags):
                yield _hourly(tz, i).rename(tag.name)

    return Port(), Jax()


@pytest.mark.parametrize("resolution", ["D", "1D", "W", "W-MON", "W-THU", "MS", "ME"])
@pytest.mark.parametrize("tz", ["+00:00", "+05:00"])
@pytest.mark.parametrize("methods", ["mean", ["max", "count", "median"]])
def test_calendar_resolutions_match_the_jax_dataset(resolution, tz, methods):
    port, jax = _providers(tz)
    config = dict(train_start_date="2020-01-01T00:00:00+00:00",
                  train_end_date="2020-06-01T00:00:00+00:00", tags=TAGS,
                  resolution=resolution, aggregation_methods=methods, interpolation_limit="3D")
    X, _ = TimeSeriesDataset(data_provider=port, **config).get_data()
    jX, _ = JaxTimeSeriesDataset(data_provider=jax, **config).get_data()
    assert X.columns == list(jX.columns) and len(X.index) > 3
    np.testing.assert_array_equal(X.index.view(np.int64), jX.index.tz_convert("UTC")
                                  .as_unit("ns").asi8)
    np.testing.assert_allclose(X.values, jX.to_numpy(np.float64), rtol=RTOL, atol=0)


@pytest.mark.parametrize("resolution", ["W", "W-SAT", "MS", "ME"])
@pytest.mark.parametrize("method", AGGREGATIONS)
def test_calendar_resample_matches_pandas(resolution, method):
    series = _hourly("+02:00", 7)
    grid, (column,) = resample(_port(series, "x"), bucket_of(resolution), [method])
    expected = series.resample(resolution).agg(method)
    np.testing.assert_array_equal(grid.view(np.int64),
                                  expected.index.tz_convert("UTC").as_unit("ns").asi8)
    np.testing.assert_allclose(column, expected.to_numpy(np.float64), rtol=RTOL, atol=0)


@pytest.mark.parametrize("resolution", ["M", "2MS", "QS", "banana", "W-XYZ"])
def test_refused_resolutions(resolution):
    port, jax = _providers("+00:00")
    config = dict(train_start_date="2020-01-01T00:00:00+00:00",
                  train_end_date="2020-06-01T00:00:00+00:00", tags=TAGS, resolution=resolution)
    with pytest.raises(ValueError, match="Unsupported resolution"):
        TimeSeriesDataset(data_provider=port, **config)
    if resolution in ("M", "banana", "W-XYZ"):  # the JAX dataset refuses these too
        with pytest.raises(ValueError):
            JaxTimeSeriesDataset(data_provider=jax, **config).get_data()


@pytest.mark.parametrize("bucket", ["7min", "10min", "1h"])
def test_native_resample_matches_pandas_and_the_jax_kernel(bucket):
    series = _hourly("+00:00", 3).resample("13min").first().dropna()
    ts = series.index.as_unit("ns").asi8
    bucket_ns = pd.Timedelta(bucket).value
    origin = ts[0] - ts[0] % 86_400_000_000_000
    n = int((ts[-1] - origin) // bucket_ns + 1)
    methods = list(AGGREGATIONS)
    calls = native.CALLS["resample"]
    ours = native.resample(ts, series.to_numpy(), origin, bucket_ns, n, methods)
    assert native.CALLS["resample"] == calls + 1
    assert jax_native.prebuild(block=True)
    theirs = jax_native.resample(ts, series.to_numpy(), origin, bucket_ns, n, methods)
    np.testing.assert_array_equal(ours, theirs)
    for row, method in zip(ours, methods):
        expected = series.resample(bucket).agg(method)
        np.testing.assert_allclose(row[-len(expected):], expected.to_numpy(np.float64),
                                   rtol=RTOL, atol=0)
    with pytest.raises(ValueError, match="differ in length"):
        native.resample(ts, series.to_numpy()[:-1], origin, bucket_ns, n, methods)


@pytest.mark.parametrize("window", [1, 6, 50, 500])
def test_native_rolling_min_max_matches_pandas_and_the_jax_fleet(window):
    rng = np.random.RandomState(window)
    values = rng.randn(400)
    values[rng.rand(400) < 0.05] = np.nan
    for column in (values, values[:window - 1] if window > 1 else values[:0],
                   np.full(window + 3, np.nan)):
        expected = pd.Series(column).rolling(window).min().max()
        got = native.rolling_min_max(column, window)
        jax_got = JaxBatchedModelBuilder._rolling_min_max(column, window)
        assert (np.isnan(got) and np.isnan(expected) and np.isnan(jax_got)) or (
            got == expected == jax_got)
