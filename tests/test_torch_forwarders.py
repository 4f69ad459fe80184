"""
The port's prediction forwarders (client/forwarders.py) and its parquet
writer (util/parquet.py) held against the JAX forwarders: the same response
body (the ``dataframe_to_dict`` layout) is read by each client's reader
(JAX's ``dataframe_from_dict``, the port's ``RawFrame.from_dict``) and
forwarded. The InfluxDB line protocol is byte-equal to JAX's, escaping
included, and ``pd.read_parquet`` of the port's disk files equals
``pd.read_parquet`` of JAX's (columns, the index as index, dtypes, NaN,
values), over hypothesis frames too. The second needs this machine's
pyarrow, as JAX's ``DataFrame.to_parquet`` does.
"""

import threading
from datetime import datetime, timedelta, timezone

import numpy as np
import pandas as pd
import pytest
import requests
from hypothesis import HealthCheck, given, settings, strategies as st

from gordo_tpu.client import forwarders as jax_forwarders
from gordo_tpu.server.utils import dataframe_from_dict
from gordo_tpu_torch.client import forwarders as port_forwarders
from gordo_tpu_torch.client import io as port_io
from gordo_tpu_torch.models.utils import RawFrame
from gordo_tpu_torch.util import parquet

UTC = timezone.utc
T0 = datetime(2020, 1, 1, tzinfo=UTC)


def layout(groups, n_rows, step=timedelta(minutes=10), tz=UTC, start=T0, frequency=True):
    """A response body's ``data``: ``groups`` is ``[(top, [(sub, values)])]``
    with None for a null; the ``start``/``end`` blocks from the index."""
    index = [(start + i * step).astimezone(tz) for i in range(n_rows)]
    keys = [str(ts) for ts in index]
    data = {"start": {"": dict(zip(keys, (ts.isoformat() for ts in index)))},
            "end": {"": dict(zip(keys, ((ts + step).isoformat() if frequency else None
                                        for ts in index)))}}
    for top, subs in groups:
        data[top] = {sub: dict(zip(keys, values)) for sub, values in subs}
    return data


class _Recorder:
    """A session that records each POST (the Influx 1.x HTTP API)."""

    def __init__(self):
        self.posts = []

    def post(self, url, params=None, data=None, headers=None):
        self.posts.append((url, params, data, headers))

        class Resp:
            status_code = 204
            text = ""
        return Resp()


def _influx(module, frame, machine, **kwargs):
    session = _Recorder()
    forwarder = module.ForwardPredictionsIntoInflux(
        destination_influx_uri="influx.example:8086/proj-db", session=session, **kwargs)
    forwarder(frame, machine, {})
    return session.posts


FRAMES = {
    "escaping": ([("total-anomaly-scaled", [("", [0.1, None, 0.3])]),
                  ("tag-anomaly-unscaled", [("tag one", [1.0, 2.0, 3.0]),
                                            ("t=2,x\\y", [None, -0.5, 1e-12])]),
                  ("weird, measure ment", [("a", [1.5, 2.5, None])])], 3, "machine a,b=c\\d"),
    "all-null-block": ([("smooth-total-anomaly-scaled", [("", [None, None])]),
                        ("model-output", [("t-0", [0.25, 1e300]), ("t-1", [None, None])])], 2,
                       "m"),
    "long": ([("model-input", [(f"tag-{j}", list(np.linspace(-1, 1, 40) * (j + 1)))
                               for j in range(4)])], 40, "m-long"),
}


@pytest.mark.parametrize("case", list(FRAMES))
@pytest.mark.parametrize("batch_lines", [5000, 7])
@pytest.mark.parametrize("recreate", [False, True])
def test_influx_line_protocol_is_byte_equal_to_jax(case, batch_lines, recreate):
    groups, n_rows, machine = FRAMES[case]
    data = layout(groups, n_rows)
    kwargs = dict(batch_lines=batch_lines, destination_influx_recreate=recreate)
    theirs = _influx(jax_forwarders, dataframe_from_dict(data), machine, **kwargs)
    ours = _influx(port_forwarders, RawFrame.from_dict(data), machine, **kwargs)
    assert ours == theirs
    assert any(params.get("q", "").startswith("CREATE") for _, params, _, _ in ours)


def test_influx_forwarder_writes_line_protocol():
    """tests/gordo_tpu/test_client.py's case, on the port's forwarder."""
    idx = [T0 + timedelta(minutes=10 * i) for i in range(3)]
    data = layout([("total-anomaly-scaled", [("", [0.1, None, 0.3])]),
                   ("tag-anomaly-unscaled", [("tag one", [1.0, 2.0, 3.0])])], 3)
    posts = _influx(port_forwarders, RawFrame.from_dict(data), "machine a")
    create_url, create_params, _, _ = posts[0]
    assert create_url.endswith("/query")
    assert create_params["q"] == 'CREATE DATABASE "proj-db"'
    write_url, write_params, body, _ = posts[-1]
    assert write_url == "http://influx.example:8086/write"
    assert write_params == {"db": "proj-db", "precision": "ns"}
    lines = body.decode().splitlines()
    scaled = [line for line in lines if line.startswith("total-anomaly-scaled")]
    unscaled = [line for line in lines if line.startswith("tag-anomaly-unscaled")]
    assert len(scaled) == 2 and len(unscaled) == 3
    assert not any(line.startswith("start") for line in lines)
    stamp = int(pd.Timestamp(idx[0]).value)
    assert scaled[0] == f"total-anomaly-scaled,machine=machine\\ a value=0.1 {stamp}"
    assert "tag\\ one=1.0" in unscaled[0]


@pytest.mark.parametrize("package", ["jax", "port"])
def test_influx_forwarder_lazy_session_no_deadlock(package, monkeypatch):
    """Made without a session (the client CLI's way), the first forward()
    makes one lazily under the prepare lock without deadlocking, and four
    concurrent forwards run DROP and CREATE once."""
    posts = []

    class StubSession:
        def __init__(self, *args, **kwargs):
            pass

        def post(self, url, params=None, data=None, headers=None):
            posts.append((url, params))

            class Resp:
                status_code = 204
                text = ""
            return Resp()

    module = jax_forwarders if package == "jax" else port_forwarders
    if package == "jax":
        monkeypatch.setattr(requests, "Session", StubSession)
    else:
        monkeypatch.setattr(port_io, "HTTPSession", StubSession)
    data = layout([("prediction", [("t0", [0.1, 0.2])])], 2)
    frame = dataframe_from_dict(data) if package == "jax" else RawFrame.from_dict(data)
    forwarder = module.ForwardPredictionsIntoInflux(
        destination_influx_uri="influx.example:8086/proj-db", destination_influx_recreate=True)
    done = []

    def run():
        forwarder(frame, "m", {})
        done.append(1)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=30)
    assert len(done) == 4
    queries = [str((p or {}).get("q", "")) for _, p in posts]
    assert sum("DROP" in q for q in queries) == 1 and sum("CREATE" in q for q in queries) == 1


# -- the disk forwarder's parquet files
def _read_back(module, frame, root):
    forwarder = module.ForwardPredictionsToDisk(str(root))
    forwarder(frame, "m", {})
    forwarder(frame, "m", {})
    paths = sorted((root / "m").glob("*.parquet"))
    assert [p.name for p in paths] == ["batch-000000.parquet", "batch-000001.parquet"]
    return [pd.read_parquet(p) for p in paths], paths


def _assert_files_equal(data, tmp_path):
    pytest.importorskip("pyarrow")
    theirs, _ = _read_back(jax_forwarders, dataframe_from_dict(data), tmp_path / "jax")
    ours, paths = _read_back(port_forwarders, RawFrame.from_dict(data), tmp_path / "port")
    for mine, jax in zip(ours, theirs):
        pd.testing.assert_frame_equal(mine, jax)
        assert list(mine.columns) == list(jax.columns)
        assert mine.index.equals(jax.index) and mine.index.dtype == jax.index.dtype
    assert [parquet.footer_rows(str(p)) for p in paths] == [len(theirs[0])] * 2


@pytest.mark.parametrize("case", list(FRAMES))
def test_disk_files_read_back_as_jax_files(case, tmp_path):
    groups, n_rows, _ = FRAMES[case]
    _assert_files_equal(layout(groups, n_rows), tmp_path)


@pytest.mark.parametrize("tz", [UTC, timezone(timedelta(hours=1)),
                                timezone(timedelta(hours=-5, minutes=-30))])
def test_disk_files_keep_the_index_time_zone(tz, tmp_path):
    _assert_files_equal(layout([("model-output", [("a", [1.0, None, 3.0])])], 3, tz=tz),
                        tmp_path)


def test_disk_files_without_a_frequency(tmp_path):
    _assert_files_equal(layout([("model-output", [("a", [1.0, 2.0])])], 2, frequency=False),
                        tmp_path)


_VALUES = st.one_of(st.none(), st.floats(allow_nan=False, allow_infinity=False, width=64))


@st.composite
def _frames(draw):
    n_rows = draw(st.integers(1, 30))
    groups = []
    for g in range(draw(st.integers(1, 4))):
        subs = draw(st.sampled_from([[""], ["a"], ["a", "b c"], ["x|y", "z", "t=1"]]))
        groups.append((f"group-{g}", [(sub, draw(st.lists(_VALUES, min_size=n_rows,
                                                          max_size=n_rows)))
                                      for sub in subs]))
    step = timedelta(seconds=draw(st.integers(1, 86400)))
    start = T0 + timedelta(microseconds=draw(st.integers(0, 10**12)))
    return layout(groups, n_rows, step=step, start=start)


@settings(max_examples=60, deadline=None, suppress_health_check=list(HealthCheck))
@given(data=_frames())
def test_disk_files_read_back_as_jax_files_over_frame_shapes_and_nan_patterns(data,
                                                                             tmp_path_factory):
    _assert_files_equal(data, tmp_path_factory.mktemp("frames"))


@settings(max_examples=60, deadline=None, suppress_health_check=list(HealthCheck))
@given(data=_frames(), machine=st.text(alphabet="ab ,=\\\"'x", min_size=1, max_size=6))
def test_influx_lines_are_byte_equal_over_frame_shapes_and_nan_patterns(data, machine):
    theirs = _influx(jax_forwarders, dataframe_from_dict(data), machine, batch_lines=11)
    ours = _influx(port_forwarders, RawFrame.from_dict(data), machine, batch_lines=11)
    assert ours == theirs


def test_the_writer_refuses_a_naive_index(tmp_path):
    with pytest.raises(ValueError, match="tz-aware"):
        parquet.write_frame(str(tmp_path / "x.parquet"), [("a", np.zeros(1))],
                            [datetime(2020, 1, 1)])
