"""
The port's data providers (``gordo_tpu_torch/dataset/data_provider.py``)
against the JAX package's on the same sources:

- ``InfluxDataProvider``: one HTTP stub on a real socket on 127.0.0.1
  answers the JAX provider (``requests``) and the port's (``urllib``); the
  series and the requests the stub saw are equal, errors raise IOError in
  both;
- ``ParquetFilesProvider(file_format="csv")``: the same per-tag files,
  naive and aware times, clipped to the window, on a dry run, missing and
  malformed;
- ``DataLakeProvider``: one fake transport for both, whose recorded
  requests (URL, headers, query) are equal for a SAS token, a bearer token
  and a SharedKey signature, and whose CSV bodies both read alike;
- ``parse_service_uri`` on both grammars.

Times are exact. Values: exact from Influx (JSON on both sides); from a
CSV file within TOL_CSV_ABS plus TOL_CSV_REL of the JAX package's, whose
pandas reads floats with its fast C parser (``xstrtod``), which is not
correctly rounded (up to 2.2e-16 from Python's ``float`` on these values),
where the port's ``float`` is.
"""

import email.utils
import http.server
import json
import threading
import urllib.parse
from datetime import datetime, timezone

import numpy as np
import pandas as pd
import pytest

from gordo_tpu.dataset import data_provider as jax_dp
from gordo_tpu.dataset.sensor_tag import SensorTag as JaxSensorTag
from gordo_tpu.util.utils import parse_service_uri as jax_parse_service_uri
from gordo_tpu_torch.dataset import data_provider as dp
from gordo_tpu_torch.dataset.sensor_tag import SensorTag
from gordo_tpu_torch.util.utils import parse_service_uri

START = datetime(2020, 1, 1, tzinfo=timezone.utc)
END = datetime(2020, 1, 2, tzinfo=timezone.utc)
TAGS = ["tag-0", "TRA-35TT8566.PV", "it's"]


TOL_CSV_ABS = 5e-16
TOL_CSV_REL = 1e-15


def _assert_series_equal(port: dp.Series, theirs: pd.Series, csv: bool = False):
    index = theirs.index
    if index.tz is None:
        index = index.tz_localize("UTC")
    np.testing.assert_array_equal(port.index.view(np.int64),
                                  index.tz_convert("UTC").as_unit("ns").asi8)
    if csv:
        np.testing.assert_allclose(port.values, theirs.to_numpy(np.float64),
                                   rtol=TOL_CSV_REL, atol=TOL_CSV_ABS)
    else:
        np.testing.assert_array_equal(port.values, theirs.to_numpy(np.float64))
    assert port.name == theirs.name


# -------------------------------------------------------------- Influx
def _series(tag: str, n: int = 200):
    rng = np.random.RandomState(len(tag))
    stamps = (pd.Timestamp(START) + pd.to_timedelta(np.sort(rng.choice(2 * 86_400, n,
                                                                         replace=False)),
                                                     unit="s")).as_unit("ns").asi8
    values = rng.randn(n)
    values[::17] = np.nan
    return stamps, values


class _InfluxStub:
    """``GET /query`` of InfluxDB 1.x: each tag's rows in the query's bounds,
    a 500 for the tag ``http-error`` and a statement error for
    ``statement-error``; every request's path and Authorization header kept."""

    def __init__(self):
        self.requests = []
        stub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                stub.requests.append((self.path, self.headers.get("Authorization")))
                params = urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query)
                q = params["q"][0]
                tag = q.split("= '", 1)[1].split("' AND", 1)[0].replace("''", "'")
                lo = pd.Timestamp(q.split("time >= '")[1].split("'")[0]).value
                hi = pd.Timestamp(q.split("time < '")[1].split("'")[0]).value
                if tag == "http-error":
                    return self._send(500, b"boom")
                if tag == "statement-error":
                    return self._send(200, json.dumps(
                        {"results": [{"statement_id": 0, "error": "bad statement"}]}).encode())
                if tag == "empty":
                    return self._send(200, json.dumps({"results": [{"statement_id": 0}]})
                                      .encode())
                stamps, values = _series(tag)
                keep = (stamps >= lo) & (stamps < hi)
                rows = [[int(t), None if np.isnan(v) else float(v)]
                        for t, v in zip(stamps[keep], values[keep])]
                if q.endswith("LIMIT 1"):
                    rows = rows[:1]
                self._send(200, json.dumps({"results": [{"statement_id": 0, "series": [
                    {"name": "sensors", "columns": ["time", "Value"], "values": rows}]}]})
                    .encode())

            def _send(self, status, body):
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture
def influx():
    stub = _InfluxStub()
    yield stub
    stub.close()


@pytest.mark.parametrize("uri", ["http://127.0.0.1:{port}/gordo", "127.0.0.1:{port}/gordo"])
@pytest.mark.parametrize("dry_run", [False, True])
def test_influx_series_and_requests_match_jax(influx, uri, dry_run):
    kwargs = dict(uri=uri.format(port=influx.port), username="user", password="secret")
    ours = dp.InfluxDataProvider(**kwargs)
    theirs = jax_dp.InfluxDataProvider(**kwargs)
    window = (datetime(2020, 1, 1, 6, tzinfo=timezone.utc), END)
    port_series = list(ours.load_series(*window, [SensorTag(t) for t in TAGS], dry_run))
    port_requests = list(influx.requests)
    influx.requests.clear()
    jax_series = list(theirs.load_series(*window, [JaxSensorTag(t) for t in TAGS], dry_run))
    assert len(port_series) == len(jax_series) == len(TAGS)
    for port, jax in zip(port_series, jax_series):
        _assert_series_equal(port, jax)
        assert len(port.values) == (1 if dry_run else len(port.values)) > 0
    assert [(urllib.parse.parse_qs(urllib.parse.urlparse(path).query), auth)
            for path, auth in port_requests] == [
        (urllib.parse.parse_qs(urllib.parse.urlparse(path).query), auth)
        for path, auth in influx.requests]
    assert ours.to_dict() == theirs.to_dict()
    assert dp.GordoBaseDataProvider.from_dict(ours.to_dict()).to_dict() == ours.to_dict()


def test_influx_errors_and_empty_tags_match_jax(influx):
    kwargs = dict(host="127.0.0.1", port=influx.port)
    ours, theirs = dp.InfluxDataProvider(**kwargs), jax_dp.InfluxDataProvider(**kwargs)
    for tag, match in (("http-error", "failed \\(500\\)"), ("statement-error", "bad statement")):
        with pytest.raises(IOError, match=match):
            list(ours.load_series(START, END, [SensorTag(tag)]))
        with pytest.raises(IOError, match=match):
            list(theirs.load_series(START, END, [JaxSensorTag(tag)]))
    (port,), (jax,) = (list(ours.load_series(START, END, [SensorTag("empty")])),
                       list(theirs.load_series(START, END, [JaxSensorTag("empty")])))
    assert len(port.values) == len(jax) == 0 and port.name == jax.name == "empty"


@pytest.mark.parametrize("uri", ["influx.example:8086/gordo", "https://h:9/db", "h", "h:1/",
                                 "", "http://h/db/x", "h:notaport/db"])
def test_parse_service_uri_matches_jax(uri):
    try:
        expected = jax_parse_service_uri(uri)
    except ValueError as exc:
        with pytest.raises(ValueError, match="Invalid port"):
            parse_service_uri(uri)
        assert "Invalid port" in str(exc)
        return
    assert parse_service_uri(uri) == expected


# ------------------------------------------------------------------ files
def _write_files(base, tz):
    frames = {}
    for j, tag in enumerate(TAGS):
        stamps, values = _series(tag, 150 + j)
        index = pd.to_datetime(stamps, unit="ns")
        index = index.tz_localize("UTC").tz_convert(tz) if tz else index
        frame = pd.DataFrame({"value": values}, index=pd.Index(index, name="time"))
        path = base / ("plant" if j == 0 else "") / f"{tag}.csv"
        path.parent.mkdir(parents=True, exist_ok=True)
        frame.to_csv(path)
        frames[tag] = frame
    return frames


@pytest.mark.parametrize("tz", [None, "UTC", "+02:00"])
@pytest.mark.parametrize("dry_run", [False, True])
def test_csv_files_match_jax(tmp_path, tz, dry_run):
    _write_files(tmp_path, tz)
    ours = dp.ParquetFilesProvider(base_path=str(tmp_path), file_format="csv")
    theirs = jax_dp.ParquetFilesProvider(base_path=str(tmp_path), file_format="csv")
    window = (datetime(2020, 1, 1, 5, tzinfo=timezone.utc),
              datetime(2020, 1, 1, 20, tzinfo=timezone.utc))
    tags = [("tag-0", "plant"), ("TRA-35TT8566.PV", "plant"), ("it's", None)]
    port = list(ours.load_series(*window, [SensorTag(t, a) for t, a in tags], dry_run))
    jax = list(theirs.load_series(*window, [JaxSensorTag(t, a) for t, a in tags], dry_run))
    for p, j in zip(port, jax):
        _assert_series_equal(p, j, csv=True)
        assert len(p.values) == 1 if dry_run else 0 < len(p.values) < 150
    if tz == "+02:00":
        assert port[0].tz.utcoffset(None).total_seconds() == 7200
    assert ours.can_handle_tag(SensorTag("tag-0", "plant"))
    assert not ours.can_handle_tag(SensorTag("missing"))


def test_csv_files_refusals_match_jax(tmp_path):
    ours = dp.ParquetFilesProvider(base_path=str(tmp_path), file_format="csv")
    theirs = jax_dp.ParquetFilesProvider(base_path=str(tmp_path), file_format="csv")
    with pytest.raises(FileNotFoundError):
        list(ours.load_series(START, END, [SensorTag("missing")]))
    with pytest.raises(FileNotFoundError):
        list(theirs.load_series(START, END, [JaxSensorTag("missing")]))
    for name, text in (("numbers", "i,value\n1,2.0\n2,3.0\n"), ("header", "time,value\n")):
        (tmp_path / f"{name}.csv").write_text(text)
        with pytest.raises(ValueError, match="needs a datetime index"):
            list(ours.load_series(START, END, [SensorTag(name)]))
        with pytest.raises(ValueError, match="needs a datetime index"):
            list(theirs.load_series(START, END, [JaxSensorTag(name)]))
    with pytest.raises(ValueError, match="parquet"):
        dp.ParquetFilesProvider(base_path=str(tmp_path))
    with pytest.raises(ValueError, match="Unsupported file_format"):
        dp.ParquetFilesProvider(base_path=str(tmp_path), file_format="xlsx")


# ------------------------------------------------------------- Data Lake
class _FakeLake:
    """A transport for both providers: records each GET, answers 404 for
    paths under ``missing/``, a 403 for ``denied.csv`` and the CSV of the
    tag otherwise."""

    def __init__(self):
        self.requests = []

    def get(self, url, headers=None, params=None, **kwargs):
        self.requests.append((url, dict(headers or {}), dict(params or {})))
        path = urllib.parse.unquote(urllib.parse.urlparse(url).path)

        class Resp:
            pass

        resp = Resp()
        tag = path.rsplit("/", 1)[-1][:-len(".csv")]
        if "/missing/" in path:
            resp.status_code, resp.content = 404, b"no such file"
        elif tag == "denied":
            resp.status_code, resp.content = 403, b"denied"
        else:
            stamps, values = _series(tag, 120)
            lines = ["time,value"] + [
                f"{pd.Timestamp(t, tz='UTC').isoformat()},{'' if np.isnan(v) else repr(float(v))}"
                for t, v in zip(stamps, values)]
            resp.status_code, resp.content = 200, ("\n".join(lines) + "\n").encode()
        resp.text = resp.content.decode()
        return resp


@pytest.mark.parametrize("credential", [
    {"sas_token": "?sv=2021-08-06&ss=b&sig=abc%2Bdef%3D&sdd="},
    {"bearer_token": "a-token"},
    {"account_key": "c2VjcmV0LWtleS1ieXRlcw=="},
])
def test_data_lake_requests_and_series_match_jax(monkeypatch, credential):
    monkeypatch.setattr(email.utils, "formatdate",
                        lambda *a, **k: "Wed, 01 Jan 2020 00:00:00 GMT")
    lake, jax_lake = _FakeLake(), _FakeLake()
    kwargs = dict(store_name="account", file_format="csv", **credential)
    ours = dp.DataLakeProvider(session=lake, **kwargs)
    theirs = jax_dp.DataLakeProvider(session=jax_lake, **kwargs)
    tags = [("tag-0", "missing"), ("TRA-35TT8566.PV", "asset #1"), ("it's", None)]
    port = list(ours.load_series(START, END, [SensorTag(t, a) for t, a in tags]))
    jax = list(theirs.load_series(START, END, [JaxSensorTag(t, a) for t, a in tags]))
    for p, j in zip(port, jax):
        _assert_series_equal(p, j, csv=True)
    assert lake.requests == jax_lake.requests
    assert len(lake.requests) == 4  # the missing asset path, then its fallback
    if "account_key" in credential:
        assert lake.requests[0][1]["Authorization"].startswith("SharedKey account:")
    assert ours.to_dict() == theirs.to_dict() and "sas_token" not in ours.to_dict()


def test_data_lake_refusals_match_jax(monkeypatch):
    for name in ("AZURE_STORAGE_SAS_TOKEN", "AZURE_STORAGE_TOKEN", "AZURE_STORAGE_KEY"):
        monkeypatch.delenv(name, raising=False)
    for cls in (dp.DataLakeProvider, jax_dp.DataLakeProvider):
        with pytest.raises(ValueError, match="store_name"):
            cls(file_format="csv")
        with pytest.raises(ValueError, match="interactive"):
            cls(store_name="a", interactive=True, file_format="csv")
    for provider, tag in ((dp.DataLakeProvider(store_name="a", file_format="csv",
                                               session=_FakeLake()), SensorTag("x")),
                          (jax_dp.DataLakeProvider(store_name="a", file_format="csv",
                                                   session=_FakeLake()), JaxSensorTag("x"))):
        with pytest.raises(ValueError, match="no credentials"):
            list(provider.load_series(START, END, [tag]))
    monkeypatch.setenv("AZURE_STORAGE_TOKEN", "from-env")
    for provider, tag in ((dp.DataLakeProvider(store_name="a", file_format="csv",
                                               session=_FakeLake()), SensorTag("denied")),
                          (jax_dp.DataLakeProvider(store_name="a", file_format="csv",
                                                   session=_FakeLake()), JaxSensorTag("denied"))):
        with pytest.raises(IOError, match="403"):
            list(provider.load_series(START, END, [tag]))
    with pytest.raises(ValueError, match="parquet"):
        dp.DataLakeProvider(store_name="a")
