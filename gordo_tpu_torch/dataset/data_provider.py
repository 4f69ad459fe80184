"""
Data providers without pandas: the port's counterpart of the registry,
``GordoBaseDataProvider`` and ``RandomDataProvider`` in
``gordo_tpu/dataset/data_provider.py``.

A provider yields one :class:`Series` per tag. ``RandomDataProvider``'s
values are bit-identical to the JAX package's: the same per-tag seed, the
same ``RandomState`` draws in the same order and the same sum over the
three sines.

The real providers keep the JAX package's constructor arguments, their
``to_dict`` and ``from_dict`` names and their ``dry_run``:

- ``InfluxDataProvider``: one InfluxQL ``GET /query`` a tag against an
  InfluxDB 1.x HTTP API (``uri`` in either grammar of
  ``util.utils.parse_service_uri``, basic auth from ``username`` and
  ``password``); an HTTP error or a statement's error raises IOError.
- ``ParquetFilesProvider``: per-tag files under ``base_path`` (``<asset>/<tag>.csv``
  first, then ``<tag>.csv``).
- ``DataLakeProvider``: per-tag files of an Azure Data Lake Storage Gen2
  file system over its REST API, signed by a SAS token, a bearer token or
  a SharedKey (HMAC-SHA256 of the canonical request, API version
  ``2021-08-06``), the credentials from the arguments or the
  ``AZURE_STORAGE_*`` variables and never in ``to_dict``.

HTTP goes through ``urllib`` behind the ``session`` seam the JAX providers
have (``session.get(url, params=..., headers=..., auth=...)`` answering an
object with ``status_code``, ``text``, ``content`` and ``json()``), so a
test hands both packages one transport. The files are CSV (``file_format:
csv``): the first column the time index (ISO 8601; naive times are UTC),
the second the values, empty and pandas' NA spellings NaN, as
``pandas.read_csv(index_col=0, parse_dates=True)`` reads them. Parquet is
refused by name: it needs pyarrow, which the port does not use.
"""

import abc
import base64
import csv
import email.utils
import hashlib
import hmac
import io
import json
import os
import urllib.error
import urllib.parse
import urllib.request
import zlib
from datetime import datetime, timedelta, timezone, tzinfo
from typing import Iterable, List, NamedTuple, Optional

import numpy as np

from ..models.utils import parse_resolution
from ..util.utils import parse_service_uri
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

    def can_handle_tag(self, tag: SensorTag) -> bool:
        return True

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


# ------------------------------------------------------------------- HTTP
class _Response:
    """What the providers read of an answer: ``requests.Response``'s names."""

    def __init__(self, status_code: int, content: bytes):
        self.status_code = status_code
        self.content = content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    def json(self):
        return json.loads(self.content)


class HttpSession:
    """The default transport: ``get`` over ``urllib.request``, the query
    string encoded as ``requests`` encodes ``params``, basic auth from an
    ``auth`` pair. Every answer is returned, an HTTP error's too."""

    def __init__(self, timeout: float = 60.0):
        self.timeout = timeout

    def get(self, url: str, params: Optional[dict] = None, headers: Optional[dict] = None,
            auth=None) -> _Response:
        if params:
            url = f"{url}?{urllib.parse.urlencode(params)}"
        headers = dict(headers or {})
        if auth:
            token = base64.b64encode(f"{auth[0]}:{auth[1]}".encode()).decode()
            headers["Authorization"] = f"Basic {token}"
        request = urllib.request.Request(url, headers=headers)
        try:
            with urllib.request.urlopen(request, timeout=self.timeout) as resp:
                return _Response(resp.status, resp.read())
        except urllib.error.HTTPError as exc:
            return _Response(exc.code, exc.read())


def _utc_ns(ts: datetime) -> int:
    """A datetime (naive ones taken as UTC) as nanoseconds since the epoch."""
    return datetime_ns(ts if ts.tzinfo is not None else ts.replace(tzinfo=timezone.utc))


def _empty(name: str) -> Series:
    return Series(np.empty(0, "datetime64[ns]"), np.empty(0), name, timezone.utc)


@register_data_provider
class InfluxDataProvider(GordoBaseDataProvider):
    """InfluxDB 1.x over its HTTP API: one ``SELECT "<value_name>" FROM
    "<measurement>" WHERE "<tag_key>" = '<tag>' AND time >= ... AND time <
    ...`` a tag (``LIMIT 1`` on a ``dry_run``), the times as epoch
    nanoseconds; a tag without rows is an empty series."""

    def __init__(self, measurement: str = "sensors", value_name: str = "Value",
                 tag_key: str = "tag", uri: Optional[str] = None, host: str = "localhost",
                 port: int = 8086, database: str = "gordo", username: Optional[str] = None,
                 password: Optional[str] = None, scheme: str = "http", session=None, **kwargs):
        if uri:
            parsed_scheme, host, port, parsed_db = parse_service_uri(uri, default_port=port)
            scheme = parsed_scheme or scheme
            database = parsed_db or database
        self.measurement = measurement
        self.value_name = value_name
        self.tag_key = tag_key
        self.base_url = f"{scheme}://{host}:{port}"
        self.database = database
        self.auth = (username, password) if username else None
        self.session = session if session is not None else HttpSession()
        # credentials travel with the config, as the JAX provider's do
        self._init_kwargs = dict(
            measurement=measurement, value_name=value_name, tag_key=tag_key, host=host,
            port=port, database=database, scheme=scheme, username=username,
            password=password, **kwargs)

    @staticmethod
    def _influx_time(ts: datetime) -> str:
        ns = _utc_ns(ts)
        stamp = datetime.fromtimestamp(ns // 1_000_000_000, timezone.utc)
        return stamp.strftime("%Y-%m-%dT%H:%M:%S") + f".{ns % 1_000_000_000 // 1_000:06d}Z"

    def load_series(self, train_start_date: datetime, train_end_date: datetime,
                    tag_list: List[SensorTag], dry_run: bool = False) -> Iterable[Series]:
        for tag in tag_list:
            safe_tag = tag.name.replace("'", "''")  # InfluxQL's string quoting
            query = (
                f'SELECT "{self.value_name}" FROM "{self.measurement}" '
                f"WHERE \"{self.tag_key}\" = '{safe_tag}' "
                f"AND time >= '{self._influx_time(train_start_date)}' "
                f"AND time < '{self._influx_time(train_end_date)}'"
            )
            if dry_run:
                query += " LIMIT 1"
            resp = self.session.get(f"{self.base_url}/query",
                                    params={"db": self.database, "q": query, "epoch": "ns"},
                                    auth=self.auth)
            if getattr(resp, "status_code", 200) != 200:
                raise IOError(f"InfluxDB query failed ({resp.status_code}): "
                              f"{getattr(resp, 'text', '')[:300]}")
            result = (resp.json().get("results") or [{}])[0]
            if result.get("error"):
                # a statement's error comes back as a 200 with an error field
                raise IOError(f"InfluxDB query error for tag {tag.name!r}: {result['error']}")
            blocks = result.get("series") or []
            if not blocks:
                yield _empty(tag.name)
                continue
            columns = blocks[0]["columns"]
            t_idx, v_idx = columns.index("time"), columns.index(self.value_name)
            rows = blocks[0].get("values") or []
            index = np.array([int(r[t_idx]) for r in rows], np.int64).view("datetime64[ns]")
            values = np.asarray([r[v_idx] for r in rows], dtype=np.float64)
            yield Series(index, values, tag.name, timezone.utc)


# pandas' default NA spellings (read_csv's na_values)
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}


def read_series_csv(source: bytes, origin: str) -> Series:
    """A per-tag CSV file's bytes as a series: a header line, then rows of
    an ISO 8601 time and a value; naive times are UTC, aware ones keep their
    offset, which must be one for every row. ValueError, naming
    ``origin``, without such a time index."""
    rows = list(csv.reader(io.StringIO(source.decode("utf-8-sig"))))[1:]
    rows = [row for row in rows if row]
    if not rows:
        raise ValueError(f"{origin}: needs a datetime index")
    try:
        stamps = [datetime.fromisoformat(row[0].strip()) for row in rows]
    except (ValueError, IndexError):
        raise ValueError(f"{origin}: needs a datetime index")
    offsets = {ts.utcoffset() for ts in stamps}
    if len(offsets) > 1:
        raise ValueError(f"{origin}: needs a datetime index")
    offset = offsets.pop() if offsets else None
    tz = timezone.utc if offset is None else stamps[0].tzinfo
    values = np.array([np.nan if len(row) < 2 or row[1].strip() in _NA else float(row[1])
                       for row in rows], np.float64)
    index = np.array([_utc_ns(ts) for ts in stamps], np.int64).view("datetime64[ns]")
    return Series(index, values, origin, tz)


def _clip_window(series: Series, start: datetime, end: datetime, dry_run: bool,
                 name: str) -> Series:
    """The rows in [start, end), only the first on a ``dry_run``, named ``name``."""
    ns = series.index.view(np.int64)
    keep = np.flatnonzero((ns >= _utc_ns(start)) & (ns < _utc_ns(end)))
    if dry_run:
        keep = keep[:1]
    return Series(series.index[keep], series.values[keep], name, series.tz)


def _check_format(file_format: str) -> None:
    if file_format == "parquet":
        raise ValueError("file_format 'parquet' is not supported by gordo_tpu_torch: it needs "
                         "pyarrow; give the files as csv (file_format: csv)")
    if file_format != "csv":
        raise ValueError(f"Unsupported file_format {file_format!r}")


@register_data_provider
class ParquetFilesProvider(GordoBaseDataProvider):
    """Per-tag files on a local or mounted file system:
    ``<base_path>/<asset>/<tag>.<file_format>`` where the tag has an
    asset, else (or when that file is missing) ``<base_path>/<tag>.<file_format>``."""

    def __init__(self, base_path: str = ".", file_format: str = "parquet", **kwargs):
        _check_format(file_format)
        self.base_path = base_path
        self.file_format = file_format
        self._init_kwargs = dict(base_path=base_path, file_format=file_format, **kwargs)

    def _tag_path(self, tag: SensorTag) -> Optional[str]:
        candidates = [os.path.join(self.base_path, f"{tag.name}.{self.file_format}")]
        if tag.asset:
            candidates.insert(0, os.path.join(self.base_path, tag.asset,
                                              f"{tag.name}.{self.file_format}"))
        return next((path for path in candidates if os.path.exists(path)), None)

    def can_handle_tag(self, tag: SensorTag) -> bool:
        return self._tag_path(tag) is not None

    def load_series(self, train_start_date: datetime, train_end_date: datetime,
                    tag_list: List[SensorTag], dry_run: bool = False) -> Iterable[Series]:
        for tag in tag_list:
            path = self._tag_path(tag)
            if path is None:
                raise FileNotFoundError(f"No {self.file_format} file for tag {tag.name!r} "
                                        f"under {self.base_path!r}")
            with open(path, "rb") as fh:
                series = read_series_csv(fh.read(), path)
            yield _clip_window(series, train_start_date, train_end_date, dry_run, tag.name)


@register_data_provider
class DataLakeProvider(GordoBaseDataProvider):
    """Azure Data Lake Storage Gen2 over its REST API: one ``GET
    https://{store_name}.dfs.core.windows.net/{filesystem}/{path}`` a tag,
    ``path`` from ``path_template`` (``{asset}/{tag}.{format}``; for a tag
    without an asset, or on a 404, the template with its empty segments
    dropped). Credentials, the first set of: ``sas_token`` (its parameters
    in the query string), ``bearer_token`` (``Authorization: Bearer``),
    ``account_key`` (SharedKey signing); else the ``AZURE_STORAGE_SAS_TOKEN``,
    ``AZURE_STORAGE_TOKEN`` and ``AZURE_STORAGE_KEY`` variables. An
    interactive login is refused: builders run headless."""

    API_VERSION = "2021-08-06"

    def __init__(self, store_name: Optional[str] = None, filesystem: str = "data",
                 path_template: str = "{asset}/{tag}.{format}", file_format: str = "parquet",
                 sas_token: Optional[str] = None, bearer_token: Optional[str] = None,
                 account_key: Optional[str] = None, session=None,
                 storename: Optional[str] = None, interactive: bool = False, **kwargs):
        self.store_name = store_name or storename
        if not self.store_name:
            raise ValueError("DataLakeProvider requires store_name")
        if interactive:
            raise ValueError(
                "interactive (browser) login is not supported: builders run headless — "
                "provide sas_token, bearer_token or account_key (or their AZURE_STORAGE_* "
                "environment variables)")
        _check_format(file_format)
        self.filesystem = filesystem
        self.path_template = path_template
        self.file_format = file_format
        if sas_token or bearer_token or account_key:
            # a credential given wins over any left in the environment
            self.sas_token, self.bearer_token, self.account_key = (
                sas_token, bearer_token, account_key)
        else:
            self.sas_token = os.environ.get("AZURE_STORAGE_SAS_TOKEN")
            self.bearer_token = os.environ.get("AZURE_STORAGE_TOKEN")
            self.account_key = os.environ.get("AZURE_STORAGE_KEY")
        self.base_url = f"https://{self.store_name}.dfs.core.windows.net"
        self.session = session if session is not None else HttpSession()
        # no credential in the config: it travels in workflow documents
        self._init_kwargs = dict(store_name=self.store_name, filesystem=filesystem,
                                 path_template=path_template, file_format=file_format,
                                 **kwargs)

    def _paths_for(self, tag: SensorTag) -> List[str]:
        fields = dict(tag=tag.name, format=self.file_format)
        paths = [self.path_template.format(asset=tag.asset, **fields)] if tag.asset else []
        collapsed = "/".join(seg for seg in self.path_template.format(asset="", **fields)
                             .split("/") if seg)
        if collapsed not in paths:
            paths.append(collapsed)
        return paths

    @staticmethod
    def _shared_key_signature(account: str, key: str, verb: str, path: str, headers: dict,
                              params: dict) -> str:
        """The Storage SharedKey signature: HMAC-SHA256, under the decoded
        account key, of the verb, eleven empty standard headers, the
        canonical ``x-ms-*`` headers and the canonical resource with its
        sorted query parameters."""
        ms_headers = "".join(f"{name.lower()}:{value}\n"
                             for name, value in sorted(headers.items())
                             if name.lower().startswith("x-ms-"))
        canonical_params = "".join(f"\n{name.lower()}:{value}"
                                   for name, value in sorted(params.items()))
        string_to_sign = (f"{verb}\n" + "\n" * 11
                          + f"{ms_headers}/{account}{path}{canonical_params}")
        digest = hmac.new(base64.b64decode(key), string_to_sign.encode("utf-8"),
                          hashlib.sha256).digest()
        return base64.b64encode(digest).decode()

    def _get(self, path: str):
        """The authenticated GET of one file of the file system."""
        # quoted before the URL is built ('#' in a tag would start a
        # fragment), and signed in the quoted form Azure canonicalises
        url_path = f"/{self.filesystem}/{urllib.parse.quote(path)}"
        headers = {"x-ms-version": self.API_VERSION}
        params: dict = {}
        if self.sas_token:
            # decoded here and encoded again on the wire; blank values kept,
            # since dropping one changes the signed query
            params.update(urllib.parse.parse_qsl(self.sas_token.lstrip("?"),
                                                 keep_blank_values=True))
        elif self.bearer_token:
            headers["Authorization"] = f"Bearer {self.bearer_token}"
        elif self.account_key:
            headers["x-ms-date"] = email.utils.formatdate(usegmt=True)
            signature = self._shared_key_signature(self.store_name, self.account_key, "GET",
                                                   url_path, headers, params)
            headers["Authorization"] = f"SharedKey {self.store_name}:{signature}"
        else:
            raise ValueError(
                "DataLakeProvider has no credentials: set sas_token, bearer_token or "
                "account_key (or AZURE_STORAGE_SAS_TOKEN / AZURE_STORAGE_TOKEN / "
                "AZURE_STORAGE_KEY)")
        return self.session.get(f"{self.base_url}{url_path}", headers=headers, params=params)

    def load_series(self, train_start_date: datetime, train_end_date: datetime,
                    tag_list: List[SensorTag], dry_run: bool = False) -> Iterable[Series]:
        for tag in tag_list:
            resp = None
            for path in self._paths_for(tag):
                resp = self._get(path)
                if getattr(resp, "status_code", 200) != 404:
                    break
            if getattr(resp, "status_code", 200) != 200:
                raise IOError(f"ADLS read failed for tag {tag.name!r} ({resp.status_code}): "
                              f"{getattr(resp, 'text', '')[:300]}")
            series = read_series_csv(resp.content, tag.name)
            yield _clip_window(series, train_start_date, train_end_date, dry_run, tag.name)
