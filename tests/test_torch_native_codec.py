"""
The port's native request codec (gordo_tpu_torch/native/, server/fast_codec.py)
against the JAX package's (``gordo_tpu.native``, ``gordo_tpu.server.fast_codec``)
and against the port's own dict path, on the CPU:

- ``parse_xy``, ``parse_columns`` and ``encode_template`` give what
  ``gordo_tpu.native`` gives on the same bodies, the refused ones included;
- ``decode_body_xy`` gives the frames ``views.decode_frame`` gives, and
  refuses the bodies the JAX codec refuses;
- ``encode_raw`` is byte-identical to ``json.dumps`` of ``RawFrame.to_dict()``
  and, parsed, equal to the JAX ``fast_codec.encode_raw`` of the same numbers;
- a mismatch poisons the native encoder; ``X-Gordo-Codec: pandas`` and
  ``GORDO_TPU_FAST_CODEC=0`` take the dict path, with the same bytes;
- a failed build raises with the compiler's output.
"""

import json
import re
import threading
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

import numpy as np
import pandas as pd
import pytest
import torch

from gordo_tpu import native as jax_native
from gordo_tpu.models import utils as jax_utils
from gordo_tpu.server import fast_codec as jax_codec
from gordo_tpu_torch import native, serializer
from gordo_tpu_torch.models.models import TransformerAutoEncoder
from gordo_tpu_torch.models.utils import RawFrame
from gordo_tpu_torch.ops.nn import init_model_params
from gordo_tpu_torch.serializer.from_jax import detector_from_arrays
from gordo_tpu_torch.server import fast_codec, views
from gordo_tpu_torch.server.server import make_server

TAGS = ["tag-0", "tag-1", "tag-2", "tag-3"]
T0 = datetime(2020, 1, 1, tzinfo=timezone.utc)


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    assert jax_native.prebuild(block=True), "the JAX package's native library did not build"
    native.load()


def _stamps(n, start=T0):
    return [(start + timedelta(minutes=10 * i)).isoformat() for i in range(n)]


def _coldict(values, columns, keys):
    return {c: dict(zip(keys, values[:, j].tolist())) for j, c in enumerate(columns)}


RNG = np.random.RandomState(0)
RECT = RNG.rand(30, 4)
BODIES = {
    # taken by parse_xy
    "rect X": json.dumps({"X": RECT.tolist()}).encode(),
    "rect X and y": json.dumps({"X": RECT.tolist(), "y": RECT[:, :2].tolist()}).encode(),
    "rect y null": json.dumps({"X": RECT.tolist(), "y": None}).encode(),
    "rect nulls": b'{"X": [[1.0, null, 3.0], [null, 5.0, 6.0]]}',
    "rect compact": b'{"X":[[1,2],[3,4]],"y":[[5],[6]]}',
    "rect extremes": json.dumps({"X": [[1e300, -1e-300, 5e-324, -0.0, 123456789012345678]]
                                 }).encode(),
    # taken by parse_columns
    "coldict times": json.dumps({"X": _coldict(RECT, TAGS, _stamps(30))}).encode(),
    "coldict int keys": json.dumps({"X": _coldict(RECT[:5], "abc", ["0", "1", "2", "3", "4"])}
                                   ).encode(),
    "coldict unsorted, nulls":
        b'{"X": {"a": {"2": 3.0, "0": null, "1": 2.0}, "b": {"2": 30.0, "0": 10.0, "1": null}}}',
    "coldict y null": json.dumps({"X": _coldict(RECT[:3], "ab", ["0", "1", "2"]), "y": None}
                                 ).encode(),
    "coldict unicode name": '{"X": {"tåg": {"0": 1.0}}}'.encode(),
    # refused by both grammars (the JAX codec's fallback bodies)
    "ragged columns": b'{"X": {"a": {"0": 1.0}, "b": {"0": 1.0, "1": 2.0}}}',
    "reordered keys": b'{"X": {"a": {"0": 1.0, "1": 2.0}, "b": {"1": 2.0, "0": 1.0}}}',
    "duplicate column": b'{"X": {"a": {"0": 1.0}, "a": {"0": 2.0}}}',
    "duplicate key": b'{"X": {"a": {"0": 1.0, "0": 2.0}}}',
    "escaped key": b'{"X": {"\\u0061": {"0": 1.0}}}',
    "column-dict y": b'{"X": {"a": {"0": 1.0}}, "y": {"a": {"0": 1.0}}}',
    "non-numeric cell": b'{"X": {"a": {"0": "oops"}}}',
    "multi-level": b'{"X": {"top": {"sub": {"0": 1.0}}}}',
    "trailing garbage": b'{"X": {"a": {"0": 1.0}}} x',
    "ragged rows": b'{"X": [[1.0, 2.0], [3.0]]}',
    "extra key": b'{"X": [[1.0]], "z": 1}',
    "no X": b'{"y": [[1.0]]}',
    "bool cell": b'{"X": [[true, 1.0]]}',
    "not json": b'{"X": [[1.0,',
    "empty": b"",
}


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is b
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("name", sorted(BODIES))
def test_parsers_are_the_jax_native_parsers(name):
    body = BODIES[name]
    for ours, theirs in ((native.parse_xy, jax_native.parse_xy),
                         (native.parse_columns, jax_native.parse_columns)):
        assert _same(ours(body), theirs(body)), (name, ours.__name__)
    taken = native.parse_xy(body) is not None or native.parse_columns(body) is not None
    assert taken == (name.startswith("rect ") or name.startswith("coldict ")), name


@pytest.mark.parametrize("name", sorted(BODIES))
def test_decode_body_is_decode_frame(name):
    """A body the native lane takes gives the frames the dict path gives;
    every other body is left to the dict path, as the JAX codec leaves it."""
    body = BODIES[name]
    parsed = fast_codec.decode_body_xy(body)
    assert (parsed is None) == (jax_codec.decode_body_xy(body) is None), name
    if parsed is None:
        return
    payload = json.loads(body)
    for frame, data in zip(parsed, (payload["X"], payload.get("y"))):
        if data is None:
            assert frame is None
            continue
        ref = views.decode_frame(data)
        np.testing.assert_array_equal(frame.values, ref.values)
        assert frame.columns == ref.columns and frame.index == ref.index


@pytest.mark.parametrize("values", [
    np.random.RandomState(1).randn(50),
    np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 5e-324, 1e300, -1e-300, 0.1, 1 / 3]),
    np.random.RandomState(2).rand(7).astype(np.float32).astype(np.float64),
])
def test_encode_template_is_the_jax_encoder(values):
    chunks = [f'"k{i}": '.encode() for i in range(len(values))] + [b"}"]
    template = b"{" + b"".join(chunks)
    lens = np.array([len(chunks[0]) + 1] + [len(c) for c in chunks[1:]], np.int32)
    ours = native.encode_template(template, lens, values)
    assert ours == jax_native.encode_template(template, lens, values)
    assert ours.count(b"null") == int((~np.isfinite(values)).sum())


def _raw(index, frequency=None, nan=False, seed=3):
    rng = np.random.RandomState(seed)
    n = len(index)
    groups = [("model-input", TAGS, rng.rand(n, 4)),
              ("model-output", TAGS, rng.rand(n, 4).astype(np.float32)),
              ("tag-anomaly-scaled", TAGS, rng.rand(n, 4)),
              ("total-anomaly-scaled", ("",), rng.rand(n, 1))]
    if nan:
        groups[0][2][0, 0] = np.nan
        groups[2][2][-1, -1] = np.inf
        groups[3][2][n // 2, 0] = -np.inf
    return RawFrame(groups, index, frequency)


FRAMES = {
    "rows from 0": lambda: _raw(range(12)),
    "rows from 15": lambda: _raw(range(15, 40)),
    "rows with gaps": lambda: _raw([3, 1, 7, 20]),
    "times": lambda: _raw([T0 + timedelta(minutes=10 * i) for i in range(9)],
                          timedelta(minutes=10)),
    "times, no frequency": lambda: _raw([T0 + timedelta(minutes=10 * i) for i in range(9)]),
    "times, microseconds": lambda: _raw(
        [T0 + timedelta(seconds=1.5 * i) for i in range(5)], timedelta(seconds=1)),
    "non-finite values": lambda: _raw(range(10), nan=True),
    "one row": lambda: _raw(range(1)),
    "a group dropped": lambda: _raw(range(6)).drop_top_level(["tag-anomaly-scaled"]),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_encode_raw_is_the_dict_path(name):
    raw = FRAMES[name]()
    fragment = fast_codec.encode_raw(raw)
    assert fragment is not None, name
    assert fragment == json.dumps(raw.to_dict())
    assert fragment == views.json_text(raw.to_dict())


@pytest.mark.parametrize("name", ["duplicate group", "group named start", "empty group",
                                  "repeated rows", "no rows", "integer values",
                                  "non-string column"])
def test_encode_raw_leaves_other_frames_to_the_dict_path(name):
    rows = np.random.RandomState(4).rand(3, 1)
    groups = {
        "duplicate group": [("a", ("x",), rows), ("a", ("y",), rows)],
        "group named start": [("start", ("x",), rows)],
        "empty group": [("a", (), np.zeros((3, 0)))],
        "repeated rows": [("a", ("x",), rows)],
        "no rows": [("a", ("x",), np.zeros((0, 1)))],
        "integer values": [("a", ("x",), np.arange(3)[:, None])],
        "non-string column": [("a", (1,), rows)],
    }[name]
    index = {"repeated rows": [0, 0, 1], "no rows": []}.get(name, range(3))
    assert fast_codec.encode_raw(RawFrame(groups, index)) is None


@pytest.mark.parametrize("timed", [False, True], ids=["rows", "times"])
@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
def test_encode_raw_parses_equal_to_the_jax_codec(timed, nan):
    """The same numbers through the JAX package's encoder (pandas frames)
    and the port's (its own frames) parse to the same document."""
    if timed:
        index = [T0 + timedelta(minutes=10 * i) for i in range(8)]
        frequency = timedelta(minutes=10)
    else:
        index, frequency = list(range(8)), None
    ours = _raw(index, frequency, nan)
    theirs = jax_utils.RawFrame(
        [(top, list(subs), values) for top, subs, values in ours.groups],
        pd.DatetimeIndex(index) if timed else pd.RangeIndex(8), frequency)
    assert json.loads(fast_codec.encode_raw(ours)) == json.loads(jax_codec.encode_raw(theirs))


def test_splice_response_body():
    assert (fast_codec.splice_response_body('{"k": 1}', '{"revision": "r"}')
            == '{"data": {"k": 1}, "revision": "r"}')
    assert fast_codec.splice_response_body('{"k": 1}', "{}") == '{"data": {"k": 1}}'
    body = {"data": _raw(range(4)), "time-seconds": "0.0100", "revision": "7"}
    expected = json.dumps({"data": body["data"].to_dict(), "time-seconds": "0.0100",
                           "revision": "7"}).encode()
    assert views.response_bytes(body, fast=True) == views.response_bytes(body, fast=False)
    assert views.response_bytes(body, fast=True) == expected


@pytest.fixture
def clean_codec(monkeypatch):
    """The encoder unpoisoned and unchecked, the counters at 0."""
    monkeypatch.setattr(fast_codec, "_native_poisoned", False)
    monkeypatch.setattr(fast_codec, "_native_checked", set())
    for name in fast_codec.COUNTERS:
        monkeypatch.setattr(fast_codec, name, 0)


def test_a_mismatch_poisons_the_native_encoder(monkeypatch, clean_codec):
    raw = _raw(range(30, 36))
    real = native.encode_template
    monkeypatch.setattr(native, "encode_template",
                        lambda *args: real(*args).replace(b"0.", b"9.", 1))
    assert fast_codec.encode_raw(raw) is None
    assert fast_codec._native_poisoned and fast_codec.POISONINGS == 1
    monkeypatch.setattr(native, "encode_template", real)
    # poisoned for the process: another frame no longer takes the encoder
    assert fast_codec.encode_raw(_raw(range(3))) is None
    body = {"data": raw, "time-seconds": "0.0"}
    assert views.response_bytes(body, fast=True) == json.dumps(
        {"data": raw.to_dict(), "time-seconds": "0.0"}).encode()
    assert fast_codec.ENCODE_FALLBACKS == 1 and fast_codec.NATIVE_ENCODES == 0


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    broken = tmp_path / "gordo_native.cpp"
    broken.write_text('extern "C" int f() { return undeclared_name; }\n')
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    path = native.library_path()
    assert path.parent.parent == tmp_path / "build" and path.name == "libgordo_native.so"
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build()
    assert not path.exists()


def test_the_library_is_built_under_build_by_a_hash_of_source_compiler_and_flags(
        monkeypatch, tmp_path):
    path = native.library_path()
    assert path.exists() and path.parent.parent == native.BUILD_ROOT
    assert native.BUILD_ROOT.parts[-3:] == ("build", "gordo_tpu_torch", "native")
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ("-g",))
    assert native.library_path() != path
    copy = tmp_path / "gordo_native.cpp"
    copy.write_bytes(native.SRC.read_bytes() + b"\n")
    monkeypatch.setattr(native, "FLAGS", native.FLAGS[:-1])
    monkeypatch.setattr(native, "SRC", copy)
    assert native.library_path() != path


# ------------------------------------------------------- through the server
@pytest.fixture(scope="module")
def port_url(tmp_path_factory):
    """The port's server on one small artifact with seeded weights."""
    collection = tmp_path_factory.mktemp("codec") / "5"
    estimator = TransformerAutoEncoder(kind="transformer_model", lookback_window=16,
                                       d_model=32, num_heads=2, ff_dim=64, num_blocks=2)
    spec = estimator.build_spec(4, 4)
    layers = [{k: v.numpy() for k, v in p.items()}
              for p in init_model_params(spec, torch.Generator().manual_seed(0))]
    ones, zeros = np.ones(4), np.zeros(4)
    detector = detector_from_arrays(
        spec, layers, zeros, ones, zeros, ones, estimator_kwargs=estimator.kwargs,
        feature_thresholds=np.full(4, 0.5), aggregate_threshold=0.25, window=6,
        smoothing_method="smm", device="cpu")
    serializer.dump(detector, str(collection / "m"), tags=TAGS,
                    metadata={"name": "m", "dataset": {"tags": TAGS, "resolution": "10min"}})
    server = make_server("127.0.0.1", 0, device="cpu", collection_dir=str(collection))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/p/m"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(url: str, body: bytes, headers=None):
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            status, body = resp.status, resp.read()
    except urllib.error.HTTPError as err:
        status, body = err.code, err.read()
    return status, re.sub(rb'"time-seconds": "[0-9.]+"', b'"time-seconds": ""', body)


def _bodies(n=40):
    values = np.random.RandomState(5).rand(n, 4)
    stamps = _stamps(n)
    return {"rect": json.dumps({"X": values.tolist(), "y": values.tolist()}).encode(),
            "coldict": json.dumps({"X": _coldict(values, TAGS, stamps),
                                   "y": _coldict(values, TAGS, stamps)}).encode(),
            "coldict X": json.dumps({"X": _coldict(values, TAGS, stamps)}).encode()}


@pytest.mark.parametrize("route", ["anomaly/prediction", "anomaly/prediction?all_columns",
                                   "prediction"])
@pytest.mark.parametrize("body", ["rect", "coldict", "coldict X"])
def test_native_lane_answers_the_dict_path_bytes(port_url, clean_codec, monkeypatch, route,
                                                 body):
    """The native lane and the dict path (``X-Gordo-Codec: pandas``, and the
    codec switched off) answer the same bytes; only the native lane counts."""
    payload = _bodies()[body]
    url = f"{port_url}/{route}"
    expected_status = 400 if (body == "coldict X" and route.startswith("anomaly")) else 200
    native_lane = _post(url, payload)
    counts = {name: getattr(fast_codec, name) for name in fast_codec.COUNTERS}
    assert native_lane[0] == expected_status
    assert counts["NATIVE_PARSES"] + counts["PARSE_FALLBACKS"] == 1
    assert counts["NATIVE_PARSES"] == (0 if body == "coldict" else 1)
    assert counts["NATIVE_ENCODES"] == (expected_status == 200)
    assert counts["ENCODE_FALLBACKS"] == counts["POISONINGS"] == 0
    assert _post(url, payload, {"X-Gordo-Codec": "pandas"}) == native_lane
    monkeypatch.setenv("GORDO_TPU_FAST_CODEC", "0")
    assert _post(url, payload) == native_lane
    # with the codec off no header turns it back on
    assert _post(url, payload, {"X-Gordo-Codec": "fast"}) == native_lane
    assert counts == {name: getattr(fast_codec, name) for name in fast_codec.COUNTERS}


def test_counts_are_not_lost_across_threads(monkeypatch, clean_codec):
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [fast_codec.count("NATIVE_PARSES")
                                                    for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert fast_codec.NATIVE_PARSES == 32000


def test_the_switch_and_the_header(monkeypatch):
    monkeypatch.delenv("GORDO_TPU_FAST_CODEC", raising=False)
    assert fast_codec.enabled()
    assert fast_codec.request_enabled({}) and fast_codec.request_enabled({"X-Gordo-Codec": "fast"})
    assert not fast_codec.request_enabled({"X-Gordo-Codec": "Pandas"})
    for off in ("0", "false", "no"):
        monkeypatch.setenv("GORDO_TPU_FAST_CODEC", off)
        assert not fast_codec.enabled() and not fast_codec.request_enabled({})
