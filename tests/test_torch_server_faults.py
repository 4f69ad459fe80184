"""
The port's server against the JAX package's on six edges of the request
surface, each request sent to the JAX ``build_app`` (werkzeug's test
client) and to the port's ``make_server`` (over HTTP) on the artifact pair
of ``tests/test_torch_server_surface.py``: the same status and the same
structure (JSON keys, blocks, sub-columns, index keys; values within the
served tolerance of ``_assert_same_data``).

1. Bodies in the column-dict-of-lists and list-of-records layouts that
   ``pd.DataFrame(data)`` reads.
2. An unreadable artifact beside a healthy one: the server starts, the
   healthy model answers 200 and the broken one 500.
3. An artifact written after the start is served at once, and the
   ``…/models`` listing agrees with the model routes.
4. ``?format=parquet``: JAX answers parquet bytes; the port, without
   pyarrow on the card's machine, refuses it explicitly (501, JSON).
5. ``Server-Timing`` on every response, error classes included, with the
   same entries in the same order.
6. PUT and DELETE on a prediction route are 405 with ``Allow: POST``; a
   JSON body sent as ``text/plain`` has no X (400).
"""

import json
import shutil
import urllib.error
import urllib.request

import pandas as pd
import pytest

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder.local_build import local_build
from gordo_tpu.server.server import build_app
from gordo_tpu_torch.server import views
from test_torch_server_surface import PROJECT, _json
from test_torch_server_surface import _Port as _SurfacePort
from test_torch_serving import CONFIG, NAME, _assert_same_data, _payload, _port_from_jax_artifact

ROUTES = ["prediction", "anomaly/prediction"]


class _Port(_SurfacePort):
    def request(self, path, payload=None, headers=None, method=None):
        """(status, body bytes, headers) of any method; ``payload`` as JSON,
        or bytes sent as they are."""
        data = payload if isinstance(payload, bytes) or payload is None else (
            json.dumps(payload).encode())
        req = urllib.request.Request(self.url + path, data=data, method=method, headers={
            "Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, resp.read(), resp.headers
        except urllib.error.HTTPError as err:
            return err.code, err.read(), err.headers


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(JAX artifact dir, port artifact dir) of the served model."""
    root = tmp_path_factory.mktemp("faults")
    (model, machine), = local_build(CONFIG)
    jax_serializer.dump(model, str(root / "jax" / NAME), metadata=machine.to_dict())
    _port_from_jax_artifact(str(root / "jax" / NAME), str(root / "port" / NAME))
    return root / "jax" / NAME, root / "port" / NAME


@pytest.fixture
def collections(artifacts, tmp_path):
    """A fresh (JAX, port) pair of collections at revision 111, each holding
    the served model."""
    pair = tmp_path / "jax" / "111", tmp_path / "port" / "111"
    for source, collection in zip(artifacts, pair):
        shutil.copytree(source, collection / NAME)
    return pair


@pytest.fixture
def port(collections):
    server = _Port(str(collections[1]))
    yield server
    server.close()


def _jax(collection, path, payload=None, method="POST", **kwargs):
    """(status, body bytes, headers) of the JAX server."""
    client = build_app({"MODEL_COLLECTION_DIR": str(collection)}).test_client()
    if payload is not None:
        kwargs.setdefault("json", payload)
    resp = client.open(path, method=method, **kwargs)
    return resp.status_code, resp.get_data(), resp.headers


def _answers_alike(ours, theirs, status: int) -> None:
    assert ours[0] == theirs[0] == status
    mine, jax_body = _json(ours[1]), _json(theirs[1])
    assert sorted(mine) == sorted(jax_body)
    if "data" in jax_body:
        _assert_same_data(mine["data"], jax_body["data"])
    else:
        assert mine == jax_body


def _column_lists(frame: dict) -> dict:
    return pd.DataFrame(frame).to_dict(orient="list")


def _records(frame: dict) -> list:
    return pd.DataFrame(frame).to_dict(orient="records")


@pytest.mark.parametrize("layout", [_column_lists, _records])
@pytest.mark.parametrize("route", ROUTES)
def test_column_lists_and_records_answer_like_jax(collections, port, layout, route):
    payload = {key: layout(frame) for key, frame in _payload(40, seed=5).items()}
    path = f"{PROJECT}/{NAME}/{route}"
    ours, theirs = port.request(path, payload), _jax(collections[0], path, payload)
    _answers_alike(ours, theirs, 200)
    assert list(_json(ours[1])["data"]["model-output"]["tag-0"])[0] == "15"


def _break(collection, name: str, file: str) -> None:
    """A sibling artifact that cannot be read: the served one's files with
    ``file`` overwritten by garbage."""
    shutil.copytree(collection / NAME, collection / name)
    (collection / name / file).write_bytes(b"\x00 not an artifact")


@pytest.mark.parametrize("route", ROUTES)
def test_broken_artifact_beside_a_healthy_one_answers_like_jax(collections, route):
    _break(collections[0], "broken", "model.pkl")
    _break(collections[1], "broken", "model.json")
    port = _Port(str(collections[1]))  # the start does not load, so it cannot fail
    try:
        payload = _payload(40, seed=6)
        for name, status in ((NAME, 200), ("broken", 500), ("broken", 500), (NAME, 200)):
            path = f"{PROJECT}/{name}/{route}"
            ours, theirs = port.request(path, payload), _jax(collections[0], path, payload)
            _answers_alike(ours, theirs, status)
            if status == 500:
                assert _json(ours[1]) == {"error": "Model 'broken' failed to load",
                                          "revision": "111"}
    finally:
        port.close()


@pytest.mark.parametrize("route", ROUTES)
def test_artifact_written_after_start_is_served_like_jax(collections, port, route):
    listing = f"{PROJECT}/models"
    path = f"{PROJECT}/late/{route}"
    payload = _payload(40, seed=7)
    _answers_alike(port.request(listing), _jax(collections[0], listing, method="GET"), 200)
    assert port.request(path, payload)[0] == _jax(collections[0], path, payload)[0] == 404
    for collection in collections:
        shutil.copytree(collection / NAME, collection / "late")
    ours, theirs = port.request(listing), _jax(collections[0], listing, method="GET")
    _answers_alike(ours, theirs, 200)
    assert _json(ours[1])["models"] == ["late", NAME]
    _answers_alike(port.request(path, payload), _jax(collections[0], path, payload), 200)


@pytest.mark.parametrize("route", ROUTES)
def test_parquet_is_refused_not_answered_as_json(collections, port, route):
    path = f"{PROJECT}/{NAME}/{route}?format=parquet"
    payload = _payload(40, seed=8)
    theirs = _jax(collections[0], path, payload)
    assert theirs[0] == 200 and theirs[2]["Content-Type"] == "application/octet-stream"
    assert theirs[1][:4] == b"PAR1"
    status, body, headers = port.request(path, payload)
    assert status == 501 and headers["Content-Type"] == "application/json"
    assert json.loads(body) == {"error": views.PARQUET_REFUSAL, "revision": "111"}


def _timing_names(headers) -> list:
    entries = [entry.split(";dur=") for entry in headers["Server-Timing"].split(", ")]
    assert all(float(seconds) >= 0.0 for _, seconds in entries)
    return [name for name, _ in entries]


TIMING_CASES = {
    "anomaly 200": ("POST", f"{PROJECT}/{NAME}/anomaly/prediction", _payload(40), {}),
    "base 200": ("POST", f"{PROJECT}/{NAME}/prediction", _payload(40), {}),
    "no X 400": ("POST", f"{PROJECT}/{NAME}/anomaly/prediction", {"y": _payload(40)["y"]}, {}),
    "no y 400": ("POST", f"{PROJECT}/{NAME}/anomaly/prediction", {"X": _payload(40)["X"]}, {}),
    "unknown model 404": ("POST", f"{PROJECT}/nope/prediction", _payload(40), {}),
    "unhandled 500": ("POST", f"{PROJECT}/{NAME}/anomaly/prediction", _payload(10), {}),
    "PUT 405": ("PUT", f"{PROJECT}/{NAME}/prediction", None, {}),
    "revision 410": ("GET", f"{PROJECT}/{NAME}/metadata", None, {"revision": "nope"}),
    "metadata 200": ("GET", f"{PROJECT}/{NAME}/metadata", None, {}),
    "healthcheck 200": ("GET", "/healthcheck", None, {}),
}


@pytest.mark.parametrize("case", list(TIMING_CASES))
def test_server_timing_on_every_response_like_jax(collections, port, case):
    method, path, payload, headers = TIMING_CASES[case]
    theirs = _jax(collections[0], path, payload, method=method, headers=headers)
    ours = port.request(path, payload, headers=headers, method=method)
    assert ours[0] == theirs[0] == int(case.split()[-1])
    names = _timing_names(ours[2])
    assert names == _timing_names(theirs[2])
    assert names[0] == "request_walltime_s"
    assert names[1:] == {"200": ["decode_s", "predict_s", "encode_s"],
                         "400": ["decode_s"], "500": ["decode_s", "predict_s"]}.get(
        case.split()[-1] if path.endswith("prediction") else "", [])


@pytest.mark.parametrize("method", ["PUT", "DELETE"])
@pytest.mark.parametrize("route", ROUTES)
def test_other_methods_on_prediction_routes_are_405_like_jax(collections, port, method, route):
    path = f"{PROJECT}/{NAME}/{route}"
    theirs = _jax(collections[0], path, method=method)
    ours = port.request(path, method=method)
    assert ours[0] == theirs[0] == 405
    assert ours[2]["Allow"] == theirs[2]["Allow"] == "POST"


@pytest.mark.parametrize("method", ["PUT", "DELETE"])
def test_other_methods_on_get_routes_answer_like_jax(collections, port, method):
    """werkzeug's rules without methods take every method: the metadata
    view answers a PUT or a DELETE as it answers a GET."""
    path = f"{PROJECT}/{NAME}/metadata"
    theirs = _jax(collections[0], path, method=method)
    ours = port.request(path, method=method)
    assert ours[0] == theirs[0] == 200
    assert sorted(_json(ours[1])) == sorted(_json(theirs[1]))


@pytest.mark.parametrize("route", ROUTES)
def test_json_sent_as_text_has_no_x_like_jax(collections, port, route):
    path = f"{PROJECT}/{NAME}/{route}"
    body = json.dumps(_payload(40, seed=9))
    theirs = _jax(collections[0], path, data=body, content_type="text/plain")
    ours = port.request(path, body.encode(), headers={"Content-Type": "text/plain"})
    _answers_alike(ours, theirs, 400)
    assert _json(ours[1]) == {"message": 'Cannot predict without "X"', "revision": "111"}
