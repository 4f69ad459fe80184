"""
The port's server surface against the JAX package's on the CPU: a small
Transformer detector built by the JAX package (the config of
``tests/test_torch_serving.py``) is carried into a port artifact, then the
JAX ``build_app`` (werkzeug's test client) and the port's server (over
HTTP) answer the same requests on every route of
``gordo_tpu/server/server.py``'s table but ``/metrics``, ``/debug/*`` and
``/gordo/v0/openapi.json``. Statuses and JSON body keys must match exactly;
base-route values within TOL (float32 models on both sides, summed in
another order). Also: ``make_base_raw`` against the JAX one, the
artifact's ``dumps``/``loads`` round trip, and ``run-server``.
"""

import html
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

import numpy as np
import pandas as pd
import pytest

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder.local_build import local_build
from gordo_tpu.models import utils as jax_utils
from gordo_tpu.server.server import build_app
from gordo_tpu.server.utils import dataframe_to_dict
from gordo_tpu_torch import serializer
from gordo_tpu_torch.models.utils import make_base_raw
from gordo_tpu_torch.server.server import make_server
from test_torch_serving import CONFIG, NAME, REPO, _assert_same_data, _payload, _port_from_jax_artifact

TOL = dict(atol=1e-5, rtol=1e-5)  # as _assert_same_data holds floats
PROJECT = "/gordo/v0/proj"


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    """(JAX collection dir, port collection dir) at revision 111, each with
    a sibling revision 222 holding the same artifact."""
    root = tmp_path_factory.mktemp("surface")
    jax_coll, port_coll = root / "jax" / "111", root / "port" / "111"
    (model, machine), = local_build(CONFIG)
    jax_serializer.dump(model, str(jax_coll / NAME), metadata=machine.to_dict())
    _port_from_jax_artifact(str(jax_coll / NAME), str(port_coll / NAME))
    for coll in (jax_coll, port_coll):
        shutil.copytree(coll, coll.parent / "222")
    return str(jax_coll), str(port_coll)


class _Port:
    """The port's server on a free port, in a thread."""

    def __init__(self, collection):
        self.server = make_server("127.0.0.1", 0, device="cpu", collection_dir=collection)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()

    def request(self, path, payload=None, headers=None):
        """(status, body bytes, headers)."""
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(self.url + path, data=data, headers={
            "Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, resp.read(), resp.headers
        except urllib.error.HTTPError as err:
            return err.code, err.read(), err.headers


@pytest.fixture(scope="module")
def port(collections):
    server = _Port(collections[1])
    yield server
    server.close()


def _jax(collection, path, payload=None, headers=None):
    client = build_app({"MODEL_COLLECTION_DIR": collection}).test_client()
    if payload is None:
        resp = client.get(path, headers=headers or {})
    else:
        resp = client.post(path, json=payload, headers=headers or {})
    return resp.status_code, resp.get_data(), resp.headers


def _json(body: bytes):
    return json.loads(body) if body else None


GET_ROUTES = ["/healthcheck", "/readiness", "/server-version", f"{PROJECT}/models",
              f"{PROJECT}/revisions", f"{PROJECT}/expected-models",
              f"{PROJECT}/{NAME}/metadata", f"{PROJECT}/{NAME}/healthcheck"]


@pytest.mark.parametrize("revision", [None, "222"])
@pytest.mark.parametrize("route", GET_ROUTES)
def test_get_routes_answer_like_jax(collections, port, route, revision):
    path = route if revision is None else f"{route}?revision={revision}"
    theirs = _jax(collections[0], path)
    ours = port.request(path)
    assert ours[0] == theirs[0] == 200
    assert ours[2].get("revision") == theirs[2].get("revision") == (revision or "111")
    mine, jax_body = _json(ours[1]), _json(theirs[1])
    if jax_body is None:
        assert mine is None
        return
    assert sorted(mine) == sorted(jax_body)
    if route.endswith(("models", "revisions", "expected-models", "readiness")):
        assert mine == jax_body
    if route.endswith(("metadata", "healthcheck")) and route != "/healthcheck":
        assert mine["metadata"]["name"] == jax_body["metadata"]["name"] == NAME
        assert sorted(mine["metadata"]) == sorted(jax_body["metadata"])


@pytest.mark.parametrize("route", GET_ROUTES + [f"{PROJECT}/{NAME}/download-model"])
def test_unknown_revision_is_gone_like_jax(collections, port, route):
    theirs = _jax(collections[0], route, headers={"revision": "nope"})
    ours = port.request(route, headers={"revision": "nope"})
    assert ours[0] == theirs[0] == 410
    assert _json(ours[1]) == _json(theirs[1]) == {"error": "Revision 'nope' not found."}


@pytest.mark.parametrize("frame", ["timestamps", "lists"])
def test_base_prediction_answers_like_jax(collections, port, frame):
    payload = _payload(60, seed=4)
    if frame == "lists":
        payload = {"X": pd.DataFrame(payload["X"]).to_numpy().tolist()}
    path = f"{PROJECT}/{NAME}/prediction"
    theirs = _jax(collections[0], path, payload)
    ours = port.request(path, payload)
    assert ours[0] == theirs[0] == 200
    mine, jax_body = _json(ours[1]), _json(theirs[1])
    assert sorted(mine) == sorted(jax_body) == ["data", "revision", "time-seconds"]
    assert sorted(mine["data"]) == ["end", "model-input", "model-output", "start"]
    assert len(mine["data"]["model-output"]["tag-0"]) == 60 - 16 + 1
    _assert_same_data(mine["data"], jax_body["data"])


@pytest.mark.parametrize("case", ["no X", "bad widths", "too few rows", "unknown model"])
def test_base_prediction_errors_answer_like_jax(collections, port, case):
    payload = _payload(40)
    name = NAME
    if case == "no X":
        payload = {"y": payload["y"]}
    elif case == "bad widths":
        payload = {"X": [[0.5] * 3] * 40}
    elif case == "too few rows":
        payload = _payload(10)
    else:
        name = "nope"
    path = f"{PROJECT}/{name}/prediction"
    theirs = _jax(collections[0], path, payload)
    ours = port.request(path, payload)
    expected = 404 if case == "unknown model" else 400
    assert ours[0] == theirs[0] == expected
    mine = _json(ours[1])
    if case == "unknown model":
        # the JAX server answers werkzeug's HTML page of the same message
        assert mine["message"] == "No such model found: 'nope'"
        assert mine["message"] in html.unescape(theirs[1].decode())
        return
    jax_body = _json(theirs[1])
    assert sorted(mine) == sorted(jax_body)
    if case == "too few rows":
        assert mine["error"].startswith("ValueError: ")
        assert jax_body["error"].startswith("ValueError: ")
    else:
        assert mine == jax_body


@pytest.mark.parametrize("route", ["metadata", "healthcheck", "download-model"])
def test_unknown_model_is_not_found_like_jax(collections, port, route):
    path = f"{PROJECT}/nope/{route}"
    theirs = _jax(collections[0], path)
    ours = port.request(path)
    assert ours[0] == theirs[0] == 404
    assert _json(ours[1])["message"] in html.unescape(theirs[1].decode())


def _expected_cases(tmp_path):
    good = tmp_path / "expected.json"
    good.write_text(json.dumps([NAME, "other"]))
    return {
        "env met": ({"EXPECTED_MODELS": json.dumps([NAME])}, 200),
        "env unmet": ({"EXPECTED_MODELS": json.dumps([NAME, "other"])}, 503),
        "file unmet": ({"EXPECTED_MODELS_FILE": str(good)}, 503),
        "file unreadable": ({"EXPECTED_MODELS_FILE": str(tmp_path / "missing.json")}, 503),
        "none": ({}, 200),
    }


@pytest.mark.parametrize("case", ["env met", "env unmet", "file unmet", "file unreadable", "none"])
def test_readiness_and_expected_models_like_jax(collections, tmp_path, monkeypatch, case):
    env, status = _expected_cases(tmp_path)[case]
    monkeypatch.delenv("EXPECTED_MODELS", raising=False)
    monkeypatch.delenv("EXPECTED_MODELS_FILE", raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    server = _Port(collections[1])
    try:
        for route, expected in (("/readiness", status),
                                (f"{PROJECT}/expected-models",
                                 503 if case == "file unreadable" else 200)):
            theirs = _jax(collections[0], route)
            ours = server.request(route)
            assert ours[0] == theirs[0] == expected, route
            mine, jax_body = _json(ours[1]), _json(theirs[1])
            if route == "/readiness" and case == "file unreadable":
                # the message names the file, as both servers write it
                assert mine == jax_body and mine["ready"] is False
            else:
                assert mine == jax_body, route
    finally:
        server.close()


def test_download_model_loads_back_and_predicts_the_same(collections, port):
    path = f"{PROJECT}/{NAME}/download-model"
    theirs = _jax(collections[0], path)
    status, body, headers = port.request(path)
    assert status == theirs[0] == 200
    assert headers["Content-Type"] == theirs[2]["Content-Type"] == "application/octet-stream"
    assert (headers["Content-Disposition"] == theirs[2]["Content-Disposition"]
            == "attachment; filename=model.tar.gz")
    loaded = serializer.loads(body, device="cpu")
    served = serializer.load(os.path.join(collections[1], NAME), device="cpu")
    X = np.random.RandomState(5).rand(40, 4)
    np.testing.assert_array_equal(loaded.predict(X), served.predict(X))
    assert loaded.aggregate_threshold_ == served.aggregate_threshold_


def test_dumps_and_loads_round_trip(collections, tmp_path):
    source = os.path.join(collections[1], NAME)
    data = serializer.dumps(source)
    again = serializer.loads(data, device="cpu")
    serializer.dump(again, str(tmp_path / "m"), tags=[f"tag-{i}" for i in range(4)],
                    metadata=serializer.load_metadata(source))
    assert serializer.loads(serializer.dumps(str(tmp_path / "m")), device="cpu").window == 6
    with open(os.path.join(source, "model.json")) as f, \
            open(tmp_path / "m" / "model.json") as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("timed", [True, False])
def test_make_base_raw_is_jax_make_base_raw(timed):
    t0 = datetime(2020, 1, 1, tzinfo=timezone.utc)
    index = [t0 + timedelta(minutes=10 * i) for i in range(5)] if timed else None
    model_input = np.arange(15.0).reshape(5, 3)
    model_output = np.arange(6.0).reshape(3, 2) / 7  # a windowed model's 3 rows, 2 outputs
    tags = ["a", "b", "c"]
    theirs = dataframe_to_dict(jax_utils.make_base_raw(
        tags, model_input, model_output, ["a", "b"],
        pd.DatetimeIndex(index) if timed else None, timedelta(minutes=10)).to_pandas())
    ours = make_base_raw(tags, model_input, model_output, ["a", "b"], index,
                         timedelta(minutes=10)).to_dict()
    assert json.loads(json.dumps(ours)) == json.loads(json.dumps(theirs, default=str))


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_run_server_answers_healthcheck(collections):
    port_number = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "gordo_tpu_torch", "run-server", "--host", "127.0.0.1",
         "--port", str(port_number), "--device", "cpu"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        env={**os.environ, "PYTHONPATH": REPO, "MODEL_COLLECTION_DIR": collections[1]},
    )
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port_number}/healthcheck", timeout=5) as resp:
                    assert resp.status == 200 and resp.headers["revision"] == "111"
                    break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.stderr.read().decode()
                assert time.monotonic() < deadline, "run-server did not answer in 60 s"
                time.sleep(0.2)
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
