"""
The port's socket fast lane, its default lane's keep-alive and
``/gordo/v0/openapi.json`` on the CPU, on the artifact pair of
``tests/test_torch_server_surface.py`` (a small Transformer detector built
by the JAX package, carried into a port artifact).

- Keep-alive on the default lane (``server/server.py``): requests that end
  early (non-JSON POST, 404, 405, 410, ``?format=parquet``) each followed by
  a good request on one ``http.client`` connection, answered on one socket
  by the port; werkzeug's threaded server serving the JAX ``build_app``
  gives each request the same status, and closes the connection after
  every response (werkzeug 3.1 sends ``Connection: close`` always).
  ``Connection: close`` and HTTP/1.0 close the port's connection; a chunked
  body is read whole.
- The fast lane (``server/fastlane.py``): the counterparts of the tests of
  ``tests/gordo_tpu/test_fastlane.py``, each against both lanes (a thread
  per connection and the event loop): the port's fast-lane bodies
  byte-identical to its default lane's (``time-seconds`` masked), and the
  JAX fast lane (same kind, over the JAX app) held to the same status and
  structure, values within ``_assert_same_data``'s tolerance. Left out, as
  they need queue A9: shed 503, breaker 503, deadline 504 and the chaos
  breaker (``traceparent``, ``X-Gordo-Trace`` on every lane and the lanes'
  counters are in ``tests/test_torch_observability_server.py``); and the
  two parquet tests (parquet format,
  multipart parquet), which the port refuses with 501 (no pyarrow on the
  card's machine).
- ``openapi.json``: the JAX document (apart from ``info.version`` where
  the versions differ), its paths covering the port's route table.
"""

import http.client
import json
import os
import re
import selectors
import shutil
import socket
import sys
import threading
import time
from pathlib import Path

import pytest

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder.local_build import local_build
from gordo_tpu.server import fastlane as jax_fastlane
from gordo_tpu.server.openapi import openapi_document as jax_openapi_document
from gordo_tpu.server.server import build_app
from gordo_tpu_torch.server import batcher, fastlane, views
from gordo_tpu_torch.server.openapi import openapi_document
from gordo_tpu_torch.server.server import make_server
from test_torch_serving import CONFIG, NAME, _assert_same_data, _payload, _port_from_jax_artifact

PROJECT = "proj"
SECOND = "tf-second"  # a copy of the served model: another name, same artifact
LANES = ["threads", "event_loop"]


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    """(JAX collection, port collection) at revision 111, each holding the
    served model as NAME and as SECOND."""
    root = tmp_path_factory.mktemp("fastlane")
    jax_coll, port_coll = root / "jax" / "111", root / "port" / "111"
    (model, machine), = local_build(CONFIG)
    jax_serializer.dump(model, str(jax_coll / NAME), metadata=machine.to_dict())
    _port_from_jax_artifact(str(jax_coll / NAME), str(port_coll / NAME))
    for coll in (jax_coll, port_coll):
        shutil.copytree(coll / NAME, coll / SECOND)
    return str(jax_coll), str(port_coll)


class _Serving:
    """A server's ``serve_forever`` in a thread; ``port`` its TCP port."""

    def __init__(self, server):
        self.server = server
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)
        self.thread.start()
        self.port = getattr(server, "server_port", None) or server.server_address[1]

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def app(collections):
    """The port's server as the fast lanes use it: its dispatch, no socket."""
    server = make_server("127.0.0.1", 0, device="cpu", collection_dir=collections[1],
                         bind_and_activate=False)
    yield server
    server.server_close()


@pytest.fixture(scope="module")
def default_lane(collections):
    serving = _Serving(make_server("127.0.0.1", 0, device="cpu", collection_dir=collections[1]))
    yield serving
    serving.close()


@pytest.fixture(scope="module")
def jax_app(collections):
    return build_app({"MODEL_COLLECTION_DIR": collections[0]})


def _lane(module, app, lane, **kwargs):
    cls = module.EventLoopServer if lane == "event_loop" else module.FastLaneServer
    return cls(app, host="127.0.0.1", port=0, **kwargs)


@pytest.fixture(scope="module", params=LANES)
def lanes(app, jax_app, request):
    """(the port's fast lane, the JAX fast lane of the same kind)."""
    ours = _Serving(_lane(fastlane, app, request.param, uds=""))
    theirs = _Serving(_lane(jax_fastlane, jax_app, request.param, uds=""))
    yield ours, theirs
    ours.close()
    theirs.close()


def _request(port, method, path, body=None, headers=None):
    """(status, lower-case headers, body) over a fresh connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


_TIME = re.compile(rb'"time-seconds": "\d+\.\d+"')


def _normalized(body: bytes) -> bytes:
    """The body with its one wall-clock value masked."""
    return _TIME.sub(b'"time-seconds": "T"', body)


def _same_structure(ours: bytes, theirs: bytes) -> None:
    mine, jax_body = json.loads(ours), json.loads(theirs)
    assert sorted(mine) == sorted(jax_body)
    if "data" in jax_body:
        _assert_same_data(mine["data"], jax_body["data"])
    for key in ("message", "error"):
        if key in jax_body:
            assert mine[key] == jax_body[key]


def _assert_parity(lanes, default_lane, path, payload=None, headers=None, method="POST",
                   jax_body=True):
    """The same request down the port's fast lane, its default lane and the
    JAX fast lane: one status; the port's two bodies byte-identical (wall
    clock masked), with ``Server-Timing`` and the same content type; the
    JAX body of the same structure. Returns (status, headers, body) of the
    port's fast lane."""
    body = json.dumps(payload).encode() if payload is not None else None
    send = dict(headers or {})
    if body is not None:
        send.setdefault("Content-Type", "application/json")
    fast = _request(lanes[0].port, method, path, body, send)
    default = _request(default_lane.port, method, path, body, send)
    jax = _request(lanes[1].port, method, path, body, send)
    assert fast[0] == default[0] == jax[0], (fast[0], default[0], jax[0], fast[2][:300],
                                             jax[2][:300])
    assert _normalized(fast[2]) == _normalized(default[2])
    for lane_headers in (fast[1], default[1]):
        assert lane_headers["server-timing"].startswith("request_walltime_s;dur=")
    assert fast[1]["content-type"] == default[1]["content-type"]
    assert fast[1].get("revision") == default[1].get("revision")
    # the JAX app answers some errors with werkzeug's HTML page: their
    # statuses are held, not their bodies
    if jax_body and fast[2] and jax[1].get("content-type", "").startswith("application/json"):
        _same_structure(fast[2], jax[2])
    return fast


def _frames(kind: str, n_rows: int = 40, seed: int = 3) -> dict:
    frames = _payload(n_rows, seed)
    if kind == "column_dict":
        return frames
    rect = {key: [[frame[tag][stamp] for tag in frame] for stamp in next(iter(frame.values()))]
            for key, frame in frames.items()}
    if kind == "with_null":
        rect["X"][0][0] = None
    return rect


ANOMALY = f"/gordo/v0/{PROJECT}/{NAME}/anomaly/prediction"
BASE = f"/gordo/v0/{PROJECT}/{NAME}/prediction"


# ------------------------------------------------------------- golden parity
@pytest.mark.parametrize("kind", ["rect", "column_dict", "with_null"])
def test_parity_anomaly_golden(lanes, default_lane, kind):
    status, headers, body = _assert_parity(lanes, default_lane, ANOMALY, _frames(kind))
    assert status == 200
    assert "total-anomaly-scaled" in json.loads(body)["data"]
    for phase in ("decode_s", "predict_s", "encode_s"):
        assert phase in headers["server-timing"]


@pytest.mark.parametrize("kind", ["rect", "column_dict"])
def test_parity_base_prediction_golden(lanes, default_lane, kind):
    status, _, body = _assert_parity(lanes, default_lane, BASE, {"X": _frames(kind)["X"]})
    assert status == 200
    assert "model-output" in json.loads(body)["data"]


def test_parity_all_columns_query(lanes, default_lane):
    path = f"/gordo/v0/{PROJECT}/{SECOND}/anomaly/prediction?all_columns=true"
    status, _, body = _assert_parity(lanes, default_lane, path, _frames("column_dict"))
    assert status == 200
    assert any(k.startswith("smooth-") for k in json.loads(body)["data"])


def test_parity_pandas_codec_header(lanes, default_lane):
    """``X-Gordo-Codec: pandas`` takes the dict path on both lanes, and the
    answer is the native path's, byte for byte."""
    status, _, body = _assert_parity(lanes, default_lane, ANOMALY, _frames("column_dict"),
                                     headers={"X-Gordo-Codec": "pandas"})
    assert status == 200
    native = _request(lanes[0].port, "POST", ANOMALY, json.dumps(_frames("column_dict")).encode(),
                      {"Content-Type": "application/json"})
    assert _normalized(native[2]) == _normalized(body)


# -------------------------------------------------------------- error classes
def test_parity_400_missing_X(lanes, default_lane):
    status, _, _ = _assert_parity(lanes, default_lane, BASE, {"noX": 1})
    assert status == 400


def test_parity_400_wrong_width(lanes, default_lane):
    frame = {f"c{j}": {str(i): 0.5 for i in range(5)} for j in range(2)}
    status, _, _ = _assert_parity(lanes, default_lane, BASE, {"X": frame})
    assert status == 400


def test_parity_400_anomaly_requires_y(lanes, default_lane):
    status, _, body = _assert_parity(lanes, default_lane, ANOMALY,
                                     {"X": _frames("column_dict")["X"]})
    assert status == 400
    assert "y" in json.loads(body)["message"]


def test_parity_404_unknown_model(lanes, default_lane):
    status, _, _ = _assert_parity(lanes, default_lane,
                                  f"/gordo/v0/{PROJECT}/no-such-model/prediction", {})
    assert status == 404


def test_parity_410_unknown_revision(lanes, default_lane):
    status, _, body = _assert_parity(lanes, default_lane, f"{BASE}?revision=999",
                                     {"X": _frames("rect")["X"]})
    assert status == 410
    assert "not found" in json.loads(body)["error"]


# ----------------------------------------------------- the shared dispatch
def test_fallback_healthcheck(lanes):
    status, headers, _ = _request(lanes[0].port, "GET", "/healthcheck")
    assert status == 200
    assert "server-timing" in headers


def test_fallback_metadata_parity(lanes, default_lane):
    status, _, body = _assert_parity(lanes, default_lane, f"/gordo/v0/{PROJECT}/{NAME}/metadata",
                                     method="GET", jax_body=False)
    assert status == 200
    assert json.loads(body)["metadata"]["name"] == NAME


def test_fallback_405_wrong_method(lanes, default_lane):
    status, headers, _ = _assert_parity(lanes, default_lane, BASE, method="GET", jax_body=False)
    assert status == 405
    assert headers["allow"] == "POST"


def test_fallback_proxy_prefix_headers(lanes, default_lane):
    """A prefixed-ingress request takes the shared dispatch, which strips
    the prefix as the JAX app's ``adapt_proxy_deployment`` does."""
    body = json.dumps({"X": _frames("rect")["X"]}).encode()
    headers = {"Content-Type": "application/json", "X-Envoy-Original-Path": "/prefixed/ingress"}
    answers = [_request(port, "POST", f"/prefixed/ingress{BASE}", body, headers)
               for port in (lanes[0].port, default_lane.port, lanes[1].port)]
    assert [a[0] for a in answers] == [200, 200, 200]
    assert _normalized(answers[0][2]) == _normalized(answers[1][2])
    _same_structure(answers[0][2], answers[2][2])
    assert "model-output" in json.loads(answers[0][2])["data"]


# ------------------------------------------------------- connection behavior
def test_keep_alive_two_requests_one_connection(lanes):
    accepted = lanes[0].server.accepted
    conn = http.client.HTTPConnection("127.0.0.1", lanes[0].port, timeout=60)
    body = json.dumps(_frames("rect")).encode()
    try:
        sockets = []
        for _ in range(2):
            conn.request("POST", ANOMALY, body=body, headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            assert resp.status == 200
            assert resp.getheader("Connection") == "keep-alive"
            assert "total-anomaly-scaled" in json.loads(data)["data"]
            sockets.append(conn.sock)
        assert sockets[0] is sockets[1] is not None
    finally:
        conn.close()
    assert lanes[0].server.accepted == accepted + 1


def test_drain_closes_connections(lanes):
    """During a drain the lane answers with ``Connection: close``."""
    assert fastlane.begin_drain()
    try:
        status, headers, _ = _request(lanes[0].port, "POST", BASE, b"{}",
                                      {"Content-Type": "application/json"})
        assert status == 400
        assert headers["connection"] == "close"
    finally:
        fastlane.end_drain()


def test_fast_lane_with_batcher(lanes, monkeypatch):
    """Fast-lane requests submit to the cross-model batcher as the default
    lane's do. On the event loop, which dispatches one request at a time,
    every fused call holds one request."""
    monkeypatch.setenv("GORDO_TPU_SERVING_BATCH", "1")
    batcher.reset_batcher()
    body = json.dumps({"X": _frames("rect")["X"]}).encode()
    statuses = []

    def post():
        statuses.append(_request(lanes[0].port, "POST", BASE, body,
                                 {"Content-Type": "application/json"})[0])

    try:
        post()
        threads = [threading.Thread(target=post) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        fused = batcher.peek_batcher()
        assert statuses == [200] * 5
        assert fused is not None and fused.stats["items"] >= 5
        if isinstance(lanes[0].server, fastlane.EventLoopServer):
            assert all(width == 1 for width, _ in fused.calls)
    finally:
        batcher.reset_batcher()


def _raw_request(path, body: bytes) -> bytes:
    return (f"POST {path} HTTP/1.1\r\nHost: localhost\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body


def _read_one_response(reader):
    """(status, headers, body) of one framed response off a socket file."""
    status_line = reader.readline()
    assert status_line.startswith(b"HTTP/1.1 "), status_line
    status = int(status_line.split(b" ", 2)[1])
    headers = {}
    while True:
        line = reader.readline()
        if line in (b"\r\n", b""):
            break
        name, _, value = line.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    return status, headers, reader.read(int(headers.get("content-length", 0)))


def test_pipelined_requests_one_burst(lanes):
    """Three requests in one send: three answers, in order, on the
    connection."""
    req = _raw_request(BASE, json.dumps({"X": _frames("rect")["X"]}).encode())
    sock = socket.create_connection(("127.0.0.1", lanes[0].port), timeout=60)
    try:
        sock.sendall(req * 3)
        reader = sock.makefile("rb")
        for _ in range(3):
            status, _, out = _read_one_response(reader)
            assert status == 200 and b"model-output" in out
    finally:
        sock.close()


def test_partial_reads_trickled_bytes(lanes):
    """A request trickled in fragments (the head split mid-line, the body
    mid-token) is parsed and served."""
    req = _raw_request(BASE, json.dumps({"X": _frames("rect")["X"]}).encode())
    step = max(1, len(req) // 7)
    sock = socket.create_connection(("127.0.0.1", lanes[0].port), timeout=60)
    try:
        for offset in range(0, len(req), step):
            sock.sendall(req[offset:offset + step])
            time.sleep(0.01)
        status, _, out = _read_one_response(sock.makefile("rb"))
        assert status == 200 and b"model-output" in out
    finally:
        sock.close()


def test_close_mid_header_is_harmless(lanes):
    sock = socket.create_connection(("127.0.0.1", lanes[0].port), timeout=10)
    sock.sendall(b"POST /gordo/v0/p/m/prediction HTTP/1.1\r\nConte")
    sock.close()
    time.sleep(0.1)
    assert _request(lanes[0].port, "GET", "/healthcheck")[0] == 200


def _own_lane(app, lane, **kwargs):
    return _Serving(_lane(fastlane, app, lane, uds="", **kwargs))


@pytest.mark.parametrize("lane", LANES)
def test_idle_keep_alive_bounded_and_counted(app, monkeypatch, lane):
    """``GORDO_TPU_FASTLANE_IDLE_S``: a connection idle between requests is
    closed by the lane (EOF at the client) and counted."""
    monkeypatch.setenv("GORDO_TPU_FASTLANE_IDLE_S", "0.6")
    serving = _own_lane(app, lane)
    try:
        sock = socket.create_connection(("127.0.0.1", serving.port), timeout=30)
        try:
            sock.sendall(b"GET /healthcheck HTTP/1.1\r\nHost: localhost\r\n\r\n")
            assert _read_one_response(sock.makefile("rb"))[0] == 200
            sock.settimeout(5)
            assert sock.recv(1) == b""
        finally:
            sock.close()
        assert serving.server.idle_closes == 1
    finally:
        serving.close()


@pytest.mark.parametrize("lane", LANES)
def test_idle_bound_yields_to_request_in_progress(app, monkeypatch, lane):
    """Request bytes that arrive during the idle wait put the connection
    mid-request: the lane serves the request instead of closing on the
    idle bound."""
    monkeypatch.setenv("GORDO_TPU_FASTLANE_IDLE_S", "0.4")
    serving = _own_lane(app, lane)
    try:
        sock = socket.create_connection(("127.0.0.1", serving.port), timeout=30)
        try:
            sock.sendall(b"GET /healthcheck HTTP/1.1\r\nHost: localhost\r\n")
            time.sleep(1.2)
            sock.sendall(b"\r\n")
            assert _read_one_response(sock.makefile("rb"))[0] == 200
        finally:
            sock.close()
    finally:
        serving.close()


def test_sweep_flushes_buffered_response_during_drain(app):
    """A connection the sweep closes while a drain is flushing its last
    response gets the whole response before the close."""
    server = fastlane.EventLoopServer(app, host="127.0.0.1", port=0, uds="")
    client, server_side = socket.socketpair()
    server_side.setblocking(False)
    payload = fastlane._serialize(200, [("Content-Type", "text/plain")], b"x" * (4 << 20),
                                  keep_alive=False)
    conn = fastlane._Conn(server_side)
    conn.queue(payload)
    conn.close_after_flush = True
    conn.last_activity = time.monotonic() - 10_000
    server._conns[server_side.fileno()] = conn
    server._selector.register(server_side, selectors.EVENT_READ, conn)
    assert fastlane.begin_drain()
    try:
        server._sweep_idle(time.monotonic())
        received = bytearray()
        client.settimeout(5)
        while True:
            if server_side.fileno() >= 0:
                server._flush(conn)  # the loop's writable callback
            chunk = client.recv(1 << 20)
            if not chunk:
                break
            received += chunk
        assert bytes(received) == payload
    finally:
        fastlane.end_drain()
        client.close()
        server.server_close()


def _load_test():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
    import load_test

    return load_test


def test_fast_lane_load_smoke(lanes):
    """The JAX package's open-loop load generator against the port's lane
    for a second and a half: every request answered, ordered percentiles,
    the phases read from ``Server-Timing``."""
    report = _load_test().run(host=f"http://127.0.0.1:{lanes[0].port}", project=PROJECT,
                              machine=NAME, mode="qps", qps=30, users=4, duration=1.5,
                              warmup=0.3, samples=20, flight=False)
    assert "error" not in report, report
    assert report["requests"] > 0 and report["errors"] == 0
    assert 0 < report["p50_ms"] <= report["p99_ms"] <= report["max_ms"]
    assert "decode" in report["phases"] and "predict" in report["phases"]


# ----------------------------------------------- the Unix-domain listener
@pytest.fixture(params=LANES)
def uds_lane(app, tmp_path, request):
    serving = _Serving(_lane(fastlane, app, request.param, uds=str(tmp_path / "node.sock")))
    yield serving
    serving.close()


def _uds_request(path, method, target, body=None, headers=None):
    conn = _load_test().UDSHTTPConnection(path, timeout=60)
    try:
        conn.request(method, target, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


def test_uds_lane_byte_parity_with_tcp(uds_lane):
    assert uds_lane.server.uds_path and os.path.exists(uds_lane.server.uds_path)
    body = json.dumps(_frames("rect")).encode()
    headers = {"Content-Type": "application/json"}
    tcp = _request(uds_lane.port, "POST", ANOMALY, body, headers)
    uds = _uds_request(uds_lane.server.uds_path, "POST", ANOMALY, body, headers)
    assert tcp[0] == uds[0] == 200
    assert _normalized(uds[2]) == _normalized(tcp[2])
    assert "server-timing" in uds[1]


@pytest.mark.parametrize("lane", LANES)
def test_uds_socket_unlinked_on_close(app, tmp_path, lane):
    path = str(tmp_path / "closing.sock")
    serving = _Serving(_lane(fastlane, app, lane, uds=path))
    try:
        assert os.path.exists(path)
    finally:
        serving.close()
    assert not os.path.exists(path)


def test_uds_load_smoke(uds_lane):
    report = _load_test().run(host="http://uds-only", project=PROJECT, machine=NAME, mode="qps",
                              qps=30, users=4, duration=1.0, warmup=0.2, samples=20,
                              flight=False, uds=uds_lane.server.uds_path)
    assert "error" not in report, report
    assert report["transport"] == "uds"
    assert report["requests"] > 0 and report["errors"] == 0 and report["p50_ms"] > 0


def test_writev_serial_flush_byte_parity(app, monkeypatch):
    """A pipelined burst flushed by one vectored ``sendmsg`` and by one
    ``send`` a response: the same bytes."""
    req = _raw_request(BASE, json.dumps({"X": _frames("rect")["X"]}).encode())

    def burst(port):
        sock = socket.create_connection(("127.0.0.1", port), timeout=60)
        try:
            sock.sendall(req * 3)
            reader = sock.makefile("rb")
            return [_normalized(_read_one_response(reader)[2]) for _ in range(3)]
        finally:
            sock.close()

    responses = {}
    for mode, knob in (("writev", "1"), ("serial", "0")):
        monkeypatch.setenv("GORDO_TPU_FASTLANE_WRITEV", knob)
        serving = _own_lane(app, "event_loop")
        try:
            assert serving.server._writev is (knob == "1")
            responses[mode] = burst(serving.port)
        finally:
            serving.close()
    assert responses["writev"] == responses["serial"]


def test_chunked_body_on_the_fast_lane(lanes, default_lane):
    """A chunked request body on both lanes, then a request on the same
    connection: the answers equal the ``Content-Length`` request's."""
    body = json.dumps(_frames("rect")).encode()
    chunked = b"".join(b"%x\r\n%s\r\n" % (len(body[i:i + 500]), body[i:i + 500])
                       for i in range(0, len(body), 500)) + b"0\r\n\r\n"
    head = (f"POST {ANOMALY} HTTP/1.1\r\nHost: localhost\r\nContent-Type: application/json\r\n"
            "Transfer-Encoding: chunked\r\n\r\n").encode()
    want = _normalized(_request(default_lane.port, "POST", ANOMALY, body,
                                {"Content-Type": "application/json"})[2])
    for port in (lanes[0].port, default_lane.port):
        sock = socket.create_connection(("127.0.0.1", port), timeout=60)
        try:
            sock.sendall(head + chunked + _raw_request(ANOMALY, body))
            reader = sock.makefile("rb")
            for _ in range(2):
                status, _, out = _read_one_response(reader)
                assert status == 200 and _normalized(out) == want
        finally:
            sock.close()


# ------------------------------------------------- the default lane's keep-alive
_X = json.dumps({"X": [[0.5, 0.25, 0.75, 0.125]] * 20}).encode()
KEEP_ALIVE_CASES = {
    "non-JSON POST 400": ("POST", ANOMALY, _X, {"Content-Type": "text/plain"},
                          400),
    "unknown model 404": ("POST", f"/gordo/v0/{PROJECT}/nope/prediction", b"{}",
                          {"Content-Type": "application/json"}, 404),
    "GET with a body 405": ("GET", BASE, _X,
                            {"Content-Type": "application/json"}, 405),
    "unknown revision 410": ("POST", f"{BASE}?revision=999", _X,
                             {"Content-Type": "application/json"}, 410),
    "parquet 501": ("POST", f"{BASE}?format=parquet", _X,
                    {"Content-Type": "application/json"}, 501),
    "metadata GET with a body 200": ("GET", f"/gordo/v0/{PROJECT}/{NAME}/metadata", b"x" * 5000,
                                     {"Content-Type": "application/octet-stream"}, 200),
}


@pytest.mark.parametrize("case", list(KEEP_ALIVE_CASES))
def test_default_lane_reads_every_body_and_keeps_the_connection(collections, default_lane, case):
    """An answer that ends early, then a good request, on one
    ``http.client`` connection: the port answers both on one socket;
    werkzeug's threaded server serving the JAX app gives each the same
    status (parquet aside: JAX answers it 200) and closes the connection
    after each (``http.client`` opens another)."""
    from werkzeug.serving import make_server as werkzeug_server

    method, path, body, headers, status = KEEP_ALIVE_CASES[case]
    good = json.dumps(_frames("rect")).encode()
    jax = _Serving(werkzeug_server("127.0.0.1", 0, build_app({
        "MODEL_COLLECTION_DIR": collections[0]}), threaded=True))
    try:
        for port, is_port in ((default_lane.port, True), (jax.port, False)):
            accepted = default_lane.server.accepted
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            try:
                answers, sockets = [], []
                for request in ((method, path, body, headers),
                                ("POST", ANOMALY, good, {"Content-Type": "application/json"})):
                    conn.request(*request)
                    resp = conn.getresponse()
                    answers.append((resp.status, resp.getheader("Connection"), resp.read()))
                    sockets.append(conn.sock)
            finally:
                conn.close()
            assert answers[1][0] == 200
            assert "total-anomaly-scaled" in json.loads(answers[1][2])["data"]
            if is_port:
                assert answers[0][0] == status
                assert [a[1] for a in answers] == ["keep-alive", "keep-alive"]
                assert sockets[0] is sockets[1] is not None
                assert default_lane.server.accepted == accepted + 1
            else:
                assert answers[0][0] == (200 if status == 501 else status)
                assert [a[1] for a in answers] == ["close", "close"]
                assert sockets == [None, None]
    finally:
        jax.close()


@pytest.mark.parametrize("version, connection, kept", [
    ("HTTP/1.1", None, True), ("HTTP/1.1", "close", False), ("HTTP/1.0", None, False),
    ("HTTP/1.0", "keep-alive", True)])
def test_default_lane_closes_when_the_client_asks(default_lane, version, connection, kept):
    head = f"GET /healthcheck {version}\r\nHost: localhost\r\n"
    if connection:
        head += f"Connection: {connection}\r\n"
    sock = socket.create_connection(("127.0.0.1", default_lane.port), timeout=30)
    try:
        sock.sendall((head + "\r\n").encode())
        reader = sock.makefile("rb")
        status_line = reader.readline()
        assert status_line.startswith(b"HTTP/1.1 200")
        headers = {}
        while (line := reader.readline()) not in (b"\r\n", b""):
            name, _, value = line.decode().partition(":")
            headers[name.lower()] = value.strip()
        assert headers["connection"] == ("keep-alive" if kept else "close")
        sock.settimeout(0.5 if kept else 5)
        if kept:
            with pytest.raises(socket.timeout):
                sock.recv(1)
        else:
            assert sock.recv(1) == b""
    finally:
        sock.close()


def test_default_lane_refuses_a_malformed_length_and_closes(default_lane):
    sock = socket.create_connection(("127.0.0.1", default_lane.port), timeout=30)
    try:
        sock.sendall(f"POST {BASE} HTTP/1.1\r\nContent-Length: x\r\n\r\n".encode())
        reader = sock.makefile("rb")
        status, headers, body = _read_one_response(reader)
        assert status == 400 and headers["connection"] == "close"
        assert json.loads(body) == {"error": "malformed Content-Length"}
        assert reader.read(1) == b""
    finally:
        sock.close()


@pytest.mark.parametrize("fast_lane, event_loop", [("0", "1"), ("1", "0"), ("1", "1")],
                         ids=["default", "threads", "event_loop"])
def test_run_server_front_end_adopts_a_listening_socket(collections, monkeypatch, fast_lane,
                                                        event_loop):
    """``run-server``'s front end: the fast lane under
    ``GORDO_TPU_FAST_LANE=1`` (the event loop unless
    ``GORDO_TPU_FAST_LANE_EVENT_LOOP=0``), else the server's own handler,
    each on a listening socket handed to it (``fd``), as a prefork pool
    shares one."""
    from gordo_tpu_torch.server.server import GordoServer, make_front_end

    monkeypatch.setenv("GORDO_TPU_FAST_LANE", fast_lane)
    monkeypatch.setenv("GORDO_TPU_FAST_LANE_EVENT_LOOP", event_loop)
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(16)
    try:
        app, server = make_front_end("127.0.0.1", 0, "cpu", collections[1],
                                     fd=listener.fileno())
        want = (GordoServer if fast_lane == "0" else fastlane.EventLoopServer
                if event_loop == "1" else fastlane.FastLaneServer)
        assert type(server) is want
        serving = _Serving(server)
        try:
            assert serving.port == listener.getsockname()[1]
            assert _request(serving.port, "GET", "/healthcheck")[0] == 200
        finally:
            serving.close()
            if app is not server:
                app.server_close()
    finally:
        listener.close()


# ------------------------------------------------------------ openapi.json
def test_openapi_document_is_the_jax_document():
    ours, theirs = openapi_document(), jax_openapi_document()
    if ours["info"]["version"] != theirs["info"]["version"]:
        ours = dict(ours, info=dict(ours["info"], version=theirs["info"]["version"]))
    assert ours == theirs


ROUTE_PATHS = ["/healthcheck", "/readiness", "/server-version", "/gordo/v0/openapi.json",
               "/gordo/v0/{gordo_project}/models", "/gordo/v0/{gordo_project}/revisions",
               "/gordo/v0/{gordo_project}/expected-models",
               "/gordo/v0/{gordo_project}/{gordo_name}/prediction",
               "/gordo/v0/{gordo_project}/{gordo_name}/anomaly/prediction",
               "/gordo/v0/{gordo_project}/{gordo_name}/metadata",
               "/gordo/v0/{gordo_project}/{gordo_name}/healthcheck",
               "/gordo/v0/{gordo_project}/{gordo_name}/download-model"]


@pytest.mark.parametrize("path", ROUTE_PATHS)
def test_openapi_paths_cover_the_route_table(default_lane, path):
    """Every route of the port's table is in the document, and the port
    answers it (a prediction route a 400 without X, the others 200)."""
    assert path in openapi_document()["paths"]
    concrete = path.replace("{gordo_project}", PROJECT).replace("{gordo_name}", NAME)
    method = "POST" if concrete.endswith("prediction") else "GET"
    body = b"{}" if method == "POST" else None
    status = _request(default_lane.port, method, concrete, body,
                      {"Content-Type": "application/json"})[0]
    assert status == (400 if method == "POST" else 200)


def test_openapi_served_on_every_lane(lanes, default_lane, collections):
    path = "/gordo/v0/openapi.json"
    status, headers, body = _assert_parity(lanes, default_lane, path, method="GET",
                                           jax_body=False)
    assert status == 200 and headers["content-type"] == "application/json"
    theirs = build_app({"MODEL_COLLECTION_DIR": collections[0]}).test_client().get(path)
    assert theirs.status_code == 200
    assert json.loads(body) == dict(theirs.get_json(), info=openapi_document()["info"])
    assert headers["revision"] == "111"


def test_parquet_refusal_is_the_same_on_every_lane(lanes, default_lane):
    """``?format=parquet`` is refused with 501 on the fast lane as on the
    default lane (the JAX lanes answer parquet bytes)."""
    body = json.dumps({"X": _frames("rect")["X"]}).encode()
    headers = {"Content-Type": "application/json"}
    fast, default = (_request(port, "POST", f"{BASE}?format=parquet", body, headers)
                     for port in (lanes[0].port, default_lane.port))
    assert fast[0] == default[0] == 501
    assert fast[2] == default[2]
    assert json.loads(fast[2]) == {"error": views.PARQUET_REFUSAL, "revision": "111"}
