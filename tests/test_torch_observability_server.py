"""
The port's server telemetry held against the JAX server on the CPU: the
same JAX-built artifact served by both (``transformer-ae-512``'s widths, d_model
256, 4 heads of 64, ff 512, 8 tags, cut to one block at lookback 32 so that
the JAX build fits the file's time), the same requests, then:

- ``/metrics`` (``ENABLE_PROMETHEUS`` and ``PROJECT`` set) has the same
  families and label names, and the same count for every label set of the
  request counter, the request histogram, the fleet request counter and the
  codec counters (``prometheus_client``'s ``_created`` samples and process
  collectors left out; durations are not compared in value);
- the five ported ``/debug/*`` routes answer with the same JSON keys, and
  404 with ``GORDO_TPU_DEBUG_ENDPOINTS`` off, as unknown paths do;
- ``X-Gordo-Trace`` is on every response of every route, on the default
  lane and on both fast lanes, and a sent ``traceparent``'s trace id comes
  back;
- ``batch-build --trace-file --metrics-file`` gives the same span names
  and metric families in both packages.
"""

import http.client
import json
import os
import re
import shutil
import threading

import numpy as np
import pytest

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder.local_build import local_build
from gordo_tpu.observability import flight as jax_flight
from gordo_tpu.observability import slo as jax_slo
from gordo_tpu.observability import telemetry as jax_telemetry
from gordo_tpu.server.server import build_app
from gordo_tpu_torch import cli
from gordo_tpu_torch.observability import flight, slo, telemetry
from gordo_tpu_torch.server import fastlane
from gordo_tpu_torch.server.server import make_server
from test_torch_serving import _port_from_jax_artifact

NAME = "tf-ae-512"
PROJECT = "proj"
TAGS = [f"tag-{i}" for i in range(8)]
CONFIG = f"""
machines:
  - name: {NAME}
    dataset:
      tags: [{", ".join(TAGS)}]
      target_tag_list: [{", ".join(TAGS)}]
      train_start_date: '2019-01-01T00:00:00+00:00'
      train_end_date: '2019-01-03T00:00:00+00:00'
      asset: asgb
      data_provider:
        type: RandomDataProvider
    model:
      gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector:
        window: 6
        base_estimator:
          sklearn.pipeline.Pipeline:
            steps:
            - sklearn.preprocessing.MinMaxScaler
            - gordo_tpu.models.models.TransformerAutoEncoder:
                kind: transformer_model
                lookback_window: 32
                d_model: 256
                num_heads: 4
                ff_dim: 512
                num_blocks: 1
                epochs: 1
"""
TRACE = "12" * 16
TRACEPARENT = f"00-{TRACE}-{'34' * 8}-01"
ANOMALY = f"/gordo/v0/{PROJECT}/{NAME}/anomaly/prediction"
BASE = f"/gordo/v0/{PROJECT}/{NAME}/prediction"
JSON = {"Content-Type": "application/json"}
DEBUG_ROUTES = ["/debug/flight", "/debug/vars", "/debug/config", "/debug/slo",
                "/debug/profile?seconds=0.1"]


def _body(rows: int = 40, seed: int = 0) -> bytes:
    values = np.random.RandomState(seed).rand(rows, len(TAGS)).tolist()
    return json.dumps({"X": values, "y": values}).encode()


# (method, path, body, headers) of the request script both servers answer
REQUESTS = [
    ("GET", "/healthcheck", None, {}),
    ("GET", "/server-version", None, {}),
    ("GET", f"/gordo/v0/{PROJECT}/models", None, {}),
    ("GET", f"/gordo/v0/{PROJECT}/{NAME}/metadata", None, {}),
    ("POST", ANOMALY, _body(), JSON),
    ("POST", ANOMALY, _body(seed=1), {**JSON, "traceparent": TRACEPARENT}),
    ("POST", BASE, json.dumps({"X": json.loads(_body())["X"]}).encode(), JSON),
    ("POST", f"/gordo/v0/{PROJECT}/no-such-model/anomaly/prediction", _body(), JSON),
    ("POST", ANOMALY, b"{not json", JSON),
    ("GET", ANOMALY, None, {}),
    ("GET", "/no/such/route", None, {}),
]


class _Headers(dict):
    """Case-insensitive ``get``, the interface the port's dispatch reads."""

    def get(self, name, default=None):
        for key, value in self.items():
            if key.lower() == name.lower():
                return value
        return default


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    root = tmp_path_factory.mktemp("observability")
    jax_coll, port_coll = root / "jax" / "111", root / "port" / "111"
    (model, machine), = local_build(CONFIG)
    jax_serializer.dump(model, str(jax_coll / NAME), metadata=machine.to_dict())
    _port_from_jax_artifact(str(jax_coll / NAME), str(port_coll / NAME))
    return str(jax_coll), str(port_coll)


@pytest.fixture(scope="module")
def servers(collections):
    """(the port's server, the JAX app), both with ENABLE_PROMETHEUS."""
    from prometheus_client import CollectorRegistry

    saved = {k: os.environ.get(k) for k in ("ENABLE_PROMETHEUS", "PROJECT",
                                             "GORDO_TPU_SERVING_BATCH")}
    os.environ.update(ENABLE_PROMETHEUS="true", PROJECT=PROJECT)
    os.environ.pop("GORDO_TPU_SERVING_BATCH", None)
    try:
        ours = make_server("127.0.0.1", 0, device="cpu", collection_dir=collections[1],
                           bind_and_activate=False)
        theirs = build_app({"MODEL_COLLECTION_DIR": collections[0], "ENABLE_PROMETHEUS": True,
                            "PROJECT": PROJECT}, prometheus_registry=CollectorRegistry())
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    yield ours, theirs
    ours.server_close()


def _ours(server, method, path, body=None, headers=None):
    status, out, data = server.dispatch(method, path, _Headers(headers or {}), body or b"")
    return status, {k.lower(): v for k, v in out}, data


def _theirs(app, method, path, body=None, headers=None):
    resp = app.test_client().open(path, method=method, data=body, headers=headers or {})
    return resp.status_code, {k.lower(): v for k, v in resp.headers.items()}, resp.get_data()


def _reset():
    for module in (telemetry, jax_telemetry, slo, jax_slo, flight, jax_flight):
        module.reset()


def _families(text: str) -> dict:
    """{family: {"type": ..., "samples": {(sample, labels): value}}}, with
    prometheus_client's ``_created`` samples and process collectors left
    out."""
    families, current = {}, None
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            current = None if name.endswith("_created") or name.startswith(
                ("process_", "python_")) else families.setdefault(
                name, {"type": kind, "samples": {}})
            continue
        if not line or line.startswith("#") or current is None:
            continue
        line = line.split(" # ", 1)[0]  # an exemplar
        match = re.match(r"^([^{ ]+)(\{.*\})? (\S+)$", line)
        name, labels, value = match.groups()
        pairs = tuple(sorted(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', labels or "")))
        current["samples"][(name, pairs)] = float(value)
    return families


COUNTED = ("gordo_server_requests_total", "gordo_server_fleet_requests_total",
           "gordo_server_fast_codec_total", "gordo_server_fast_codec_fallback_total")


def test_metrics_have_the_same_families_labels_and_counts(servers):
    from gordo_tpu.observability import metrics as jax_metrics

    ours, theirs = servers
    _reset()
    for method, path, body, headers in REQUESTS:
        mine, jax = _ours(ours, method, path, body, headers), _theirs(theirs, method, path,
                                                                     body, headers)
        assert mine[0] == jax[0], (method, path, mine[2][:200], jax[2][:200])
    status, headers, text = _ours(ours, "GET", "/metrics")
    jax_status, jax_headers, jax_text = _theirs(theirs, "GET", "/metrics")
    assert status == jax_status == 200
    assert headers["content-type"] == "text/plain; version=0.0.4"
    mine, jax = _families(text.decode()), _families(jax_text.decode())
    server_families = {"gordo_server_request_duration_seconds", "gordo_server_requests_total",
                       "gordo_server_info", "gordo_server_batcher_items",
                       "gordo_server_batcher_device_calls", "gordo_server_batcher_largest_batch",
                       "gordo_server_batcher_specs"}
    catalog = {getattr(jax_metrics, n).name for n in dir(jax_metrics)
               if isinstance(getattr(jax_metrics, n), jax_telemetry._Metric)}
    assert set(mine) <= set(jax) and server_families | catalog <= set(mine)
    for name, family in mine.items():
        assert family["type"] == jax[name]["type"], name
        ours_labels = {tuple(k for k, _ in labels) for _, labels in family["samples"]}
        jax_labels = {tuple(k for k, _ in labels) for _, labels in jax[name]["samples"]}
        # a series that only one package feeds (a JAX trace compile, say)
        # has samples on that side alone
        assert ours_labels == jax_labels or not (ours_labels and jax_labels), name
    for name in COUNTED:
        assert mine[name]["samples"] == jax[name]["samples"], name
    for name in ("gordo_server_request_duration_seconds", "gordo_server_fleet_request_seconds"):
        counts = {key: value for key, value in mine[name]["samples"].items()
                  if key[0].endswith("_count")}
        assert counts == {key: value for key, value in jax[name]["samples"].items()
                          if key[0].endswith("_count")}, name
    requests = mine["gordo_server_requests_total"]["samples"]
    assert sum(requests.values()) == len(REQUESTS)
    assert dict(next(labels for (_, labels) in requests if dict(labels)["status_code"] == "404"
                     and dict(labels)["path"] != "(unmatched)"))["gordo_name"] == ""


@pytest.mark.parametrize("gate", ["1", ""])
def test_debug_routes_answer_with_the_same_keys(servers, monkeypatch, gate):
    from gordo_tpu.server import warmup as jax_warmup

    ours, theirs = servers
    monkeypatch.setenv("GORDO_TPU_DEBUG_ENDPOINTS", gate)
    # the port has no warm-up yet (A9): compare with a JAX process in which
    # none ran either, whatever an earlier test in this process warmed
    monkeypatch.setattr(jax_warmup, "_last_report", None)
    for method, path, body, headers in REQUESTS[4:6]:
        _ours(ours, method, path, body, headers), _theirs(theirs, method, path, body, headers)
    unknown = _ours(ours, "GET", "/debug/unknown")
    for path in DEBUG_ROUTES:
        mine, jax = _ours(ours, "GET", path), _theirs(theirs, "GET", path)
        assert mine[0] == jax[0] == (200 if gate else 404), path
        if not gate:
            # the unknown path's answer, naming this path
            assert mine[2] == unknown[2].replace(b"/debug/unknown", path.split("?")[0].encode())
            assert mine[1]["content-type"] == unknown[1]["content-type"]
            continue
        doc, jax_doc = json.loads(mine[2]), json.loads(jax[2])
        assert sorted(doc) == sorted(jax_doc), path
        # the nested blocks' keys too, but for the series, models and knobs
        # present (what ran before) and the batcher's own counters, which the
        # two batchers define apart
        for key, value in jax_doc.items():
            if isinstance(value, dict) and key not in ("metrics", "models", "env", "merged",
                                                       "batcher"):
                assert sorted(doc[key] or {}) == sorted(value), (path, key)
    for path in ("/debug/perf", "/debug/drift", "/debug/prewarm"):  # not ported yet
        assert _ours(ours, "GET", path)[0] == 404


@pytest.fixture(scope="module")
def lanes(collections):
    """The port's three front ends over one collection: its own handler,
    the fast lane's threads and its event loop."""
    app = make_server("127.0.0.1", 0, device="cpu", collection_dir=collections[1],
                      bind_and_activate=False)
    fronts = [make_server("127.0.0.1", 0, device="cpu", collection_dir=collections[1]),
              fastlane.FastLaneServer(app, "127.0.0.1", 0, uds=""),
              fastlane.EventLoopServer(app, "127.0.0.1", 0, uds="")]
    threads = [threading.Thread(target=front.serve_forever, daemon=True) for front in fronts]
    for thread in threads:
        thread.start()
    yield [getattr(front, "server_port", None) or front.server_address[1] for front in fronts]
    for front, thread in zip(fronts, threads):
        front.shutdown()
        front.server_close()
        thread.join(10)
    app.server_close()


@pytest.mark.parametrize("lane", ["default", "threads", "event_loop"])
def test_every_response_of_every_route_carries_the_trace(lanes, monkeypatch, lane):
    monkeypatch.setenv("GORDO_TPU_DEBUG_ENDPOINTS", "1")
    port = lanes[["default", "threads", "event_loop"].index(lane)]
    routes = REQUESTS + [("GET", path, None, {}) for path in
                         DEBUG_ROUTES[:4] + ["/metrics", "/readiness", "/gordo/v0/openapi.json"]]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    seen = set()
    try:
        for method, path, body, headers in routes:
            for traced in (False, True):
                send = dict(headers, traceparent=TRACEPARENT) if traced else dict(headers)
                send.pop("traceparent", None) if not traced else None
                conn.request(method, path, body=body, headers=send)
                resp = conn.getresponse()
                resp.read()
                trace = resp.getheader("X-Gordo-Trace")
                assert trace and re.fullmatch(r"[0-9a-f]{32}", trace), (lane, method, path)
                assert (trace == TRACE) == traced, (lane, method, path)
                seen.add(resp.status)
    finally:
        conn.close()
    assert {200, 400, 404, 405} <= seen


@pytest.mark.parametrize("lane", ["threads", "event_loop"])
def test_fast_lanes_feed_their_idle_close_and_syscall_counters(collections, monkeypatch, lane):
    """Each lane's idle closes feed ``gordo_server_fastlane_idle_closes_total``
    with its ``idle_closes`` attribute; the event loop counts a ``recv`` a
    read and a ``send`` a write in ``gordo_server_fastlane_syscalls_total``,
    as the JAX event loop does."""
    import socket

    from gordo_tpu_torch.observability import metrics as catalog

    monkeypatch.setenv("GORDO_TPU_FASTLANE_IDLE_S", "0.6")
    _reset()
    # the counters are process-wide: other lanes alive in the process may
    # add to them, so this lane's part is read as a lower bound
    app = make_server("127.0.0.1", 0, device="cpu", collection_dir=collections[1],
                      bind_and_activate=False)
    cls = fastlane.EventLoopServer if lane == "event_loop" else fastlane.FastLaneServer
    front = cls(app, "127.0.0.1", 0, uds="")
    thread = threading.Thread(target=front.serve_forever, daemon=True)
    thread.start()
    try:
        sock = socket.create_connection(("127.0.0.1", front.server_port), timeout=30)
        try:
            for _ in range(2):  # two requests on one kept connection
                sock.sendall(b"GET /healthcheck HTTP/1.1\r\nHost: localhost\r\n\r\n")
                head = sock.recv(65536)
                assert head.startswith(b"HTTP/1.1 200") and b"X-Gordo-Trace: " in head
            sock.settimeout(5)
            assert sock.recv(1) == b""  # closed by the idle bound
        finally:
            sock.close()
    finally:
        front.shutdown()
        front.server_close()
        thread.join(10)
        app.server_close()
    assert front.idle_closes == 1 and catalog.FASTLANE_IDLE_CLOSES.value() >= 1
    if lane == "event_loop":
        assert catalog.FASTLANE_SYSCALLS.value(op="recv") >= 2
        assert catalog.FASTLANE_SYSCALLS.value(op="send") >= 2


def _machine(name: str) -> dict:
    return {"name": name, "dataset": {
        "tags": [f"{name}-tag-{j}" for j in range(4)],
        "train_start_date": "2019-01-01T00:00:00+00:00",
        "train_end_date": "2019-01-03T00:00:00+00:00",
        "data_provider": {"type": "RandomDataProvider"}},
        "model": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {
            "require_thresholds": True, "base_estimator": {"sklearn.pipeline.Pipeline": {
                "steps": ["sklearn.preprocessing.MinMaxScaler",
                          {"gordo_tpu.models.models.AutoEncoder": {
                              "kind": "feedforward_hourglass", "epochs": 1}}]}}}}}


def _spans_and_families(trace_file, metrics_file) -> tuple:
    with open(trace_file) as fh:
        events = json.load(fh)["traceEvents"]
    with open(metrics_file) as fh:
        families = {line.split()[2] for line in fh if line.startswith("# TYPE ")}
    return ({e["name"] for e in events}, families,
            {e["args"]["machine"] for e in events if e["name"] == "serialize"})


def test_batch_build_trace_and_metrics_files_match(tmp_path):
    from click.testing import CliRunner

    from gordo_tpu.cli.cli import gordo

    config = tmp_path / "config.json"
    config.write_text(json.dumps({"machines": [_machine("obs-0"), _machine("obs-1")]}))
    outputs = {}
    for package in ("jax", "port"):
        trace_file, metrics_file = tmp_path / f"{package}.json", tmp_path / f"{package}.prom"
        _reset()
        if package == "jax":
            result = CliRunner().invoke(gordo, [
                "batch-build", str(config), "--output-dir", str(tmp_path / "jax"),
                "--trace-file", str(trace_file), "--metrics-file", str(metrics_file)])
            assert result.exit_code == 0, result.output
        else:
            assert cli.main(["batch-build", str(config), str(tmp_path / "port"), "--device",
                             "cpu", "--trace-file", str(trace_file), "--metrics-file",
                             str(metrics_file)]) == 0
        outputs[package] = _spans_and_families(trace_file, metrics_file)
    ours, theirs = outputs["port"], outputs["jax"]
    assert ours == theirs
    assert {"batched_build", "fetch", "validate", "compile", "train", "assemble",
            "serialize"} <= ours[0]
    assert ours[2] == {"obs-0", "obs-1"}
    _reset()
    shutil.rmtree(tmp_path / "jax", ignore_errors=True)
