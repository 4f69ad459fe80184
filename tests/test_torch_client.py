"""
The port's prediction client (gordo_tpu_torch/client/) held against the JAX
client. Two small Transformer machines are built by the JAX package and
carried into port artifacts (``_port_from_jax_artifact``); the JAX app
serves the first, the port's server the second, on the CPU. Each case of
tests/gordo_tpu/test_client.py runs twice: the JAX client against the JAX
app (werkzeug, in process) and the port's client against the port's server
over HTTP. Both clients come back with the same machines, revisions,
metadata structure and prediction frames, and so do the two cross
directions. ``_handle_response``'s mapping, the retry sleeps of
``call_with_retry_after`` and of the HTTP session (against ``requests``'
adapter), the timeouts and the parquet refusal are held exactly.
"""

import http.server
import json
import threading
import time

import numpy as np
import pandas as pd
import pytest
import requests
import urllib3
import yaml

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder.local_build import local_build
from gordo_tpu.cli import workflow_generator as jax_cli_gen
from gordo_tpu.client import Client as JaxClient
from gordo_tpu.client import cli as jax_client_cli
from gordo_tpu.client import io as jax_io
from gordo_tpu.client.forwarders import ForwardPredictionsToDisk as JaxDisk
from gordo_tpu.client.testing import WSGISession
from gordo_tpu.server import build_app
from gordo_tpu.server import utils as jax_server_utils
from gordo_tpu.util import faults as jax_faults
from gordo_tpu_torch.client import Client
from gordo_tpu_torch.client import cli as port_client_cli
from gordo_tpu_torch.client import io as port_io
from gordo_tpu_torch.client.client import DEFAULT_TIMEOUT, _timeout_from_env
from gordo_tpu_torch.client.forwarders import ForwardPredictionsToDisk
from gordo_tpu_torch.client.testing import DispatchSession
from gordo_tpu_torch.models.utils import RawFrame
from gordo_tpu_torch.server.server import make_server
from gordo_tpu_torch.util import faults as port_faults
from gordo_tpu_torch.workflow import workflow_generator as port_gen
from test_torch_serving import CONFIG, NAME, _port_from_jax_artifact

PROJECT = "gordo-test"
REVISION = "1604321820000"
NAMES = ("machine-1", "machine-2")
START, END = "2020-03-01T00:00:00+00:00", "2020-03-02T00:00:00+00:00"
# float32 on both sides, the served tolerance of the serving test
RTOL = ATOL = 1e-5


def _config() -> str:
    block = CONFIG.split("machines:\n", 1)[1]
    return "machines:\n" + "".join(block.replace(NAME, name) for name in NAMES)


class _Thread:
    def __init__(self, server):
        self.server = server
        self.port = server.server_address[1]
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX app and its werkzeug server over the JAX collection, and the
    port's server over the port's artifacts of it."""
    from werkzeug.serving import make_server as werkzeug_server

    root = tmp_path_factory.mktemp("client")
    jax_coll, port_coll = root / "jax" / REVISION, root / "port" / REVISION
    for model, machine in local_build(_config()):
        metadata = machine.to_dict()
        jax_serializer.dump(model, str(jax_coll / metadata["name"]), metadata=metadata)
        _port_from_jax_artifact(str(jax_coll / metadata["name"]),
                                str(port_coll / metadata["name"]))
    jax_server_utils.clear_model_caches()
    app = build_app({"MODEL_COLLECTION_DIR": str(jax_coll)})
    jax_http = _Thread(werkzeug_server("127.0.0.1", 0, app, threaded=True))
    port_http = _Thread(make_server("127.0.0.1", 0, device="cpu", collection_dir=str(port_coll)))
    yield {"app": app, "jax_port": jax_http.port, "port_port": port_http.port,
           "port_server": port_http.server, "root": root}
    jax_http.close()
    port_http.close()


class Side:
    """One client against its own server: the JAX client on the JAX app (the
    JAX tests' ``WSGISession``) or the port's client on the port's server
    over HTTP."""

    def __init__(self, name: str, served: dict):
        self.name, self.served = name, served
        self.io = jax_io if name == "jax" else port_io
        self.faults = jax_faults if name == "jax" else port_faults
        self.disk = JaxDisk if name == "jax" else ForwardPredictionsToDisk
        self.cli = jax_client_cli if name == "jax" else port_client_cli

    def client(self, **kwargs):
        if self.name == "jax":
            kwargs.setdefault("session", WSGISession(self.served["app"]))
            kwargs.setdefault("use_parquet", False)
            return JaxClient(project=PROJECT, **kwargs)
        return Client(project=PROJECT, host="127.0.0.1", port=self.served["port_port"],
                      scheme="http", device="cpu", **kwargs)

    def top_levels(self, predictions) -> set:
        if self.name == "jax":
            return set(predictions.columns.get_level_values(0))
        return set(predictions.top_levels())

    def predict_rows(self, model, n_rows: int) -> np.ndarray:
        idx = pd.date_range("2020-01-01", periods=n_rows, freq="10min", tz="UTC")
        X = np.full((n_rows, 4), 0.5)
        if self.name == "jax":
            X = pd.DataFrame(X, columns=[f"tag-{i}" for i in range(4)], index=idx)
        return np.asarray(model.predict(X))


@pytest.fixture(params=["jax", "port"])
def side(request, served):
    return Side(request.param, served)


def _frame(predictions) -> pd.DataFrame:
    """A prediction frame as the JAX client has it: the port's
    :class:`RawFrame` through the JAX reader of its ``dataframe_to_dict``
    layout; columns sorted."""
    if isinstance(predictions, RawFrame):
        predictions = jax_server_utils.dataframe_from_dict(predictions.to_dict())
    return predictions.sort_index(axis=1)


def _assert_same_frames(ours, theirs) -> None:
    ours, theirs = _frame(ours), _frame(theirs)
    assert list(ours.columns) == list(theirs.columns)
    assert ours.index.equals(theirs.index)
    for column in theirs.columns:
        if theirs[column].dtype.kind == "f":
            np.testing.assert_allclose(ours[column].to_numpy(float),
                                       theirs[column].to_numpy(float), rtol=RTOL, atol=ATOL)
        else:
            assert list(ours[column]) == list(theirs[column]), column


def _structure(value):
    """The key tree of a metadata document, its leaves' types; without
    ``model_meta``, which the port's artifact recomputes from the carried
    detector (``serializer.dump``), and ``_port_from_jax_artifact`` carries
    no per-fold thresholds."""
    if isinstance(value, dict):
        return {key: _structure(item) for key, item in value.items()
                if key != "model_meta"}
    return type(value).__name__


# -- tests/gordo_tpu/test_client.py, each case against both pairs
def test_client_get_machines(side):
    assert set(side.client().get_machine_names()) == set(NAMES)


def test_client_get_revisions(side):
    revisions = side.client().get_revisions()
    assert REVISION in revisions["available-revisions"]
    assert revisions["latest"] == REVISION


def test_client_get_metadata(side):
    client = side.client()
    metadata = client.get_metadata()
    assert NAMES[0] in metadata
    assert metadata[NAMES[0]]["name"] == NAMES[0]
    assert "dataset" in metadata[NAMES[0]]
    assert list(client.get_metadata(targets=[NAMES[0]])) == [NAMES[0]]


def test_client_metadata_unknown_target(side):
    with pytest.raises(side.io.NotFound):
        side.client().get_metadata(targets=["no-such-machine"])


def test_client_download_model(side):
    model = side.client().download_model(targets=[NAMES[0]])[NAMES[0]]
    assert side.predict_rows(model, 32).shape == (17, 4)  # lookback 16


def test_client_predict(side, tmp_path):
    results = side.client(prediction_forwarder=side.disk(str(tmp_path / "fwd"))).predict(
        START, END, targets=[NAMES[0]])
    assert len(results) == 1
    result = results[0]
    assert type(result).__name__ == "PredictionResult"
    assert result.error_messages == []
    assert result.predictions is not None and len(result.predictions) > 0
    assert "total-anomaly-scaled" in side.top_levels(result.predictions)
    assert list((tmp_path / "fwd" / NAMES[0]).glob("*.parquet"))


def test_client_predict_unknown_target(side):
    with pytest.raises(side.io.NotFound):
        side.client().predict(START, END, targets=["nope"])


def test_client_retries_503_with_retry_after(side, monkeypatch):
    """A shed 503 naming Retry-After on the first prediction answer is
    retried (the body rebuilt) and the retry's 200 wins: through
    ``call_with_retry_after`` with the JAX test's session, through the
    session's own retries over HTTP."""
    monkeypatch.setenv("GORDO_TPU_FAULT_BACKOFF_BASE", "0.01")
    state = {"calls": 0}
    if side.name == "jax":
        real = WSGISession.post

        def flaky(self, url, **kwargs):
            resp = real(self, url, **kwargs)
            if "/prediction" in url:
                state["calls"] += 1
                if state["calls"] == 1:
                    resp.status_code = 503
                    resp.headers["Retry-After"] = "0"
            return resp

        monkeypatch.setattr(WSGISession, "post", flaky)
    else:
        real = port_io.HTTPSession._exchange

        def flaky(parts, method, target, *args):
            resp = real(parts, method, target, *args)
            if "/prediction" in target:
                state["calls"] += 1
                if state["calls"] == 1:
                    return port_io.Response(503, port_io.header_map({"Retry-After": "0"}), b"{}")
            return resp

        monkeypatch.setattr(port_io.HTTPSession, "_exchange", staticmethod(flaky))
    results = side.client().predict(START, END, targets=[NAMES[0]])
    assert state["calls"] >= 2
    assert len(results) == 1 and results[0].error_messages == []
    assert results[0].predictions is not None


def test_client_cli_metadata(side, monkeypatch, tmp_path):
    out = tmp_path / "meta.json"
    args = ["--project", PROJECT, "metadata", "--target", NAMES[0], "--output-file", str(out)]
    if side.name == "jax":
        from click.testing import CliRunner

        def patched(**kwargs):
            kwargs.pop("session", None)
            return JaxClient(session=WSGISession(side.served["app"]), **kwargs)

        monkeypatch.setattr(jax_client_cli, "Client", patched)
        result = CliRunner().invoke(jax_client_cli.gordo_client, args)
        assert result.exit_code == 0, result.output
    else:
        assert port_client_cli.main(["--host", "127.0.0.1", "--port",
                                     str(side.served["port_port"]), "--scheme", "http",
                                     *args]) == 0
    assert NAMES[0] in json.loads(out.read_text())


def test_fan_out_first_failure_cancels_unstarted_and_raises_promptly(side):
    client = (JaxClient if side.name == "jax" else Client)(project="p", session=object())
    client.parallelism = 2
    started: list = []
    lock = threading.Lock()

    def fetch(name):
        with lock:
            started.append(name)
        if name == "m-0":
            raise RuntimeError("boom")
        time.sleep(0.2)
        return name

    names = [f"m-{i}" for i in range(40)]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="boom"):
        client._fan_out(fetch, names)
    assert time.monotonic() - t0 < 2.0
    assert len(started) < len(names)


def test_client_calls_carry_timeout(monkeypatch):
    """Every call of the port's client carries the (connect, read) timeout:
    the JAX test's stub session, and the default from
    ``GORDO_TPU_CLIENT_TIMEOUT`` as the JAX client reads it."""
    from gordo_tpu.client import client as jax_client_mod

    captured = []

    class StubResp:
        status_code = 200
        headers = {"Content-Type": "application/json"}
        content = b"{}"

        def json(self):
            return {"models": ["m-0"]}

    class StubSession:
        def get(self, url, params=None, timeout=None, **kwargs):
            captured.append(timeout)
            return StubResp()

    client = Client(project="p", session=StubSession())
    client.get_available_machines()
    client.get_metadata(targets=["m-0"])
    assert captured and all(t == DEFAULT_TIMEOUT == jax_client_mod.DEFAULT_TIMEOUT
                            for t in captured)
    for raw in ("5,60", "7", "bogus", ""):
        monkeypatch.setenv("GORDO_TPU_CLIENT_TIMEOUT", raw)
        assert _timeout_from_env() == jax_client_mod._timeout_from_env()
    monkeypatch.setenv("GORDO_TPU_CLIENT_TIMEOUT", "5,60")
    assert Client(project="p", session=StubSession()).timeout == (5.0, 60.0)
    assert Client(project="p", session=StubSession(), timeout=3.0).timeout == (3.0, 3.0)


def test_every_call_over_http_carries_the_timeout(served, monkeypatch):
    """Over the port's own session: the list, metadata, each prediction
    batch and each download carry the client's timeout to the socket."""
    seen = []
    real = port_io.HTTPSession._exchange

    def recording(parts, method, target, body, headers, connect_s, read_s):
        seen.append((method, target.split("?")[0].rsplit("/", 1)[-1], connect_s, read_s))
        return real(parts, method, target, body, headers, connect_s, read_s)

    monkeypatch.setattr(port_io.HTTPSession, "_exchange", staticmethod(recording))
    client = Client(project=PROJECT, host="127.0.0.1", port=served["port_port"], scheme="http",
                    device="cpu", timeout=(4.0, 40.0), batch_size=60)
    client.get_revisions()
    client.predict(START, END, targets=[NAMES[0]])
    client.download_model(targets=[NAMES[1]])
    kinds = {kind for _, kind, _, _ in seen}
    assert {"revisions", "models", "metadata", "prediction", "download-model"} <= kinds
    assert sum(kind == "prediction" for _, kind, _, _ in seen) == 3  # 145 rows / 60
    assert all((c, r) == (4.0, 40.0) for _, _, c, r in seen)


def test_use_parquet_is_refused_by_name():
    with pytest.raises(ValueError, match="use_parquet=True") as refused:
        Client(project="p", use_parquet=True)
    assert "pyarrow" in str(refused.value) and "JSON" in str(refused.value)
    assert Client(project="p").use_parquet is False


# -- the same answers from both pairs, and in both cross directions
def _answers(client) -> dict:
    predictions = client.predict(START, END)
    return {"machines": sorted(client.get_machine_names()),
            "revisions": client.get_revisions(),
            "metadata": client.get_metadata(),
            "predictions": {r.name: r for r in predictions}}


def _assert_same_answers(ours: dict, theirs: dict) -> None:
    assert ours["machines"] == theirs["machines"] == sorted(NAMES)
    assert ours["revisions"] == theirs["revisions"]
    assert _structure(ours["metadata"]) == _structure(theirs["metadata"])
    for name in NAMES:
        assert ours["metadata"][name]["dataset"] == theirs["metadata"][name]["dataset"]
        mine, jax = ours["predictions"][name], theirs["predictions"][name]
        assert mine.error_messages == jax.error_messages == []
        _assert_same_frames(mine.predictions, jax.predictions)


@pytest.fixture(scope="module")
def jax_answers(served):
    return _answers(JaxClient(project=PROJECT, session=WSGISession(served["app"]),
                              use_parquet=False, batch_size=100))


def test_both_clients_read_the_same_answers_from_their_servers(served, jax_answers):
    ours = _answers(Client(project=PROJECT, host="127.0.0.1", port=served["port_port"],
                           scheme="http", device="cpu", batch_size=100))
    _assert_same_answers(ours, jax_answers)


def test_the_port_client_reads_the_jax_app_alike(served, jax_answers):
    ours = _answers(Client(project=PROJECT, host="127.0.0.1", port=served["jax_port"],
                           scheme="http", device="cpu", batch_size=100))
    _assert_same_answers(ours, jax_answers)


def test_the_jax_client_reads_the_port_server_alike(served, jax_answers):
    theirs_on_ours = _answers(JaxClient(project=PROJECT, host="127.0.0.1",
                                        port=served["port_port"], scheme="http",
                                        use_parquet=False, batch_size=100))
    _assert_same_answers(theirs_on_ours, jax_answers)


def test_the_in_process_session_answers_as_http(served, jax_answers):
    server = make_server("127.0.0.1", 0, device="cpu",
                         collection_dir=str(served["root"] / "port" / REVISION),
                         bind_and_activate=False)
    ours = _answers(Client(project=PROJECT, session=DispatchSession(server), device="cpu",
                           batch_size=100))
    _assert_same_answers(ours, jax_answers)


def test_the_download_predicts_as_served(served):
    client = Client(project=PROJECT, host="127.0.0.1", port=served["port_port"], scheme="http",
                    device="cpu")
    served_frame = client.predict(START, END, targets=[NAMES[0]])[0].predictions
    model = client.download_model(targets=[NAMES[0]])[NAMES[0]]
    X, _ = client._get_data(client.get_metadata(targets=[NAMES[0]])[NAMES[0]], START, END)
    direct = np.asarray(model.predict(X.values), np.float64)
    group = dict((top, values) for top, _, values in served_frame.groups)["model-output"]
    np.testing.assert_allclose(group, direct, rtol=RTOL, atol=ATOL)


# -- the error mapping and the retries
def _fake(status, headers=None, payload=None, bad_json=False):
    class Fake:
        status_code = status
        content = b"{}"

        def __init__(self):
            self.headers = {"Content-Type": "application/json", **(headers or {})}

        def json(self):
            if bad_json:
                raise ValueError("not json")
            return payload if payload is not None else {}

    return Fake()


RESPONSES = [
    (200, {}, {"ok": 1}, False), (204, {"Content-Type": "text/plain"}, None, False),
    (422, {}, None, False), (404, {}, {"error": "nope"}, False), (410, {}, None, False),
    (400, {}, {"error": "bad"}, False), (401, {}, None, True), (499, {}, None, False),
    (500, {"X-Gordo-Trace": "deadbeef" * 4, "X-Gordo-Gateway-Node": "node-2"},
     {"error": "boom"}, False),
    (500, {"X-Gordo-Trace": "ab" * 16}, None, True), (502, {}, None, False),
    (503, {"Retry-After": "3"}, {"error": "busy"}, False),
    (503, {"Retry-After": "Wed, 21 Oct 2026 07:28:00 GMT"}, None, False),
    (503, {"Retry-After": "-2"}, None, False), (503, {}, {"error": "busy"}, False),
    (504, {"X-Gordo-Gateway-Node": "n"}, None, False),
]


def _mapped(module, response):
    try:
        return ("ok", module._handle_response(response, "thing"))
    except Exception as exc:  # noqa: BLE001 -- the class and message are compared
        return (type(exc).__name__, str(exc), getattr(exc, "retry_after_s", "-"))


@pytest.mark.parametrize("status,headers,payload,bad_json", RESPONSES)
def test_handle_response_maps_as_jax(status, headers, payload, bad_json):
    ours = _mapped(port_io, _fake(status, headers, payload, bad_json))
    theirs = _mapped(jax_io, _fake(status, headers, payload, bad_json))
    assert ours == theirs


@pytest.mark.parametrize("policy", [
    dict(max_attempts=3, backoff_base=0.1, backoff_factor=2.0, backoff_max=5.0, jitter=0.0),
    dict(max_attempts=2, backoff_base=0.1, backoff_factor=2.0, backoff_max=1.5, jitter=0.0),
    dict(max_attempts=5, backoff_base=0.5, backoff_factor=3.0, backoff_max=30.0, jitter=0.1),
])
@pytest.mark.parametrize("horizons", [(2.0, 2.0, None), (0.5, 0.5, 0.5, 0.5), (600.0,),
                                      (None, 0.01, 7.5)])
def test_call_with_retry_after_sleeps_as_jax(policy, horizons):
    sleeps = {}
    for module, faults in ((port_io, port_faults), (jax_io, jax_faults)):
        calls, slept = [], []

        def flaky():
            calls.append(1)
            if len(calls) <= len(horizons):
                raise module.ServerBusy("busy", retry_after_s=horizons[len(calls) - 1])
            return "ok"

        try:
            outcome = module.call_with_retry_after(flaky, faults.FaultPolicy(**policy),
                                                   sleep=slept.append)
        except module.ServerBusy:
            outcome = "busy"
        sleeps[module.__name__] = (outcome, len(calls), slept)
    assert sleeps["gordo_tpu_torch.client.io"] == sleeps["gordo_tpu.client.io"]


class _Flaky(http.server.BaseHTTPRequestHandler):
    """Answers its ``plan`` of (status, Retry-After) in turn, then 200."""

    plan: list = []
    served: list = []

    def _answer(self):
        if self.headers.get("Content-Length"):
            self.rfile.read(int(self.headers["Content-Length"]))
        status, retry_after = self.plan.pop(0) if self.plan else (200, None)
        self.served.append(status)
        body = b'{"ok": true}'
        self.send_response(status)
        if retry_after is not None:
            self.send_header("Retry-After", retry_after)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    do_GET = do_POST = _answer

    def log_message(self, *args):
        pass


@pytest.mark.parametrize("plan", [
    [(500, None)] * 3, [(503, "2"), (502, None), (504, "0")], [(500, None)] * 6,
    [(503, "1")] * 2 + [(500, None)] * 4, [(429, "3")], [(500, "4"), (500, None)],
], ids=["three-500", "mixed", "exhausted", "503-then-exhausted", "429-not-retried",
        "retry-after-on-500"])
@pytest.mark.parametrize("method", ["GET", "POST"])
def test_the_session_retries_and_sleeps_as_requests_adapter(plan, method, monkeypatch):
    """The port's session against ``requests`` with the JAX client's
    ``Retry`` adapter, on the same answers: the same attempts, the same
    sleeps and the same outcome."""
    from requests.adapters import HTTPAdapter, Retry

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Flaky)
    running = _Thread(server)
    url = f"http://127.0.0.1:{running.port}/thing"
    outcomes = []
    try:
        for which in ("requests", "port"):
            _Flaky.plan, _Flaky.served, slept = list(plan), [], []
            if which == "requests":
                session = requests.Session()
                session.mount("http://", HTTPAdapter(max_retries=Retry(
                    total=5, backoff_factor=0.5, status_forcelist=(500, 502, 503, 504),
                    allowed_methods=("GET", "POST"))))
                monkeypatch.setattr(urllib3.util.retry.time, "sleep", slept.append)
            else:
                session = port_io.HTTPSession(n_retries=5, sleep=slept.append)
            call = session.get if method == "GET" else session.post
            try:
                status = call(url, timeout=(5.0, 5.0)).status_code
            except (requests.exceptions.RetryError, port_io.RetryError) as exc:
                status = ("retries spent", "too many" in str(exc))
            monkeypatch.undo()
            outcomes.append((status, list(_Flaky.served), slept))
    finally:
        running.close()
    assert outcomes[0] == outcomes[1]


def test_the_session_retries_a_refused_connection_then_raises():
    slept = []
    session = port_io.HTTPSession(n_retries=3, sleep=slept.append)
    probe = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Flaky)
    port = probe.server_address[1]
    probe.server_close()
    with pytest.raises(ConnectionRefusedError):
        session.get(f"http://127.0.0.1:{port}/x", timeout=(1.0, 1.0))
    assert slept == [1.0, 2.0]  # urllib3: none before the first retry


# -- C4: the JAX-rendered client task speaks https to the plain-HTTP server
def test_c4_the_rendered_client_task_reaches_the_server_only_on_the_card_template(served,
                                                                                  tmp_path,
                                                                                  monkeypatch):
    """The client task of JAX's template passes no ``--scheme``, so the
    client's default https meets the server's plain-HTTP Service port: it
    fails. The card's template adds ``--scheme=http``, and the same task
    predicts."""
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump({"machines": [
        {"name": NAMES[0], "dataset": {"type": "RandomDataset", "tags": ["a"],
                                       "train_start_date": "2019-01-01T00:00:00+00:00",
                                       "train_end_date": "2019-01-08T00:00:00+00:00"},
         "model": {"gordo_tpu.models.models.AutoEncoder": {"kind": "feedforward_hourglass"}}}]}))
    monkeypatch.setattr(port_io.HTTPSession, "backoff", lambda self, errors: 0.0)
    codes = []
    for generate in (jax_cli_gen.generate_workflow_docs, port_gen.generate_workflow_docs):
        doc = yaml.safe_load(generate(machine_config=str(config), project_name=PROJECT,
                                      client_start_date=START, client_end_date=END))
        task = next(t for t in doc["spec"]["templates"] if t["name"] == "gordo-client")
        args = [arg.replace("{{inputs.parameters.machine-name}}", NAMES[0])
                .replace(f"gordo-server-{PROJECT}", "127.0.0.1")
                .replace("--port=80", f"--port={served['port_port']}")
                for arg in task["container"]["args"] if not arg.startswith("--influx")]
        try:
            codes.append(port_client_cli.main(args))
        except OSError as exc:  # the TLS handshake against plain HTTP
            codes.append(type(exc).__name__)
    assert codes[0] != 0 and codes[1] == 0
