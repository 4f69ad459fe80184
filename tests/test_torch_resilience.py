"""
The port's serving resilience (``gordo_tpu_torch/server/resilience.py`` and
its wiring in the server, the views, both fast lanes and the batcher)
against the JAX package's (``gordo_tpu/server/resilience.py`` and the JAX
server), after the cases of ``tests/gordo_tpu/test_resilience.py``:

- the module's functions on the same scripts, with an injected clock
  (a patched ``time.monotonic``): the gate, deadlines, breakers, drain,
  watchdog and output guard give the same answers and counter values;
- the JAX app (werkzeug's test client) and the port's route table
  (``GordoServer.dispatch``) on the same requests: the shed 503 with
  ``Retry-After``, a corrupt artifact's 500 then its breaker's 503, a spent
  deadline's 504 and the watchdog's 503 on ``/healthcheck`` have the same
  statuses, headers and JSON bodies (a deadline's overrun in milliseconds
  differs with the clock), and the catalog counts them alike;
- with every knob unset, the default lane and both fast lanes answer as
  before and the layer leaves no state behind;
- the batcher: a rider whose deadline runs out in the queue is abandoned
  (504) while its cohort answers, a poisoned model's rider of a fused call
  fails alone (``GORDO_TPU_VALIDATE_OUTPUT``), and the ``serve_device_call``
  site fires against the riders' models.
"""

import http.client
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder.local_build import local_build
from gordo_tpu.observability import metrics as jax_catalog
from gordo_tpu.server import resilience as jax_resilience
from gordo_tpu.server import utils as jax_server_utils
from gordo_tpu.server.server import build_app
from gordo_tpu.util import faults as jax_faults
from gordo_tpu_torch.observability import metrics as metric_catalog
from gordo_tpu_torch.server import batcher, fastlane, resilience
from gordo_tpu_torch.server.server import make_server
from gordo_tpu_torch.util import faults
from test_torch_serving import CONFIG, NAME, _port_from_jax_artifact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = ("GORDO_TPU_MAX_INFLIGHT", "GORDO_TPU_RETRY_AFTER_S", "GORDO_TPU_DEADLINE_MS",
         "GORDO_TPU_BREAKER_THRESHOLD", "GORDO_TPU_BREAKER_COOLDOWN_S", "GORDO_TPU_DRAIN_S",
         "GORDO_TPU_WATCHDOG_S", "GORDO_TPU_VALIDATE_OUTPUT", "GORDO_TPU_SERVING_BATCH",
         faults.PLAN_ENV)
# a small transformer-ae-512: the same family and config keys at CPU size
SMALL = dict(kind="transformer_model", lookback_window=16, d_model=16, num_heads=2, ff_dim=32,
             num_blocks=2, causal=True, pool="last", attention="auto")


def write_artifacts(collection: Path, names, poisoned=()) -> None:
    """Port artifacts of one small Transformer spec (seeded weights per
    name); a name in ``poisoned`` has a NaN in its first kernel."""
    sys.path.insert(0, REPO)
    import chip_smoke

    for seed, name in enumerate(names):
        chip_smoke.write_artifact(collection, device="cpu", name=name, seed=seed, config=SMALL)
        if name in poisoned:
            path = collection / name / "params.npz"
            params = dict(np.load(path))
            params["0/kernel"] = params["0/kernel"].copy()
            params["0/kernel"][0, 0] = np.nan
            np.savez(path, **params)


def rect_body(rows: int, seed: int = 0, tags: int = 8) -> bytes:
    values = np.random.RandomState(seed).rand(rows, tags).tolist()
    return json.dumps({"X": values, "y": values}).encode()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    for module in (faults, jax_faults):
        module.reset_plan()
    for module in (resilience, jax_resilience):
        module.reset_for_tests()
    batcher.reset_batcher()
    yield
    for module in (faults, jax_faults):
        module.reset_plan()
    for module in (resilience, jax_resilience):
        module.reset_for_tests()
    batcher.reset_batcher()


class Clock:
    """An injected ``time.monotonic`` that moves only when told."""

    def __init__(self, now: float = 5000.0):
        self.now = now

    def __call__(self) -> float:
        return self.now


def _set_plan(monkeypatch, rules):
    monkeypatch.setenv(faults.PLAN_ENV, json.dumps({"rules": rules}))
    faults.reset_plan()
    jax_faults.reset_plan()


# ------------------------------------------------------------- the functions
def test_gate_and_drain_agree(monkeypatch):
    def script(module):
        out = [module.try_admit() for _ in range(3)]
        out.append(module.gated_inflight())
        module.release()
        out += [module.try_admit(), module.gated_inflight(), module.max_inflight(),
                module.retry_after_s()]
        module.request_started()
        module.request_started()
        out += [module.inflight_requests(), module.begin_drain(), module.begin_drain(),
                module.is_draining(), module.wait_drained(budget_s=0.0)]
        module.request_finished()
        module.request_finished()
        out += [module.wait_drained(budget_s=0.0), module.drain_budget_s()]
        return out

    monkeypatch.setenv("GORDO_TPU_MAX_INFLIGHT", "2")
    monkeypatch.setenv("GORDO_TPU_RETRY_AFTER_S", "7")
    monkeypatch.setenv("GORDO_TPU_DRAIN_S", "12")
    before = (metric_catalog.SERVER_SHED.value(reason="max_inflight"),
              jax_catalog.SERVER_SHED.value(reason="max_inflight"))
    ours, theirs = script(resilience), script(jax_resilience)
    assert ours == theirs
    assert ours[2]["reason"] == "max_inflight" and ours[2]["retry-after-seconds"] == 7.0
    assert (metric_catalog.SERVER_SHED.value(reason="max_inflight") - before[0]
            == jax_catalog.SERVER_SHED.value(reason="max_inflight") - before[1] == 1)


@pytest.mark.parametrize("header, env", [(None, None), (None, "500"), ("125", "500"),
                                         ("soon", None), ("-5", None), ("0", "30")])
def test_deadline_parsing_agrees(monkeypatch, header, env):
    if env is not None:
        monkeypatch.setenv("GORDO_TPU_DEADLINE_MS", env)
    headers = {} if header is None else {"X-Gordo-Deadline-Ms": header}
    assert resilience.deadline_ms_from(headers) == jax_resilience.deadline_ms_from(headers)


def test_deadline_scope_agrees_under_an_injected_clock(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(time, "monotonic", clock)

    def script(module, catalog):
        out = [module.remaining_s(), module.current_model()]
        with module.request_scope(model="m", deadline_ms=250):
            out += [module.current_model(), module.remaining_s()]
            module.check_deadline("preflight")
            clock.now += 0.3
            before = catalog.SERVER_DEADLINE_EXCEEDED.value(where="preflight")
            try:
                module.check_deadline("preflight")
            except module.DeadlineExceeded as exc:
                out.append(str(exc))
            out.append(catalog.SERVER_DEADLINE_EXCEEDED.value(where="preflight") - before)
        out += [module.current_model(), module.remaining_s()]
        return out

    ours = script(resilience, metric_catalog)
    theirs = script(jax_resilience, jax_catalog)
    assert ours == theirs
    assert ours[4] == "request deadline exceeded (preflight, 50ms over budget)" and ours[5] == 1


def test_breakers_agree_under_an_injected_clock(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    monkeypatch.setenv("GORDO_TPU_BREAKER_THRESHOLD", "3")
    monkeypatch.setenv("GORDO_TPU_BREAKER_COOLDOWN_S", "60")

    model = "m-parity-breaker"  # a label no other test of the process sets

    def script(module, fault_module, catalog):
        opens = catalog.BREAKER_OPENS.value(model=model)
        fast = catalog.BREAKER_FAST_FAILURES.value(model=model)
        breaker, out = module.breaker_for(model), []
        steps = [("fail", fault_module.TransientFault("hiccup"))] * 2 + [("allow",)] \
            + [("fail", fault_module.TransientFault("hiccup")), ("allow",), ("tick", 30),
               ("allow",), ("tick", 31), ("allow",), ("allow",),
               ("fail", fault_module.PermanentFault("corrupt")), ("tick", 61), ("allow",),
               ("tick", 61), ("allow",), ("succeed",), ("allow",),
               ("fail", fault_module.NonFiniteDataError("nan")), ("allow",)]
        for step in steps:
            if step[0] == "fail":
                breaker.record_failure(step[1])
            elif step[0] == "succeed":
                breaker.record_success()
            elif step[0] == "tick":
                clock.now += step[1]
            else:
                info = breaker.allow()
                out.append(info)
                if info is not None:
                    out.append(module.breaker_retry_after_header(info))
            out.append((breaker.state, catalog.BREAKER_STATE.value(model=model)))
        out.append((catalog.BREAKER_OPENS.value(model=model) - opens,
                    catalog.BREAKER_FAST_FAILURES.value(model=model) - fast))
        return out

    ours = script(resilience, faults, metric_catalog)
    theirs = script(jax_resilience, jax_faults, jax_catalog)
    assert ours == theirs
    assert ours[-1][0] >= 3 and ours[-1][1] >= 3
    monkeypatch.delenv("GORDO_TPU_BREAKER_THRESHOLD")
    assert resilience.breaker_for("m-b") is None and jax_resilience.breaker_for("m-b") is None


def test_breaker_admits_one_probe_under_race(monkeypatch):
    monkeypatch.setenv("GORDO_TPU_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("GORDO_TPU_BREAKER_COOLDOWN_S", "30")
    breaker = resilience.breaker_for("m-race")
    breaker.record_failure(faults.PermanentFault("corrupt"))
    breaker._opened_at -= 31
    barrier, results = threading.Barrier(16), [None] * 16

    def hit(i):
        barrier.wait()
        results[i] = breaker.allow()

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert sum(r is None for r in results) == 1
    assert breaker.state == resilience.HALF_OPEN


def test_output_guard_agrees(monkeypatch):
    outputs = [np.ones(4), np.array([1.0, np.nan, np.inf]), np.arange(3)]

    def script(module):
        out = []
        for value in outputs:
            try:
                module.check_output_finite(value, "m")
                out.append(None)
            except ValueError as exc:
                out.append((type(exc).__name__, str(exc)))
        return out

    assert script(resilience) == script(jax_resilience) == [None, None, None]
    monkeypatch.setenv("GORDO_TPU_VALIDATE_OUTPUT", "1")
    assert script(resilience) == script(jax_resilience) == [
        None, ("NonFiniteDataError", "model 'm' produced 2 non-finite output value(s)"), None]


class _StuckBatcher:
    def __init__(self, stuck):
        self.stuck = stuck

    def device_call_stuck_s(self):
        return self.stuck

    def close(self):
        pass


def test_watchdog_agrees(monkeypatch):
    import gordo_tpu.server.batcher as jax_batcher

    assert resilience.stuck_device_call_s() is None
    monkeypatch.setenv("GORDO_TPU_WATCHDOG_S", "0.5")
    for stuck in (0.1, 1.2345):
        monkeypatch.setattr(batcher, "_batcher", _StuckBatcher(stuck))
        monkeypatch.setattr(jax_batcher, "_batcher", _StuckBatcher(stuck))
        before = (metric_catalog.WATCHDOG_TRIPS.value(), jax_catalog.WATCHDOG_TRIPS.value())
        assert resilience.stuck_device_call_s() == jax_resilience.stuck_device_call_s()
        assert (metric_catalog.WATCHDOG_TRIPS.value() - before[0]
                == jax_catalog.WATCHDOG_TRIPS.value() - before[1] == (stuck > 0.5))


# ----------------------------------------------------- the JAX app and ours
class _Headers(dict):
    def get(self, name, default=None):
        for key, value in self.items():
            if key.lower() == name.lower():
                return value
        return default


def _ours(server, method, path, body=b"", headers=None):
    status, out, data = server.dispatch(method, path, _Headers(headers or {}), body)
    return status, {k.lower(): v for k, v in out}, data


def _theirs(app, method, path, body=b"", headers=None):
    resp = app.test_client().open(path, method=method, data=body, headers=headers or {})
    return resp.status_code, {k.lower(): v for k, v in resp.headers.items()}, resp.get_data()


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    """(JAX collection, port collection) of the serving test's machine."""
    root = tmp_path_factory.mktemp("resilience")
    jax_coll, port_coll = root / "jax" / "111", root / "port" / "111"
    (model, machine), = local_build(CONFIG)
    jax_serializer.dump(model, str(jax_coll / NAME), metadata=machine.to_dict())
    _port_from_jax_artifact(str(jax_coll / NAME), str(port_coll / NAME))
    return jax_coll, port_coll


@pytest.fixture()
def servers(collections):
    jax_server_utils.clear_model_caches()
    ours = make_server("127.0.0.1", 0, device="cpu", collection_dir=str(collections[1]),
                       bind_and_activate=False)
    yield ours, build_app({"MODEL_COLLECTION_DIR": str(collections[0])})
    ours.server_close()
    jax_server_utils.clear_model_caches()


JSON = {"Content-Type": "application/json"}


def _strip(headers: dict) -> dict:
    """The headers both servers set alike (no timing, trace or length)."""
    return {k: v for k, v in headers.items()
            if k in ("content-type", "retry-after", "revision")}


def test_shed_is_the_jax_servers(servers, monkeypatch):
    """A slot held by a request in flight, ``GORDO_TPU_MAX_INFLIGHT=1``: the
    next prediction is shed (503, ``Retry-After``, no revision) on both, and
    once the slot is free the request is admitted."""
    ours, theirs = servers
    monkeypatch.setenv("GORDO_TPU_MAX_INFLIGHT", "1")
    monkeypatch.setenv("GORDO_TPU_RETRY_AFTER_S", "3")
    url = "/gordo/v0/p/no-such-model/prediction"
    before = (metric_catalog.SERVER_SHED.value(reason="max_inflight"),
              jax_catalog.SERVER_SHED.value(reason="max_inflight"))
    assert resilience.try_admit() is None and jax_resilience.try_admit() is None
    mine, jax = _ours(ours, "POST", url, b"{}", JSON), _theirs(theirs, "POST", url, b"{}", JSON)
    assert mine[0] == jax[0] == 503
    assert _strip(mine[1]) == _strip(jax[1]) == {"content-type": "application/json",
                                                  "retry-after": "3"}
    assert json.loads(mine[2]) == json.loads(jax[2])
    assert json.loads(mine[2])["reason"] == "max_inflight"
    assert (metric_catalog.SERVER_SHED.value(reason="max_inflight") - before[0]
            == jax_catalog.SERVER_SHED.value(reason="max_inflight") - before[1] == 1)
    # a GET of a prediction route is no prediction: answered, not shed
    assert _ours(ours, "GET", url)[0] == _theirs(theirs, "GET", url)[0] == 405
    resilience.release()
    jax_resilience.release()
    assert _ours(ours, "POST", url, b"{}", JSON)[0] == _theirs(theirs, "POST", url, b"{}",
                                                               JSON)[0] == 404
    assert resilience.gated_inflight() == jax_resilience.gated_inflight() == 0


def test_a_corrupt_artifacts_breaker_is_the_jax_servers(servers, collections, monkeypatch):
    ours, theirs = servers
    clock = Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    monkeypatch.setenv("GORDO_TPU_BREAKER_THRESHOLD", "3")
    monkeypatch.setenv("GORDO_TPU_BREAKER_COOLDOWN_S", "60")
    for coll, garbage in ((collections[0], ("model.pkl", b"\x80\x04 truncated")),
                          (collections[1], ("model.json", b"{ truncated"))):
        (coll / "m-bad").mkdir(exist_ok=True)
        (coll / "m-bad" / "metadata.json").write_text(json.dumps({"dataset": {"tags": []}}))
        (coll / "m-bad" / garbage[0]).write_bytes(garbage[1])
    url = "/gordo/v0/p/m-bad/prediction"
    first = _ours(ours, "POST", url, b"{}", JSON), _theirs(theirs, "POST", url, b"{}", JSON)
    assert first[0][0] == first[1][0] == 500
    assert json.loads(first[0][2]) == json.loads(first[1][2]) == {
        "error": "Model 'm-bad' failed to load", "revision": "111"}
    clock.now += 20
    second = _ours(ours, "POST", url, b"{}", JSON), _theirs(theirs, "POST", url, b"{}", JSON)
    assert second[0][0] == second[1][0] == 503
    assert _strip(second[0][1]) == _strip(second[1][1])
    assert second[0][1]["retry-after"] == "40"
    assert json.loads(second[0][2]) == json.loads(second[1][2])
    assert json.loads(second[0][2])["model"] == "m-bad"
    assert resilience.breaker_for("m-bad").state == jax_resilience.breaker_for("m-bad").state \
        == resilience.OPEN


def test_an_injected_load_fault_is_cached_and_counted_alike(servers, monkeypatch):
    ours, theirs = servers
    _set_plan(monkeypatch, [{"site": "serve_model_load", "machine": NAME, "times": 1,
                             "error": "permanent"}])
    url = f"/gordo/v0/p/{NAME}/prediction"
    body = rect_body(40, tags=4)
    for _ in range(2):  # the second answer comes from the failure cache
        mine, jax = _ours(ours, "POST", url, body, JSON), _theirs(theirs, "POST", url, body, JSON)
        assert mine[0] == jax[0] == 500
        assert json.loads(mine[2]) == json.loads(jax[2])


def test_a_spent_deadline_is_the_jax_servers_504(servers, monkeypatch):
    ours, theirs = servers
    url = f"/gordo/v0/p/{NAME}/anomaly/prediction"
    body = rect_body(40, tags=4)
    assert _ours(ours, "POST", url, body, JSON)[0] == _theirs(theirs, "POST", url, body,
                                                              JSON)[0] == 200
    before = (metric_catalog.SERVER_DEADLINE_EXCEEDED.value(where="preflight"),
              jax_catalog.SERVER_DEADLINE_EXCEEDED.value(where="preflight"))
    answers = []
    for serve, app in ((_ours, ours), (_theirs, theirs)):
        _set_plan(monkeypatch, [{"site": "serve_predict", "times": 1, "error": "wedge",
                                 "seconds": 0.2}])
        answers.append(serve(app, "POST", url, body, dict(JSON, **{"X-Gordo-Deadline-Ms": "50"})))
    (mine, jax) = answers
    assert mine[0] == jax[0] == 504
    assert _strip(mine[1]) == _strip(jax[1])
    doc, jax_doc = json.loads(mine[2]), json.loads(jax[2])
    assert sorted(doc) == sorted(jax_doc) == ["error", "revision"]
    assert doc["error"].startswith("request deadline exceeded (preflight, ")
    assert jax_doc["error"].startswith("request deadline exceeded (preflight, ")
    assert (metric_catalog.SERVER_DEADLINE_EXCEEDED.value(where="preflight") - before[0]
            == jax_catalog.SERVER_DEADLINE_EXCEEDED.value(where="preflight") - before[1] == 1)
    # without the header the route serves
    assert _ours(ours, "POST", url, body, JSON)[0] == 200


def test_the_watchdogs_healthcheck_is_the_jax_servers(servers, monkeypatch):
    import gordo_tpu.server.batcher as jax_batcher

    ours, theirs = servers
    monkeypatch.setenv("GORDO_TPU_WATCHDOG_S", "0.5")
    monkeypatch.setattr(batcher, "_batcher", _StuckBatcher(1.2345))
    monkeypatch.setattr(jax_batcher, "_batcher", _StuckBatcher(1.2345))
    mine, jax = _ours(ours, "GET", "/healthcheck"), _theirs(theirs, "GET", "/healthcheck")
    assert mine[0] == jax[0] == 503
    assert json.loads(mine[2]) == json.loads(jax[2]) == {
        "error": "device watchdog: dispatcher stuck in one device call", "stuck-seconds": 1.234}
    monkeypatch.setattr(batcher, "_batcher", _StuckBatcher(0.0))
    assert _ours(ours, "GET", "/healthcheck")[0] == 200


def test_debug_prewarm_and_the_resilience_blocks_are_the_jax_servers(servers, monkeypatch):
    """``/debug/prewarm`` warms through the server's own model cache and
    answers the JAX report's keys (and the port's), which ``/debug/vars``
    then carries; an unknown revision is 410; ``/debug/config`` resolves the
    resilience knobs as the JAX server does."""
    ours, theirs = servers
    monkeypatch.setenv("GORDO_TPU_DEBUG_ENDPOINTS", "1")
    monkeypatch.setenv("GORDO_TPU_WARMUP_ROWS", "8")
    for knob, value in (("GORDO_TPU_MAX_INFLIGHT", "3"), ("GORDO_TPU_DEADLINE_MS", "250"),
                        ("GORDO_TPU_BREAKER_THRESHOLD", "2"), ("GORDO_TPU_WATCHDOG_S", "9"),
                        ("GORDO_TPU_VALIDATE_OUTPUT", "1")):
        monkeypatch.setenv(knob, value)
    warm = f"/debug/prewarm?machine={NAME}"  # a corrupt artifact of another test may be there
    mine, jax = _ours(ours, "POST", warm), _theirs(theirs, "POST", warm)
    assert mine[0] == jax[0] == 200
    report, jax_report = json.loads(mine[2]), json.loads(jax[2])
    assert set(jax_report) <= set(report)
    assert report["models"] == jax_report["models"] == 1 and report["failed"] == []
    (arch,) = report["architectures"].values()
    assert arch["models"] == [NAME] and arch["rows"] == [8]
    # the bank holds the served module: the warm-up loaded it through the cache
    assert ours.models[NAME].detector is ours.model_entry("111", NAME).detector
    doc = json.loads(_ours(ours, "GET", "/debug/vars")[2])
    assert doc["warmup"] == report
    assert doc["server"] == {"inflight_requests": 0, "gated_inflight": 0, "draining": False,
                             "project": os.environ.get("PROJECT")}
    resolved = json.loads(_ours(ours, "GET", "/debug/config")[2])["resolved"]
    jax_resolved = json.loads(_theirs(theirs, "GET", "/debug/config")[2])["resolved"]
    for key in ("max_inflight", "retry_after_s", "deadline_ms_default", "breaker_threshold",
                "drain_budget_s", "watchdog_threshold_s", "validate_output"):
        assert resolved[key] == jax_resolved[key], key
    assert _ours(ours, "POST", "/debug/prewarm?revision=nope")[0] == _theirs(
        theirs, "POST", "/debug/prewarm?revision=nope")[0] == 410
    assert _ours(ours, "POST", "/debug/prewarm?revision=..")[0] == 410


# --------------------------------------------------------- every knob unset
@pytest.fixture(scope="module")
def lanes(collections):
    """The default lane and both fast lanes over one port collection."""
    app = make_server("127.0.0.1", 0, device="cpu", collection_dir=str(collections[1]),
                      bind_and_activate=False)
    fronts = [make_server("127.0.0.1", 0, device="cpu", collection_dir=str(collections[1])),
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


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


def _masked(body: bytes) -> dict:
    doc = json.loads(body)
    doc.pop("time-seconds", None)
    return doc


def test_with_every_knob_unset_the_lanes_answer_as_before(lanes, collections):
    """Every lane answers a prediction, a shed-free burst and a breaker-free
    failure as it did without the layer; no gate slot, in-flight count or
    breaker is left behind."""
    from gordo_tpu_torch.server import views
    from gordo_tpu_torch.server.server import ModelEntry

    entry = ModelEntry(str(collections[1] / NAME), "cpu")
    body = rect_body(40, tags=4)
    status, direct = views.anomaly_prediction_core(
        entry.detector, body, entry.tags, entry.target_tags, entry.frequency, False)
    assert status == 200
    expected = json.loads(views.response_bytes(dict(direct, revision="111"), False))
    expected.pop("time-seconds")
    for port in lanes:
        for path, sent, want in ((f"/gordo/v0/p/{NAME}/anomaly/prediction", body, 200),
                                 (f"/gordo/v0/p/{NAME}/prediction", b"{}", 400),
                                 ("/gordo/v0/p/nope/prediction", b"{}", 404)):
            got = _request(port, "POST", path, sent, JSON)
            assert got[0] == want, (port, path)
            assert "retry-after" not in got[1] and got[1]["connection"] == "keep-alive"
            if want == 200:
                assert _masked(got[2]) == expected
        assert _request(port, "GET", "/healthcheck")[0] == 200
    assert resilience.gated_inflight() == 0 and resilience.inflight_requests() == 0
    assert not resilience._breakers and not resilience.is_draining()


def test_the_fast_lanes_shed_and_break_as_the_default_lane(lanes, monkeypatch):
    monkeypatch.setenv("GORDO_TPU_MAX_INFLIGHT", "1")
    monkeypatch.setenv("GORDO_TPU_RETRY_AFTER_S", "2")
    assert resilience.try_admit() is None  # a request in flight holds the slot
    body = rect_body(40, tags=4)
    answers = [_request(port, "POST", f"/gordo/v0/p/{NAME}/anomaly/prediction", body, JSON)
               for port in lanes]
    assert [a[0] for a in answers] == [503] * 3
    assert {a[1]["retry-after"] for a in answers} == {"2"}
    assert len({a[2] for a in answers}) == 1
    resilience.release()


# ------------------------------------------------------------------ batcher
@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """Three port artifacts of one small spec; ``m-bad`` is poisoned."""
    collection = tmp_path_factory.mktemp("small") / "1"
    collection.mkdir()
    write_artifacts(collection, ["m-0", "m-1", "m-bad"], poisoned=("m-bad",))
    return collection


def _estimator(collection, name):
    from gordo_tpu_torch.server.server import ModelEntry

    return ModelEntry(str(collection / name), "cpu").detector.base_estimator.steps[-1][1]


def test_a_poisoned_rider_fails_alone(small, monkeypatch):
    """The per-rider guard of a fused call: the poisoned model gets
    ``NonFiniteDataError``, its cohort its own direct predict's rows."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from gordo_tpu_torch.ops.predict import pad_for_predict

    monkeypatch.setenv("GORDO_TPU_VALIDATE_OUTPUT", "1")
    ests = [_estimator(small, name) for name in ("m-0", "m-bad", "m-1")]
    X = np.random.RandomState(1).rand(40, 8).astype(np.float32)
    fused = batcher.CrossModelBatcher()
    items = []
    for est, tag in zip(ests, ("m-0", "m-bad", "m-1")):
        X_pad, n_pad, n_keep = pad_for_predict(est.spec_, X)
        item = batcher._Item(est.spec_, est.module_, X_pad, n_pad, n_keep,
                             batcher._device_of(est.module_), tag=tag)
        fused._ring.put(item)
        items.append(item)
    fused._ensure_thread()
    for item in items:
        assert item.done.wait(timeout=60)
    fused.close()
    assert fused.stats["device_calls"] == 1 and fused.stats["largest_batch"] == 3
    assert isinstance(items[1].error, faults.NonFiniteDataError)
    assert "'m-bad'" in str(items[1].error)
    for item, est in ((items[0], ests[0]), (items[2], ests[2])):
        assert item.error is None
        np.testing.assert_allclose(item.result, est._predict(X), rtol=1e-5, atol=1e-6)
    del chip_smoke


def test_a_deadline_spent_in_the_queue_abandons_the_rider(small, monkeypatch):
    """A wedged first call holds the dispatcher; a rider whose deadline runs
    out behind it is answered 504 (``DeadlineExceeded``) and abandoned, and
    the call behind it answers the others."""
    monkeypatch.setenv("GORDO_TPU_SERVING_BATCH", "1")
    _set_plan(monkeypatch, [{"site": "serve_device_call", "machine": "m-0", "times": 1,
                             "error": "wedge", "seconds": 0.5}])
    est0, est1 = _estimator(small, "m-0"), _estimator(small, "m-1")
    X = np.random.RandomState(2).rand(40, 8).astype(np.float32)
    before = (metric_catalog.BATCHER_ABANDONED.value(),
              metric_catalog.SERVER_DEADLINE_EXCEEDED.value(where="queue_wait"))
    results, started = {}, threading.Event()

    def wedged():
        with resilience.request_scope(model="m-0"):
            started.set()
            results["m-0"] = batcher.maybe_submit(est0.spec_, est0.module_, X)

    thread = threading.Thread(target=wedged)
    thread.start()
    assert started.wait(timeout=30)
    fused = batcher.get_batcher()
    deadline = time.monotonic() + 30
    while fused.device_call_stuck_s() == 0.0:  # the dispatcher is inside the wedge
        assert time.monotonic() < deadline
        time.sleep(0.005)
    with resilience.request_scope(model="m-1", deadline_ms=50):
        with pytest.raises(resilience.DeadlineExceeded, match="expired in the batch queue"):
            batcher.maybe_submit(est1.spec_, est1.module_, X)
    thread.join(timeout=60)
    np.testing.assert_allclose(results["m-0"], est0._predict(X), rtol=1e-5, atol=1e-6)
    assert metric_catalog.BATCHER_ABANDONED.value() - before[0] == 1
    assert metric_catalog.SERVER_DEADLINE_EXCEEDED.value(where="queue_wait") - before[1] == 1
    assert fused.stats["abandoned"] == 1
    # the abandoned rider was never computed: one device call, m-0's
    assert fused.stats["items"] == 1


def test_the_device_call_site_fires_against_the_riders(small, monkeypatch):
    """``serve_device_call`` matched against the riders' models: a permanent
    fault on m-1's fused call bisects down to its serial rescue, where it
    fires again and fails m-1 alone."""
    monkeypatch.setenv("GORDO_TPU_SERVING_BATCH", "1")
    _set_plan(monkeypatch, [{"site": "serve_device_call", "machine": "m-1", "times": -1,
                             "error": "permanent"}])
    ests = {name: _estimator(small, name) for name in ("m-0", "m-1")}
    X = np.random.RandomState(3).rand(40, 8).astype(np.float32)
    fused = batcher.CrossModelBatcher()
    items = []
    from gordo_tpu_torch.ops.predict import pad_for_predict

    for name, est in ests.items():
        X_pad, n_pad, n_keep = pad_for_predict(est.spec_, X)
        item = batcher._Item(est.spec_, est.module_, X_pad, n_pad, n_keep,
                             batcher._device_of(est.module_), tag=name)
        fused._ring.put(item)
        items.append(item)
    fused._ensure_thread()
    for item in items:
        assert item.done.wait(timeout=60)
    fused.close()
    assert items[0].error is None
    assert isinstance(items[1].error, faults.PermanentFault)
    assert fused.stats["bisections"] >= 1 and fused.stats["serial_rescues"] >= 1
