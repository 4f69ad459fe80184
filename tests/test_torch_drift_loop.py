"""
The self-healing drift loop in the port, end to end on the CPU, and its
seams against the JAX package, after ``tests/gordo_tpu/test_drift_loop.py``:

- warm starts: a JAX fleet (two hourglass machines and one tiny
  Transformer, which the port runs on the plain attention twins) is built
  and registered by the JAX ``BatchedModelBuilder``, carried over to the
  port (``serializer/from_jax.py``) and registered there under the port's
  keys; with their data windows refreshed as a drift would refresh them,
  both fleet trainers warm-start every machine from those parameters, and
  the port's epoch losses (on the JAX program's own sample orders,
  ``test_torch_fleet.jax_draws``) are the JAX ones within 1e-4; a spec whose
  layers do not match falls back to a cold init in both;
- the served drift observation: one request to the JAX ``build_app`` and to
  the port's server feeds the same statistic within 1e-4 relative, on the
  base and the anomaly route; ``/debug/drift`` answers the JAX body's keys;
- the loop: detect on live threaded traffic through the port's route table
  (the batcher forced on), enqueue once per drifted machine, hysteresis,
  drain into a warm-start delta revision of exactly the drifted machines,
  swap under load, recalibrate, with zero 5xx, each machine's revision
  sequence, the counters and the marker, as the JAX test holds them; its
  "zero trace compiles after the swap" is here "the bank's capacity and
  restacks unchanged"; a pinned revision bypasses the override;
- ``/debug/prewarm`` of an explicit revision, and the CLI's
  ``batch-build --drain-drift-queue`` and ``drift-rebuilder --once``.

Float32 on both sides: the loss tolerance is ``tests/test_torch_fleet.py``'s.
"""

import json
import os
import pickle
import shutil
import threading
import time
from datetime import datetime, timezone

import numpy as np
import pytest
import torch

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder import drift_rebuild as jax_rebuild
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.observability import drift as jax_drift
from gordo_tpu.observability import metrics as jax_catalog
from gordo_tpu.parallel import batch_trainer as jax_bt
from gordo_tpu.server import hotswap as jax_hotswap
from gordo_tpu.server import utils as jax_server_utils
from gordo_tpu.server.server import build_app
from gordo_tpu_torch import cli, serializer
from gordo_tpu_torch.builder import drift_rebuild
from gordo_tpu_torch.builder.build_model import ModelBuilder
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.observability import drift
from gordo_tpu_torch.observability import metrics as metric_catalog
from gordo_tpu_torch.parallel import batch_trainer as bt
from gordo_tpu_torch.parallel import drift_queue
from gordo_tpu_torch.serializer.from_jax import detector_from_arrays, spec_from_dataclass
from gordo_tpu_torch.server import batcher, hotswap
from gordo_tpu_torch.server.server import make_server
from gordo_tpu_torch.server.warmup import warmup_collection
from gordo_tpu_torch.util import disk_registry
from test_torch_feedforward import ff_config
from test_torch_fleet import jax_draws, machine_config

PROJECT = "drift-loop"
NAMES = ("dl-0", "dl-1", "dl-tf")
DRIFTED = ("dl-1", "dl-tf")
TOL_LOSS_REL = 1e-4
TOL_STAT_REL = 1e-4
TOL_OUT = dict(rtol=1e-5, atol=1e-5)  # one model's answer, fused or direct
# a detection time on the 10-minute grid, two days after the training window
DETECTED_AT = datetime(2020, 1, 5, tzinfo=timezone.utc).timestamp()
KNOBS = ("GORDO_TPU_DRIFT_DETECT", "GORDO_TPU_DRIFT_MIN_SAMPLES", "GORDO_TPU_DRIFT_THRESHOLD",
         "GORDO_TPU_DRIFT_COOLDOWN_S", "GORDO_TPU_DRIFT_QUEUE_DIR", "GORDO_TPU_HOT_SWAP",
         "GORDO_TPU_SERVING_BATCH", "GORDO_TPU_DEBUG_ENDPOINTS", "GORDO_TPU_WARM_START",
         "GORDO_TPU_WARMUP_ROWS", "GORDO_TPU_TELEMETRY_DIR")
JSON = {"Content-Type": "application/json"}


def _configs():
    return [ff_config("dl-0"), ff_config("dl-1"), machine_config("dl-tf")]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    for module in (drift, jax_drift):
        module.reset()
    for module in (hotswap, jax_hotswap):
        module.reset_for_tests()
    batcher.reset_batcher()
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(torch_threads)
    batcher.reset_batcher()
    for module in (drift, jax_drift):
        module.reset()
    for module in (hotswap, jax_hotswap):
        module.reset_for_tests()


def _port_artifact(jax_dir: str, port_dir: str) -> None:
    """The port's artifact of a JAX artifact of any family."""
    with open(os.path.join(jax_dir, "model.pkl"), "rb") as f:
        jax_model = pickle.load(f)
    metadata = jax_serializer.load_metadata(jax_dir)
    (_, in_scaler), (_, estimator) = jax_model.base_estimator.steps
    detector = detector_from_arrays(
        spec_from_dataclass(estimator.spec_),
        [{k: np.asarray(v) for k, v in p.items()} for p in estimator.params_],
        in_scaler.min_, in_scaler.scale_, jax_model.scaler.min_, jax_model.scaler.scale_,
        estimator=type(estimator).__name__, kind=estimator.kind,
        estimator_kwargs=estimator.kwargs,
        feature_thresholds=np.asarray(jax_model.feature_thresholds_),
        aggregate_threshold=jax_model.aggregate_threshold_,
        require_thresholds=jax_model.require_thresholds, window=jax_model.window,
        smoothing_method=jax_model.smoothing_method, device="cpu")
    tags = [t["name"] for t in metadata["dataset"]["tags"]]
    serializer.dump(detector, port_dir, tags=tags, metadata=metadata)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """The JAX fleet built and registered in ``jax/rev-initial``, and its
    port copies registered under the port's keys in ``port/rev-initial``."""
    root = tmp_path_factory.mktemp("drift-loop")
    configs = _configs()
    jax_machines = [JaxMachine.from_config(c, PROJECT) for c in configs]
    results = jax_bt.BatchedModelBuilder(
        jax_machines, serial_fallback=False, output_dir=str(root / "jax" / "rev-initial"),
        model_register_dir=str(root / "jax" / "register")).build()
    assert sorted(m.name for _, m in results) == sorted(NAMES)
    machines = [Machine.from_config(c, PROJECT) for c in configs]
    port_register = str(root / "port" / "register")
    for machine in machines:
        target = str(root / "port" / "rev-initial" / machine.name)
        _port_artifact(str(root / "jax" / "rev-initial" / machine.name), target)
        disk_registry.write_key(port_register, ModelBuilder.calculate_cache_key(machine), target)
        disk_registry.write_key(port_register, ModelBuilder.calculate_warm_key(machine), target)
    return {"root": root, "configs": configs, "jax_machines": jax_machines,
            "machines": machines, "register": port_register,
            "jax_register": str(root / "jax" / "register"),
            "collection": str(root / "port" / "rev-initial"),
            "jax_collection": str(root / "jax" / "rev-initial")}


def _losses(results) -> dict:
    return {m.name: model.base_estimator.steps[-1][1].history["loss"] for model, m in results}


def test_warm_start_losses_are_the_jax_warm_start_losses(fleet, monkeypatch):
    request = {"detected_at": DETECTED_AT}
    jax_refreshed = [jax_rebuild._refreshed_machine(m, request) for m in fleet["jax_machines"]]
    refreshed = [drift_rebuild._refreshed_machine(m, request) for m in fleet["machines"]]
    for ours, theirs in zip(refreshed, jax_refreshed):
        assert ModelBuilder.calculate_cache_key(ours) != ModelBuilder.calculate_cache_key(
            fleet["machines"][0])
    jax_warm = jax_catalog.WARM_STARTS.value()
    theirs = _losses(jax_bt.BatchedModelBuilder(
        jax_refreshed, serial_fallback=False, model_register_dir=fleet["jax_register"],
        warm_start=True).build())
    assert jax_catalog.WARM_STARTS.value() - jax_warm == len(NAMES)

    # the JAX program's sample orders, by bucket spec
    jax_specs = {spec_from_dataclass(plan.spec): plan.spec
                 for plan in map(jax_bt._plan_machine, fleet["jax_machines"])}
    monkeypatch.setattr(bt, "draw_inputs", lambda seeds, spec, *rest:
                        jax_draws(jax_specs[spec])(seeds, spec, *rest))
    starts = []
    run_bucket = bt.run_bucket

    def recorded(spec, X, y, stages, epochs, scale_x, inits, orders, device, perms=None):
        starts.append((spec, inits))
        return run_bucket(spec, X, y, stages, epochs, scale_x, inits, orders, device, perms)

    monkeypatch.setattr(bt, "run_bucket", recorded)
    warm = metric_catalog.WARM_STARTS.value()
    builder = bt.BatchedModelBuilder(refreshed, serial_fallback=False,
                                     model_register_dir=fleet["register"], device="cpu")
    ours = _losses(builder.build())
    assert metric_catalog.WARM_STARTS.value() - warm == len(NAMES)
    assert not builder.serial_built and not builder.from_cache
    for name in NAMES:
        np.testing.assert_allclose(ours[name], theirs[name], rtol=TOL_LOSS_REL, err_msg=name)
    # every stage of each bucket started from the registered artifacts' parameters
    assert len(starts) == 2  # the hourglass bucket and the Transformer bucket
    by_name = {m.name: m for m in fleet["machines"]}
    for spec, inits in starts:
        names = [n for n in NAMES if bt._plan_machine(by_name[n]).spec == spec]
        old = [serializer.load(os.path.join(fleet["collection"], n), "cpu")
               .base_estimator.steps[-1][1].module_.params_numpy() for n in names]
        for stage in inits:
            for i, layer in enumerate(stage):
                for key, value in layer.items():
                    np.testing.assert_array_equal(value, np.stack([o[i][key] for o in old]))

    # the same machines cold: every first epoch loses to the warm start's
    monkeypatch.setattr(bt, "run_bucket", run_bucket)
    cold = _losses(bt.BatchedModelBuilder(refreshed, serial_fallback=False,
                                          model_register_dir=fleet["register"], device="cpu",
                                          warm_start=False).build())
    for name in NAMES:
        assert ours[name][0] < cold[name][0], (name, ours[name], cold[name])


def test_a_spec_that_does_not_match_starts_cold_in_both(fleet):
    other = ff_config("dl-0", estimator={"kind": "feedforward_hourglass", "epochs": 2,
                                         "encoding_layers": 1})
    theirs = jax_bt.BatchedModelBuilder([], model_register_dir=fleet["jax_register"])
    ours = bt.BatchedModelBuilder([], model_register_dir=fleet["register"], device="cpu")
    jax_machine, machine = fleet["jax_machines"][0], fleet["machines"][0]
    assert theirs._maybe_warm_params(jax_machine, jax_bt._plan_machine(jax_machine).spec)
    assert ours._maybe_warm_params(machine, bt._plan_machine(machine).spec)
    jax_other = jax_bt._plan_machine(JaxMachine.from_config(other, PROJECT)).spec
    port_other = bt._plan_machine(Machine.from_config(other, PROJECT)).spec
    assert port_other == spec_from_dataclass(jax_other) != bt._plan_machine(machine).spec
    assert theirs._maybe_warm_params(jax_machine, jax_other) is None
    assert ours._maybe_warm_params(machine, port_other) is None
    # no register, or warm starts off: cold too
    assert bt.BatchedModelBuilder([], device="cpu")._maybe_warm_params(
        machine, port_other) is None
    assert bt.BatchedModelBuilder([], model_register_dir=fleet["register"], device="cpu",
                                  warm_start=False)._maybe_warm_params(
        machine, bt._plan_machine(machine).spec) is None


# ---------------------------------------------------------- the served statistic
class _Headers(dict):
    """Case-insensitive ``get``, the interface the port's dispatch reads."""

    def get(self, name, default=None):
        for key, value in self.items():
            if key.lower() == name.lower():
                return value
        return default


def _ours(server, method, path, body=b"", headers=None):
    status, out, data = server.dispatch(method, path, _Headers(headers or {}), body)
    return status, {k.lower(): v for k, v in out}, data


def _body(seed: int, rows: int = 40, scale: float = 1.0) -> bytes:
    values = (np.random.RandomState(seed).rand(rows, 4) * scale).tolist()
    return json.dumps({"X": values, "y": values}).encode()


@pytest.mark.parametrize("route", ["prediction", "anomaly/prediction"])
@pytest.mark.parametrize("name", ["dl-0", "dl-tf"])
def test_a_request_feeds_the_jax_drift_observation(fleet, monkeypatch, route, name):
    monkeypatch.setenv("GORDO_TPU_DRIFT_DETECT", "1")
    monkeypatch.setenv("GORDO_TPU_DRIFT_MIN_SAMPLES", "100")
    jax_server_utils.clear_model_caches()
    app = build_app({"MODEL_COLLECTION_DIR": fleet["jax_collection"]})
    server = make_server("127.0.0.1", 0, device="cpu", collection_dir=fleet["collection"],
                         bind_and_activate=False)
    try:
        path = f"/gordo/v0/{PROJECT}/{name}/{route}"
        for seed in (1, 2):
            body = _body(seed)
            assert _ours(server, "POST", path, body, JSON)[0] == 200
            assert app.test_client().post(path, data=body, headers=JSON).status_code == 200
    finally:
        server.server_close()
    ours, theirs = drift.snapshot()[name], jax_drift.snapshot()[name]
    assert ours["baseline_n"] == theirs["baseline_n"] == 2
    for key in ("baseline_mean", "recent_mean"):
        assert ours[key] == pytest.approx(theirs[key], rel=TOL_STAT_REL), key
    assert ours["baseline_mean"] > 0


@pytest.mark.parametrize("batching", ["0", "1"])
def test_every_lane_feeds_the_detector(fleet, monkeypatch, batching):
    """The default lane, the fast lane's threads and its event loop (and,
    batching on, the batcher's riders) each feed one observation a request,
    the same statistic for the same body."""
    import http.client

    from gordo_tpu_torch.server import fastlane

    monkeypatch.setenv("GORDO_TPU_DRIFT_DETECT", "1")
    monkeypatch.setenv("GORDO_TPU_DRIFT_MIN_SAMPLES", "100")
    monkeypatch.setenv("GORDO_TPU_SERVING_BATCH", batching)
    app = make_server("127.0.0.1", 0, device="cpu", collection_dir=fleet["collection"],
                      bind_and_activate=False)
    fronts = [make_server("127.0.0.1", 0, device="cpu", collection_dir=fleet["collection"]),
              fastlane.FastLaneServer(app, "127.0.0.1", 0, uds=""),
              fastlane.EventLoopServer(app, "127.0.0.1", 0, uds="")]
    threads = [threading.Thread(target=front.serve_forever, daemon=True) for front in fronts]
    for thread in threads:
        thread.start()
    try:
        for n, front in enumerate(fronts, start=1):
            port = getattr(front, "server_port", None) or front.server_address[1]
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("POST", f"/gordo/v0/{PROJECT}/dl-tf/anomaly/prediction",
                         body=_body(5), headers=JSON)
            response = conn.getresponse()
            response.read()
            conn.close()
            assert response.status == 200
            state = drift.snapshot()["dl-tf"]
            assert state["baseline_n"] == n
            assert state["baseline_std"] == 0.0  # the same statistic every time
    finally:
        for front, thread in zip(fronts, threads):
            front.shutdown()
            front.server_close()
            thread.join(10)
        app.server_close()


def test_a_failing_statistic_never_fails_the_request(fleet, monkeypatch):
    from gordo_tpu_torch.server import views

    monkeypatch.setenv("GORDO_TPU_DRIFT_DETECT", "1")
    server = make_server("127.0.0.1", 0, device="cpu", collection_dir=fleet["collection"],
                         bind_and_activate=False)

    def broken(*args):
        raise RuntimeError("statistic failed")

    monkeypatch.setattr(views, "_anomaly_total_stat", broken)
    monkeypatch.setattr(views, "_base_reconstruction_stat", broken)
    try:
        for route in ("prediction", "anomaly/prediction"):
            assert _ours(server, "POST", f"/gordo/v0/{PROJECT}/dl-0/{route}", _body(1),
                         JSON)[0] == 200
    finally:
        server.server_close()
    assert drift.snapshot() == {}
    # with the gate closed nothing is computed at all
    monkeypatch.delenv("GORDO_TPU_DRIFT_DETECT")
    monkeypatch.setattr(views, "_anomaly_total_stat",
                        lambda *a: pytest.fail("computed with the gate closed"))
    server = make_server("127.0.0.1", 0, device="cpu", collection_dir=fleet["collection"],
                         bind_and_activate=False)
    try:
        assert _ours(server, "POST", f"/gordo/v0/{PROJECT}/dl-0/anomaly/prediction", _body(1),
                     JSON)[0] == 200
    finally:
        server.server_close()


def test_debug_drift_answers_the_jax_body(fleet, monkeypatch, tmp_path):
    queue = str(tmp_path / "queue")
    for knob, value in (("GORDO_TPU_DRIFT_DETECT", "1"), ("GORDO_TPU_DRIFT_MIN_SAMPLES", "2"),
                        ("GORDO_TPU_DEBUG_ENDPOINTS", "1"), ("GORDO_TPU_DRIFT_QUEUE_DIR", queue)):
        monkeypatch.setenv(knob, value)
    jax_server_utils.clear_model_caches()
    app = build_app({"MODEL_COLLECTION_DIR": fleet["jax_collection"]})
    server = make_server("127.0.0.1", 0, device="cpu", collection_dir=fleet["collection"],
                         bind_and_activate=False)
    path = f"/gordo/v0/{PROJECT}/dl-0/anomaly/prediction"
    try:
        for seed, scale in ((1, 1.0), (2, 1.1), (3, 0.9), (4, 40.0)):
            body = _body(seed, scale=scale)
            assert _ours(server, "POST", path, body, JSON)[0] == 200
            assert app.test_client().post(path, data=body, headers=JSON).status_code == 200
        status, headers, data = _ours(server, "GET", "/debug/drift")
    finally:
        server.server_close()
    response = app.test_client().get("/debug/drift")
    assert status == response.status_code == 200
    assert headers["content-type"] == response.headers["Content-Type"]
    ours, theirs = json.loads(data), response.get_json()
    assert sorted(ours) == sorted(theirs) == ["drifted", "enabled", "local", "queue"]
    assert ours["drifted"] == theirs["drifted"] == ["dl-0"]
    assert ours["enabled"] is theirs["enabled"] is True
    assert sorted(ours["local"]["dl-0"]) == sorted(theirs["local"]["dl-0"])
    assert sorted(ours["queue"]) == sorted(theirs["queue"])
    assert ours["queue"]["depth"] == 1 and ours["queue"]["pending"] == ["dl-0"]
    monkeypatch.delenv("GORDO_TPU_DEBUG_ENDPOINTS")
    server = make_server("127.0.0.1", 0, device="cpu", collection_dir=fleet["collection"],
                         bind_and_activate=False)
    try:
        assert _ours(server, "GET", "/debug/drift")[0] == 404
    finally:
        server.server_close()


# ------------------------------------------------------------------ the loop
class _Load:
    """Threaded anomaly traffic through the port's route table: every
    machine in turn, each machine's three payload variants (input scale 0.9,
    1.0, 1.1) in strict rotation, each machine's sequence of revisions."""

    def __init__(self, server, names):
        self.server = server
        self.names = names
        rng = np.random.RandomState(13)
        self.variants = {}
        for name in names:
            base = rng.rand(40, 4)
            self.variants[name] = [(base * s).tolist() for s in (0.9, 1.0, 1.1)]
        self.counts = {name: 0 for name in names}
        self.revisions = {name: [] for name in names}
        self.status_5xx = 0
        self.requests = 0
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.threads = []

    def post(self, name, values, query=""):
        body = json.dumps({"X": values, "y": values}).encode()
        return _ours(self.server, "POST",
                     f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction{query}", body, JSON)

    def _run(self, tid):
        i = 0
        while not self.stop.is_set():
            name = self.names[(tid + i) % len(self.names)]
            i += 1
            with self.lock:
                values = self.variants[name][self.counts[name] % 3]
                self.counts[name] += 1
            status, headers, _ = self.post(name, values)
            with self.lock:
                self.requests += 1
                self.status_5xx += status >= 500
                seen = self.revisions[name]
                if headers.get("revision") and (not seen or seen[-1] != headers["revision"]):
                    seen.append(headers["revision"])

    def start(self, n=3):
        for tid in range(n):
            thread = threading.Thread(target=self._run, args=(tid,), daemon=True)
            thread.start()
            self.threads.append(thread)

    def halt(self):
        self.stop.set()
        for thread in self.threads:
            thread.join(timeout=60)


def _wait(predicate, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    pytest.fail(f"timed out after {timeout_s}s waiting for {what}")


def _banks():
    fused = batcher.peek_batcher()
    return {key: (bank.capacity, bank.restacks) for key, bank in fused._banks.items()}


def _output(data: bytes) -> np.ndarray:
    block = json.loads(data)["data"]["model-output"]
    return np.array([list(column.values()) for column in block.values()]).T


def test_self_healing_drift_loop(fleet, monkeypatch, tmp_path):
    # a copy of the revision tree: the rebuild writes beside the collection
    root = tmp_path / "tree"
    shutil.copytree(fleet["root"] / "port", root)
    collection, register = str(root / "rev-initial"), str(root / "register")
    for key in os.listdir(register):
        target = disk_registry.get_value(register, key)
        disk_registry.write_key(register, key, target.replace(str(fleet["root"] / "port"),
                                                              str(root)))
    queue = str(tmp_path / "queue")
    for knob, value in (("GORDO_TPU_DRIFT_DETECT", "1"), ("GORDO_TPU_DRIFT_MIN_SAMPLES", "6"),
                        ("GORDO_TPU_DRIFT_THRESHOLD", "4.0"),
                        ("GORDO_TPU_DRIFT_COOLDOWN_S", "3600"),
                        ("GORDO_TPU_DRIFT_QUEUE_DIR", queue), ("GORDO_TPU_SERVING_BATCH", "1"),
                        ("GORDO_TPU_WARMUP_ROWS", "32")):
        monkeypatch.setenv(knob, value)
    server = make_server("127.0.0.1", 0, device="cpu", collection_dir=collection,
                         bind_and_activate=False)
    report = warmup_collection(collection, loader=lambda n: server.model_entry(server.revision,
                                                                               n))
    assert report["failed"] == [] and report["registered_params"] == len(NAMES)
    load = _Load(server, list(NAMES))
    load.start(n=3)
    try:
        # detect: live traffic freezes every machine's baseline
        _wait(lambda: all(drift.snapshot().get(n, {}).get("status") == "ok" for n in NAMES),
              120, "every baseline to freeze")
        # 15x out-of-range inputs on exactly two machines, on the same path
        for name in DRIFTED:
            drifted = (np.asarray(load.variants[name][1]) * 15.0).tolist()
            for _attempt in range(100):
                assert load.post(name, drifted)[0] < 500
                if drift.snapshot()[name]["status"] == "drifted":
                    break
            else:
                pytest.fail(f"{name} never detected as drifted")
        assert sorted(r["machine"] for r in drift_queue.pending(queue)) == sorted(DRIFTED)
        # hysteresis: the same episode enqueues nothing more
        events = {n: drift.snapshot()[n]["events"] for n in DRIFTED}
        for name in DRIFTED:
            drifted = (np.asarray(load.variants[name][1]) * 15.0).tolist()
            for _ in range(5):
                load.post(name, drifted)
        assert drift_queue.depth(queue) == len(DRIFTED)
        assert {n: drift.snapshot()[n]["events"] for n in DRIFTED} == events == {
            n: 1 for n in DRIFTED}

        # rebuild: a warm-start delta revision of exactly the drifted machines
        warm = metric_catalog.WARM_STARTS.value()
        rebuilds = {n: metric_catalog.DRIFT_REBUILDS.value(model=n) for n in NAMES}
        built = drift_rebuild.drain_drift_queue(fleet["machines"], queue, str(root),
                                                model_register_dir=register, device="cpu")
        assert sorted(built["built"]) == sorted(DRIFTED) and built["failed"] == []
        assert built["revision"] is not None
        assert metric_catalog.WARM_STARTS.value() - warm == len(DRIFTED)
        for name in NAMES:
            assert metric_catalog.DRIFT_REBUILDS.value(model=name) - rebuilds[name] == (
                name in DRIFTED)
        assert drift_queue.depth(queue) == 0

        # swap under load: the bank keeps its capacity and restacks
        banks = _banks()
        swaps = {n: metric_catalog.HOT_SWAPS.value(model=n) for n in NAMES}
        swapped = hotswap.poll_once(collection, server)
        assert sorted(swapped) == sorted(DRIFTED)
        for name in DRIFTED:
            assert metric_catalog.HOT_SWAPS.value(model=name) - swaps[name] == 1
            assert hotswap.active(name) == (os.path.join(str(root), built["revision"]),
                                            built["revision"])
        assert [s["machine"] for s in hotswap.swaps()] == swapped
        assert all(s["swapped"] for s in hotswap.swaps())
        floor = load.requests + 3 * len(NAMES)
        _wait(lambda: load.requests >= floor, 120, "traffic after the swap on every machine")
        assert _banks() == banks

        # the swapped machines answer with the new artifact, a pinned
        # revision with the old one
        for name in DRIFTED:
            values = load.variants[name][1]
            status, headers, data = load.post(name, values)
            assert status == 200 and headers["revision"] == built["revision"]
            new = serializer.load(os.path.join(str(root), built["revision"], name), "cpu")
            old = serializer.load(os.path.join(collection, name), "cpu")
            X = np.asarray(values, np.float32)
            np.testing.assert_allclose(_output(data), new.base_estimator.predict(X), **TOL_OUT)
            status, headers, data = load.post(name, values, "?revision=rev-initial")
            assert status == 200 and headers["revision"] == "rev-initial"
            np.testing.assert_allclose(_output(data), old.base_estimator.predict(X), **TOL_OUT)

        # recalibrate: the rebuilt models settle at their new normal
        _wait(lambda: all(drift.snapshot().get(n, {}).get("status") == "ok"
                          and drift.snapshot()[n]["events"] == 0 for n in DRIFTED),
              120, "the rebuilt models to recalibrate")
    finally:
        load.halt()
        server.server_close()

    assert load.status_5xx == 0, f"{load.status_5xx} 5xx of {load.requests} requests"
    for name in NAMES:
        seen = load.revisions[name]
        assert seen == (["rev-initial", built["revision"]] if name in DRIFTED
                        else ["rev-initial"]), (name, seen)
    rev_dir = os.path.join(str(root), built["revision"])
    assert sorted(n for n in os.listdir(rev_dir)
                  if os.path.isdir(os.path.join(rev_dir, n))) == sorted(DRIFTED)
    with open(os.path.join(rev_dir, hotswap.COMPLETE_MARKER)) as fh:
        marker = json.load(fh)
    assert marker["machines"] == sorted(DRIFTED) and marker["revision"] == built["revision"]
    # each refreshed window ends at its detection time and keeps its length
    for name in DRIFTED:
        with open(os.path.join(queue, "done", f"{name}.g1.json")) as fh:
            done = json.load(fh)
        assert done["revision"] == built["revision"]
        dataset = serializer.load_metadata(os.path.join(rev_dir, name))["dataset"]
        start, end = (datetime.fromisoformat(str(dataset[k]))
                      for k in ("train_start_date", "train_end_date"))
        assert (end - start).days == 2
        assert end.timestamp() == pytest.approx(done["detected_at"], abs=1e-6)


POOL = """
import logging, os, sys
logging.basicConfig(level=logging.INFO)
arbiter = os.getpid()
from gordo_tpu_torch.server import hotswap
start = hotswap.start_watcher
def guarded(*args, **kwargs):
    if os.getpid() == arbiter:
        sys.stderr.write("ARBITER STARTED A WATCHER\\n")
        sys.stderr.flush()
        os._exit(99)
    return start(*args, **kwargs)
hotswap.start_watcher = guarded
from gordo_tpu_torch.server.server import run_server
run_server("127.0.0.1", {port}, "cpu", None, None, 2, 50, False)
"""


def test_each_pool_worker_swaps_and_the_arbiter_starts_no_watcher(fleet, tmp_path):
    """``run-server --workers 2`` with the hot swap on over a tree with one
    committed delta revision: each worker starts its own watcher after the
    fork and swaps, so the hot-swap sum over the shards is exactly 2, and
    both workers answer with the delta revision."""
    import signal
    import socket
    import subprocess
    import sys
    import urllib.request

    tree = tmp_path / "tree"
    shutil.copytree(fleet["collection"], tree / "rev-initial")
    revision = drift_rebuild.revision_name(1_700_000_000.0)
    shutil.copytree(os.path.join(fleet["collection"], "dl-0"), tree / revision / "dl-0")
    (tree / revision / hotswap.COMPLETE_MARKER).write_text(
        json.dumps({"revision": revision, "machines": ["dl-0"]}))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("GORDO_TPU_")}
    env.update(PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
               MODEL_COLLECTION_DIR=str(tree / "rev-initial"), GORDO_TPU_HOT_SWAP="1",
               GORDO_TPU_HOT_SWAP_POLL_S="0.2", GORDO_TPU_TELEMETRY_DIR=str(tmp_path / "shards"))
    log = tmp_path / "pool.log"
    with open(log, "w") as fh:
        proc = subprocess.Popen([sys.executable, "-c", POOL.format(port=port)], env=env,
                                stdout=subprocess.DEVNULL, stderr=fh, start_new_session=True)
    base = f"http://127.0.0.1:{port}"
    seen = {}

    def both_swapped():
        try:
            request = urllib.request.Request(
                f"{base}/gordo/v0/{PROJECT}/dl-0/anomaly/prediction", data=_body(3), headers=JSON)
            with urllib.request.urlopen(request, timeout=30) as resp:
                seen[json.loads(resp.read())["revision"]] = True
            time.sleep(0.3)  # a worker's trailing shard flush
            with urllib.request.urlopen(f"{base}/metrics", timeout=30) as resp:
                text = resp.read().decode()
        except OSError:
            return False
        total = sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                    if line.startswith('gordo_server_hot_swaps_total{model="dl-0"'))
        return total == 2.0
    try:
        _wait(both_swapped, 120, "both workers to swap")
        assert list(seen)[-1] == revision
        os.kill(proc.pid, signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    text = log.read_text()
    assert "ARBITER STARTED A WATCHER" not in text
    assert text.count("hot-swap watcher started") == 2


def test_prewarm_accepts_explicit_revision(fleet, monkeypatch):
    monkeypatch.setenv("GORDO_TPU_DEBUG_ENDPOINTS", "1")
    monkeypatch.setenv("GORDO_TPU_SERVING_BATCH", "1")
    monkeypatch.setenv("GORDO_TPU_WARMUP_ROWS", "32")
    server = make_server("127.0.0.1", 0, device="cpu", collection_dir=fleet["collection"],
                         bind_and_activate=False)
    try:
        status, _, data = _ours(server, "POST", "/debug/prewarm?machine=dl-0&revision=rev-initial")
        assert status == 200
        body = json.loads(data)
        assert body["revision"] == "rev-initial" and body["failed"] == []
        assert _ours(server, "POST", "/debug/prewarm?machine=dl-0&revision=no-such-rev")[0] == 410
        assert _ours(server, "POST", "/debug/prewarm?machine=dl-0&revision=..%2Fescape")[0] == 410
    finally:
        server.server_close()


# ------------------------------------------------------------------- the CLI
def test_the_cli_drains_the_queue_into_delta_revisions(tmp_path, capsys):
    configs = [ff_config(f"cli-{i}") for i in range(2)]
    config = tmp_path / "fleet.json"
    config.write_text(json.dumps({"machines": configs}))
    root, register, queue = tmp_path / "tree", str(tmp_path / "register"), str(tmp_path / "q")
    common = ["--device", "cpu", "--project-name", PROJECT]
    assert cli.main(["batch-build", str(config), str(root / "rev-initial"),
                     "--model-register-dir", register, *common]) == 0
    warm = metric_catalog.WARM_STARTS.value()

    assert drift_queue.enqueue(queue, "cli-0", {"detected_at": DETECTED_AT})
    assert cli.main(["batch-build", str(config), str(root), "--drain-drift-queue",
                     "--drift-queue-dir", queue, "--model-register-dir", register,
                     *common]) == 0
    first = sorted(n for n in os.listdir(root) if n.startswith("drift-"))
    assert len(first) == 1
    assert f"drift-rebuilt: cli-0 -> {root / first[0] / 'cli-0'}" in capsys.readouterr().out
    assert metric_catalog.WARM_STARTS.value() - warm == 1

    metrics = tmp_path / "drift.prom"
    assert drift_queue.enqueue(queue, "cli-1", {"detected_at": DETECTED_AT + 600})
    assert cli.main(["drift-rebuilder", str(config), "--queue-dir", queue, "--output-dir",
                     str(root), "--model-register-dir", register, "--once",
                     "--metrics-file", str(metrics), *common]) == 0
    revisions = sorted(n for n in os.listdir(root) if n.startswith("drift-"))
    assert len(revisions) == 2 and revisions[0] == first[0]
    assert "drift drain: built=['cli-1']" in capsys.readouterr().out
    assert 'gordo_build_drift_rebuilds_total{model="cli-1"} 1' in metrics.read_text()
    for revision, name in zip(revisions, ("cli-0", "cli-1")):
        with open(root / revision / hotswap.COMPLETE_MARKER) as fh:
            assert json.load(fh)["machines"] == [name]
        assert sorted(os.listdir(root / revision)) == sorted([name, hotswap.COMPLETE_MARKER])
    assert drift_queue.depth(queue) == 0
    # nothing queued: one pass, nothing built
    assert cli.main(["drift-rebuilder", str(config), "--queue-dir", queue, "--output-dir",
                     str(root), "--once", *common]) == 0
    assert len([n for n in os.listdir(root) if n.startswith("drift-")]) == 2
