"""
The drift loop's pieces in the port (``gordo_tpu_torch/observability/drift.py``,
``parallel/drift_queue.py``, ``server/hotswap.py``, ``builder/drift_rebuild.py``,
the warm key of ``builder/build_model.py`` and the server's eviction) against
the JAX package's, after the cases of ``tests/gordo_tpu/test_drift.py``:

- the detector: one seeded numpy stream through both packages' ``observe``
  gives the same ``snapshot()`` (baseline mean and std, CUSUM level, status,
  events, the recent window) within 1e-12, and the same events at the same
  observations, in each scenario (a shift, the cooldown and its re-arm,
  ``note_rebuilt``, non-finite values, window expiry, the cardinality
  overflow); the shard payloads are equal and ``merge_payloads`` of two
  shards equals the single stream's in both packages; then a port of each
  detector, merge, shard and queue test of the JAX file;
- the queue: requests the port enqueues are pending, claimed and completed
  by the JAX package and the other way round, the files byte-identical;
- the hot swap's scan: ``_delta_revisions``, the order of ``poll_once`` and
  the lexical fence on one tree of revisions, against the JAX module;
- warm keys (equal in both packages for 3 machines) and the refreshed data
  windows (the same dates).
"""

import json
import math
import os
import threading

import numpy as np
import pytest

from gordo_tpu.builder import drift_rebuild as jax_rebuild
from gordo_tpu.builder.build_model import ModelBuilder as JaxModelBuilder
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.observability import drift as jax_drift
from gordo_tpu.parallel import drift_queue as jax_queue
from gordo_tpu.server import hotswap as jax_hotswap
from gordo_tpu.util import faults as jax_faults
from gordo_tpu_torch.builder import drift_rebuild
from gordo_tpu_torch.builder.build_model import ModelBuilder
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.observability import drift, shared, slo, telemetry
from gordo_tpu_torch.parallel import drift_queue
from gordo_tpu_torch.server import hotswap
from gordo_tpu_torch.util import faults

TOL_SNAPSHOT = 1e-12
KNOBS = ("GORDO_TPU_DRIFT_DETECT", "GORDO_TPU_DRIFT_MIN_SAMPLES", "GORDO_TPU_DRIFT_THRESHOLD",
         "GORDO_TPU_DRIFT_WINDOW_S", "GORDO_TPU_DRIFT_COOLDOWN_S", "GORDO_TPU_DRIFT_QUEUE_DIR",
         "GORDO_TPU_HOT_SWAP", faults.PLAN_ENV)


@pytest.fixture(autouse=True)
def _detector_on(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("GORDO_TPU_DRIFT_DETECT", "1")
    monkeypatch.setenv("GORDO_TPU_DRIFT_MIN_SAMPLES", "5")
    monkeypatch.setenv("GORDO_TPU_DRIFT_THRESHOLD", "4.0")
    for module in (faults, jax_faults):
        module.reset_plan()
    for module in (drift, jax_drift):
        module.reset()
    for module in (hotswap, jax_hotswap):
        module.reset_for_tests()
    yield
    for module in (drift, jax_drift):
        module.reset()
    for module in (hotswap, jax_hotswap):
        module.reset_for_tests()
    for module in (faults, jax_faults):
        module.reset_plan()


def _seed_baseline(module, model, n=5, value=1.0, t0=1_000_000.0):
    """Alternating values around ``value`` so that the frozen baseline has
    a standard deviation above 0."""
    for i in range(n):
        module.observe(model, value + (0.1 if i % 2 else -0.1), now=t0 + i)
    return t0 + n


# ------------------------------------------------- the detector, both packages
def _stream(seed, n):
    """``n`` (value, time) pairs: noise around 1, times 1 to 60 s apart."""
    rng = np.random.RandomState(seed)
    values = 1.0 + 0.1 * rng.randn(n)
    times = 1_000_000.0 + np.cumsum(rng.uniform(1.0, 60.0, n))
    return [float(v) for v in values], [float(t) for t in times]


def _shift(module):
    values, times = _stream(0, 60)
    values[30:] = [v * 40.0 for v in values[30:]]
    fired = [module.observe("m", v, now=t) for v, t in zip(values, times)]
    return fired


def _cooldown(module):
    os.environ["GORDO_TPU_DRIFT_COOLDOWN_S"] = "300"
    values, times = _stream(1, 80)
    values[10:] = [v * 30.0 + 0.5 * math.sin(i) for i, v in enumerate(values[10:])]
    return [module.observe("m", v, now=t) for v, t in zip(values, times)]


def _rebuilt(module):
    values, times = _stream(2, 60)
    values[20:] = [v * 40.0 for v in values[20:]]
    fired = []
    for i, (v, t) in enumerate(zip(values, times)):
        if i == 30:
            module.note_rebuilt("m")
        fired.append(module.observe("m", v, now=t))
    return fired


def _non_finite(module):
    values, times = _stream(3, 30)
    values[4], values[9], values[20] = float("nan"), float("inf"), float("-inf")
    return [module.observe("m", v, now=t) for v, t in zip(values, times)]


def _expiry(module):
    os.environ["GORDO_TPU_DRIFT_WINDOW_S"] = "600"
    values, times = _stream(4, 40)
    times = [t + 200.0 * i for i, t in enumerate(times)]
    return [module.observe(f"m{i % 3}", v, now=t) for i, (v, t) in
            enumerate(zip(values, times))]


def _overflow(module):
    fired = [module.observe(f"m-{i}", 1.0 + 0.01 * i, now=float(i))
             for i in range(drift._MAX_MODELS + 3)]
    fired.append(module.observe("one-too-many", 2.0, now=5000.0))
    return fired


SCENARIOS = {"shift": _shift, "cooldown": _cooldown, "note_rebuilt": _rebuilt,
             "non_finite": _non_finite, "window_expiry": _expiry, "overflow": _overflow}


def _assert_same_snapshot(ours: dict, theirs: dict) -> None:
    assert sorted(ours) == sorted(theirs)
    for name, state in theirs.items():
        assert sorted(ours[name]) == sorted(state), name
        for key, value in state.items():
            if isinstance(value, float):
                assert abs(ours[name][key] - value) <= TOL_SNAPSHOT * max(1.0, abs(value)), (
                    name, key, ours[name][key], value)
            else:
                assert ours[name][key] == value, (name, key)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_one_stream_gives_the_jax_snapshot(scenario, monkeypatch):
    # the scenarios may set knobs: the fixture's monkeypatch restores them
    monkeypatch.setenv("GORDO_TPU_DRIFT_COOLDOWN_S", "1800")
    monkeypatch.setenv("GORDO_TPU_DRIFT_WINDOW_S", "3600")
    theirs = SCENARIOS[scenario](jax_drift)
    ours = SCENARIOS[scenario](drift)
    assert ours == theirs
    if scenario in ("shift", "cooldown", "note_rebuilt"):
        assert any(ours)
    _assert_same_snapshot(drift.snapshot(), jax_drift.snapshot())
    assert drift.drifted_models() == jax_drift.drifted_models()
    assert json.dumps(drift.shard_payload(), sort_keys=True) == json.dumps(
        jax_drift.shard_payload(), sort_keys=True)


def test_merge_of_two_shards_is_the_jax_merge_and_the_single_stream(monkeypatch):
    monkeypatch.setenv("GORDO_TPU_DRIFT_MIN_SAMPLES", "100")
    values, times = _stream(5, 40)
    shards = []
    for part in (slice(0, 17), slice(17, 40)):
        drift.reset()
        for v, t in zip(values[part], times[part]):
            drift.observe("m", v, now=t)
        shards.append(drift.shard_payload())
    drift.reset()
    for v, t in zip(values, times):
        drift.observe("m", v, now=t)
    single = drift.shard_payload()["m"]
    pairs = [(1, shards[0]), (2, shards[1])]
    ours, theirs = drift.merge_payloads(pairs), jax_drift.merge_payloads(pairs)
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    merged = ours["m"]
    assert merged["baseline"][0] == single["baseline"][0] == 40
    assert merged["baseline"][1] == pytest.approx(single["baseline"][1], rel=1e-12)
    assert merged["baseline"][2] == pytest.approx(single["baseline"][2], rel=1e-9)
    assert merged["recent_count"] == 40
    assert merged["recent_mean"] == pytest.approx(sum(values) / 40, rel=1e-12)


def test_an_event_enqueues_the_jax_request(tmp_path, monkeypatch):
    t_ours = t_theirs = None
    for module, queue in ((drift, tmp_path / "ours"), (jax_drift, tmp_path / "theirs")):
        monkeypatch.setenv("GORDO_TPU_DRIFT_QUEUE_DIR", str(queue))
        t = _seed_baseline(module, "m")
        while not module.observe("m", 50.0, now=t):
            t += 1
        t_ours, t_theirs = (t, t_theirs) if module is drift else (t_ours, t)
    ours = drift_queue.pending(str(tmp_path / "ours"))
    theirs = jax_queue.pending(str(tmp_path / "theirs"))
    assert t_ours == t_theirs
    for body in ours + theirs:
        body.pop("enqueued_at"), body.pop("host")
    assert ours == theirs and ours[0]["detected_at"] == t_ours


# ------------------------------------------- the JAX file's tests, on the port
def test_gate_closed_records_nothing(monkeypatch):
    monkeypatch.delenv("GORDO_TPU_DRIFT_DETECT")
    assert not drift.observe("m", 1.0)
    assert drift.snapshot() == {}


def test_baseline_freezes_then_cusum_fires_once():
    t = _seed_baseline(drift, "m")
    state = drift.snapshot()["m"]
    assert state["status"] == "ok"
    assert state["baseline_n"] == 5
    assert state["baseline_std"] > 0
    fired = [i for i in range(10) if drift.observe("m", 50.0, now=t + i)]
    assert fired == [0]
    snap = drift.snapshot()["m"]
    assert snap["status"] == "drifted"
    assert snap["events"] == 1


def test_normal_traffic_never_fires():
    t = _seed_baseline(drift, "m")
    for i in range(500):
        assert not drift.observe("m", 1.0 + (0.1 if i % 2 else -0.1), now=t + i)
    assert drift.snapshot()["m"]["status"] == "ok"


def test_hysteresis_cooldown_then_rearm(monkeypatch):
    monkeypatch.setenv("GORDO_TPU_DRIFT_COOLDOWN_S", "100")
    t = _seed_baseline(drift, "m")
    while not drift.observe("m", 50.0, now=t):
        t += 1
    assert drift.snapshot()["m"]["events"] == 1
    for i in range(20):
        assert not drift.observe("m", 50.0, now=t + i)
    assert drift.snapshot()["m"]["events"] == 1
    # past the cooldown the alarm re-arms and the persisting shift fires again
    assert any(drift.observe("m", 50.0, now=t + 200 + i) for i in range(10))
    assert drift.snapshot()["m"]["events"] == 2


def test_note_rebuilt_recalibrates():
    t = _seed_baseline(drift, "m", value=1.0)
    while not drift.observe("m", 50.0, now=t):
        t += 1
    drift.note_rebuilt("m")
    snap = drift.snapshot()["m"]
    assert snap["status"] == "baseline" and snap["baseline_n"] == 0
    t = _seed_baseline(drift, "m", value=10.0, t0=t + 10)
    for i in range(50):
        assert not drift.observe("m", 10.0 + (0.1 if i % 2 else -0.1), now=t + i)
    snap = drift.snapshot()["m"]
    assert snap["status"] == "ok"
    assert abs(snap["baseline_mean"] - 10.0) < 0.2


def test_non_finite_values_ignored():
    assert not drift.observe("m", float("nan"))
    assert not drift.observe("m", float("inf"))
    assert drift.snapshot() == {}


def test_rolling_windows_expire(monkeypatch):
    monkeypatch.setenv("GORDO_TPU_DRIFT_WINDOW_S", "600")  # 2 sub-windows
    drift.observe("m", 1.0, now=0.0)
    drift.observe("m", 1.0, now=1.0)
    assert drift.snapshot()["m"]["recent_count"] == 2
    drift.observe("m", 2.0, now=3 * drift._SUBWINDOW_S + 1.0)
    snap = drift.snapshot()["m"]
    assert snap["recent_count"] == 1 and snap["recent_mean"] == 2.0


def test_event_emission_enqueues_once(tmp_path, monkeypatch):
    queue = str(tmp_path / "q")
    monkeypatch.setenv("GORDO_TPU_DRIFT_QUEUE_DIR", queue)
    before = drift.metric_catalog.DRIFT_EVENTS.value(model="m")
    t = _seed_baseline(drift, "m")
    while not drift.observe("m", 50.0, now=t):
        t += 1
    pending = drift_queue.pending(queue)
    assert [r["machine"] for r in pending] == ["m"]
    assert pending[0]["baseline_mean"] == pytest.approx(1.0, abs=0.1)
    assert pending[0]["detected_at"] == t
    assert drift.metric_catalog.DRIFT_EVENTS.value(model="m") == before + 1


@pytest.mark.parametrize("site", ["drift_enqueue", "drift_detect"])
def test_an_injected_fault_never_fails_the_observation(tmp_path, monkeypatch, site):
    queue = str(tmp_path / "q")
    monkeypatch.setenv("GORDO_TPU_DRIFT_QUEUE_DIR", queue)
    monkeypatch.setenv(faults.PLAN_ENV, json.dumps({"rules": [
        {"site": site, "machine": "m", "times": -1, "error": "permanent"}]}))
    faults.reset_plan()
    t = _seed_baseline(drift, "m")
    assert any(drift.observe("m", 50.0, now=t + i) for i in range(10))  # must not raise
    assert drift_queue.depth(queue) == 0  # the enqueue itself was eaten
    assert drift.snapshot()["m"]["status"] == "drifted"


def test_cardinality_overflow_collapses():
    for i in range(drift._MAX_MODELS):
        drift.observe(f"m-{i}", 1.0, now=0.0)
    drift.observe("one-too-many", 1.0, now=0.0)
    snap = drift.snapshot()
    assert "one-too-many" not in snap
    assert drift._OVERFLOW in snap


def test_merge_payloads_matches_single_stream(monkeypatch):
    monkeypatch.setenv("GORDO_TPU_DRIFT_MIN_SAMPLES", "100")
    values = [1.0, 1.2, 0.8, 1.1, 0.9, 1.05, 0.95, 1.15]
    for v in values[:4]:
        drift.observe("m", v, now=100.0)
    shard_a = drift.shard_payload()
    drift.reset()
    for v in values[4:]:
        drift.observe("m", v, now=100.0)
    shard_b = drift.shard_payload()
    drift.reset()
    for v in values:
        drift.observe("m", v, now=100.0)
    reference = drift.shard_payload()["m"]["baseline"]
    merged = drift.merge_payloads([(1, shard_a), (2, shard_b)])["m"]
    assert merged["baseline"][0] == reference[0]
    assert merged["baseline"][1] == pytest.approx(reference[1])
    assert merged["baseline"][2] == pytest.approx(reference[2])
    assert merged["recent_count"] == len(values)
    assert merged["recent_mean"] == pytest.approx(sum(values) / len(values))


def test_merge_counts_drifted_workers():
    t = _seed_baseline(drift, "m")
    while not drift.observe("m", 50.0, now=t):
        t += 1
    merged = drift.merge_payloads([(1, drift.shard_payload()), (2, {"m": {
        "windows": {}, "baseline": [0, 0.0, 0.0], "events": 0, "status": "ok"}})])
    assert merged["m"]["drifted_workers"] == 1
    assert merged["m"]["events"] == 1


def _write_fake_shard(pid: int, extras: dict) -> None:
    payload = json.dumps({"schema": shared.PAYLOAD_SCHEMA, "pid": pid, "metrics": [],
                          "extras": extras}).encode()
    writer = shared._ShardWriter(shared.shard_path(pid))
    writer.write(payload)
    writer.close()


def test_shard_death_drops_rows_without_zero_or_double_count(tmp_path, monkeypatch):
    """Reaping a worker removes exactly its contribution from the merged
    drift and SLO windows: the survivor's are neither zeroed nor counted
    twice."""
    monkeypatch.setenv(shared.ENV_DIR, str(tmp_path))
    shared.reset_for_tests()
    slo.reset()
    try:
        for v in (2.0, 2.0):
            drift.observe("m", v, now=100.0)
        slo.record("m", 0.01, 200)
        dead_extras = {"drift": drift.shard_payload(), "slo": slo.shard_payload()}
        drift.reset()
        slo.reset()
        shared.register_extra("drift", drift.shard_payload)
        shared.register_extra("slo", slo.shard_payload)
        for v in (1.0, 1.0, 1.0):
            drift.observe("m", v, now=100.0)
        slo.record("m", 0.01, 200)
        slo.record("m", 0.02, 200)
        assert shared.flush(force=True, registry=telemetry.MetricsRegistry())
        dead_pid = os.getpid() + 7
        _write_fake_shard(dead_pid, dead_extras)
        both = drift.merge_payloads(shared.fleet_extras("drift"))
        assert both["m"]["recent_count"] == 5 and both["m"]["baseline"][0] == 5
        shared.mark_shard_dead(dead_pid)
        after = drift.merge_payloads(shared.fleet_extras("drift"))
        assert after["m"]["recent_count"] == 3 and after["m"]["baseline"][0] == 3
        assert after["m"]["recent_mean"] == pytest.approx(1.0)
        assert slo.merge_payloads(shared.fleet_extras("slo"))["models"]["m"]["5m"][
            "requests"] == 2
    finally:
        shared.reset_for_tests()
        slo.reset()


def test_refresh_gauges_read_the_detector_and_the_queue(tmp_path, monkeypatch):
    queue = str(tmp_path / "q")
    monkeypatch.setenv("GORDO_TPU_DRIFT_QUEUE_DIR", queue)
    t = _seed_baseline(drift, "m")
    while not drift.observe("m", 50.0, now=t):
        t += 1
    drift_queue.enqueue(queue, "other", {})
    drift.refresh_gauges()
    assert drift.metric_catalog.DRIFTED_MODELS.value() == 1
    assert drift.metric_catalog.DRIFT_QUEUE_DEPTH.value() == 2


# ------------------------------------------------------------------ the queue
def test_enqueue_is_exclusive_across_racers(tmp_path):
    queue = str(tmp_path / "q")
    wins = []
    barrier = threading.Barrier(8)

    def racer(i):
        barrier.wait()
        if drift_queue.enqueue(queue, "m", {"detected_at": float(i)}):
            wins.append(i)

    threads = [threading.Thread(target=racer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(wins) == 1
    assert drift_queue.depth(queue) == 1


def test_claim_is_exclusive_across_racers(tmp_path):
    queue = str(tmp_path / "q")
    assert drift_queue.enqueue(queue, "m", {})
    claims = []
    barrier = threading.Barrier(8)

    def racer(i):
        barrier.wait()
        handle = drift_queue.claim(queue, "m", host_id=f"h{i}")
        if handle is not None:
            claims.append(handle)

    threads = [threading.Thread(target=racer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(claims) == 1 and claims[0].generation == 1


def test_claim_is_exclusive_and_steals_stale(tmp_path):
    queue = str(tmp_path / "q")
    assert drift_queue.enqueue(queue, "m", {})
    first = drift_queue.claim(queue, "m", host_id="a")
    assert first is not None and first.generation == 1
    assert drift_queue.claim(queue, "m", host_id="b") is None
    stolen = drift_queue.claim(queue, "m", host_id="b", timeout_s=0.0)
    assert stolen is not None and stolen.generation == 2
    assert not drift_queue.complete(queue, first, {})  # the zombie is fenced off
    assert drift_queue.depth(queue) == 1
    assert drift_queue.complete(queue, stolen, {"revision": "r"})
    assert drift_queue.depth(queue) == 0
    assert drift_queue.enqueue(queue, "m", {})  # a later episode enqueues again


def test_claim_without_request_is_none(tmp_path):
    assert drift_queue.claim(str(tmp_path / "q"), "ghost") is None


def test_pending_skips_torn_request(tmp_path):
    queue = str(tmp_path / "q")
    assert drift_queue.enqueue(queue, "ok-machine", {})
    with open(os.path.join(queue, drift_queue.REQUESTS_DIRNAME, "torn.json"), "w") as fh:
        fh.write("{not json")
    assert [r["machine"] for r in drift_queue.pending(queue)] == ["ok-machine"]
    assert drift_queue.depth(queue) == 2  # depth is a cheap file count


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_the_queue_files_are_read_across_the_packages(tmp_path, monkeypatch, writer):
    """One package enqueues; the other lists, claims and completes; a stale
    claim of the reader is stolen by the writer. The request files are
    byte-identical for the same payload and host."""
    monkeypatch.setenv("GORDO_TPU_HOST_ID", "node-a")
    mine, other = (drift_queue, jax_queue) if writer == "port" else (jax_queue, drift_queue)
    queue = str(tmp_path / "q")
    body = {"detected_at": 1234.5, "enqueued_at": 1235.0, "recent_mean": 3.25}
    for name in ("m-0", "m-1"):
        assert mine.enqueue(queue, name, dict(body))
        assert not other.enqueue(queue, name, dict(body))  # the dedup slot is shared
    twin = str(tmp_path / "twin")
    other.enqueue(twin, "m-0", dict(body))
    with open(os.path.join(queue, "requests", "m-0.json"), "rb") as a, \
            open(os.path.join(twin, "requests", "m-0.json"), "rb") as b:
        assert a.read() == b.read()
    assert [r["machine"] for r in other.pending(queue)] == ["m-0", "m-1"]
    assert other.depth(queue) == 2
    handle = other.claim(queue, "m-0", host_id="reader")
    assert handle.generation == 1
    assert mine.claim(queue, "m-0", host_id="writer") is None  # a live claim holds
    assert other.complete(queue, handle, {"revision": "drift-1"})
    with open(os.path.join(queue, "done", "m-0.g1.json")) as fh:
        assert json.load(fh)["revision"] == "drift-1"
    stale = other.claim(queue, "m-1", host_id="reader")
    stolen = mine.claim(queue, "m-1", host_id="writer", timeout_s=0.0)
    assert stolen.generation == stale.generation + 1
    assert not other.complete(queue, stale, {})
    assert mine.complete(queue, stolen, {}) and other.depth(queue) == 0


# ------------------------------------------------------------- the hot swap's scan
def _tree(root, revisions):
    """``root/rev-base`` and the delta revisions ``{name: marker machines or
    None (no marker)}``."""
    collection = root / "rev-base"
    collection.mkdir()
    for name, machines in revisions.items():
        rev = root / name
        rev.mkdir()
        (rev / "m").mkdir()
        if machines is not None:
            (rev / hotswap.COMPLETE_MARKER).write_text(
                json.dumps({"machines": machines, "revision": name}))
    (root / "not-a-delta").mkdir()
    return str(collection)


TREE = {"drift-000000000000003": ["a", "b"], "drift-000000000000001": ["a"],
        "drift-000000000000002": None, "drift-000000000000004": ["b", "c", 7]}


def test_delta_revisions_and_the_poll_order_are_the_jax_modules(tmp_path, monkeypatch):
    collection = _tree(tmp_path, TREE)
    ours = hotswap._delta_revisions(collection)
    assert ours == jax_hotswap._delta_revisions(collection)
    assert [name for name, _ in ours] == ["drift-000000000000001", "drift-000000000000003",
                                          "drift-000000000000004"]
    calls = {"ours": [], "theirs": []}
    monkeypatch.setattr(hotswap, "_swap_one", lambda server, rev_dir, revision, machine:
                        calls["ours"].append((revision, machine)) or machine != "c")
    monkeypatch.setattr(jax_hotswap, "_swap_one", lambda base, rev_dir, revision, machine:
                        calls["theirs"].append((revision, machine)) or machine != "c")
    # a fence set by an earlier swap: b stays on revision 3
    hotswap._last_swapped["b"] = jax_hotswap._last_swapped["b"] = "drift-000000000000003"
    swapped = hotswap.poll_once(collection)
    assert swapped == jax_hotswap.poll_once(collection) == ["a", "a", "b"]
    assert calls["ours"] == calls["theirs"] == [
        ("drift-000000000000001", "a"), ("drift-000000000000003", "a"),
        ("drift-000000000000004", "b"), ("drift-000000000000004", "c")]


def test_uncommitted_revision_is_invisible(tmp_path):
    collection = _tree(tmp_path, {"drift-000000000000001": None})
    assert hotswap._delta_revisions(collection) == []
    assert hotswap.poll_once(collection) == []


def test_lexical_fence_prevents_rollback(tmp_path, monkeypatch):
    collection = _tree(tmp_path, {"drift-000000000000001": ["m"]})
    hotswap._last_swapped["m"] = "drift-000000000000002"
    monkeypatch.setattr(hotswap, "_swap_one",
                        lambda *a: pytest.fail("an older revision must never swap in"))
    assert hotswap.poll_once(collection) == []


def test_a_failed_swap_is_counted_and_retried(tmp_path, monkeypatch):
    collection = _tree(tmp_path, {"drift-000000000000001": ["m"]})
    failures = hotswap.metric_catalog.HOT_SWAP_FAILURES.value(model="m")
    monkeypatch.setenv(faults.PLAN_ENV, json.dumps({"rules": [
        {"site": "swap_commit", "machine": "m", "times": 1, "error": "permanent"}]}))
    faults.reset_plan()
    attempts = []

    class Server:
        revision = "rev-base"

        def model_entry(self, revision, name):
            attempts.append((revision, name))
            raise FileNotFoundError(name)  # stops the swap after its fault site

    assert hotswap.poll_once(collection, Server()) == []
    assert attempts == []  # the fault site fires before the preload
    assert hotswap.metric_catalog.HOT_SWAP_FAILURES.value(model="m") == failures + 1
    assert hotswap.poll_once(collection, Server()) == []
    assert attempts == [("drift-000000000000001", "m")]
    assert hotswap.active("m") is None and hotswap.swaps() == []


def test_watcher_gated_off_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv("GORDO_TPU_HOT_SWAP", raising=False)
    assert hotswap.start_watcher(str(tmp_path), None) is None
    assert not hotswap.enabled()


def test_active_fast_path_without_overrides():
    assert hotswap.active("anything") is None
    with hotswap._lock:
        hotswap._overrides["m"] = ("/somewhere", "drift-1")
    assert hotswap.active("m") == ("/somewhere", "drift-1")
    assert hotswap.active("other") is None


# ------------------------------------------------------ warm keys, windows
def _machine_config(name, d_model=16, seed=0):
    return {
        "name": name,
        "dataset": {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00+00:00",
                    "train_end_date": "2020-01-03T00:00:00+00:00",
                    "tags": [f"{name}-tag-{j}" for j in range(4)], "resolution": "10min"},
        "model": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {
            "base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
                "sklearn.preprocessing.MinMaxScaler",
                {"gordo_tpu.models.models.TransformerAutoEncoder": {
                    "kind": "transformer_model", "lookback_window": 16, "d_model": d_model,
                    "num_heads": 2, "epochs": 1}}]}}}},
        "evaluation": {"cv_mode": "full_build", "seed": seed},
    }


CONFIGS = [_machine_config("m-0"), _machine_config("m-1", d_model=32),
           _machine_config("a-longer-machine-name", seed=3)]


@pytest.mark.parametrize("config", CONFIGS, ids=[c["name"] for c in CONFIGS])
def test_warm_keys_are_the_jax_keys(config):
    ours, theirs = Machine.from_config(config, "proj"), JaxMachine.from_config(config, "proj")
    key = ModelBuilder.calculate_warm_key(ours)
    assert key == JaxModelBuilder.calculate_warm_key(theirs)
    assert key.startswith("warm-") and len(key) == 5 + 128
    assert ModelBuilder.calculate_cache_key(ours) == JaxModelBuilder.calculate_cache_key(theirs)
    # the data moved: the cache key misses, the warm key still names the artifact
    moved = dict(config, dataset=dict(config["dataset"],
                                      train_end_date="2020-01-04T00:00:00+00:00"))
    moved_machine = Machine.from_config(moved, "proj")
    assert ModelBuilder.calculate_warm_key(moved_machine) == key
    assert ModelBuilder.calculate_cache_key(moved_machine) != ModelBuilder.calculate_cache_key(
        ours)


@pytest.mark.parametrize("detected_at", [1_580_000_000.0, 1_600_000_123.456789, 1.0, None])
def test_refreshed_windows_are_the_jax_windows(detected_at, monkeypatch):
    monkeypatch.setattr(drift_rebuild.time, "time", lambda: 1_590_000_000.25)
    monkeypatch.setattr(jax_rebuild.time, "time", lambda: 1_590_000_000.25)
    request = {} if detected_at is None else {"detected_at": detected_at}
    config = CONFIGS[0]
    ours = drift_rebuild._refreshed_machine(Machine.from_config(config, "proj"), request)
    theirs = jax_rebuild._refreshed_machine(JaxMachine.from_config(config, "proj"), request)
    ours_ds, theirs_ds = ours.to_dict()["dataset"], theirs.to_dict()["dataset"]
    for key in ("train_start_date", "train_end_date"):
        assert str(ours_ds[key]) == str(theirs_ds[key]), key
    from datetime import datetime, timedelta

    start, end = (datetime.fromisoformat(str(ours_ds[k]))
                  for k in ("train_start_date", "train_end_date"))
    assert end - start == timedelta(days=2)
    if detected_at is not None and detected_at > 1e9:
        assert end.timestamp() == pytest.approx(detected_at, abs=1e-6)
    assert ModelBuilder.calculate_warm_key(ours) == ModelBuilder.calculate_warm_key(
        Machine.from_config(config, "proj"))


def test_revision_names_sort_by_time():
    names = [drift_rebuild.revision_name(t) for t in (9.0, 10.0, 1_700_000_000.5)]
    assert names == sorted(names) == [jax_rebuild.revision_name(t)
                                      for t in (9.0, 10.0, 1_700_000_000.5)]
    assert names[-1] == "drift-001700000000500"
