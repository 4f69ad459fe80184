"""
Latency attribution, the perf sentinel and the Grafana dashboards of the
port (``gordo_tpu_torch/observability/{attribution,sentinel,grafana}.py``)
against the JAX package's modules, on the same phase sequences with an
injected clock (``now=`` and a patched ``time.time``): the same windows,
decomposition, mix shift, snapshots and fire times; shard payloads that
merge across the two packages; a disabled path that takes no lock; each
dashboard equal to the JAX one but for the panels over series the port has
no counterpart of, and every series a dashboard names in the port's
catalog or its server families. Exact unless stated.
"""

import json
import os
import re
import time

import numpy as np
import pytest

from gordo_tpu.observability import attribution as jax_attribution
from gordo_tpu.observability import flight as jax_flight
from gordo_tpu.observability import grafana as jax_grafana
from gordo_tpu.observability import sentinel as jax_sentinel
from gordo_tpu_torch.observability import attribution, flight, grafana, sentinel, telemetry
from gordo_tpu_torch.observability import metrics as metric_catalog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = ("GORDO_TPU_PERF_ATTRIBUTION", "GORDO_TPU_PERF_SENTINEL", "GORDO_TPU_PERF_WINDOW_S",
         "GORDO_TPU_PERF_SENTINEL_THRESHOLD", "GORDO_TPU_PERF_SENTINEL_MIN_SAMPLES",
         "GORDO_TPU_PERF_SENTINEL_COOLDOWN_S")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in KNOBS:
        monkeypatch.delenv(var, raising=False)
    for module in (attribution, jax_attribution, sentinel, jax_sentinel):
        module.reset()
    yield
    for module in (attribution, jax_attribution, sentinel, jax_sentinel):
        module.reset()


def _sequence(seed: int = 0, n: int = 120, start: float = 1000.0):
    """(model, total, phases, now) of a traffic mix whose second half is
    slower in ``predict`` and has another model mix."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        slow = i >= n // 2
        model = ["m-a", "m-b", "m-c"][rng.randint(3) if not slow else rng.randint(2) + 1]
        decode, encode = 0.002 * (1 + 0.1 * rng.rand()), 0.001 * (1 + 0.1 * rng.rand())
        predict = (0.012 if slow else 0.004) * (1 + 0.1 * rng.rand())
        phases = {"decode": decode, "predict": predict, "encode": encode}
        if i % 7 == 0:
            phases["queue"] = 0.0005  # a phase name outside the core three
        total = decode + predict + encode + 0.001 * rng.rand()
        out.append((model, total, phases, start + i * (100.0 / (n // 2))))
    return out


def test_the_same_sequence_gives_the_same_windows_and_decomposition(monkeypatch):
    monkeypatch.setenv("GORDO_TPU_PERF_ATTRIBUTION", "1")
    monkeypatch.setenv("GORDO_TPU_PERF_WINDOW_S", "100")
    for model, total, phases, now in _sequence():
        attribution.observe(model, total, phases, now=now)
        jax_attribution.observe(model, total, phases, now=now)
    for index in (9, 10, 11, 12):
        assert attribution.window_stats(index) == jax_attribution.window_stats(index)
    for percentile in ("p50_ms", "p99_ms"):
        ours = attribution.live_decomposition(percentile, now=1150.0)
        assert ours == jax_attribution.live_decomposition(percentile, now=1150.0)
        assert ours["base_window"] == 10 and ours["cur_window"] == 11
        # the rows sum exactly to the headline delta, and predict moved most
        assert sum(r["delta_ms"] for r in ours["rows"]) == pytest.approx(
            ours["headline_delta_ms"], abs=1e-9)
        assert max(ours["rows"], key=lambda r: r["delta_ms"])["name"] == "predict"
        assert attribution.format_decomposition(ours) == \
            jax_attribution.format_decomposition(ours)
    monkeypatch.setattr(time, "time", lambda: 1150.0)
    assert attribution.snapshot() == jax_attribution.snapshot()


def test_gate_disabled_takes_no_lock(monkeypatch):
    """With every knob unset, both modules return before their locks."""
    class Forbidden:
        def __enter__(self):
            raise AssertionError("a lock was taken with the knobs unset")

        def __exit__(self, *exc):
            return False

    with monkeypatch.context() as patched:
        patched.setattr(attribution._tracker, "lock", Forbidden())
        patched.setattr(sentinel, "_lock", Forbidden())
        attribution.observe("m", 0.01, {"decode": 0.002}, now=1000.0)
        assert sentinel.observe_phases(0.01, {"decode": 0.002}, now=1000.0) == []
        assert attribution.enabled() is False and sentinel.enabled() is False


@pytest.mark.parametrize("walltime", [False, True])
def test_decompose_stats_and_mix_shift_agree(walltime):
    def stats(p50, p99, phases, models):
        return {"total": {"p50_ms": p50, "p99_ms": p99},
                "phases": {k: {"p50_ms": v, "p99_ms": v * 1.5} for k, v in phases.items()},
                "models": models}

    base_phases = {"decode": 2.0, "predict": 5.0, "encode": 1.0}
    cur_phases = {"decode": 2.5, "predict": 15.0, "encode": 1.0}
    if walltime:
        base_phases.update(request_walltime=9.0, gateway=0.5)
        cur_phases.update(request_walltime=19.5, gateway=0.7)
    base = stats(10.0, 20.0, base_phases, {"a": {"count": 50, "mean_ms": 1.0},
                                           "b": {"count": 50, "mean_ms": 9.0}})
    cur = stats(21.0, 40.0, cur_phases, {"a": {"count": 10, "mean_ms": 1.0},
                                         "b": {"count": 90, "mean_ms": 9.0}})
    for percentile in ("p50_ms", "p99_ms"):
        ours = attribution.decompose_stats(base, cur, percentile)
        assert ours == jax_attribution.decompose_stats(base, cur, percentile)
        assert sum(r["delta_ms"] for r in ours["rows"]) == pytest.approx(ours["headline_delta_ms"])
    assert attribution.mix_shift(base["models"], cur["models"]) == pytest.approx(0.4 * 9 - 0.4)
    assert attribution.mix_shift(None, cur["models"]) is None


@pytest.mark.parametrize("name", ["BENCH_r08.json", "BENCH_r09.json", "BENCH_r10.json"])
def test_phase_stats_from_a_record_agree(name):
    with open(os.path.join(REPO, name)) as fh:
        record = json.load(fh)
    assert (attribution.phase_stats_from_record(record, base_dir=REPO)
            == jax_attribution.phase_stats_from_record(record, base_dir=REPO))


def test_shard_payloads_merge_across_the_packages(monkeypatch):
    from gordo_tpu.observability.latency import LatencyHistogram as JaxHistogram

    monkeypatch.setenv("GORDO_TPU_PERF_ATTRIBUTION", "1")
    monkeypatch.setenv("GORDO_TPU_PERF_WINDOW_S", "100")
    for model, total, phases, now in _sequence(seed=3, n=40):
        attribution.observe(model, total, phases, now=now)
        jax_attribution.observe(model, total, phases, now=now)
    ours, theirs = attribution.shard_payload(), jax_attribution.shard_payload()
    assert ours == theirs
    pairs = [(1, ours), (2, theirs)]
    merged = attribution.merge_payloads(pairs)
    assert merged == jax_attribution.merge_payloads(pairs)
    for index, row in merged.items():
        assert JaxHistogram.from_dict(row["phases"]["total"]).count == 2 * sum(
            count for count, _ in ours[index]["models"].values())


def _arm(monkeypatch, min_samples=20, threshold=4.0, cooldown=50.0):
    monkeypatch.setenv("GORDO_TPU_PERF_SENTINEL", "1")
    monkeypatch.setenv("GORDO_TPU_PERF_SENTINEL_MIN_SAMPLES", str(min_samples))
    monkeypatch.setenv("GORDO_TPU_PERF_SENTINEL_THRESHOLD", str(threshold))
    monkeypatch.setenv("GORDO_TPU_PERF_SENTINEL_COOLDOWN_S", str(cooldown))


def test_the_sentinel_fires_at_the_same_times(monkeypatch):
    """A baseline, a persistent predict slowdown, the cooldown's silence,
    then the re-armed alarm: the same phases fire on the same calls in
    both, and each fire leaves one flight event with the snapshot and the
    stacks."""
    _arm(monkeypatch)
    monkeypatch.setattr(time, "time", lambda: 1200.0)
    flight.default_recorder().reset()
    jax_flight.default_recorder().reset()
    rng = np.random.RandomState(0)
    calls = []
    for i in range(25):
        jitter = 1.0 + 0.02 * float(rng.standard_normal())
        calls.append((0.010 * jitter, {"decode": 0.002 * jitter, "predict": 0.004 * jitter,
                                       "encode": 0.001 * jitter}, 1000.0 + i))
    slow = (0.030, {"decode": 0.002, "predict": 0.024, "encode": 0.001})
    calls += [(*slow, 1100.0 + i) for i in range(10)]
    calls += [(*slow, 1120.0 + i) for i in range(10)]   # inside the cooldown
    calls += [(*slow, 1200.0 + i) for i in range(10)]   # re-armed
    fires, jax_fires = [], []
    for total, phases, now in calls:
        fires.append(sentinel.observe_phases(total, phases, now=now))
        jax_fires.append(jax_sentinel.observe_phases(total, phases, now=now))
    assert fires == jax_fires
    flat = [phase for fired in fires for phase in fired]
    assert flat.count("predict") == 2 and "decode" not in flat and "encode" not in flat
    assert sentinel.snapshot() == jax_sentinel.snapshot()
    assert sentinel.regressed_phases() == jax_sentinel.regressed_phases()
    events = [e for e in flight.default_recorder().events() if e["kind"] == "perf_regression"]
    assert [e["payload"]["phase"] for e in events] == [p for p in flat]
    payload = next(e["payload"] for e in events if e["payload"]["phase"] == "predict")
    assert payload["observed_ms"] == pytest.approx(24.0)
    assert {"attribution", "top_stacks", "baseline_mean_ms", "baseline_n"} <= set(payload)
    assert metric_catalog.PERF_REGRESSIONS.value(phase="predict") >= 2


def test_the_gauges_are_fed(monkeypatch):
    monkeypatch.setenv("GORDO_TPU_PERF_ATTRIBUTION", "1")
    monkeypatch.setenv("GORDO_TPU_PERF_WINDOW_S", "100")
    monkeypatch.setattr(time, "time", lambda: 1010.0)
    for model, total, phases, now in _sequence(n=20):
        attribution.observe(model, total, phases, now=now)
    attribution.refresh_gauges()
    stats = attribution.window_stats(10)
    assert metric_catalog.PHASE_P50.value(phase="predict") == pytest.approx(
        stats["phases"]["predict"]["p50_ms"] / 1000.0)
    assert metric_catalog.PHASE_P99.value(phase="total") == pytest.approx(
        stats["total"]["p99_ms"] / 1000.0)
    _arm(monkeypatch, min_samples=2)
    for model, total, phases, now in _sequence(n=6):
        sentinel.observe_phases(total, phases, now=now)
    sentinel.refresh_gauges()
    assert metric_catalog.SENTINEL_CUSUM.value(phase="predict") == \
        sentinel.snapshot()["phases"]["predict"]["cusum"]


# ------------------------------------------------------------------- Grafana
DASHBOARDS = ("servers_dashboard", "machines_dashboard", "build_dashboard",
              "resilience_dashboard", "fleet_dashboard", "gateway_dashboard", "drift_dashboard",
              "chaos_dashboard", "perf_dashboard")
# the panels over series with no counterpart in the port (module docstring)
LEFT_OUT = {"build_dashboard": {"Bucket-program cache", "XLA cache entries", "XLA cache size",
                                "XLA cache entries added"},
            "fleet_dashboard": {"AOT serving programs by source"}}


@pytest.mark.parametrize("name", DASHBOARDS)
def test_each_dashboard_is_the_jax_one_but_for_the_named_panels(name):
    ours, theirs = getattr(grafana, name)(), getattr(jax_grafana, name)()
    left_out = LEFT_OUT.get(name, set())
    kept = [panel for panel in theirs["panels"] if panel["title"] not in left_out]
    assert len(kept) == len(theirs["panels"]) - len(left_out)
    assert ours["panels"] == kept
    assert {k: v for k, v in ours.items() if k != "panels"} == \
        {k: v for k, v in theirs.items() if k != "panels"}


def test_every_series_the_dashboards_name_is_exported():
    from gordo_tpu_torch.server.prometheus import metrics as server_metrics

    families = server_metrics.GordoServerPrometheusMetrics(registry=telemetry.MetricsRegistry())
    exported = set(telemetry.default_registry().names()) | set(families.registry.names())
    metric_re = re.compile(r"(gordo_(?:server|build|gateway)_[a-z0-9_]+?)(?:_bucket|_count|_sum)?"
                           r"[{\[\s)]")
    named = set()
    for name in DASHBOARDS:
        for panel in getattr(grafana, name)()["panels"]:
            for target in panel["targets"]:
                found = metric_re.findall(target["expr"])
                assert found, target["expr"]
                named.update(re.sub(r"_(bucket|count|sum)$", "", n) for n in found)
    assert named <= exported, sorted(named - exported)
    unmatched = {"gordo_build_xla_persistent_cache_entries", "gordo_server_aot_programs_total",
                 "gordo_build_program_cache_requests_total"}
    assert not named & unmatched


def test_write_dashboards_writes_each_one(tmp_path):
    paths = grafana.write_dashboards(str(tmp_path))
    assert [os.path.basename(p) for p in paths] == [
        os.path.basename(p) for p in jax_grafana.write_dashboards(str(tmp_path / "jax"))]
    for path in paths:
        with open(path) as fh:
            assert json.load(fh)["panels"]
