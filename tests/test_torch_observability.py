"""
The port's telemetry plane (``gordo_tpu_torch/observability/``,
``ops/flops.py``, ``util/profiling.py``) held against the JAX package's
modules of the same names on the CPU, with the same inputs and, where
time enters, an injected clock. Exact unless a test says otherwise.

- The registry: the same counter, gauge and histogram operations (exemplars
  under fixed trace ids and a fixed clock) render byte-identical text.
- Chrome traces of the same spans are structurally equal.
- ``traceparent``: a table of valid and invalid headers, the same verdicts
  and ids.
- ``LatencyHistogram``: quantiles, merges, and ``to_dict`` loading across.
- The flight recorder, the SLO windows and the JSON logs: the same
  (duration, status) sequence keeps the same traces and gives the same
  ``/debug/slo`` numbers; log lines have the same keys.
- FLOPs: forward, training, CV-build FLOPs and the parameter count of a
  Dense, LSTM, Transformer, MoE and TCN spec.
- Shards: two processes' shards render the summed fleet text, the same
  text from either package's renderer.
- Zero allocation: the disabled ``span()`` and the port batcher's
  ``submit`` leave nothing allocated by the observability modules
  (``tracemalloc``, as ``tests/gordo_tpu/test_profiler.py`` checks the JAX
  batcher).
- The port's own parts: the batcher's telemetry on the CPU, the device
  sampler, the ``torch.profiler`` captures and their one-session rule.
"""

import json
import logging
import os
import subprocess
import sys
import threading
import time
import tracemalloc

import numpy as np
import pytest

from gordo_tpu.models import spec as jax_spec
from gordo_tpu.observability import flight as jax_flight
from gordo_tpu.observability import latency as jax_latency
from gordo_tpu.observability import logs as jax_logs
from gordo_tpu.observability import shared as jax_shared
from gordo_tpu.observability import slo as jax_slo
from gordo_tpu.observability import telemetry as jax_telemetry
from gordo_tpu.observability import tracing as jax_tracing
from gordo_tpu.ops import flops as jax_flops
from gordo_tpu_torch.observability import device, flight, latency, logs, profiler, shared, slo
from gordo_tpu_torch.observability import metrics as metric_catalog
from gordo_tpu_torch.observability import telemetry, tracing
from gordo_tpu_torch.ops import flops
from gordo_tpu_torch.serializer.from_jax import spec_from_dataclass
from gordo_tpu_torch.util import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE = "ab" * 16
PARENT = "cd" * 8
TRACEPARENT = f"00-{TRACE}-{PARENT}-01"
PACKAGES = {"port": (telemetry, tracing), "jax": (jax_telemetry, jax_tracing)}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in ("GORDO_TPU_PROFILE_DIR", "GORDO_TPU_FLIGHT_SLOW_S", "GORDO_TPU_SLO_P99_MS",
                 "GORDO_TPU_SLO_ERROR_BUDGET", "GORDO_TPU_TELEMETRY_DIR",
                 "GORDO_TPU_DEBUG_ENDPOINTS", "GORDO_TPU_PROFILE_HZ"):
        monkeypatch.delenv(name, raising=False)
    for module in (telemetry, jax_telemetry):
        module.reset()
    for module in (slo, jax_slo):
        module.reset()
    for module in (flight, jax_flight):
        module.reset()
    yield
    for module in (telemetry, jax_telemetry):
        module.reset()


# ------------------------------------------------------------------ registry
def _registry_ops(telemetry_mod, tracing_mod) -> str:
    """One script of counter, gauge and histogram operations, with
    exemplars captured under a request trace; the registry's text."""
    reg = telemetry_mod.MetricsRegistry()
    c = reg.counter("gordo_t_events_total", "events\nwith a newline", ("kind",))
    c.labels(kind="a").inc()
    c.labels(kind='q"uote').inc(2.5)
    g = reg.gauge("gordo_t_level", "level", ("device", "stat"))
    g.labels(device="0", stat="bytes_in_use").set(7)
    g.labels(device="0", stat="nan").set(float("nan"))
    g.labels(device="1", stat="inf").set(float("inf"))
    plain = reg.gauge("gordo_t_plain", "plain")
    plain.inc(3)
    plain.inc(-1)
    h = reg.histogram("gordo_t_seconds", "durations", ("route",), buckets=(0.1, 1.0, 10.0))
    h.labels(route="/a").observe(0.05)
    h.labels(route="/a").observe(100.0)
    with tracing_mod.request_root(TRACEPARENT):
        h.labels(route="/b").observe(0.5)
        h.labels(route="/b").observe(5.0)
    with tracing_mod.request_root(f"00-{'ef' * 16}-{PARENT}-01"):
        h.labels(route="/b").observe(0.7)  # the bucket's newest exemplar wins
    reg.histogram("gordo_t_empty_seconds", "never observed")
    return reg.render_text()


def test_registry_render_text_is_byte_identical(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    ours, theirs = (_registry_ops(*PACKAGES[p]) for p in ("port", "jax"))
    assert ours == theirs
    assert f'# {{trace_id="{"ef" * 16}"}} 0.7 1700000000.250' in ours


def test_catalog_matches_the_jax_catalog():
    """Names, kinds, help texts, label names and buckets of all 81 series."""
    from gordo_tpu.observability import metrics as jax_metrics

    def catalog(module, registry):
        out = {}
        for name in dir(module):
            metric = getattr(module, name)
            if isinstance(metric, registry._Metric):
                out[name] = (metric.name, metric.kind, metric.help, metric.labelnames,
                             getattr(metric, "buckets", None))
        return out

    ours, theirs = catalog(metric_catalog, telemetry), catalog(jax_metrics, jax_telemetry)
    assert len(ours) == 81 and ours == theirs


# ------------------------------------------------------------ chrome traces
def _span_script(telemetry_mod, tracing_mod) -> dict:
    telemetry_mod.start_trace()
    with telemetry_mod.span("batched_build", machines=2):
        with telemetry_mod.span("fetch", machine="m-0"):
            pass
        with tracing_mod.attach(tracing_mod.root_for("m-1")):
            with telemetry_mod.span("serialize", machine="m-1"):
                pass
    try:
        with telemetry_mod.span("compile", bucket="b0"):
            raise ValueError("boom")
    except ValueError:
        pass
    telemetry_mod.add_trace_event("serve_device_call", time.monotonic(), 0.001, fused=3)
    return telemetry_mod.stop_trace()


def _structure(trace: dict) -> list:
    """Each event without its clock, ids and process: name, category,
    phase, and args (trace and span ids only as present or absent)."""
    out = []
    for event in trace["traceEvents"]:
        args = dict(event.get("args", {}))
        for key in ("trace_id", "span_id"):
            if key in args:
                args[key] = len(args[key])
        out.append((event["name"], event["cat"], event["ph"], sorted(event),
                    sorted(args.items())))
    return out


def test_chrome_traces_are_structurally_equal():
    ours, theirs = (_span_script(*PACKAGES[p]) for p in ("port", "jax"))
    assert _structure(ours) == _structure(theirs)
    assert sorted(ours) == sorted(theirs) and sorted(ours["otherData"]) == sorted(
        theirs["otherData"])
    names = [e["name"] for e in ours["traceEvents"]]
    assert names == ["fetch", "serialize", "batched_build", "compile", "serve_device_call"]


def test_disabled_span_is_the_shared_noop_singleton():
    assert telemetry.span("compile", machine="m") is telemetry.span("train")
    assert telemetry.span("x") is telemetry._NULL_SPAN
    with tracing.request_root():
        assert telemetry.span("x") is not telemetry._NULL_SPAN


# --------------------------------------------------------------- traceparent
TRACEPARENTS = [
    TRACEPARENT,
    f"  {TRACEPARENT.upper()}  ",
    f"01-{TRACE}-{PARENT}-00",
    f"ff-{TRACE}-{PARENT}-ff",
    f"00-{'0' * 32}-{PARENT}-01",
    f"00-{TRACE}-{'0' * 16}-01",
    f"00-{TRACE}-{PARENT}",
    f"00-{TRACE[:-1]}-{PARENT}-01",
    f"00-{TRACE}g-{PARENT}-01",
    f"00_{TRACE}_{PARENT}_01",
    f"00-{TRACE}-{PARENT}-01-extra",
    "",
    None,
    "garbage",
]


@pytest.mark.parametrize("header", TRACEPARENTS)
def test_traceparent_verdicts_and_ids_match(header):
    ours, theirs = tracing.parse_traceparent(header), jax_tracing.parse_traceparent(header)
    assert ours == theirs
    with tracing.request_root(header) as ctx, jax_tracing.request_root(header) as jax_ctx:
        if theirs is None:
            assert ctx.span_id is None and jax_ctx.span_id is None
            assert len(ctx.trace_id) == 32 and ctx.trace_id != jax_ctx.trace_id
        else:
            assert (ctx.trace_id, ctx.span_id) == (jax_ctx.trace_id, jax_ctx.span_id) == theirs
        assert tracing.format_traceparent(ctx).split("-")[:2] == \
            jax_tracing.format_traceparent(ctx).split("-")[:2]


# ----------------------------------------------------------------- latency
def _latency_records(hist_cls, seed: int):
    rng = np.random.RandomState(seed)
    hist = hist_cls(subbuckets=32)
    for i, value in enumerate(rng.lognormal(-4, 1.5, 500)):
        hist.record(float(value), trace_id=f"t{i}" if i % 7 == 0 else None)
    hist.record(float("nan"))
    hist.record(-1.0)
    hist.record_with_expected_interval(0.5, 0.05, trace_id="co")
    return hist


def test_latency_histogram_matches_and_loads_across():
    ours = _latency_records(latency.LatencyHistogram, 0)
    theirs = _latency_records(jax_latency.LatencyHistogram, 0)
    assert ours.summary() == theirs.summary() and ours.to_dict() == theirs.to_dict()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)
    other, jax_other = (_latency_records(cls, 1) for cls in (latency.LatencyHistogram,
                                                             jax_latency.LatencyHistogram))
    ours.merge(other)
    theirs.merge(jax_other)
    assert ours.to_dict() == theirs.to_dict() and ours.exemplars() == theirs.exemplars()
    # each package's dict loads in the other, and merges there the same
    crossed = latency.LatencyHistogram.from_dict(json.loads(json.dumps(theirs.to_dict())))
    jax_crossed = jax_latency.LatencyHistogram.from_dict(json.loads(json.dumps(ours.to_dict())))
    assert crossed.to_dict() == theirs.to_dict() and jax_crossed.to_dict() == ours.to_dict()
    merged = latency.LatencyHistogram.merged([crossed, other], subbuckets=32)
    jax_merged = jax_latency.LatencyHistogram.merged([jax_crossed, jax_other], subbuckets=32)
    assert merged.percentiles() == jax_merged.percentiles()


# --------------------------------------------------- flight, SLO and logs
# (duration seconds, status) of one request sequence
SEQUENCE = [(0.01 * (1 + i % 9), 200) for i in range(60)] + [
    (0.002, 404), (0.003, 400), (1.7, 200), (0.02, 503), (0.9, 200), (0.04, 200),
    (0.31, 500), (0.005, 200)]


def _flight_run(flight_mod, tracing_mod, telemetry_mod) -> list:
    recorder = flight_mod.FlightRecorder(capacity=8)
    kept = []
    for i, (duration, status) in enumerate(SEQUENCE):
        with tracing_mod.request_root(f"00-{i:032x}-{PARENT}-01") as ctx:
            with telemetry_mod.span("serve_request", method="POST"):
                with telemetry_mod.span("serve_batch_queue", model="m"):
                    pass
        kept.append(recorder.observe(ctx.collector, status, duration, "/rule", "m"))
    doc = recorder.chrome_trace()
    summaries = [{k: v for k, v in r.items() if k != "recorded_at"} for r in doc["gordoFlight"]]
    names = sorted((e["name"], e["args"]["trace_id"]) for e in doc["traceEvents"])
    return [kept, summaries, names, recorder.slow_threshold_s(), recorder.seen, recorder.kept,
            sorted(doc), sorted(doc["otherData"])]


@pytest.mark.parametrize("slow_s", [None, "0.25"])
def test_flight_recorder_keeps_the_same_traces(monkeypatch, slow_s):
    if slow_s:
        monkeypatch.setenv("GORDO_TPU_FLIGHT_SLOW_S", slow_s)
    ours = _flight_run(flight, tracing, telemetry)
    theirs = _flight_run(jax_flight, jax_tracing, jax_telemetry)
    assert ours == theirs
    # the explicit knob, or the adaptive threshold (its 0.25 s floor) after
    # the first 50 requests
    assert "error" in ours[0] and "slow" in ours[0]


def _slo_run(slo_mod) -> tuple:
    for i, (duration, status) in enumerate(SEQUENCE):
        slo_mod.record("model-a" if i % 3 else "model-b", duration, status)
    slo_mod.record("", 1.0, 200)  # no model: ignored
    return slo_mod.snapshot(), slo_mod.shard_payload()


def test_slo_windows_give_the_same_numbers(monkeypatch):
    monkeypatch.setenv("GORDO_TPU_SLO_P99_MS", "100")
    monkeypatch.setenv("GORDO_TPU_SLO_ERROR_BUDGET", "0.05")
    monkeypatch.setattr(time, "time", lambda: 1_700_000_123.0)
    ours, theirs = _slo_run(slo), _slo_run(jax_slo)
    assert ours == theirs
    assert ours[0]["models"]["model-a"]["5m"]["slow"] > 0
    merged = slo.merge_payloads([(1, ours[1]), (2, theirs[1])])
    assert merged == jax_slo.merge_payloads([(1, ours[1]), (2, theirs[1])])
    assert merged["models"]["model-b"]["1h"]["requests"] == \
        2 * ours[0]["models"]["model-b"]["1h"]["requests"]


def _log_line(logs_mod, tracing_mod, telemetry_mod) -> dict:
    record = logging.LogRecord("gordo.test", logging.WARNING, __file__, 1, "slow %s", ("x",),
                               None)
    record.created, record.msecs = 1_700_000_000.0, 123.0  # one clock for both
    with tracing_mod.request_root(TRACEPARENT):
        with telemetry_mod.span("serve_request"):
            logs_mod.TraceContextFilter().filter(record)
    return json.loads(logs_mod.JsonLogFormatter().format(record))


def test_json_log_lines_have_the_same_keys(monkeypatch):
    ours = _log_line(logs, tracing, telemetry)
    theirs = _log_line(jax_logs, jax_tracing, jax_telemetry)
    assert sorted(ours) == sorted(theirs) == ["level", "logger", "message", "span_id",
                                             "trace_id", "ts"]
    assert ours["trace_id"] == theirs["trace_id"] == TRACE
    assert {k: v for k, v in ours.items() if k != "span_id"} == \
        {k: v for k, v in theirs.items() if k != "span_id"}
    monkeypatch.setenv("GORDO_TPU_LOG_FORMAT", "json")
    assert logs.json_logs_enabled() and jax_logs.json_logs_enabled()


# --------------------------------------------------------------------- FLOPs
def _specs() -> dict:
    S = jax_spec
    adam = S.OptimizerSpec()
    return {
        "dense": S.ModelSpec(layers=(S.DenseLayer(8, "tanh"), S.DenseLayer(3, "tanh"),
                                     S.DenseLayer(8, "tanh"), S.DenseLayer(5, "linear")),
                             n_features=5, n_features_out=5, optimizer=adam),
        "lstm": S.ModelSpec(layers=(S.LSTMLayer(16, return_sequences=True), S.LSTMLayer(8),
                                    S.DenseLayer(4)),
                            n_features=4, n_features_out=4, lookback_window=12),
        "transformer": S.ModelSpec(layers=(S.DenseLayer(256), S.PositionalEncoding(),
                                           S.TransformerBlock(256, 4, 512),
                                           S.TransformerBlock(256, 4, 512), S.PoolLayer("last"),
                                           S.DenseLayer(8)),
                                   n_features=8, n_features_out=8, lookback_window=512),
        "moe": S.ModelSpec(layers=(S.DenseLayer(64), S.MoEBlock(64, 4, 8, 32), S.PoolLayer(),
                                   S.DenseLayer(6)),
                           n_features=6, n_features_out=6, lookback_window=32, remat=True),
        "tcn": S.ModelSpec(layers=(S.TCNBlock(16, 3, 1), S.TCNBlock(16, 3, 2), S.PoolLayer(),
                                   S.DenseLayer(3)),
                           n_features=3, n_features_out=3, lookback_window=24),
    }


@pytest.mark.parametrize("family", ["dense", "lstm", "transformer", "moe", "tcn"])
def test_flops_equal_the_jax_values(family):
    theirs = _specs()[family]
    ours = spec_from_dataclass(theirs)
    assert flops.forward_flops_per_sample(ours) == jax_flops.forward_flops_per_sample(theirs) > 0
    assert flops.training_flops_per_sample(ours) == jax_flops.training_flops_per_sample(theirs)
    assert flops.spec_param_count(ours) == jax_flops.spec_param_count(theirs) > 0
    for rows in (700, 1535):
        assert flops.n_windows(ours, rows) == jax_flops.n_windows(theirs, rows)
        assert flops.cv_build_flops(ours, rows, 2) == jax_flops.cv_build_flops(theirs, rows, 2)


def test_peak_table_env_override_and_measured_fallback(monkeypatch):
    assert flops.peak_flops_with_source("NVIDIA H100 80GB HBM3") == (989.4e12, "table")
    assert flops.chip_peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert flops.chip_peak_flops("TPU v5e") is None  # the port carries no TPU entry
    monkeypatch.setenv("GORDO_TPU_PEAK_FLOPS", "2e12")
    assert flops.peak_flops_with_source("NVIDIA H100 80GB HBM3") == (2e12, "env")
    monkeypatch.delenv("GORDO_TPU_PEAK_FLOPS")
    monkeypatch.setattr(flops, "_measured_peak", None)
    peak, source = flops.peak_flops_with_source("cpu")
    assert source == "measured" and peak > 0
    assert flops.serving_peak_flops() == (peak, "measured")


# -------------------------------------------------------------------- shards
_SHARD_WRITER = """
import os, sys
sys.path.insert(0, {repo!r})
os.environ["GORDO_TPU_TELEMETRY_DIR"] = {directory!r}
from gordo_tpu_torch.observability import metrics, shared, slo, telemetry
metrics.FLEET_REQUESTS.labels(endpoint="/rule", status="2xx").inc({n})
metrics.FLEET_REQUEST_SECONDS.labels(endpoint="/rule").observe(0.05 * {n})
metrics.DEVICE_BUSY_RATIO.set(0.1 * {n})
metrics.PARAM_BANK_BYTES.set(1000 * {n})
slo.install_shard_hooks()
slo.record("model-a", 0.01 * {n}, 200)
assert shared.flush(force=True)
print(os.getpid())
"""


def test_two_processes_shards_render_the_summed_fleet_text(tmp_path):
    pids = []
    for n in (1, 2):
        out = subprocess.run(
            [sys.executable, "-c", _SHARD_WRITER.format(repo=REPO, directory=str(tmp_path), n=n)],
            capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        pids.append(out.stdout.split()[-1])
    ours = shared.render_fleet_text(str(tmp_path))
    theirs = jax_shared.render_fleet_text(str(tmp_path))
    assert ours == theirs
    assert "gordo_server_fleet_workers 2.0" in ours
    assert 'gordo_server_fleet_requests_total{endpoint="/rule",status="2xx"} 3.0' in ours
    assert 'gordo_server_fleet_request_seconds_count{endpoint="/rule"} 2' in ours
    assert "gordo_server_device_busy_ratio 0.2" in ours  # max-merged
    assert "gordo_server_param_bank_bytes 3000.0" in ours  # summed
    for pid in pids:
        assert f'gordo_server_param_bank_bytes{{worker="{pid}"}}' in ours
    merged = slo.merge_payloads(shared.fleet_extras("slo", str(tmp_path)))
    assert merged["workers"] == 2 and merged["models"]["model-a"]["5m"]["requests"] == 2
    assert merged == jax_slo.merge_payloads(jax_shared.fleet_extras("slo", str(tmp_path)))


# ----------------------------------------------------------- zero allocation
def _observability_files() -> list:
    return [module.__file__ for module in (tracing, flight, profiler, slo, logs, shared, device,
                                           latency)]


def _live(filters, fn, rounds: int = 5) -> list:
    tracemalloc.start(5)
    try:
        for _ in range(rounds):
            fn()
        snapshot = tracemalloc.take_snapshot().filter_traces(filters)
    finally:
        tracemalloc.stop()
    return [(str(stat.traceback), stat.size) for stat in snapshot.statistics("lineno")]


def test_disabled_span_allocates_nothing():
    filters = [tracemalloc.Filter(True, path) for path in
               [telemetry.__file__, profiling.__file__, *_observability_files()]]

    def spans():
        with telemetry.span("serve_batch_queue", model="m"):
            tracing.capture()

    spans()
    assert _live(filters, spans) == []


def test_batcher_submit_adds_no_observability_allocations():
    from gordo_tpu_torch.server.batcher import CrossModelBatcher

    spec, (model,) = _dense_models(1)
    fused = CrossModelBatcher(window_ms=0, max_batch=8)
    X = np.random.RandomState(0).rand(64, 4).astype(np.float32)
    fused.submit(spec, model, X)  # warm: the bank, the dispatcher thread
    filters = [tracemalloc.Filter(True, path) for path in _observability_files()]
    try:
        assert _live(filters, lambda: fused.submit(spec, model, X)) == []
    finally:
        fused.close()


# --------------------------------------------- the port's batcher telemetry
def _dense_models(n: int):
    """A small dense spec and ``n`` models of it on the CPU."""
    import torch

    from gordo_tpu_torch.models.spec import DenseLayer, ModelSpec
    from gordo_tpu_torch.ops.nn import TransformerModel, init_model_params

    spec = ModelSpec(layers=(DenseLayer(3, "tanh"), DenseLayer(4, "linear")), n_features=4,
                     n_features_out=4)
    return spec, [TransformerModel(spec, init_model_params(spec), torch.device("cpu"))
                  for _ in range(n)]


def test_batcher_feeds_the_catalog_on_the_cpu():
    from gordo_tpu_torch.server import batcher

    spec, models = _dense_models(3)
    fused = batcher.CrossModelBatcher(window_ms=0, max_batch=8)
    rng = np.random.RandomState(1)
    items = [(models[i % 3], rng.rand(50, 4).astype(np.float32)) for i in range(6)]
    telemetry.start_trace()
    results = [None] * len(items)

    def user(i):
        model, X = items[i]
        with tracing.request_root(f"00-{i + 1:032x}-{PARENT}-01"):
            with batcher.request_model(f"m{i}"):
                results[i] = fused.submit(spec, model, X)
            results[i] = (results[i], tracing.current().collector.snapshot())

    threads = [threading.Thread(target=user, args=(i,)) for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    fused.close()
    stats = fused.stats
    assert stats["items"] == 6 and not stats["bisections"]
    assert metric_catalog.BATCHER_FUSE_WIDTH.count() == stats["device_calls"]
    assert metric_catalog.BATCHER_QUEUE_WAIT_SECONDS.count() == 6
    assert metric_catalog.DEVICE_FLOPS.value() == \
        flops.forward_flops_per_sample(spec) * sum(windows for _, windows in fused.calls)
    assert 0 < metric_catalog.DEVICE_BUSY_SECONDS.value()
    assert metric_catalog.PARAM_BANK_RESTACKS.value() == 1
    for i, (out, spans) in enumerate(results):
        assert out.shape == (50, 4)
        by_name = {s.name: s for s in spans}
        queue, call = by_name["serve_batch_queue"], by_name["serve_device_call"]
        assert call.parent_id == queue.span_id and call.attrs["model"] == f"m{i}"
        assert len(call.links) == call.attrs["fused"] - 1
    events = [e["name"] for e in telemetry.stop_trace()["traceEvents"]]
    assert events.count("serve_device_call") == stats["device_calls"]
    # the device sampler: the banks' bytes and occupancy, no memory series
    # without CUDA, the program cache at 0
    device.reset_for_tests()
    batcher._batcher = fused
    try:
        snap = device.snapshot()
        bank = next(iter(fused._banks.values()))
        assert snap["param_bank_bytes"] == sum(t.nbytes for layer in bank.stacked
                                               for t in layer.values())
        assert snap["param_bank_occupancy"] == 3 / 8 and snap["program_cache_entries"] == 0
        assert metric_catalog.DEVICE_MEMORY.snapshot() == []
    finally:
        batcher._batcher = None


class _StreamEvent:
    """A stand-in for a completed CUDA timing event at ``ms`` on one
    stream: ``elapsed_time`` gives float32 milliseconds, as CUDA does."""

    def __init__(self, ms: float):
        self.ms = ms

    def elapsed_time(self, other: "_StreamEvent") -> float:
        return float(np.float32(other.ms - self.ms))


def test_stream_busy_seconds_union_short_intervals():
    from gordo_tpu_torch.server import batcher

    fused = batcher.CrossModelBatcher(window_ms=0)
    before = metric_catalog.DEVICE_BUSY_SECONDS.value()
    # a day into the process, where float32 milliseconds since the start
    # are 8 ms apart: each reading must span a call or a gap, not the day
    day = 86_400_000.0
    for begin, end in [(0.25, 20.25), (30.25, 50.25), (40.25, 70.25), (45.25, 60.25),
                       (100.25, 100.75)]:
        fused._account_events("stream", _StreamEvent(day + begin), _StreamEvent(day + end))
    # the union of [0.25, 20.25], [30.25, 70.25] and [100.25, 100.75]
    assert metric_catalog.DEVICE_BUSY_SECONDS.value() - before == pytest.approx(60.5e-3)


@pytest.mark.parametrize("family,stems", [
    ("dense", ()), ("tcn", ()), ("lstm", ("lstm_recurrence",)),
    ("transformer", ("flash_attention", "flash_attention_bwd")),
    ("moe", ("flash_attention", "flash_attention_bwd"))])
def test_compile_span_loads_only_the_kernels_a_family_launches(family, stems):
    import dataclasses

    from gordo_tpu_torch.parallel import batch_trainer

    spec = spec_from_dataclass(_specs()[family])
    assert batch_trainer._kernel_libraries(spec) == stems
    bf16 = batch_trainer._kernel_libraries(dataclasses.replace(spec, compute_dtype="bfloat16"))
    assert bf16 == tuple(s if s == "lstm_recurrence" else f"{s}_bf16" for s in stems)


# ------------------------------------------------------- torch.profiler parts
def test_profiled_block_mirrors_spans_and_exports(tmp_path, monkeypatch):
    import torch

    monkeypatch.setenv("GORDO_TPU_PROFILE_DIR", str(tmp_path))
    with profiling.maybe_profile("batched-build"):
        with telemetry.span("train", machines=1):
            torch.ones(64, 64) @ torch.ones(64, 64)
    written = profiling.LAST_PROFILE
    assert written["label"] == "batched-build" and written["bytes"] > 0
    assert written["path"].startswith(str(tmp_path / "batched-build"))
    with open(written["path"]) as fh:
        names = {event.get("name") for event in json.load(fh)["traceEvents"]}
    assert "train" in names
    assert written["kernels"] == {}  # nothing ran on a card


def test_device_trace_reports_and_refuses_a_second_session(tmp_path, monkeypatch):
    monkeypatch.setenv("GORDO_TPU_PROFILE_DIR", str(tmp_path))
    trace = profiler.device_trace(0.1)
    assert "error" not in trace, trace
    assert trace["files"] == 1 and trace["bytes"] > 0 and trace["kernels"] == {}
    assert trace["dir"] == str(tmp_path / "device_trace")
    again = profiler.device_trace(0.1)  # its own file's size, not the directory's
    assert again["files"] == 1 and again["bytes"] == os.path.getsize(again["path"])
    with profiling.SESSION_LOCK:
        busy = profiler.device_trace(0.1)
        with profiling.maybe_profile("skipped"):
            pass
    assert sorted(busy) == ["dir", "error"] and busy["dir"] == str(tmp_path)
    assert not (tmp_path / "skipped").exists()


def test_burst_names_the_registered_thread(monkeypatch):
    monkeypatch.setenv("GORDO_TPU_DEBUG_ENDPOINTS", "1")
    profiler.reset()
    stop = threading.Event()

    def hot():
        profiler.register_thread("gordo-batcher")
        while not stop.is_set():
            sum(range(200))

    worker = threading.Thread(target=hot, daemon=True)
    worker.start()
    try:
        time.sleep(0.05)
        counter = profiler.burst(0.2, hz=200)
    finally:
        stop.set()
        worker.join(5)
        profiler.reset()
    assert any(line.startswith("gordo-batcher;") for line in counter.collapsed())
