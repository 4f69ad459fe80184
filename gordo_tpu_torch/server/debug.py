"""
Read-only introspection endpoints, the operator's first stop on a pager:
the port's counterpart of ``gordo_tpu/server/debug.py``.

Every route is gated by ``GORDO_TPU_DEBUG_ENDPOINTS=1`` (or ``true``,
``yes``): without it each answers 404 exactly as an unknown path does, so a
production server exposes nothing new by default.

- ``GET /debug/flight``: the flight recorder's kept request traces as
  Chrome trace-event JSON (observability/flight.py), with the
  ``gordoFlight`` sidecar of per-trace summaries and a ``gordoProfile``
  sidecar (the worst kept trace beside the steady profiler's stacks);
  ``?trace=<id>`` filters to that one trace, 404 when it was never kept.
- ``GET /debug/vars``: every telemetry series' current value, the
  batcher's counters, the device block (observability/device.py: duty
  cycle, online MFU, param banks, memory), the fleet view of the shards
  and the flight recorder's census, as JSON.
- ``GET /debug/config``: the ``GORDO_TPU_*`` knobs as set (values whose
  name suggests a secret redacted) and the effective values of the serving
  knobs the port has.
- ``GET /debug/slo``: per-model rolling-window latency and error summaries
  with burn rates (observability/slo.py), this process's and, with
  ``GORDO_TPU_TELEMETRY_DIR`` shards, the fleet's.
- ``GET /debug/profile``: a burst capture of the registered hot threads
  (observability/profiler.py) for ``seconds`` at ``hz``, as collapsed
  stacks (``format=json``, the default, or ``collapsed``) or a Chrome trace
  (``format=chrome``); ``steady=1`` returns the steady sampler's view
  instead; ``device=1`` runs an on-demand ``torch.profiler`` device trace
  and reports its files and the CUDA kernels it recorded.

``/debug/perf`` (the latency attribution and perf sentinel, A8's second
part), ``/debug/drift`` and ``/debug/prewarm`` (A9) answer 404 until their
ROADMAP.md items land. The resilience block of ``/debug/vars`` and
``/debug/config`` waits for A9 as well; its keys are here, null where the
port has no such knob (the drain is the fast lane's flag until then).
"""

import os
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs

from ..observability import flight, telemetry
from .views import json_text

# substrings that mark a knob's VALUE as sensitive — never echo those
# through an HTTP endpoint, even a gated one
_SECRET_MARKERS = ("PASSWORD", "SECRET", "TOKEN", "KEY", "CREDENTIAL")

# the ported routes, by path (the JAX server's endpoint names)
ROUTES = {
    "/debug/flight": "debug_flight",
    "/debug/vars": "debug_vars",
    "/debug/config": "debug_config",
    "/debug/slo": "debug_slo",
    "/debug/profile": "debug_profile",
}

Answer = Tuple[int, str, bytes]


def enabled() -> bool:
    return os.environ.get("GORDO_TPU_DEBUG_ENDPOINTS", "").lower() in ("1", "true", "yes")


def _json(payload: Dict[str, Any], status: int = 200) -> Answer:
    # non-finite floats as null, as the JAX routes' simplejson writes them
    return status, "application/json", json_text(payload).encode()


def dispatch(endpoint: str, query: str = "") -> Optional[Answer]:
    """``(status, content type, body)`` of one ``debug_*`` endpoint with its
    query string; None when the gate is off (the caller answers its 404 for
    an unknown path)."""
    if not enabled():
        return None
    args = {name: values[0] for name, values in parse_qs(query, keep_blank_values=True).items()}
    if endpoint == "debug_flight":
        return flight_view(args)
    if endpoint == "debug_vars":
        return vars_view()
    if endpoint == "debug_slo":
        return slo_view()
    if endpoint == "debug_profile":
        return profile_view(args)
    return config_view()


# -------------------------------------------------------------- /debug/flight
def flight_view(args: Dict[str, str]) -> Answer:
    from ..observability import profiler

    trace_id = args.get("trace")
    recorder = flight.default_recorder()
    if trace_id:
        payload = recorder.chrome_trace(trace_id)
        if payload is None:
            return _json({"error": "trace not kept", "trace_id": trace_id}, status=404)
        return _json(payload)
    payload = recorder.chrome_trace()
    worst = recorder.worst_trace()
    payload["gordoProfile"] = {
        "worst_trace": None if worst is None else {
            "trace_id": worst["trace_id"],
            "class": worst["class"],
            "duration_s": worst["duration_s"],
            "endpoint": worst["endpoint"],
        },
        "profile": profiler.snapshot(top=20),
    }
    return _json(payload)


# ------------------------------------------------------------- /debug/profile
def _float_arg(args: Dict[str, str], name: str, default: float) -> float:
    try:
        return float(args.get(name, default))
    except (TypeError, ValueError):
        return default


def profile_view(args: Dict[str, str]) -> Answer:
    """A burst capture, the steady view, or a device trace (see the module
    docstring). A burst runs in the handling thread: the other threads keep
    serving while it samples them."""
    from ..observability import profiler

    if args.get("device") in ("1", "true"):
        return _json({"device_trace": profiler.device_trace(_float_arg(args, "seconds", 2.0))})
    fmt = args.get("format", "json")
    if args.get("steady") in ("1", "true"):
        counter = profiler.steady_counter()
    else:
        counter = profiler.burst(_float_arg(args, "seconds", 2.0),
                                 hz=_float_arg(args, "hz", profiler.DEFAULT_HZ))
    if fmt == "collapsed":
        return 200, "text/plain", ("\n".join(counter.collapsed()) + "\n").encode()
    if fmt == "chrome":
        return _json(counter.chrome_trace(profiler.steady_hz() or profiler.DEFAULT_HZ))
    payload = counter.to_dict(top=100)
    payload["steady"] = profiler.snapshot(top=0)
    return _json(payload)


# ---------------------------------------------------------------- /debug/vars
def vars_view() -> Answer:
    metrics: Dict[str, Any] = {}
    for metric in telemetry.default_registry().collect():
        series = []
        for key, value in metric.snapshot():
            labels = dict(zip(metric.labelnames, key))
            if metric.kind == "histogram":
                counts, total = value
                series.append({"labels": labels, "count": sum(counts), "sum": total})
            else:
                series.append({"labels": labels, "value": value})
        metrics[metric.name] = {"kind": metric.kind, "series": series}

    from ..observability import device, shared
    from .batcher import peek_batcher
    from .fastlane import is_draining

    batcher = peek_batcher()
    recorder = flight.default_recorder()
    return _json({
        "metrics": metrics,
        "server": {"inflight_requests": None, "gated_inflight": None, "draining": is_draining(),
                   "project": os.environ.get("PROJECT")},
        "batcher": None if batcher is None else dict(batcher.stats),
        "warmup": None,
        "device": device.snapshot(),
        "fleet": shared.fleet_vars(),
        "flight": {"seen": recorder.seen, "kept": recorder.kept,
                   "slow_threshold_s": recorder.slow_threshold_s()},
    })


# ----------------------------------------------------------------- /debug/slo
def slo_view() -> Answer:
    from ..observability import shared, slo

    payload: Dict[str, Any] = {"local": slo.snapshot()}
    if shared.enabled():
        # flush first so the answering process's own windows are in the merge
        shared.flush(force=True)
        payload["fleet"] = slo.merge_payloads(shared.fleet_extras("slo"))
    return _json(payload)


# -------------------------------------------------------------- /debug/config
def _redact(name: str, value: str) -> str:
    if any(marker in name.upper() for marker in _SECRET_MARKERS):
        return "<redacted>"
    return value


def config_view() -> Answer:
    """The knobs as this process resolved them: every ``GORDO_TPU_*``
    variable that is set, and the effective values of the serving knobs."""
    env = {name: _redact(name, value) for name, value in sorted(os.environ.items())
           if name.startswith("GORDO_TPU_")}
    resolved = {
        "max_inflight": None,
        "retry_after_s": None,
        "deadline_ms_default": None,
        "breaker_threshold": None,
        "drain_budget_s": None,
        "watchdog_threshold_s": None,
        "validate_output": False,
        "flight_capacity": flight.capacity_from_env(),
        "flight_slow_s": flight.default_recorder().slow_threshold_s(),
        "debug_endpoints": enabled(),
        "log_format": os.environ.get("GORDO_TPU_LOG_FORMAT", "plain"),
        "serving_batch": os.environ.get("GORDO_TPU_SERVING_BATCH", "off"),
        "fast_codec": os.environ.get("GORDO_TPU_FAST_CODEC", "1"),
    }
    return _json({"env": env, "resolved": resolved})
