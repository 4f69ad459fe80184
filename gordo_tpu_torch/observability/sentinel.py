"""
Online perf-regression sentinel: a CUSUM over the server's own per-phase
latencies. The port's copy of ``gordo_tpu/observability/sentinel.py``.

Per phase (decode, predict, encode, the derived in-server remainder
``server_other``, and the request's ``total``) it keeps:

- a **frozen baseline**: mean and standard deviation of the first
  ``GORDO_TPU_PERF_SENTINEL_MIN_SAMPLES`` observations after the process
  starts (Welford), the post-warm-up steady state;
- a **one-sided CUSUM** over baseline-standardised latencies,
  ``s = max(0, s + z - 0.5)``: a persistent slowdown accumulates, zero-mean
  jitter drains back to 0.

When a phase's CUSUM crosses ``GORDO_TPU_PERF_SENTINEL_THRESHOLD``,
``gordo_server_perf_regression_total{phase}`` increments and ONE event is
recorded into the flight recorder with the evidence: the attribution
snapshot (attribution.py: which phase moved, by how much, against which
window) and the steady profiler's top collapsed stacks at fire time. A
fired phase stays silent until ``GORDO_TPU_PERF_SENTINEL_COOLDOWN_S``
elapses, then re-arms with a cleared statistic: a still-regressed server
pages at most once a cooldown.

Gated behind ``GORDO_TPU_PERF_SENTINEL`` (default off): with the gate
closed :func:`observe_phases` returns before taking the lock. Feeds
``gordo_server_perf_sentinel_cusum`` on telemetry flushes.
"""


import logging
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import metrics as metric_catalog

logger = logging.getLogger(__name__)

# same slack as drift.py: sub-half-sigma deviations drain the statistic
_CUSUM_SLACK = 0.5

# the phase space is closed (ctx.phase names plus the two derived
# series), so no overflow bucket is needed — unknown names are dropped
_PHASES = ("decode", "predict", "encode", "server_other", "total")


def enabled() -> bool:
    return os.environ.get("GORDO_TPU_PERF_SENTINEL", "").lower() in (
        "1", "true", "yes",
    )


def threshold() -> float:
    try:
        return float(
            os.environ.get("GORDO_TPU_PERF_SENTINEL_THRESHOLD", "8.0")
        )
    except ValueError:
        return 8.0


def min_samples() -> int:
    try:
        return max(
            2,
            int(os.environ.get(
                "GORDO_TPU_PERF_SENTINEL_MIN_SAMPLES", "200"
            )),
        )
    except ValueError:
        return 200


def cooldown_s() -> float:
    try:
        return float(
            os.environ.get("GORDO_TPU_PERF_SENTINEL_COOLDOWN_S", "300")
        )
    except ValueError:
        return 300.0


class _PhaseState:
    __slots__ = (
        "n", "mean", "m2", "std", "cusum", "status", "last_event_ts",
        "events",
    )

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.std = 0.0
        self.cusum = 0.0
        self.status = "baseline"  # baseline -> ok -> regressed
        self.last_event_ts = 0.0
        self.events = 0


_lock = threading.Lock()
_states: Dict[str, _PhaseState] = {}


def _observe_one(
    phase: str, value: float, now: float
) -> Optional[Dict[str, Any]]:
    """CUSUM update for one phase; returns the fire payload when this
    observation tripped the detector. Caller holds ``_lock``."""
    state = _states.get(phase)
    if state is None:
        state = _states.setdefault(phase, _PhaseState())

    if state.status == "baseline":
        state.n += 1
        delta = value - state.mean
        state.mean += delta / state.n
        state.m2 += delta * (value - state.mean)
        if state.n >= min_samples():
            variance = state.m2 / max(1, state.n - 1)
            state.std = math.sqrt(max(variance, 0.0))
            state.status = "ok"
        return None

    if state.status == "regressed":
        # hysteresis: silent until the cooldown re-arms the alarm
        if now - state.last_event_ts < cooldown_s():
            return None
        state.status = "ok"
        state.cusum = 0.0

    sigma = state.std if state.std > 1e-12 else 1e-12
    z = (value - state.mean) / sigma
    state.cusum = max(0.0, state.cusum + z - _CUSUM_SLACK)
    if state.cusum < threshold():
        return None
    state.status = "regressed"
    state.last_event_ts = now
    state.events += 1
    state.cusum = 0.0
    return {
        "phase": phase,
        "detected_at": now,
        "baseline_mean_ms": state.mean * 1000.0,
        "baseline_std_ms": state.std * 1000.0,
        "observed_ms": value * 1000.0,
        "baseline_n": state.n,
    }


def observe_phases(
    total_s: float,
    phases: Optional[Dict[str, float]],
    now: Optional[float] = None,
) -> List[str]:
    """Feed one finished request's timings to every phase detector;
    returns the phases that fired. No-op (before the lock) unless the
    ``GORDO_TPU_PERF_SENTINEL`` gate is open."""
    if not enabled():
        return []
    if now is None:
        now = time.time()
    series: Dict[str, float] = {}
    measured = 0.0
    for name, value in (phases or {}).items():
        if name in _PHASES and isinstance(value, (int, float)) \
                and math.isfinite(value):
            series[name] = float(value)
            measured += float(value)
    if isinstance(total_s, (int, float)) and math.isfinite(total_s):
        series["total"] = float(total_s)
        if series and "total" in series and measured and len(series) > 1:
            series["server_other"] = max(float(total_s) - measured, 0.0)
    if not series:
        return []
    fired: List[Dict[str, Any]] = []
    with _lock:
        for phase, value in series.items():
            payload = _observe_one(phase, value, now)
            if payload is not None:
                fired.append(payload)
    for payload in fired:
        _emit_event(payload)
    return [payload["phase"] for payload in fired]


def _emit_event(payload: Dict[str, Any]) -> None:
    """Count the regression and attach the evidence bundle — the
    attribution snapshot plus the profiler's top stacks at fire time —
    to the flight recorder. Best-effort: a failing emission must never
    fail the request that happened to trip the detector."""
    phase = payload["phase"]
    try:
        metric_catalog.PERF_REGRESSIONS.labels(phase=phase).inc()
        from . import attribution, flight, profiler

        payload = dict(payload)
        payload["attribution"] = attribution.snapshot()
        payload["top_stacks"] = profiler.top_stacks(10)
        flight.default_recorder().record_event(
            "perf_regression", payload
        )
        logger.warning(
            "perf sentinel: phase %s regressed (observed %.3f ms vs "
            "baseline %.3f±%.3f ms over %d samples)",
            phase, payload["observed_ms"], payload["baseline_mean_ms"],
            payload["baseline_std_ms"], payload["baseline_n"],
        )
    except Exception as exc:  # noqa: BLE001 — detection is advisory
        logger.warning(
            "perf sentinel: event emission for %s failed: %s", phase, exc
        )


def regressed_phases() -> List[str]:
    with _lock:
        return sorted(
            name for name, state in _states.items()
            if state.status == "regressed"
        )


def snapshot() -> Dict[str, Any]:
    """Per-phase detector state for /debug/perf and tests."""
    out: Dict[str, Any] = {"enabled": enabled()}
    phases: Dict[str, Any] = {}
    with _lock:
        for name, state in _states.items():
            phases[name] = {
                "status": state.status,
                "baseline_n": state.n,
                "baseline_mean_ms": state.mean * 1000.0,
                "baseline_std_ms": state.std * 1000.0,
                "cusum": state.cusum,
                "events": state.events,
            }
            metric_catalog.SENTINEL_CUSUM.labels(phase=name).set(
                state.cusum
            )
    out["phases"] = phases
    return out


def refresh_gauges() -> None:
    with _lock:
        for name, state in _states.items():
            metric_catalog.SENTINEL_CUSUM.labels(phase=name).set(
                state.cusum
            )


_hooks_installed = False


def install_shard_hooks() -> None:
    """Idempotent: export the CUSUM gauges on telemetry flushes. The
    sentinel itself is per-process by design — each worker watches its
    own latencies — so there is no cross-shard payload to merge."""
    global _hooks_installed
    if _hooks_installed:
        return
    _hooks_installed = True
    from . import shared

    shared.register_sampler(refresh_gauges)


def reset() -> None:
    """Test hook: drop every phase state."""
    with _lock:
        _states.clear()
