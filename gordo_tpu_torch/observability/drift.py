"""
Online drift detection for the serving fleet, the *detect* quarter of the
self-healing loop: the port's copy of ``gordo_tpu/observability/drift.py``,
with its knobs, its states and its shard payload, so that a JAX worker's
shard and a port worker's merge into one fleet view.

Every prediction records one scalar per request: the model's
reconstruction-error statistic (``server/views.py`` computes it in both the
base and the anomaly cores, on every lane). This module keeps, per model
name:

- a **frozen baseline**: mean and std of the first
  ``GORDO_TPU_DRIFT_MIN_SAMPLES`` observations (Welford, so shard payloads
  merge exactly);
- a **one-sided CUSUM** over baseline-standardized deviations
  ``s = max(0, s + z - k)`` with slack ``k = 0.5``: a persistent upward
  shift in reconstruction error accumulates, while zero-mean noise drains
  back to 0;
- **epoch-aligned rolling sub-windows** (the ``slo.py`` layout: keyed by
  ``int(now // width)`` so merging worker shards is exact addition) of
  count, sum and sum of squares covering the last
  ``GORDO_TPU_DRIFT_WINDOW_S`` seconds.

When the CUSUM crosses ``GORDO_TPU_DRIFT_THRESHOLD`` (sigma units) the
model turns ``drifted`` and ONE drift event is emitted:
``gordo_server_drift_events_total`` counts it and, when
``GORDO_TPU_DRIFT_QUEUE_DIR`` is set, a rebuild request is enqueued through
:mod:`gordo_tpu_torch.parallel.drift_queue` (O_EXCL request files, so N
workers observing the same drift still enqueue one rebuild). The
``drift_detect`` and ``drift_enqueue`` fault sites (util/faults.py) fire in
the emission, which never fails the request that tripped it.

Hysteresis: a drifted model emits no further events until either the loop
closes (the hot swap, server/hotswap.py, calls :func:`note_rebuilt`, which
resets the baseline so the rebuilt model's scores recalibrate) or
``GORDO_TPU_DRIFT_COOLDOWN_S`` elapses with no rebuild (the alarm re-arms).

Everything is gated behind ``GORDO_TPU_DRIFT_DETECT`` (default off): with
the gate closed :func:`observe` returns before taking the lock.
"""

import logging
import math
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..util import faults
from . import metrics as metric_catalog

logger = logging.getLogger(__name__)

# CUSUM slack, in baseline sigmas: deviations below k/2 sigma drain the
# statistic instead of feeding it (standard tuning for ~1-sigma shifts)
_CUSUM_SLACK = 0.5

# epoch-aligned sub-window width; count derives from the window knob
_SUBWINDOW_S = 300.0

# same cardinality guard as slo.py: an unbounded model-name space (fuzzed
# request paths) must not grow the tracker without limit
_MAX_MODELS = 1024
_OVERFLOW = "_other"


def enabled() -> bool:
    return os.environ.get("GORDO_TPU_DRIFT_DETECT", "").lower() in (
        "1", "true", "yes",
    )


def threshold() -> float:
    try:
        return float(os.environ.get("GORDO_TPU_DRIFT_THRESHOLD", "4.0"))
    except ValueError:
        return 4.0


def min_samples() -> int:
    try:
        return max(2, int(os.environ.get("GORDO_TPU_DRIFT_MIN_SAMPLES", "60")))
    except ValueError:
        return 60


def window_s() -> float:
    try:
        return float(os.environ.get("GORDO_TPU_DRIFT_WINDOW_S", "3600"))
    except ValueError:
        return 3600.0


def cooldown_s() -> float:
    try:
        return float(os.environ.get("GORDO_TPU_DRIFT_COOLDOWN_S", "1800"))
    except ValueError:
        return 1800.0


def queue_dir() -> Optional[str]:
    return os.environ.get("GORDO_TPU_DRIFT_QUEUE_DIR") or None


class _ModelState:
    __slots__ = (
        "n", "mean", "m2", "std", "cusum", "status", "last_event_ts",
        "events", "windows",
    )

    def __init__(self):
        self.n = 0               # Welford baseline arm
        self.mean = 0.0
        self.m2 = 0.0
        self.std = 0.0           # frozen at baseline completion
        self.cusum = 0.0
        self.status = "baseline"  # baseline -> ok -> drifted
        self.last_event_ts = 0.0
        self.events = 0
        # epoch-aligned sub-windows: index -> [count, total, sumsq]
        self.windows: Dict[int, List[float]] = {}


class _Tracker:
    def __init__(self):
        self.lock = threading.Lock()
        self.states: Dict[str, _ModelState] = {}

    def state_for(self, model: str) -> _ModelState:
        state = self.states.get(model)
        if state is None:
            if len(self.states) >= _MAX_MODELS and model not in self.states:
                model = _OVERFLOW
                state = self.states.get(model)
                if state is not None:
                    return state
            state = self.states.setdefault(model, _ModelState())
        return state

    def reset(self):
        with self.lock:
            self.states.clear()


_tracker = _Tracker()


def _expire_windows(state: _ModelState, index: int, count: int) -> None:
    horizon = index - count
    for old in [i for i in state.windows if i <= horizon]:
        del state.windows[old]


def _recent(state: _ModelState) -> Tuple[int, float, float]:
    """(count, mean, variance*count) over the live sub-windows."""
    count = 0
    total = 0.0
    sumsq = 0.0
    for c, t, s2 in state.windows.values():
        count += int(c)
        total += t
        sumsq += s2
    mean = total / count if count else 0.0
    return count, mean, sumsq


def observe(model: str, value: float, now: Optional[float] = None) -> bool:
    """Record one reconstruction-error observation; True iff this call
    emitted a drift event. No-op (before the lock) unless the
    ``GORDO_TPU_DRIFT_DETECT`` gate is open."""
    if not enabled():
        return False
    if value is None or not math.isfinite(value):
        return False
    value = float(value)
    if now is None:
        now = time.time()
    index = int(now // _SUBWINDOW_S)
    n_windows = max(2, int(math.ceil(window_s() / _SUBWINDOW_S)))
    fired = False
    with _tracker.lock:
        state = _tracker.state_for(model)
        row = state.windows.setdefault(index, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += value
        row[2] += value * value
        _expire_windows(state, index, n_windows)

        if state.status == "baseline":
            state.n += 1
            delta = value - state.mean
            state.mean += delta / state.n
            state.m2 += delta * (value - state.mean)
            if state.n >= min_samples():
                variance = state.m2 / max(1, state.n - 1)
                state.std = math.sqrt(max(variance, 0.0))
                state.status = "ok"
            return False

        if state.status == "drifted":
            # hysteresis: silent until rebuilt, or cooldown re-arms
            if now - state.last_event_ts < cooldown_s():
                return False
            state.status = "ok"
            state.cusum = 0.0

        sigma = state.std if state.std > 1e-12 else 1e-12
        z = (value - state.mean) / sigma
        state.cusum = max(0.0, state.cusum + z - _CUSUM_SLACK)
        if state.cusum >= threshold():
            state.status = "drifted"
            state.last_event_ts = now
            state.events += 1
            state.cusum = 0.0
            fired = True
            recent_count, recent_mean, _ = _recent(state)
            payload = {
                "machine": model,
                "detected_at": now,
                "baseline_mean": state.mean,
                "baseline_std": state.std,
                "recent_mean": recent_mean,
                "recent_count": recent_count,
            }
    if fired:
        _emit_event(model, payload)
    return fired


def _emit_event(model: str, payload: Dict[str, Any]) -> None:
    """Count the event and (queue dir set) enqueue ONE rebuild request.
    Best-effort: a failing emission must never fail the serving request
    that happened to trip the detector."""
    try:
        faults.fault_point("drift_detect", machine=model)
        metric_catalog.DRIFT_EVENTS.labels(model=model).inc()
        directory = queue_dir()
        if directory:
            from ..parallel import drift_queue

            if drift_queue.enqueue(directory, model, payload):
                logger.info(
                    "drift: model %s drifted (recent mean %.4g vs baseline "
                    "%.4g±%.4g over %d samples) — rebuild request enqueued",
                    model, payload["recent_mean"], payload["baseline_mean"],
                    payload["baseline_std"], payload["recent_count"],
                )
            else:
                logger.info(
                    "drift: model %s drifted — rebuild already pending "
                    "(deduplicated)", model,
                )
        else:
            logger.info("drift: model %s drifted (no queue dir; event "
                        "counted only)", model)
    except Exception as exc:  # noqa: BLE001 — detection is advisory
        logger.warning("drift: event emission for %s failed: %s", model, exc)


def note_rebuilt(model: str) -> None:
    """Close the loop: the hot-swap path installed a rebuilt artifact, so
    drop the old baseline — the new model's scores recalibrate from
    scratch instead of being judged against the stale distribution."""
    with _tracker.lock:
        if model in _tracker.states:
            _tracker.states[model] = _ModelState()


def drifted_models() -> List[str]:
    with _tracker.lock:
        return sorted(
            name for name, state in _tracker.states.items()
            if state.status == "drifted"
        )


def snapshot() -> Dict[str, Any]:
    """Per-model detector state for /debug/drift and tests."""
    out: Dict[str, Any] = {}
    with _tracker.lock:
        for name, state in _tracker.states.items():
            count, mean, sumsq = _recent(state)
            out[name] = {
                "status": state.status,
                "baseline_n": state.n,
                "baseline_mean": state.mean,
                "baseline_std": state.std,
                "cusum": state.cusum,
                "events": state.events,
                "recent_count": count,
                "recent_mean": mean,
            }
    return out


# ----------------------------------------------------------- fleet merge
def shard_payload() -> Dict[str, Any]:
    """This worker's contribution to the fleet drift view: per model, the
    epoch-aligned sub-window rows plus the Welford baseline triple —
    both merge exactly (addition / Chan's parallel variance)."""
    payload: Dict[str, Any] = {}
    with _tracker.lock:
        for name, state in _tracker.states.items():
            payload[name] = {
                "windows": {
                    str(i): list(row) for i, row in state.windows.items()
                },
                "baseline": [state.n, state.mean, state.m2],
                "events": state.events,
                "status": state.status,
            }
    return payload


def merge_payloads(
    pairs: Iterable[Tuple[int, Dict[str, Any]]]
) -> Dict[str, Any]:
    """Fleet merge over ``(pid, payload)`` shard pairs. Epoch-aligned
    windows sum exactly; a reaped shard simply drops out of the sum (its
    rows vanish, nothing is zeroed or double-counted; tested in
    tests/test_torch_drift.py)."""
    merged: Dict[str, Any] = {}
    for _pid, payload in pairs:
        if not isinstance(payload, dict):
            continue
        for name, row in payload.items():
            if not isinstance(row, dict):
                continue
            slot = merged.setdefault(
                name,
                {"windows": {}, "baseline": [0, 0.0, 0.0], "events": 0,
                 "drifted_workers": 0},
            )
            for idx, win in (row.get("windows") or {}).items():
                agg = slot["windows"].setdefault(str(idx), [0, 0.0, 0.0])
                agg[0] += int(win[0])
                agg[1] += float(win[1])
                agg[2] += float(win[2])
            base = row.get("baseline") or [0, 0.0, 0.0]
            slot["baseline"] = _merge_welford(slot["baseline"], base)
            slot["events"] += int(row.get("events") or 0)
            if row.get("status") == "drifted":
                slot["drifted_workers"] += 1
    for slot in merged.values():
        count = sum(int(w[0]) for w in slot["windows"].values())
        total = sum(float(w[1]) for w in slot["windows"].values())
        slot["recent_count"] = count
        slot["recent_mean"] = total / count if count else 0.0
    return merged


def _merge_welford(a: List[float], b) -> List[float]:
    """Chan's parallel combination of two (n, mean, M2) triples."""
    n_a, mean_a, m2_a = int(a[0]), float(a[1]), float(a[2])
    n_b, mean_b, m2_b = int(b[0]), float(b[1]), float(b[2])
    if n_a == 0:
        return [n_b, mean_b, m2_b]
    if n_b == 0:
        return [n_a, mean_a, m2_a]
    n = n_a + n_b
    delta = mean_b - mean_a
    mean = mean_a + delta * n_b / n
    m2 = m2_a + m2_b + delta * delta * n_a * n_b / n
    return [n, mean, m2]


# ----------------------------------------------------------- shard hooks
def refresh_gauges() -> None:
    metric_catalog.DRIFTED_MODELS.set(len(drifted_models()))
    directory = queue_dir()
    if directory:
        from ..parallel import drift_queue

        try:
            metric_catalog.DRIFT_QUEUE_DEPTH.set(
                drift_queue.depth(directory)
            )
        except OSError:
            pass


def install_shard_hooks() -> None:
    """Ride the telemetry-shard flush as slo.py does: the gauges refresh
    before every flush and the payload rides ``extras["drift"]`` (no-ops
    until ``GORDO_TPU_TELEMETRY_DIR`` enables shards). Idempotent: each
    server start registers again, after any reset of the shard machinery."""
    from . import shared

    shared.register_sampler(refresh_gauges)
    shared.register_extra("drift", shard_payload)


def reset() -> None:
    """Test hook: drop every model state."""
    _tracker.reset()
