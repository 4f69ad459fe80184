"""
Serving resilience: admission control, request deadlines, per-model circuit
breakers, graceful drain, a device watchdog and an output guard. The port's
copy of ``gordo_tpu/server/resilience.py``, by the same names and knobs.

- **Admission control**: ``GORDO_TPU_MAX_INFLIGHT`` bounds the prediction
  requests in flight; past it a request is shed with a fast 503 and
  ``Retry-After`` (``GORDO_TPU_RETRY_AFTER_S``) instead of queueing behind
  the card.
- **Deadlines**: a request's budget is its ``X-Gordo-Deadline-Ms`` header,
  else ``GORDO_TPU_DEADLINE_MS``. The budget is checked before the predict
  (``preflight``) and bounds the wait in the cross-model batcher's queue
  (``queue_wait``): a waiter that runs out marks its item abandoned, the
  dispatcher skips it at fan-out (a fused call already launched on the
  card is not taken back), and the client gets a 504.
- **Circuit breakers**: ``GORDO_TPU_BREAKER_THRESHOLD`` consecutive
  predict or load failures of one model open its breaker, and its requests
  fast-fail 503 until ``GORDO_TPU_BREAKER_COOLDOWN_S`` has passed; then one
  probe is let through. A permanent-class fault (util/faults.py: a corrupt
  artifact, a non-finite output) opens it at once.
- **Drain**: on SIGTERM a worker stops accepting, finishes its requests in
  flight within ``GORDO_TPU_DRAIN_S``, and exits (server/server.py).
- **Device watchdog**: when the batcher's dispatcher has been inside one
  device call past ``GORDO_TPU_WATCHDOG_S`` (its host-clock reading
  ``device_call_stuck_s``), ``/healthcheck`` answers 503.
- **Output guard**: ``GORDO_TPU_VALIDATE_OUTPUT=1`` turns a non-finite
  model output into a ``NonFiniteDataError`` (500, and the breaker counts
  it); in the batcher it is checked per rider of a fused call, on the host
  copy the dispatcher already waits for, so a poisoned model fails alone.

Every knob defaults off: with none set, every lane answers as it did
without this module. The transport-free route table (server/server.py) and
the views call these functions, so the default lane and both fast lanes
behave alike. Feeds ``gordo_server_shed_total``,
``gordo_server_deadline_exceeded_total``,
``gordo_server_breaker_{state,opens_total,fast_failures_total}`` and
``gordo_server_watchdog_trips_total``.
"""


import contextlib
import logging
import math
import os
import threading
import time
from typing import Any, Dict, Optional

from ..observability import metrics as metric_catalog
from ..util import faults

logger = logging.getLogger(__name__)


class DeadlineExceeded(TimeoutError):
    """The request's deadline budget ran out (queue-wait included)."""


# --------------------------------------------------------------- env helpers
def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("invalid %s=%r; using %r", name, raw, default)
        return default


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "yes")


# ---------------------------------------------------------- request context
class _RequestState(threading.local):
    """Per-thread request scope: the model being served and the monotonic
    deadline, readable from anywhere below the dispatch (the batcher's
    submit path has no request argument to thread them through)."""

    model: Optional[str] = None
    deadline_at: Optional[float] = None


_state = _RequestState()


@contextlib.contextmanager
def request_scope(model: Optional[str] = None, deadline_ms: Optional[float] = None):
    """Establish the request's model tag and deadline for this thread."""
    prev = (_state.model, _state.deadline_at)
    _state.model = model
    _state.deadline_at = (
        time.monotonic() + deadline_ms / 1e3 if deadline_ms else None
    )
    try:
        yield
    finally:
        _state.model, _state.deadline_at = prev


def current_model() -> Optional[str]:
    return _state.model


def remaining_s() -> Optional[float]:
    """Seconds left in this request's budget; None when no deadline."""
    deadline_at = _state.deadline_at
    if deadline_at is None:
        return None
    return deadline_at - time.monotonic()


def check_deadline(where: str) -> None:
    """Raise :class:`DeadlineExceeded` when the budget is already spent."""
    remaining = remaining_s()
    if remaining is not None and remaining <= 0:
        metric_catalog.SERVER_DEADLINE_EXCEEDED.labels(where=where).inc()
        raise DeadlineExceeded(
            f"request deadline exceeded ({where}, "
            f"{-remaining * 1e3:.0f}ms over budget)"
        )


def record_deadline_exceeded(where: str) -> None:
    metric_catalog.SERVER_DEADLINE_EXCEEDED.labels(where=where).inc()


def deadline_ms_from(headers) -> Optional[float]:
    """The request's deadline budget: ``X-Gordo-Deadline-Ms`` header, or
    the ``GORDO_TPU_DEADLINE_MS`` env default. None = no deadline (the
    pre-resilience behavior). A malformed value is ignored, not a 400 —
    a client bug must not take down its own requests."""
    raw = headers.get("X-Gordo-Deadline-Ms") or os.environ.get(
        "GORDO_TPU_DEADLINE_MS"
    )
    if not raw:
        return None
    try:
        ms = float(raw)
    except (TypeError, ValueError):
        logger.warning("ignoring malformed deadline %r", raw)
        return None
    return ms if ms > 0 else None


# ----------------------------------------------------------- admission gate
# gated-section concurrency (prediction routes only) for load shedding, and
# a separate all-requests counter for drain (healthcheck probes etc. must
# not be shed, but a drain must still wait for them)
_gate_lock = threading.Lock()
_gated_inflight = 0
_total_inflight = 0


def max_inflight() -> int:
    """0 = unbounded (the default: admission control off)."""
    return int(_env_float("GORDO_TPU_MAX_INFLIGHT", 0))


def retry_after_s() -> float:
    return max(0.0, _env_float("GORDO_TPU_RETRY_AFTER_S", 1.0))


def try_admit() -> Optional[Dict[str, Any]]:
    """Admit one prediction request, or return shed info for a 503.

    Callers MUST call :func:`release` exactly once after an admit (None
    return); a shed return holds no slot."""
    global _gated_inflight
    limit = max_inflight()
    with _gate_lock:
        if limit > 0 and _gated_inflight >= limit:
            metric_catalog.SERVER_SHED.labels(reason="max_inflight").inc()
            return {
                "error": "server overloaded: in-flight request limit "
                f"reached ({limit})",
                "reason": "max_inflight",
                "retry-after-seconds": retry_after_s(),
            }
        _gated_inflight += 1
    return None


def release() -> None:
    global _gated_inflight
    with _gate_lock:
        _gated_inflight -= 1


def gated_inflight() -> int:
    with _gate_lock:
        return _gated_inflight


# ------------------------------------------------------- drain (in-flight)
_draining = threading.Event()


def request_started() -> None:
    global _total_inflight
    with _gate_lock:
        _total_inflight += 1


def request_finished() -> None:
    global _total_inflight
    with _gate_lock:
        _total_inflight -= 1


def inflight_requests() -> int:
    with _gate_lock:
        return _total_inflight


def drain_budget_s() -> float:
    return _env_float("GORDO_TPU_DRAIN_S", 30.0)


def begin_drain() -> bool:
    """Mark the process draining; True only for the first caller."""
    if _draining.is_set():
        return False
    _draining.set()
    return True


def is_draining() -> bool:
    return _draining.is_set()


def wait_drained(budget_s: Optional[float] = None, poll_s: float = 0.05) -> bool:
    """Block until every in-flight request finished, or the drain budget
    ran out. Returns True when fully drained."""
    if budget_s is None:
        budget_s = drain_budget_s()
    deadline = time.monotonic() + max(0.0, budget_s)
    while time.monotonic() < deadline:
        if inflight_requests() <= 0:
            return True
        time.sleep(poll_s)
    leftover = inflight_requests()
    if leftover > 0:
        logger.warning(
            "drain budget (%.1fs) exhausted with %d request(s) still "
            "in flight", budget_s, leftover,
        )
    return leftover <= 0


# --------------------------------------------------------- circuit breaker
CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half-open", OPEN: "open"}


class CircuitBreaker:
    """Per-model breaker over consecutive predict/load failures.

    Fault classification is shared with the build side (util/faults.py):
    a permanent-class failure (corrupt artifact, non-finite output) opens
    the breaker immediately — no retry will clear it until the artifact
    changes; transient-class failures must repeat ``threshold`` times.
    An open breaker answers 503 without touching the model; after
    ``cooldown_s`` it goes half-open and admits exactly one probe, whose
    outcome closes or re-opens it.
    """

    def __init__(self, model: str, threshold: int, cooldown_s: float):
        self.model = model
        self.threshold = max(1, threshold)
        self.cooldown_s = max(0.0, cooldown_s)
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False
        # when the in-flight probe was admitted: a probe whose thread dies
        # without ever reporting (killed worker, lost connection) must not
        # wedge the breaker half-open forever — after a further cooldown
        # the probe lease expires and allow() admits a replacement
        self._probe_started_at = 0.0

    # ------------------------------------------------------------- public
    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def allow(self) -> Optional[Dict[str, Any]]:
        """None = proceed; otherwise info for the fast-fail 503."""
        with self._lock:
            if self._state == CLOSED:
                return None
            now = time.monotonic()
            if self._state == OPEN and now - self._opened_at >= self.cooldown_s:
                self._set_state(HALF_OPEN)
                self._probing = True
                self._probe_started_at = now
                return None  # this caller is the probe
            if self._state == HALF_OPEN and not self._probing:
                self._probing = True
                self._probe_started_at = now
                return None
            if (
                self._state == HALF_OPEN
                and self._probing
                and now - self._probe_started_at >= self.cooldown_s
            ):
                # probe lease expired: the admitted probe never reported
                # back (its thread died mid-call) — admit one replacement
                # per elapsed cooldown instead of fast-failing forever
                self._probe_started_at = now
                return None
            remaining = max(0.0, self.cooldown_s - (now - self._opened_at))
            metric_catalog.BREAKER_FAST_FAILURES.labels(model=self.model).inc()
            return {
                "error": f"circuit breaker open for model '{self.model}' "
                f"({self._consecutive} consecutive failure(s))",
                "model": self.model,
                "retry-after-seconds": remaining,
            }

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._probing = False
            if self._state != CLOSED:
                logger.info(
                    "circuit breaker for model '%s' closed (probe "
                    "succeeded)", self.model,
                )
            self._set_state(CLOSED)

    def record_failure(self, exc: BaseException) -> None:
        with self._lock:
            self._probing = False
            self._consecutive += 1
            permanent = not faults.is_transient(exc)
            if permanent or self._consecutive >= self.threshold:
                if self._state != OPEN:
                    metric_catalog.BREAKER_OPENS.labels(model=self.model).inc()
                    logger.warning(
                        "circuit breaker for model '%s' OPEN after %d "
                        "consecutive failure(s) (%s: %s); cooling down "
                        "%.1fs", self.model, self._consecutive,
                        "permanent" if permanent else "transient",
                        exc, self.cooldown_s,
                    )
                self._set_state(OPEN)
                self._opened_at = time.monotonic()

    # ------------------------------------------------------------ internal
    def _set_state(self, state: int) -> None:
        self._state = state
        metric_catalog.BREAKER_STATE.labels(model=self.model).set(state)


_breakers: Dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker_threshold() -> int:
    """0 (the default) = circuit breakers disabled."""
    return int(_env_float("GORDO_TPU_BREAKER_THRESHOLD", 0))


def breaker_for(model: str) -> Optional[CircuitBreaker]:
    """The model's breaker, or None when breakers are disabled."""
    threshold = breaker_threshold()
    if threshold <= 0:
        return None
    with _breakers_lock:
        breaker = _breakers.get(model)
        if breaker is None:
            breaker = _breakers[model] = CircuitBreaker(
                model,
                threshold=threshold,
                cooldown_s=_env_float("GORDO_TPU_BREAKER_COOLDOWN_S", 30.0),
            )
        return breaker


def record_breaker_failure(breaker: Optional[CircuitBreaker], exc: BaseException):
    if breaker is not None:
        breaker.record_failure(exc)


def record_breaker_success(breaker: Optional[CircuitBreaker]):
    if breaker is not None:
        breaker.record_success()


def breaker_retry_after_header(info: Dict[str, Any]) -> str:
    return str(int(math.ceil(info.get("retry-after-seconds", 0.0))))


def reset_breakers() -> None:
    """Forget every breaker (tests)."""
    with _breakers_lock:
        _breakers.clear()


# ------------------------------------------------------------ output guard
def validate_output_enabled() -> bool:
    return _env_flag("GORDO_TPU_VALIDATE_OUTPUT")


def check_output_finite(output, model: str) -> None:
    """Raise a permanent-class fault when a model output carries NaN/Inf
    (only when ``GORDO_TPU_VALIDATE_OUTPUT`` is on — the default path
    serves whatever the model produced, as before)."""
    if not validate_output_enabled():
        return
    import numpy as np

    arr = np.asarray(output)
    if np.issubdtype(arr.dtype, np.floating) and not np.all(np.isfinite(arr)):
        n_bad = int(arr.size - np.count_nonzero(np.isfinite(arr)))
        raise faults.NonFiniteDataError(
            f"model '{model}' produced {n_bad} non-finite output value(s)"
        )


# --------------------------------------------------------- device watchdog
def watchdog_threshold_s() -> float:
    """0 (the default) = watchdog disabled."""
    return _env_float("GORDO_TPU_WATCHDOG_S", 0.0)


def stuck_device_call_s() -> Optional[float]:
    """Seconds the batcher dispatcher has been stuck inside one device
    call, when that exceeds the watchdog threshold; None = healthy (or
    watchdog disabled). Peeks only — never creates a batcher."""
    threshold = watchdog_threshold_s()
    if threshold <= 0:
        return None
    from .batcher import peek_batcher

    batcher = peek_batcher()
    if batcher is None:
        return None
    stuck = batcher.device_call_stuck_s()
    if stuck <= threshold:
        return None
    metric_catalog.WATCHDOG_TRIPS.inc()
    return stuck


# ----------------------------------------------------------------- testing
def reset_for_tests() -> None:
    """Zero the process-wide gate/drain/breaker state between tests."""
    global _gated_inflight, _total_inflight
    with _gate_lock:
        _gated_inflight = 0
        _total_inflight = 0
    _draining.clear()
    reset_breakers()
