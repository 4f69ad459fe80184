"""
The flight recorder: always-on tail sampling of interesting request traces.

A metrics dashboard says *that* p99 spiked; the flight recorder keeps the
evidence — complete span trees for the requests that were actually bad —
in a bounded in-process ring buffer, readable after the fact through
``GET /debug/flight`` (gated by ``GORDO_TPU_DEBUG_ENDPOINTS``). Head
sampling (record 1-in-N) would almost never catch a rare bad request;
tail sampling decides *after* the response, when the verdict is known.

A trace is kept when the request:

- **errored** — any 4xx/5xx, which covers shed 503s, deadline 504s,
  breaker fast-fails, and plain server errors; or
- **was slow** — wall time above ``GORDO_TPU_FLIGHT_SLOW_S`` when set,
  else above an adaptive p99-ish threshold learned from the last
  ``_SAMPLE_WINDOW`` request durations (with a small floor so an idle
  server doesn't record everything).

Errored and slow traces live in *separate* rings (half the capacity
each): a flood of slow-but-successful requests can never evict the
errored exemplars, which are usually the ones an operator is hunting.
Ring occupancy and recording rates are exported as
``gordo_server_flight_*`` metrics (observability/metrics.py). The port's
copy of ``gordo_tpu/observability/flight.py``.
"""

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import metrics as metric_catalog
from .tracing import RequestTrace

DEFAULT_CAPACITY = 64
# adaptive thresholding: p99-ish over a sliding window of durations,
# never below the floor (an idle server's "p99" is meaninglessly small)
_SAMPLE_WINDOW = 512
_MIN_SAMPLES = 50
_ADAPTIVE_FLOOR_S = 0.25
_EVENT_CAPACITY = 16


def capacity_from_env() -> int:
    raw = os.environ.get("GORDO_TPU_FLIGHT_CAPACITY")
    if not raw:
        return DEFAULT_CAPACITY
    try:
        return max(2, int(raw))
    except ValueError:
        return DEFAULT_CAPACITY


def recent_capacity_from_env(default: int = 0) -> int:
    """Size of the optional *recent* ring (``GORDO_TPU_FLIGHT_RECENT``):
    every observed trace is kept there regardless of the tail-sampling
    verdict, so ``find()`` can resolve a trace id that was neither
    errored nor slow — what cross-node stitching and metric exemplars
    need. 0 (the default for serving nodes) disables it; the gateway's
    recorder defaults it on, since it only observes opted-in traces."""
    raw = os.environ.get("GORDO_TPU_FLIGHT_RECENT")
    if not raw:
        return default
    try:
        return max(0, int(raw))
    except ValueError:
        return default


def slow_threshold_env_s() -> Optional[float]:
    """The explicit slow knob (seconds), or None → adaptive."""
    raw = os.environ.get("GORDO_TPU_FLIGHT_SLOW_S")
    if not raw:
        return None
    try:
        value = float(raw)
    except ValueError:
        return None
    return value if value > 0 else None


class FlightRecorder:
    """Bounded ring of kept traces; all methods thread-safe."""

    def __init__(
        self, capacity: Optional[int] = None, recent: Optional[int] = None
    ):
        capacity = capacity if capacity is not None else capacity_from_env()
        recent = recent if recent is not None else recent_capacity_from_env()
        error_cap = max(1, capacity // 2)
        self._lock = threading.Lock()
        self._errors: "deque[Dict[str, Any]]" = deque(maxlen=error_cap)
        self._slow: "deque[Dict[str, Any]]" = deque(
            maxlen=max(1, capacity - error_cap)
        )
        self._recent: Optional["deque[Dict[str, Any]]"] = (
            deque(maxlen=recent) if recent > 0 else None
        )
        self._durations: "deque[float]" = deque(maxlen=_SAMPLE_WINDOW)
        # out-of-band events (perf-sentinel fires, etc.): small bounded
        # ring, never evicted by request traces
        self._events: "deque[Dict[str, Any]]" = deque(maxlen=_EVENT_CAPACITY)
        self._t0 = time.monotonic()
        self.seen = 0
        self.kept = 0

    # ------------------------------------------------------------ policy
    def slow_threshold_s(self) -> float:
        """Current slow cutoff: the env knob, or adaptive ~p99 of recent
        durations (inf until enough samples — no slow verdicts from a
        cold start)."""
        explicit = slow_threshold_env_s()
        if explicit is not None:
            return explicit
        with self._lock:
            samples = sorted(self._durations)
        if len(samples) < _MIN_SAMPLES:
            return float("inf")
        p99 = samples[min(len(samples) - 1, int(len(samples) * 0.99))]
        return max(p99, _ADAPTIVE_FLOOR_S)

    def classify(self, status: int, duration_s: float) -> Optional[str]:
        if status >= 400:
            return "error"
        if duration_s >= self.slow_threshold_s():
            return "slow"
        return None

    # ----------------------------------------------------------- record
    def observe(
        self,
        trace: Optional[RequestTrace],
        status: int,
        duration_s: float,
        endpoint: str = "",
        model: str = "",
    ) -> Optional[str]:
        """Consider one finished request; returns the kept class
        ("error"/"slow") or None when the trace was not interesting."""
        self.seen += 1
        verdict = self.classify(status, duration_s)
        # the duration sample is recorded AFTER classification so a storm
        # of slow requests keeps being classified against the window that
        # called the first ones slow (the threshold adapts, but one
        # request never raises the bar for itself)
        with self._lock:
            self._durations.append(duration_s)
        if trace is None or (verdict is None and self._recent is None):
            return None
        record = {
            "trace_id": trace.trace_id,
            "class": verdict or "recent",
            "status": int(status),
            "endpoint": endpoint,
            "model": model,
            "duration_s": float(duration_s),
            "recorded_at": time.time(),
            "dropped_spans": trace.dropped,
            "spans": [s.to_dict() for s in trace.snapshot()],
        }
        if self._recent is not None:
            with self._lock:
                self._recent.append(record)
        if verdict is None:
            return None
        ring = self._errors if verdict == "error" else self._slow
        with self._lock:
            ring.append(record)
            self.kept += 1
            n_err, n_slow = len(self._errors), len(self._slow)
        metric_catalog.FLIGHT_RECORDED.labels(cls=verdict).inc()
        metric_catalog.FLIGHT_OCCUPANCY.labels(cls="error").set(n_err)
        metric_catalog.FLIGHT_OCCUPANCY.labels(cls="slow").set(n_slow)
        return verdict

    def find(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Newest kept record for ``trace_id`` — the tail-sampled rings
        first, then the recent ring. None when the id was never kept."""
        with self._lock:
            rings = [list(self._errors), list(self._slow)]
            if self._recent is not None:
                rings.append(list(self._recent))
        for ring in rings:
            for record in reversed(ring):
                if record["trace_id"] == trace_id:
                    return record
        return None

    def record_event(self, kind: str, payload: Dict[str, Any]) -> None:
        """Attach an out-of-band event (e.g. a perf-sentinel fire with
        its attribution snapshot and stack evidence) to the recorder so
        /debug/flight carries it alongside the request traces."""
        record = {
            "kind": str(kind),
            "recorded_at": time.time(),
            "payload": payload,
        }
        with self._lock:
            self._events.append(record)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def worst_trace(self) -> Optional[Dict[str, Any]]:
        """The slowest kept trace (any class), or None when empty."""
        with self._lock:
            records = list(self._errors) + list(self._slow)
        if not records:
            return None
        return max(records, key=lambda r: r["duration_s"])

    # ------------------------------------------------------------ export
    def snapshot(self) -> List[Dict[str, Any]]:
        """Kept traces, oldest first, errors and slow interleaved by
        recording time."""
        with self._lock:
            records = list(self._errors) + list(self._slow)
        return sorted(records, key=lambda r: r["recorded_at"])

    def chrome_trace(
        self, trace_id: Optional[str] = None
    ) -> Optional[Dict[str, Any]]:
        """The ring as one Chrome trace-event JSON document (open in
        Perfetto / ``chrome://tracing``): each kept request's spans on its
        originating thread lanes, trace/span ids and span-links in args.
        A ``gordoFlight`` sidecar lists the per-trace summaries (status,
        class, duration) so the document is greppable without a UI.

        With ``trace_id`` the document is filtered to that one trace —
        the shape cross-node stitching fetches — and None is returned
        when the recorder never kept it."""
        if trace_id is not None:
            record = self.find(trace_id)
            if record is None:
                return None
            records = [record]
        else:
            records = self.snapshot()
        events: List[Dict[str, Any]] = []
        for record in records:
            for span in record["spans"]:
                args = {
                    "trace_id": span["trace_id"],
                    "span_id": span["span_id"],
                    "parent_span_id": span.get("parent_id") or "",
                }
                for key, value in (span.get("attrs") or {}).items():
                    args.setdefault(key, value)
                links = span.get("links") or []
                if links:
                    args["links"] = ",".join(
                        f"{l['trace_id']}:{l['span_id']}" for l in links
                    )
                events.append(
                    {
                        "name": span["name"],
                        "cat": "gordo_flight",
                        "ph": "X",
                        "ts": max(0.0, (span["start"] - self._t0) * 1e6),
                        "dur": span["duration_s"] * 1e6,
                        "pid": os.getpid(),
                        "tid": span["thread"],
                        "args": args,
                    }
                )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "gordo_tpu_torch.observability.flight",
                "seen": self.seen,
                "kept": self.kept,
                "slowThresholdSeconds": self.slow_threshold_s(),
            },
            "gordoFlight": [
                {k: v for k, v in record.items() if k != "spans"}
                for record in records
            ],
            "gordoEvents": self.events() if trace_id is None else [],
        }

    def reset(self) -> None:
        with self._lock:
            self._errors.clear()
            self._slow.clear()
            if self._recent is not None:
                self._recent.clear()
            self._durations.clear()
            self._events.clear()
            self.seen = 0
            self.kept = 0


_recorder_lock = threading.Lock()
_recorder: Optional[FlightRecorder] = None


def default_recorder() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def reset() -> None:
    """Tests: drop the process recorder (capacity knobs re-read on next
    use)."""
    global _recorder
    with _recorder_lock:
        _recorder = None
