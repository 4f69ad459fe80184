"""
Per-model SLOs: rolling multi-window latency/error tracking + burn rates.

Podracer-shape serving (PAPERS.md) means one serving plane watching
thousands of models; "is the fleet healthy" is a per-model question the
raw request counters can't answer. This module keeps, per model, two
rolling windows (5m and 1h) of request latencies (a
:class:`~.latency.LatencyHistogram` per sub-window,
so tail quantiles are measurement-grade) and error/slow counts, and
derives **burn rates** against configurable objectives:

- ``GORDO_TPU_SLO_P99_MS`` — the latency objective: at most 1% of
  requests may exceed this (i.e. "p99 <= objective"). The latency burn
  rate is ``slow_fraction / 0.01``: 1.0 means the window is consuming
  budget exactly as fast as allowed, >1 means the p99 objective is being
  missed, 14.4 is the classic "page now" multi-window threshold.
- ``GORDO_TPU_SLO_ERROR_BUDGET`` — the allowed 5xx fraction (default
  0.01). Error burn rate is ``error_fraction / budget``.

Sub-windows are keyed by absolute epoch index (``time // width``), so
every worker's rings align and the fleet view merges exactly: counts sum,
histograms fold through :meth:`LatencyHistogram.merge`. The tracker ships
its state in the telemetry shard's ``extras["slo"]`` section
(:mod:`.shared`) and refreshes the ``gordo_server_slo_*`` gauges before
every shard flush; ``/debug/slo`` (server/debug.py) reports both the
local and the merged fleet view.

Every lane of the port's server (its own handler and both fast lanes)
feeds :func:`record` for the two prediction routes through
``server.observe_request_outcome``; this module is the port's copy of
``gordo_tpu/observability/slo.py``.
"""

import os
import threading
import time
from typing import Any, Dict, List, Tuple

from .latency import LatencyHistogram

__all__ = [
    "record",
    "snapshot",
    "shard_payload",
    "merge_payloads",
    "refresh_gauges",
    "objectives",
    "reset",
    "WINDOWS",
]

# (window label, total span seconds, sub-window count). Sub-window width =
# span / count; coarse enough that a shard payload stays small, fine
# enough that the window rolls smoothly.
WINDOWS: Tuple[Tuple[str, float, int], ...] = (
    ("5m", 300.0, 10),
    ("1h", 3600.0, 12),
)

# the latency objective is a p99: at most this fraction may be slow
_SLOW_BUDGET = 0.01

# bounded model cardinality: the fleet is finite, but a scanner must not
# mint unbounded tracker state — overflow coalesces into one bucket
_MAX_MODELS = 1024
_OVERFLOW = "_other"

_SUBBUCKETS = 32  # coarser than the load harness: shards ship these as JSON


def objectives() -> Dict[str, float]:
    """The configured objectives (defaults keep /debug/slo meaningful out
    of the box: 250ms p99, 1% error budget)."""
    try:
        p99_ms = float(os.environ.get("GORDO_TPU_SLO_P99_MS", "250"))
    except ValueError:
        p99_ms = 250.0
    try:
        error_budget = float(
            os.environ.get("GORDO_TPU_SLO_ERROR_BUDGET", "0.01")
        )
    except ValueError:
        error_budget = 0.01
    return {
        "p99_ms": p99_ms,
        "error_budget": max(error_budget, 1e-9),
        "slow_budget": _SLOW_BUDGET,
    }


class _SubWindow:
    __slots__ = ("total", "errors", "slow", "hist")

    def __init__(self):
        self.total = 0
        self.errors = 0
        self.slow = 0
        self.hist = LatencyHistogram(subbuckets=_SUBBUCKETS)


class _Tracker:
    """Rolling per-model multi-window state. One lock: records are a dict
    lookup + histogram record, far off any device-call critical path."""

    def __init__(self):
        self._lock = threading.Lock()
        # {model: {window_label: {subwindow_index: _SubWindow}}}
        self._models: Dict[str, Dict[str, Dict[int, _SubWindow]]] = {}

    def record(self, model: str, duration_s: float, status: int) -> None:
        now = time.time()
        slow_cut = objectives()["p99_ms"] / 1000.0
        error = int(status) >= 500
        slow = duration_s > slow_cut
        with self._lock:
            if model not in self._models and len(self._models) >= _MAX_MODELS:
                model = _OVERFLOW
            windows = self._models.setdefault(model, {})
            for label, span, count in WINDOWS:
                width = span / count
                index = int(now // width)
                ring = windows.setdefault(label, {})
                sub = ring.get(index)
                if sub is None:
                    sub = ring[index] = _SubWindow()
                    # expire sub-windows that rolled out of the span
                    horizon = index - count
                    for old in [i for i in ring if i <= horizon]:
                        del ring[old]
                sub.total += 1
                sub.errors += error
                sub.slow += slow
                sub.hist.record(duration_s)

    # ----------------------------------------------------------- summaries
    def _live(self, ring: Dict[int, _SubWindow], span: float, count: int,
              now: float) -> List[_SubWindow]:
        width = span / count
        horizon = int(now // width) - count
        return [sub for index, sub in ring.items() if index > horizon]

    def snapshot(self) -> Dict[str, Any]:
        """Per-model per-window summary of this process's tracker."""
        now = time.time()
        obj = objectives()
        out: Dict[str, Any] = {}
        with self._lock:
            items = [
                (model, {
                    label: self._live(
                        windows.get(label, {}), span, count, now
                    )
                    for label, span, count in WINDOWS
                })
                for model, windows in self._models.items()
            ]
        for model, windows in items:
            out[model] = {
                label: _summarize(subs, obj)
                for label, subs in windows.items()
            }
        return {"objectives": obj, "models": out}

    def shard_payload(self) -> Dict[str, Any]:
        """JSON-able state for the telemetry shard: per model/window the
        live sub-windows as ``[index, total, errors, slow, hist_dict]``."""
        now = time.time()
        payload: Dict[str, Any] = {}
        with self._lock:
            for model, windows in self._models.items():
                model_out: Dict[str, Any] = {}
                for label, span, count in WINDOWS:
                    width = span / count
                    horizon = int(now // width) - count
                    rows = [
                        [index, sub.total, sub.errors, sub.slow,
                         sub.hist.to_dict()]
                        for index, sub in sorted(
                            windows.get(label, {}).items()
                        )
                        if index > horizon
                    ]
                    if rows:
                        model_out[label] = rows
                if model_out:
                    payload[model] = model_out
        return payload

    def reset(self) -> None:
        with self._lock:
            self._models.clear()


def _summarize(subs: List[_SubWindow], obj: Dict[str, float]) -> Dict[str, Any]:
    total = sum(sub.total for sub in subs)
    errors = sum(sub.errors for sub in subs)
    slow = sum(sub.slow for sub in subs)
    merged = LatencyHistogram.merged(
        (sub.hist for sub in subs), subbuckets=_SUBBUCKETS
    )
    return _window_summary(total, errors, slow, merged, obj)


def _window_summary(
    total: int, errors: int, slow: int, hist: LatencyHistogram,
    obj: Dict[str, float],
) -> Dict[str, Any]:
    p99 = hist.quantile(0.99)
    p50 = hist.quantile(0.50)
    error_rate = (errors / total) if total else 0.0
    slow_rate = (slow / total) if total else 0.0
    return {
        "requests": total,
        "errors": errors,
        "slow": slow,
        "p50_ms": round(p50 * 1000.0, 3) if p50 is not None else None,
        "p99_ms": round(p99 * 1000.0, 3) if p99 is not None else None,
        "error_rate": error_rate,
        "slow_rate": slow_rate,
        "error_burn_rate": error_rate / obj["error_budget"],
        "latency_burn_rate": slow_rate / obj["slow_budget"],
    }


_tracker = _Tracker()


def record(model: str, duration_s: float, status: int) -> None:
    """Record one request outcome for ``model`` (both serving lanes)."""
    if not model:
        return
    try:
        _tracker.record(str(model), float(duration_s), int(status))
    except Exception:  # noqa: BLE001 — observability must not fail requests
        pass


def snapshot() -> Dict[str, Any]:
    return _tracker.snapshot()


def shard_payload() -> Dict[str, Any]:
    return _tracker.shard_payload()


def merge_payloads(
    payloads: List[Tuple[int, Dict[str, Any]]],
) -> Dict[str, Any]:
    """Fleet view: fold every worker's shard payload (``(pid, payload)``
    pairs from shared.fleet_extras) into one per-model summary. Counts sum
    and histograms merge because sub-window indices are epoch-aligned
    across processes."""
    obj = objectives()
    acc: Dict[str, Dict[str, List[Any]]] = {}
    for _pid, payload in payloads:
        if not isinstance(payload, dict):
            continue
        for model, windows in payload.items():
            model_acc = acc.setdefault(model, {})
            for label, rows in windows.items():
                state = model_acc.setdefault(
                    label,
                    [0, 0, 0, LatencyHistogram(subbuckets=_SUBBUCKETS)],
                )
                for row in rows:
                    try:
                        _index, total, errors, slow, hist_dict = row
                        hist = LatencyHistogram.from_dict(hist_dict)
                    except (ValueError, TypeError, KeyError):
                        continue
                    state[0] += int(total)
                    state[1] += int(errors)
                    state[2] += int(slow)
                    if hist.subbuckets == state[3].subbuckets:
                        state[3].merge(hist)
    models = {
        model: {
            label: _window_summary(
                state[0], state[1], state[2], state[3], obj
            )
            for label, state in windows.items()
        }
        for model, windows in acc.items()
    }
    return {
        "objectives": obj,
        "workers": len(payloads),
        "models": models,
    }


def refresh_gauges() -> None:
    """Mirror the local tracker into the ``gordo_server_slo_*`` gauges
    (shard-flush sampler + /metrics scrape refresh)."""
    from . import metrics as metric_catalog

    snap = snapshot()
    for model, windows in snap["models"].items():
        for label, summary in windows.items():
            labels = {"model": model, "window": label}
            metric_catalog.SLO_REQUESTS.labels(**labels).set(
                summary["requests"]
            )
            if summary["p99_ms"] is not None:
                metric_catalog.SLO_P99_MS.labels(**labels).set(
                    summary["p99_ms"]
                )
            metric_catalog.SLO_ERROR_BURN.labels(**labels).set(
                summary["error_burn_rate"]
            )
            metric_catalog.SLO_LATENCY_BURN.labels(**labels).set(
                summary["latency_burn_rate"]
            )


def install_shard_hooks() -> None:
    """Register the tracker with the shared-telemetry shard machinery:
    gauges refresh before every flush and the window state rides the
    shard's ``extras["slo"]`` section."""
    from . import shared

    shared.register_sampler(refresh_gauges)
    shared.register_extra("slo", shard_payload)


def reset() -> None:
    _tracker.reset()
