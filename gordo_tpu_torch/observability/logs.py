"""
Structured, trace-correlated logging.

``GORDO_TPU_LOG_FORMAT=json`` switches every process log line to one
JSON object per line — machine-parseable by fleet log pipelines (Loki,
Cloud Logging, `jq`), and stamped with the active request's
``trace_id``/``span_id`` from :mod:`.tracing` (the port's copy of
``gordo_tpu/observability/logs.py``, with the same keys).
That stamp is what closes the loop between the three telemetry surfaces:
a slow request's ``X-Gordo-Trace`` header names the trace, ``/debug/flight``
shows its span tree, and a ``grep trace_id=<id>`` over the logs finds every
warning the same request emitted on the way through.

The trace ids are attached by a :class:`logging.Filter` at emit time (in
the emitting thread, where the contextvar is correct), not by the
formatter — an async/queued handler formatting in another thread would
otherwise stamp the wrong request's ids.

Default format stays the plain human one: with the knob unset this
module changes nothing (``maybe_configure`` is a no-op).
"""

import json
import logging
import os
import time
from typing import Any, Dict, Optional

from . import tracing

__all__ = [
    "TraceContextFilter",
    "JsonLogFormatter",
    "json_logs_enabled",
    "maybe_configure",
]


def json_logs_enabled() -> bool:
    return os.environ.get("GORDO_TPU_LOG_FORMAT", "").strip().lower() == "json"


class TraceContextFilter(logging.Filter):
    """Stamp the emitting thread's trace/span ids onto every record (empty
    strings outside a request — the fields are always present, so log
    pipelines can index them unconditionally)."""

    def filter(self, record: logging.LogRecord) -> bool:
        ctx = tracing.current()
        record.trace_id = ctx.trace_id if ctx is not None else ""
        record.span_id = (ctx.span_id or "") if ctx is not None else ""
        return True


class JsonLogFormatter(logging.Formatter):
    """One JSON object per line: ts (ISO-8601 UTC), level, logger, message,
    trace/span ids when present, exception text when attached."""

    def format(self, record: logging.LogRecord) -> str:
        payload: Dict[str, Any] = {
            "ts": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)
            )
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        trace_id = getattr(record, "trace_id", "")
        if trace_id:
            payload["trace_id"] = trace_id
            span_id = getattr(record, "span_id", "")
            if span_id:
                payload["span_id"] = span_id
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        # default=str: a log line must never raise out of the handler over
        # an unserializable arg — logs are the diagnosis channel itself
        return json.dumps(payload, default=str)


def maybe_configure(level: Optional[int] = None) -> bool:
    """Install JSON formatting (+ trace filter) on the root logger's
    handlers when ``GORDO_TPU_LOG_FORMAT=json``; returns whether it did.
    Creates a stream handler if the root has none yet. Idempotent."""
    if not json_logs_enabled():
        return False
    root = logging.getLogger()
    if not root.handlers:
        root.addHandler(logging.StreamHandler())
    for handler in root.handlers:
        if not any(
            isinstance(f, TraceContextFilter) for f in handler.filters
        ):
            handler.addFilter(TraceContextFilter())
        handler.setFormatter(JsonLogFormatter())
    if level is not None:
        root.setLevel(level)
    return True
