"""
Request-scoped trace context: the correlation layer under every span, the
port's copy of ``gordo_tpu/observability/tracing.py``.

A ``TraceContext`` (a W3C-style ``trace_id``/``span_id`` pair and an
optional per-request collector) rides a ``contextvars.ContextVar``, so every
:func:`telemetry.span` opened below the request's dispatch joins the
request's span tree. The context crosses a thread only when carried:
:func:`capture` at a queue's enqueue side, :func:`attach` (or
:func:`record_into`) at the dequeue side. The serving batcher
(server/batcher.py) correlates one fused device call with the requests
riding it this way: a span-link to every rider, not a reparenting.

The wire format is W3C Trace Context (``traceparent:
00-<32 hex trace-id>-<16 hex span-id>-<2 hex flags>``): the server
(server/server.py) continues an inbound one and answers every request with
the trace id in ``X-Gordo-Trace``, so a caller can quote the trace an
operator pulls from ``/debug/flight`` or the JSON logs.

Standard library only; outside a request the cost is one ContextVar read.
"""

import contextlib
import contextvars
import os
import re
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "TraceContext",
    "RequestTrace",
    "SpanRecord",
    "current",
    "current_trace_id",
    "current_span_id",
    "new_trace_id",
    "new_span_id",
    "parse_traceparent",
    "format_traceparent",
    "request_root",
    "fresh_context",
    "capture",
    "attach",
    "record_into",
    "root_for",
    "reset_roots",
]

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)
_ALL_ZERO_TRACE = "0" * 32
_ALL_ZERO_SPAN = "0" * 16


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


class SpanRecord:
    """One finished span of a request's tree (immutable once recorded)."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id",
        "start", "duration", "attrs", "links", "thread",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        span_id: str,
        parent_id: Optional[str],
        start: float,
        duration: float,
        attrs: Optional[Dict[str, Any]] = None,
        links: Sequence[Tuple[str, str]] = (),
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.duration = duration
        self.attrs = dict(attrs) if attrs else {}
        # (trace_id, span_id) pairs of correlated-but-not-parented spans
        # (the fused device call's other riders)
        self.links = tuple(links)
        self.thread = threading.get_ident()

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "duration_s": self.duration,
            "thread": self.thread,
        }
        if self.attrs:
            out["attrs"] = {k: str(v) for k, v in self.attrs.items()}
        if self.links:
            out["links"] = [
                {"trace_id": t, "span_id": s} for t, s in self.links
            ]
        return out


class RequestTrace:
    """Span-tree collector for one request. Thread-safe and bounded: the
    batcher dispatcher appends the device-call span from its own thread
    while the request thread appends phases, and a runaway instrumented
    loop must cap at dropped spans, not an unbounded list."""

    MAX_SPANS = 256

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self._lock = threading.Lock()
        self._spans: List[SpanRecord] = []
        self.dropped = 0

    def add(self, record: SpanRecord) -> None:
        with self._lock:
            if len(self._spans) >= self.MAX_SPANS:
                self.dropped += 1
                return
            self._spans.append(record)

    def snapshot(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


class TraceContext:
    """The ambient (trace_id, span_id) a new span parents under, plus the
    request's collector (None for contexts that only correlate — e.g. the
    per-machine build roots, whose spans land in the global trace buffer)."""

    __slots__ = ("trace_id", "span_id", "collector")

    def __init__(
        self,
        trace_id: str,
        span_id: Optional[str] = None,
        collector: Optional[RequestTrace] = None,
    ):
        self.trace_id = trace_id
        self.span_id = span_id
        self.collector = collector

    def child(self, span_id: str) -> "TraceContext":
        return TraceContext(self.trace_id, span_id, self.collector)


_current: "contextvars.ContextVar[Optional[TraceContext]]" = (
    contextvars.ContextVar("gordo_tpu_torch_trace", default=None)
)


def current() -> Optional[TraceContext]:
    return _current.get()


def current_trace_id() -> Optional[str]:
    ctx = _current.get()
    return ctx.trace_id if ctx is not None else None


def current_span_id() -> Optional[str]:
    ctx = _current.get()
    return ctx.span_id if ctx is not None else None


# ------------------------------------------------------- W3C trace context
def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """``(trace_id, parent_span_id)`` from a ``traceparent`` header, or
    None when absent/malformed (a malformed header must never fail the
    request — the trace just starts fresh here)."""
    if not header:
        return None
    match = _TRACEPARENT_RE.match(header.strip().lower())
    if not match:
        return None
    _version, trace_id, span_id, _flags = match.groups()
    if trace_id == _ALL_ZERO_TRACE or span_id == _ALL_ZERO_SPAN:
        return None  # all-zero ids are invalid per the W3C spec
    return trace_id, span_id


def format_traceparent(ctx: TraceContext) -> str:
    """The outbound ``traceparent`` for this context (sampled flag set —
    everything we propagate we are willing to record)."""
    return f"00-{ctx.trace_id}-{ctx.span_id or new_span_id()}-01"


# ----------------------------------------------------------- context scopes
def push_child(ctx: TraceContext, span_id: str) -> "contextvars.Token":
    """Make ``span_id`` the ambient parent (telemetry._Span enter)."""
    return _current.set(ctx.child(span_id))


def pop(token: "contextvars.Token") -> None:
    _current.reset(token)


@contextlib.contextmanager
def request_root(
    traceparent: Optional[str] = None, collect: bool = True
) -> Iterator[TraceContext]:
    """Establish a request's root context: continue the inbound
    ``traceparent`` when present (same trace_id, remote span as parent),
    mint a fresh trace otherwise. Spans opened inside land in the yielded
    context's collector."""
    parsed = parse_traceparent(traceparent)
    if parsed is not None:
        trace_id, parent_span = parsed
    else:
        trace_id, parent_span = new_trace_id(), None
    collector = RequestTrace(trace_id) if collect else None
    ctx = TraceContext(trace_id, parent_span, collector)
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def fresh_context(collect: bool = False) -> TraceContext:
    """A brand-new root context (client-side outbound calls with no
    surrounding trace)."""
    collector = None
    trace_id = new_trace_id()
    if collect:
        collector = RequestTrace(trace_id)
    return TraceContext(trace_id, new_span_id(), collector)


def capture() -> Optional[TraceContext]:
    """The current context, for carrying across a queue/thread hop."""
    return _current.get()


@contextlib.contextmanager
def attach(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Re-establish a captured context in another thread (or a fresh
    scope in the same one). ``attach(None)`` is a no-op scope."""
    if ctx is None:
        yield None
        return
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def record_into(
    ctx: TraceContext,
    name: str,
    start: float,
    duration: float,
    links: Sequence[Tuple[str, str]] = (),
    **attrs: Any,
) -> Optional[SpanRecord]:
    """Record one finished span directly into ``ctx``'s trace, parented
    under its capture point — the dequeue-side half of a queue hop, where
    the work ran in a thread that never held the request's context (the
    batcher's fused device call, fanned into every rider's tree)."""
    if ctx is None or ctx.collector is None:
        return None
    record = SpanRecord(
        name,
        ctx.trace_id,
        new_span_id(),
        ctx.span_id,
        start,
        duration,
        attrs=attrs,
        links=links,
    )
    ctx.collector.add(record)
    return record


# ------------------------------------------------------- build-side roots
# fresh root per machine for fleet builds: all of one machine's spans
# (fetch → validate → assemble → serialize, across phases and thread-pool
# lanes) share a trace_id in the exported Chrome trace, so Perfetto's
# args filter isolates a single machine out of a 10k-machine build
_roots_lock = threading.Lock()
_roots: Dict[str, TraceContext] = {}
_ROOTS_MAX = 4096


def root_for(key: str) -> TraceContext:
    """The (memoized) root context for one logical work unit — e.g. a
    machine name in ``batch-build``. Same key → same trace_id, so spans
    recorded at different build phases correlate."""
    with _roots_lock:
        ctx = _roots.get(key)
        if ctx is None:
            if len(_roots) >= _ROOTS_MAX:
                _roots.clear()
            ctx = _roots[key] = TraceContext(new_trace_id(), new_span_id())
        return ctx


def reset_roots() -> None:
    """Tests: forget the per-key build roots."""
    with _roots_lock:
        _roots.clear()


def monotonic() -> float:
    """The clock every span start/duration uses (one definition, so the
    flight recorder and Chrome exports agree)."""
    return time.monotonic()
