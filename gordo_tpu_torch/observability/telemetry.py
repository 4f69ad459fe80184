"""
Dependency-light telemetry runtime: spans, metrics and exporters, the
port's copy of ``gordo_tpu/observability/telemetry.py``.

- :func:`span`: a thread-safe context manager over monotonic clocks. Spans
  are recorded as Chrome trace events (openable in Perfetto or
  ``chrome://tracing``) while a trace is active, mirrored into the
  ``torch.profiler`` trace through ``torch.profiler.record_function``
  (:func:`gordo_tpu_torch.util.profiling.annotate`) while
  ``$GORDO_TPU_PROFILE_DIR`` profiling is on, joined to the request's tree
  under a request trace context, and optionally observed into a duration
  histogram. When none of these is on, ``span()`` returns one shared no-op
  singleton: the disabled path allocates nothing and times nothing.
- :class:`MetricsRegistry`: a process-local counter/gauge/histogram
  registry that needs no ``prometheus_client``.
  Counters and histograms always record (a float add under a lock: they
  are incremented from fault paths and the serving batcher, where an
  "enabled" gate would lose exactly the events worth counting).
- Exporters: :func:`write_trace` (Chrome trace-event JSON) and
  :meth:`MetricsRegistry.render_text` / :meth:`MetricsRegistry.write_textfile`
  (Prometheus text exposition 0.0.4). The JAX package's
  ``prometheus_bridge`` is not ported: the port's server renders this
  registry itself (server/prometheus/metrics.py).

Metric naming contract: every metric name carries a ``gordo_`` prefix and
non-empty help text.

>>> reg = MetricsRegistry()
>>> c = reg.counter("gordo_demo_total", "demo counter", ("kind",))
>>> c.labels(kind="a").inc()
>>> c.labels(kind="a").inc(2)
>>> 'gordo_demo_total{kind="a"} 3.0' in reg.render_text()
True
"""

import json
import math
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import tracing as _request_tracing

__all__ = [
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "default_registry",
    "counter",
    "gauge",
    "histogram",
    "span",
    "add_trace_event",
    "spans_enabled",
    "enable_spans",
    "start_trace",
    "stop_trace",
    "tracing",
    "chrome_trace",
    "write_trace",
    "write_metrics",
    "reset",
]

# seconds; from sub-millisecond queue waits at the bottom to a cold kernel
# build (every CUDA source compiled) at the top
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, float("inf"),
)

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _format_float(value: float) -> str:
    """Prometheus exposition float formatting (``+Inf``, no locale)."""
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    if math.isnan(value):
        return "NaN"
    return repr(float(value))


def _escape_label_value(value: str) -> str:
    return (
        str(value)
        .replace("\\", r"\\")
        .replace("\n", r"\n")
        .replace('"', r'\"')
    )


# rendered OpenMetrics exemplars are capped per metric family (newest
# first) so the exposition stays bounded however many label series exist;
# scripts/lint_metric_names.py enforces the same cap on the rendered text
MAX_EXEMPLARS_PER_FAMILY = 16


def _format_exemplar(trace_id: str, value: float, ts: float) -> str:
    """OpenMetrics exemplar suffix for a ``_bucket`` sample line:
    ``# {trace_id="<id>"} <value> <unix_ts>``. ``trace_id`` is the only
    exemplar label this codebase emits (unbounded label values belong in
    exemplars, never in metric labels — the lint owns both rules)."""
    return (
        f' # {{trace_id="{_escape_label_value(trace_id)}"}} '
        f"{_format_float(value)} {ts:.3f}"
    )


def _capped_exemplars(metric: "_Metric") -> Dict[Tuple[Any, int], Tuple]:
    """{(label key, bucket index): (trace_id, value, ts)} for one
    histogram family, newest ``MAX_EXEMPLARS_PER_FAMILY`` only."""
    if metric.kind != "histogram":
        return {}
    flat = [
        (key, index, entry)
        for key, per_bucket in metric.exemplars().items()
        for index, entry in per_bucket.items()
    ]
    flat.sort(key=lambda item: -item[2][2])  # newest first
    return {
        (key, index): entry
        for key, index, entry in flat[:MAX_EXEMPLARS_PER_FAMILY]
    }


def _render_labels(
    labelnames: Sequence[str],
    labelvalues: Sequence[str],
    extra: Tuple[Tuple[str, str], ...] = (),
) -> str:
    pairs = list(zip(labelnames, labelvalues)) + list(extra)
    if not pairs:
        return ""
    inner = ",".join(
        f'{name}="{_escape_label_value(value)}"' for name, value in pairs
    )
    return "{" + inner + "}"


class _HistogramState:
    __slots__ = ("counts", "sum", "exemplars")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.sum = 0.0
        # bucket index -> (trace_id, value, unix_ts): latest traced
        # observation per bucket; None until the first one (the common
        # untraced series never allocates the dict)
        self.exemplars: Optional[Dict[int, Tuple[str, float, float]]] = None


class _Metric:
    """Base for the three metric kinds: labeled children share the parent's
    lock and value table (one lock per metric — contention on these paths is
    per-machine/per-bucket/per-request, not per-sample)."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        if not _METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        if not help or not str(help).strip():
            raise ValueError(f"metric {name} must carry non-empty help text")
        for label in labelnames:
            if not _LABEL_NAME_RE.match(label):
                raise ValueError(f"invalid label name: {label!r}")
        self.name = name
        self.help = str(help)
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labelkw: Dict[str, str]) -> Tuple[str, ...]:
        if set(labelkw) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} takes labels {self.labelnames}, "
                f"got {tuple(labelkw)}"
            )
        return tuple(str(labelkw[name]) for name in self.labelnames)

    def labels(self, **labelkw: str) -> "_Child":
        return _Child(self, self._key(labelkw))

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> List[Tuple[Tuple[str, ...], Any]]:
        """Point-in-time copy of every child's value, ordered by label key
        for deterministic exposition."""
        with self._lock:
            out = []
            for key in sorted(self._values):
                value = self._values[key]
                if isinstance(value, _HistogramState):
                    value = (list(value.counts), value.sum)
                out.append((key, value))
            return out


class _Child:
    """One labelled series of a metric; delegates to the parent."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: _Metric, key: Tuple[str, ...]):
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._metric._inc(self._key, amount)

    def set(self, value: float) -> None:
        self._metric._set(self._key, value)

    def observe(self, value: float) -> None:
        self._metric._observe(self._key, value)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._inc((), amount)

    def _inc(self, key: Tuple[str, ...], amount: float) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labelkw: str) -> float:
        with self._lock:
            return float(self._values.get(self._key(labelkw), 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float) -> None:
        self._set((), value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._values[()] = self._values.get((), 0.0) + amount

    def _set(self, key: Tuple[str, ...], value: float) -> None:
        with self._lock:
            self._values[key] = float(value)

    def value(self, **labelkw: str) -> float:
        with self._lock:
            return float(self._values.get(self._key(labelkw), 0.0))


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help, labelnames)
        buckets = [float(b) for b in buckets]
        if buckets != sorted(buckets):
            raise ValueError("histogram buckets must be sorted")
        if not buckets or buckets[-1] != float("inf"):
            buckets.append(float("inf"))
        self.buckets = tuple(buckets)

    def observe(self, value: float) -> None:
        self._observe((), value)

    def _observe(self, key: Tuple[str, ...], value: float) -> None:
        value = float(value)
        # exemplar capture is implicit: an observation made under an
        # active request trace links its bucket to that trace id (latest
        # wins — a rendered exemplar should still resolve in the flight
        # recorder). One contextvar read; untraced paths pay nothing else.
        ctx = _request_tracing.current()
        trace_id = ctx.trace_id if ctx is not None \
            and ctx.collector is not None else None
        with self._lock:
            state = self._values.get(key)
            if state is None:
                state = self._values[key] = _HistogramState(len(self.buckets))
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    state.counts[i] += 1
                    if trace_id is not None:
                        if state.exemplars is None:
                            state.exemplars = {}
                        state.exemplars[i] = (trace_id, value, time.time())
                    break
            state.sum += value

    def exemplars(
        self,
    ) -> Dict[Tuple[str, ...], Dict[int, Tuple[str, float, float]]]:
        """{label key: {bucket index: (trace_id, value, unix_ts)}} for
        every series that has captured at least one exemplar."""
        with self._lock:
            return {
                key: dict(state.exemplars)
                for key, state in self._values.items()
                if isinstance(state, _HistogramState) and state.exemplars
            }

    def count(self, **labelkw: str) -> int:
        with self._lock:
            state = self._values.get(self._key(labelkw))
            return sum(state.counts) if state is not None else 0


_METRIC_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Process-local metric registry with get-or-create semantics (modules
    re-imported under different names, or tests re-wiring, must converge on
    the same series rather than crash on a duplicate registration)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    # ----------------------------------------------------------- factories
    def counter(
        self, name: str, help: str, labelnames: Sequence[str] = ()
    ) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(
        self, name: str, help: str, labelnames: Sequence[str] = ()
    ) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def _get_or_create(self, cls, name, help, labelnames, **kwargs) -> Any:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != tuple(
                    labelnames
                ):
                    raise ValueError(
                        f"metric {name} already registered as "
                        f"{existing.kind}{existing.labelnames}"
                    )
                return existing
            metric = cls(name, help, labelnames, **kwargs)
            self._metrics[name] = metric
            return metric

    # ------------------------------------------------------------- queries
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[name] for name in sorted(self._metrics)]

    def reset_values(self) -> None:
        """Zero every series (tests; metric objects stay registered so
        module-level references keep working)."""
        for metric in self.collect():
            with metric._lock:
                metric._values.clear()

    # ----------------------------------------------------------- exporters
    def render_text(self) -> str:
        """Prometheus text exposition format 0.0.4, pure python — the
        textfile exporter for push-style batch jobs needs no
        prometheus_client."""
        lines: List[str] = []
        for metric in self.collect():
            help_text = metric.help.replace("\\", r"\\").replace("\n", r"\n")
            lines.append(f"# HELP {metric.name} {help_text}")
            lines.append(f"# TYPE {metric.name} {metric.kind}")
            exemplars = _capped_exemplars(metric)
            for key, value in metric.snapshot():
                if metric.kind == "histogram":
                    counts, total = value
                    cumulative = 0
                    for i, (bound, count) in enumerate(
                        zip(metric.buckets, counts)
                    ):
                        cumulative += count
                        labels = _render_labels(
                            metric.labelnames,
                            key,
                            extra=(("le", _format_float(bound)),),
                        )
                        line = f"{metric.name}_bucket{labels} {cumulative}"
                        exemplar = exemplars.get((key, i))
                        if exemplar is not None:
                            line += _format_exemplar(*exemplar)
                        lines.append(line)
                    labels = _render_labels(metric.labelnames, key)
                    lines.append(f"{metric.name}_sum{labels} "
                                 f"{_format_float(total)}")
                    lines.append(f"{metric.name}_count{labels} {cumulative}")
                else:
                    labels = _render_labels(metric.labelnames, key)
                    lines.append(
                        f"{metric.name}{labels} {_format_float(value)}"
                    )
        return "\n".join(lines) + "\n"

    def write_textfile(self, path: str) -> str:
        """Atomic write (tmp + rename): the node-exporter textfile collector
        must never scrape a half-written file."""
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(self.render_text())
        os.replace(tmp, path)
        return path


_default_registry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default_registry


def counter(name: str, help: str, labelnames: Sequence[str] = ()) -> Counter:
    return _default_registry.counter(name, help, labelnames)


def gauge(name: str, help: str, labelnames: Sequence[str] = ()) -> Gauge:
    return _default_registry.gauge(name, help, labelnames)


def histogram(
    name: str,
    help: str,
    labelnames: Sequence[str] = (),
    buckets: Sequence[float] = DEFAULT_BUCKETS,
) -> Histogram:
    return _default_registry.histogram(name, help, labelnames, buckets)


# ------------------------------------------------------------------- spans
class _TraceBuffer:
    """Chrome-trace-event accumulator. Bounded: a runaway fleet build must
    degrade to dropped events, not an OOM of the build process."""

    MAX_EVENTS = 1_000_000

    def __init__(self):
        self.t0 = time.monotonic()
        self._lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0

    def add(
        self, name: str, start: float, duration: float, attrs: Dict[str, Any]
    ) -> None:
        event = {
            "name": name,
            "cat": "gordo",
            "ph": "X",
            # Chrome trace timestamps/durations are microseconds
            "ts": max(0.0, (start - self.t0) * 1e6),
            "dur": duration * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if attrs:
            event["args"] = {k: str(v) for k, v in attrs.items()}
        with self._lock:
            if len(self.events) >= self.MAX_EVENTS:
                self.dropped += 1
                return
            self.events.append(event)

    def chrome_trace(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {
                    "producer": "gordo_tpu_torch.observability.telemetry",
                    "droppedEvents": self.dropped,
                },
            }


_state_lock = threading.Lock()
_spans_enabled = False
_trace: Optional[_TraceBuffer] = None


class _NullSpan:
    """The disabled-path span: one shared instance, no timing, no state.
    ``span()`` returning this singleton is what makes dormant
    instrumentation free (asserted allocation-free by the tests)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_attrs(self, **attrs) -> None:
        """No-op twin of :meth:`_Span.set_attrs`."""


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = (
        "name", "hist", "attrs", "links",
        "_t0", "_annotation", "_ctx", "_span_id", "_token",
    )

    def __init__(self, name: str, hist: Optional[Histogram], attrs, links=()):
        self.name = name
        self.hist = hist
        self.attrs = attrs
        self.links = tuple(links)

    def set_attrs(self, **attrs) -> None:
        """Add/overwrite span attributes mid-flight (e.g. the matched
        route, known only after the span opened)."""
        self.attrs.update(attrs)

    def __enter__(self):
        from ..util.profiling import annotate

        # the profiler's record_function range shares the span's name, so
        # the device timeline (GORDO_TPU_PROFILE_DIR) and the spans line up
        self._annotation = annotate(self.name)
        self._annotation.__enter__()
        # request-scoped tracing: under an active trace context this span
        # becomes the ambient parent for anything opened inside it
        self._ctx = _request_tracing.current()
        self._token = None
        if self._ctx is not None:
            self._span_id = _request_tracing.new_span_id()
            self._token = _request_tracing.push_child(self._ctx, self._span_id)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        duration = time.monotonic() - self._t0
        self._annotation.__exit__(exc_type, exc, tb)
        ctx = self._ctx
        if self._token is not None:
            _request_tracing.pop(self._token)
        if ctx is not None:
            if exc_type is not None:
                self.attrs.setdefault("error", exc_type.__name__)
            if ctx.collector is not None:
                ctx.collector.add(
                    _request_tracing.SpanRecord(
                        self.name, ctx.trace_id, self._span_id,
                        ctx.span_id, self._t0, duration,
                        attrs=self.attrs, links=self.links,
                    )
                )
        trace = _trace
        if trace is not None:
            attrs = self.attrs
            if ctx is not None:
                # trace/span ids in the Chrome-trace args: Perfetto's args
                # filter then isolates one request/machine end to end
                attrs = dict(attrs)
                attrs["trace_id"] = ctx.trace_id
                attrs["span_id"] = self._span_id
            trace.add(self.name, self._t0, duration, attrs)
        if self.hist is not None:
            self.hist.observe(duration)
        return False


def span(name: str, hist: Optional[Histogram] = None, links=(), **attrs):
    """A named timing span.

    Active when a trace was started (:func:`start_trace`), span timing was
    enabled (:func:`enable_spans`, the ``--metrics-file``-only mode), a
    request trace context is attached (:mod:`.tracing`: the span joins
    the request's tree), or ``torch.profiler`` profiling is on
    (``$GORDO_TPU_PROFILE_DIR``). Otherwise returns the shared no-op
    singleton. ``hist``: a :class:`Histogram` to observe the span's
    duration into on exit (phase-duration metrics without a second timer
    at the call site). ``links``: (trace_id, span_id) pairs of correlated
    spans in other traces (the batcher's co-fused riders).
    """
    if (
        not _spans_enabled
        and _request_tracing.current() is None
        and not os.environ.get("GORDO_TPU_PROFILE_DIR")
    ):
        return _NULL_SPAN
    return _Span(name, hist, attrs, links)


def add_trace_event(
    name: str, start: float, duration: float, **attrs
) -> None:
    """Record one already-timed event into the active global trace buffer
    (no-op without one). For work timed manually because its span records
    are fanned out elsewhere — the batcher's fused device call."""
    trace = _trace
    if trace is not None:
        trace.add(name, start, duration, attrs)


def spans_enabled() -> bool:
    return _spans_enabled


def enable_spans() -> None:
    """Turn span timing on without recording trace events (metrics-only
    collection: phase histograms fill, no event buffer grows)."""
    global _spans_enabled
    with _state_lock:
        _spans_enabled = True


def start_trace() -> None:
    """Start (or restart) in-memory trace-event collection."""
    global _spans_enabled, _trace
    with _state_lock:
        _trace = _TraceBuffer()
        _spans_enabled = True


def tracing() -> bool:
    return _trace is not None


def chrome_trace() -> Optional[Dict[str, Any]]:
    """The active trace as a Chrome trace-event dict (None if no trace)."""
    trace = _trace
    return trace.chrome_trace() if trace is not None else None


def stop_trace() -> Optional[Dict[str, Any]]:
    """Stop collection; returns the final Chrome trace dict (None if no
    trace was active). Span timing stays enabled until :func:`reset`."""
    global _trace
    with _state_lock:
        trace = _trace
        _trace = None
    return trace.chrome_trace() if trace is not None else None


def write_trace(path: str) -> str:
    """Write the active trace as Chrome trace-event JSON (open the file in
    Perfetto / ``chrome://tracing``). The trace stays active."""
    data = chrome_trace()
    if data is None:
        raise RuntimeError("no active trace: call start_trace() first")
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(data, fh)
    os.replace(tmp, path)
    return path


def write_metrics(path: str) -> str:
    """Textfile-export the default registry (see
    :meth:`MetricsRegistry.write_textfile`)."""
    return _default_registry.write_textfile(path)


def reset() -> None:
    """Tests: drop any trace, disable span timing, zero metric values."""
    global _spans_enabled, _trace
    with _state_lock:
        _spans_enabled = False
        _trace = None
    _default_registry.reset_values()
