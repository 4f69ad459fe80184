"""
Prometheus metrics for the model server, without ``prometheus_client``: the
port's counterpart of ``gordo_tpu/server/prometheus/metrics.py``, over the
port's own registry (observability/telemetry.py).

The reference's families and labels: the request duration histogram and
the request counter, labelled ``(method, path, status_code, gordo_name,
project)``, the version-info gauge, and the cross-model batcher's gauges.
:meth:`GordoServerPrometheusMetrics.expose` renders them and the metric
catalog (observability/metrics.py) in the text format ``version=0.0.4``:
both from this process's registries, or, with ``GORDO_TPU_TELEMETRY_DIR``
set, merged from every worker's shard (observability/shared.py). The JAX
pool aggregates its request families through ``prometheus_client``'s
multiprocess directory (``PROMETHEUS_MULTIPROC_DIR``), which the port does
not have: each worker's request families ride its telemetry shard as the
extra section ``prometheus`` (counters and histograms summed over the
workers, the info and largest-batch gauges their maximum), so any worker's
``/metrics`` and the sidecar (server/prometheus/server.py) count every
worker's requests, and a dead worker's shard, reaped by the arbiter, leaves
the sum.
"""

import re
import timeit
from typing import Optional

from ... import __version__
from ...observability import telemetry

_NAME_RE = re.compile(r"/gordo/v0/[^/]+/([^/]+)/")

# prometheus_client's Histogram.DEFAULT_BUCKETS, which the reference's
# request histogram uses
REQUEST_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0,
                   7.5, 10.0, float("inf"))
_LABELS = ("method", "path", "status_code", "gordo_name", "project")
# the shard section the request families ride, and the gauges merged by max
SHARD_KEY = "prometheus"
MAX_MERGE = frozenset({"gordo_server_info", "gordo_server_batcher_largest_batch"})


def fleet_text() -> str:
    """Every worker's request families, merged from the shards."""
    from ...observability import shared

    return shared.render_registry_extra(SHARD_KEY, max_merge=MAX_MERGE)


class GordoServerPrometheusMetrics:
    def __init__(self, project: Optional[str] = None,
                 registry: Optional[telemetry.MetricsRegistry] = None):
        self.project = project or "unknown"
        self.registry = registry if registry is not None else telemetry.MetricsRegistry()
        self.request_duration = self.registry.histogram(
            "gordo_server_request_duration_seconds", "HTTP request duration", _LABELS,
            buckets=REQUEST_BUCKETS)
        self.request_count = self.registry.counter(
            "gordo_server_requests_total", "HTTP request count", _LABELS)
        self.version_info = self.registry.gauge(
            "gordo_server_info", "Server version info", ("version", "project"))
        self.version_info.labels(version=__version__, project=self.project).set(1)
        self.batcher_items = self.registry.gauge(
            "gordo_server_batcher_items", "Predicts that went through the cross-model batcher",
            ("project",))
        self.batcher_device_calls = self.registry.gauge(
            "gordo_server_batcher_device_calls", "Fused device calls the batcher executed",
            ("project",))
        self.batcher_largest_batch = self.registry.gauge(
            "gordo_server_batcher_largest_batch", "Largest fused batch observed", ("project",))
        self.batcher_specs = self.registry.gauge(
            "gordo_server_batcher_specs",
            "Architectures by self-A/B decision (batching on/stood down)",
            ("project", "decision"))
        # labeled children resolved once: record() runs per request
        self._batcher_children = {
            "items": self.batcher_items.labels(project=self.project),
            "device_calls": self.batcher_device_calls.labels(project=self.project),
            "largest_batch": self.batcher_largest_batch.labels(project=self.project),
            "on": self.batcher_specs.labels(project=self.project, decision="batch"),
            "off": self.batcher_specs.labels(project=self.project, decision="direct"),
        }
        # a prometheus_client child exists, at 0, from its first labels()
        for child in self._batcher_children.values():
            child.set(0)
        from ...observability import shared

        shared.register_extra(SHARD_KEY, lambda: shared.registry_metrics(self.registry))

    def record(self, method: str, rule: Optional[str], path: str, status_code: int,
               start_time: float) -> None:
        """Record one request: ``rule`` is the route rule it matched (the
        JAX server's werkzeug rule string), None when it matched none;
        ``path`` is the request's path; ``start_time`` the caller's
        ``timeit.default_timer()`` at its start. Labelled by the matched
        rule, never the raw path (a scanner's random URLs would mint a
        series each), and ``gordo_name`` only for a name the server
        resolved (not on 404, 405 or 410)."""
        duration = timeit.default_timer() - start_time
        if rule is not None and status_code not in (404, 405, 410):
            match = _NAME_RE.search(path)
            gordo_name = match.group(1) if match else ""
        else:
            gordo_name = ""
        labels = dict(method=method, path=rule if rule is not None else "(unmatched)",
                      status_code=str(status_code), gordo_name=gordo_name, project=self.project)
        self.request_duration.labels(**labels).observe(duration)
        self.request_count.labels(**labels).inc()
        self._refresh_batcher()

    def _refresh_batcher(self) -> None:
        """Mirror the process batcher's counters into gauges (peek only:
        never creates a batcher)."""
        from ..batcher import peek_batcher

        batcher = peek_batcher()
        if batcher is None:
            return
        children = self._batcher_children
        children["items"].set(batcher.stats["items"])
        children["device_calls"].set(batcher.stats["device_calls"])
        children["largest_batch"].set(batcher.stats["largest_batch"])
        on, off = batcher.decision_counts()
        children["on"].set(on)
        children["off"].set(off)

    def expose(self) -> bytes:
        """The exposition: these families, then the catalog (the fleet view
        from the shards when ``GORDO_TPU_TELEMETRY_DIR`` is set). The device
        and SLO gauges are sampled first."""
        from ...observability import device, shared, slo

        device.sample()
        slo.refresh_gauges()
        if shared.enabled():
            self._refresh_batcher()
            fleet = shared.render_fleet_text()  # flushes this worker's shard first
            return (fleet_text() + fleet).encode()
        out = self.registry.render_text() + telemetry.default_registry().render_text()
        return out.encode()
