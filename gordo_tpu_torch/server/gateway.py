"""
The cross-node serving gateway: the port's counterpart of
``gordo_tpu/server/gateway.py``, the tier above a single ``run-server``
node.

Many clients reach a fleet of serving nodes through one front end. Each
node keeps its parameter bank and kernels warm for *its* machines:
placement is a consistent-hash ring (:class:`HashRing`, vnode-weighted,
the JAX ring's placement exactly for the same node ids and vnodes) keyed
by machine name, so a machine's requests land on one node, and losing a
node moves only the keys of its segment.

- **Membership** is filesystem leases (server/membership.py): nodes
  heartbeat registration files under ``GORDO_TPU_GATEWAY_DIR``; a stale
  lease is a dead node, and its segment spills to the ring successors.
- **Drain**: a health poller reads each node's ``/debug/slo``; a 5-minute
  latency burn past ``GORDO_TPU_GATEWAY_DRAIN_BURN`` marks the node
  draining (placements skip it while another node is viable), and the
  gateway pre-warms the drained segment's successors through
  ``POST /debug/prewarm`` (naming the revision each machine last answered
  with, so a hot-swapped artifact is what warms), or a metadata GET where
  the debug surface is off.
- **Hedged failover**: a connect failure, a 503 or an injected transient
  on the primary is retried once on the next node in ring order, where the
  request's ``X-Gordo-Deadline-Ms`` leaves at least
  ``GORDO_TPU_GATEWAY_HEDGE_MS``.
- **Per-node breakers** (:class:`NodeBreaker`, on ``faults.is_transient``):
  a node failing repeatedly is skipped at placement for its cooldown.

The front end is the fast lane's event loop (server/fastlane.py):
:class:`GatewayServer` sets the loop's ``offloop`` hook, so the loop keeps
its parser, keep-alive, pipelining, drain and idle bound while each parsed
request goes to a pool of proxy threads (``GORDO_TPU_GATEWAY_WORKERS``);
their answers return through the loop's wake-up in pipeline order. The
upstream connections are pooled per thread and prefer a node's advertised
Unix-domain socket where it exists on this host.

Local routes: ``/healthcheck``, ``/metrics``, ``/gateway/status`` and,
under ``GORDO_TPU_DEBUG_ENDPOINTS``, ``/debug/flight`` (``?trace=<id>``
stitches the nodes' subtrees under the gateway's spans, with a
``gordoStitch`` entry per node). A request with a ``traceparent`` (every
request under ``GORDO_TPU_GATEWAY_TRACE``) gets the gateway's span tree and
passes a ``traceparent`` naming its attempt span upstream.

Chaos sites (util/faults.py): ``gateway_route`` at the top of routing
(machine = placement key) and ``node_partition`` before each upstream
attempt (machine = node id). The ``gordo_gateway_*`` series of the catalog
are fed here. ``python -m gordo_tpu_torch run-gateway`` is the command. The
gateway computes nothing: it initialises no CUDA.
"""

import bisect
import hashlib
import http.client
import json
import logging
import os
import queue
import re
import socket
import threading
import time
import timeit
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple
from urllib.parse import unquote

from ..observability import flight, metrics as metric_catalog, profiler, shared, telemetry, tracing
from ..util import faults
from . import membership, resilience
from .fastlane import _HOP_BY_HOP, EventLoopServer, _Headers, _serialize
from .views import json_text

logger = logging.getLogger(__name__)

# /gordo/v0/<project>/<machine>/<route...> places by machine; the project's
# listing routes (a second segment with no route after it) place by path, so
# any live node answers them
_MACHINE_RE = re.compile(r"^/gordo/v0/([^/]+)/([^/]+)/")
_PROJECT_ROUTES = frozenset(("models", "revisions", "expected-models"))
_JSON = ("Content-Type", "application/json")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def vnode_count() -> int:
    return max(1, _env_int("GORDO_TPU_GATEWAY_VNODES", 64))


def hedge_budget_ms() -> float:
    """The least remaining request deadline (ms) worth spending a hedge on."""
    return _env_float("GORDO_TPU_GATEWAY_HEDGE_MS", 50.0)


def trace_all_enabled() -> bool:
    """``GORDO_TPU_GATEWAY_TRACE``: trace every routed request, not only
    those that arrive with a ``traceparent``."""
    return os.environ.get("GORDO_TPU_GATEWAY_TRACE", "").lower() in ("1", "true", "yes", "on")


def _dumps(doc) -> bytes:
    return json_text(doc).encode()


class _UDSHTTPConnection(http.client.HTTPConnection):
    """``http.client`` over a node's advertised Unix-domain socket (the
    lease's ``uds``); host and port stay for the Host header."""

    def __init__(self, path: str, host: str, port: int, timeout=None):
        super().__init__(host, port, timeout=timeout)
        self.uds_path = path

    def connect(self):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if self.timeout is not None:
            sock.settimeout(self.timeout)
        sock.connect(self.uds_path)
        self.sock = sock


def _ring_hash(key: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


class HashRing:
    """Consistent-hash ring with virtual nodes.

    Each node owns ``vnodes`` points on a 64-bit ring; a key belongs to
    the first point clockwise from its hash. Removing a node hands only
    its own arcs to the ring successors — every other key keeps its
    placement (and its node-side caches) untouched.
    """

    def __init__(self, vnodes: Optional[int] = None):
        self.vnodes = vnodes or vnode_count()
        self._points: List[Tuple[int, str]] = []
        self.nodes: Tuple[str, ...] = ()

    def rebuild(self, node_ids) -> None:
        points: List[Tuple[int, str]] = []
        for node in node_ids:
            for v in range(self.vnodes):
                points.append((_ring_hash(f"{node}#{v}"), node))
        points.sort()
        self._points = points
        self.nodes = tuple(sorted(node_ids))

    def candidates(self, key: str, limit: Optional[int] = None) -> List[str]:
        """Distinct nodes in ring-successor order from the key's position
        — index 0 is the primary, the rest are the failover/hedge order."""
        points = self._points
        if not points:
            return []
        start = bisect.bisect_right(points, (_ring_hash(key), "￿"))
        seen, order = set(), []
        for i in range(len(points)):
            node = points[(start + i) % len(points)][1]
            if node not in seen:
                seen.add(node)
                order.append(node)
                if limit is not None and len(order) >= limit:
                    break
        return order

    def share(self) -> Dict[str, float]:
        """Fraction of the ring each node owns (the occupancy gauge)."""
        points = self._points
        if not points:
            return {}
        span = float(2 ** 64)
        share = {node: 0.0 for node in self.nodes}
        prev = points[-1][0] - 2 ** 64  # wraparound arc
        for h, node in points:
            share[node] += (h - prev) / span
            prev = h
        return share


# ------------------------------------------------------------------- breakers
class NodeBreaker:
    """Per-node circuit breaker for the routing tier.

    Counts consecutive upstream failures; at ``threshold`` the node is
    skipped at placement for ``cooldown_s`` (open), then one probe
    request is let through (half-open). Classification reuses
    ``faults.is_transient``: a permanent fault opens immediately — no
    point burning the threshold on errors retrying will never clear.
    """

    def __init__(self, node_id: str, threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None):
        self.node_id = node_id
        self.threshold = (
            threshold
            if threshold is not None
            else _env_int("GORDO_TPU_GATEWAY_BREAKER_THRESHOLD", 3)
        )
        self.cooldown_s = (
            cooldown_s
            if cooldown_s is not None
            else _env_float("GORDO_TPU_GATEWAY_BREAKER_COOLDOWN_S", 5.0)
        )
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_until = 0.0
        self._half_open = False

    def _gauge(self, value: float) -> None:
        metric_catalog.GATEWAY_BREAKER_STATE.labels(
            node=self.node_id
        ).set(value)

    def allow(self) -> bool:
        if self.threshold <= 0:
            return True
        with self._lock:
            if self._failures < self.threshold:
                return True
            now = time.monotonic()
            if now < self._opened_until:
                return False
            # cooldown expired: let one probe through (half-open)
            if self._half_open:
                return False
            self._half_open = True
            self._gauge(0.5)
            return True

    def record_success(self) -> None:
        with self._lock:
            if self._failures:
                self._gauge(0.0)
            self._failures = 0
            self._half_open = False

    def record_failure(self, exc: Optional[BaseException] = None) -> None:
        if self.threshold <= 0:
            return
        with self._lock:
            if exc is not None and not faults.is_transient(exc):
                self._failures = max(self._failures + 1, self.threshold)
            else:
                self._failures += 1
            if self._failures >= self.threshold:
                self._opened_until = time.monotonic() + self.cooldown_s
                self._half_open = False
                self._gauge(1.0)


class GatewayServer(EventLoopServer):
    """The gateway on the fast lane's event loop, with ``offloop`` set: the
    loop parses, a pool of proxy threads places and proxies each request
    (hedging where it must) and hands the response bytes back through
    :meth:`EventLoopServer.complete`. ``directory`` is the membership
    directory."""

    offloop = True

    def __init__(self, directory: str, host: str = "127.0.0.1", port: int = 0,
                 fd: Optional[int] = None, request_timeout: float = 120.0):
        # no app: every route is proxied or answered here; uds="" keeps the
        # gateway off GORDO_TPU_UDS_PATH, which names a serving node's lane
        super().__init__(None, host=host, port=port, fd=fd, request_timeout=request_timeout,
                         uds="")
        self.directory = directory
        self.view = membership.MembershipView(directory)
        self.ring = HashRing()
        self.upstream_timeout_s = _env_float("GORDO_TPU_GATEWAY_TIMEOUT_S", 30.0)
        self.connect_timeout_s = _env_float("GORDO_TPU_GATEWAY_CONNECT_TIMEOUT_S", 1.0)
        self.health_interval_s = _env_float("GORDO_TPU_GATEWAY_HEALTH_S", 2.0)
        self.drain_burn_threshold = _env_float("GORDO_TPU_GATEWAY_DRAIN_BURN", 14.4)
        self.prewarm_enabled = os.environ.get("GORDO_TPU_GATEWAY_PREWARM", "1").lower() not in (
            "0", "false", "no")
        self.trace_all = trace_all_enabled()
        # traced requests opt in, so the recent ring is on by default here: a
        # hedged request that succeeded stays resolvable for stitching
        self.flight = flight.FlightRecorder(recent=flight.recent_capacity_from_env(default=32))

        self._live: Dict[str, membership.NodeInfo] = {}
        self._draining: set = set()
        self._breakers: Dict[str, NodeBreaker] = {}
        self._state_lock = threading.Lock()
        # machine -> project, the pre-warm working set (LRU-bounded)
        self._recent: "OrderedDict[str, str]" = OrderedDict()
        # machine -> the revision its last successful answer carried (the
        # ``revision`` header): a hot swap's pre-warm names it
        self._revisions: "OrderedDict[str, str]" = OrderedDict()

        self._jobs: "queue.Queue" = queue.Queue()
        self._stop_health = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self._workers: List[threading.Thread] = []
        for i in range(max(1, _env_int("GORDO_TPU_GATEWAY_WORKERS", 8))):
            worker = threading.Thread(target=self._worker_loop, daemon=True,
                                      name=f"gordo-gateway-{i}")
            worker.start()
            self._workers.append(worker)
        # a first scan now, so a new gateway routes before the poller's tick
        self._refresh_membership()
        self._health_thread = threading.Thread(target=self._health_loop, daemon=True,
                                               name="gordo-gateway-health")
        self._health_thread.start()

    # ------------------------------------------------------------ lifecycle
    def serve_forever(self) -> None:
        logger.info("gateway serving on port %d (ring nodes: %s; membership dir %s)",
                    self.server_port, list(self.ring.nodes), self.directory)
        super().serve_forever()

    def server_close(self) -> None:
        self._stop_health.set()
        for _ in self._workers:
            self._jobs.put(None)
        super().server_close()
        if self._health_thread is not None:
            self._health_thread.join(timeout=2.0)

    # ------------------------------------------------------- proxy threads
    def _hand_off(self, conn, seq, method, target, headers, body, keep) -> None:
        self._jobs.put((conn, seq, method, target, headers, body, keep))

    def _worker_loop(self) -> None:
        profiler.register_thread("gordo-gateway-worker")
        while True:
            job = self._jobs.get()
            if job is None:
                return
            conn, seq, method, target, headers, body, keep = job
            try:
                payload = self._route(method, target, headers, body, keep)
            except Exception:  # noqa: BLE001 -- a proxy thread must never die
                logger.exception("gateway routing error")
                payload = _serialize(500, [_JSON], _dumps({"error": "Internal gateway error"}),
                                     keep_alive=False)
                keep = False
            self.complete(conn, seq, payload, not keep)

    # ------------------------------------------------------------- routing
    def _placement_key(self, path: str) -> Tuple[Optional[str], Optional[str]]:
        """(machine, project) from the path; machine None for
        project-level routes, both None for non-gordo paths."""
        match = _MACHINE_RE.match(path)
        if match is None:
            return None, None
        project, second = match.group(1), match.group(2)
        if second in _PROJECT_ROUTES:
            return None, project
        return second, project

    def _viable_nodes(self, key: str) -> Tuple[List[membership.NodeInfo], List[str]]:
        """Ring-ordered live candidates for a key, breakers and drains
        applied (drainers only skipped while alternatives exist)."""
        with self._state_lock:
            live = dict(self._live)
            draining = set(self._draining)
        order = self.ring.candidates(key)
        viable: List[membership.NodeInfo] = []
        drained: List[membership.NodeInfo] = []
        skipped: List[str] = []
        for node_id in order:
            node = live.get(node_id)
            if node is None:
                skipped.append(f"{node_id}:dead")
                continue
            if not self._breaker(node_id).allow():
                skipped.append(f"{node_id}:breaker")
                continue
            if node_id in draining:
                drained.append(node)
                continue
            viable.append(node)
        # every survivor is draining: routing to a slow node beats a 502
        viable.extend(drained)
        return viable, skipped

    def _breaker(self, node_id: str) -> NodeBreaker:
        breaker = self._breakers.get(node_id)
        if breaker is None:
            breaker = self._breakers.setdefault(node_id, NodeBreaker(node_id))
        return breaker

    def _route(self, method: str, target: str, headers: Dict[str, str],
               body: bytes, keep: bool) -> bytes:
        """The response bytes of one request: a local route, or placed and
        proxied (traced when it carries a ``traceparent``)."""
        started = timeit.default_timer()
        raw_path, _, query = target.partition("?")
        path = unquote(raw_path)
        local = self._local_response(method, path, query)
        if local is not None:
            status, out_headers, out_body = local
            return _serialize(status, out_headers, out_body, keep_alive=keep)
        traceparent = headers.get("traceparent")
        if traceparent is None and not self.trace_all:
            # untraced: no tracing call, no span, no flight observation
            status, out_headers, out_body = self._route_upstream(
                method, raw_path, path, query, headers, body, started, None
            )
            return _serialize(status, out_headers, out_body, keep_alive=keep)
        with tracing.request_root(traceparent, collect=True) as rctx:
            with telemetry.span("gateway_request", method=method) as root:
                status, out_headers, out_body = self._route_upstream(
                    method, raw_path, path, query, headers, body,
                    started, rctx,
                )
                root.set_attrs(status=status)
            duration = timeit.default_timer() - started
            # the gateway's own share: wall time less the upstream attempts
            upstream_s = sum(
                span.duration
                for span in rctx.collector.snapshot()
                if span.name == "gateway_upstream_attempt"
            )
            out_headers = list(out_headers)
            if not any(
                name.lower() == "x-gordo-trace" for name, _ in out_headers
            ):
                out_headers.append(("X-Gordo-Trace", rctx.trace_id))
            out_headers.append((
                "Server-Timing",
                f"gateway_s;dur={max(0.0, duration - upstream_s)}",
            ))
            self.flight.observe(
                rctx.collector, status, duration, endpoint=path
            )
        return _serialize(status, out_headers, out_body, keep_alive=keep)

    def _route_upstream(self, method: str, raw_path: str, path: str,
                        query: str, headers: Dict[str, str], body: bytes,
                        started: float, rctx) -> Tuple[int, list, bytes]:
        """Place and proxy one request; returns ``(status, headers,
        body)`` for :func:`_serialize`. ``rctx`` is the request's
        ``TraceContext`` on the traced path, None on the hot path — every
        span/record call is gated on it so the untraced path touches no
        tracing machinery at all."""
        machine, project = self._placement_key(path)
        key = machine or path
        try:
            faults.fault_point("gateway_route", machine=machine)
        except Exception as exc:  # noqa: BLE001 -- an injected routing fault
            transient = faults.is_transient(exc)
            status = 503 if transient else 500
            out_headers = [("Content-Type", "application/json")]
            if transient:
                out_headers.append(
                    ("Retry-After", str(int(resilience.retry_after_s())))
                )
            metric_catalog.GATEWAY_REQUESTS.labels(
                node="none", status=str(status)
            ).inc()
            return status, out_headers, _dumps({"error": str(exc)})
        if machine is not None and project is not None:
            self._note_machine(machine, project)

        deadline_ms = resilience.deadline_ms_from(_Headers(headers))
        if rctx is not None:
            with telemetry.span(
                "gateway_route_resolve", machine=machine or key
            ) as resolve_span:
                candidates, skipped = self._viable_nodes(key)
                resolve_span.set_attrs(
                    candidates=",".join(n.node_id for n in candidates),
                    skipped=",".join(skipped),
                )
        else:
            candidates, skipped = self._viable_nodes(key)
        if not candidates:
            retry_after = max(1, int(self.view.timeout_s / 2))
            metric_catalog.GATEWAY_REQUESTS.labels(
                node="none", status="503"
            ).inc()
            doc = {"error": "no live serving nodes"}
            if rctx is not None:
                doc["gateway_trace"] = rctx.trace_id
            return 503, [
                ("Content-Type", "application/json"),
                ("Retry-After", str(retry_after)),
            ], _dumps(doc)

        path_q = raw_path + (("?" + query) if query else "")
        last_exc: Optional[BaseException] = None
        fallback_response = None
        # primary + at most one budgeted hedge, in ring order
        for attempt, node in enumerate(candidates[:2]):
            if attempt:
                if not self._hedge_allowed(deadline_ms, started):
                    if rctx is not None:
                        tracing.record_into(
                            tracing.current(), "gateway_retry_decision",
                            tracing.monotonic(), 0.0,
                            decision="hedge_denied",
                            reason="deadline_budget", node=node.node_id,
                        )
                    break
                reason = "connect" if last_exc is not None else "status_503"
                metric_catalog.GATEWAY_HEDGES.labels(reason=reason).inc()
                metric_catalog.GATEWAY_FAILOVERS.labels(
                    node=candidates[0].node_id
                ).inc()
                if rctx is not None:
                    tracing.record_into(
                        tracing.current(), "gateway_retry_decision",
                        tracing.monotonic(), 0.0,
                        decision="hedge", reason=reason,
                        node=node.node_id,
                        failed_node=candidates[0].node_id,
                    )
            breaker = self._breaker(node.node_id)
            proxy_exc: Optional[BaseException] = None
            if rctx is not None:
                # hedge arms are SIBLING spans under the gateway root
                # (each attempt span closes before the next opens), tagged
                # with the node id and the lane _proxy_once actually used
                with telemetry.span(
                    "gateway_upstream_attempt",
                    node=node.node_id, attempt=attempt,
                ) as attempt_span:
                    try:
                        status, up_headers, up_body = self._proxy_once(
                            node, method, path_q, headers, body,
                            deadline_ms, started, span=attempt_span,
                        )
                        attempt_span.set_attrs(status=status)
                    except Exception as exc:  # noqa: BLE001 -- connect or injected
                        attempt_span.set_attrs(
                            error=str(exc) or type(exc).__name__
                        )
                        proxy_exc = exc
            else:
                try:
                    status, up_headers, up_body = self._proxy_once(
                        node, method, path_q, headers, body,
                        deadline_ms, started,
                    )
                except Exception as exc:  # noqa: BLE001 -- connect or injected
                    proxy_exc = exc
            if proxy_exc is not None:
                last_exc = proxy_exc
                breaker.record_failure(proxy_exc)
                logger.warning(
                    "gateway: upstream %s failed for %s %s: %s",
                    node.node_id, method, path, proxy_exc,
                )
                continue
            if status == 503 and attempt == 0 and len(candidates) > 1:
                # shed/breaker fast-fail on the primary: spend the hedge on
                # the next replica, keep this response as the fallback
                breaker.record_failure(faults.TransientFault("upstream 503"))
                last_exc = None
                fallback_response = (status, up_headers, up_body)
                if rctx is not None:
                    tracing.record_into(
                        tracing.current(), "gateway_retry_decision",
                        tracing.monotonic(), 0.0,
                        decision="hedge_on_503", node=node.node_id,
                    )
                continue
            if status >= 500:
                breaker.record_failure(faults.TransientFault(f"upstream {status}"))
            else:
                breaker.record_success()
            elapsed = timeit.default_timer() - started
            metric_catalog.GATEWAY_REQUESTS.labels(
                node=node.node_id, status=str(status)
            ).inc()
            metric_catalog.GATEWAY_PROXY_SECONDS.labels(
                node=node.node_id
            ).observe(elapsed)
            out_headers = [
                (name, value) for name, value in up_headers
                if name.lower() not in _HOP_BY_HOP
            ]
            out_headers.append(("X-Gordo-Gateway-Node", node.node_id))
            if machine is not None and status < 300:
                self._note_revision(machine, up_headers)
            return status, out_headers, up_body

        if fallback_response is not None:
            status, up_headers, up_body = fallback_response
            metric_catalog.GATEWAY_REQUESTS.labels(
                node=candidates[0].node_id, status=str(status)
            ).inc()
            out_headers = [
                (name, value) for name, value in up_headers
                if name.lower() not in _HOP_BY_HOP
            ]
            out_headers.append(
                ("X-Gordo-Gateway-Node", candidates[0].node_id)
            )
            if rctx is not None:
                up_body = self._quote_trace(up_body, rctx.trace_id)
            return status, out_headers, up_body
        metric_catalog.GATEWAY_REQUESTS.labels(
            node="none", status="502"
        ).inc()
        doc = {
            "error": "all replicas failed",
            "detail": str(last_exc) if last_exc else "",
        }
        if rctx is not None:
            doc["gateway_trace"] = rctx.trace_id
        return 502, [("Content-Type", "application/json")], _dumps(doc)

    @staticmethod
    def _quote_trace(body, trace_id: str):
        """Name the gateway trace id inside an upstream error body (the
        saved-503 fallback) so the operator's next step, ``python -m
        gordo_tpu_torch trace <id>``, is in the payload itself, not just a header. Best-effort:
        a non-JSON body passes through untouched."""
        try:
            doc = json.loads(body)
        except (TypeError, ValueError):
            return body
        if not isinstance(doc, dict) or "gateway_trace" in doc:
            return body
        doc["gateway_trace"] = trace_id
        return json.dumps(doc).encode()

    def _hedge_allowed(self, deadline_ms: Optional[float],
                       started: float) -> bool:
        if deadline_ms is None:
            return True
        remaining_ms = deadline_ms - (timeit.default_timer() - started) * 1000.0
        return remaining_ms >= hedge_budget_ms()

    def _note_machine(self, machine: str, project: str) -> None:
        with self._state_lock:
            self._recent[machine] = project
            self._recent.move_to_end(machine)
            while len(self._recent) > 4096:
                self._recent.popitem(last=False)

    def _note_revision(self, machine: str, up_headers) -> None:
        """Track the revision each machine last answered with (from the
        upstream ``revision`` response header) so hot-swap pre-warms can
        name it explicitly."""
        revision = next(
            (value for name, value in up_headers
             if name.lower() == "revision"),
            None,
        )
        if not revision:
            return
        with self._state_lock:
            self._revisions[machine] = revision
            self._revisions.move_to_end(machine)
            while len(self._revisions) > 4096:
                self._revisions.popitem(last=False)

    def _revision_of(self, machine: str) -> Optional[str]:
        with self._state_lock:
            return self._revisions.get(machine)

    # --------------------------------------------------------- upstream I/O
    _pool = threading.local()

    def _upstream_conn(
        self, node: membership.NodeInfo, force_tcp: bool = False
    ) -> http.client.HTTPConnection:
        """A pooled keep-alive connection to ``node``, preferring the
        node's advertised Unix-domain lane when its socket path exists on
        this host (the co-located case the lane exists for); ``force_tcp``
        pins the retry after a UDS-level failure back onto TCP."""
        pool = getattr(self._pool, "conns", None)
        if pool is None:
            pool = self._pool.conns = {}
        key = (node.node_id, node.address)
        conn = pool.get(key)
        if conn is None:
            uds = None if force_tcp else node.uds
            if uds and os.path.exists(uds):
                conn = _UDSHTTPConnection(
                    uds, node.host, node.port,
                    timeout=self.connect_timeout_s,
                )
            else:
                conn = http.client.HTTPConnection(
                    node.host, node.port, timeout=self.connect_timeout_s
                )
            pool[key] = conn
        return conn

    def _drop_upstream(self, node: membership.NodeInfo) -> None:
        pool = getattr(self._pool, "conns", None)
        if pool is None:
            return
        conn = pool.pop((node.node_id, node.address), None)
        if conn is not None:
            conn.close()

    def _proxy_once(self, node: membership.NodeInfo, method: str,
                    path_q: str, headers: Dict[str, str], body: bytes,
                    deadline_ms: Optional[float], started: float,
                    span=None):
        """One upstream attempt over a pooled keep-alive connection;
        returns (status, header list, body bytes) or raises on
        connection-level failure (the hedge trigger). ``span`` is the
        surrounding attempt span on the traced path (None otherwise): it
        receives the lane actually used (TCP vs UDS) and any in-attempt
        retry attrs, and its presence gates the upstream ``traceparent``
        injection that parents node-side ``serve_request`` trees here."""
        faults.fault_point("node_partition", machine=node.node_id)
        read_timeout = self.upstream_timeout_s
        if deadline_ms is not None:
            remaining = deadline_ms / 1000.0 - (
                timeit.default_timer() - started
            )
            read_timeout = max(0.05, min(read_timeout, remaining))
        fwd = {
            name: value for name, value in headers.items()
            if name not in _HOP_BY_HOP and name != "host"
        }
        fwd["host"] = node.address
        fwd["connection"] = "keep-alive"
        if span is not None:
            # the ambient context is this attempt's span, so the node's
            # serve_request root parents under THIS hedge arm — replacing
            # any client-supplied traceparent (same trace id, new parent)
            ctx = tracing.current()
            if ctx is not None:
                fwd["traceparent"] = tracing.format_traceparent(ctx)
        conn = self._upstream_conn(node)
        was_pooled = conn.sock is not None
        if span is not None:
            span.set_attrs(
                lane="uds" if isinstance(conn, _UDSHTTPConnection)
                else "tcp",
            )
        tried_tcp = False
        while True:
            try:
                if conn.sock is None:
                    conn.timeout = self.connect_timeout_s
                    conn.connect()
                conn.sock.settimeout(read_timeout)
                conn.request(method, path_q, body=body or None, headers=fwd)
                resp = conn.getresponse()
                data = resp.read()
                break
            except Exception:
                self._drop_upstream(node)
                if was_pooled:
                    # a stale keep-alive connection (node restarted, idle
                    # close) is not a node failure: one fresh-connection
                    # retry against the SAME node before the hedge fires
                    was_pooled = False
                    conn = self._upstream_conn(node)
                    if span is not None:
                        span.set_attrs(
                            stale_retry=True,
                            lane="uds" if isinstance(conn, _UDSHTTPConnection)
                            else "tcp",
                        )
                    continue
                if isinstance(conn, _UDSHTTPConnection) and not tried_tcp:
                    # a broken Unix-domain lane (stale advertised path,
                    # perms) is not a node failure either: fall back to the
                    # node's TCP address before spending a hedge
                    tried_tcp = True
                    conn = self._upstream_conn(node, force_tcp=True)
                    if span is not None:
                        span.set_attrs(tcp_fallback=True, lane="tcp")
                    continue
                raise
        if resp.will_close:
            self._drop_upstream(node)
        return resp.status, resp.getheaders(), data

    # ------------------------------------------------------- local endpoints
    def _local_response(self, method: str, path: str, query: str = ""):
        if path in ("/healthcheck", "/healthcheck/"):
            return 200, [("Content-Type", "application/json")], _dumps(
                {"gordo-gateway": "ok", "nodes": len(self.ring.nodes)}
            )
        if path in ("/metrics", "/metrics/"):
            text = shared.render_fleet_text() if shared.enabled() else None
            if text is None:
                text = telemetry.default_registry().render_text()
            return 200, [
                ("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
            ], text.encode()
        if path in ("/gateway/status", "/gateway/status/"):
            return 200, [_JSON], json.dumps(self.status(), sort_keys=True).encode()
        if path in ("/debug/flight", "/debug/flight/"):
            from . import debug

            if not debug.enabled():
                # indistinguishable from an unknown (proxied) path:
                # fall through to routing, which will 503/404 upstream
                return None
            trace_id = None
            for part in query.split("&"):
                name, _, value = part.partition("=")
                if name == "trace" and value:
                    trace_id = unquote(value)
            if trace_id:
                return self._stitched_flight(trace_id)
            doc = self.flight.chrome_trace()
            return 200, [("Content-Type", "application/json")], \
                _dumps(doc)
        return None

    # ----------------------------------------------------- trace stitching
    def _stitched_flight(self, trace_id: str):
        """``GET /debug/flight?trace=<id>``: ONE stitched Chrome-trace
        document — the gateway's own span tree plus the node-side
        subtrees fetched live from every node named in its
        ``gateway_upstream_attempt`` spans. Partial results are explicit,
        never fatal: a dead node or a gated-off node debug surface
        becomes a ``gordoStitch`` entry, not an error. Cross-process span
        linkage is by ids (the injected traceparent), not timestamps —
        each process's ``ts`` offsets are its own monotonic clock."""
        doc = self.flight.chrome_trace(trace_id)
        if doc is None:
            metric_catalog.GATEWAY_TRACE_STITCHES.labels(
                outcome="miss"
            ).inc()
            return 404, [("Content-Type", "application/json")], \
                _dumps({
                    "error": "trace not kept by the gateway",
                    "trace_id": trace_id,
                })
        record = self.flight.find(trace_id)
        node_ids: List[str] = []
        for span in record["spans"]:
            node = (span.get("attrs") or {}).get("node")
            if (
                span["name"] == "gateway_upstream_attempt"
                and node and node not in node_ids
            ):
                node_ids.append(node)
        with self._state_lock:
            live = dict(self._live)
        stitched = []
        fetched = 0
        for node_id in node_ids:
            node = live.get(node_id)
            if node is None:
                stitched.append({
                    "node": node_id, "ok": False,
                    "reason": "not in live membership",
                })
                continue
            subdoc, reason = self._fetch_node_trace(node, trace_id)
            if subdoc is None:
                stitched.append(
                    {"node": node_id, "ok": False, "reason": reason}
                )
                continue
            events = subdoc.get("traceEvents") or []
            for event in events:
                event.setdefault("args", {})["gordo_node"] = node_id
            doc["traceEvents"].extend(events)
            doc["gordoFlight"].extend(subdoc.get("gordoFlight") or [])
            stitched.append(
                {"node": node_id, "ok": True, "events": len(events)}
            )
            fetched += 1
        doc["gordoStitch"] = {
            "trace_id": trace_id,
            "nodes": stitched,
            "complete": fetched == len(node_ids),
        }
        outcome = (
            "full" if fetched == len(node_ids)
            else ("partial" if fetched else "gateway_only")
        )
        metric_catalog.GATEWAY_TRACE_STITCHES.labels(outcome=outcome).inc()
        return 200, [("Content-Type", "application/json")], \
            _dumps(doc)

    def _fetch_node_trace(self, node: membership.NodeInfo, trace_id: str):
        """One node's subtree for ``trace_id`` via its own
        ``/debug/flight?trace=`` — ``(doc, "")`` or ``(None, reason)``;
        a node dying mid-fetch (torn stitch) is a reason, not a raise."""
        try:
            conn = http.client.HTTPConnection(
                node.host, node.port,
                timeout=max(0.5, self.connect_timeout_s),
            )
            try:
                conn.request("GET", f"/debug/flight?trace={trace_id}")
                resp = conn.getresponse()
                payload = resp.read()
            finally:
                conn.close()
        except (OSError, http.client.HTTPException) as exc:
            return None, f"unreachable ({type(exc).__name__})"
        if resp.status == 404:
            return None, "trace not kept (or node debug endpoints off)"
        if resp.status != 200:
            return None, f"status {resp.status}"
        try:
            subdoc = json.loads(payload)
        except ValueError:
            return None, "unparseable response"
        if not isinstance(subdoc, dict):
            return None, "unparseable response"
        return subdoc, ""

    def status(self) -> dict:
        """The /gateway/status document: membership + ring + health."""
        nodes = self.view.poll()
        with self._state_lock:
            draining = set(self._draining)
        share = self.ring.share()
        return {
            "ring": {"vnodes": self.ring.vnodes, "share": share},
            "draining": sorted(draining),
            "nodes": {
                node_id: {
                    "address": info.address,
                    "alive": info.alive,
                    "generation": info.generation,
                    "age_s": round(info.age_s, 3),
                    "draining": node_id in draining,
                }
                for node_id, info in sorted(nodes.items())
            },
        }

    # ----------------------------------------------------- health and drain
    def _health_loop(self):
        while not self._stop_health.wait(self.health_interval_s):
            try:
                self._refresh_membership()
                self._poll_node_health()
            except Exception:  # noqa: BLE001 -- the poller must survive
                logger.exception("gateway health poll failed")

    def _refresh_membership(self):
        nodes = self.view.poll()
        live = {n.node_id: n for n in nodes.values() if n.alive}
        dead = len(nodes) - len(live)
        with self._state_lock:
            previous = set(self._live)
            self._live = live
            self._draining &= set(live)
            draining = len(self._draining)
        if set(live) != set(self.ring.nodes):
            self.ring.rebuild(sorted(live))
            joined = sorted(set(live) - previous)
            left = sorted(previous - set(live))
            if joined or left:
                logger.info(
                    "gateway membership changed: +%s -%s (ring now %s)",
                    joined, left, list(self.ring.nodes),
                )
        metric_catalog.GATEWAY_NODES.labels(state="live").set(len(live))
        metric_catalog.GATEWAY_NODES.labels(state="dead").set(dead)
        metric_catalog.GATEWAY_NODES.labels(state="draining").set(draining)
        for node_id, fraction in self.ring.share().items():
            metric_catalog.GATEWAY_RING_SHARE.labels(node=node_id).set(
                fraction
            )

    def _poll_node_health(self):
        with self._state_lock:
            live = dict(self._live)
        for node_id, node in live.items():
            burn = self._read_latency_burn(node)
            if burn is None:
                continue
            metric_catalog.GATEWAY_NODE_BURN.labels(node=node_id).set(burn)
            with self._state_lock:
                is_draining = node_id in self._draining
            if burn > self.drain_burn_threshold and not is_draining:
                logger.warning(
                    "gateway: node %s latency burn %.1f > %.1f — draining "
                    "(ring segment spills to successors)",
                    node_id, burn, self.drain_burn_threshold,
                )
                with self._state_lock:
                    self._draining.add(node_id)
                metric_catalog.GATEWAY_DRAIN_EVENTS.labels(
                    node=node_id
                ).inc()
                self._prewarm_successors(node_id)
            elif is_draining and burn < self.drain_burn_threshold / 2.0:
                # hysteresis: recover well below the trip point
                logger.info(
                    "gateway: node %s burn %.1f recovered — back in the "
                    "ring", node_id, burn,
                )
                with self._state_lock:
                    self._draining.discard(node_id)

    def _read_latency_burn(self, node: membership.NodeInfo) -> Optional[float]:
        """Worst-model 5m latency burn from the node's /debug/slo (None
        when the endpoint is gated off or unreachable)."""
        try:
            conn = http.client.HTTPConnection(
                node.host, node.port, timeout=max(0.5, self.connect_timeout_s)
            )
            try:
                conn.request("GET", "/debug/slo")
                resp = conn.getresponse()
                payload = resp.read()
            finally:
                conn.close()
            if resp.status != 200:
                return None
            doc = json.loads(payload)
        except (OSError, ValueError):
            return None
        models = (doc.get("local") or {}).get("models") or {}
        worst = 0.0
        for windows in models.values():
            summary = windows.get("5m") or {}
            worst = max(worst, float(summary.get("latency_burn_rate") or 0.0))
        return worst

    def _prewarm_successors(self, draining_node: str):
        """Warm the drained segment's machines on their new primaries so
        the spill lands on hot caches: POST /debug/prewarm runs the real
        warmup pre-registration (param-bank pin + AOT pre-lower) when the
        node's debug surface is enabled; otherwise a metadata GET at least
        faults in the serving-info/model cache."""
        if not self.prewarm_enabled:
            return
        with self._state_lock:
            recent = list(self._recent.items())[-32:]
            live = dict(self._live)
            draining = set(self._draining)
        for machine, project in recent:
            order = self.ring.candidates(machine)
            if not order or order[0] != draining_node:
                continue
            successor = next(
                (live[n] for n in order[1:]
                 if n in live and n not in draining),
                None,
            )
            if successor is None:
                continue
            if self._prewarm_one(successor, project, machine):
                metric_catalog.GATEWAY_PREWARMS.labels(
                    node=successor.node_id
                ).inc()

    def _prewarm_one(self, successor: membership.NodeInfo, project: str,
                     machine: str) -> bool:
        timeout = max(0.5, self.connect_timeout_s)
        target = f"/debug/prewarm?machine={machine}"
        # name the revision the fleet is currently serving for this
        # machine (hot-swap cutover: the successor must warm the NEW
        # artifact, not its boot-time collection)
        revision = self._revision_of(machine)
        if revision:
            target += f"&revision={revision}"
        try:
            conn = http.client.HTTPConnection(
                successor.host, successor.port, timeout=timeout
            )
            try:
                conn.request("POST", target)
                resp = conn.getresponse()
                resp.read()
                if resp.status == 200:
                    return True
            finally:
                conn.close()
        except OSError:
            return False
        # debug endpoints gated off (404) or prewarm failed: fall back to
        # a metadata touch
        try:
            conn = http.client.HTTPConnection(
                successor.host, successor.port, timeout=timeout
            )
            try:
                conn.request(
                    "GET", f"/gordo/v0/{project}/{machine}/metadata"
                )
                resp = conn.getresponse()
                resp.read()
                return resp.status == 200
            finally:
                conn.close()
        except OSError:
            return False



# ----------------------------------------------------------------- CLI mount
def run_gateway(host: str = "0.0.0.0", port: int = 5556,
                directory: Optional[str] = None) -> None:
    """The gateway until SIGTERM or SIGINT (``python -m gordo_tpu_torch
    run-gateway``): a signal begins the drain (responses carry
    ``Connection: close``) and stops the loop; buffered responses are
    flushed before it closes."""
    import signal

    directory = directory or membership.gateway_dir()
    if not directory:
        raise ValueError(
            "gateway needs a membership directory: pass --membership-dir "
            "or set GORDO_TPU_GATEWAY_DIR"
        )
    server = GatewayServer(directory, host=host, port=port)

    def _handle(signum, frame):  # noqa: ARG001 -- the signal handler's signature
        logger.info("gateway: signal %s — draining", signum)
        resilience.begin_drain()
        server.shutdown()

    signal.signal(signal.SIGTERM, _handle)
    signal.signal(signal.SIGINT, _handle)
    try:
        server.serve_forever()
    finally:
        server.server_close()
