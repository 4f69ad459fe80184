"""
The chaos fleet's serving node, ``python -m gordo_tpu_torch.chaos.node``:
the port's copy of ``gordo_tpu/chaos/node.py``.

A lease-holding member of the gateway's fleet with the serving resilience
pieces (the membership lease and heartbeat of server/membership.py, the
per-model circuit breakers of server/resilience.py, the serving fault
sites of util/faults.py) and no model stack: it initialises no CUDA, so a
SIGKILL or SIGSTOP from the conductor is an OS signal against a real lease
heartbeat, on the host alone.

Routes:

- ``GET /healthcheck``: liveness;
- ``GET /debug/slo``: the worst-model ``latency_burn_rate`` the gateway's
  drain poller reads, from a sliding window of this node's latencies
  against ``GORDO_TPU_CHAOS_NODE_SLO_MS``;
- ``GET /chaos/breakers``: ``{model: breaker state}`` for the
  ``breaker_scoped`` invariant;
- ``GET /debug/flight`` (``?trace=<id>``): the node's flight recorder as a
  Chrome-trace document, gated by ``GORDO_TPU_DEBUG_ENDPOINTS`` as the
  serving node's debug surface is; the gateway's stitcher fetches it;
- ``/gordo/v0/<project>/<machine>/...``: the serving path. The first hit
  of a machine passes ``serve_model_load``, every hit ``serve_predict`` and
  then ``serve_device_call`` (``GORDO_TPU_CHAOS_NODE_WORK_MS`` of sleep),
  all behind the machine's breaker; an injected transient answers 503 with
  ``Retry-After``, a permanent 500.

A request with a ``traceparent`` gets the node-side span tree
(``serve_request``, ``serve_batch_queue``, ``serve_device_call``), an
``X-Gordo-Trace`` echo and a flight-recorder observation.

On its standard output the node prints one ``CHAOS-NODE READY <node_id>
<port>`` line once its lease is registered and its socket listens.
"""

import argparse
import collections
import json
import os
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..observability import flight, telemetry, tracing
from ..server import membership, resilience
from ..util import faults

_BURN_WINDOW = 200


def _debug_enabled() -> bool:
    # server/debug.py's gate, inlined: the node imports no serving stack
    return os.environ.get("GORDO_TPU_DEBUG_ENDPOINTS", "").lower() in (
        "1", "true", "yes",
    )


def _query_param(query: str, name: str):
    for part in query.split("&"):
        key, _, value = part.partition("=")
        if key == name and value:
            return urllib.parse.unquote(value)
    return None


def _slo_s() -> float:
    try:
        return max(0.001, float(os.environ.get("GORDO_TPU_CHAOS_NODE_SLO_MS", 250)) / 1000.0)
    except ValueError:
        return 0.25


def _work_s() -> float:
    try:
        return max(0.0, float(os.environ.get("GORDO_TPU_CHAOS_NODE_WORK_MS", 2)) / 1000.0)
    except ValueError:
        return 0.002


class ChaosNode:
    def __init__(self, directory: str, node_id: str, host: str = "127.0.0.1",
                 port: int = 0):
        self.node_id = node_id
        self.hits = 0
        self._latencies = collections.deque(maxlen=_BURN_WINDOW)
        self._loaded = set()
        self._lock = threading.Lock()
        # traced requests only land here; the recent ring (default on for
        # the drill fleet) keeps fast successes resolvable for stitching
        self.flight = flight.FlightRecorder(
            recent=flight.recent_capacity_from_env(default=32)
        )
        node = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self):
                node.handle(self)

            do_POST = do_GET

            def log_message(self, *args):  # noqa: D102 -- stdout carries the READY line alone
                pass

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.registration = membership.NodeRegistration(
            directory, address=f"{host}:{self.port}", node_id=node_id,
        )

    # ------------------------------------------------------------ serving
    def handle(self, req: BaseHTTPRequestHandler) -> None:
        path, _, query = req.path.partition("?")
        if path == "/healthcheck":
            return self._json(req, 200, {"node": self.node_id, "ok": True})
        if path == "/debug/slo":
            return self._json(req, 200, self._slo_doc())
        if path == "/chaos/breakers":
            return self._json(req, 200, {"node": self.node_id,
                                         "breakers": self._breaker_states()})
        if path == "/debug/flight":
            return self._flight(req, query)
        parts = path.split("/")
        if len(parts) >= 5 and parts[1] == "gordo" and parts[2] == "v0":
            return self._serve(req, machine=parts[4])
        return self._json(req, 404, {"error": f"no route {path}"})

    def _flight(self, req: BaseHTTPRequestHandler, query: str) -> None:
        if not _debug_enabled():
            # indistinguishable from an unknown route, like server/debug.py
            return self._json(req, 404, {"error": "no route /debug/flight"})
        trace_id = _query_param(query, "trace")
        if trace_id:
            doc = self.flight.chrome_trace(trace_id)
            if doc is None:
                return self._json(req, 404, {"error": "trace not kept",
                                             "trace_id": trace_id})
            return self._json(req, 200, doc)
        return self._json(req, 200, self.flight.chrome_trace())

    def _serve(self, req: BaseHTTPRequestHandler, machine: str) -> None:
        start = time.monotonic()
        self.hits += 1
        traceparent = req.headers.get("traceparent")
        if traceparent is None:
            status, doc, extra = self._predict(machine)
            self._latencies.append(time.monotonic() - start)
            return self._json(req, status, doc, extra=extra)
        with tracing.request_root(traceparent) as rtrace:
            with telemetry.span("serve_request", method=req.command) as root:
                root.set_attrs(endpoint="prediction", machine=machine,
                               node=self.node_id)
                status, doc, extra = self._predict(machine)
                root.set_attrs(status=status)
        duration = time.monotonic() - start
        self._latencies.append(duration)
        self.flight.observe(rtrace.collector, status, duration,
                            endpoint="prediction", model=machine)
        extra = list(extra) + [("X-Gordo-Trace", rtrace.trace_id)]
        return self._json(req, status, doc, extra=extra)

    def _predict(self, machine: str):
        """The serving pipeline for one hit: (status, doc, extra headers).
        Span structure mirrors the real fast lane — ``serve_batch_queue``
        (admission + model load) wrapping ``serve_device_call``."""
        breaker = resilience.breaker_for(machine)
        if breaker is not None:
            info = breaker.allow()
            if info is not None:
                header = ("Retry-After",
                          resilience.breaker_retry_after_header(info))
                return 503, info, [header]
        try:
            with telemetry.span("serve_batch_queue", machine=machine):
                with self._lock:
                    cold = machine not in self._loaded
                if cold:
                    # first touch = artifact load; a wedge rule here is the
                    # slow-store stall, a permanent is a corrupt artifact
                    faults.fault_point("serve_model_load", machine=machine)
                    with self._lock:
                        self._loaded.add(machine)
                faults.fault_point("serve_predict", machine=machine)
                with telemetry.span("serve_device_call", machine=machine):
                    faults.fault_point("serve_device_call", machine=machine)
                    time.sleep(_work_s())
        except Exception as exc:  # noqa: BLE001 -- injected faults only
            resilience.record_breaker_failure(breaker, exc)
            transient = faults.is_transient(exc)
            status = 503 if transient else 500
            extra = [("Retry-After", "1")] if transient else []
            return status, {"error": str(exc), "node": self.node_id,
                            "machine": machine}, extra
        resilience.record_breaker_success(breaker)
        return 200, {"node": self.node_id, "machine": machine}, []

    # ---------------------------------------------------------- telemetry
    def _slo_doc(self) -> dict:
        lat = list(self._latencies)
        slo = _slo_s()
        slow = sum(1 for v in lat if v > slo) / len(lat) if lat else 0.0
        # burn = slow fraction over the 5% error budget, the same
        # worst-model shape server/debug.py reports
        burn = slow / 0.05
        return {
            "local": {
                "models": {
                    "_chaos": {"5m": {"latency_burn_rate": burn,
                                      "requests": len(lat)}},
                }
            },
            "node": self.node_id,
        }

    def _breaker_states(self) -> dict:
        with resilience._breakers_lock:
            breakers = dict(resilience._breakers)
        return {model: b.state for model, b in breakers.items()}

    def _json(self, req, status: int, doc: dict, extra=()) -> None:
        body = json.dumps(doc).encode()
        req.send_response(status)
        req.send_header("Content-Type", "application/json")
        req.send_header("Content-Length", str(len(body)))
        for name, value in extra:
            req.send_header(name, value)
        req.end_headers()
        try:
            req.wfile.write(body)
        except OSError:
            pass

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def close(self) -> None:
        self.registration.close()
        self.httpd.shutdown()
        self.httpd.server_close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dir", required=True, help="membership directory")
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    args = parser.parse_args(argv)
    node = ChaosNode(args.dir, args.node_id, args.host, args.port)
    print(f"CHAOS-NODE READY {node.node_id} {node.port}", flush=True)
    try:
        node.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        node.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
