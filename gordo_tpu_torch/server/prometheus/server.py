"""
The Prometheus metrics sidecar: the port's counterpart of
``gordo_tpu/server/prometheus/server.py``, a process of its own that
answers ``/metrics`` and ``/healthcheck``, so that the model server's port
carries no scrape traffic.

The JAX sidecar renders ``prometheus_client``'s multiprocess directory,
which every worker of the pool writes and from which the arbiter's reaper
removes a dead worker's files (``mark_process_dead``). The port has no
``prometheus_client``: its aggregate is the telemetry shards
(observability/shared.py, ``GORDO_TPU_TELEMETRY_DIR``), where each worker's
request families ride beside its catalog (server/prometheus/metrics.py).
The sidecar renders the merge of every shard, the request families and the
catalog, without writing a shard of its own; a dead worker's shard is
removed by the arbiter's reaper (:func:`mark_worker_dead`), so it leaves
the sum. Run it with the pool's telemetry directory in the environment::

    GORDO_TPU_TELEMETRY_DIR=<dir> python -c \\
        "from gordo_tpu_torch.server.prometheus.server import run_metrics_server; \\
         run_metrics_server(port=5556)"
"""

import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ...observability import shared
from .metrics import fleet_text

logger = logging.getLogger(__name__)

METRICS_TYPE = "text/plain; version=0.0.4"


def render() -> bytes:
    """The aggregate exposition of every worker's shard."""
    fleet = shared.render_fleet_text(flush_own=False) or ""
    return (fleet_text() + fleet).encode()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):
        logger.debug("%s - %s", self.address_string(), format % args)

    def do_GET(self):
        if self.path.split("?", 1)[0] == "/metrics":
            status, content_type, body = 200, METRICS_TYPE, render()
        elif self.path.split("?", 1)[0] == "/healthcheck":
            status, content_type, body = 200, "text/plain", b""
        else:
            status, content_type, body = 404, "text/plain", b""
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def build_metrics_server(host: str = "0.0.0.0", port: int = 5556) -> ThreadingHTTPServer:
    """The sidecar's bound server (``port`` 0 picks a free one)."""
    if not shared.enabled():
        logger.warning("GORDO_TPU_TELEMETRY_DIR is not set: the sidecar sees no worker's "
                       "metrics and /metrics will be empty")
    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    return server


def mark_worker_dead(pid: int) -> None:
    """Reap a dead worker's shard (request families and catalog alike)."""
    shared.mark_shard_dead(pid)
    logger.debug("Marked worker %d dead", pid)


def run_metrics_server(host: str = "0.0.0.0", port: int = 5556) -> None:
    """Serve the sidecar until interrupted."""
    logger.info("Starting prometheus metrics sidecar on %s:%s", host, port)
    build_metrics_server(host, port).serve_forever()
