"""
The port's model server: a standard-library ``ThreadingHTTPServer`` with
the JAX package's route table (``gordo_tpu/server/server.py``):

- ``GET  /healthcheck``, ``GET /readiness``, ``GET /server-version``
- ``GET  /gordo/v0/<project>/models``, ``…/revisions``, ``…/expected-models``
- ``POST /gordo/v0/<project>/<name>/prediction`` (the base route:
  ``model-input`` and ``model-output``)
- ``POST /gordo/v0/<project>/<name>/anomaly/prediction``
- ``GET  /gordo/v0/<project>/<name>/metadata`` and ``…/<name>/healthcheck``
  (the same metadata view)
- ``GET  /gordo/v0/<project>/<name>/download-model`` (the artifact as the
  bytes ``serializer.loads`` takes)
- ``GET  /gordo/v0/openapi.json`` (server/openapi.py)
- ``GET  /metrics`` and ``/debug/*`` (server/debug.py)

The route table is :meth:`GordoServer.dispatch`, which knows nothing of
the transport: it takes a request's method, target, headers and body and
returns its status, headers and body. This module's handler and the socket
fast lanes of server/fastlane.py (``GORDO_TPU_FAST_LANE=1``) answer
through it. The handler speaks HTTP/1.1 with persistent connections: the
body of every request (``Content-Length`` or chunked) is read whole before
the request is answered, whatever the answer, so the next request on the
connection starts at its request line; a client that sends ``Connection:
close``, or speaks HTTP/1.0 without ``keep-alive``, has its connection
closed after the response. (werkzeug 3.1's threaded server, which serves
the JAX app by default, also answers HTTP/1.1 but closes every connection
after its response; the JAX fast lane keeps them, as this handler does.)

Telemetry (ROADMAP.md item A8, first part), on every lane alike: each
request runs under a trace root that continues its W3C ``traceparent``
(observability/tracing.py) and every response carries ``X-Gordo-Trace``;
the flight recorder keeps the errored and slow traces; the request outcome
feeds the fleet series, the SLO windows and the telemetry shard
(:func:`observe_request_outcome`); ``ENABLE_PROMETHEUS`` (with ``PROJECT``)
adds the reference's request histogram and counter
(server/prometheus/metrics.py). ``/metrics`` is served by those when
``ENABLE_PROMETHEUS`` is set, else by the shard view when
``GORDO_TPU_TELEMETRY_DIR`` is set, else answered 404; the ``/debug/*``
routes are server/debug.py's. Not ported yet: ``/debug/perf`` (A8's
second part), ``/debug/drift``, ``/debug/prewarm`` and the breakers,
deadlines and output check of ``gordo_tpu/server/resilience.py`` (A9).
``?format=parquet`` on a POST route is refused with 501: pyarrow is not
a dependency of the port.

Each artifact under ``MODEL_COLLECTION_DIR`` (one directory per model,
serializer/serializer.py) is loaded at its first request, with its
parameters on the card (``device="cpu"`` serves from the CPU), and kept, as
the JAX package's server loads them: an artifact written after the start
is served at once, a missing one is answered 404, and one that fails to
load is answered 500 ``{"error": "Model '<name>' failed to load"}``, the
failure cached for ``GORDO_TPU_LOAD_FAILURE_TTL_S`` seconds (30; 0 retries
every request), while the other models serve on. Requests run concurrently,
to one model as to many, as the JAX package's server runs them: a predict
reads the detector and writes nothing to it, and with the cross-model
batcher on (server/batcher.py, which ``run-server`` turns on) concurrent
predicts of one spec fuse into one device call. Request bodies are parsed
and responses encoded by the native codec (server/fast_codec.py), whose
library is built when the server starts unless ``GORDO_TPU_FAST_CODEC=0``.
The revision is the collection directory's name, as in the
JAX package's server; a request to any route may name another revision, a
sibling collection directory, with ``?revision=`` or a ``revision``
header: its models are loaded at their first request and kept, and a
revision that does not exist is answered 410. ``/readiness`` and
``…/expected-models`` read the expected fleet from ``EXPECTED_MODELS`` (a
JSON list), else from the file ``EXPECTED_MODELS_FILE`` names, read at each
call; a declared file that cannot be read is answered 503. Non-finite
floats in a JSON body are written as null, and an unhandled error is
answered 500 ``{"error": "Internal server error"}``, as the JAX package's
server answers them. Every response carries ``Server-Timing``:
``request_walltime_s`` first, then the ``decode_s``, ``predict_s`` and
``encode_s`` phases a prediction request entered. The prediction routes
take POST alone (405 otherwise, with ``Allow: POST``); the other routes
take any method, as werkzeug's rules without methods do; a prediction body
not sent as JSON (``Content-Type`` ``application/json`` or
``application/*+json``) has no X.

Run it with ``python -m gordo_tpu_torch run-server --port 5555``.
"""

import json
import logging
import os
import re
import socket
import threading
import time
import timeit
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from .. import __version__, native, resolve_device
from ..models.utils import parse_resolution
from ..observability import device as device_telemetry
from ..observability import flight, metrics as metric_catalog, shared, slo, telemetry, tracing
from ..serializer import load, load_metadata, load_model_json
from . import batcher, debug, fast_codec, views
from .openapi import openapi_document
from .prometheus import GordoServerPrometheusMetrics

logger = logging.getLogger(__name__)

_PROJECT_ROUTE = re.compile(r"^/gordo/v0/([^/]+)/(models|revisions|expected-models)/?$")
_MODEL_ROUTE = re.compile(
    r"^/gordo/v0/([^/]+)/([^/]+)/"
    r"(prediction|anomaly/prediction|metadata|healthcheck|download-model)/?$"
)
OPENAPI_ROUTE = "/gordo/v0/openapi.json"
_TOP_ROUTES = ("/healthcheck", "/readiness", "/server-version", "/metrics", OPENAPI_ROUTE)
# every /debug/* rule of the JAX table: the ported ones (server/debug.py)
# and those that answer 404 until their items land
_DEBUG_ROUTES = (*debug.ROUTES, "/debug/drift", "/debug/prewarm", "/debug/perf")
# the JAX table's werkzeug rules, which label the metrics and traces
_PROJECT_RULE = "/gordo/v0/<gordo_project>/{}"
_MODEL_RULE = "/gordo/v0/<gordo_project>/<gordo_name>/{}"
# the JAX endpoint names of the port's routes (a debug route's name is its
# path's, e.g. debug_flight)
_ENDPOINTS = {
    "/healthcheck": "healthcheck", "/readiness": "readiness",
    "/server-version": "server_version", "/metrics": "metrics", OPENAPI_ROUTE: "openapi_spec",
    "models": "model_list", "revisions": "revision_list", "expected-models": "expected_models",
    "prediction": "base_prediction", "anomaly/prediction": "anomaly_prediction",
    "metadata": "metadata_view", "healthcheck": "metadata_view",
    "download-model": "download_model",
}
METRICS_TYPE = "text/plain; version=0.0.4"
_POST_ACTIONS = ("prediction", "anomaly/prediction")
# a revision is a plain directory-name token; anything with path separators
# or dot-runs would escape the model collection tree
_REVISION = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")
# a request head or body beyond these is a client error, not a reason to
# buffer unbounded bytes per connection
MAX_HEAD_BYTES = 64 * 1024
MAX_BODY_BYTES = 256 * 1024 * 1024


class ModelEntry:
    """One served model: the detector on the device, its directory, tags,
    resolution and metadata."""

    def __init__(self, directory: str, device):
        spec = load_model_json(directory)
        self.directory = directory
        self.detector = load(directory, device)
        self.tags = spec["tags"]
        self.target_tags = spec["target_tags"]
        self.metadata = load_metadata(directory)
        dataset = self.metadata.get("dataset") or {}
        self.frequency = parse_resolution(dataset.get("resolution", "10min"))


def observe_request_outcome(rule: str, model: str, duration_s: float, status: int,
                            slo_eligible: bool = False) -> None:
    """The per-request fleet and SLO feed, shared by every lane, as in the
    JAX package (``gordo_tpu/server/server.py``): labelled by the matched
    rule and the status class (both bounded), the prediction routes'
    outcomes into their model's SLO windows, then this process's
    telemetry shard flushed (throttled; a no-op without
    ``GORDO_TPU_TELEMETRY_DIR``)."""
    try:
        metric_catalog.FLEET_REQUESTS.labels(endpoint=rule, status=f"{int(status) // 100}xx").inc()
        metric_catalog.FLEET_REQUEST_SECONDS.labels(endpoint=rule).observe(duration_s)
        if slo_eligible and model:
            slo.record(model, duration_s, status)
        shared.flush()
    except Exception:  # noqa: BLE001 -- observability must not fail requests
        logger.debug("request observability feed failed", exc_info=True)


def _load_failure_ttl_s() -> float:
    """How long a failed load is answered from the cache; <= 0 disables it."""
    try:
        return float(os.environ.get("GORDO_TPU_LOAD_FAILURE_TTL_S", "30"))
    except ValueError:
        return 30.0


def _is_json(content_type: Optional[str]) -> bool:
    """werkzeug's ``Request.is_json``: the mimetype is ``application/json``
    or ``application/*+json``."""
    mimetype = (content_type or "").split(";", 1)[0].strip().lower()
    return mimetype == "application/json" or (
        mimetype.startswith("application/") and mimetype.endswith("+json"))


class BadRequest(Exception):
    """A request the transport cannot frame: answered with ``status`` and
    the connection closed."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def read_body(rfile, headers) -> bytes:
    """The request body off a buffered socket file: ``Content-Length``
    bytes, or a ``Transfer-Encoding: chunked`` body (trailers discarded),
    as werkzeug's server reads them; no body without either. Every byte of
    the body is consumed, so the next request on the connection starts at
    its request line. Raises :class:`BadRequest` for a malformed length and
    a body over MAX_BODY_BYTES."""
    if "chunked" in (headers.get("Transfer-Encoding") or "").lower():
        body = bytearray()
        while True:
            line = rfile.readline(MAX_HEAD_BYTES + 1)
            try:
                size = int(line.split(b";", 1)[0].strip(), 16)
            except ValueError:
                raise BadRequest(400, "malformed chunk size") from None
            if size == 0:
                while rfile.readline(MAX_HEAD_BYTES + 1) not in (b"\r\n", b"\n", b""):
                    pass
                return bytes(body)
            if len(body) + size > MAX_BODY_BYTES:
                raise BadRequest(413, "request body too large")
            body += rfile.read(size)
            rfile.readline(MAX_HEAD_BYTES + 1)  # the chunk's CRLF
    length = content_length(headers.get("Content-Length"))
    return rfile.read(length) if length else b""


def content_length(value: Optional[str]) -> int:
    """A ``Content-Length`` header's byte count (0 without one); raises
    :class:`BadRequest` for one that is not a count or is over
    MAX_BODY_BYTES."""
    try:
        length = int(value or 0)
    except ValueError:
        raise BadRequest(400, "malformed Content-Length") from None
    if length < 0:
        raise BadRequest(400, "malformed Content-Length")
    if length > MAX_BODY_BYTES:
        raise BadRequest(413, "request body too large")
    return length


class _Exchange:
    """One request's state while the route table answers it: when it
    started, its revision once resolved, whether it takes the native codec,
    and its phases' seconds."""

    def __init__(self, started: float):
        self.started = started
        self.timings: Dict[str, float] = {}
        self.revision: Optional[str] = None
        self.fast = False
        # the JAX table's rule and endpoint the request matched (None when
        # it matched none), and the model it names
        self.rule: Optional[str] = None
        self.endpoint: Optional[str] = None
        self.model = ""

    def matched(self, rule: str, endpoint: str, model: str = "") -> None:
        self.rule, self.endpoint, self.model = rule, endpoint, model

    def answer(self, status: int, body, with_revision: bool = True,
               content_type: str = "application/json", headers=()) -> Tuple[int, list, bytes]:
        """``(status, headers, bytes)`` of ``body``: a dict as JSON (its
        ``"data"`` may be a RawFrame), with the request's revision in it
        unless ``with_revision`` is false, or bytes as they are. A
        prediction that succeeded times its encoding as the ``encode``
        phase; the ``Server-Timing`` header holds the request's wall time so
        far, then its phases."""
        encode_started = timeit.default_timer()
        if isinstance(body, dict):
            if with_revision:
                body = dict(body, revision=self.revision)
            data = views.response_bytes(body, self.fast)
        else:
            data = body
        if status == 200 and "predict" in self.timings:
            self.timings["encode"] = timeit.default_timer() - encode_started
        entries = [f"request_walltime_s;dur={timeit.default_timer() - self.started}"]
        entries += [f"{name}_s;dur={seconds}" for name, seconds in self.timings.items()]
        out = [("Content-Type", content_type), ("Server-Timing", ", ".join(entries)),
               *headers]
        if self.revision:
            out.append(("revision", self.revision))
        return status, out, data


class GordoServer(ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog: socketserver's default of 5 resets connections
    # when more clients than that connect at once
    request_queue_size = 128

    def __init__(self, address, collection_dir: str, device, bind_and_activate: bool = True):
        self.collection_dir = collection_dir
        self.revision = os.path.basename(os.path.normpath(collection_dir))
        self.device = device
        expected = os.environ.get("EXPECTED_MODELS")
        self.expected = json.loads(expected) if expected else []
        self.expected_file = os.environ.get("EXPECTED_MODELS_FILE")
        if fast_codec.enabled():
            native.load()  # a failed build fails the start, not a request
        # the SLO windows and the device sampler ride every telemetry-shard
        # flush (no-ops until GORDO_TPU_TELEMETRY_DIR enables shards)
        slo.install_shard_hooks()
        device_telemetry.install_shard_hooks()
        self.project = os.environ.get("PROJECT")
        self.prometheus: Optional[GordoServerPrometheusMetrics] = None
        if os.environ.get("ENABLE_PROMETHEUS", "false").lower() in ("1", "true", "yes"):
            self.prometheus = GordoServerPrometheusMetrics(project=self.project)
        # (revision, name) -> the loaded model; -> (expiry, error) of a
        # failed load; -> the lock its first loader holds
        self._entries: Dict[Tuple[str, str], ModelEntry] = {}
        self._failures: Dict[Tuple[str, str], Tuple[float, BaseException]] = {}
        self._load_locks: Dict[Tuple[str, str], threading.Lock] = {}
        self._entries_lock = threading.Lock()
        # the connections open on this server, and how many were accepted
        self._connections = set()
        self._connections_lock = threading.Lock()
        self.accepted = 0
        super().__init__(address, _Handler, bind_and_activate)

    def server_close(self) -> None:
        """Close the listener, end the keep-alive connections waiting for
        their next request (their read side is shut down; a response being
        written still goes out), and wait for the connections' threads."""
        with self._connections_lock:
            for connection in self._connections:
                try:
                    connection.shutdown(socket.SHUT_RD)
                except OSError:
                    pass
        super().server_close()

    @property
    def models(self) -> Dict[str, ModelEntry]:
        """The models of the current revision loaded so far, by name."""
        with self._entries_lock:
            return {name: entry for (revision, name), entry in self._entries.items()
                    if revision == self.revision}

    def revision_dir(self, revision: str) -> Optional[str]:
        """The collection directory of ``revision``, or None if there is no
        such revision."""
        if revision == self.revision:
            return self.collection_dir
        directory = os.path.join(self.collection_dir, "..", revision)
        if _REVISION.match(revision) and ".." not in revision and os.path.isdir(directory):
            return directory
        return None

    def _cached_entry(self, key):
        """(entry, cached failure) of ``key``; both None when neither is
        held. The caller holds ``_entries_lock``."""
        if key in self._entries:
            return self._entries[key], None
        failure = self._failures.get(key)
        if failure is not None:
            if time.monotonic() < failure[0]:
                return None, failure[1]
            del self._failures[key]
        return None, None

    def model_entry(self, revision: str, name: str) -> ModelEntry:
        """The model ``name`` of an existing revision, loaded at its first
        request by one thread while the others wait. Raises
        FileNotFoundError when it has no artifact (never cached: one may be
        written at any time), and re-raises a failed load for the cache's
        TTL."""
        key = (revision, name)
        with self._entries_lock:
            entry, failure = self._cached_entry(key)
            lock = self._load_locks.setdefault(key, threading.Lock())
        if entry is not None:
            return entry
        if failure is not None:
            metric_catalog.MODEL_LOAD_FAILURES.labels(kind="cached").inc()
            raise failure
        with lock:
            with self._entries_lock:
                entry, failure = self._cached_entry(key)
            if entry is not None:
                return entry
            if failure is not None:
                metric_catalog.MODEL_LOAD_FAILURES.labels(kind="cached").inc()
                raise failure
            directory = os.path.join(self.revision_dir(revision), name)
            if not os.path.exists(os.path.join(directory, "model.json")):
                raise FileNotFoundError(directory)
            try:
                entry = ModelEntry(directory, self.device)
            except Exception as exc:
                metric_catalog.MODEL_LOAD_FAILURES.labels(kind="fresh").inc()
                ttl = _load_failure_ttl_s()
                logger.warning("Model %r failed to load (%s: %s); caching the failure for "
                               "%.0f s", name, type(exc).__name__, exc, ttl)
                if ttl > 0:
                    with self._entries_lock:
                        self._failures[key] = (time.monotonic() + ttl, exc)
                raise
            with self._entries_lock:
                self._entries[key] = entry
            return entry

    def expected_models(self) -> list:
        """The expected fleet: ``EXPECTED_MODELS``, else the file
        ``EXPECTED_MODELS_FILE`` names, read at each call. Raises OSError or
        ValueError when a declared file cannot be read."""
        if not self.expected and self.expected_file:
            with open(self.expected_file) as f:
                return json.load(f)
        return self.expected

    # ------------------------------------------------------------ dispatch
    def dispatch(self, method: str, target: str, headers, body: bytes,
                 started: Optional[float] = None) -> Tuple[int, list, bytes]:
        """The answer to one request, whatever carried it: ``method``, the
        request target (path and query), ``headers`` (any mapping whose
        ``get`` takes a header's name in any case) and the body's bytes.
        Returns ``(status, headers, body bytes)``: the headers hold
        ``Content-Type``, ``Server-Timing`` and the revision, never
        ``Content-Length`` or ``Connection``, which are the transport's. Every
        front end of this server (the handler below and the fast lanes of
        server/fastlane.py) answers through it."""
        exchange = _Exchange(timeit.default_timer() if started is None else started)
        return self._observed(exchange, method, urlsplit(target).path, headers,
                              self._route, exchange, method, target, headers, body)

    def _observed(self, exchange: _Exchange, method: str, path: str, headers, handler, *args
                  ) -> Tuple[int, list, bytes]:
        """``handler(*args)``'s answer, under the request's trace root (the
        inbound ``traceparent`` continued, or a fresh trace) and its
        ``serve_request`` span, with ``X-Gordo-Trace`` added; then the
        request's outcome goes to the flight recorder, the Prometheus
        families and :func:`observe_request_outcome`, as the JAX server's
        ``dispatch_request`` feeds them. An unhandled error is a 500."""
        with tracing.request_root(headers.get("traceparent")) as rtrace:
            with telemetry.span("serve_request", method=method) as root_span:
                try:
                    status, out_headers, data = handler(*args)
                except Exception:  # noqa: BLE001 -- the server keeps serving
                    logger.exception("Unhandled server error: %s %s", method, path)
                    status, out_headers, data = exchange.answer(
                        500, {"error": "Internal server error"}, with_revision=False)
                if exchange.rule is not None:
                    root_span.set_attrs(endpoint=exchange.endpoint, rule=exchange.rule)
                    if exchange.model:
                        root_span.set_attrs(model=exchange.model)
            out_headers.append(("X-Gordo-Trace", rtrace.trace_id))
            runtime_s = timeit.default_timer() - exchange.started
            logger.debug("request %s %s -> %d in %.4fs", method, path, status, runtime_s)
        rule = exchange.rule
        flight.default_recorder().observe(rtrace.collector, status=status, duration_s=runtime_s,
                                          endpoint=rule if rule is not None else path,
                                          model=exchange.model)
        if self.prometheus is not None:
            self.prometheus.record(method, rule, path, status, exchange.started)
        observe_request_outcome(rule if rule is not None else "(unmatched)", exchange.model,
                                runtime_s, status,
                                slo_eligible=rule is not None and rule.endswith("/prediction"))
        return status, out_headers, data

    def _readiness(self, exchange: _Exchange, collection_dir: str):
        """200 when every expected model's artifact is in the collection
        (or none is expected), else 503 with the missing ones."""
        try:
            expected = self.expected_models()
        except (OSError, ValueError):
            return exchange.answer(503, {
                "ready": False,
                "missing": [f"(expected-models file {self.expected_file!r} unreadable)"],
                "n_missing": 1,
            }, with_revision=False)
        missing = [name for name in expected if not os.path.exists(
            os.path.join(collection_dir, name, "metadata.json"))]
        if missing:
            return exchange.answer(503, {"ready": False, "missing": missing[:20],
                                         "n_missing": len(missing)}, with_revision=False)
        return exchange.answer(200, {"ready": True}, with_revision=False)

    def _expected(self, exchange: _Exchange):
        try:
            expected = self.expected_models()
        except (OSError, ValueError):
            return exchange.answer(503, {"error": "expected-models file declared but unreadable"},
                                   with_revision=False)
        return exchange.answer(200, {"expected-models": expected})

    def prediction_request(self, name: str, action: str, query: str, headers, body: bytes,
                           started: Optional[float] = None, path: Optional[str] = None
                           ) -> Tuple[int, list, bytes]:
        """The answer to a POST to one of the two prediction routes of model
        ``name`` (``action`` ``"prediction"`` or ``"anomaly/prediction"``),
        the route table's own handler of them: what :meth:`dispatch` answers
        for the same request, its telemetry included. The fast lanes call it
        for their hot routes, with the request's ``path``."""
        exchange = _Exchange(timeit.default_timer() if started is None else started)
        exchange.matched(_MODEL_RULE.format(action), _ENDPOINTS[action], name)
        return self._observed(exchange, "POST", path or f"/gordo/v0/-/{name}/{action}", headers,
                              self._prediction, exchange, name, action, query, headers, body)

    def _prediction(self, exchange: _Exchange, name: str, action: str, query: str, headers,
                    body: bytes):
        parsed = parse_qs(query, keep_blank_values=True)
        refusal = self._resolve_revision(exchange, parsed, headers)
        if refusal is not None:
            return refusal
        return self._model_action(exchange, name, action, parsed, headers, body)

    def _resolve_revision(self, exchange: _Exchange, query: dict, headers):
        """Set the request's revision (``?revision=``, else the ``revision``
        header, else the served one); the 410 answer when it does not exist,
        else None."""
        pinned = (query.get("revision") or [""])[0] or headers.get("revision")
        exchange.revision = pinned or self.revision
        if self.revision_dir(exchange.revision) is None:
            return exchange.answer(410, {"error": f"Revision '{pinned}' not found."},
                                   with_revision=False)
        return None

    def _route(self, exchange: _Exchange, method: str, target: str, headers, body: bytes):
        url = urlsplit(target)
        query = parse_qs(url.query, keep_blank_values=True)
        path = local_path(url.path, headers).rstrip("/") or "/"
        project_match = _PROJECT_ROUTE.match(path)
        model_match = _MODEL_ROUTE.match(path)
        if project_match:
            listing = project_match.group(2)
            exchange.matched(_PROJECT_RULE.format(listing), _ENDPOINTS[listing])
        elif model_match:
            exchange.matched(_MODEL_RULE.format(model_match.group(3)),
                             _ENDPOINTS[model_match.group(3)], model_match.group(2))
        elif path in _TOP_ROUTES or path in _DEBUG_ROUTES:
            exchange.matched(path, _ENDPOINTS.get(path) or path.strip("/").replace("/", "_"))
        refusal = self._resolve_revision(exchange, query, headers)
        if refusal is not None:
            return refusal
        collection_dir = self.revision_dir(exchange.revision)
        if exchange.rule is None:
            return exchange.answer(404, {"message": f"No route {method} {url.path}"})
        if model_match and model_match.group(3) in _POST_ACTIONS and method != "POST":
            return exchange.answer(405, {"message": f"{method} not allowed on {url.path}"},
                                   headers=[("Allow", "POST")])
        if path in _DEBUG_ROUTES:
            answer = debug.dispatch(exchange.endpoint, url.query) if path in debug.ROUTES else None
            if answer is None:  # the gate is off, or the route is not ported yet
                return exchange.answer(404, {"message": f"No route {method} {url.path}"})
            status, content_type, data = answer
            return exchange.answer(status, data, content_type=content_type)
        if path == "/metrics":
            return self._metrics(exchange)
        if path == "/healthcheck":
            return exchange.answer(200, b"")
        if path == "/readiness":
            return self._readiness(exchange, collection_dir)
        if path == "/server-version":
            return exchange.answer(200, {"version": __version__})
        if path == OPENAPI_ROUTE:
            return exchange.answer(200, json.dumps(openapi_document()).encode())
        if project_match:
            if listing == "models":
                return exchange.answer(200, views.model_list(collection_dir))
            if listing == "revisions":
                return exchange.answer(200, views.revision_list(collection_dir, self.revision))
            return self._expected(exchange)
        _, name, action = model_match.groups()
        if action in ("metadata", "healthcheck"):
            directory = os.path.join(collection_dir, name)
            if not os.path.exists(os.path.join(directory, "metadata.json")):
                return exchange.answer(404, {"message": f"No model found for '{name}'"})
            return exchange.answer(200, {
                "gordo-server-version": __version__,
                "metadata": load_metadata(directory),
                "env": {"MODEL_COLLECTION_DIR": self.collection_dir},
            })
        return self._model_action(exchange, name, action, query, headers, body)

    def _metrics(self, exchange: _Exchange):
        """``/metrics``: the Prometheus families and the catalog with
        ``ENABLE_PROMETHEUS``, else the shard view with
        ``GORDO_TPU_TELEMETRY_DIR``, else 404, as the JAX server answers."""
        if self.prometheus is not None:
            return exchange.answer(200, self.prometheus.expose(), content_type=METRICS_TYPE)
        fleet = shared.render_fleet_text()
        if fleet is None:
            return exchange.answer(404, b"metrics disabled", content_type="text/plain")
        return exchange.answer(200, fleet.encode(), content_type=METRICS_TYPE)

    def _model_action(self, exchange: _Exchange, name: str, action: str, query: dict, headers,
                      body: bytes):
        """A route that loads model ``name``: ``download-model`` or a
        prediction (``body`` read as X and y only when sent as JSON)."""
        try:
            entry = self.model_entry(exchange.revision, name)
        except FileNotFoundError:
            return exchange.answer(404, {"message": f"No such model found: '{name}'"})
        except Exception:  # noqa: BLE001 -- one broken artifact; the rest serve on
            if action == "download-model":
                raise  # the JAX server's generic 500
            logger.exception("Failed to load model %r", name)
            return exchange.answer(500, {"error": f"Model '{name}' failed to load"})
        if action == "download-model":
            return exchange.answer(200, views.download_model(entry.directory),
                                   content_type="application/octet-stream",
                                   headers=[("Content-Disposition",
                                             "attachment; filename=model.tar.gz")])
        if (query.get("format") or [""])[0] == "parquet":
            return exchange.answer(501, {"error": views.PARQUET_REFUSAL})
        exchange.fast = fast_codec.request_enabled(headers)
        if not _is_json(headers.get("Content-Type")):
            body = None
        with batcher.request_model(name):
            if action == "prediction":
                status, out = views.base_prediction_core(
                    entry.detector, body, entry.tags, entry.target_tags, entry.frequency,
                    exchange.fast, exchange.timings)
            else:
                status, out = views.anomaly_prediction_core(
                    entry.detector, body, entry.tags, entry.target_tags,
                    entry.frequency, "all_columns" in query, exchange.fast, exchange.timings)
        return exchange.answer(status, out)


def local_path(path: str, headers) -> str:
    """``path`` without the prefix of a prefixed ingress, as the JAX app's
    ``adapt_proxy_deployment`` strips it: the prefix is
    ``X-Envoy-Original-Path`` (its path part) less the local path when it
    ends with it, else the header's path itself; without that header,
    ``X-Forwarded-Prefix``. It is stripped at a segment boundary only."""
    original = (headers.get("X-Envoy-Original-Path") or "").split("?", 1)[0]
    if original:
        local, stripped = path.rstrip("/"), original.rstrip("/")
        prefix = stripped[:-len(local)] if local and stripped.endswith(local) else original
    else:
        prefix = headers.get("X-Forwarded-Prefix") or ""
    prefix = prefix.rstrip("/")
    if prefix and path == prefix:
        return "/"
    if prefix and path.startswith(prefix + "/"):
        return path[len(prefix):]
    return path


def client_keep_alive(version: str, connection: Optional[str]) -> bool:
    """Whether a client keeps its connection after this request: HTTP/1.1
    unless it sends ``Connection: close``, HTTP/1.0 only with
    ``Connection: keep-alive``."""
    connection = (connection or "").lower()
    if "close" in connection:
        return False
    if version == "HTTP/1.0":
        return "keep-alive" in connection
    return True


class _Handler(BaseHTTPRequestHandler):
    """HTTP/1.1 with persistent connections, as the JAX package's fast lane
    speaks it: the body of every request is read whole before it is
    answered, whatever the answer, so the next request on the connection
    starts at its request line."""

    server: GordoServer
    protocol_version = "HTTP/1.1"
    # a connection idle (or stalled) this long is closed
    timeout = 75.0
    # TCP_NODELAY: on a kept connection a response must not wait for the
    # client's delayed ACK of the previous one (Nagle's algorithm)
    disable_nagle_algorithm = True

    def setup(self):
        super().setup()
        with self.server._connections_lock:
            self.server._connections.add(self.connection)
            self.server.accepted += 1

    def finish(self):
        with self.server._connections_lock:
            self.server._connections.discard(self.connection)
        super().finish()

    def log_message(self, format, *args):
        logger.debug("%s - %s", self.address_string(), format % args)

    def _write(self, status: int, headers, data: bytes) -> None:
        """The response, its head and body in one write."""
        self.send_response(status)
        for name, value in headers:
            self.send_header(name, value)
        self.send_header("Content-Length", str(len(data)))
        keep = not self.close_connection
        self.send_header("Connection", "keep-alive" if keep else "close")
        self._headers_buffer.extend((b"\r\n", data))
        self.flush_headers()

    def _handle(self, method: str) -> None:
        started = timeit.default_timer()
        self.close_connection = not client_keep_alive(self.request_version,
                                                      self.headers.get("Connection"))
        try:
            body = read_body(self.rfile, self.headers)
        except BadRequest as exc:
            self.close_connection = True
            return self._write(exc.status, [("Content-Type", "application/json")],
                               json.dumps({"error": exc.message}).encode())
        self._write(*self.server.dispatch(method, self.path, self.headers, body, started))

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")

    def do_PUT(self):
        self._handle("PUT")

    def do_DELETE(self):
        self._handle("DELETE")


def make_server(host: str, port: int, device=None, collection_dir: str = None,
                bind_and_activate: bool = True) -> GordoServer:
    """A bound server of the collection's models, each loaded on ``device``
    (``cuda`` unless ``"cpu"``) at its first request; ``port`` 0 picks a
    free one (``server.server_address`` has it). With ``bind_and_activate``
    false it opens no socket: a fast lane serves its :meth:`dispatch`."""
    collection_dir = collection_dir or os.environ.get("MODEL_COLLECTION_DIR")
    if not collection_dir:
        raise ValueError("MODEL_COLLECTION_DIR is not set")
    return GordoServer((host, port), collection_dir, resolve_device(device), bind_and_activate)


def make_front_end(host: str, port: int, device=None, collection_dir: str = None,
                   fd: Optional[int] = None):
    """``(app, server)``: the server of the collection (``app``) and the
    front end that serves it: the socket fast lane (server/fastlane.py) when
    ``GORDO_TPU_FAST_LANE=1``, as the JAX ``run_server`` mounts it, else the
    server itself with this module's handler. ``fd`` adopts a listening
    socket (one that prefork workers share) instead of binding
    ``host:port``."""
    from . import fastlane

    if fastlane.enabled():
        app = make_server(host, port, device, collection_dir, bind_and_activate=False)
        return app, fastlane.make_server(app, host, port, fd=fd)
    app = make_server(host, port, device, collection_dir, bind_and_activate=fd is None)
    if fd is not None:
        app.socket.close()
        app.socket = socket.socket(socket.AF_INET, socket.SOCK_STREAM, fileno=os.dup(fd))
        app.server_address = app.socket.getsockname()
    return app, app


def run_server(host: str = "0.0.0.0", port: int = 5555, device=None,
               collection_dir: str = None, fd: Optional[int] = None) -> None:
    """Serve until interrupted (:func:`make_front_end`)."""
    app, server = make_front_end(host, port, device, collection_dir, fd)
    logger.info("Serving %s on port %d (%s)", app.collection_dir,
                getattr(server, "server_port", None) or server.server_address[1],
                type(server).__name__)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if app is not server:
            app.server_close()
