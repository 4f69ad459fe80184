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

Not ported yet: ``/metrics``, ``/debug/*`` and ``/gordo/v0/openapi.json``
(ROADMAP.md queue A8), and the breakers, deadlines and output check of
``gordo_tpu/server/resilience.py`` (queue A9). ``?format=parquet`` on a
POST route is refused with 501: the card's machine has no pyarrow.

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
import threading
import time
import timeit
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from .. import __version__, native, resolve_device
from ..models.utils import parse_resolution
from ..serializer import load, load_metadata, load_model_json
from . import fast_codec, views

logger = logging.getLogger(__name__)

_PROJECT_ROUTE = re.compile(r"^/gordo/v0/([^/]+)/(models|revisions|expected-models)/?$")
_MODEL_ROUTE = re.compile(
    r"^/gordo/v0/([^/]+)/([^/]+)/"
    r"(prediction|anomaly/prediction|metadata|healthcheck|download-model)/?$"
)
_TOP_ROUTES = ("/healthcheck", "/readiness", "/server-version")
_POST_ACTIONS = ("prediction", "anomaly/prediction")
# a revision is a plain directory-name token; anything with path separators
# or dot-runs would escape the model collection tree
_REVISION = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


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


def _load_failure_ttl_s() -> float:
    """How long a failed load is answered from the cache; <= 0 disables it."""
    try:
        return float(os.environ.get("GORDO_TPU_LOAD_FAILURE_TTL_S", "30"))
    except ValueError:
        return 30.0


class GordoServer(ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog: socketserver's default of 5 resets connections
    # when more clients than that connect at once
    request_queue_size = 128

    def __init__(self, address, collection_dir: str, device):
        self.collection_dir = collection_dir
        self.revision = os.path.basename(os.path.normpath(collection_dir))
        self.device = device
        expected = os.environ.get("EXPECTED_MODELS")
        self.expected = json.loads(expected) if expected else []
        self.expected_file = os.environ.get("EXPECTED_MODELS_FILE")
        if fast_codec.enabled():
            native.load()  # a failed build fails the start, not a request
        # (revision, name) -> the loaded model; -> (expiry, error) of a
        # failed load; -> the lock its first loader holds
        self._entries: Dict[Tuple[str, str], ModelEntry] = {}
        self._failures: Dict[Tuple[str, str], Tuple[float, BaseException]] = {}
        self._load_locks: Dict[Tuple[str, str], threading.Lock] = {}
        self._entries_lock = threading.Lock()
        super().__init__(address, _Handler)

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
            raise failure
        with lock:
            with self._entries_lock:
                entry, failure = self._cached_entry(key)
            if entry is not None:
                return entry
            if failure is not None:
                raise failure
            directory = os.path.join(self.revision_dir(revision), name)
            if not os.path.exists(os.path.join(directory, "model.json")):
                raise FileNotFoundError(directory)
            try:
                entry = ModelEntry(directory, self.device)
            except Exception as exc:
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


def _is_json(content_type: Optional[str]) -> bool:
    """werkzeug's ``Request.is_json``: the mimetype is ``application/json``
    or ``application/*+json``."""
    mimetype = (content_type or "").split(";", 1)[0].strip().lower()
    return mimetype == "application/json" or (
        mimetype.startswith("application/") and mimetype.endswith("+json"))


class _Handler(BaseHTTPRequestHandler):
    server: GordoServer

    def log_message(self, format, *args):
        logger.debug("%s - %s", self.address_string(), format % args)

    revision = None  # the request's revision, once resolved
    fast = False  # whether the request takes the native codec

    def _send(self, status: int, body, with_revision: bool = True,
              content_type: str = "application/json", headers=()) -> None:
        """Answer ``body``: a dict as JSON (its ``"data"`` may be a
        RawFrame), with the request's revision in it unless
        ``with_revision`` is false, or bytes as they are. A prediction that
        succeeded times its encoding as the ``encode`` phase; the
        ``Server-Timing`` header holds the request's wall time so far, then
        its phases."""
        started = timeit.default_timer()
        if isinstance(body, dict):
            if with_revision:
                body = dict(body, revision=self.revision)
            data = views.response_bytes(body, self.fast)
        else:
            data = body
        if status == 200 and "predict" in self.timings:
            self.timings["encode"] = timeit.default_timer() - started
        entries = [f"request_walltime_s;dur={timeit.default_timer() - self.started}"]
        entries += [f"{name}_s;dur={seconds}" for name, seconds in self.timings.items()]
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Server-Timing", ", ".join(entries))
        for name, value in headers:
            self.send_header(name, value)
        if self.revision:
            self.send_header("revision", self.revision)
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length") or 0))

    def _readiness(self, collection_dir: str):
        """200 when every expected model's artifact is in the collection
        (or none is expected), else 503 with the missing ones."""
        try:
            expected = self.server.expected_models()
        except (OSError, ValueError):
            return self._send(503, {
                "ready": False,
                "missing": [f"(expected-models file {self.server.expected_file!r} unreadable)"],
                "n_missing": 1,
            }, with_revision=False)
        missing = [name for name in expected if not os.path.exists(
            os.path.join(collection_dir, name, "metadata.json"))]
        if missing:
            return self._send(503, {"ready": False, "missing": missing[:20],
                                    "n_missing": len(missing)}, with_revision=False)
        return self._send(200, {"ready": True}, with_revision=False)

    def _expected(self):
        try:
            expected = self.server.expected_models()
        except (OSError, ValueError):
            return self._send(503, {"error": "expected-models file declared but unreadable"},
                              with_revision=False)
        return self._send(200, {"expected-models": expected})

    def _route(self, method: str):
        url = urlsplit(self.path)
        query = parse_qs(url.query, keep_blank_values=True)
        pinned = (query.get("revision") or [""])[0] or self.headers.get("revision")
        self.revision = pinned or self.server.revision
        collection_dir = self.server.revision_dir(self.revision)
        if collection_dir is None:
            return self._send(410, {"error": f"Revision '{pinned}' not found."},
                              with_revision=False)
        path = url.path.rstrip("/") or "/"
        project_match = _PROJECT_ROUTE.match(path)
        model_match = _MODEL_ROUTE.match(path)
        if not (project_match or model_match or path in _TOP_ROUTES):
            return self._send(404, {"message": f"No route {method} {url.path}"})
        if model_match and model_match.group(3) in _POST_ACTIONS and method != "POST":
            return self._send(405, {"message": f"{method} not allowed on {url.path}"},
                              headers=[("Allow", "POST")])
        if path == "/healthcheck":
            return self._send(200, b"")
        if path == "/readiness":
            return self._readiness(collection_dir)
        if path == "/server-version":
            return self._send(200, {"version": __version__})
        if project_match:
            listing = project_match.group(2)
            if listing == "models":
                return self._send(200, views.model_list(collection_dir))
            if listing == "revisions":
                return self._send(200, views.revision_list(collection_dir, self.server.revision))
            return self._expected()
        _, name, action = model_match.groups()
        if action in ("metadata", "healthcheck"):
            directory = os.path.join(collection_dir, name)
            if not os.path.exists(os.path.join(directory, "metadata.json")):
                return self._send(404, {"message": f"No model found for '{name}'"})
            return self._send(200, {
                "gordo-server-version": __version__,
                "metadata": load_metadata(directory),
                "env": {"MODEL_COLLECTION_DIR": self.server.collection_dir},
            })
        try:
            entry = self.server.model_entry(self.revision, name)
        except FileNotFoundError:
            return self._send(404, {"message": f"No such model found: '{name}'"})
        except Exception:  # noqa: BLE001 -- one broken artifact; the rest serve on
            if action == "download-model":
                raise  # the JAX server's generic 500
            logger.exception("Failed to load model %r", name)
            return self._send(500, {"error": f"Model '{name}' failed to load"})
        if action == "download-model":
            return self._send(200, views.download_model(entry.directory),
                              content_type="application/octet-stream",
                              headers=[("Content-Disposition",
                                        "attachment; filename=model.tar.gz")])
        if (query.get("format") or [""])[0] == "parquet":
            return self._send(501, {"error": views.PARQUET_REFUSAL})
        self.fast = fast_codec.request_enabled(self.headers)
        body = self._body() if _is_json(self.headers.get("Content-Type")) else None
        if action == "prediction":
            status, body = views.base_prediction_core(
                entry.detector, body, entry.tags, entry.target_tags, entry.frequency,
                self.fast, self.timings)
        else:
            status, body = views.anomaly_prediction_core(
                entry.detector, body, entry.tags, entry.target_tags,
                entry.frequency, "all_columns" in query, self.fast, self.timings)
        return self._send(status, body)

    def _handle(self, method: str) -> None:
        self.started = timeit.default_timer()
        self.timings: Dict[str, float] = {}
        try:
            self._route(method)
        except Exception:  # noqa: BLE001 -- the server keeps serving
            logger.exception("Unhandled server error: %s %s", method, self.path)
            self._send(500, {"error": "Internal server error"}, with_revision=False)

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")

    def do_PUT(self):
        self._handle("PUT")

    def do_DELETE(self):
        self._handle("DELETE")


def make_server(host: str, port: int, device=None, collection_dir: str = None
                ) -> GordoServer:
    """A bound server of the collection's models, each loaded on ``device``
    (``cuda`` unless ``"cpu"``) at its first request; ``port`` 0 picks a
    free one (``server.server_address`` has it)."""
    collection_dir = collection_dir or os.environ.get("MODEL_COLLECTION_DIR")
    if not collection_dir:
        raise ValueError("MODEL_COLLECTION_DIR is not set")
    return GordoServer((host, port), collection_dir, resolve_device(device))


def run_server(host: str = "0.0.0.0", port: int = 5555, device=None,
               collection_dir: str = None) -> None:
    """Serve until interrupted."""
    server = make_server(host, port, device, collection_dir)
    logger.info("Serving %s on http://%s:%d", server.collection_dir,
                *server.server_address[:2])
    try:
        server.serve_forever()
    finally:
        server.server_close()
