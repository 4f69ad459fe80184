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
(ROADMAP.md queue A8), ``?format=parquet``, and the breakers, deadlines
and output check of ``gordo_tpu/server/resilience.py`` (queue A9).

Every artifact under ``MODEL_COLLECTION_DIR`` (one directory per model,
serializer/serializer.py) is loaded once at start, with its parameters on
the card (``device="cpu"`` serves from the CPU). Requests to one model run
one at a time. The revision is the collection directory's name, as in the
JAX package's server; a request to any route may name another revision, a
sibling collection directory, with ``?revision=`` or a ``revision``
header: its models are loaded at their first request and kept, and a
revision that does not exist is answered 410. ``/readiness`` and
``…/expected-models`` read the expected fleet from ``EXPECTED_MODELS`` (a
JSON list), else from the file ``EXPECTED_MODELS_FILE`` names, read at each
call; a declared file that cannot be read is answered 503. Non-finite
floats in a JSON body are written as null, and an unhandled error is
answered 500 ``{"error": "Internal server error"}``, as the JAX package's
server answers them.

Run it with ``python -m gordo_tpu_torch run-server --port 5555``.
"""

import json
import logging
import math
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlsplit

from .. import __version__, resolve_device
from ..models.utils import parse_resolution
from ..serializer import load, load_metadata, load_model_json
from . import views

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
        self.lock = threading.Lock()


def load_collection(collection_dir: str, device) -> Dict[str, ModelEntry]:
    models = {}
    for name in sorted(os.listdir(collection_dir)):
        directory = os.path.join(collection_dir, name)
        if os.path.exists(os.path.join(directory, "model.json")):
            models[name] = ModelEntry(directory, device)
    return models


def _without_nan(value):
    """``value`` with every non-finite float replaced by None, as
    ``simplejson.dumps(..., ignore_nan=True)`` writes it."""
    if isinstance(value, float):
        return value if math.isfinite(value) else None
    if isinstance(value, dict):
        return {key: _without_nan(v) for key, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_without_nan(v) for v in value]
    return value


def _json_bytes(body) -> bytes:
    """``body`` as JSON, with null for every non-finite float."""
    try:
        return json.dumps(body, allow_nan=False).encode()
    except ValueError:
        return json.dumps(_without_nan(body), allow_nan=False).encode()


class GordoServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, address, collection_dir: str, device):
        self.collection_dir = collection_dir
        self.revision = os.path.basename(os.path.normpath(collection_dir))
        self.device = device
        expected = os.environ.get("EXPECTED_MODELS")
        self.expected = json.loads(expected) if expected else []
        self.expected_file = os.environ.get("EXPECTED_MODELS_FILE")
        self.models = load_collection(collection_dir, device)
        # revision -> its models: the current one at start, others at their
        # first model request
        self._revisions = {self.revision: self.models}
        self._revisions_lock = threading.Lock()
        super().__init__(address, _Handler)

    def revision_dir(self, revision: str) -> Optional[str]:
        """The collection directory of ``revision``, or None if there is no
        such revision."""
        if revision == self.revision:
            return self.collection_dir
        directory = os.path.join(self.collection_dir, "..", revision)
        if _REVISION.match(revision) and ".." not in revision and os.path.isdir(directory):
            return directory
        return None

    def revision_models(self, revision: str) -> Dict[str, ModelEntry]:
        """The models of an existing revision, loaded at the first call."""
        with self._revisions_lock:
            if revision not in self._revisions:
                self._revisions[revision] = load_collection(
                    self.revision_dir(revision), self.device
                )
            return self._revisions[revision]

    def expected_models(self) -> list:
        """The expected fleet: ``EXPECTED_MODELS``, else the file
        ``EXPECTED_MODELS_FILE`` names, read at each call. Raises OSError or
        ValueError when a declared file cannot be read."""
        if not self.expected and self.expected_file:
            with open(self.expected_file) as f:
                return json.load(f)
        return self.expected


class _Handler(BaseHTTPRequestHandler):
    server: GordoServer

    def log_message(self, format, *args):
        logger.debug("%s - %s", self.address_string(), format % args)

    revision = None  # the request's revision, once resolved

    def _send(self, status: int, body, with_revision: bool = True,
              content_type: str = "application/json", headers=()) -> None:
        """Answer ``body``: a dict as JSON, with the request's revision in
        it unless ``with_revision`` is false, or bytes as they are."""
        if isinstance(body, dict):
            if with_revision:
                body = dict(body, revision=self.revision)
            data = _json_bytes(body)
        else:
            data = body
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for name, value in headers:
            self.send_header(name, value)
        if self.revision:
            self.send_header("revision", self.revision)
        self.end_headers()
        self.wfile.write(data)

    def _payload(self):
        length = int(self.headers.get("Content-Length") or 0)
        try:
            return json.loads(self.rfile.read(length) or b"null")
        except ValueError:
            return None

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
        allowed = "POST" if model_match and model_match.group(3) in _POST_ACTIONS else "GET"
        if method != allowed:
            return self._send(405, {"message": f"{method} not allowed on {url.path}"})
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
        entry = self.server.revision_models(self.revision).get(name)
        if entry is None:
            found = "No model found for" if action in ("metadata", "healthcheck") else (
                "No such model found:")
            return self._send(404, {"message": f"{found} '{name}'"})
        if action in ("metadata", "healthcheck"):
            return self._send(200, {
                "gordo-server-version": __version__,
                "metadata": entry.metadata,
                "env": {"MODEL_COLLECTION_DIR": self.server.collection_dir},
            })
        if action == "download-model":
            return self._send(200, views.download_model(entry.directory),
                              content_type="application/octet-stream",
                              headers=[("Content-Disposition",
                                        "attachment; filename=model.tar.gz")])
        payload = self._payload()
        with entry.lock:
            if action == "prediction":
                status, body = views.base_prediction_core(
                    entry.detector, payload, entry.tags, entry.target_tags, entry.frequency)
            else:
                status, body = views.anomaly_prediction_core(
                    entry.detector, payload, entry.tags, entry.target_tags,
                    entry.frequency, "all_columns" in query)
        return self._send(status, body)

    def _handle(self, method: str) -> None:
        try:
            self._route(method)
        except Exception:  # noqa: BLE001 -- the server keeps serving
            logger.exception("Unhandled server error: %s %s", method, self.path)
            self._send(500, {"error": "Internal server error"}, with_revision=False)

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")


def make_server(host: str, port: int, device=None, collection_dir: str = None
                ) -> GordoServer:
    """A bound server with every model of the collection loaded on
    ``device`` (``cuda`` unless ``"cpu"``); ``port`` 0 picks a free one
    (``server.server_address`` has it)."""
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
