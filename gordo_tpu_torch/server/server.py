"""
The port's model server: a standard-library ``ThreadingHTTPServer`` with

- ``GET  /healthcheck``
- ``POST /gordo/v0/<project>/<name>/anomaly/prediction``
- ``GET  /gordo/v0/<project>/<name>/metadata``

Every artifact under ``MODEL_COLLECTION_DIR`` (one directory per model,
serializer/serializer.py) is loaded once at start, with its parameters on
the card (``device="cpu"`` serves from the CPU). Requests to one model run
one at a time. The revision is the collection directory's name, as in the
JAX package's server; a request may name another revision, a sibling
collection directory, with ``?revision=`` or a ``revision`` header: it is
loaded at its first request and kept, and a revision that does not exist is
answered 410. Non-finite floats in a JSON body are written as null, and an
unhandled error is answered 500 ``{"error": "Internal server error"}``, as
the JAX package's server answers them.

Run it with ``python -m gordo_tpu_torch.server.server --port 5555``.
"""

import argparse
import json
import logging
import math
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict
from urllib.parse import parse_qs, urlsplit

from .. import __version__, resolve_device
from ..models.utils import parse_resolution
from ..serializer import load, load_metadata, load_model_json
from .views import anomaly_prediction_core

logger = logging.getLogger(__name__)

_MODEL_ROUTE = re.compile(r"^/gordo/v0/([^/]+)/([^/]+)/(anomaly/prediction|metadata)$")
# a revision is a plain directory-name token; anything with path separators
# or dot-runs would escape the model collection tree
_REVISION = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


class ModelEntry:
    """One served model: the detector on the device, its tags, its
    resolution and its metadata."""

    def __init__(self, directory: str, device):
        spec = load_model_json(directory)
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
        self.models = load_collection(collection_dir, device)
        # revision -> its models: the current one at start, others at their
        # first request
        self._revisions = {self.revision: self.models}
        self._revisions_lock = threading.Lock()
        super().__init__(address, _Handler)

    def revision_models(self, revision: str):
        """The models of a sibling revision of the served collection, or
        None if there is no such revision."""
        with self._revisions_lock:
            if revision not in self._revisions:
                directory = os.path.join(self.collection_dir, "..", revision)
                if not (_REVISION.match(revision) and ".." not in revision
                        and os.path.isdir(directory)):
                    return None
                self._revisions[revision] = load_collection(directory, self.device)
            return self._revisions[revision]


class _Handler(BaseHTTPRequestHandler):
    server: GordoServer

    def log_message(self, format, *args):
        logger.debug("%s - %s", self.address_string(), format % args)

    revision = None  # the request's revision, once resolved

    def _send(self, status: int, body, with_revision: bool = True) -> None:
        """Answer ``body``: a dict as JSON, with the request's revision in
        it unless ``with_revision`` is false, or bytes as they are."""
        if isinstance(body, dict):
            if with_revision:
                body = dict(body, revision=self.revision)
            data = _json_bytes(body)
        else:
            data = body
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if self.revision:
            self.send_header("revision", self.revision)
        self.end_headers()
        self.wfile.write(data)

    def _route(self, method: str):
        url = urlsplit(self.path)
        query = parse_qs(url.query, keep_blank_values=True)
        self.revision = self.server.revision
        pinned = (query.get("revision") or [""])[0] or self.headers.get("revision")
        models = self.server.models
        if pinned:
            self.revision = pinned
            models = self.server.revision_models(pinned)
            if models is None:
                return self._send(410, {"error": f"Revision '{pinned}' not found."},
                                  with_revision=False)
        if url.path == "/healthcheck" and method == "GET":
            return self._send(200, b"")
        match = _MODEL_ROUTE.match(url.path)
        if not match:
            return self._send(404, {"message": f"No route {method} {url.path}"})
        _, name, action = match.groups()
        entry = models.get(name)
        if entry is None:
            return self._send(404, {"message": f"No such model found: '{name}'"})
        if action == "metadata" and method == "GET":
            return self._send(200, {
                "gordo-server-version": __version__,
                "metadata": entry.metadata,
                "env": {"MODEL_COLLECTION_DIR": self.server.collection_dir},
            })
        if action == "anomaly/prediction" and method == "POST":
            length = int(self.headers.get("Content-Length") or 0)
            try:
                payload = json.loads(self.rfile.read(length) or b"null")
            except ValueError:
                payload = None
            all_columns = "all_columns" in query
            with entry.lock:
                status, body = anomaly_prediction_core(
                    entry.detector, payload, entry.tags, entry.target_tags,
                    entry.frequency, all_columns,
                )
            return self._send(status, body)
        return self._send(405, {"message": f"{method} not allowed on {url.path}"})

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
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5555)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    run_server(args.host, args.port, args.device)
