"""
In-process session: drive the port's server with the session API the
Client expects, without sockets. The port's counterpart of
``gordo_tpu/client/testing.py``'s ``WSGISession``, over
``GordoServer.dispatch`` (the transport-free route table every front end
of the server answers through): ``Client(session=DispatchSession(server))``
talks to a server made with ``make_server(..., bind_and_activate=False)``.
"""

import json as _json
from typing import Any, Optional
from urllib.parse import urlencode, urlsplit

from .io import Response, header_map


class DispatchSession:
    """``get`` / ``post`` against a ``GordoServer``'s ``dispatch``. The route
    table is called from the caller's thread, as the server's handler
    threads call it, so the Client may fan out over a thread pool."""

    def __init__(self, server: Any):
        self.server = server

    @staticmethod
    def _target(url: str, params: Optional[dict]) -> str:
        parts = urlsplit(url)
        query = parts.query
        if params:
            extra = urlencode(params)
            query = f"{query}&{extra}" if query else extra
        return f"{parts.path}?{query}" if query else parts.path

    def _call(self, method: str, url: str, params, headers, body: bytes) -> Response:
        status, out_headers, data = self.server.dispatch(
            method, self._target(url, params), header_map(headers or {}), body)
        return Response(status, header_map(out_headers), data)

    def get(self, url: str, params: Optional[dict] = None, headers: Optional[dict] = None,
            **kwargs) -> Response:
        return self._call("GET", url, params, headers, b"")

    def post(self, url: str, params: Optional[dict] = None, json: Any = None,
             data: Optional[bytes] = None, headers: Optional[dict] = None,
             **kwargs) -> Response:
        headers = dict(headers or {})
        if json is not None:
            data = _json.dumps(json, allow_nan=False).encode()
            headers.setdefault("Content-Type", "application/json")
        return self._call("POST", url, params, headers, data or b"")
