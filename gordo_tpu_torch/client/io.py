"""
HTTP plumbing for the client: the port's counterpart of
``gordo_tpu/client/io.py`` (the typed exceptions, :func:`_handle_response`
with the same classes and message text, :func:`call_with_retry_after` over
the port's fault policy), and :class:`HTTPSession`, the session the JAX
client gets from ``requests`` with its ``Retry`` adapter, on
``http.client``.

:class:`HTTPSession` keeps what the JAX client relies on: ``get`` and
``post`` with ``params``, ``headers``, a ``json`` or ``data`` body and a
``(connect, read)`` ``timeout``. A connection error, a read error, or an
answer whose status is in ``status_forcelist`` (500, 502, 503, 504) or is a
413, 429 or 503 naming a ``Retry-After``, is retried, for GET and POST,
``n_retries`` times in all, after urllib3's backoff (none before the first
retry, then ``backoff_factor`` x 2^(n-1) seconds, at most 120) or, where the
answer names one above 0, its ``Retry-After`` (at most 6 hours). When they
are spent the session raises :class:`RetryError` (a status) or the
connection's own error, as ``requests`` raises them. Each request opens its
own connection, so the session is safe across threads.
"""

import email.utils
import http.client
import json as _json
import re
import time
from typing import Any, Callable, Optional, Tuple, Union
from urllib.parse import urlencode, urlsplit

from ..util import faults

RETRY_STATUSES = (500, 502, 503, 504)
BACKOFF_MAX_S = 120.0
RETRY_AFTER_MAX_S = 21600.0
# retried where they name a Retry-After, whatever the forcelist
RETRY_AFTER_STATUSES = (413, 429, 503)


class HttpUnprocessableEntity(Exception):
    """Server returned 422 — e.g. anomaly endpoint on a plain model."""


class BadGordoRequest(Exception):
    """A 4xx class error that is our fault."""


class NotFound(Exception):
    """Resource not found (404)."""


class ResourceGone(Exception):
    """Resource moved or removed (410) — e.g. an expired revision."""


class ServerBusy(IOError):
    """503 carrying a server-named retry horizon (``Retry-After``): the
    shed gate, an open breaker, or a gateway with no live nodes. Retrying
    after the horizon has a real chance; surfacing immediately does not."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class RetryError(IOError):
    """The session's retries of a retryable status were spent (``requests``'
    ``RetryError``)."""


def call_with_retry_after(
    fn: Callable[[], Any],
    policy: Optional[faults.FaultPolicy] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Run ``fn`` with a bounded retry on :class:`ServerBusy`.

    The sleep before each retry is the *longer* of the server's
    ``Retry-After`` horizon (capped at the policy's backoff ceiling — a
    server must not be able to park the client for minutes) and the
    policy's own exponential backoff, so repeated busy answers still back
    off even when the server keeps naming the same short horizon.
    """
    policy = policy or faults.FaultPolicy.from_env()
    attempt = 1
    while True:
        try:
            return fn()
        except ServerBusy as exc:
            if attempt >= policy.max_attempts:
                raise
            delay = policy.backoff(attempt, key="retry-after")
            if exc.retry_after_s is not None:
                delay = max(
                    delay, min(exc.retry_after_s, policy.backoff_max)
                )
            sleep(delay)
            attempt += 1


def _handle_response(resp: Any, resource_name: str = "") -> Any:
    """
    Map a response onto its decoded payload or a typed exception.

    Accepts any requests-like response object (``status_code``, ``json()``,
    ``content``, ``headers``).
    """
    if 200 <= resp.status_code <= 299:
        content_type = resp.headers.get("Content-Type", "")
        if "json" in content_type:
            return resp.json()
        return resp.content
    msg = f"Failed to get {resource_name or 'resource'}: {resp.status_code}"
    # the server's echoed trace id: quoting it in the client-side error is
    # what lets an operator pull the exact request out of the server's
    # /debug/flight recorder and trace-correlated logs
    trace_id = resp.headers.get("X-Gordo-Trace")
    if trace_id:
        msg = f"{msg} [trace {trace_id}]"
    # when a gateway routed this request, name the node it landed on —
    # together with the trace id that points at the one machine whose
    # flight recorder holds the node-side subtree
    gateway_node = resp.headers.get("X-Gordo-Gateway-Node")
    if gateway_node:
        msg = f"{msg} [via {gateway_node}]"
    try:
        detail = resp.json()
    except Exception:
        detail = None
    if detail:
        msg = f"{msg} — {detail}"
    if resp.status_code == 422:
        raise HttpUnprocessableEntity(msg)
    if resp.status_code == 404:
        raise NotFound(msg)
    if resp.status_code == 410:
        raise ResourceGone(msg)
    if 400 <= resp.status_code <= 499:
        raise BadGordoRequest(msg)
    if resp.status_code == 503:
        retry_after = resp.headers.get("Retry-After")
        if retry_after is not None:
            try:
                seconds: Optional[float] = max(0.0, float(retry_after))
            except (TypeError, ValueError):
                seconds = None  # HTTP-date form: retry on backoff alone
            raise ServerBusy(msg, retry_after_s=seconds)
    raise IOError(msg)


class Response:
    """An answer as the client reads it: ``status_code``, ``headers`` (their
    ``get`` takes a name in any case), ``content`` bytes, ``text`` and
    ``json()``."""

    def __init__(self, status_code: int, headers, content: bytes):
        self.status_code = status_code
        self.headers = headers
        self.content = content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self):
        return _json.loads(self.content)


def header_map(pairs) -> http.client.HTTPMessage:
    """A header mapping whose ``get`` takes a name in any case, of ``pairs``
    (a mapping or ``(name, value)`` pairs)."""
    message = http.client.HTTPMessage()
    for name, value in (pairs.items() if hasattr(pairs, "items") else pairs):
        message[name] = value
    return message


def _retry_after_s(value: Optional[str]) -> Optional[float]:
    """A ``Retry-After`` value in seconds (whole seconds or an HTTP date),
    at most 6 hours, as urllib3 reads it; None where there is none or it
    does not parse."""
    if value is None:
        return None
    if re.match(r"^\s*[0-9]+\s*$", value):
        seconds = float(int(value))
    else:
        when = email.utils.parsedate_tz(value)
        if when is None:
            return None
        seconds = email.utils.mktime_tz(when) - time.time()
    return min(max(seconds, 0.0), RETRY_AFTER_MAX_S)


class HTTPSession:
    """``get`` and ``post`` over ``http.client`` with ``requests``' retry
    adapter's behaviour (the module docstring)."""

    def __init__(self, n_retries: int = 5, backoff_factor: float = 0.5,
                 status_forcelist: Tuple[int, ...] = RETRY_STATUSES,
                 allowed_methods: Tuple[str, ...] = ("GET", "POST"),
                 sleep: Callable[[float], None] = time.sleep):
        self.n_retries = n_retries
        self.backoff_factor = backoff_factor
        self.status_forcelist = tuple(status_forcelist)
        self.allowed_methods = tuple(allowed_methods)
        self.sleep = sleep

    def get(self, url: str, params: Optional[dict] = None, headers: Optional[dict] = None,
            timeout=None) -> Response:
        return self.request("GET", url, params=params, headers=headers, timeout=timeout)

    def post(self, url: str, params: Optional[dict] = None, json: Any = None,
             data: Union[bytes, str, None] = None, headers: Optional[dict] = None,
             timeout=None) -> Response:
        return self.request("POST", url, params=params, json=json, data=data, headers=headers,
                            timeout=timeout)

    def backoff(self, errors: int) -> float:
        """urllib3's backoff after ``errors`` consecutive failed attempts."""
        if errors <= 1:
            return 0.0
        return min(BACKOFF_MAX_S, self.backoff_factor * 2 ** (errors - 1))

    def request(self, method: str, url: str, params: Optional[dict] = None, json: Any = None,
                data: Union[bytes, str, None] = None, headers: Optional[dict] = None,
                timeout=None) -> Response:
        parts = urlsplit(url)
        target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        if params:
            target += ("&" if "?" in target else "?") + urlencode(params)
        out_headers = dict(headers or {})
        body = data.encode() if isinstance(data, str) else data
        if json is not None:
            body = _json.dumps(json, allow_nan=False).encode()
            out_headers.setdefault("Content-Type", "application/json")
        connect_s, read_s = (timeout if isinstance(timeout, tuple) else (timeout, timeout))
        retryable = method.upper() in self.allowed_methods
        errors = 0
        while True:
            try:
                response = self._exchange(parts, method, target, body, out_headers, connect_s,
                                          read_s)
            except (OSError, http.client.HTTPException):
                errors += 1
                if not retryable or errors > self.n_retries:
                    raise
                self._pause(errors, None)
                continue
            status = response.status_code
            if not retryable or not (status in self.status_forcelist or (
                    status in RETRY_AFTER_STATUSES and errors < self.n_retries
                    and response.headers.get("Retry-After"))):
                return response
            errors += 1
            if errors > self.n_retries:
                raise RetryError(
                    f"{parts.scheme}://{parts.hostname}:{parts.port}: Max retries exceeded with "
                    f"url: {target} (Caused by ResponseError('too many "
                    f"{status} error responses'))")
            self._pause(errors, response)

    def _pause(self, errors: int, response: Optional[Response]) -> None:
        """urllib3's sleep before a retry: the answer's ``Retry-After`` where
        it names a time above 0, else the backoff where it is above 0."""
        wait = _retry_after_s(response.headers.get("Retry-After")) if response else None
        if not wait:
            wait = self.backoff(errors)
        if wait > 0:
            self.sleep(wait)

    @staticmethod
    def _exchange(parts, method: str, target: str, body: Optional[bytes], headers: dict,
                  connect_s: Optional[float], read_s: Optional[float]) -> Response:
        kind = (http.client.HTTPSConnection if parts.scheme == "https"
                else http.client.HTTPConnection)
        conn = kind(parts.hostname, parts.port, timeout=connect_s)
        try:
            conn.connect()
            conn.sock.settimeout(read_s)
            conn.request(method, target, body=body, headers={"Connection": "close", **headers})
            answer = conn.getresponse()
            return Response(answer.status, answer.headers, answer.read())
        finally:
            conn.close()
