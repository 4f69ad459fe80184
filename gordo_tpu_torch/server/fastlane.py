"""
The socket fast lane: the port's counterpart of
``gordo_tpu/server/fastlane.py``, a minimal HTTP/1.1 front end with
persistent connections and pipelining in front of the server's one route
table (:meth:`GordoServer.dispatch <gordo_tpu_torch.server.server.GordoServer.dispatch>`).

The hot routes,

- ``POST /gordo/v0/<project>/<name>/prediction``
- ``POST /gordo/v0/<project>/<name>/anomaly/prediction``

sent with a JSON body and no proxy-prefix header (``X-Envoy-Original-Path``,
``X-Forwarded-Prefix``), go straight to the server's prediction handler
(:meth:`GordoServer.prediction_request`), the one its route table calls
for them;
every other request goes through :meth:`GordoServer.dispatch` itself. So
the bodies are the default lane's, byte for byte, by construction: the JAX
lane gets the same property by running the same core handlers and falling
back to its WSGI app in-process, and this module's counterpart of that
fallback is the shared dispatch (there is no second route table and no
werkzeug). The request body is the bytes off the socket buffer, which the
native codec (server/fast_codec.py) parses as the default lane's are.

Two front ends, both over the same parser functions and dispatch:

- :class:`FastLaneServer`: a thread per connection, keep-alive, the
  optional Unix-domain listener (``GORDO_TPU_UDS_PATH``), the keep-alive
  idle bound (``GORDO_TPU_FASTLANE_IDLE_S``), and the drain: it stops
  accepting, finishes the requests in flight, and answers them with
  ``Connection: close``. Concurrent requests on their connections run
  concurrently, so the cross-model batcher (server/batcher.py) fuses them
  as it does on the default lane.
- :class:`EventLoopServer`: one ``selectors`` loop over every connection,
  an incremental parser (head, body and chunked states), pipelining,
  ``Expect: 100-continue``, partial writes flushed on ``EVENT_WRITE``, and
  a pipelined burst's responses in one vectored ``sendmsg``
  (``GORDO_TPU_FASTLANE_WRITEV``). Dispatch is synchronous on the loop
  thread, as in the JAX lane, so the batcher sees one request at a time
  from it: its fuse width is 1. A subclass that sets ``offloop`` answers
  off the loop instead (server/gateway.py): :meth:`EventLoopServer._hand_off`
  gives it each parsed request with its place in the connection's pipeline,
  its threads return the response bytes through
  :meth:`EventLoopServer.complete`, and a wake-up socket has the loop write
  each connection's responses in request order.

Gates: ``GORDO_TPU_FAST_LANE`` (default off) makes ``run-server`` mount the
lane; ``GORDO_TPU_FAST_LANE_EVENT_LOOP`` (default on under the lane) picks
the event loop over a thread per connection.

Telemetry (ROADMAP.md item A8, first part) is the server's on both lanes:
the dispatch and the prediction handler run each request under its trace
root (``traceparent`` continued, ``X-Gordo-Trace`` on every response) and
feed the flight recorder, the Prometheus families and the request outcome
(``server.GordoServer._observed``). The lanes feed
``gordo_server_fastlane_idle_closes_total`` (from the same place as their
``idle_closes`` attribute) and the event loop
``gordo_server_fastlane_syscalls_total`` (one ``recv`` a read, one ``send``
a write, a vectored ``sendmsg`` counted once); the connection, accept and
event-loop threads register with the sampling profiler.

Resilience (server/resilience.py) is the server's on both lanes, as the
JAX lane reuses the same layer: the hot routes go through
:meth:`GordoServer.prediction_request`, which applies the admission gate
(the shed 503 with ``Retry-After``), the request scope with its deadline
(504), the breakers (503) and the output guard exactly as the default
lane's route table does. Both lanes count each request in flight for the
drain (``resilience.request_started``/``request_finished``; the thread lane
until its response is written, the event loop until it is queued, its
buffered writes flushed before the loop closes), and both read the drain
from ``resilience.is_draining()``: while draining they answer with
``Connection: close`` and flush what is buffered before closing.
:func:`begin_drain`, :func:`end_drain` and :func:`is_draining` are that
process-wide drain's switch.
"""

import json
import logging
import os
import re
import selectors
import socket
import threading
import time
import timeit
from collections import deque
from http.client import responses as _status_phrases
from typing import Dict, Optional, Tuple
from urllib.parse import unquote

from ..observability import metrics as metric_catalog, profiler
from . import resilience
from .server import (
    MAX_BODY_BYTES, MAX_HEAD_BYTES, BadRequest, GordoServer, client_keep_alive, content_length,
)

logger = logging.getLogger(__name__)

# the two hot routes: group 2 is the machine name, group 3 tells the anomaly
# route; one trailing slash allowed, as the route table allows it
_HOT_RE = re.compile(r"^/gordo/v0/([^/]+)/([^/]+)/(anomaly/)?prediction/?$")


def enabled() -> bool:
    """The ``GORDO_TPU_FAST_LANE`` gate (default off)."""
    return os.environ.get("GORDO_TPU_FAST_LANE", "").lower() in ("1", "true", "yes")


def event_loop_enabled() -> bool:
    """The ``GORDO_TPU_FAST_LANE_EVENT_LOOP`` gate: under the fast lane,
    connections run on the selectors event loop unless it is 0, false or
    no, which falls back to a thread per connection."""
    return os.environ.get("GORDO_TPU_FAST_LANE_EVENT_LOOP", "1").lower() not in (
        "0", "false", "no")


def idle_seconds() -> float:
    """``GORDO_TPU_FASTLANE_IDLE_S`` (75): how long a keep-alive connection
    may sit idle between requests before the lane closes it (a stall in the
    middle of a request is bounded by the request timeout instead)."""
    try:
        value = float(os.environ.get("GORDO_TPU_FASTLANE_IDLE_S", "75"))
    except ValueError:
        return 75.0
    return value if value > 0 else 75.0


def uds_path() -> Optional[str]:
    """``GORDO_TPU_UDS_PATH``: when set, the lane also listens on a
    Unix-domain socket at this path, beside TCP, on the same dispatch."""
    value = os.environ.get("GORDO_TPU_UDS_PATH", "").strip()
    return value or None


def writev_enabled() -> bool:
    """``GORDO_TPU_FASTLANE_WRITEV`` (default on): the event loop flushes a
    pipelined burst of responses with one vectored ``sendmsg`` instead of
    one ``send`` each; the bytes are the same either way."""
    return os.environ.get("GORDO_TPU_FASTLANE_WRITEV", "1").lower() not in ("0", "false", "no")


def begin_drain() -> bool:
    """Start the process's drain (``resilience.begin_drain``): every lane
    answers with ``Connection: close`` from now on. False if a drain was
    already on."""
    return resilience.begin_drain()


def end_drain() -> None:
    """End the drain (a process serves on after it only in tests)."""
    resilience._draining.clear()


def is_draining() -> bool:
    return resilience.is_draining()


# most kernels allow 1,024 iovecs a sendmsg; stay beneath it
try:
    _IOV_CAP = min(1024, os.sysconf("SC_IOV_MAX"))
except (AttributeError, ValueError, OSError):  # pragma: no cover - exotic libc
    _IOV_CAP = 64


class _Headers:
    """Case-insensitive ``get`` over the parsed headers (kept lower-case),
    the one interface the dispatch reads headers through."""

    __slots__ = ("_raw",)

    def __init__(self, raw: Dict[str, str]):
        self._raw = raw

    def get(self, name: str, default=None):
        return self._raw.get(name.lower(), default)


# ------------------------------------------------------------ HTTP plumbing
class _ConnectionClosed(Exception):
    """The peer went away mid-request: drop the connection."""


def _recv_until(conn, buf: bytearray, marker: bytes, limit: int) -> int:
    """Grow ``buf`` from the socket until ``marker`` appears; returns its
    offset. Raises on EOF, and when ``limit`` bytes hold no marker."""
    while True:
        idx = buf.find(marker)
        if idx >= 0:
            return idx
        if len(buf) > limit:
            raise BadRequest(431, "request head too large")
        chunk = conn.recv(65536)
        if not chunk:
            raise _ConnectionClosed()
        buf.extend(chunk)


def _recv_exact(conn, buf: bytearray, n: int, limit: int) -> bytes:
    """The next ``n`` bytes, from ``buf`` and then the socket."""
    if n > limit:
        raise BadRequest(413, "request body too large")
    while len(buf) < n:
        chunk = conn.recv(65536)
        if not chunk:
            raise _ConnectionClosed()
        buf.extend(chunk)
    body = bytes(buf[:n])
    del buf[:n]
    return body


def _read_chunked(conn, buf: bytearray, limit: int) -> bytes:
    """A ``Transfer-Encoding: chunked`` body, trailers discarded."""
    body = bytearray()
    while True:
        idx = _recv_until(conn, buf, b"\r\n", MAX_HEAD_BYTES)
        size_line = bytes(buf[:idx]).split(b";", 1)[0].strip()
        del buf[:idx + 2]
        try:
            size = int(size_line, 16)
        except ValueError:
            raise BadRequest(400, "malformed chunk size") from None
        if size == 0:
            idx = _recv_until(conn, buf, b"\r\n", MAX_HEAD_BYTES)
            while idx != 0:
                del buf[:idx + 2]
                idx = _recv_until(conn, buf, b"\r\n", MAX_HEAD_BYTES)
            del buf[:2]
            return bytes(body)
        body.extend(_recv_exact(conn, buf, size, limit - len(body)))
        _recv_exact(conn, buf, 2, 4)  # the chunk's CRLF


def _parse_head(head: bytes) -> Tuple[str, str, str, Dict[str, str]]:
    """(method, target, version, headers) of a raw request head; repeated
    headers are joined with commas."""
    try:
        lines = head.decode("latin-1").split("\r\n")
        method, target, version = lines[0].split(" ", 2)
    except (UnicodeDecodeError, ValueError):
        raise BadRequest(400, "malformed request line") from None
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            raise BadRequest(400, "malformed header line")
        key, value = name.strip().lower(), value.strip()
        headers[key] = headers[key] + "," + value if key in headers else value
    return method, target, version, headers


def _serialize(status: int, headers, body: bytes, keep_alive: bool) -> bytes:
    """One HTTP/1.1 response: the status line, ``headers``, then
    ``Content-Length`` and ``Connection``, then the body."""
    out = [f"HTTP/1.1 {status} {_status_phrases.get(status, 'UNKNOWN')}"]
    out.extend(f"{name}: {value}" for name, value in headers)
    out.append(f"Content-Length: {len(body)}")
    out.append("Connection: keep-alive" if keep_alive else "Connection: close")
    return ("\r\n".join(out) + "\r\n\r\n").encode("latin-1") + body


# hop-by-hop headers (RFC 7230 section 6.1, and the framing the lane writes
# itself): a proxy in front of the lane forwards none of them
_HOP_BY_HOP = frozenset((
    "connection", "keep-alive", "proxy-authenticate", "proxy-authorization", "te", "trailers",
    "transfer-encoding", "upgrade", "content-length",
))


def _refusal(exc: BadRequest) -> bytes:
    return _serialize(exc.status, [("Content-Type", "application/json")],
                      json.dumps({"error": exc.message}).encode(), keep_alive=False)


# --------------------------------------------------- thread per connection
class FastLaneServer:
    """The socket front end, a thread per connection, over ``app`` (a
    :class:`GordoServer`, bound or not: only its dispatch is used). It has
    the methods ``run_server`` calls on a server: ``serve_forever``,
    ``shutdown`` and ``server_close``; ``server_port`` is the TCP port.
    ``fd`` adopts a listening socket (one shared by prefork workers) instead
    of binding ``host:port``; ``uds`` is the Unix-domain path (None reads
    ``GORDO_TPU_UDS_PATH``, "" opens none). ``accepted`` counts the
    connections accepted, ``idle_closes`` those closed by the idle bound."""

    def __init__(self, app: GordoServer, host: str = "127.0.0.1", port: int = 0,
                 fd: Optional[int] = None, request_timeout: float = 120.0,
                 uds: Optional[str] = None):
        self.app = app
        self.request_timeout = request_timeout
        self.idle_timeout = idle_seconds()
        self.accepted = 0
        self.idle_closes = 0
        self._shutdown = threading.Event()
        if fd is not None:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM, fileno=os.dup(fd))
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((host, port))
            self._sock.listen(128)
        self._sock.settimeout(0.5)
        self.server_port = self._sock.getsockname()[1]
        self.host = host
        self.uds_path: Optional[str] = None
        self._uds_sock = self._bind_uds(uds_path() if uds is None else uds)

    def _bind_uds(self, path: Optional[str]):
        """The Unix-domain listener at ``path``, a stale socket file there
        unlinked first; a failed bind logs and leaves the lane TCP only."""
        if not path or not hasattr(socket, "AF_UNIX"):
            return None
        try:
            if os.path.exists(path):
                os.unlink(path)
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.bind(path)
            sock.listen(128)
        except OSError:
            logger.exception("fast lane: UDS bind failed at %s; serving TCP only", path)
            return None
        sock.settimeout(0.5)
        self.uds_path = path
        return sock

    # ------------------------------------------------------------ lifecycle
    def serve_forever(self) -> None:
        logger.info("fast lane serving on port %d (a thread per connection)", self.server_port)
        if self._uds_sock is not None:
            threading.Thread(target=self._accept_loop, args=(self._uds_sock,), daemon=True,
                             name="gordo-fastlane-uds-accept").start()
        self._accept_loop(self._sock)

    def _accept_loop(self, listener) -> None:
        profiler.register_thread("gordo-fastlane-accept")
        while not self._shutdown.is_set():
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            self.accepted += 1
            threading.Thread(target=self._handle_connection, args=(conn,), daemon=True,
                             name="gordo-fastlane").start()

    def shutdown(self) -> None:
        self._shutdown.set()

    def server_close(self) -> None:
        self._shutdown.set()
        for listener in (self._sock, self._uds_sock):
            if listener is not None:
                try:
                    listener.close()
                except OSError:  # pragma: no cover - closed twice
                    pass
        if self.uds_path:
            try:
                os.unlink(self.uds_path)
            except OSError:
                pass

    # ----------------------------------------------------------- connection
    def _idle_close(self) -> None:
        self.idle_closes += 1
        metric_catalog.FASTLANE_IDLE_CLOSES.inc()

    def _handle_connection(self, conn) -> None:
        profiler.register_thread("gordo-fastlane")
        conn.settimeout(self.request_timeout)
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:  # not a TCP socket
            pass
        buf = bytearray()
        try:
            while not self._shutdown.is_set():
                idle_wait = not buf
                if idle_wait:
                    # between requests the idle bound applies, not the
                    # request timeout
                    conn.settimeout(self.idle_timeout)
                try:
                    head_end = _recv_until(conn, buf, b"\r\n\r\n", MAX_HEAD_BYTES)
                except _ConnectionClosed:
                    break
                except socket.timeout:
                    if idle_wait and buf:
                        # request bytes came during the idle wait: the
                        # connection is mid-request now, so serve it under
                        # the request timeout instead of closing it
                        continue
                    if idle_wait:
                        self._idle_close()
                    break
                finally:
                    conn.settimeout(self.request_timeout)
                head = bytes(buf[:head_end])
                del buf[:head_end + 4]
                method, target, version, headers = _parse_head(head)
                if headers.get("expect", "").lower() == "100-continue":
                    conn.sendall(b"HTTP/1.1 100 Continue\r\n\r\n")
                if "chunked" in headers.get("transfer-encoding", "").lower():
                    body = _read_chunked(conn, buf, MAX_BODY_BYTES)
                else:
                    length = content_length(headers.get("content-length"))
                    body = _recv_exact(conn, buf, length, MAX_BODY_BYTES) if length else b""
                resilience.request_started()
                try:
                    keep = (client_keep_alive(version, headers.get("connection"))
                            and not is_draining())
                    conn.sendall(self._dispatch(method, target, headers, body, keep))
                finally:
                    resilience.request_finished()
                if not keep:
                    break
        except BadRequest as exc:
            try:
                conn.sendall(_refusal(exc))
            except OSError:
                pass
        except (_ConnectionClosed, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:  # pragma: no cover
                pass

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, method: str, target: str, headers: Dict[str, str], body: bytes,
                  keep_alive: bool) -> bytes:
        """The response bytes of one request: the hot routes through the
        server's prediction handler, everything else through its dispatch."""
        started = timeit.default_timer()
        raw_path, _, query = target.partition("?")
        match = _HOT_RE.match(unquote(raw_path))
        view = _Headers(headers)
        try:
            if (match is not None and method == "POST"
                    and "x-envoy-original-path" not in headers
                    and "x-forwarded-prefix" not in headers
                    and (headers.get("content-type") or "").partition(";")[0].strip().lower()
                    == "application/json"):
                answer = self.app.prediction_request(
                    match.group(2), "anomaly/prediction" if match.group(3) else "prediction",
                    query, view, body, started, path=unquote(raw_path))
            else:
                answer = self.app.dispatch(method, target, view, body, started)
            return _serialize(*answer, keep_alive)
        except Exception:  # noqa: BLE001 -- a fault of the lane itself: a 500, not a dead socket
            logger.exception("fast lane dispatch error")
            return _serialize(500, [("Content-Type", "application/json")],
                              json.dumps({"error": "Internal server error"}).encode(),
                              keep_alive=False)


# ------------------------------------------------------------- event loop
_ST_HEAD, _ST_BODY, _ST_CHUNK_SIZE, _ST_CHUNK_DATA, _ST_CHUNK_CRLF, _ST_CHUNK_TRAILER = range(6)
_RECV_CHUNK = 262144
_WAKE = object()  # the selector's tag of the off-loop wake-up socket


class _Conn:
    """One connection on the event loop: its socket, the input not yet
    parsed, the responses not yet written (a list, so that a pipelined burst
    leaves in one ``sendmsg``), and the parser's state between callbacks."""

    __slots__ = ("sock", "buf", "out", "state", "method", "target", "version", "headers",
                 "body", "body_remaining", "close_after_flush", "last_activity", "events",
                 "submitted", "emitted", "ready", "closing")

    def __init__(self, sock):
        self.sock = sock
        self.buf = bytearray()
        self.out = []
        self.state = _ST_HEAD
        self.method = self.target = self.version = ""
        self.headers: Dict[str, str] = {}
        self.body = bytearray()
        self.body_remaining = 0
        self.close_after_flush = False
        self.last_activity = time.monotonic()
        self.events = selectors.EVENT_READ
        # off the loop (EventLoopServer.offloop): requests handed off, responses
        # written, finished responses waiting for an earlier one, and whether a
        # handed-off request asked to close the connection
        self.submitted = self.emitted = 0
        self.ready: Dict[int, Tuple[bytes, bool]] = {}
        self.closing = False

    def queue(self, data: bytes) -> None:
        self.out.append(data)

    def consume(self, sent: int) -> None:
        """Drop ``sent`` bytes off the front of the output (a short write
        leaves a view of the rest of the first buffer)."""
        while sent:
            size = len(self.out[0])
            if sent >= size:
                sent -= size
                del self.out[0]
            else:
                self.out[0] = memoryview(self.out[0])[sent:]
                return

    def mid_request(self) -> bool:
        """A request partly received or a response partly written: the
        request timeout applies, not the idle bound."""
        return (self.state != _ST_HEAD or bool(self.buf) or bool(self.out)
                or self.submitted != self.emitted)


class EventLoopServer(FastLaneServer):
    """The fast lane on one ``selectors`` loop: every connection has an
    incremental HTTP/1.1 parser fed by whatever bytes are ready, so a
    request in many reads costs no blocking read and a pipelined burst is
    answered from one wake-up. Requests are dispatched on the loop thread,
    in arrival order. Keep-alive, ``Expect: 100-continue``, the drain,
    partial writes (kept and flushed on ``EVENT_WRITE``) and the idle bound
    are handled on the loop.

    With ``offloop`` set (a subclass), requests are not dispatched on the
    loop: :meth:`_hand_off` receives each one with its sequence number on
    its connection, and the subclass's threads call :meth:`complete` with
    the response bytes; the loop, woken through a socket pair, writes each
    connection's responses in request order. Pipelined bytes after a
    request that closes the connection are not served."""

    offloop = False

    def __init__(self, app: GordoServer, host: str = "127.0.0.1", port: int = 0,
                 fd: Optional[int] = None, request_timeout: float = 120.0,
                 uds: Optional[str] = None):
        super().__init__(app, host, port, fd, request_timeout, uds)
        self._sock.setblocking(False)
        if self._uds_sock is not None:
            self._uds_sock.setblocking(False)
        self._selector = selectors.DefaultSelector()
        self._conns: Dict[int, _Conn] = {}
        self._writev = writev_enabled() and hasattr(socket.socket, "sendmsg")
        self._sys_recv = metric_catalog.FASTLANE_SYSCALLS.labels(op="recv")
        self._sys_send = metric_catalog.FASTLANE_SYSCALLS.labels(op="send")
        self._done: deque = deque()  # (conn, seq, payload, close) from complete()
        self._wake_r = self._wake_w = None
        if self.offloop:
            self._wake_r, self._wake_w = socket.socketpair()
            self._wake_r.setblocking(False)
            self._wake_w.setblocking(False)

    # ------------------------------------------------------------ lifecycle
    def serve_forever(self) -> None:
        logger.info("fast lane serving on port %d (event loop)", self.server_port)
        profiler.register_thread("gordo-eventloop")
        sel = self._selector
        sel.register(self._sock, selectors.EVENT_READ, None)
        if self._uds_sock is not None:
            sel.register(self._uds_sock, selectors.EVENT_READ, None)
        if self._wake_r is not None:
            sel.register(self._wake_r, selectors.EVENT_READ, _WAKE)
        last_sweep = time.monotonic()
        try:
            while not self._shutdown.is_set():
                try:
                    events = sel.select(0.5)
                except OSError:  # a listener closed under the loop
                    break
                for key, mask in events:
                    if key.data is None:
                        self._accept(key.fileobj)
                        continue
                    if key.data is _WAKE:
                        self._drain_wake()
                        self._emit_completions()
                        continue
                    conn = key.data
                    if mask & selectors.EVENT_WRITE:
                        self._flush(conn)
                    if mask & selectors.EVENT_READ and conn.sock.fileno() >= 0:
                        self._on_readable(conn)
                now = time.monotonic()
                if now - last_sweep >= 0.5:
                    last_sweep = now
                    self._sweep_idle(now)
        finally:
            self._emit_completions()
            if is_draining():
                # a drain's last responses may still be buffered: give them a
                # bounded window to reach their sockets
                self._drain_flush()
            for conn in list(self._conns.values()):
                self._close(conn)
            for listener in (self._sock, self._uds_sock, self._wake_r):
                if listener is not None:
                    try:
                        sel.unregister(listener)
                    except (KeyError, ValueError, OSError):
                        pass
            sel.close()

    # ----------------------------------------------------------- readiness
    def _accept(self, listener) -> None:
        while True:
            try:
                sock, _ = listener.accept()
            except (BlockingIOError, socket.timeout, OSError):
                return
            self.accepted += 1
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:  # not a TCP socket
                pass
            conn = _Conn(sock)
            self._conns[sock.fileno()] = conn
            self._selector.register(sock, selectors.EVENT_READ, conn)

    def _on_readable(self, conn: _Conn) -> None:
        try:
            while True:
                self._sys_recv.inc()
                chunk = conn.sock.recv(_RECV_CHUNK)
                if not chunk:
                    self._close(conn)
                    return
                conn.buf.extend(chunk)
                conn.last_activity = time.monotonic()
                if len(chunk) < _RECV_CHUNK:
                    break
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._close(conn)
            return
        self._pump(conn)

    def _pump(self, conn: _Conn) -> None:
        """Run the parser over the buffered input, dispatching every complete
        request in arrival order, then flush once."""
        try:
            while self._advance(conn):
                pass
        except BadRequest as exc:
            conn.queue(_refusal(exc))
            conn.close_after_flush = True
            conn.buf.clear()
            conn.state = _ST_HEAD
        self._flush(conn)

    def _advance(self, conn: _Conn) -> bool:
        """One parser step: True when it made progress, False when it needs
        more bytes (or the connection is closing)."""
        if conn.close_after_flush or conn.closing:
            # a response with Connection: close is queued (or, off the loop, a
            # request that asked for it was handed off): pipelined bytes
            # after it are not served
            return False
        buf, state = conn.buf, conn.state
        if state == _ST_HEAD:
            idx = buf.find(b"\r\n\r\n")
            if idx < 0:
                if len(buf) > MAX_HEAD_BYTES:
                    raise BadRequest(431, "request head too large")
                return False
            head = bytes(buf[:idx])
            del buf[:idx + 4]
            conn.method, conn.target, conn.version, conn.headers = _parse_head(head)
            if conn.headers.get("expect", "").lower() == "100-continue":
                conn.queue(b"HTTP/1.1 100 Continue\r\n\r\n")
            conn.body = bytearray()
            if "chunked" in conn.headers.get("transfer-encoding", "").lower():
                conn.state = _ST_CHUNK_SIZE
            else:
                conn.body_remaining = content_length(conn.headers.get("content-length"))
                conn.state = _ST_BODY
            return True
        if state in (_ST_BODY, _ST_CHUNK_DATA):
            take = min(len(buf), conn.body_remaining)
            if take:
                conn.body += buf[:take]
                del buf[:take]
                conn.body_remaining -= take
            if conn.body_remaining:
                return False
            if state == _ST_BODY:
                self._finish_request(conn)
            else:
                conn.state = _ST_CHUNK_CRLF
            return True
        if state == _ST_CHUNK_SIZE:
            idx = buf.find(b"\r\n")
            if idx < 0:
                if len(buf) > MAX_HEAD_BYTES:
                    raise BadRequest(400, "malformed chunk size")
                return False
            size_line = bytes(buf[:idx]).split(b";", 1)[0].strip()
            del buf[:idx + 2]
            try:
                size = int(size_line, 16)
            except ValueError:
                raise BadRequest(400, "malformed chunk size") from None
            if size == 0:
                conn.state = _ST_CHUNK_TRAILER
            else:
                if len(conn.body) + size > MAX_BODY_BYTES:
                    raise BadRequest(413, "request body too large")
                conn.body_remaining = size
                conn.state = _ST_CHUNK_DATA
            return True
        if state == _ST_CHUNK_CRLF:
            if len(buf) < 2:
                return False
            del buf[:2]
            conn.state = _ST_CHUNK_SIZE
            return True
        # _ST_CHUNK_TRAILER: trailer lines up to the blank one are discarded
        idx = buf.find(b"\r\n")
        if idx < 0:
            if len(buf) > MAX_HEAD_BYTES:
                raise BadRequest(400, "trailer too large")
            return False
        del buf[:idx + 2]
        if idx == 0:
            self._finish_request(conn)
        return True

    def _finish_request(self, conn: _Conn) -> None:
        if self.offloop:
            keep = (client_keep_alive(conn.version, conn.headers.get("connection"))
                    and not is_draining())
            seq = conn.submitted
            conn.submitted += 1
            conn.closing = not keep
            self._hand_off(conn, seq, conn.method, conn.target, dict(conn.headers),
                           bytes(conn.body), keep)
        else:
            resilience.request_started()
            try:
                keep = (client_keep_alive(conn.version, conn.headers.get("connection"))
                        and not is_draining())
                conn.queue(self._dispatch(conn.method, conn.target, conn.headers,
                                          bytes(conn.body), keep))
            finally:
                resilience.request_finished()
            if not keep:
                conn.close_after_flush = True
        conn.state = _ST_HEAD
        conn.body = bytearray()
        conn.last_activity = time.monotonic()

    # ------------------------------------------------------ off the loop
    def _hand_off(self, conn: _Conn, seq: int, method: str, target: str,
                  headers: Dict[str, str], body: bytes, keep: bool) -> None:
        """An ``offloop`` subclass's intake: request ``seq`` of ``conn``,
        parsed; its answer comes back through :meth:`complete`."""
        raise NotImplementedError

    def complete(self, conn: _Conn, seq: int, payload: bytes, close: bool) -> None:
        """From any thread: ``payload`` answers request ``seq`` of ``conn``
        (``close``: the connection closes after it). The loop writes it once
        every earlier response of the connection is written."""
        self._done.append((conn, seq, payload, close))
        try:
            self._wake_w.send(b"x")
        except OSError:  # a full pair already holds a wake-up, or the lane closed
            pass

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except OSError:  # drained (BlockingIOError), or closed
            pass

    def _emit_completions(self) -> None:
        """Queue every finished response whose predecessors on its
        connection are written, in request order, and flush."""
        while True:
            try:
                conn, seq, payload, close = self._done.popleft()
            except IndexError:
                return
            if conn.sock.fileno() < 0:
                continue  # the connection went away while the answer was made
            conn.ready[seq] = (payload, close)
            progressed = False
            while conn.emitted in conn.ready:
                body, close_flag = conn.ready.pop(conn.emitted)
                conn.emitted += 1
                conn.queue(body)
                if close_flag:
                    conn.close_after_flush = True
                progressed = True
            if progressed:
                conn.last_activity = time.monotonic()
                self._flush(conn)

    # ------------------------------------------------------------- writing
    def _flush(self, conn: _Conn) -> None:
        if conn.sock.fileno() < 0:
            return
        try:
            while conn.out:
                self._sys_send.inc()
                if self._writev and len(conn.out) > 1:
                    sent = conn.sock.sendmsg(conn.out[:_IOV_CAP])
                else:
                    sent = conn.sock.send(conn.out[0])
                conn.consume(sent)
                conn.last_activity = time.monotonic()
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._close(conn)
            return
        if conn.out:
            self._want(conn, selectors.EVENT_READ | selectors.EVENT_WRITE)
        elif conn.close_after_flush:
            self._close(conn)
        else:
            self._want(conn, selectors.EVENT_READ)

    def _want(self, conn: _Conn, events: int) -> None:
        if conn.events != events:
            conn.events = events
            try:
                self._selector.modify(conn.sock, events, conn)
            except (KeyError, ValueError, OSError):
                pass

    # ------------------------------------------------------------- closing
    def _close(self, conn: _Conn) -> None:
        fd = conn.sock.fileno()
        if fd >= 0:
            self._conns.pop(fd, None)
        try:
            self._selector.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:  # pragma: no cover
            pass

    def _sweep_idle(self, now: float) -> None:
        for conn in list(self._conns.values()):
            stalled = now - conn.last_activity
            if conn.mid_request():
                if stalled > self.request_timeout:
                    self._flush_then_close(conn)
            elif stalled > self.idle_timeout:
                self._idle_close()
                self._flush_then_close(conn)

    def _flush_then_close(self, conn: _Conn) -> None:
        """Close a swept connection without dropping a buffered response: it
        gets one more write pass, and during a drain the close waits for the
        writable callback to finish the response."""
        if conn.out and conn.sock.fileno() >= 0:
            self._flush(conn)
            if conn.sock.fileno() < 0:
                return  # flushed, and closed by close_after_flush
            if conn.out and is_draining():
                conn.close_after_flush = True
                self._want(conn, selectors.EVENT_READ | selectors.EVENT_WRITE)
                return
        self._close(conn)

    def server_close(self) -> None:
        super().server_close()
        for sock in (self._wake_r, self._wake_w):
            if sock is not None:
                try:
                    sock.close()
                except OSError:  # pragma: no cover - closed twice
                    pass

    def _drain_flush(self, budget_s: float = 1.0) -> None:
        """Before the loop closes every connection, give buffered responses
        (a drain's last writes) ``budget_s`` to reach their sockets."""
        deadline = time.monotonic() + budget_s
        while time.monotonic() < deadline:
            pending = [c for c in self._conns.values() if c.out and c.sock.fileno() >= 0]
            if not pending:
                return
            for conn in pending:
                self._flush(conn)
            time.sleep(0.01)


def make_server(app: GordoServer, host: str, port: int, fd: Optional[int] = None,
                uds: Optional[str] = None) -> FastLaneServer:
    """The fast lane over ``app``'s dispatch, on ``host:port`` or the
    listening socket ``fd``: the event loop unless
    ``GORDO_TPU_FAST_LANE_EVENT_LOOP=0``, then a thread per connection."""
    cls = EventLoopServer if event_loop_enabled() else FastLaneServer
    return cls(app, host=host, port=port, fd=fd, uds=uds)
