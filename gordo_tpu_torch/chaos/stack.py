"""
The chaos stack, N serving-node subprocesses and one in-process gateway:
the port's copy of ``gordo_tpu/chaos/stack.py``.

The nodes are child processes (chaos/node.py), so the conductor's fault
actions are real:

- ``kill_node``: SIGKILL; the listener, every connection and the lease
  heartbeat die together, and the lease goes stale;
- ``stop_node`` / ``cont_node``: SIGSTOP / SIGCONT, the wedged-alive split
  (the kernel keeps accepting on the listener while the frozen process
  answers nothing and its heartbeat stops);
- ``expire_lease`` / ``corrupt_lease`` / ``delete_lease`` act on the lease
  files themselves, racing the node's own heartbeat.

The gateway (server/gateway.py, port 0) runs in this process, so the
invariant checkers read its ring, live set and counters directly.
"""

import http.client
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from ..server import gateway as gateway_mod

logger = logging.getLogger(__name__)

_READY_PREFIX = "CHAOS-NODE READY "


class StackError(RuntimeError):
    """The fleet failed to come up (node never readied, ring short)."""


class NodeProc:
    """One spawned serving node and its stdout reader."""

    def __init__(self, index: int, node_id: str, proc: subprocess.Popen):
        self.index = index
        self.node_id = node_id
        self.proc = proc
        self.port: Optional[int] = None
        self.stopped = False  # SIGSTOP'd (for cont_node bookkeeping)
        self._ready = threading.Event()
        self._reader = threading.Thread(
            target=self._read_stdout, name=f"chaos-node-out-{node_id}",
            daemon=True,
        )
        self._reader.start()

    def _read_stdout(self) -> None:
        for raw in self.proc.stdout:
            line = raw.decode(errors="replace").rstrip()
            if line.startswith(_READY_PREFIX):
                try:
                    self.port = int(line.split()[-1])
                except ValueError:
                    pass
                self._ready.set()
            elif line:
                logger.debug("node %s: %s", self.node_id, line)
        self._ready.set()  # EOF: unblock waiters (they check port)

    def wait_ready(self, timeout: float) -> bool:
        return self._ready.wait(timeout) and self.port is not None

    def alive(self) -> bool:
        return self.proc.poll() is None


class ChaosStack:
    """Spin up the fleet, aim actions at it, tear it down."""

    def __init__(self, directory: str, nodes: int = 3,
                 child_env: Optional[Dict[str, str]] = None):
        self.directory = directory
        self.n = nodes
        self.child_env = dict(child_env or {})
        self.nodes: List[NodeProc] = []
        self.gateway: Optional[gateway_mod.GatewayServer] = None
        self._gateway_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self, timeout: float = 30.0) -> None:
        env = {**os.environ, **self.child_env}
        for i in range(self.n):
            node_id = f"node-{i}"
            proc = subprocess.Popen(
                [sys.executable, "-m", "gordo_tpu_torch.chaos.node",
                 "--dir", self.directory, "--node-id", node_id],
                stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL,
                env=env,
            )
            self.nodes.append(NodeProc(i, node_id, proc))
        deadline = time.monotonic() + timeout
        for node in self.nodes:
            if not node.wait_ready(max(0.1, deadline - time.monotonic())):
                raise StackError(f"{node.node_id} never readied (rc={node.proc.poll()})")
        self.gateway = gateway_mod.GatewayServer(
            self.directory, host="127.0.0.1", port=0,
        )
        self._gateway_thread = threading.Thread(
            target=self.gateway.serve_forever, name="chaos-gateway",
            daemon=True,
        )
        self._gateway_thread.start()
        while len(self.gateway.ring.nodes) < self.n:
            if time.monotonic() > deadline:
                raise StackError(
                    f"ring has {len(self.gateway.ring.nodes)}/{self.n} nodes "
                    f"after {timeout}s"
                )
            time.sleep(0.05)

    def close(self) -> None:
        if self.gateway is not None:
            try:
                self.gateway.shutdown()
                self.gateway.server_close()
            except Exception:  # noqa: BLE001 -- teardown is best-effort
                logger.exception("gateway close failed")
            if self._gateway_thread is not None:
                self._gateway_thread.join(timeout=5.0)
        for node in self.nodes:
            if node.alive():
                try:
                    node.proc.send_signal(signal.SIGCONT)  # in case stopped
                    node.proc.kill()
                except OSError:
                    pass
            try:
                node.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                logger.warning("%s did not exit", node.node_id)

    def __enter__(self) -> "ChaosStack":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    # -------------------------------------------------------------- actions
    def kill_node(self, index: int) -> None:
        node = self.nodes[index]
        node.proc.kill()  # SIGKILL
        node.proc.wait(timeout=10.0)

    def stop_node(self, index: int) -> None:
        node = self.nodes[index]
        node.proc.send_signal(signal.SIGSTOP)
        node.stopped = True

    def cont_node(self, index: int) -> None:
        node = self.nodes[index]
        node.proc.send_signal(signal.SIGCONT)
        node.stopped = False

    def _lease_path(self, index: int) -> Optional[str]:
        node_id = self.nodes[index].node_id
        nodes_dir = os.path.join(self.directory, "nodes")
        best, best_gen = None, -1
        try:
            names = os.listdir(nodes_dir)
        except OSError:
            return None
        for name in names:
            stem, dot, suffix = name.rpartition(".g")
            if dot and stem == node_id and suffix.isdigit():
                if int(suffix) > best_gen:
                    best, best_gen = os.path.join(nodes_dir, name), int(suffix)
        return best

    def expire_lease(self, index: int) -> None:
        """Backdate the lease mtime past any sane timeout: stale-but-
        present, the half-dead state a wedged NFS client leaves behind."""
        path = self._lease_path(index)
        if path:
            try:
                past = time.time() - 86400.0
                os.utime(path, (past, past))
            except OSError:
                pass

    def corrupt_lease(self, index: int) -> None:
        path = self._lease_path(index)
        if path:
            try:
                with open(path, "w") as fh:
                    fh.write("\x00garbage{not json")
            except OSError:
                pass

    def delete_lease(self, index: int) -> None:
        path = self._lease_path(index)
        if path:
            try:
                os.unlink(path)
            except OSError:
                pass

    def drop_gateway_conns(self) -> None:
        """Drop every pooled gateway→node connection: the next proxied
        request must re-connect (a middlebox reset, in effect)."""
        gw = self.gateway
        if gw is None:
            return
        with gw._state_lock:
            live = list(gw._live.values())
        for node in live:
            gw._drop_upstream(node)

    # -------------------------------------------------------------- queries
    @property
    def gateway_port(self) -> int:
        return self.gateway.server_port

    def request(self, method: str, path: str, timeout: float = 10.0,
                headers: Optional[dict] = None):
        """One request through the gateway; returns (status, headers, body)
        with status -1 on transport errors."""
        conn = http.client.HTTPConnection(
            "127.0.0.1", self.gateway_port, timeout=timeout
        )
        try:
            conn.request(method, path, headers=headers or {})
            resp = conn.getresponse()
            body = resp.read()
            return resp.status, {k.lower(): v for k, v in resp.getheaders()}, body
        except OSError as exc:
            return -1, {}, repr(exc).encode()[:160]
        finally:
            conn.close()

    def node_breakers(self, index: int, timeout: float = 3.0) -> Optional[dict]:
        """{model: breaker state} straight from one node, or None when the
        node is unreachable (killed / stopped)."""
        node = self.nodes[index]
        if node.port is None or not node.alive() or node.stopped:
            return None
        conn = http.client.HTTPConnection("127.0.0.1", node.port, timeout=timeout)
        try:
            conn.request("GET", "/chaos/breakers")
            resp = conn.getresponse()
            if resp.status != 200:
                return None
            return json.loads(resp.read()).get("breakers", {})
        except (OSError, ValueError):
            return None
        finally:
            conn.close()
