"""
Serving-node membership through filesystem leases: the port's copy of
``gordo_tpu/server/membership.py``, whose lease files it writes and reads
the same way (a JAX gateway reads a port node's lease, and this module a
JAX node's).

The gateway (server/gateway.py) learns which serving nodes are alive
without a network dependency (etcd, consul, gossip): a lease file's mtime
is the heartbeat, a stale mtime is a dead holder, and a generation suffix
that only grows fences a restarted holder against its own ghost.

- every ``run-server`` node (or test fixture) holds a
  :class:`NodeRegistration`: a JSON file
  ``<GORDO_TPU_GATEWAY_DIR>/nodes/<node_id>.g<N>`` carrying the node's
  advertised ``host:port`` (and its Unix-domain socket, where it binds
  one), refreshed atomically (mkstemp + ``os.replace``) every
  ``GORDO_TPU_HEARTBEAT_S`` seconds;
- the gateway holds a :class:`MembershipView` that rescans the
  directory: the newest generation of a node wins, and a registration
  whose mtime is older than ``GORDO_TPU_LEASE_TIMEOUT_S`` is dead; its
  ring segment spills to its successors until the heartbeat resumes or a
  new generation appears;
- generation fencing: a node that finds a *higher* generation of its own
  id stops heartbeating (a restarted twin has superseded it).

Chaos hooks: every heartbeat passes through the ``node_dead`` fault site
(machine = node id); a matching plan rule stops the heartbeat thread and
calls the registration's ``on_dead`` callback, the in-process stand-in
for kill -9. A ``lease_refresh`` rule skips one refresh (the lease ages
while the node serves on).
"""

import json
import logging
import os
import socket
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..util import faults

logger = logging.getLogger(__name__)

GATEWAY_DIR_ENV = "GORDO_TPU_GATEWAY_DIR"
# deliberately the same knobs as the elastic scheduler's leases: one
# staleness vocabulary across the build and serve tiers
LEASE_TIMEOUT_ENV = "GORDO_TPU_LEASE_TIMEOUT_S"
HEARTBEAT_ENV = "GORDO_TPU_HEARTBEAT_S"
DEFAULT_LEASE_TIMEOUT_S = 60.0

_NODES_SUBDIR = "nodes"


def gateway_dir() -> Optional[str]:
    """The shared membership directory, or None when gateway routing is
    not configured for this process."""
    value = os.environ.get(GATEWAY_DIR_ENV, "").strip()
    return value or None


def lease_timeout_s() -> float:
    try:
        value = float(os.environ.get(LEASE_TIMEOUT_ENV, DEFAULT_LEASE_TIMEOUT_S))
    except ValueError:
        value = DEFAULT_LEASE_TIMEOUT_S
    return max(0.1, value)


def heartbeat_s() -> float:
    raw = os.environ.get(HEARTBEAT_ENV)
    if raw:
        try:
            return max(0.05, float(raw))
        except ValueError:
            pass
    return max(0.05, lease_timeout_s() / 4.0)


def default_node_id() -> str:
    return os.environ.get(
        "GORDO_TPU_HOST_ID", f"{socket.gethostname()}-{os.getpid()}"
    )


def _nodes_dir(directory: str) -> str:
    return os.path.join(directory, _NODES_SUBDIR)


def _split_generation(filename: str) -> Optional[tuple]:
    """``node-a.g3`` -> ("node-a", 3); None for non-registration files."""
    stem, dot, suffix = filename.rpartition(".g")
    if not dot or not suffix.isdigit():
        return None
    return stem, int(suffix)


@dataclass
class NodeInfo:
    """One serving node as seen through the membership directory."""

    node_id: str
    address: str  # "host:port" as advertised by the node
    generation: int
    age_s: float  # seconds since the last heartbeat touched the file
    alive: bool
    # Unix-domain socket path the node also listens on (GORDO_TPU_UDS_PATH),
    # for co-located callers; None when the node is TCP-only or the lease
    # predates the UDS lane
    uds: Optional[str] = None

    @property
    def host(self) -> str:
        return self.address.rsplit(":", 1)[0]

    @property
    def port(self) -> int:
        return int(self.address.rsplit(":", 1)[1])


class NodeRegistration:
    """A serving node's presence in the membership directory.

    Creating the registration writes generation ``max(existing) + 1`` for
    this node id (O_CREAT | O_EXCL — two racing twins cannot both own a
    generation) and starts a daemon heartbeat that atomically refreshes
    the file's payload/mtime. ``close()`` stops the heartbeat and removes
    the file, so a graceful shutdown is immediately visible instead of
    waiting out the lease timeout.
    """

    def __init__(
        self,
        directory: str,
        address: str,
        node_id: Optional[str] = None,
        on_dead: Optional[Callable[[], None]] = None,
        uds: Optional[str] = None,
    ):
        self.directory = directory
        self.address = address
        self.uds = uds
        self.node_id = node_id or default_node_id()
        self.on_dead = on_dead
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(_nodes_dir(directory), exist_ok=True)
        self.generation = self._acquire()
        self.path = self._path(self.generation)
        self._thread = threading.Thread(
            target=self._heartbeat_loop,
            name=f"gordo-node-hb-{self.node_id}",
            daemon=True,
        )
        self._thread.start()
        logger.info(
            "node %s g%d registered at %s (dir %s)",
            self.node_id, self.generation, self.address, directory,
        )

    # ------------------------------------------------------------- lease
    def _path(self, generation: int) -> str:
        return os.path.join(
            _nodes_dir(self.directory), f"{self.node_id}.g{generation}"
        )

    def _payload(self) -> str:
        payload = {
            "node_id": self.node_id,
            "address": self.address,
            "pid": os.getpid(),
            "ts": time.time(),
        }
        if self.uds:
            # co-located callers (the gateway on this host) may prefer the
            # node's Unix-domain lane over loopback TCP
            payload["uds"] = self.uds
        return json.dumps(payload)

    def _acquire(self) -> int:
        generation = self._highest_generation() + 1
        while True:
            try:
                fd = os.open(
                    self._path(generation),
                    os.O_CREAT | os.O_EXCL | os.O_WRONLY,
                )
            except FileExistsError:
                generation += 1
                continue
            with os.fdopen(fd, "w") as fh:
                fh.write(self._payload())
            return generation

    def _highest_generation(self) -> int:
        highest = 0
        try:
            names = os.listdir(_nodes_dir(self.directory))
        except OSError:
            return 0
        for name in names:
            parsed = _split_generation(name)
            if parsed and parsed[0] == self.node_id:
                highest = max(highest, parsed[1])
        return highest

    def still_current(self) -> bool:
        """Generation fencing: False once a higher generation of this node
        id exists (a restarted twin superseded us)."""
        return self._highest_generation() <= self.generation

    # --------------------------------------------------------- heartbeat
    def _refresh(self) -> None:
        base = os.path.basename(self.path)
        fd, tmp = tempfile.mkstemp(
            dir=_nodes_dir(self.directory), prefix=base + ".hb-"
        )
        try:
            with os.fdopen(fd, "w") as fh:
                fh.write(self._payload())
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _heartbeat_loop(self) -> None:
        interval = heartbeat_s()
        while not self._stop.wait(interval):
            try:
                # chaos hook: a matching ``node_dead`` rule turns this
                # beat into the node's death — heartbeat stops, the lease
                # goes stale, and on_dead (test fixture / log hook) runs
                faults.fault_point("node_dead", machine=self.node_id)
            except Exception as exc:  # noqa: BLE001 -- any injected error kills the node
                logger.warning(
                    "node %s: injected death at node_dead (%s)",
                    self.node_id, exc,
                )
                callback = self.on_dead
                if callback is not None:
                    try:
                        callback()
                    except Exception:  # noqa: BLE001 -- the callback is best-effort
                        logger.exception("node %s on_dead callback failed",
                                         self.node_id)
                return
            if not self.still_current():
                logger.warning(
                    "node %s g%d fenced by a newer generation; stopping "
                    "heartbeat", self.node_id, self.generation,
                )
                return
            try:
                # chaos hook: a ``lease_refresh`` rule skips THIS refresh
                # only — the node keeps serving and heartbeating while its
                # lease ages toward stale (the expired-but-alive split the
                # gateway must route around), unlike node_dead above which
                # ends the heartbeat for good. A ``wedge`` rule stalls the
                # beat instead (slow shared filesystem stand-in).
                faults.fault_point("lease_refresh", machine=self.node_id)
                self._refresh()
            except OSError:
                logger.exception(
                    "node %s heartbeat refresh failed", self.node_id
                )
            except Exception as exc:  # noqa: BLE001 -- injected: skip one beat
                logger.warning(
                    "node %s: injected lease_refresh skip (%s)",
                    self.node_id, exc,
                )

    def close(self) -> None:
        """Stop heartbeating and withdraw the registration (graceful
        leave: visible to the gateway on its next membership poll)."""
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=2.0)
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def __enter__(self) -> "NodeRegistration":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


class MembershipView:
    """The gateway's read side: rescan the directory, newest generation
    per node wins, stale mtime = dead."""

    def __init__(self, directory: str, timeout_s: Optional[float] = None):
        self.directory = directory
        self._timeout_s = timeout_s

    @property
    def timeout_s(self) -> float:
        return self._timeout_s if self._timeout_s is not None else lease_timeout_s()

    def poll(self) -> Dict[str, NodeInfo]:
        """All registered nodes (alive and dead), newest generation each."""
        nodes: Dict[str, NodeInfo] = {}
        nodes_dir = _nodes_dir(self.directory)
        try:
            names = os.listdir(nodes_dir)
        except OSError:
            return nodes
        now = time.time()
        timeout = self.timeout_s
        for name in sorted(names):
            parsed = _split_generation(name)
            if parsed is None:
                continue  # heartbeat temp files, strays
            node_id, generation = parsed
            known = nodes.get(node_id)
            if known is not None and known.generation >= generation:
                continue
            path = os.path.join(nodes_dir, name)
            try:
                age = now - os.stat(path).st_mtime
                with open(path) as fh:
                    payload = json.load(fh)
            except (OSError, ValueError):
                continue  # mid-replace or withdrawn; next poll settles it
            address = payload.get("address")
            if not address:
                continue
            nodes[node_id] = NodeInfo(
                node_id=node_id,
                address=address,
                generation=generation,
                age_s=max(0.0, age),
                alive=age <= timeout,
                uds=payload.get("uds") or None,
            )
        return nodes

    def live_nodes(self) -> List[NodeInfo]:
        return sorted(
            (n for n in self.poll().values() if n.alive),
            key=lambda n: n.node_id,
        )
