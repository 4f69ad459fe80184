"""
The port's gateway tier against the JAX package's: the consistent-hash
ring, the membership leases (read both ways), the node breakers, the
placement key and the hedge budget, held against ``gordo_tpu``'s on the
same inputs; the port's gateway (``server/gateway.py``) over in-process
stub fleets: placement, local routes, the ``gateway_route`` and
``node_partition`` fault sites, a node's death under load, the drain on a
``/debug/slo`` burn with the successors' pre-warm (beside the JAX gateway
on a fleet of its own), the revision named after a hot swap, pipelined
answers in request order, the Unix-domain lane, the stitched
``/debug/flight?trace=`` and the ``trace`` command beside the JAX command;
the slice as a whole (a JAX-built Transformer carried to the port, one
request routed through the port's gateway to two port nodes and through
the JAX gateway to two JAX nodes); and ``run-server``'s lease (the pool's
arbiter holds one, a worker's death leaves it, SIGTERM withdraws it)
beside ``run-gateway`` as processes.

Nodes listen on port 0; every wait is bounded, and each test has a
deadline of its own (``DEADLINE_S``).
"""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import timeit
import urllib.request
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest

from gordo_tpu.server import gateway as jax_gateway, membership as jax_membership
from gordo_tpu.util import faults as jax_faults
from gordo_tpu_torch import cli
from gordo_tpu_torch.chaos.node import ChaosNode
from gordo_tpu_torch.observability import metrics as metric_catalog, tracing
from gordo_tpu_torch.server import fastlane, gateway, membership
from gordo_tpu_torch.util import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 90.0
KNOBS = {membership.LEASE_TIMEOUT_ENV: "2.5", membership.HEARTBEAT_ENV: "0.2",
         "GORDO_TPU_GATEWAY_HEALTH_S": "0.3", "GORDO_TPU_GATEWAY_CONNECT_TIMEOUT_S": "0.5"}


@pytest.fixture(autouse=True)
def _deadline():
    """Fail the test past DEADLINE_S instead of hanging the run."""
    def expired(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S:.0f} s deadline")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, DEADLINE_S)
    yield
    signal.setitimer(signal.ITIMER_REAL, 0)
    signal.signal(signal.SIGALRM, previous)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in ("GORDO_TPU_DEBUG_ENDPOINTS", "GORDO_TPU_GATEWAY_DRAIN_BURN",
                 "GORDO_TPU_GATEWAY_HEDGE_MS", "GORDO_TPU_UDS_PATH", faults.PLAN_ENV):
        monkeypatch.delenv(name, raising=False)
    for module in (faults, jax_faults):
        module.reset_plan()
    yield
    for module in (faults, jax_faults):
        module.reset_plan()


def _set_plan(monkeypatch, rules) -> None:
    monkeypatch.setenv(faults.PLAN_ENV, json.dumps({"rules": rules}))
    faults.reset_plan()
    jax_faults.reset_plan()


def _until(probe, what: str, timeout: float = 10.0, step: float = 0.02):
    deadline = time.monotonic() + timeout
    while True:
        value = probe()
        if value:
            return value
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(step)


# ------------------------------------------------------------------- ring
@pytest.mark.parametrize("n_nodes", [3, 4, 5])
def test_ring_places_keys_as_the_jax_ring(n_nodes):
    """Candidate order for 1,000 keys and every node's share are the JAX
    ring's, exactly (the same blake2b points in the same order)."""
    nodes = [f"node-{i}" for i in range(n_nodes)]
    ours, theirs = gateway.HashRing(vnodes=64), jax_gateway.HashRing(vnodes=64)
    ours.rebuild(nodes)
    theirs.rebuild(nodes)
    assert ours.nodes == theirs.nodes
    for i in range(1000):
        key = f"m-{i:04d}"
        assert ours.candidates(key) == theirs.candidates(key)
        assert ours.candidates(key, limit=2) == theirs.candidates(key, limit=2)
    assert ours.share() == theirs.share()  # the same float sums: tolerance 0
    assert sum(ours.share().values()) == pytest.approx(1.0, abs=1e-12)


def test_ring_loss_of_a_node_moves_only_its_keys():
    keys = [f"m-{i:04d}" for i in range(1000)]
    ours, theirs = gateway.HashRing(vnodes=64), jax_gateway.HashRing(vnodes=64)
    for ring in (ours, theirs):
        ring.rebuild(["node-a", "node-b", "node-c", "node-d"])
    before = {k: ours.candidates(k)[0] for k in keys}
    for ring in (ours, theirs):
        ring.rebuild(["node-a", "node-c", "node-d"])
    for key in keys:
        after = ours.candidates(key)[0]
        assert after == theirs.candidates(key)[0]
        if before[key] != "node-b":
            assert after == before[key]
    assert gateway.HashRing(vnodes=8).candidates("m-1") == []
    assert gateway.HashRing(vnodes=8).share() == {}


# ------------------------------------------------------------- membership
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_leases_read_both_ways(tmp_path, monkeypatch, writer):
    """A lease written by one package is read by the other's view: the
    NodeInfo fields are equal, the UDS path included, and a withdrawn lease
    is gone from both."""
    for name, value in KNOBS.items():
        monkeypatch.setenv(name, value)
    mod = membership if writer == "port" else jax_membership
    sock_path = str(tmp_path / "a.sock")
    with_uds = mod.NodeRegistration(str(tmp_path), address="127.0.0.1:5555", node_id="node-a",
                                    uds=sock_path)
    without = mod.NodeRegistration(str(tmp_path), address="127.0.0.1:5556", node_id="node-b")
    try:
        ours = membership.MembershipView(str(tmp_path)).poll()
        theirs = jax_membership.MembershipView(str(tmp_path)).poll()
        assert sorted(ours) == sorted(theirs) == ["node-a", "node-b"]
        for node_id in ours:
            mine, other = asdict(ours[node_id]), asdict(theirs[node_id])
            assert abs(mine.pop("age_s") - other.pop("age_s")) < 1.0
            assert mine == other
            assert ours[node_id].port == theirs[node_id].port
        assert ours["node-a"].uds == sock_path and ours["node-b"].uds is None
        assert ours["node-a"].generation == 1 and ours["node-a"].alive
    finally:
        with_uds.close()
        without.close()
    assert membership.MembershipView(str(tmp_path)).poll() == {}
    assert jax_membership.MembershipView(str(tmp_path)).poll() == {}


def test_stale_lease_is_dead_to_both_views(tmp_path, monkeypatch):
    monkeypatch.setenv(membership.LEASE_TIMEOUT_ENV, "0.4")
    monkeypatch.setenv(membership.HEARTBEAT_ENV, "0.1")
    reg = membership.NodeRegistration(str(tmp_path), address="127.0.0.1:5555",
                                      node_id="node-a")
    try:
        assert membership.MembershipView(str(tmp_path)).poll()["node-a"].alive
        reg._stop.set()  # the heartbeat stops, the file stays: kill -9's shape
        reg._thread.join(timeout=2.0)
        views = (membership.MembershipView(str(tmp_path)),
                 jax_membership.MembershipView(str(tmp_path)))
        _until(lambda: all(not v.poll()["node-a"].alive for v in views), "a stale lease", 3.0)
        assert all(v.live_nodes() == [] for v in views)
    finally:
        reg.close()


@pytest.mark.parametrize("first", ["port", "jax"])
def test_generation_fencing_across_packages(tmp_path, monkeypatch, first):
    """A restarted twin of either package takes generation + 1; the old
    holder sees itself superseded and stops heartbeating; both views follow
    the newest generation's address."""
    monkeypatch.setenv(membership.LEASE_TIMEOUT_ENV, "5.0")
    monkeypatch.setenv(membership.HEARTBEAT_ENV, "0.1")
    old_mod, new_mod = ((membership, jax_membership) if first == "port"
                        else (jax_membership, membership))
    old = old_mod.NodeRegistration(str(tmp_path), address="127.0.0.1:1111", node_id="node-a")
    new = new_mod.NodeRegistration(str(tmp_path), address="127.0.0.1:2222", node_id="node-a")
    try:
        assert new.generation == old.generation + 1
        assert not old.still_current() and new.still_current()
        for view in (membership.MembershipView(str(tmp_path)),
                     jax_membership.MembershipView(str(tmp_path))):
            info = view.poll()["node-a"]
            assert (info.generation, info.address) == (new.generation, "127.0.0.1:2222")
        old._thread.join(timeout=2.0)
        assert not old._thread.is_alive()
    finally:
        new.close()
        old.close()


def test_node_dead_fault_stops_the_heartbeat_alike(tmp_path, monkeypatch):
    """The node_dead site: a matching rule ends each package's heartbeat
    and calls its on_dead; strays in the directory are not leases."""
    monkeypatch.setenv(membership.HEARTBEAT_ENV, "0.05")
    _set_plan(monkeypatch, [{"site": "node_dead", "machine": "node-p", "times": 1,
                             "error": "transient"},
                            {"site": "node_dead", "machine": "node-j", "times": 1,
                             "error": "transient"}])
    died = {"node-p": threading.Event(), "node-j": threading.Event()}
    regs = [mod.NodeRegistration(str(tmp_path), address="127.0.0.1:1", node_id=node_id,
                                 on_dead=died[node_id].set)
            for mod, node_id in ((membership, "node-p"), (jax_membership, "node-j"))]
    try:
        for node_id, event in died.items():
            assert event.wait(5.0), node_id
        for reg in regs:
            reg._thread.join(timeout=2.0)
            assert not reg._thread.is_alive()
    finally:
        for reg in regs:
            reg.close()
    (tmp_path / "nodes" / "not-a-lease").write_text("junk")
    (tmp_path / "nodes" / "half-written.g2").write_text("{truncated")
    assert membership.MembershipView(str(tmp_path)).poll() == {}
    assert jax_membership.MembershipView(str(tmp_path)).poll() == {}


# ---------------------------------------------------- breakers, key, budget
BREAKER_SEQUENCES = {
    "transients_then_half_open": [
        ("allow",), ("fail", "transient"), ("allow",), ("fail", "transient"), ("allow",),
        ("sleep",), ("allow",), ("allow",), ("ok",), ("allow",)],
    "permanent_opens_at_once": [("fail", "permanent"), ("allow",), ("sleep",), ("allow",),
                                ("fail", "transient"), ("allow",)],
    "success_resets_the_count": [("fail", "transient"), ("ok",), ("fail", "transient"),
                                 ("allow",), ("fail", None), ("allow",)],
}


@pytest.mark.parametrize("sequence", sorted(BREAKER_SEQUENCES))
@pytest.mark.parametrize("threshold", [0, 2])
def test_node_breaker_transitions_match_jax(sequence, threshold):
    def run(mod, fault_mod):
        breaker = mod.NodeBreaker("node-a", threshold=threshold, cooldown_s=0.2)
        seen = []
        for step in BREAKER_SEQUENCES[sequence]:
            if step[0] == "allow":
                seen.append(breaker.allow())
            elif step[0] == "ok":
                breaker.record_success()
            elif step[0] == "sleep":
                time.sleep(0.25)
            else:
                exc = {"transient": fault_mod.TransientFault("x"),
                       "permanent": fault_mod.PermanentFault("x"), None: None}[step[1]]
                breaker.record_failure(exc)
        return seen

    assert run(gateway, faults) == run(jax_gateway, jax_faults)


PATHS = ["/gordo/v0/proj/machine-1/prediction", "/gordo/v0/proj/machine-1/anomaly/prediction",
         "/gordo/v0/proj/machine-1/metadata", "/gordo/v0/proj/models/",
         "/gordo/v0/proj/revisions/", "/gordo/v0/proj/expected-models/", "/gordo/v0/proj/models",
         "/healthcheck", "/metrics", "/gordo/v0/", "/other/v0/proj/m/prediction"]


def test_placement_key_and_hedge_budget_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("GORDO_TPU_GATEWAY_HEDGE_MS", "50")
    ours = gateway.GatewayServer(str(tmp_path), host="127.0.0.1", port=0)
    theirs = jax_gateway.GatewayServer(str(tmp_path), host="127.0.0.1", port=0)
    try:
        for path in PATHS:
            assert ours._placement_key(path) == theirs._placement_key(path), path
        now = timeit.default_timer()
        for deadline_ms, elapsed_s in ((None, 0.0), (1000.0, 0.0), (1000.0, 0.9),
                                       (1000.0, 0.97), (40.0, 0.0), (200.0, 0.1)):
            started = now - elapsed_s
            assert (ours._hedge_allowed(deadline_ms, started)
                    == theirs._hedge_allowed(deadline_ms, started)
                    == (deadline_ms is None or deadline_ms - elapsed_s * 1e3 >= 50.0)), (
                deadline_ms, elapsed_s)
    finally:
        ours.server_close()
        theirs.server_close()


# ------------------------------------------------------------ stub fleets
class _Stub:
    """A fake serving node with a real lease (``mod``'s registration):
    answers every route with its id after ``delay_s`` (a ``?delay=``
    query overrides it), carries ``revision`` when set, reports ``burn`` on
    ``/debug/slo``, and logs every request. ``kill()`` (its ``on_dead``)
    closes the listener and every connection."""

    def __init__(self, directory: str, node_id: str, mod=membership):
        self.node_id = node_id
        self.burn = 0.0
        self.revision = None
        self.log = []
        self._conns = set()
        self._lock = threading.Lock()
        node = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def setup(self):
                super().setup()
                with node._lock:
                    node._conns.add(self.connection)

            def finish(self):
                with node._lock:
                    node._conns.discard(self.connection)
                super().finish()

            def _answer(self):
                path, _, query = self.path.partition("?")
                with node._lock:
                    node.log.append((self.command, self.path))
                if path == "/debug/slo":
                    doc = {"local": {"models": {"m": {"5m": {"latency_burn_rate": node.burn}}}}}
                    return self._reply(200, doc)
                delay = float(dict(p.partition("=")[::2] for p in query.split("&") if p)
                              .get("delay", 0.0))
                time.sleep(delay)
                self._reply(200, {"node": node.node_id, "path": self.path})

            def _reply(self, status, doc):
                body = json.dumps(doc).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if node.revision:
                    self.send_header("revision", node.revision)
                self.end_headers()
                self.wfile.write(body)

            do_GET = do_POST = _answer

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.registration = mod.NodeRegistration(directory, address=f"127.0.0.1:{self.port}",
                                                 node_id=node_id, on_dead=self.kill)

    def posts(self) -> list:
        with self._lock:
            return [path for method, path in self.log if method == "POST"]

    def kill(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        with self._lock:
            conns = list(self._conns)
        for sock in conns:
            for step in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
                try:
                    step()
                except OSError:
                    pass

    def close(self):
        self.registration.close()
        self.kill()
        self.thread.join(timeout=2.0)


def _start(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=5)


def _request(port: int, method: str, path: str, headers=None, body=None, timeout=10):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


@pytest.fixture
def fleet(tmp_path, monkeypatch):
    for name, value in KNOBS.items():
        monkeypatch.setenv(name, value)
    nodes = [_Stub(str(tmp_path), f"node-{c}") for c in "abc"]
    server = gateway.GatewayServer(str(tmp_path), host="127.0.0.1", port=0)
    thread = _start(server)
    _until(lambda: len(server.ring.nodes) == 3, "three nodes in the ring", 5.0)
    yield SimpleNamespace(server=server, nodes={n.node_id: n for n in nodes}, dir=tmp_path)
    _stop(server, thread)
    for node in nodes:
        node.close()


def test_gateway_routes_by_ring_placement(fleet):
    server = fleet.server
    for i in range(8):
        machine = f"m-{i:03d}"
        primary = server.ring.candidates(machine)[0]
        status, headers, body = _request(server.server_port, "GET",
                                         f"/gordo/v0/proj/{machine}/metadata")
        assert status == 200
        assert headers["x-gordo-gateway-node"] == primary == json.loads(body)["node"]
        assert "connection" in headers and "transfer-encoding" not in headers


def test_gateway_local_routes_and_no_nodes(fleet, tmp_path_factory):
    port = fleet.server.server_port
    status, _, body = _request(port, "GET", "/healthcheck")
    assert status == 200 and json.loads(body) == {"gordo-gateway": "ok", "nodes": 3}
    status, _, body = _request(port, "GET", "/gateway/status")
    doc = json.loads(body)
    assert set(doc) == {"ring", "draining", "nodes"}
    assert set(doc["nodes"]) == {"node-a", "node-b", "node-c"}
    assert set(doc["nodes"]["node-a"]) == {"address", "alive", "generation", "age_s", "draining"}
    assert sum(doc["ring"]["share"].values()) == pytest.approx(1.0)
    status, headers, body = _request(port, "GET", "/metrics")
    assert status == 200 and "text/plain" in headers["content-type"]
    assert b"gordo_gateway_nodes" in body and b"gordo_gateway_ring_share" in body
    # /debug/flight is a route only with the debug surface on: else proxied
    status, headers, _ = _request(port, "GET", "/debug/flight")
    assert headers.get("x-gordo-gateway-node")
    empty = gateway.GatewayServer(str(tmp_path_factory.mktemp("none")), port=0)
    thread = _start(empty)
    try:
        status, headers, body = _request(empty.server_port, "GET", "/gordo/v0/p/m-1/metadata")
        assert status == 503 and int(headers["retry-after"]) >= 1
        assert json.loads(body) == {"error": "no live serving nodes"}
    finally:
        _stop(empty, thread)


def test_gateway_route_fault_answers_503_once(fleet, monkeypatch):
    _set_plan(monkeypatch, [{"site": "gateway_route", "machine": "m-001", "times": 1,
                             "error": "transient"}])
    before = dict(metric_catalog.GATEWAY_REQUESTS.snapshot()).get(("none", "503"), 0.0)
    status, headers, _ = _request(fleet.server.server_port, "GET", "/gordo/v0/p/m-001/metadata")
    assert status == 503 and headers.get("retry-after")
    assert dict(metric_catalog.GATEWAY_REQUESTS.snapshot())[("none", "503")] == before + 1
    status, _, _ = _request(fleet.server.server_port, "GET", "/gordo/v0/p/m-001/metadata")
    assert status == 200


def test_node_partition_hedges_to_the_successor(fleet, monkeypatch):
    machine = "m-007"
    order = fleet.server.ring.candidates(machine)
    _set_plan(monkeypatch, [{"site": "node_partition", "machine": order[0], "times": 1,
                             "error": "transient"}])
    hedges = dict(metric_catalog.GATEWAY_HEDGES.snapshot()).get(("connect",), 0.0)
    failovers = dict(metric_catalog.GATEWAY_FAILOVERS.snapshot()).get((order[0],), 0.0)
    status, headers, body = _request(fleet.server.server_port, "GET",
                                     f"/gordo/v0/p/{machine}/metadata")
    assert status == 200 and headers["x-gordo-gateway-node"] == order[1]
    assert json.loads(body)["node"] == order[1]
    assert dict(metric_catalog.GATEWAY_HEDGES.snapshot())[("connect",)] == hedges + 1
    assert dict(metric_catalog.GATEWAY_FAILOVERS.snapshot())[(order[0],)] == failovers + 1
    # a hedge the deadline cannot pay for is not spent: the answer is a 502
    _set_plan(monkeypatch, [{"site": "node_partition", "machine": order[0], "times": 1,
                             "error": "transient"}])
    status, _, body = _request(fleet.server.server_port, "GET",
                               f"/gordo/v0/p/{machine}/metadata",
                               headers={"X-Gordo-Deadline-Ms": "10"})
    assert status == 502 and json.loads(body)["error"] == "all replicas failed"


def test_killed_node_healthy_shards_unharmed(fleet, monkeypatch):
    """One node killed through node_dead under load: the healthy shards
    never fail, the killed shard answers again within one lease timeout
    (the hedge), and the membership drops the node."""
    server = fleet.server
    machines = [f"m-{i:03d}" for i in range(60)]
    primaries = {m: server.ring.candidates(m)[0] for m in machines}
    victim = primaries[machines[0]]
    victims = [m for m in machines if primaries[m] == victim][:3]
    healthy = [m for m in machines if primaries[m] != victim][:3]
    results, t_kill, i = [], None, 0
    t0 = time.monotonic()
    while time.monotonic() - t0 < 12.0:
        machine = (victims + healthy)[i % 6]
        i += 1
        status, headers, _ = _request(server.server_port, "GET",
                                      f"/gordo/v0/p/{machine}/metadata", timeout=5)
        results.append((time.monotonic() - t0, machine, status,
                        headers.get("x-gordo-gateway-node")))
        if t_kill is None and i == 18:
            _set_plan(monkeypatch, [{"site": "node_dead", "machine": victim, "times": 1,
                                     "error": "transient"}])
            t_kill = time.monotonic() - t0
        if t_kill is not None and victim not in server._live and i % 6 == 0:
            break
        time.sleep(0.015)
    assert t_kill is not None and victim not in server._live
    assert all(r[2] == 200 for r in results if r[1] in healthy)
    after = [r for r in results if r[1] in victims and r[0] > t_kill and r[2] == 200]
    assert after and after[0][0] - t_kill <= 2.5
    assert all(r[3] != victim for r in results[-3:])
    errors = [r for r in results if r[2] != 200]
    assert len(errors) <= max(3, len(results) // 10), errors


@pytest.mark.parametrize("package", ["port", "jax"])
def test_drain_on_slo_burn_prewarms_successors_with_the_revision(tmp_path, monkeypatch,
                                                                 package):
    """A node whose /debug/slo burn passes GORDO_TPU_GATEWAY_DRAIN_BURN is
    drained: its machines go to their successors, which get a
    ``POST /debug/prewarm`` naming each machine and the revision it last
    answered with (the hot swap's new one); a burn under half the trip
    point brings it back. The JAX gateway posts the same targets."""
    for name, value in KNOBS.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("GORDO_TPU_GATEWAY_HEALTH_S", "0.1")
    mod, mem = (gateway, membership) if package == "port" else (jax_gateway, jax_membership)
    nodes = {c: _Stub(str(tmp_path), f"node-{c}", mem) for c in "ab"}
    server = mod.GatewayServer(str(tmp_path), host="127.0.0.1", port=0)
    thread = _start(server)
    try:
        _until(lambda: len(server.ring.nodes) == 2, "two nodes in the ring", 5.0)
        machines = [f"m-{i:03d}" for i in range(12)]
        drained = server.ring.candidates(machines[0])[0]
        mine = [m for m in machines if server.ring.candidates(m)[0] == drained]
        for stub in nodes.values():
            stub.revision = "rev-1"
        for machine in machines:
            assert _request(server.server_port, "GET", f"/gordo/v0/p/{machine}/metadata")[0] \
                == 200
        for stub in nodes.values():  # the hot swap: the fleet answers with rev-2
            stub.revision = "rev-2"
        for machine in mine:
            assert _request(server.server_port, "GET", f"/gordo/v0/p/{machine}/metadata")[0] \
                == 200
        other = next(s for s in nodes.values() if s.node_id != drained)
        nodes[drained[-1]].burn = 100.0
        _until(lambda: drained in server._draining, "the drain", 5.0)
        expected = {f"/debug/prewarm?machine={m}&revision=rev-2" for m in mine}
        _until(lambda: expected <= set(other.posts()), "the successor's pre-warm posts", 5.0)
        assert all(p in expected for p in other.posts())
        status, headers, _ = _request(server.server_port, "GET", f"/gordo/v0/p/{mine[0]}/x")
        assert status == 200 and headers["x-gordo-gateway-node"] == other.node_id
        nodes[drained[-1]].burn = 1.0
        _until(lambda: drained not in server._draining, "the recovery", 5.0)
    finally:
        _stop(server, thread)
        for stub in nodes.values():
            stub.close()


def test_pipelined_answers_leave_in_request_order(fleet):
    """Off the loop, a slow answer does not let a later one overtake it on
    a keep-alive connection: three pipelined requests, the first the
    slowest, come back in the order sent."""
    with socket.create_connection(("127.0.0.1", fleet.server.server_port), timeout=10) as sock:
        requests = b"".join(
            f"GET /gordo/v0/p/m-{i:03d}/metadata?delay={d} HTTP/1.1\r\nHost: g\r\n\r\n".encode()
            for i, d in ((0, 0.3), (1, 0.0), (2, 0.1)))
        sock.sendall(requests)
        data = b""
        while data.count(b"HTTP/1.1 200") < 3 or not data.endswith(b"}"):
            chunk = sock.recv(65536)
            assert chunk, data
            data += chunk
    paths = [json.loads(part.split(b"\r\n\r\n", 1)[1].split(b"HTTP/1.1")[0])["path"]
             for part in data.split(b"HTTP/1.1 200")[1:]]
    assert [p.split("?")[0] for p in paths] == [f"/gordo/v0/p/m-{i:03d}/metadata"
                                                 for i in range(3)]


class _App:
    """The dispatch a fast lane fronts: every route answers its path."""

    def dispatch(self, method, target, headers, body, started):
        return 200, [("Content-Type", "application/json")], json.dumps(
            {"node": "uds-only", "path": target}).encode()

    prediction_request = None


@pytest.mark.parametrize("stale", [False, True], ids=["uds", "stale_uds_to_tcp"])
def test_gateway_prefers_the_advertised_uds(tmp_path, monkeypatch, stale):
    """A node's advertised Unix-domain socket carries the request (its TCP
    address is dead); a stale socket path falls back to TCP on the same
    node before any hedge."""
    for name, value in KNOBS.items():
        monkeypatch.setenv(name, value)
    sock_path = str(tmp_path / "node.sock")
    node = fastlane.EventLoopServer(_App(), host="127.0.0.1", port=0,
                                    uds="" if stale else sock_path)
    node_thread = _start(node)
    if stale:
        orphan = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        orphan.bind(sock_path)
        orphan.close()  # a socket file nothing listens on
    address = f"127.0.0.1:{node.server_port}" if stale else "127.0.0.1:1"
    reg = membership.NodeRegistration(str(tmp_path), address=address, node_id="node-u",
                                      uds=sock_path)
    server = gateway.GatewayServer(str(tmp_path), host="127.0.0.1", port=0)
    thread = _start(server)
    try:
        status, headers, body = _request(server.server_port, "GET", "/gordo/v0/p/m-1/metadata")
        assert status == 200 and headers["x-gordo-gateway-node"] == "node-u"
        assert json.loads(body)["node"] == "uds-only"
    finally:
        _stop(server, thread)
        reg.close()
        _stop(node, node_thread)


# ---------------------------------------------------------------- traces
@pytest.fixture
def chaos_fleet(tmp_path, monkeypatch):
    """Two in-process chaos nodes (the port's node-side span tree and
    flight recorder), debug endpoints on."""
    for name, value in KNOBS.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("GORDO_TPU_DEBUG_ENDPOINTS", "1")
    nodes = [ChaosNode(str(tmp_path), f"node-{i}") for i in range(2)]
    threads = [threading.Thread(target=n.serve_forever, daemon=True) for n in nodes]
    for t in threads:
        t.start()
    yield SimpleNamespace(dir=tmp_path, nodes=nodes)
    for node in nodes:
        node.close()


def _traced_stitch(mod, directory, victim_plan, monkeypatch):
    """One traced request through ``mod``'s gateway (the primary
    partitioned when ``victim_plan``), and its stitched document."""
    server = mod.GatewayServer(str(directory), host="127.0.0.1", port=0)
    thread = _start(server)
    try:
        _until(lambda: len(server.ring.nodes) == 2, "two nodes in the ring", 5.0)
        primary = server.ring.candidates("m-001")[0]
        if victim_plan:
            _set_plan(monkeypatch, [{"site": "node_partition", "machine": primary, "times": 1,
                                     "error": "transient"}])
        trace_id = tracing.new_trace_id()
        headers = {"traceparent": f"00-{trace_id}-{tracing.new_span_id()}-01"}
        status, answer_headers, _ = _request(server.server_port, "GET",
                                             "/gordo/v0/chaos/m-001/prediction", headers)
        assert status == 200 and answer_headers["x-gordo-trace"] == trace_id
        assert "server-timing" in answer_headers
        status, _, raw = _request(server.server_port, "GET", f"/debug/flight?trace={trace_id}")
        assert status == 200
        missing = _request(server.server_port, "GET", "/debug/flight?trace=" + "0" * 32)
        assert missing[0] == 404
        return json.loads(raw), primary, trace_id
    finally:
        _stop(server, thread)


@pytest.mark.parametrize("hedged", [False, True], ids=["plain", "hedged"])
def test_stitched_flight_has_the_jax_gateways_keys(chaos_fleet, monkeypatch, hedged):
    """``/debug/flight?trace=`` through the port's gateway and the JAX one
    over the same nodes: the same document keys, the same ``gordoStitch``
    keys and entries, the node's subtree grafted under the attempt that
    reached it; a partitioned primary is the hedge's failed attempt."""
    docs = {}
    for name, mod in (("port", gateway), ("jax", jax_gateway)):
        docs[name] = _traced_stitch(mod, chaos_fleet.dir, hedged, monkeypatch)
    (ours, primary, trace_id), (theirs, _, _) = docs["port"], docs["jax"]
    assert set(ours) == set(theirs)
    assert set(ours["gordoStitch"]) == set(theirs["gordoStitch"]) == {"trace_id", "nodes",
                                                                      "complete"}
    assert ours["gordoStitch"]["trace_id"] == trace_id
    strip = lambda doc: [{k: v for k, v in e.items() if k != "events"}  # noqa: E731
                         for e in doc["gordoStitch"]["nodes"]]
    assert strip(ours) == strip(theirs)
    names = lambda doc: sorted(e["name"] for e in doc["traceEvents"])  # noqa: E731
    assert names(ours) == names(theirs)
    spans = {e["args"]["span_id"]: e for e in ours["traceEvents"]}
    attempts = [e for e in ours["traceEvents"] if e["name"] == "gateway_upstream_attempt"]
    served = [e for e in ours["traceEvents"] if e["name"] == "serve_request"]
    assert len(served) == 1
    parent = spans[served[0]["args"]["parent_span_id"]]
    assert parent["name"] == "gateway_upstream_attempt"
    assert served[0]["args"]["gordo_node"] == parent["args"]["node"]
    if hedged:
        assert [a["args"]["node"] for a in attempts][0] == primary
        assert attempts[0]["args"].get("error") and attempts[1]["args"]["status"] == "200"
        assert ours["gordoStitch"]["complete"] is False
    else:
        assert len(attempts) == 1 and ours["gordoStitch"]["complete"] is True


class _DocServer:
    """Serves one document at every path (``status``)."""

    def __init__(self, doc: dict, status: int = 200):
        body = json.dumps(doc).encode()

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


STITCHED = {
    "traceEvents": [
        {"name": "gateway_request", "ph": "X", "ts": 0.0, "dur": 2500.0,
         "args": {"trace_id": "ab" * 16, "span_id": "s-root", "parent_span_id": "",
                  "method": "GET", "status": "200"}},
        {"name": "gateway_upstream_attempt", "ph": "X", "ts": 10.0, "dur": 400.0,
         "args": {"trace_id": "ab" * 16, "span_id": "s-a0", "parent_span_id": "s-root",
                  "node": "node-1", "attempt": "0", "error": "refused", "lane": "tcp"}},
        {"name": "gateway_upstream_attempt", "ph": "X", "ts": 500.0, "dur": 1900.0,
         "args": {"trace_id": "ab" * 16, "span_id": "s-a1", "parent_span_id": "s-root",
                  "node": "node-0", "attempt": "1", "status": "200", "lane": "uds"}},
        {"name": "serve_request", "ph": "X", "ts": 3.0, "dur": 1500.0,
         "args": {"trace_id": "ab" * 16, "span_id": "n-0", "parent_span_id": "s-a1",
                  "gordo_node": "node-0", "machine": "m-1"}},
        {"name": "serve_device_call", "ph": "X", "ts": 9.0, "dur": 700.25,
         "args": {"trace_id": "ab" * 16, "span_id": "n-1", "parent_span_id": "n-0",
                  "gordo_node": "node-0", "links": "x"}},
        {"name": "orphan", "ph": "X", "ts": -1.0, "dur": 1.0,
         "args": {"span_id": "o-1", "parent_span_id": "gone"}},
    ],
    "gordoStitch": {"trace_id": "ab" * 16, "complete": False,
                    "nodes": [{"node": "node-1", "ok": False, "reason": "unreachable (X)"},
                              {"node": "node-0", "ok": True, "events": 2}]},
}


@pytest.mark.parametrize("status", [200, 404])
def test_trace_command_prints_the_jax_commands_lines(tmp_path, capsys, status):
    """``trace`` against one stitched document: the same lines and exit
    code as the JAX command's, and the ``--out`` file the same JSON."""
    from click.testing import CliRunner
    from gordo_tpu.cli.cli import trace_cli

    served = _DocServer(STITCHED, status)
    try:
        args = ["ab" * 16, "--port", str(served.port)]
        theirs = CliRunner().invoke(trace_cli, args + ["--out",
                                                                        str(tmp_path / "j")])
        code = cli.main(["trace"] + args + ["--out", str(tmp_path / "p")])
    finally:
        served.close()
    out = capsys.readouterr()
    assert code == theirs.exit_code == (0 if status == 200 else 1)
    if status == 200:
        assert out.out.splitlines() == theirs.stdout.splitlines()
        assert "stitch node-1: MISSING (unreachable (X))" in out.out.splitlines()
        assert json.loads((tmp_path / "p").read_text()) == json.loads((tmp_path / "j").read_text())
    else:
        assert out.err.strip() == theirs.stderr.strip()


def test_trace_command_unreachable_exits_2(capsys):
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    assert cli.main(["trace", "ab" * 16, "--port", str(port)]) == 2
    assert capsys.readouterr().err.startswith(f"error: cannot reach 127.0.0.1:{port}")


# ------------------------------------------------------ the slice, whole
@pytest.fixture(scope="module")
def slice_collections(tmp_path_factory):
    """A narrow 2-block Transformer detector built by the JAX package, and
    the port's artifact of the same parameters (serializer/from_jax.py)."""
    from gordo_tpu import serializer as jax_serializer
    from gordo_tpu.builder.local_build import local_build
    from test_torch_serving import CONFIG, NAME, _port_from_jax_artifact

    root = tmp_path_factory.mktemp("gateway-slice")
    jax_coll, port_coll = root / "jax" / "111", root / "port" / "111"
    (model, machine), = local_build(CONFIG)
    jax_serializer.dump(model, str(jax_coll / NAME), metadata=machine.to_dict())
    _port_from_jax_artifact(str(jax_coll / NAME), str(port_coll / NAME))
    return NAME, str(jax_coll), str(port_coll)


def _routed(mod, directory, path, body):
    server = mod.GatewayServer(str(directory), host="127.0.0.1", port=0)
    thread = _start(server)
    try:
        _until(lambda: len(server.ring.nodes) == 2, "two nodes in the ring", 10.0)
        machine = path.split("/")[4]
        status, headers, answer = _request(server.server_port, "POST", path,
                                           {"Content-Type": "application/json"}, body, 120)
        assert status == 200, answer[:300]
        assert headers["x-gordo-gateway-node"] == server.ring.candidates(machine)[0]
        return json.loads(answer)
    finally:
        _stop(server, thread)


def test_routed_answer_matches_the_jax_gateways(slice_collections, tmp_path, monkeypatch):
    """The same anomaly request through the port's gateway to two port
    nodes and through the JAX gateway to two JAX nodes carrying the same
    parameters: the structure is exact, values within 1e-5 (float32, the
    two frameworks sum in different orders)."""
    from werkzeug.serving import make_server as werkzeug_server
    from gordo_tpu.server.server import build_app
    from gordo_tpu_torch.server.server import make_server
    from test_torch_serving import _assert_same_data, _payload

    for name, value in KNOBS.items():
        monkeypatch.setenv(name, value)
    name, jax_coll, port_coll = slice_collections
    path = f"/gordo/v0/proj/{name}/anomaly/prediction"
    body = json.dumps(_payload()).encode()
    nodes, regs = [], []
    try:
        for i in range(2):
            port_node = make_server("127.0.0.1", 0, device="cpu", collection_dir=port_coll)
            jax_node = werkzeug_server("127.0.0.1", 0, build_app({"MODEL_COLLECTION_DIR":
                                                                 jax_coll}), threaded=True)
            for node in (port_node, jax_node):
                nodes.append((node, _start(node)))
            regs.append(membership.NodeRegistration(
                str(tmp_path / "port"), address=f"127.0.0.1:{port_node.server_address[1]}",
                node_id=f"port-{i}"))
            regs.append(jax_membership.NodeRegistration(
                str(tmp_path / "jax"), address=f"127.0.0.1:{jax_node.server_port}",
                node_id=f"jax-{i}"))
        ours = _routed(gateway, tmp_path / "port", path, body)
        theirs = _routed(jax_gateway, tmp_path / "jax", path, body)
    finally:
        for reg in regs:
            reg.close()
        for node, thread in nodes:
            node.shutdown()
            node.server_close()
            thread.join(timeout=10)
    assert set(ours) == set(theirs) and ours["revision"] == theirs["revision"] == "111"
    _assert_same_data(ours["data"], theirs["data"])


# ---------------------------------------------------------- as processes
def _leases(directory) -> dict:
    nodes = os.path.join(directory, "nodes")
    out = {}
    for name in os.listdir(nodes) if os.path.isdir(nodes) else ():
        if ".hb-" not in name:
            try:
                out[name] = json.loads(open(os.path.join(nodes, name)).read())
            except (OSError, ValueError):
                continue
    return out


@pytest.fixture(scope="module")
def small_collection(tmp_path_factory):
    from test_torch_resilience import write_artifacts

    path = tmp_path_factory.mktemp("gateway-pool") / "1"
    path.mkdir()
    write_artifacts(path, ["m-0", "m-1"])
    return path


class _Server:
    """``python -m gordo_tpu_torch run-server --port <a free port> --device
    cpu`` under ``GORDO_TPU_GATEWAY_DIR=directory``, in a session of its own:
    its address is the one its lease advertises (``--port`` is 1-65535, as
    the JAX command's)."""

    def __init__(self, collection, tmp_path, directory, workers: int, **env):
        from test_torch_server_pool import _env, _free_port

        self.directory = directory
        self.log = tmp_path / f"server-{workers}.log"
        with open(self.log, "w") as fh:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "gordo_tpu_torch", "--log-level", "INFO", "run-server",
                 "--host", "127.0.0.1", "--port", str(_free_port()), "--device", "cpu",
                 "--workers", str(workers)],
                cwd=REPO, env=_env(collection, GORDO_TPU_GATEWAY_DIR=str(directory), **env),
                stdout=subprocess.DEVNULL, stderr=fh, start_new_session=True)

    def lease(self) -> dict:
        def mine():
            assert self.proc.poll() is None, self.log.read_text()[-3000:]
            return next((lease for lease in _leases(self.directory).values()
                         if lease["pid"] == self.proc.pid), None)
        return _until(mine, "the server's lease", 60.0, 0.1)

    def serving(self, workers: int) -> str:
        """The base URL, once ``workers`` workers serve and it answers."""
        base = f"http://{self.lease()['address']}"

        def up():
            assert self.proc.poll() is None, self.log.read_text()[-3000:]
            return self.log.read_text().count("Serving ") >= workers and _swallow(
                lambda: urllib.request.urlopen(base + "/healthcheck", timeout=5).status == 200)
        _until(up, "the server to answer", 60.0, 0.1)
        return base

    def stop(self, sig=signal.SIGKILL, timeout: float = 30.0) -> int:
        if self.proc.poll() is None:
            os.kill(self.proc.pid, sig)
        try:
            return self.proc.wait(timeout=timeout)
        finally:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def test_pool_holds_one_lease_from_its_arbiter(small_collection, tmp_path):
    """``run-server --workers 2`` under GORDO_TPU_GATEWAY_DIR holds one
    lease, written by the arbiter; a worker's SIGKILL leaves it (same
    generation, still heartbeating); SIGTERM withdraws it."""
    from test_torch_server_pool import ANOMALY, _body, _children, _post

    directory = tmp_path / "members"
    server = _Server(small_collection, tmp_path, directory, 2,
                     **{membership.LEASE_TIMEOUT_ENV: "2.0", membership.HEARTBEAT_ENV: "0.1"})
    try:
        base = server.serving(2)
        (name, lease), = _leases(directory).items()
        assert lease["pid"] == server.proc.pid and "uds" not in lease and name.endswith(".g1")
        workers = _children(server.proc.pid)
        assert len(workers) == 2
        os.kill(workers[0], signal.SIGKILL)
        _until(lambda: len([p for p in _children(server.proc.pid) if p != workers[0]]) == 2,
               "the pool to respawn", 60.0, 0.1)
        assert _post(base + ANOMALY, _body())[0] == 200
        stamp = _leases(directory)[name]["ts"]
        _until(lambda: _leases(directory).get(name, {}).get("ts", stamp) > stamp,
               "a heartbeat after the respawn", 5.0)
        assert list(_leases(directory)) == [name]
        assert membership.MembershipView(str(directory)).poll()[lease["node_id"]].alive
        assert server.stop(signal.SIGTERM) == 0
        assert _leases(directory) == {}
    finally:
        server.stop()


def test_run_gateway_routes_to_a_run_server_node(small_collection, tmp_path):
    """``run-server --workers 1`` with the fast lane and a UDS path
    advertises both; ``python -m gordo_tpu_torch run-gateway`` places a
    prediction on it; SIGTERM to the node withdraws its lease at once."""
    from test_torch_server_pool import ANOMALY, _body, _env, _free_port

    directory = tmp_path / "members"
    knobs = {membership.LEASE_TIMEOUT_ENV: "2.0", membership.HEARTBEAT_ENV: "0.1",
             "GORDO_TPU_GATEWAY_HEALTH_S": "0.2"}
    uds = str(tmp_path / "node.sock")
    node = _Server(small_collection, tmp_path, directory, 1, GORDO_TPU_FAST_LANE="1",
                   GORDO_TPU_UDS_PATH=uds, **knobs)
    port = _free_port()  # run-gateway's --port is 1-65535, as the JAX command's
    log = tmp_path / "gateway.log"
    with open(log, "w") as fh:
        gw = subprocess.Popen(
            [sys.executable, "-m", "gordo_tpu_torch", "run-gateway", "--host", "127.0.0.1",
             "--port", str(port), "--membership-dir", str(directory)],
            cwd=REPO, env=_env(small_collection, **knobs), stdout=subprocess.DEVNULL,
            stderr=fh, start_new_session=True)
    try:
        node.serving(1)
        (lease,) = _leases(directory).values()
        assert lease["uds"] == uds and lease["pid"] == node.proc.pid

        def routed():
            req = urllib.request.Request(f"http://127.0.0.1:{port}{ANOMALY}", data=_body(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status == 200 and resp.headers["X-Gordo-Gateway-Node"] == \
                    lease["node_id"] and json.loads(resp.read())
        try:
            answer = _until(lambda: _swallow(routed), "a routed 200", 60.0, 0.2)
        except AssertionError:
            raise AssertionError(log.read_text()[-3000:]) from None
        assert "total-anomaly-scaled" in answer["data"]
        assert node.stop(signal.SIGTERM) == 0
        assert _leases(directory) == {}
        _until(lambda: json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/gateway/status", timeout=10).read())["nodes"] == {},
            "the gateway to drop the node", 5.0)
    finally:
        node.stop()
        gw.send_signal(signal.SIGTERM)
        try:
            gw.wait(timeout=10)
        finally:
            if gw.poll() is None:
                gw.kill()


def _swallow(probe):
    try:
        return probe()
    except OSError:
        return None
