"""
The port's chaos drills (``gordo_tpu_torch/chaos``) against the JAX
package's (``gordo_tpu/chaos``): every committed scenario (the JAX YAML
parsed by the JAX package, its JSON copy by the port) parses alike, bad
vocabulary is refused with the same errors, each invariant gives the JAX
result on the same run context, the load's schedules and keys are
``benchmarks/load_test.py``'s for the same seed, the stub node answers as
the JAX one, the drift burst and the lease tampering act alike, the JAX
tiny drill (its numbers unchanged) passes under the port's conductor with
the JAX report's keys, and ``chaos list`` / ``chaos run`` print as the JAX
commands do.

Each test has a deadline of its own (``DEADLINE_S``); the drills' nodes
listen on port 0.
"""

import dataclasses
import http.client
import json
import os
import shutil
import signal
import tempfile
import threading
from types import SimpleNamespace

import pytest
import yaml

from benchmarks import load_test as jax_load
from gordo_tpu.chaos import conductor as jax_conductor, invariants as jax_inv
from gordo_tpu.chaos import node as jax_node, scenario as jax_scn, stack as jax_stack
from gordo_tpu.observability.latency import LatencyHistogram as JaxHistogram
from gordo_tpu.server import resilience as jax_resilience
from gordo_tpu.util import faults as jax_faults
from gordo_tpu_torch import cli
from gordo_tpu_torch.chaos import conductor, invariants as inv, load, node, scenario as scn, stack
from gordo_tpu_torch.observability.latency import LatencyHistogram
from gordo_tpu_torch.server import resilience
from gordo_tpu_torch.util import faults, yaml_subset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(REPO, "resources", "chaos")
DEADLINE_S = 90.0
SCENARIOS = sorted(os.path.splitext(f)[0] for f in os.listdir(JAX_DIR) if f.endswith(".yaml"))


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
    for name in (faults.PLAN_ENV, "GORDO_TPU_BREAKER_THRESHOLD", "GORDO_TPU_DEBUG_ENDPOINTS"):
        monkeypatch.delenv(name, raising=False)
    for module in (faults, jax_faults):
        module.reset_plan()
    for module in (resilience, jax_resilience):
        module.reset_for_tests()
    yield
    for module in (faults, jax_faults):
        module.reset_plan()


def _fields(spec) -> dict:
    out = dataclasses.asdict(spec)
    out.pop("path")
    return out


# -------------------------------------------------------------- scenarios
def test_scenario_copies_cover_the_committed_drills():
    ours = sorted(os.path.splitext(f)[0] for f in os.listdir(scn.SCENARIO_DIR))
    assert ours == SCENARIOS and len(ours) == 6


@pytest.mark.parametrize("name", SCENARIOS)
def test_committed_scenario_parses_as_the_jax_yaml(name):
    """The JSON copy is ``yaml.safe_load`` of the JAX file, and the port's
    parse of it equals the JAX parse of the YAML, field by field."""
    jax_path = os.path.join(JAX_DIR, name + ".yaml")
    port_path = os.path.join(scn.SCENARIO_DIR, name + ".json")
    with open(jax_path) as fh, open(port_path) as gh:
        assert json.load(gh) == yaml.safe_load(fh)
    ours, theirs = scn.load_scenario(port_path), jax_scn.load_scenario(jax_path)
    assert _fields(ours) == _fields(theirs)
    assert ours.invariants


def _minimal_doc(**overrides):
    doc = {"name": "unit", "stack": {"nodes": 2}, "machines": 4,
           "load": {"phases": [{"shape": "flat", "qps": 10, "duration": 1}]},
           "invariants": [{"check": "availability", "min": 0.9}]}
    doc.update(overrides)
    return doc


BAD = {
    "shape": {"load": {"phases": [{"shape": "sawtooth", "qps": 10, "duration": 1}]}},
    "knob": {"load": {"phases": [{"shape": "flat", "qps": 10, "duration": 1, "bogus_knob": 3}]}},
    "rate": {"load": {"phases": [{"shape": "flat", "qps": 0, "duration": 1}]}},
    "action": {"timeline": [{"at": 0.5, "action": "reboot_node", "node": 0}]},
    "node": {"timeline": [{"at": 0.5, "action": "kill_node", "node": 7}]},
    "order": {"timeline": [{"at": 2.0, "action": "kill_node", "node": 0},
                           {"at": 1.0, "action": "stop_node", "node": 1}]},
    "plan_action": {"timeline": [{"at": 1.0, "action": "set_fault_plan"}]},
    "check": {"invariants": [{"check": "always_fine"}]},
    "site": {"fault_plan": {"rules": [{"site": "not_a_site", "times": 1,
                                       "error": "transient"}]}},
    "plan": {"fault_plan": {"not_rules": []}},
    "chaff": {"load": {"phases": [{"shape": "flat", "qps": 10, "duration": 1}],
                       "chaff": [{"kind": "udp_flood", "conns": 2, "duration": 1}]}},
    "machines": {"machines": "m-1"},
    "nodes": {"stack": {"nodes": 0}},
    "name": {"name": ""},
}


@pytest.mark.parametrize("mutation", sorted(BAD))
def test_bad_vocabulary_is_refused_alike(mutation):
    doc = _minimal_doc(**BAD[mutation])
    with pytest.raises(scn.ScenarioError) as ours:
        scn.parse_scenario(doc)
    with pytest.raises(jax_scn.ScenarioError) as theirs:
        jax_scn.parse_scenario(doc)
    assert str(ours.value) == str(theirs.value)


def test_minimal_scenario_and_yaml_refusal(tmp_path):
    assert _fields(scn.parse_scenario(_minimal_doc())) == _fields(
        jax_scn.parse_scenario(_minimal_doc()))
    path = tmp_path / "s.json"
    path.write_text(json.dumps(_minimal_doc()))
    assert scn.load_scenario(str(path)).machines == ["m-000", "m-001", "m-002", "m-003"]
    # a YAML scenario loads as its JSON copy does (util/yaml_subset.py)
    yaml_path = os.path.join(JAX_DIR, "kill_node_mid_ramp.yaml")
    assert _fields(scn.load_scenario(yaml_path)) == _fields(
        scn.load_scenario(os.path.join(scn.SCENARIO_DIR, "kill_node_mid_ramp.json")))
    (tmp_path / "mine.yml").write_text("name: x\n")
    assert _fields(scn.load_scenario(str(tmp_path / "mine.yml"))) == _fields(
        jax_scn.load_scenario(str(tmp_path / "mine.yml")))
    (tmp_path / "anchored.yaml").write_text("name: &n x\n")
    with pytest.raises(yaml_subset.YAMLSubsetError, match="an anchor"):
        scn.load_scenario(str(tmp_path / "anchored.yaml"))
    (tmp_path / "broken.json").write_text("{not json")
    with pytest.raises(scn.ScenarioError, match="not JSON"):
        scn.load_scenario(str(tmp_path / "broken.json"))


# -------------------------------------------------------------- invariants
def _contexts(package: str) -> dict:
    """Named run contexts built with ``package``'s classes (a log of 10
    arrivals over two machines, and variants)."""
    mod, hist_cls = (inv, LatencyHistogram) if package == "port" else (jax_inv, JaxHistogram)
    states = resilience if package == "port" else jax_resilience

    def ctx(**overrides):
        log = [(i * 0.1, 0.005 * (1 + i % 3), None, f"m-{i % 2:03d}", i // 5) for i in range(10)]
        log = overrides.pop("log", log)
        hist = hist_cls()
        for e in log:
            if e[2] is None:
                hist.record(e[1])
        per_phase = {}
        for e in log:
            if e[2] is None:
                per_phase.setdefault(e[4], hist_cls()).record(e[1])
        base = dict(log=log, hist=hist, per_phase=per_phase, scheduled={0: 5, 1: 5},
                    primaries={"m-000": "node-0", "m-001": "node-1"}, actions=[], breakers={},
                    drift=None)
        base.update(overrides)
        return mod.RunContext(**base)

    failed = [(0.0, 0.005, "http-503", "m-000", 0)] + [
        (i * 0.1, 0.005, None, f"m-{i % 2:03d}", 0) for i in range(1, 10)]
    transport = [(0.0, 0.005, "ConnectionResetError(54)", "m-000", 0),
                 (0.1, 0.005, "http-404", "m-001", 0)] + [
        (i * 0.1, 0.005, None, f"m-{i % 2:03d}", 0) for i in range(2, 10)]
    kill = [{"action": "kill_node", "node": 0, "node_id": "node-0", "fired_at": 0.35,
             "at": 0.3}]
    stitched = {"doc": _stitched_doc(), "victim": "node-1", "trace_id": "ab" * 16}
    return {
        "clean": ctx(),
        "failed": ctx(log=failed),
        "transport": ctx(log=transport),
        "killed": ctx(actions=kill),
        "stop_other": ctx(actions=[dict(kill[0], action="stop_node", node=1,
                                        node_id="node-1")]),
        "short": ctx(scheduled={0: 6, 1: 5}),
        "breakers": ctx(breakers={"node-0": {"m-003": states.OPEN, "m-001": states.CLOSED},
                                  "node-1": {"m-004": states.HALF_OPEN}}),
        "drift": ctx(drift={"machines": 4, "threads": 8, "enqueued": 4, "depth": 4}),
        "drift_dup": ctx(drift={"machines": 4, "threads": 8, "enqueued": 6, "depth": 6}),
        "stitched": ctx(stitched=stitched),
        "stitched_torn": ctx(stitched={"doc": _stitched_doc(with_subtree=False),
                                       "victim": "node-1"}),
        "stitched_wrong": ctx(stitched=dict(stitched, victim="node-9")),
        "stitched_none": ctx(stitched={"reason": "probe never landed"}),
        "empty": ctx(log=[], scheduled={}),
    }


def _stitched_doc(victim="node-1", survivor="node-0", with_subtree=True):
    def ev(name, span_id, parent, **attrs):
        args = {"trace_id": "ab" * 16, "span_id": span_id, "parent_span_id": parent}
        args.update({k: str(v) for k, v in attrs.items()})
        return {"name": name, "ph": "X", "args": args}

    events = [ev("gateway_request", "s-root", "", method="GET", status=200),
              ev("gateway_upstream_attempt", "s-a0", "s-root", node=victim, attempt=0,
                 error="ConnectionRefusedError(111)"),
              ev("gateway_upstream_attempt", "s-a1", "s-root", node=survivor, attempt=1,
                 status=200)]
    if with_subtree:
        events += [ev("serve_request", "s-n0", "s-a1", node=survivor, status=200),
                   ev("serve_batch_queue", "s-n1", "s-n0"),
                   ev("serve_device_call", "s-n2", "s-n1")]
    return {"traceEvents": events, "gordoStitch": {"complete": with_subtree}}


PARAMS = {
    "availability": [{}, {"min": 1.0}, {"min": 0.95}, {"min": 0.95, "exclude": ["m-000"]},
                     {"phase": 1, "min": 1.0}],
    "zero_5xx": [{}, {"max": 1}, {"phase": 0}],
    "failover_under": [{"seconds": 0.5}, {"seconds": 0.01}, {"seconds": 5, "node": 1},
                       {"seconds": 5}],
    "p99_under": [{"ms": 1000}, {"ms": 0.001}, {"ms": 1000, "phase": 0}, {"ms": 1000, "phase": 7}],
    "breaker_scoped": [{"models": ["m-003", "m-004"]}, {"models": ["m-003"]}, {"models": []}],
    "histogram_exact": [{}],
    "one_rebuild_per_machine": [{}],
    "stitched_trace": [{}],
    "definitely_not_a_check": [{}],
}


@pytest.mark.parametrize("check", sorted(PARAMS))
def test_invariant_gives_the_jax_result(check):
    """Every checker on every named context, with each parameter set: the
    port's ``evaluate`` returns the JAX package's result dicts."""
    ours, theirs = _contexts("port"), _contexts("jax")
    verdicts = set()
    for name in ours:
        for params in PARAMS[check]:
            mine = inv.evaluate([scn.Invariant(check, params)], ours[name])
            other = jax_inv.evaluate([jax_scn.Invariant(check, params)], theirs[name])
            assert mine == other, (name, params)
            verdicts.add(mine[0]["ok"])
    assert verdicts == ({False} if check == "definitely_not_a_check" else {True, False})


# -------------------------------------------------------------------- load
@pytest.mark.parametrize("shape,kwargs", [
    ("flat", {}), ("flat", {"warmup": 1.0}),
    ("diurnal", {"amp": 0.5}), ("diurnal", {"period": 2.0, "amp": 2.0}),
    ("flash", {}), ("flash", {"peak": 6.0, "flash_at": 1.5, "flash_len": 0.5}),
], ids=["flat", "flat_warmup", "diurnal", "diurnal_period", "flash", "flash_placed"])
def test_schedule_and_keys_match_the_jax_harness(shape, kwargs):
    ours = load.build_schedule(shape, 40.0, 3.0, **kwargs)
    assert ours == jax_load.build_schedule(shape, 40.0, 3.0, **kwargs)
    keys = [f"m-{i:03d}" for i in range(24)]
    for seed, hot in ((0, 0.0), (3, 25.0), (7, 80.0)):
        mine = load.skewed_key_picker(keys, hot_pct=hot, seed=seed)
        other = jax_load.skewed_key_picker(keys, hot_pct=hot, seed=seed)
        assert [mine(i) for i in range(len(ours))] == [other(i) for i in range(len(ours))]
    with pytest.raises(ValueError):
        load.build_schedule("sawtooth", 1.0, 1.0)


def test_open_schedule_logs_the_jax_harness_arrivals():
    """The same schedule and keys through each package's open loop: the
    logged offsets, keys and errors agree, and the histograms hold the
    successes."""
    schedule = load.build_schedule("flash", 200.0, 0.2, peak=3.0)
    keys = [f"m-{i}" for i in range(5)]

    def send(key):
        return (None if key != "m-3" else "http-503"), None, {}

    runs = {}
    for name, mod in (("port", load), ("jax", jax_load)):
        stats, wall = mod.run_open_schedule(send, 4, schedule, keep_log=True,
                                            key_of=mod.skewed_key_picker(keys, 20.0, 1))
        log = sorted((e[0], e[3], e[2]) for s in stats for e in s.log)
        runs[name] = (log, sum(s.hist.count for s in stats))
        assert wall > 0
    assert runs["port"] == runs["jax"]
    assert runs["port"][1] == sum(1 for e in runs["port"][0] if e[2] is None) < len(schedule)


# -------------------------------------------------------- node, drift, lease
def _node_answers(mod, directory):
    chaos = mod.ChaosNode(directory, "node-x")
    thread = threading.Thread(target=chaos.serve_forever, daemon=True)
    thread.start()
    answers = []
    try:
        for method, path in (("GET", "/healthcheck"), ("GET", "/chaos/breakers"),
                             ("POST", "/gordo/v0/p/m-1/prediction"),
                             ("POST", "/gordo/v0/p/m-2/prediction"),
                             ("POST", "/gordo/v0/p/m-2/prediction"),
                             ("POST", "/gordo/v0/p/m-2/prediction"),
                             ("GET", "/debug/flight"), ("GET", "/nope"), ("GET", "/debug/slo"),
                             ("GET", "/chaos/breakers")):
            conn = http.client.HTTPConnection("127.0.0.1", chaos.port, timeout=10)
            try:
                conn.request(method, path)
                resp = conn.getresponse()
                doc = json.loads(resp.read())
                if "retry-after-seconds" in doc:  # the breaker's cooldown left, to the second
                    doc["retry-after-seconds"] = round(doc["retry-after-seconds"])
                answers.append((resp.status, resp.getheader("Retry-After"), doc))
            finally:
                conn.close()
    finally:
        chaos.close()
    return answers


def test_chaos_node_answers_as_the_jax_node(tmp_path, monkeypatch):
    """The stub node's routes, fault sites (a transient 503 with
    Retry-After, then a permanent 500 that opens m-2's breaker), breaker
    states and SLO document, beside the JAX node's."""
    monkeypatch.setenv("GORDO_TPU_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("GORDO_TPU_CHAOS_NODE_WORK_MS", "0")
    runs = {}
    for name, mod in (("port", node), ("jax", jax_node)):
        monkeypatch.setenv(faults.PLAN_ENV, json.dumps({"rules": [
            {"site": "serve_predict", "machine": "m-2", "times": 1, "error": "permanent"}]}))
        for module in (faults, jax_faults):
            module.reset_plan()
        for module in (resilience, jax_resilience):
            module.reset_for_tests()
        runs[name] = _node_answers(mod, str(tmp_path / name))
    assert runs["port"] == runs["jax"]
    statuses = [a[0] for a in runs["port"]]
    assert statuses == [200, 200, 200, 500, 503, 503, 404, 404, 200, 200]
    assert runs["port"][-1][2]["breakers"] == {"m-1": resilience.CLOSED, "m-2": resilience.OPEN}


def test_drift_burst_admits_one_request_a_machine(tmp_path):
    spec = scn.parse_scenario(_minimal_doc(drift={"machines": 5, "threads": 6, "at": 0.0}))
    jax_spec = jax_scn.parse_scenario(_minimal_doc(drift={"machines": 5, "threads": 6, "at": 0.0}))
    ours, theirs = {}, {}
    conductor._run_drift_burst(spec, str(tmp_path / "port"), 0.0, ours)
    jax_conductor._run_drift_burst(jax_spec, str(tmp_path / "jax"), 0.0, theirs)
    assert ours == theirs == {"machines": 5, "threads": 6, "enqueued": 5, "depth": 5}
    assert sorted(os.listdir(tmp_path / "port" / "drift-queue")) == sorted(
        os.listdir(tmp_path / "jax" / "drift-queue"))


@pytest.mark.parametrize("action", ["expire_lease", "corrupt_lease", "delete_lease"])
def test_lease_tampering_acts_as_the_jax_stacks(tmp_path, action):
    """Each lease action on the newest generation of a node's lease, by
    the port's stack and by the JAX stack on twin directories."""
    results = {}
    for name, mod in (("port", stack), ("jax", jax_stack)):
        directory = tmp_path / name
        (directory / "nodes").mkdir(parents=True)
        for lease in ("node-0.g1", "node-0.g2", "node-1.g1"):
            (directory / "nodes" / lease).write_text('{"address": "127.0.0.1:1"}')
        chaos = mod.ChaosStack(str(directory), 2)
        chaos.nodes = [SimpleNamespace(node_id="node-0"), SimpleNamespace(node_id="node-1")]
        getattr(chaos, action)(0)
        results[name] = {lease: ((directory / "nodes" / lease).read_text(),
                                 (directory / "nodes" / lease).stat().st_mtime < 1e9)
                         for lease in sorted(os.listdir(directory / "nodes"))}
    assert results["port"] == results["jax"]
    assert "node-0.g2" in results["port"] or action == "delete_lease"


# ----------------------------------------------------------------- drills
JAX_REPORT_KEYS = {"scenario", "description", "nodes", "machines", "scheduled", "succeeded",
                   "availability", "failover_s", "p99_ms", "errors", "actions", "chaff",
                   "drift", "stitched_trace", "invariants", "ok"}


def test_jax_tiny_drill_passes_under_the_port_conductor():
    """``tests/gordo_tpu/test_chaos_conductor.py``'s tiny drill, its numbers
    unchanged: 2 node subprocesses and the port's gateway, flat load, one
    node killed mid-window. Every invariant holds and the report has the
    JAX report's keys."""
    spec = scn.parse_scenario({
        "name": "tiny-drill",
        "seed": 1,
        "stack": {"nodes": 2, "lease_timeout_s": 1.5, "heartbeat_s": 0.15,
                  "gateway_env": {"health_s": "0.2", "connect_timeout_s": "0.5"}},
        "env": {"GORDO_TPU_DEBUG_ENDPOINTS": "1", "GORDO_TPU_FLIGHT_RECENT": "64"},
        "machines": 8,
        "load": {"phases": [{"shape": "flat", "qps": 25, "duration": 2.0, "users": 4}]},
        "timeline": [{"at": 0.8, "action": "kill_node", "node": 1}],
        "invariants": [
            {"check": "availability", "min": 0.9},
            {"check": "failover_under", "seconds": 2.0},
            {"check": "histogram_exact"},
            {"check": "stitched_trace"},
        ],
    })
    directory = tempfile.mkdtemp(prefix="gordo-chaos-test-")
    try:
        report = conductor.run_scenario(spec, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    assert set(report) == JAX_REPORT_KEYS
    assert report["ok"], report["invariants"]
    assert report["scheduled"] == 50 and report["availability"] >= 0.9
    assert [a["action"] for a in report["actions"]] == ["kill_node"]
    assert report["failover_s"] is not None and report["failover_s"] <= 2.0
    assert {r["check"]: r["ok"] for r in report["invariants"]} == {
        "availability": True, "failover_under": True, "histogram_exact": True,
        "stitched_trace": True}
    assert report["stitched_trace"]["trace_id"]
    assert report["stitched_trace"]["victim"] == "node-1"


def test_chaos_list_prints_the_jax_commands_lines(capsys):
    from click.testing import CliRunner
    from gordo_tpu.cli.cli import chaos_cli

    assert cli.main(["chaos", "list"]) == 0
    ours = capsys.readouterr().out.splitlines()
    theirs = CliRunner().invoke(chaos_cli, ["list", "--dir", JAX_DIR]).stdout.splitlines()
    assert [line.replace(".json:", ":", 1) for line in ours] == [
        line.replace(".yaml:", ":", 1) for line in theirs]
    assert len(ours) == 6


def test_chaos_run_command_reports_and_exits_on_the_verdict(tmp_path, capsys):
    """``chaos run`` on a one-node flat drill: exit 0, a PASS line an
    invariant and the summary line; an invariant that cannot hold exits 1;
    ``--out`` holds the report."""
    doc = {"name": "one-node", "stack": {"nodes": 1, "lease_timeout_s": 2.0,
                                         "heartbeat_s": 0.2},
           "machines": 3, "load": {"phases": [{"shape": "flat", "qps": 20, "duration": 0.5,
                                               "users": 2}]},
           "invariants": [{"check": "availability", "min": 1.0}, {"check": "histogram_exact"},
                          {"check": "one_rebuild_per_machine"}]}
    path = tmp_path / "one.json"
    path.write_text(json.dumps(doc))
    code = cli.main(["chaos", "run", str(path), "--dir", str(tmp_path / "w"),
                     "--out", str(tmp_path / "r.json")])
    lines = capsys.readouterr().out.splitlines()
    assert code == 1
    assert lines[:3] == [
        "[PASS] availability: availability 1.0000 (10/10) vs min 1.0",
        "[PASS] histogram_exact: scheduled 10 == logged 10; histogram 10 == successes 10",
        "[FAIL] one_rebuild_per_machine: scenario ran no drift burst"]
    assert lines[3].startswith("one-node: availability=1.0 p99=") and lines[3].endswith(
        "failover_s=None -> FAILED")
    report = json.loads((tmp_path / "r.json").read_text())
    assert set(report) == JAX_REPORT_KEYS and report["ok"] is False
    assert os.path.isdir(tmp_path / "w" / "nodes")
