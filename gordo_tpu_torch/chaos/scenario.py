"""
Chaos scenario schema, vocabulary and parser: the port's copy of
``gordo_tpu/chaos/scenario.py``, with the same schema, vocabulary and
errors.

A scenario is one document describing a drill: the stack (N serving
nodes and one gateway, with its membership and gateway knobs), extra
environment for both, a fault plan (util/faults.py rules), the machines,
the load phases (chaos/load.py schedules) and chaff, an optional drift
burst, a timeline of fault actions, and the invariants to check. The
committed drills are ``gordo_tpu_torch/chaos/scenarios/*.json``, each the
JSON of the JAX package's YAML file of the same name
(``resources/chaos/``). :func:`load_scenario` reads either, as the JAX one
does: ``.json`` as JSON, anything else as YAML (util/yaml_subset.py).

The vocabulary lives here (``ACTIONS``, ``INVARIANTS``, ``CHAFF_KINDS``),
with ``faults.KNOWN_SITES`` and ``load.SCHEDULE_SHAPES``.
"""

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..util import faults, yaml_subset
from .load import SCHEDULE_SHAPES

# the committed drills, JSON copies of the JAX package's YAML files
SCENARIO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenarios")

# every timeline action the conductor knows how to fire
ACTIONS = (
    "kill_node",      # SIGKILL the node subprocess (lease goes stale)
    "stop_node",      # SIGSTOP: wedged-alive — lease freezes, socket accepts
    "cont_node",      # SIGCONT a stopped node
    "expire_lease",   # backdate the lease mtime past the timeout
    "corrupt_lease",  # overwrite the lease file with garbage bytes
    "delete_lease",   # unlink the lease file out from under the node
    "drop_gateway_conns",  # drop the gateway's pooled upstream connections
    "set_fault_plan",  # re-arm GORDO_TPU_FAULT_PLAN for in-process sites
)

# every invariant checker (chaos/invariants.py's registry keys)
INVARIANTS = (
    "availability",            # ok-ratio of measured non-chaff requests
    "zero_5xx",                # no (or at most `max`) 5xx answers
    "failover_under",          # killed shard served again within bound
    "p99_under",               # merged p99 below a bound (optionally per phase)
    "breaker_scoped",          # open breakers ⊆ the poisoned model set
    "histogram_exact",         # merged histogram count == measured sends
    "one_rebuild_per_machine",  # drift queue depth == drifted machines
    "stitched_trace",          # failover visible in one stitched trace
)

CHAFF_KINDS = ("slow_loris", "scanner")


class ScenarioError(ValueError):
    """A scenario file that cannot be run (parse or vocabulary error)."""


@dataclass
class Phase:
    shape: str = "flat"
    qps: float = 20.0
    duration: float = 5.0
    warmup: float = 0.0
    users: int = 8
    hot_pct: float = 0.0
    peak: float = 4.0
    flash_at: Optional[float] = None
    flash_len: float = 1.0
    period: Optional[float] = None
    amp: float = 0.5


@dataclass
class Action:
    at: float
    action: str
    node: Optional[int] = None
    plan: Optional[dict] = None  # set_fault_plan only


@dataclass
class Invariant:
    check: str
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Scenario:
    name: str
    description: str = ""
    seed: int = 0
    nodes: int = 3
    lease_timeout_s: float = 2.5
    heartbeat_s: float = 0.2
    gateway_env: Dict[str, str] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    fault_plan: Optional[dict] = None
    machines: List[str] = field(default_factory=list)
    phases: List[Phase] = field(default_factory=list)
    chaff: List[dict] = field(default_factory=list)
    drift: Optional[dict] = None
    timeline: List[Action] = field(default_factory=list)
    invariants: List[Invariant] = field(default_factory=list)
    path: Optional[str] = None


def _machines(raw) -> List[str]:
    if isinstance(raw, int):
        return [f"m-{i:03d}" for i in range(raw)]
    if isinstance(raw, list) and all(isinstance(m, str) for m in raw):
        return list(raw)
    raise ScenarioError(f"machines must be an int or a list of names, got {raw!r}")


def parse_scenario(doc: dict, path: Optional[str] = None) -> Scenario:
    """Validate one scenario document against the vocabulary; raises
    :class:`ScenarioError` with the first problem found."""
    if not isinstance(doc, dict):
        raise ScenarioError("scenario must be a mapping")
    name = doc.get("name")
    if not name or not isinstance(name, str):
        raise ScenarioError("scenario needs a string 'name'")

    stack = doc.get("stack") or {}
    nodes = int(stack.get("nodes", 3))
    if nodes < 1:
        raise ScenarioError("stack.nodes must be >= 1")

    phases = []
    load = doc.get("load") or {}
    for i, raw in enumerate(load.get("phases") or [{}]):
        try:
            phase = Phase(**{k: v for k, v in raw.items()})
        except TypeError as exc:
            raise ScenarioError(f"load.phases[{i}]: {exc}") from None
        if phase.shape not in SCHEDULE_SHAPES:
            raise ScenarioError(
                f"load.phases[{i}].shape {phase.shape!r} not in {SCHEDULE_SHAPES}"
            )
        if phase.qps <= 0 or phase.duration <= 0:
            raise ScenarioError(f"load.phases[{i}] needs qps > 0 and duration > 0")
        phases.append(phase)

    chaff = list(load.get("chaff") or [])
    for i, spec in enumerate(chaff):
        if spec.get("kind") not in CHAFF_KINDS:
            raise ScenarioError(
                f"load.chaff[{i}].kind {spec.get('kind')!r} not in {CHAFF_KINDS}"
            )

    timeline = []
    last_at = -1.0
    for i, raw in enumerate(doc.get("timeline") or []):
        action = Action(
            at=float(raw.get("at", -1)),
            action=raw.get("action", ""),
            node=raw.get("node"),
            plan=raw.get("plan"),
        )
        if action.action not in ACTIONS:
            raise ScenarioError(
                f"timeline[{i}].action {action.action!r} not in {ACTIONS}"
            )
        if action.at < last_at:
            raise ScenarioError(f"timeline[{i}].at={action.at} not monotonic")
        last_at = action.at
        if action.action == "set_fault_plan":
            if not isinstance(action.plan, dict):
                raise ScenarioError(f"timeline[{i}] set_fault_plan needs a 'plan'")
        elif action.action != "drop_gateway_conns":
            if not isinstance(action.node, int) or not 0 <= action.node < nodes:
                raise ScenarioError(
                    f"timeline[{i}].node must be 0..{nodes - 1}, got {action.node!r}"
                )
        timeline.append(action)

    plan = doc.get("fault_plan")
    if plan is not None:
        if not isinstance(plan, dict) or not isinstance(plan.get("rules"), list):
            raise ScenarioError("fault_plan must be {rules: [...]}")
        for i, rule in enumerate(plan["rules"]):
            site = rule.get("site")
            if site not in faults.KNOWN_SITES:
                raise ScenarioError(
                    f"fault_plan.rules[{i}].site {site!r} not a known fault site"
                )

    invariants = []
    for i, raw in enumerate(doc.get("invariants") or []):
        check = raw.get("check", "")
        if check not in INVARIANTS:
            raise ScenarioError(
                f"invariants[{i}].check {check!r} not in {INVARIANTS}"
            )
        invariants.append(
            Invariant(check, {k: v for k, v in raw.items() if k != "check"})
        )

    env = {str(k): str(v) for k, v in (doc.get("env") or {}).items()}
    gateway_env = {
        str(k): str(v) for k, v in (stack.get("gateway") or {}).items()
    }

    return Scenario(
        name=name,
        description=str(doc.get("description") or ""),
        seed=int(doc.get("seed", 0)),
        nodes=nodes,
        lease_timeout_s=float(stack.get("lease_timeout_s", 2.5)),
        heartbeat_s=float(stack.get("heartbeat_s", 0.2)),
        gateway_env=gateway_env,
        env=env,
        fault_plan=plan,
        machines=_machines(doc.get("machines", 16)),
        phases=phases,
        chaff=chaff,
        drift=doc.get("drift"),
        timeline=timeline,
        invariants=invariants,
        path=path,
    )


def load_scenario(path: str) -> Scenario:
    """Parse a scenario file: ``.json`` as JSON, anything else as YAML (the
    superset, so a JSON file loads either way)."""
    with open(path) as fh:
        raw = fh.read()
    if os.path.splitext(path)[1].lower() == ".json":
        try:
            doc = json.loads(raw)
        except ValueError as exc:
            raise ScenarioError(f"{path}: not JSON ({exc})") from None
    else:
        doc = yaml_subset.load(raw)
    return parse_scenario(doc, path=path)
