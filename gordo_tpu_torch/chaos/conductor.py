"""
Chaos conductor, the port's copy of ``gordo_tpu/chaos/conductor.py``: run
one scenario end to end and report.

Flow (one ``run_scenario`` call):

1. resolve the environment the drill runs under — membership knobs from
   the stack block, ``GORDO_TPU_GATEWAY_*`` knobs from its gateway
   block, scenario ``env`` verbatim, and the scenario's fault plan as
   ``GORDO_TPU_FAULT_PLAN`` — applied to this process (the in-process
   gateway reads them) and inherited by the node subprocesses; every
   touched variable is restored afterwards, so a drill leaves the
   process as it found it;
2. spin up the stack (chaos/stack.py) and snapshot each
   machine's ring primary;
3. drive the load phases back to back on one shared ``t0`` — shaped
   schedules from chaos/load.py with per-request logging on,
   chaff connections beside them — while the timeline thread fires the
   fault actions at their offsets and the optional drift burst races
   T threads of enqueues against the queue's O_EXCL exactly-once
   contract;
4. merge the accounting exactly (log-bucketed histograms add), collect
   each reachable node's breaker states, and evaluate the invariants;
5. return the report; ``ok`` is the AND of every invariant.

Determinism: the schedule, the key pattern (skewed_key_picker), and the
in-process fault rules all derive from the scenario (seed included) —
two runs of the same file fire the same faults at the same arrivals.
Wall-clock effects (exact failover seconds) vary; the invariants bound
them instead of pinning them.
"""

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from ..observability import metrics as metric_catalog
from ..observability.latency import LatencyHistogram
from ..server import membership
from ..util import faults
from . import load as load_test
from .invariants import CHECKERS, RunContext, evaluate
from .scenario import Scenario
from .stack import ChaosStack

logger = logging.getLogger(__name__)


def _resolved_env(spec: Scenario, directory: str) -> Dict[str, str]:
    env = {
        membership.GATEWAY_DIR_ENV: directory,
        membership.LEASE_TIMEOUT_ENV: str(spec.lease_timeout_s),
        membership.HEARTBEAT_ENV: str(spec.heartbeat_s),
    }
    for key, value in spec.gateway_env.items():
        env[f"GORDO_TPU_GATEWAY_{key.upper()}"] = value
    env.update(spec.env)
    if spec.fault_plan is not None:
        env[faults.PLAN_ENV] = json.dumps(spec.fault_plan)
    return env


class _EnvScope:
    """Apply a dict to os.environ, restore every touched key on exit."""

    def __init__(self, env: Dict[str, str]):
        self.env = env
        self._saved: Dict[str, Optional[str]] = {}

    def __enter__(self):
        for key, value in self.env.items():
            self._saved[key] = os.environ.get(key)
            os.environ[key] = value
        faults.reset_plan()
        return self

    def __exit__(self, *exc_info):
        for key, old in self._saved.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old
        faults.reset_plan()


def _gateway_send(port: int):
    """send(machine) for the load loop: one GET through the gateway,
    returning load_test's (error, trace_id, phases) contract with the
    status encoded as ``http-<code>`` on non-2xx."""
    import http.client

    def send(machine: str):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            conn.request("GET", f"/gordo/v0/chaos/{machine}/prediction")
            resp = conn.getresponse()
            resp.read()
            if 200 <= resp.status < 300:
                return None, resp.headers.get("X-Gordo-Trace"), {}
            return f"http-{resp.status}", None, {}
        except OSError as exc:
            return repr(exc)[:80], None, {}
        finally:
            conn.close()

    return send


def _kill_of(fired: List[dict]) -> Optional[dict]:
    """The first kill or stop action that fired, or None."""
    return next((a for a in fired if a["action"] in ("kill_node", "stop_node")
                 and "node_id" in a), None)


def _run_timeline(spec: Scenario, stack: ChaosStack, t0: float,
                  fired: List[dict], stop: threading.Event) -> None:
    for action in spec.timeline:
        while True:
            delay = (t0 + action.at) - time.monotonic()
            if delay <= 0:
                break
            if stop.wait(min(delay, 0.1)):
                return
        record = {"action": action.action, "at": action.at, "node": action.node}
        try:
            if action.action == "set_fault_plan":
                os.environ[faults.PLAN_ENV] = json.dumps(action.plan)
                faults.reset_plan()
            elif action.action == "drop_gateway_conns":
                stack.drop_gateway_conns()
            else:
                record["node_id"] = stack.nodes[action.node].node_id
                getattr(stack, action.action)(action.node)
        except Exception as exc:  # noqa: BLE001 -- a failed action is reported, not fatal
            record["error"] = repr(exc)[:160]
            logger.exception("chaos action %s failed", action.action)
        record["fired_at"] = time.monotonic() - t0
        metric_catalog.CHAOS_ACTIONS.labels(action=action.action).inc()
        logger.info("chaos: fired %s (node=%s) at +%.2fs",
                    action.action, action.node, record["fired_at"])
        fired.append(record)


def _run_drift_burst(spec: Scenario, directory: str, t0: float,
                     result: dict) -> None:
    """T threads all enqueue a rebuild for every drifted machine at once:
    the queue's O_EXCL ticket files must admit exactly one per machine."""
    from ..parallel import drift_queue

    drift = spec.drift or {}
    machines = [f"drifted-{i:02d}" for i in range(int(drift.get("machines", 4)))]
    threads_n = int(drift.get("threads", 8))
    queue_dir = os.path.join(directory, "drift-queue")
    delay = (t0 + float(drift.get("at", 0.0))) - time.monotonic()
    if delay > 0:
        time.sleep(delay)
    wins = [0] * threads_n

    def enqueuer(slot: int):
        for machine in machines:
            if drift_queue.enqueue(queue_dir, machine,
                                   {"reason": "chaos-drill"}):
                wins[slot] += 1

    workers = [threading.Thread(target=enqueuer, args=(i,), daemon=True)
               for i in range(threads_n)]
    for t in workers:
        t.start()
    for t in workers:
        t.join()
    result.update({
        "machines": len(machines),
        "threads": threads_n,
        "enqueued": sum(wins),
        "depth": drift_queue.depth(queue_dir),
    })


def _capture_stitched_trace(stack: ChaosStack, primaries: Dict[str, str],
                            fired: List[dict], stop: threading.Event,
                            out: dict, planned: Optional[tuple] = None) -> None:
    """Keep one traced probe in flight around the kill: the moment a
    kill/stop action fires, a probe against a victim-primary machine
    rides the gateway's hedge, and its stitched
    ``/debug/flight?trace=<id>`` document is the drill's failover
    evidence. Probes run continuously (the kill must land close to
    mid-request for the failed-attempt span to be real — once the
    gateway marks the victim dead it stops trying it), each under a
    fresh trace id, until a capture satisfies the ``stitched_trace``
    checker or the drill ends.

    The gateway stops trying the victim once its node breaker opens (after
    a few failed attempts of the load) or its lease goes stale, so the
    probes must meet the kill: ``planned`` (the victim's node id and the
    kill's time on the monotonic clock, from the timeline) aims them at the
    victim's machines and sends them back to back from 0.25 s before the
    kill, so one is in flight when it lands (its upstream attempts were
    chosen at its start: the victim, then the hedge), and a probe in flight
    across the kill is read as evidence."""
    from ..observability import tracing

    machines = sorted(primaries)
    grace_until = None
    attempt = 0
    while True:
        kill = _kill_of(fired)
        victim = kill["node_id"] if kill is not None else None
        aim = victim if victim is not None else (planned[0] if planned else None)
        targets = ([m for m in machines if primaries[m] == aim]
                   if aim is not None else machines)
        if victim is not None and not targets:
            out["reason"] = f"no machine had {victim} as ring primary"
            return
        machine = targets[attempt % len(targets)]
        attempt += 1
        trace_id = tracing.new_trace_id()
        traceparent = f"00-{trace_id}-{tracing.new_span_id()}-01"
        status, headers, _body = stack.request(
            "GET", f"/gordo/v0/chaos/{machine}/prediction",
            timeout=10.0, headers={"traceparent": traceparent},
        )
        if (victim is None and planned is not None and primaries[machine] == planned[0]
                and headers.get("x-gordo-gateway-node") not in (None, planned[0])):
            # answered off the planned victim: its kill landed while this
            # probe was in flight (the timeline records it once the process
            # is reaped)
            victim = planned[0]
        if victim is not None and 200 <= status < 300:
            s2, _h2, raw = stack.request(
                "GET", f"/debug/flight?trace={trace_id}"
            )
            doc = None
            if s2 == 200:
                try:
                    doc = json.loads(raw)
                except ValueError:
                    doc = None
            if isinstance(doc, dict):
                candidate = {"doc": doc, "victim": victim,
                             "trace_id": trace_id}
                ok, detail = CHECKERS["stitched_trace"](
                    RunContext(stitched=candidate), {}
                )
                if ok:
                    out.pop("reason", None)
                    out.update(candidate)
                    return
                # keep the best-failing evidence for the invariant report
                out.update(candidate)
                out["reason"] = detail
        if stop.is_set():
            if kill is None:
                out.setdefault("reason", "no kill/stop action fired")
                return
            # short grace window: the load can end moments after the kill
            if grace_until is None:
                grace_until = time.monotonic() + 3.0
            elif time.monotonic() > grace_until:
                out.setdefault(
                    "reason", "no qualifying capture before drill end"
                )
                return
        if kill is None and planned is not None and planned[1] - time.monotonic() < 0.25:
            continue  # back to back across the kill
        stop.wait(0.04)


def run_scenario(spec: Scenario, directory: str,
                 stack_timeout: float = 30.0) -> dict:
    """Run one parsed scenario under ``directory`` (membership dir, drift
    queue, scratch). Returns the report dict; ``report["ok"]`` is the
    verdict."""
    os.makedirs(directory, exist_ok=True)
    env = _resolved_env(spec, directory)
    report: dict = {"scenario": spec.name, "description": spec.description,
                    "nodes": spec.nodes, "machines": len(spec.machines)}
    with _EnvScope(env):
        with ChaosStack(directory, spec.nodes, child_env=env) as stack:
            stack.start(timeout=stack_timeout)
            primaries = {
                m: stack.gateway.ring.candidates(m)[0] for m in spec.machines
            }
            send = _gateway_send(stack.gateway_port)

            # schedules first: global offsets, phases back to back
            schedules, start = [], 0.0
            for phase in spec.phases:
                offsets = load_test.build_schedule(
                    phase.shape, phase.qps, phase.duration,
                    warmup=phase.warmup, peak=phase.peak,
                    flash_at=phase.flash_at, flash_len=phase.flash_len,
                    period=phase.period, amp=phase.amp,
                )
                schedules.append([start + o for o in offsets])
                start += phase.warmup + phase.duration
            horizon = start

            t0 = time.monotonic() + 0.25
            stop = threading.Event()
            fired: List[dict] = []
            timeline_thread = threading.Thread(
                target=_run_timeline, args=(spec, stack, t0, fired, stop),
                daemon=True,
            )
            timeline_thread.start()

            stitched: dict = {}
            stitch_thread = None
            if any(inv.check == "stitched_trace" for inv in spec.invariants):
                planned = next(((stack.nodes[a.node].node_id, t0 + a.at)
                                for a in spec.timeline
                                if a.action in ("kill_node", "stop_node")), None)
                stitch_thread = threading.Thread(
                    target=_capture_stitched_trace,
                    args=(stack, primaries, fired, stop, stitched, planned),
                    daemon=True,
                )
                stitch_thread.start()

            chaff_results: List[dict] = []
            chaff_threads = []
            for chaff in spec.chaff:
                def chaff_worker(spec_c=chaff):
                    chaff_results.append(load_test.run_chaff(
                        "127.0.0.1", stack.gateway_port, spec_c["kind"],
                        int(spec_c.get("conns", 2)),
                        float(spec_c.get("duration", horizon)), stop=stop,
                    ))
                t = threading.Thread(target=chaff_worker, daemon=True)
                t.start()
                chaff_threads.append(t)

            drift_result: dict = {}
            drift_thread = None
            if spec.drift is not None:
                drift_thread = threading.Thread(
                    target=_run_drift_burst,
                    args=(spec, directory, t0, drift_result), daemon=True,
                )
                drift_thread.start()

            # the measured load, phase by phase on the one shared t0
            log: List[tuple] = []
            scheduled: Dict[int, int] = {}
            all_stats, per_phase = [], {}
            for idx, (phase, schedule) in enumerate(zip(spec.phases, schedules)):
                key_of = load_test.skewed_key_picker(
                    spec.machines, hot_pct=phase.hot_pct, seed=spec.seed,
                )
                stats_list, _wall = load_test.run_open_schedule(
                    send, phase.users, schedule, keep_log=True,
                    key_of=key_of, t0=t0,
                )
                scheduled[idx] = len(schedule)
                per_phase[idx] = LatencyHistogram.merged(
                    s.hist for s in stats_list
                )
                all_stats.extend(stats_list)
                for stats in stats_list:
                    log.extend(e + (idx,) for e in stats.log)

            stop.set()
            timeline_thread.join(timeout=10.0)
            for t in chaff_threads:
                t.join(timeout=10.0)
            if drift_thread is not None:
                drift_thread.join(timeout=30.0)
            if stitch_thread is not None:
                stitch_thread.join(timeout=15.0)

            breakers = {}
            for i in range(spec.nodes):
                states = stack.node_breakers(i)
                if states is not None:
                    breakers[stack.nodes[i].node_id] = states

            merged = LatencyHistogram.merged(s.hist for s in all_stats)
            ctx = RunContext(
                log=sorted(log, key=lambda e: e[0]),
                hist=merged,
                per_phase=per_phase,
                scheduled=scheduled,
                primaries=primaries,
                actions=fired,
                breakers=breakers,
                drift=drift_result or None,
                stitched=stitched or None,
            )
            results = evaluate(spec.invariants, ctx)

    # ---------------------------------------------------------- reporting
    total = sum(scheduled.values())
    ok_n = sum(1 for e in log if e[2] is None)
    availability = ok_n / total if total else 0.0
    metric_catalog.CHAOS_AVAILABILITY.set(availability)
    failover_s = None
    for res in results:
        if not res["ok"]:
            metric_catalog.CHAOS_INVARIANT_FAILURES.labels(
                invariant=res["check"]
            ).inc()
    kill = _kill_of(fired)
    if kill is not None:
        victims = {m for m, p in primaries.items() if p == kill["node_id"]}
        recovered = [e[0] + e[1] for e in log
                     if e[3] in victims and e[2] is None
                     and e[0] + e[1] > kill["fired_at"]]
        if recovered:
            failover_s = min(recovered) - kill["fired_at"]
            metric_catalog.CHAOS_FAILOVER_SECONDS.set(failover_s)

    error_counts: Dict[str, int] = {}
    for e in log:
        if e[2] is not None:
            error_counts[e[2]] = error_counts.get(e[2], 0) + 1
    report.update({
        "scheduled": total,
        "succeeded": ok_n,
        "availability": round(availability, 5),
        "failover_s": round(failover_s, 3) if failover_s is not None else None,
        "p99_ms": round((merged.quantile(0.99) or 0.0) * 1000.0, 2)
        if merged.count else None,
        "errors": dict(sorted(error_counts.items())),
        "actions": fired,
        "chaff": chaff_results,
        "drift": drift_result or None,
        "stitched_trace": (
            {k: stitched.get(k) for k in ("trace_id", "victim", "reason")
             if stitched.get(k) is not None}
            or None
        ) if stitched else None,
        "invariants": results,
        "ok": all(r["ok"] for r in results),
    })
    return report
