"""
Chaos invariant checkers, the port's copy of
``gordo_tpu/chaos/invariants.py``: machine-checked assertions over what the
drill actually produced — the merged response log, the exact-merge
histograms, each node's breaker states and the drift queue — never over
what the scenario hoped would happen.

Each checker takes the run context assembled by the conductor and the
invariant's parameters, and returns ``(ok, detail)`` where ``detail`` is
a human-readable one-liner with the numbers that decided it.

The context (:class:`RunContext`) fields the checkers read:

- ``log`` — every measured request as ``(offset_s, latency_s, error,
  key, phase)``; error is None on 200, ``"http-<status>"`` otherwise,
  chaff connections are never in here (they are not requests);
- ``hist`` — the exactly-merged LatencyHistogram, plus ``per_phase``;
- ``scheduled`` — measured arrivals per phase (what SHOULD have been
  sent);
- ``primaries`` — machine -> ring-primary node id at stack-up;
- ``actions`` — fired timeline actions as dicts with ``at``/``fired_at``
  offsets, ``action``, ``node``/``node_id``;
- ``breakers`` — node_id -> {model: state int} (reachable nodes only);
- ``drift`` — the exactly-once enqueue burst result, when the scenario
  ran one;
- ``stitched`` — the cross-node trace capture, when the scenario declared
  the ``stitched_trace`` invariant: ``{"doc": <the gateway's stitched
  /debug/flight?trace= document>, "victim": <killed node id>,
  "trace_id": ..., "reason": <why capture fell short, when it did>}``.
"""

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..server import resilience


@dataclass
class RunContext:
    log: List[tuple] = field(default_factory=list)
    hist: object = None  # merged LatencyHistogram
    per_phase: Dict[int, object] = field(default_factory=dict)
    scheduled: Dict[int, int] = field(default_factory=dict)
    primaries: Dict[str, str] = field(default_factory=dict)
    actions: List[dict] = field(default_factory=list)
    breakers: Dict[str, Dict[str, int]] = field(default_factory=dict)
    drift: Optional[dict] = None
    stitched: Optional[dict] = None


Checker = Callable[[RunContext, dict], Tuple[bool, str]]
CHECKERS: Dict[str, Checker] = {}


def _checker(name: str):
    def register(fn: Checker) -> Checker:
        CHECKERS[name] = fn
        return fn

    return register


def _entries(ctx: RunContext, params: dict) -> List[tuple]:
    """The log filtered by the common params: ``phase`` (int) restricts
    to one load phase, ``exclude`` (list of machines) drops keys whose
    failures are the scenario's point (e.g. the poisoned model)."""
    entries = ctx.log
    phase = params.get("phase")
    if phase is not None:
        entries = [e for e in entries if e[4] == phase]
    exclude = set(params.get("exclude") or ())
    if exclude:
        entries = [e for e in entries if e[3] not in exclude]
    return entries


@_checker("availability")
def _availability(ctx: RunContext, params: dict) -> Tuple[bool, str]:
    """ok-ratio of measured, non-chaff requests >= ``min``."""
    entries = _entries(ctx, params)
    if not entries:
        return False, "no measured requests"
    ok = sum(1 for e in entries if e[2] is None)
    ratio = ok / len(entries)
    floor = float(params.get("min", 0.99))
    return ratio >= floor, (
        f"availability {ratio:.4f} ({ok}/{len(entries)}) vs min {floor}"
    )


@_checker("zero_5xx")
def _zero_5xx(ctx: RunContext, params: dict) -> Tuple[bool, str]:
    """At most ``max`` (default 0) 5xx answers; transport errors count —
    a dropped connection is worse than a 503."""
    entries = _entries(ctx, params)
    bad = [
        e for e in entries
        if e[2] is not None and (e[2].startswith("http-5") or not e[2].startswith("http-"))
    ]
    cap = int(params.get("max", 0))
    sample = ", ".join(sorted({e[2] for e in bad})[:3])
    return len(bad) <= cap, f"{len(bad)} 5xx/transport errors (cap {cap}) {sample}"


@_checker("failover_under")
def _failover_under(ctx: RunContext, params: dict) -> Tuple[bool, str]:
    """After the (first) kill/stop action on ``node``, a machine whose
    ring primary was that node gets a successful answer within
    ``seconds``."""
    bound = float(params.get("seconds", 5.0))
    want_node = params.get("node")
    hit = next(
        (a for a in ctx.actions
         if a["action"] in ("kill_node", "stop_node")
         and (want_node is None or a.get("node") == want_node)),
        None,
    )
    if hit is None:
        return False, "no kill/stop action fired to fail over from"
    killed_id = hit.get("node_id")
    t_kill = hit["fired_at"]
    victims = {m for m, p in ctx.primaries.items() if p == killed_id}
    if not victims:
        return False, f"no machines had {killed_id} as ring primary"
    recovered = [
        e[0] + e[1] for e in ctx.log
        if e[3] in victims and e[2] is None and e[0] + e[1] > t_kill
    ]
    if not recovered:
        return False, f"killed shard ({len(victims)} machines) never served again"
    first = min(recovered) - t_kill
    return first <= bound, (
        f"first post-kill success on {killed_id}'s shard after {first:.2f}s "
        f"(bound {bound}s)"
    )


@_checker("p99_under")
def _p99_under(ctx: RunContext, params: dict) -> Tuple[bool, str]:
    bound_ms = float(params.get("ms", 1000.0))
    phase = params.get("phase")
    hist = ctx.per_phase.get(phase) if phase is not None else ctx.hist
    if hist is None or hist.count == 0:
        return False, "no latency samples"
    p99 = (hist.quantile(0.99) or 0.0) * 1000.0
    where = f"phase {phase}" if phase is not None else "all phases"
    return p99 <= bound_ms, f"p99 {p99:.1f}ms vs bound {bound_ms}ms ({where})"


@_checker("breaker_scoped")
def _breaker_scoped(ctx: RunContext, params: dict) -> Tuple[bool, str]:
    """Every OPEN/HALF_OPEN breaker on every reachable node belongs to
    the declared poisoned set — the blast radius stayed scoped — and the
    poison actually tripped at least one breaker somewhere."""
    allowed = set(params.get("models") or ())
    tripped, leaked = set(), []
    for node_id, states in ctx.breakers.items():
        for model, state in states.items():
            if state != resilience.CLOSED:
                tripped.add(model)
                if model not in allowed:
                    leaked.append(f"{model}@{node_id}")
    if leaked:
        return False, f"breaker opened outside the poisoned set: {leaked[:4]}"
    if allowed and not tripped:
        return False, f"no breaker tripped for poisoned models {sorted(allowed)}"
    return True, f"open breakers {sorted(tripped) or '[]'} ⊆ {sorted(allowed)}"


@_checker("histogram_exact")
def _histogram_exact(ctx: RunContext, params: dict) -> Tuple[bool, str]:
    """Merged accounting is exact: every measured arrival is in the log,
    and the histogram holds every success (errors are in the log, not
    the latency histogram)."""
    sent = sum(ctx.scheduled.values())
    logged = len(ctx.log)
    ok = sum(1 for e in ctx.log if e[2] is None)
    hist_n = ctx.hist.count if ctx.hist is not None else 0
    exact = logged == sent and hist_n == ok
    return exact, (
        f"scheduled {sent} == logged {logged}; histogram {hist_n} == "
        f"successes {ok}"
    )


@_checker("one_rebuild_per_machine")
def _one_rebuild(ctx: RunContext, params: dict) -> Tuple[bool, str]:
    """The drift burst's O_EXCL exactly-once contract: with T threads all
    enqueueing every drifted machine, the queue holds exactly one ticket
    per machine and exactly one enqueue per machine reported success."""
    drift = ctx.drift
    if not drift:
        return False, "scenario ran no drift burst"
    machines = drift["machines"]
    depth = drift["depth"]
    wins = drift["enqueued"]
    ok = depth == machines and wins == machines
    return ok, (
        f"{machines} drifted machines -> queue depth {depth}, "
        f"{wins} winning enqueues (threads {drift['threads']})"
    )


@_checker("stitched_trace")
def _stitched_trace(ctx: RunContext, params: dict) -> Tuple[bool, str]:
    """The failover was *visible in one stitched trace*: the gateway's
    ``/debug/flight?trace=<id>`` document for a request traced across the
    kill must hold the gateway root, a failed upstream-attempt span on
    the victim, a successful hedge-arm attempt span on a survivor, and
    the survivor's own node-side subtree (``serve_request`` →
    ``serve_batch_queue`` → ``serve_device_call``) grafted under that
    hedge arm."""
    stitched = ctx.stitched
    if not stitched or not isinstance(stitched.get("doc"), dict):
        reason = (stitched or {}).get("reason", "no stitched trace captured")
        return False, str(reason)
    doc = stitched["doc"]
    victim = stitched.get("victim")
    spans = [(e.get("name"), e.get("args") or {})
             for e in doc.get("traceEvents") or []]
    if not any(n == "gateway_request" for n, _ in spans):
        return False, "stitched doc has no gateway_request root span"
    attempts = [a for n, a in spans if n == "gateway_upstream_attempt"]
    failed_on_victim = [a for a in attempts
                        if a.get("node") == victim and a.get("error")]
    hedge_ok = [a for a in attempts
                if a.get("node") != victim and a.get("status") == "200"]
    if not failed_on_victim:
        return False, (
            f"no failed attempt span on victim {victim} "
            f"({len(attempts)} attempt spans)"
        )
    if not hedge_ok:
        return False, "no successful hedge-arm attempt span on a survivor"
    hedge_ids = {a.get("span_id") for a in hedge_ok}
    roots = [a for n, a in spans
             if n == "serve_request" and a.get("parent_span_id") in hedge_ids]
    queue_ids = {a.get("span_id") for n, a in spans
                 if n == "serve_batch_queue"
                 and a.get("parent_span_id") in {r.get("span_id") for r in roots}}
    device = [a for n, a in spans
              if n == "serve_device_call"
              and a.get("parent_span_id") in queue_ids]
    if not roots:
        return False, (
            "survivor's serve_request subtree missing (stitch: "
            f"{doc.get('gordoStitch')})"
        )
    if not device:
        return False, "survivor subtree incomplete (no serve_device_call)"
    survivor = hedge_ok[0].get("node")
    return True, (
        f"one tree: victim {victim} attempt failed "
        f"({failed_on_victim[0].get('error', '')[:40]!r}), hedge arm on "
        f"{survivor} succeeded with full node subtree "
        f"({len(spans)} spans, complete="
        f"{(doc.get('gordoStitch') or {}).get('complete')})"
    )


def evaluate(invariants, ctx: RunContext) -> List[dict]:
    """Run every declared invariant; unknown checks fail loudly (the
    scenario linter should have caught them)."""
    results = []
    for inv in invariants:
        checker = CHECKERS.get(inv.check)
        if checker is None:
            results.append({"check": inv.check, "ok": False,
                            "detail": "unknown invariant"})
            continue
        try:
            ok, detail = checker(ctx, inv.params)
        except Exception as exc:  # noqa: BLE001 -- a crashed checker is a failure
            ok, detail = False, f"checker crashed: {exc!r}"
        results.append({"check": inv.check, "ok": bool(ok), "detail": detail,
                        **({"params": inv.params} if inv.params else {})})
    return results
