"""
The fault vocabulary: classification, retry and backoff, quarantine
records, and a deterministic fault-injection harness. The port's copy of
``gordo_tpu/util/faults.py``, by the same names, so that one fault plan
fires at the same sites and calls in either package.

- ``TransientFault``, ``PermanentFault``, ``InjectedOOM``,
  ``NonFiniteDataError`` and ``DivergedModelError``, classified by
  :func:`is_transient` (retrying may clear it) and :func:`is_oom` (a device
  allocation failure: the runtime's ``RESOURCE_EXHAUSTED``, an injected OOM,
  or ``torch.OutOfMemoryError`` on the card).
- ``FaultPolicy`` and :func:`retry_call`: bounded retries with exponential
  backoff and deterministic jitter, around the serial builder's and the
  fleet trainer's fetches and the fleet trainer's chunks.
- ``QuarantineRecord``: a machine dropped from a fleet build, with the host
  and process rank that observed the fault (the rank is the multi-host
  flag ``GORDO_TPU_PROCESS_ID``, else ``torch.distributed``'s rank when a
  process group is initialised, else 0).
- ``FaultPlan`` on ``GORDO_TPU_FAULT_PLAN`` (JSON, or ``@path`` for a file)
  with :func:`fault_point`, :func:`should_fire` and :func:`maybe_poison`.

Plan schema::

    {"rules": [
      {"site": "serve_predict",     "machine": "m-1", "times": 1,
       "error": "wedge", "seconds": 2},
      {"site": "serve_model_load",  "machine": "m-2", "error": "permanent"},
      {"site": "serve_poison_nan",  "machine": "m-3"},
      {"site": "serve_device_call", "machine": "m-4", "after": 2}
    ]}

``times``: how many matching invocations fire the rule (-1 = every one;
the data-altering sites ``poison_nan``, ``serve_poison_nan`` and
``diverge`` default to -1, the others to 1). ``after``: how many matching
invocations pass before the rule starts firing. ``error``: ``transient`` |
``permanent`` | ``resource_exhausted`` | ``wedge`` (sleep ``seconds`` at the
fault point instead of raising) | ``die`` (``os._exit`` at the fault
point). Rules are matched in order and count their own firings, so a plan
is a deterministic script.

The serving sites wired in the port (server/resilience.py):
``serve_model_load`` in the server's model load (machine = model name),
``serve_predict`` in the prediction cores before the predict (supports
``wedge``), ``serve_poison_nan`` on the base route's feature matrix, and
``serve_device_call`` at the top of every fused device call of the
cross-model batcher and of its serial rescue (machine matched against the
group's members; supports ``wedge``). The drift loop's sites:
``drift_detect`` in the drift detector's event emission
(observability/drift.py), ``drift_enqueue`` in the queue's enqueue
(parallel/drift_queue.py) and ``swap_commit`` at the start of each hot swap
(server/hotswap.py), each with the machine's name. The gateway tier's:
``gateway_route`` at the top of the gateway's routing (machine = the
placement key) and ``node_partition`` before each upstream attempt
(machine = node id) in server/gateway.py, ``node_dead`` and
``lease_refresh`` in the membership heartbeat (server/membership.py).
The build sites: ``data_fetch`` and ``poison_nan`` in the serial
builder's and the fleet trainer's fetch (builder/build_model.py,
parallel/batch_trainer.py), ``bucket_compile`` before each of the fleet's
stacked programs (machines = the chunk's) and ``diverge`` in the fleet's
check of each trained machine. ``KNOWN_SITES`` is the JAX package's whole
vocabulary; ``scheduler_lease`` belongs to the elastic scheduler, which the
port does not have yet (ROADMAP.md item A7), and ``aot_program_load`` to the
loading of shipped XLA programs, which the port will not have: it compiles
no program, so it ships and loads none (serializer/serializer.py), and a
rule at that site never fires.
"""

import json
import logging
import os
import sys
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

PLAN_ENV = "GORDO_TPU_FAULT_PLAN"

# the fleet build's exit codes (cli.py batch-build)
EXIT_ALL_BUILT = 0
EXIT_PARTIAL = 81
EXIT_NONE_BUILT = 82

# the JAX package's whole fault-plan vocabulary (append-only: a site name
# in a committed scenario file is a public contract)
KNOWN_SITES = (
    # build plane
    "data_fetch", "poison_nan", "diverge", "bucket_compile",
    "scheduler_lease",
    # serve plane
    "serve_model_load", "serve_predict", "serve_device_call",
    "serve_poison_nan", "serve_encode",
    # gateway / membership plane
    "gateway_route", "node_partition", "node_dead", "lease_refresh",
    # drift loop
    "drift_detect", "drift_enqueue", "swap_commit",
    # build-to-serve artifacts
    "aot_program_load",
)

# quarantine stages (where in the build the machine was dropped)
STAGE_DATA_FETCH = "data_fetch"
STAGE_DATA_VALIDATION = "data_validation"
STAGE_TRAINING = "training"
STAGE_SERIAL_BUILD = "serial_build"
STAGE_CACHE = "cache"


# --------------------------------------------------------------- exceptions
class TransientFault(RuntimeError):
    """An injected (or wrapped) fault that retrying may clear."""


class PermanentFault(RuntimeError):
    """An injected (or wrapped) fault no retry will clear."""


class InjectedOOM(RuntimeError):
    """An injected device allocation failure; message mirrors the runtime's
    RESOURCE_EXHAUSTED so :func:`is_oom` has one code path for both."""


class NonFiniteDataError(ValueError):
    """Pre-flight validation found NaN/Inf in a machine's training data."""


class DivergedModelError(ValueError):
    """Post-build validation found non-finite params/losses (training
    diverged); only raised in fail-fast mode — the fleet path quarantines."""


_TRANSIENT_TYPE_NAMES = {
    # network/provider hiccups by type name, so requests/urllib3 types are
    # recognized without importing them here
    "ConnectionError",
    "ConnectTimeout",
    "ReadTimeout",
    "Timeout",
    "ProtocolError",
    "TemporaryFailure",
}


def is_transient(exc: BaseException) -> bool:
    """Whether retrying has a chance of clearing this exception."""
    if isinstance(exc, (PermanentFault, NonFiniteDataError, DivergedModelError)):
        return False
    if isinstance(exc, (TransientFault, TimeoutError, ConnectionError)):
        return True
    if isinstance(exc, OSError):
        return True
    return any(
        t.__name__ in _TRANSIENT_TYPE_NAMES for t in type(exc).__mro__
    )


_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "OUT OF MEMORY", "OOM")


def is_oom(exc: BaseException) -> bool:
    """Whether the exception is a device allocation failure (the signal for
    bucket bisection: half the machine axis, half the live buffers)."""
    if isinstance(exc, InjectedOOM):
        return True
    torch_oom = getattr(sys.modules.get("torch"), "OutOfMemoryError", None)
    if torch_oom is not None and isinstance(exc, torch_oom):
        return True
    if type(exc).__name__ == "XlaRuntimeError" and "RESOURCE_EXHAUSTED" in str(exc):
        return True
    text = str(exc).upper()
    return isinstance(exc, MemoryError) or any(m in text for m in _OOM_MARKERS)


# -------------------------------------------------------------------- policy
@dataclass
class FaultPolicy:
    """Retry/backoff policy for fleet-build fault handling.

    ``backoff(attempt, key)`` is exponential with *deterministic* jitter:
    the jitter fraction is a hash of ``(key, attempt)``, so a rebuilt fleet
    replays the same schedule — reproducibility is a feature of the fault
    path too, not just the happy path.

    >>> p = FaultPolicy(max_attempts=4, backoff_base=0.5, jitter=0.0)
    >>> [round(p.backoff(a, "m"), 2) for a in (1, 2, 3)]
    [0.5, 1.0, 2.0]
    """

    max_attempts: int = 3
    backoff_base: float = 0.5
    backoff_factor: float = 2.0
    backoff_max: float = 30.0
    jitter: float = 0.1

    @classmethod
    def from_env(cls) -> "FaultPolicy":
        """Build a policy from ``GORDO_TPU_FAULT_*`` environment variables
        (``MAX_ATTEMPTS``, ``BACKOFF_BASE``, ``BACKOFF_FACTOR``,
        ``BACKOFF_MAX``, ``JITTER``); unset vars keep the defaults."""
        def _get(name, cast, default):
            raw = os.environ.get(f"GORDO_TPU_FAULT_{name}")
            if raw is None:
                return default
            try:
                return cast(raw)
            except ValueError:
                logger.warning(
                    "Invalid GORDO_TPU_FAULT_%s=%r; using %r", name, raw, default
                )
                return default

        return cls(
            max_attempts=max(1, _get("MAX_ATTEMPTS", int, cls.max_attempts)),
            backoff_base=_get("BACKOFF_BASE", float, cls.backoff_base),
            backoff_factor=_get("BACKOFF_FACTOR", float, cls.backoff_factor),
            backoff_max=_get("BACKOFF_MAX", float, cls.backoff_max),
            jitter=_get("JITTER", float, cls.jitter),
        )

    def classify(self, exc: BaseException) -> str:
        """``"transient"`` (retry may help) or ``"permanent"``."""
        return "transient" if is_transient(exc) else "permanent"

    def backoff(self, attempt: int, key: str = "") -> float:
        """Seconds to wait after the ``attempt``-th failure (1-based)."""
        delay = min(
            self.backoff_base * self.backoff_factor ** (attempt - 1),
            self.backoff_max,
        )
        if self.jitter:
            frac = (zlib.crc32(f"{key}:{attempt}".encode()) % 1000) / 1000.0
            delay *= 1.0 + self.jitter * frac
        return delay


def record_retry(operation: str) -> None:
    """Count one absorbed transient retry in the telemetry registry
    (observability/metrics.py). Guarded: the fault path must survive even
    a broken observability layer."""
    try:
        from ..observability import metrics as metric_catalog

        metric_catalog.FAULT_RETRIES.labels(operation=operation).inc()
    except Exception:  # noqa: BLE001 — metrics must never mask the fault
        logger.debug("could not record retry metric", exc_info=True)


def record_quarantine(stage: str) -> None:
    """Count one quarantined machine by stage (same guard rationale)."""
    try:
        from ..observability import metrics as metric_catalog

        metric_catalog.QUARANTINES.labels(stage=stage).inc()
        metric_catalog.BUILD_MACHINES.labels(outcome="quarantined").inc()
    except Exception:  # noqa: BLE001 — metrics must never mask the fault
        logger.debug("could not record quarantine metric", exc_info=True)


def retry_call(
    fn,
    policy: FaultPolicy,
    key: str = "",
    describe: str = "operation",
    sleep=time.sleep,
) -> Tuple[Any, int]:
    """Run ``fn()`` under the policy. Returns ``(result, attempts)``;
    re-raises the last exception once a permanent fault is seen or the
    attempt budget is exhausted."""
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn(), attempt
        except Exception as exc:
            if policy.classify(exc) != "transient" or attempt >= policy.max_attempts:
                raise
            delay = policy.backoff(attempt, key)
            logger.warning(
                "%s failed transiently (attempt %d/%d, retrying in %.2fs): %s",
                describe, attempt, policy.max_attempts, delay, exc,
            )
            record_retry(describe.split(" for ", 1)[0].replace(" ", "_"))
            sleep(delay)


# ---------------------------------------------------------------- quarantine
def _observer_host() -> str:
    """Identity of the host recording a quarantine: honors the elastic
    scheduler's GORDO_TPU_HOST_ID so a pod-scale report attributes each
    entry to the process that observed the fault."""
    import socket

    return (
        os.environ.get("GORDO_TPU_HOST_ID")
        or f"{socket.gethostname()}-{os.getpid()}"
    )


def _observer_process_index() -> int:
    """This host's rank: the multi-host flag if set, else the rank of the
    initialised ``torch.distributed`` process group, else 0."""
    raw = os.environ.get("GORDO_TPU_PROCESS_ID")
    if raw:
        try:
            return int(raw)
        except ValueError:
            pass
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            dist = torch.distributed
            if dist.is_available() and dist.is_initialized():
                return int(dist.get_rank())
        except Exception:  # noqa: BLE001 — attribution must never fail a build
            pass
    return 0


@dataclass
class QuarantineRecord:
    """Why one machine was dropped from a fleet build — and by whom: the
    ``host``/``process_index`` attribution makes a merged pod-scale
    quarantine report traceable to the host that observed each fault."""

    machine: str
    stage: str
    reason: str
    error: str = ""
    attempts: int = 1
    host: str = field(default_factory=_observer_host)
    process_index: int = field(default_factory=_observer_process_index)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "quarantined": True,
            "machine": self.machine,
            "stage": self.stage,
            "reason": self.reason,
            "error": self.error,
            "attempts": self.attempts,
            "host": self.host,
            "process_index": self.process_index,
        }


# ----------------------------------------------------------------- injection
@dataclass
class _FaultRule:
    site: str
    machine: Optional[str] = None
    times: int = 1
    error: str = "transient"
    # skip the first `after` matching invocations ("fail the Nth call")
    after: int = 0
    # wedge duration for error == "wedge" (a stuck-call stand-in)
    seconds: float = 0.0
    fired: int = field(default=0, compare=False)
    seen: int = field(default=0, compare=False)

    def matches(self, site: str, machine: Optional[str], machines: Sequence[str]):
        if site != self.site:
            return False
        if self.machine is None:
            return True
        if machine is not None and machine == self.machine:
            return True
        return self.machine in machines

    def armed(self) -> bool:
        """Count one matching invocation; True when the rule fires on it
        (past its ``after`` skip window, firing budget not exhausted)."""
        self.seen += 1
        if self.seen <= self.after:
            return False
        if self.times >= 0 and self.fired >= self.times:
            return False
        self.fired += 1
        return True

    def make_error(self, site: str, machine: Optional[str]) -> Exception:
        target = machine or self.machine or "*"
        msg = f"injected {self.error} fault at {site} for {target}"
        if self.error in ("resource_exhausted", "oom"):
            return InjectedOOM(f"RESOURCE_EXHAUSTED: {msg}")
        if self.error == "permanent":
            return PermanentFault(msg)
        return TransientFault(msg)


class FaultPlan:
    """A deterministic script of faults to inject, parsed from JSON."""

    def __init__(self, rules: List[_FaultRule]):
        self.rules = rules

    @classmethod
    def parse(cls, raw: str) -> "FaultPlan":
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        data = json.loads(raw)
        entries = data["rules"] if isinstance(data, dict) else data
        rules = []
        for entry in entries:
            entry = dict(entry)
            site = entry.pop("site")
            # data-altering sites apply on every matching call by default;
            # raising sites fire once
            times = entry.pop(
                "times",
                -1
                if site in ("poison_nan", "serve_poison_nan", "diverge")
                else 1,
            )
            rules.append(
                _FaultRule(
                    site=site,
                    machine=entry.pop("machine", None),
                    times=int(times),
                    error=entry.pop("error", "transient"),
                    after=int(entry.pop("after", 0)),
                    seconds=float(entry.pop("seconds", 0.0)),
                )
            )
            if entry:
                logger.warning("fault plan rule has unknown keys: %s", entry)
        return cls(rules)

    def fire(
        self,
        site: str,
        machine: Optional[str] = None,
        machines: Sequence[str] = (),
    ) -> None:
        """Raise the first matching, armed rule's error — or, for a
        ``wedge`` rule, sleep its ``seconds`` in place (one action per
        fault point either way)."""
        for rule in self.rules:
            if not rule.matches(site, machine, machines):
                continue
            if not rule.armed():
                continue
            if rule.error == "wedge":
                logger.warning(
                    "fault plan: wedging %s for %.1fs", site, rule.seconds
                )
                time.sleep(rule.seconds)
                return
            if rule.error == "die":
                # host death: no exception to catch, no atexit, no flushed
                # buffers — the process is simply gone, exactly what the
                # lease-expiry steal path must survive
                logger.warning(
                    "fault plan: host death at %s (machine %s)", site, machine
                )
                os._exit(17)
            raise rule.make_error(site, machine)

    def should_fire(self, site: str, machine: str) -> bool:
        """Boolean form of :meth:`fire` for sites that alter data instead
        of raising (``poison_nan``, ``diverge``); consumes the rule's
        firing budget the same way."""
        for rule in self.rules:
            if rule.matches(site, machine, ()) and rule.armed():
                return True
        return False


# the process-wide active plan: re-parsed whenever the env string changes,
# so a plan's firing counters survive across calls within one build but a
# test switching plans (monkeypatch.setenv) gets a fresh script
_active_plan: Optional[FaultPlan] = None
_active_raw: Optional[str] = None


def get_plan() -> Optional[FaultPlan]:
    global _active_plan, _active_raw
    raw = os.environ.get(PLAN_ENV)
    if not raw:
        _active_plan = _active_raw = None
        return None
    if raw != _active_raw:
        _active_plan = FaultPlan.parse(raw)
        _active_raw = raw
    return _active_plan


def reset_plan() -> None:
    """Forget the active plan (tests: re-arm firing counters)."""
    global _active_plan, _active_raw
    _active_plan = _active_raw = None


def fault_point(
    site: str,
    machine: Optional[str] = None,
    machines: Sequence[str] = (),
) -> None:
    """Injection hook: no-op unless the active plan scripts a fault here."""
    plan = get_plan()
    if plan is not None:
        plan.fire(site, machine=machine, machines=machines)


def should_fire(site: str, machine: str) -> bool:
    """Injection hook for boolean sites (e.g. ``diverge``): False unless
    the active plan scripts a fault here."""
    plan = get_plan()
    return plan is not None and plan.should_fire(site, machine)


def maybe_poison(machine: str, X, site: str = "poison_nan"):
    """Injection hook: NaN-poison a machine's feature matrix (an ndarray,
    or a frame with ``values``, ``columns`` and ``index`` such as
    ``models.utils.Frame``) per plan. Returns ``X`` unchanged when no rule
    matches (the common case). ``site`` distinguishes the build-side hook
    (default) from the serving twin (``serve_poison_nan``)."""
    plan = get_plan()
    if plan is None or not plan.should_fire(site, machine):
        return X
    import numpy as np

    if hasattr(X, "columns") and hasattr(X, "index"):
        values = np.array(X.values, dtype=float, copy=True)
        values[:, 0] = np.nan
        X = type(X)(values, X.columns, X.index)
    else:
        X = np.array(X, copy=True)
        X[:, 0] = np.nan
    logger.warning("fault plan: NaN-poisoned data for machine %s", machine)
    return X


# ---------------------------------------------------------------- validation
def non_finite_report(X, y=None) -> Optional[str]:
    """None when all values are finite; otherwise a short description of
    what is wrong (used both for pre-flight data validation and post-build
    divergence detection)."""
    import numpy as np

    for name, arr in (("X", X), ("y", y)):
        if arr is None:
            continue
        arr = np.asarray(arr)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        n_bad = int(np.size(arr) - np.count_nonzero(np.isfinite(arr)))
        if n_bad:
            return f"{n_bad} non-finite values in {name} (shape {arr.shape})"
    return None


def params_non_finite(params, losses=None) -> Optional[str]:
    """Divergence check over trained parameters (tensors or arrays, nested
    in dicts, lists and tuples) and a loss history."""
    import numpy as np

    if losses is not None:
        losses = np.asarray(losses)
        if not np.all(np.isfinite(losses)):
            return "non-finite training loss"
    stack = [params]
    while stack:
        leaf = stack.pop()
        if isinstance(leaf, dict):
            stack.extend(leaf.values())
            continue
        if isinstance(leaf, (list, tuple)):
            stack.extend(leaf)
            continue
        if hasattr(leaf, "detach"):
            leaf = leaf.detach().float().cpu().numpy()
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.all(np.isfinite(arr)):
            return f"non-finite model parameters (leaf shape {arr.shape})"
    return None
