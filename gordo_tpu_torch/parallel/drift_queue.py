"""
Filesystem rebuild-request queue between drift detection and the builder,
the *trigger* quarter of the self-healing loop: the port's copy of
``gordo_tpu/parallel/drift_queue.py``. Its files are byte-compatible with
the JAX package's, so JAX and port nodes may share one queue directory.

The three operations the drift loop needs, on a shared filesystem:

- **enqueue**: ``requests/<machine>.json`` created with
  ``O_CREAT | O_EXCL``: of N serving workers observing the same drift,
  exactly one creation succeeds, so one drift episode enqueues ONE rebuild
  no matter how many replicas notice it.
- **claim**: generation-fenced claim files ``claims/<machine>.g<N>``
  (O_EXCL again): two rebuilders draining the same queue cannot both build
  a machine, and a claim whose holder died mid-rebuild goes stale after
  ``GORDO_TPU_DRIFT_CLAIM_TIMEOUT_S`` and is stolen by writing generation
  N+1; the fencing token makes the zombie's late ``complete`` a no-op.
- **complete**: an audit marker ``done/<machine>.g<N>.json`` is written
  (tmp + ``os.replace``, idempotent), then the request and claim files are
  removed so a *future* drift episode on the same machine can enqueue
  again. In-episode dedup is the request file's existence; cross-episode
  hysteresis lives in the detector (observability/drift.py cooldown).

``depth()`` (pending request count) feeds the
``gordo_server_drift_queue_depth`` gauge.
"""

import errno
import json
import logging
import os
import socket
import time
from typing import Any, Dict, List, NamedTuple, Optional

from ..util import faults

logger = logging.getLogger(__name__)

REQUESTS_DIRNAME = "requests"
CLAIMS_DIRNAME = "claims"
DONE_DIRNAME = "done"


def default_host_id() -> str:
    return os.environ.get("GORDO_TPU_HOST_ID") or (
        f"{socket.gethostname()}-{os.getpid()}"
    )


def claim_timeout_s() -> float:
    try:
        return float(
            os.environ.get("GORDO_TPU_DRIFT_CLAIM_TIMEOUT_S", "600")
        )
    except ValueError:
        return 600.0


def _ensure_layout(queue_dir: str) -> None:
    for sub in (REQUESTS_DIRNAME, CLAIMS_DIRNAME, DONE_DIRNAME):
        os.makedirs(os.path.join(queue_dir, sub), exist_ok=True)


def _request_path(queue_dir: str, machine: str) -> str:
    return os.path.join(queue_dir, REQUESTS_DIRNAME, f"{machine}.json")


class Claim(NamedTuple):
    machine: str
    generation: int
    path: str


# ------------------------------------------------------------------ enqueue
def enqueue(queue_dir: str, machine: str, payload: Dict[str, Any]) -> bool:
    """Write one rebuild request; False when one is already pending for
    this machine (the dedup path). Raises only on real I/O failure or an
    injected ``drift_enqueue`` fault."""
    faults.fault_point("drift_enqueue", machine=machine)
    _ensure_layout(queue_dir)
    path = _request_path(queue_dir, machine)
    body = dict(payload)
    body.setdefault("machine", machine)
    body.setdefault("enqueued_at", time.time())
    body.setdefault("host", default_host_id())
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
    except FileExistsError:
        return False
    except OSError as exc:  # pragma: no cover - exotic filesystems
        if exc.errno == errno.EEXIST:
            return False
        raise
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(body, fh)
    except Exception:
        # a torn request would wedge the dedup slot: drop it
        try:
            os.remove(path)
        except OSError:
            pass
        raise
    return True


def pending(queue_dir: str) -> List[Dict[str, Any]]:
    """Every readable pending request, oldest first. Unparsable files
    (a writer died mid-write before the fdopen cleanup ran) are skipped,
    not raised — the queue must drain around damage."""
    requests_dir = os.path.join(queue_dir, REQUESTS_DIRNAME)
    try:
        names = sorted(os.listdir(requests_dir))
    except FileNotFoundError:
        return []
    out: List[Dict[str, Any]] = []
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(requests_dir, name)
        try:
            with open(path) as fh:
                body = json.load(fh)
        except (OSError, ValueError):
            logger.warning("drift queue: skipping unreadable request %s", path)
            continue
        if isinstance(body, dict):
            body.setdefault("machine", name[: -len(".json")])
            out.append(body)
    return out


def depth(queue_dir: str) -> int:
    requests_dir = os.path.join(queue_dir, REQUESTS_DIRNAME)
    try:
        return sum(
            1 for name in os.listdir(requests_dir) if name.endswith(".json")
        )
    except FileNotFoundError:
        return 0


# -------------------------------------------------------------------- claim
def _current_claim(queue_dir: str, machine: str):
    """Highest-generation claim file for a machine: (gen, path, age_s),
    or (0, None, None) when unclaimed."""
    claims_dir = os.path.join(queue_dir, CLAIMS_DIRNAME)
    prefix = f"{machine}.g"
    best_gen, best_path = 0, None
    try:
        names = os.listdir(claims_dir)
    except FileNotFoundError:
        return 0, None, None
    for name in names:
        if not name.startswith(prefix):
            continue
        try:
            gen = int(name[len(prefix):])
        except ValueError:
            continue
        if gen > best_gen:
            best_gen, best_path = gen, os.path.join(claims_dir, name)
    if best_path is None:
        return 0, None, None
    try:
        age = time.time() - os.path.getmtime(best_path)
    except OSError:
        # claim vanished between listdir and stat: treat as unclaimed
        return best_gen, None, None
    return best_gen, best_path, age


def claim(
    queue_dir: str,
    machine: str,
    host_id: Optional[str] = None,
    timeout_s: Optional[float] = None,
) -> Optional[Claim]:
    """Acquire the generation-fenced claim for one pending request;
    None when another live rebuilder holds it (or the request vanished).
    A stale claim (holder silent past the timeout) is stolen by writing
    the next generation."""
    _ensure_layout(queue_dir)
    if not os.path.exists(_request_path(queue_dir, machine)):
        return None
    timeout = claim_timeout_s() if timeout_s is None else timeout_s
    gen, path, age = _current_claim(queue_dir, machine)
    if path is not None and age is not None and age < timeout:
        return None
    next_gen = gen + 1
    claim_path = os.path.join(
        queue_dir, CLAIMS_DIRNAME, f"{machine}.g{next_gen}"
    )
    try:
        fd = os.open(claim_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
    except (FileExistsError, OSError):
        return None  # lost the race for this generation
    with os.fdopen(fd, "w") as fh:
        json.dump(
            {"host": host_id or default_host_id(), "ts": time.time()}, fh
        )
    if gen:
        logger.info(
            "drift queue: stole stale claim for %s (g%d -> g%d, idle %.0fs)",
            machine, gen, next_gen, age or 0.0,
        )
    return Claim(machine=machine, generation=next_gen, path=claim_path)


def complete(queue_dir: str, handle: Claim, result: Dict[str, Any]) -> bool:
    """Finish one claimed rebuild: write the done marker, then clear the
    request + claim so future episodes can enqueue. Returns False (and
    changes nothing) when the claim was fenced off by a newer
    generation — the zombie-rebuilder guard."""
    gen, _path, _age = _current_claim(queue_dir, handle.machine)
    if gen > handle.generation:
        logger.warning(
            "drift queue: completion for %s g%d fenced off by g%d",
            handle.machine, handle.generation, gen,
        )
        return False
    done_path = os.path.join(
        queue_dir, DONE_DIRNAME,
        f"{handle.machine}.g{handle.generation}.json",
    )
    tmp = f"{done_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(
            {"completed_at": time.time(), "host": default_host_id(),
             **result},
            fh,
        )
    os.replace(tmp, done_path)
    for path in (_request_path(queue_dir, handle.machine), handle.path):
        try:
            os.remove(path)
        except FileNotFoundError:
            pass
    return True
