"""
Zero-downtime model hot swap, the *swap* quarter of the self-healing loop:
the port's counterpart of ``gordo_tpu/server/hotswap.py``, with its knobs,
its revision layout and its order of steps.

The drift rebuilder (builder/drift_rebuild.py) writes each batch of rebuilt
machines into a **delta revision directory** beside the serving collection
directory::

    <root>/
      rev-abcdef/          <- MODEL_COLLECTION_DIR (full revision)
      drift-0001754.../    <- delta revision: ONLY the rebuilt machines
        .drift-complete.json   <- commit marker, written LAST
        machine-7/ ...

A watcher thread (``GORDO_TPU_HOT_SWAP=1``, polled every
``GORDO_TPU_HOT_SWAP_POLL_S``, 5 s by default) scans for delta revisions
whose commit marker exists (a revision still being built is invisible) and
swaps each machine the marker lists, oldest revision first, in this order:

1. the ``swap_commit`` fault site (util/faults.py; a failure aborts this
   swap, counted in ``gordo_server_hot_swap_failures_total``, and the next
   poll retries: the pointer never flips to a half-loaded model);
2. preload: the new artifact loaded through the server's own loader
   (``GordoServer.model_entry``), so it is the object requests will hold;
3. warm: ``warmup_collection`` of that one machine through the same loader
   (server/warmup.py: its kernel libraries, one predict per row bucket, its
   parameters into the batcher's bank);
4. the bank swap: ``CrossModelBatcher.swap_params`` writes each rebuilt
   estimator's parameters over the old artifact's slot in place (no
   restack, no change of capacity);
5. the flip: the machine's override (one dict write under a lock), which
   every request of the machine that pins no revision resolves once, at its
   start; a request in flight finishes on the artifact it resolved;
6. evict: the server drops the old artifact's loaded model and every cached
   failed load of the machine (``GordoServer.evict_machine``);
7. ``drift.note_rebuilt``, so the detector's scores recalibrate, then
   ``gordo_server_hot_swaps_total``.

Each swap's preload, warm, bank-write and flip milliseconds are logged and
kept (:func:`swaps`). A request that pins a revision (``?revision=`` or the
``revision`` header) bypasses the override. Everything is off by default:
without ``GORDO_TPU_HOT_SWAP`` no watcher starts, and with no override
:func:`active` is one truthiness check on the request path.
"""

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..observability import drift
from ..observability import metrics as metric_catalog
from ..util import faults

logger = logging.getLogger(__name__)

# a delta revision is committed only once this marker file exists inside it
# (written atomically, after every artifact is on disk)
COMPLETE_MARKER = ".drift-complete.json"
REVISION_PREFIX = "drift-"

_lock = threading.Lock()
# machine name -> (collection dir of the delta revision, revision name)
_overrides: Dict[str, Tuple[str, str]] = {}
# machine name -> highest revision name swapped in (lexical fence: delta
# revision names are zero-padded epoch milliseconds, so string order is time
# order and a re-scanned old revision can never roll a machine back)
_last_swapped: Dict[str, str] = {}
# the latest swaps: machine, revision, each step's milliseconds, flip time
_swaps: "deque[dict]" = deque(maxlen=256)
_watcher: Optional[threading.Thread] = None
_watcher_owner = None
_watcher_stop = threading.Event()


def enabled() -> bool:
    return os.environ.get("GORDO_TPU_HOT_SWAP", "").lower() in ("1", "true", "yes")


def poll_interval_s() -> float:
    try:
        return float(os.environ.get("GORDO_TPU_HOT_SWAP_POLL_S", "5"))
    except ValueError:
        return 5.0


def active(name: str) -> Optional[Tuple[str, str]]:
    """The (collection_dir, revision) override of one machine, or None.
    With no override at all this is one truthiness check, no lock."""
    if not _overrides:
        return None
    with _lock:
        return _overrides.get(name)


def overrides() -> Dict[str, Tuple[str, str]]:
    with _lock:
        return dict(_overrides)


def swaps() -> List[dict]:
    """The latest swaps, oldest first: ``machine``, ``revision``,
    ``preload_ms``, ``warm_ms``, ``bank_ms``, ``flip_ms``, ``swapped``
    (whether the old artifact's bank slot was rewritten) and ``flipped_at``
    (``time.time()`` of the flip)."""
    with _lock:
        return list(_swaps)


# ------------------------------------------------------------------- scan
def _delta_revisions(collection_dir: str) -> List[Tuple[str, str]]:
    """Committed delta revisions beside the serving collection directory,
    as (revision name, path), oldest first (so a machine rebuilt twice ends
    on the newest)."""
    parent = os.path.dirname(os.path.normpath(collection_dir))
    try:
        names = sorted(os.listdir(parent))
    except OSError:
        return []
    out = []
    for name in names:
        if not name.startswith(REVISION_PREFIX):
            continue
        path = os.path.join(parent, name)
        if os.path.isdir(path) and os.path.exists(os.path.join(path, COMPLETE_MARKER)):
            out.append((name, path))
    return out


def _marker_machines(rev_dir: str) -> List[str]:
    try:
        with open(os.path.join(rev_dir, COMPLETE_MARKER)) as fh:
            body = json.load(fh)
    except (OSError, ValueError):
        return []
    machines = body.get("machines") if isinstance(body, dict) else None
    return [m for m in machines or [] if isinstance(m, str)]


def poll_once(collection_dir: str, server=None) -> List[str]:
    """One watcher tick over the delta revisions beside ``collection_dir``:
    swap into ``server`` (a GordoServer) every machine newer than what this
    process last swapped in. Returns the machines swapped this tick."""
    swapped: List[str] = []
    for revision, rev_dir in _delta_revisions(collection_dir):
        for machine in _marker_machines(rev_dir):
            if _last_swapped.get(machine, "") >= revision:
                continue
            if _swap_one(server, rev_dir, revision, machine):
                swapped.append(machine)
    return swapped


# ------------------------------------------------------------------- swap
def _swap_one(server, rev_dir: str, revision: str, machine: str) -> bool:
    """Swap ``machine`` of delta revision ``revision`` (at ``rev_dir``) into
    ``server``, in the module docstring's order; False (counted, logged,
    the old artifact serving on) when a step before the flip fails."""
    current = active(machine)
    old_revision = current[1] if current else server.revision
    timings: Dict[str, float] = {}
    try:
        faults.fault_point("swap_commit", machine=machine)
        # everything up to the flip leaves the old artifact serving, untouched
        started = time.perf_counter()
        entry = server.model_entry(revision, machine)
        timings["preload_ms"] = 1e3 * (time.perf_counter() - started)
        started = time.perf_counter()
        _warm(server, rev_dir, revision, machine)
        timings["warm_ms"] = 1e3 * (time.perf_counter() - started)
        started = time.perf_counter()
        rewritten = _swap_bank(server.peek_entry(old_revision, machine), entry)
        timings["bank_ms"] = 1e3 * (time.perf_counter() - started)
        started = time.perf_counter()
        with _lock:
            _overrides[machine] = (rev_dir, revision)
            _last_swapped[machine] = revision
        flipped_at = time.time()
        timings["flip_ms"] = 1e3 * (time.perf_counter() - started)
        # after the flip: drop what still describes the old artifact (and any
        # cached failure masking the new one), and close the detection loop
        server.evict_machine(machine, keep_revision=revision)
        drift.note_rebuilt(machine)
        metric_catalog.HOT_SWAPS.labels(model=machine).inc()
    except Exception as exc:  # noqa: BLE001 -- the next poll retries
        metric_catalog.HOT_SWAP_FAILURES.labels(model=machine).inc()
        logger.warning("hot-swap of %s to revision %s failed (old artifact keeps serving): %s",
                       machine, revision, exc)
        return False
    record = dict(machine=machine, revision=revision, swapped=rewritten,
                  flipped_at=flipped_at, **timings)
    with _lock:
        _swaps.append(record)
    logger.info("hot-swap: %s now serving revision %s (preload %.1f ms, warm %.1f ms, bank "
                "%.2f ms, flip %.3f ms)", machine, revision, timings["preload_ms"],
                timings["warm_ms"], timings["bank_ms"], timings["flip_ms"])
    return True


def _warm(server, rev_dir: str, revision: str, machine: str) -> None:
    """Warm the new artifact as a boot warm-up would, through the server's
    loader, so the bank keys on the object requests will hold. A model that
    fails to warm fails the swap: it would fail its requests too."""
    from .warmup import warmup_collection

    report = warmup_collection(rev_dir, names=[machine],
                               loader=lambda name: server.model_entry(revision, name))
    if report["failed"]:
        raise RuntimeError(f"warm-up failed: {report['errors'].get(machine)}")


def _swap_bank(old_entry, new_entry) -> bool:
    """Write each rebuilt estimator's parameters over its old counterpart's
    bank slot (matched by spec). False when there is no batcher or the old
    model is not resident: its slot then ages out by LRU, and the new
    parameters were written by the warm-up."""
    from .batcher import peek_batcher
    from .warmup import _estimators

    batcher = peek_batcher()
    if batcher is None or old_entry is None:
        return False
    new_by_spec = {est.spec_: est.module_ for est in _estimators(new_entry.detector)}
    rewritten = False
    for old_est in _estimators(old_entry.detector):
        new_module = new_by_spec.get(old_est.spec_)
        if new_module is not None:
            rewritten |= batcher.swap_params(old_est.spec_, old_est.module_, new_module)
    return rewritten


# ---------------------------------------------------------------- watcher
def start_watcher(collection_dir: str, server) -> Optional[threading.Thread]:
    """Start the daemon poll thread that swaps into ``server`` (idempotent:
    one watcher a process; None when ``GORDO_TPU_HOT_SWAP`` is closed)."""
    global _watcher, _watcher_owner
    if not enabled():
        return None
    if _watcher is not None and _watcher.is_alive():
        return _watcher
    _watcher_stop.clear()

    def _loop():
        while not _watcher_stop.wait(poll_interval_s()):
            try:
                poll_once(collection_dir, server)
            except Exception as exc:  # noqa: BLE001 -- the watcher must survive
                logger.warning("hot-swap watcher tick failed: %s", exc)

    _watcher = threading.Thread(target=_loop, name="gordo-hotswap-watcher", daemon=True)
    _watcher_owner = server
    _watcher.start()
    logger.info("hot-swap watcher started (poll every %.1fs) over %s", poll_interval_s(),
                collection_dir)
    return _watcher


def stop_watcher(server=None) -> None:
    """Stop the watcher (only if ``server`` started it, when one is given)."""
    global _watcher, _watcher_owner
    if server is not None and server is not _watcher_owner:
        return
    _watcher_stop.set()
    if _watcher is not None and _watcher is not threading.current_thread():
        _watcher.join(timeout=30.0)
    _watcher = _watcher_owner = None


def reset_for_tests() -> None:
    stop_watcher()
    with _lock:
        _overrides.clear()
        _last_swapped.clear()
        _swaps.clear()
