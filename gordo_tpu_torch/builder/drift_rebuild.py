"""
Drain the drift-rebuild queue into warm-start delta rebuilds, the consumer
half of the *trigger* quarter of the self-healing loop: the port's
counterpart of ``gordo_tpu/builder/drift_rebuild.py``, with its revision
names and its commit marker, so that JAX and port serving nodes read the
same revision tree.

``python -m gordo_tpu_torch drift-rebuilder`` (a daemon, or one pass with
``--once``) and ``batch-build --drain-drift-queue`` both call
:func:`drain_drift_queue`:

1. claim each pending request through the generation-fenced queue
   (parallel/drift_queue.py): two rebuilders watching one queue never build
   the same machine twice;
2. **refresh the data window**: each drifted machine's
   ``train_start_date``/``train_end_date`` slide so that the window ENDS at
   the detection time and keeps its length. The cache key (which holds the
   dataset config) therefore misses, while the warm key (the config
   without the data, ``ModelBuilder.calculate_warm_key``) still names the
   registered artifact: the fleet trainer starts from the drifted model's
   own parameters;
3. build ONLY the claimed machines with the fleet trainer
   (``BatchedModelBuilder``) into a fresh **delta revision directory**
   ``<output root>/drift-<epoch-ms>/`` (zero-padded, so lexical order is
   time order: the hot-swap watcher's fence relies on it);
4. commit: the ``.drift-complete.json`` marker is written LAST (tmp +
   ``os.replace``); a revision without it is invisible to serving nodes, so
   a rebuilder that dies mid-build leaves garbage but never a half-swapped
   model;
5. complete the claims of the machines that built (each counted in
   ``gordo_build_drift_rebuilds_total``). A quarantined machine keeps its
   claim until the stale-claim timeout, after which another drain retries.

Dates are parsed with ``datetime.fromisoformat``, as the port's datasets
parse them.
"""

import json
import logging
import os
import time
from datetime import datetime, timedelta, timezone
from typing import Any, Dict, List, Optional

from ..observability import metrics as metric_catalog
from ..parallel import drift_queue

logger = logging.getLogger(__name__)

REVISION_PREFIX = "drift-"
COMPLETE_MARKER = ".drift-complete.json"


def revision_name(now: Optional[float] = None) -> str:
    """``drift-<epoch-ms>``, zero-padded so string order is time order."""
    millis = int((time.time() if now is None else now) * 1000)
    return f"{REVISION_PREFIX}{millis:015d}"


def _refreshed_machine(machine, request: Dict[str, Any]):
    """The drifted machine with its training window slid to end at the
    request's detection time, its length kept. On dates that do not parse
    the config is left as it is (the build then hits the cache and
    republishes the existing artifact: safe, just not fresh)."""
    from ..machine import Machine

    cfg = machine.to_dict()
    dataset = dict(cfg.get("dataset") or {})
    try:
        start = datetime.fromisoformat(str(dataset["train_start_date"]))
        end = datetime.fromisoformat(str(dataset["train_end_date"]))
        detected = float(request.get("detected_at") or time.time())
        new_end = datetime.fromtimestamp(detected, tz=timezone.utc)
        if new_end <= end:
            # a replayed or clock-skewed event: still move forward, so that
            # the cache key misses and the rebuild trains
            new_end = end + timedelta(seconds=1)
        dataset["train_end_date"] = new_end.isoformat()
        dataset["train_start_date"] = (new_end - (end - start)).isoformat()
        cfg["dataset"] = dataset
    except (KeyError, TypeError, ValueError, OverflowError) as exc:
        logger.warning("drift rebuild: could not refresh the data window of %s (%s); "
                       "rebuilding with the original window", machine.name, exc)
    return Machine.from_dict(cfg)


def _write_marker(rev_dir: str, built: List[str], revision: str) -> None:
    marker = os.path.join(rev_dir, COMPLETE_MARKER)
    tmp = f"{marker}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump({"revision": revision, "machines": sorted(built),
                   "completed_at": time.time(), "source": "drift-rebuild"}, fh)
    os.replace(tmp, marker)


def drain_drift_queue(machines: List[Any], queue_dir: str, output_root: str,
                      model_register_dir: Optional[str] = None,
                      warm_start: Optional[bool] = None, host_id: Optional[str] = None,
                      serial_fallback: bool = True, fail_fast: bool = False,
                      device=None) -> Dict[str, Any]:
    """One drain pass: claim, rebuild on ``device``, commit. ``machines`` is
    the project's whole fleet; only those with a pending request this pass
    claimed are built. Returns ``{"revision", "built", "failed",
    "requests", "skipped", "seconds"}``; ``revision`` is None when nothing
    built, and ``seconds`` has the wall seconds of the ``claim``, ``build``
    and ``commit`` steps (the marker and the claims' completion)."""
    started = time.perf_counter()
    seconds = {"claim": 0.0, "build": 0.0, "commit": 0.0}
    by_name = {m.name: m for m in machines}
    requests = drift_queue.pending(queue_dir)
    claims = []
    selected = []
    skipped: List[str] = []
    for request in requests:
        name = request.get("machine")
        machine = by_name.get(name)
        if machine is None:
            logger.warning("drift rebuild: request for %r not in the project config; leaving "
                           "it pending", name)
            skipped.append(name)
            continue
        handle = drift_queue.claim(queue_dir, name, host_id=host_id)
        if handle is None:  # another rebuilder holds it
            skipped.append(name)
            continue
        claims.append((handle, request))
        selected.append(_refreshed_machine(machine, request))
    seconds["claim"] = time.perf_counter() - started
    if not selected:
        return {"revision": None, "built": [], "failed": [], "requests": len(requests),
                "skipped": skipped, "seconds": seconds}

    from ..parallel.batch_trainer import BatchedModelBuilder

    started = time.perf_counter()
    revision = revision_name()
    rev_dir = os.path.join(output_root, revision)
    os.makedirs(rev_dir, exist_ok=True)
    logger.info("drift rebuild: warm-start rebuilding %s into %s",
                sorted(m.name for m in selected), rev_dir)
    builder = BatchedModelBuilder(selected, serial_fallback=serial_fallback, output_dir=rev_dir,
                                  model_register_dir=model_register_dir, fail_fast=fail_fast,
                                  device=device, warm_start=warm_start)
    results = builder.build()
    built = sorted(machine_out.name for _model, machine_out in results)
    for name in built:
        metric_catalog.DRIFT_REBUILDS.labels(model=name).inc()
    failed = sorted({handle.machine for handle, _request in claims} - set(built))
    seconds["build"] = time.perf_counter() - started
    started = time.perf_counter()
    if built:
        _write_marker(rev_dir, built, revision)
    for handle, request in claims:
        if handle.machine not in built:
            # the request and the claim stay: the stale-claim timeout fences
            # this generation off and a later drain retries
            continue
        drift_queue.complete(queue_dir, handle,
                             {"revision": revision, "detected_at": request.get("detected_at")})
    seconds["commit"] = time.perf_counter() - started
    if failed:
        logger.warning("drift rebuild: %s failed to build; their requests stay queued for "
                       "retry after the claim timeout", failed)
    return {"revision": revision if built else None, "built": built, "failed": failed,
            "requests": len(requests), "skipped": skipped, "seconds": seconds}
