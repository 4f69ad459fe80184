"""
Serving warm-up: pay the first request's costs before traffic. The port's
counterpart of ``gordo_tpu/server/warmup.py``, with its report's keys.

The JAX warm-up compiles each artifact's XLA predict programs per padded
row bucket, or loads them where the artifact ships them. The port compiles
no program, so it neither ships nor loads one (serializer/serializer.py:
with ``GORDO_TPU_LOAD_SHIPPED_PROGRAMS`` set it logs that once); what its
first request pays in that place is, per architecture of the collection:

- the kernel libraries its spec launches (``ops/_build.py``
  ``load_library``: on an empty build directory this builds every CUDA
  source, then loads the ones the spec names, the stems that
  ``parallel.batch_trainer._kernel_libraries`` lists);
- one predict per row bucket (``GORDO_TPU_WARMUP_ROWS``, default 128 and
  1,024 output rows) through the estimator's ``predict``: with the
  cross-model batcher on (``run-server``'s default) that is the batcher,
  whose ``auto`` mode runs its measured A/B at the first predict of a spec,
  and each Transformer block launches the flash forward;
- ``register_params``: the model's parameters written into the batcher's
  device-resident ``_ParamBank`` after its first predict, so that the first
  fused call of real traffic gathers from a bank already stacked
  (``gordo_server_param_bank_restacks_total`` stays flat from boot).

Models are loaded through the loader the server serves them from
(``GordoServer.model_entry``), so the bank holds the very modules traffic
predicts with. ``run-server --warmup`` (``GORDO_TPU_SERVING_WARMUP=1``)
runs :func:`warmup_collection` in each worker after the fork, before the
worker accepts; ``POST /debug/prewarm`` runs it on demand. A model that
fails to warm is logged and named in the report, and the server serves it
lazily. The report, also kept for ``/debug/vars`` (:func:`last_report`),
has the JAX keys (``aot_programs``, ``aot_shipped``, ``aot_rejected`` and
``compile_seconds_saved`` are 0: the port ships no AOT program) and the
port's ``architectures`` (each spec's models, row buckets and kernel
libraries), ``libraries``, ``errors`` (by model, the failure's type and
message) and ``pid`` (the worker that warmed).
"""

import hashlib
import json
import logging
import os
import threading
import time
from typing import Callable, Iterable, Optional

import numpy as np

logger = logging.getLogger(__name__)

DEFAULT_BUCKET_ROWS = (128, 1024)

_last_report: Optional[dict] = None
_last_report_lock = threading.Lock()


def last_report() -> Optional[dict]:
    """The most recent warm-up report, or None before any warm-up ran."""
    with _last_report_lock:
        return None if _last_report is None else dict(_last_report)


def record_report(report: dict) -> None:
    """Keep ``report`` as the last one (a warm-up that failed as a whole
    records its error here)."""
    global _last_report
    with _last_report_lock:
        _last_report = dict(report)


def _estimators(model):
    """Every fitted estimator with a ``spec_`` and a ``module_`` inside an
    artifact: the estimator itself, a pipeline's steps, or a detector's
    base estimator."""
    seen = set()
    stack = [model]
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        if hasattr(node, "spec_") and hasattr(node, "module_"):
            yield node
            continue
        if hasattr(node, "base_estimator"):
            stack.append(node.base_estimator)
        if hasattr(node, "steps"):
            stack.extend(step for _name, step in node.steps)


def _default_bucket_rows():
    """The output-row buckets to warm per model: ``GORDO_TPU_WARMUP_ROWS``
    (comma-separated positive integers), else 128 and 1,024; a malformed
    value falls back to the defaults with a warning."""
    env = os.environ.get("GORDO_TPU_WARMUP_ROWS")
    if env:
        try:
            rows = tuple(int(part) for part in env.split(",") if part.strip())
        except ValueError:
            rows = ()
        if rows and all(r > 0 for r in rows):
            return rows
        logger.warning("malformed GORDO_TPU_WARMUP_ROWS=%r; using defaults %s", env,
                       DEFAULT_BUCKET_ROWS)
    return DEFAULT_BUCKET_ROWS


def _model_names(collection_dir: str) -> list:
    names = []
    for name in sorted(os.listdir(collection_dir)):
        path = os.path.join(collection_dir, name)
        if os.path.isdir(path) and os.path.exists(os.path.join(path, "metadata.json")):
            names.append(name)
    return names


def architecture_label(spec) -> str:
    """A spec's layers, windowing, dtype and width, and a short digest of
    the whole spec: models with one label fuse into one batcher call."""
    from ..models.spec import spec_to_dict

    digest = hashlib.sha1(json.dumps(spec_to_dict(spec), sort_keys=True,
                                     default=str).encode()).hexdigest()[:8]
    layers = "+".join(sorted({type(layer).__name__ for layer in spec.layers}))
    return (f"{layers} lookback {spec.lookback_window} lookahead {spec.lookahead} "
            f"{spec.compute_dtype} {spec.n_features} tags #{digest}")


def _load_libraries(spec, device) -> tuple:
    """Load the kernel libraries ``spec`` launches; none on the CPU, where
    the wrappers run their plain twins."""
    if getattr(device, "type", str(device)) != "cuda":
        return ()
    from ..ops import _build
    from ..parallel.batch_trainer import _kernel_libraries

    stems = _kernel_libraries(spec)
    for stem in stems:
        _build.load_library(stem)
    return stems


def _register_params(estimator) -> bool:
    """Write the estimator's parameters into the batcher's bank of its
    spec (when batching is on); False when there is no batcher."""
    from .batcher import get_batcher

    batcher = get_batcher()
    if batcher is None:
        return False
    batcher.register_params(estimator.spec_, estimator.module_)
    return True


def warmup_collection(collection_dir: str, bucket_rows: Optional[Iterable[int]] = None,
                      names: Optional[Iterable[str]] = None,
                      loader: Optional[Callable[[str], object]] = None) -> dict:
    """Warm every model of the collection (or ``names``): its kernel
    libraries, one predict per row bucket, its parameters into the bank.
    ``loader(name)`` gives the served entry of a model (with ``detector``);
    without one the artifact is loaded on the card, outside any server.
    Returns the report (module docstring); a model that fails is skipped
    and named in ``failed`` and ``errors``."""
    from ..serializer import load

    t0 = time.monotonic()
    rows = tuple(_default_bucket_rows() if bucket_rows is None else bucket_rows)
    names = list(names) if names is not None else _model_names(collection_dir)
    programs = warmed = registered = 0
    failed, errors = [], {}
    architectures: dict = {}
    libraries: set = set()
    for name in names:
        try:
            if loader is not None:
                model = loader(name).detector
            else:
                model = load(os.path.join(collection_dir, name))
            estimators = list(_estimators(model))
            if not estimators:
                raise ValueError("no fitted estimator in the artifact")
            for estimator in estimators:
                spec = estimator.spec_
                label = architecture_label(spec)
                arch = architectures.setdefault(label, {
                    "models": [], "rows": list(rows), "libraries": [],
                    "lookback_window": spec.lookback_window,
                    "compute_dtype": spec.compute_dtype})
                stems = _load_libraries(spec, next(estimator.module_.parameters()).device)
                arch["libraries"] = sorted(set(arch["libraries"]) | set(stems))
                libraries.update(stems)
                for bucket in rows:
                    # + the offset, so that a windowed model gives exactly
                    # ``bucket`` outputs: the padded shape a request of that
                    # many outputs takes
                    X = np.zeros((int(bucket) + spec.output_offset, spec.n_features),
                                 np.float32)
                    estimator.predict(X)
                    programs += 1
                registered += _register_params(estimator)
                arch["models"].append(name)
            warmed += 1
        except Exception as exc:  # noqa: BLE001 -- a failed warm-up serves lazily
            logger.warning("warmup failed for model %r: %s: %s", name, type(exc).__name__, exc)
            failed.append(name)
            errors[name] = f"{type(exc).__name__}: {exc}"
    seconds = time.monotonic() - t0
    logger.info("serving warmup: %d model(s), %d architecture(s), %d predict(s), %d param-bank "
                "registration(s), libraries %s in %.1fs%s", warmed, len(architectures), programs,
                registered, sorted(libraries), seconds,
                f" ({len(failed)} failed: {failed})" if failed else "")
    report = {
        "models": warmed,
        "programs": programs,
        "aot_programs": 0,
        "aot_shipped": 0,
        "aot_rejected": 0,
        "compile_seconds_saved": 0.0,
        "registered_params": registered,
        "seconds": round(seconds, 2),
        "failed": failed,
        "errors": errors,
        "architectures": architectures,
        "libraries": sorted(libraries),
        "pid": os.getpid(),
    }
    record_report(report)
    return report
