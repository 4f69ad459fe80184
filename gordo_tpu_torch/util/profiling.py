"""
Opt-in ``torch.profiler`` hookup: the port's counterpart of
``gordo_tpu/util/profiling.py``.

``GORDO_TPU_PROFILE_DIR=/path`` wraps the fleet build (and any code under
:func:`maybe_profile`) in ``torch.profiler.profile`` with CPU and CUDA
activity, and exports a Chrome trace into ``<dir>/<label>/`` (open it in
Perfetto or ``chrome://tracing``: the host's ops and the card's kernels on
one timeline). While it is on, every telemetry span (observability/
telemetry.py) opens a ``torch.profiler.record_function`` range of its own
name (:func:`annotate`), so the spans and the kernels they launched line
up in the trace.

``torch.profiler`` (Kineto, and CUPTI on the card) allows one session at a
time in a process: :data:`SESSION_LOCK` is held by whichever capture runs,
this module's or the on-demand device trace of observability/profiler.py,
and the other one does not start while it is held.
"""

import contextlib
import logging
import os
import threading
import time

logger = logging.getLogger(__name__)

PROFILE_DIR_ENV = "GORDO_TPU_PROFILE_DIR"

# one torch.profiler session a process (see the module docstring)
SESSION_LOCK = threading.Lock()
# what the last maybe_profile capture wrote: {"label", "path", "bytes",
# "export_s", "kernels"}; None before the first
LAST_PROFILE = None


def profiling_enabled() -> bool:
    """Whether $GORDO_TPU_PROFILE_DIR profiling is requested."""
    return bool(os.environ.get(PROFILE_DIR_ENV))


def activities() -> list:
    """The profiler's activities: the CPU, and CUDA when torch sees a card."""
    import torch
    from torch.profiler import ProfilerActivity

    out = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        out.append(ProfilerActivity.CUDA)
    return out


def kernel_counts(trace: dict) -> dict:
    """``{kernel name: launches}`` of a ``torch.profiler`` Chrome trace: its
    events of category ``kernel`` (what ran on the card)."""
    counts: dict = {}
    for event in trace.get("traceEvents", ()):
        if event.get("cat") == "kernel":
            counts[event["name"]] = counts.get(event["name"], 0) + 1
    return counts


def export(prof, path: str) -> dict:
    """Write ``prof``'s Chrome trace to ``path``; returns its size, the
    seconds the export took and its kernels' launches (:func:`kernel_counts`)."""
    import json

    started = time.perf_counter()
    prof.export_chrome_trace(path)
    export_s = time.perf_counter() - started
    with open(path) as fh:
        kernels = kernel_counts(json.load(fh))
    return {"path": path, "bytes": os.path.getsize(path), "export_s": export_s,
            "kernels": kernels}


@contextlib.contextmanager
def maybe_profile(label: str):
    """Profile the enclosed block when $GORDO_TPU_PROFILE_DIR is set, into
    ``<dir>/<label>/trace_<pid>.json``. While another session holds
    :data:`SESSION_LOCK` the block runs unprofiled, with a warning."""
    global LAST_PROFILE
    profile_dir = os.environ.get(PROFILE_DIR_ENV)
    if not profile_dir:
        yield
        return
    if not SESSION_LOCK.acquire(blocking=False):
        logger.warning("torch.profiler is busy in this process: %s runs unprofiled", label)
        yield
        return
    try:
        from torch.profiler import profile

        target = os.path.join(profile_dir, label)
        os.makedirs(target, exist_ok=True)
        logger.info("torch.profiler tracing %s -> %s", label, target)
        with profile(activities=activities()) as prof:
            yield
        LAST_PROFILE = dict(label=label, **export(
            prof, os.path.join(target, f"trace_{os.getpid()}.json")))
        logger.info("profile written: %s (%d bytes in %.2f s; open with Perfetto)",
                    LAST_PROFILE["path"], LAST_PROFILE["bytes"], LAST_PROFILE["export_s"])
    finally:
        SESSION_LOCK.release()


def annotate(name: str):
    """A named range inside an active ``torch.profiler`` trace: a shared
    ``nullcontext`` unless $GORDO_TPU_PROFILE_DIR is set, so spans cost
    nothing here when profiling is off."""
    if not profiling_enabled():
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)
