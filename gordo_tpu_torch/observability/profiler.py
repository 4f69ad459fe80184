"""
Always-on sampling profiler for the serving plane's hot threads: the port's
copy of ``gordo_tpu/observability/profiler.py``.

A metrics dashboard says *that* CPU time went somewhere; this module says
*where*. A background sampler walks ``sys._current_frames()`` at
``GORDO_TPU_PROFILE_HZ`` (default off; ~99 Hz when on — deliberately not
100 so the sampler cannot alias against 10ms-periodic work) for the
registered hot threads (the batcher's dispatcher, ``gordo-batcher``, and
the fast lanes' connection and event-loop threads); each registers itself
by name at thread start via :func:`register_thread`. Sampled stacks fold into a bounded counter keyed
by frame tuples, exported two ways:

- **collapsed-stack text** (``thread;file:fn;file:fn count`` — the
  flamegraph.pl / speedscope interchange format), and
- **Chrome trace-event JSON** (one synthetic ``X`` slice per distinct
  stack, duration proportional to its sample share, one lane per thread).

``GET /debug/profile?seconds=N`` (gated by ``GORDO_TPU_DEBUG_ENDPOINTS``)
serves both, and can also run an **on-demand burst capture** — an inline
sampling loop at a requested Hz that works even when the steady sampler
is off — plus an on-demand ``torch.profiler`` device-trace arm
(``?device=1``, :func:`device_trace`) for the card's side of the same
question: it records CPU and CUDA activity, writes a Chrome trace and
reports the CUDA kernels it saw, by name and count.

Disabled path: with neither ``GORDO_TPU_PROFILE_HZ`` nor
``GORDO_TPU_DEBUG_ENDPOINTS`` set, :func:`register_thread` returns a
shared no-op singleton without touching any state — the serving path is
byte-identical to a build without this module. Registration is armed by
*either* knob because burst capture through the debug endpoint must be
able to name the hot threads even when steady sampling is off.

Cost model when on: one ``sys._current_frames()`` call per tick returns
every thread's current frame without stopping the world; folding walks at
most ``_MAX_DEPTH`` frames per registered thread. At 99 Hz over three
registered threads this is tens of microseconds per tick.
"""

import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import metrics as metric_catalog

logger = logging.getLogger(__name__)

DEFAULT_HZ = 99.0

# folding bounds: frame walks and the distinct-stack space are both capped
# so a pathological recursion or an unbounded code path cannot grow the
# profiler without limit (overflow folds into one "_overflow" bucket)
_MAX_DEPTH = 64
_DEFAULT_MAX_STACKS = 2048
_MAX_THREADS = 512

_OVERFLOW_KEY: Tuple[str, ...] = ("_overflow",)

_TRUTHY = ("1", "true", "yes")


def steady_hz() -> float:
    """Steady-sampler rate from ``GORDO_TPU_PROFILE_HZ`` (0 = off)."""
    raw = os.environ.get("GORDO_TPU_PROFILE_HZ", "")
    if not raw:
        return 0.0
    try:
        hz = float(raw)
    except ValueError:
        return 0.0
    if hz <= 0:
        return 0.0
    return min(hz, 1000.0)


def max_stacks() -> int:
    try:
        return max(
            16,
            int(os.environ.get(
                "GORDO_TPU_PROFILE_MAX_STACKS", str(_DEFAULT_MAX_STACKS)
            )),
        )
    except ValueError:
        return _DEFAULT_MAX_STACKS


def registration_armed() -> bool:
    """True when registering thread names can ever matter: the steady
    sampler is configured, or the debug endpoints (burst capture) are
    enabled. With both off, :func:`register_thread` is a pure no-op."""
    if steady_hz() > 0:
        return True
    return os.environ.get(
        "GORDO_TPU_DEBUG_ENDPOINTS", ""
    ).lower() in _TRUTHY


# ------------------------------------------------------------ registration
class _NoopRegistration:
    """Shared do-nothing handle returned on the disabled path."""

    __slots__ = ()

    def unregister(self) -> None:
        pass


NOOP_REGISTRATION = _NoopRegistration()


class _Registration:
    __slots__ = ("ident",)

    def __init__(self, ident: int):
        self.ident = ident

    def unregister(self) -> None:
        with _lock:
            _threads.pop(self.ident, None)


_lock = threading.Lock()
_threads: Dict[int, str] = {}  # thread ident -> registered name


def register_thread(name: str):
    """Register the *calling* thread as a named hot thread. Returns a
    handle with ``unregister()``; the shared no-op singleton when no
    profiler/debug knob is set (zero state touched, zero allocation
    beyond the call itself)."""
    if not registration_armed():
        return NOOP_REGISTRATION
    ident = threading.get_ident()
    with _lock:
        if len(_threads) >= _MAX_THREADS and ident not in _threads:
            return NOOP_REGISTRATION
        _threads[ident] = str(name)
    ensure_started()
    return _Registration(ident)


def registered_threads() -> Dict[int, str]:
    with _lock:
        return dict(_threads)


def _purge(stale: List[int]) -> None:
    """Drop idents that no longer map to a live frame (thread exited).
    Idents are reused by the OS, so per-connection thread-lane
    registrations must not pin dead entries forever."""
    if not stale:
        return
    with _lock:
        for ident in stale:
            _threads.pop(ident, None)


# ----------------------------------------------------------- stack folding
def _fold_frames(frame) -> Tuple[str, ...]:
    """Root-first tuple of ``file.py:function`` frames, depth-bounded."""
    parts: List[str] = []
    depth = 0
    while frame is not None and depth < _MAX_DEPTH:
        code = frame.f_code
        parts.append(
            os.path.basename(code.co_filename) + ":" + code.co_name
        )
        frame = frame.f_back
        depth += 1
    parts.reverse()
    return tuple(parts)


class StackCounter:
    """Bounded counter of folded stacks keyed by (thread, *frames).

    Thread-safe; new distinct stacks past ``limit`` fold into one
    overflow bucket instead of growing the dict.
    """

    def __init__(self, limit: Optional[int] = None):
        self.limit = int(limit) if limit else max_stacks()
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, ...], int] = {}
        self.total = 0
        self.overflow = 0

    def fold(self, thread_name: str, frame) -> None:
        key = (thread_name,) + _fold_frames(frame)
        with self._lock:
            self.total += 1
            current = self._counts.get(key)
            if current is not None:
                self._counts[key] = current + 1
            elif len(self._counts) < self.limit:
                self._counts[key] = 1
            else:
                self.overflow += 1
                self._counts[_OVERFLOW_KEY] = (
                    self._counts.get(_OVERFLOW_KEY, 0) + 1
                )

    def merge(self, other: "StackCounter") -> "StackCounter":
        with other._lock:
            items = list(other._counts.items())
            total, overflow = other.total, other.overflow
        with self._lock:
            for key, n in items:
                current = self._counts.get(key)
                if current is not None:
                    self._counts[key] = current + n
                elif len(self._counts) < self.limit:
                    self._counts[key] = n
                else:
                    self.overflow += n
                    self._counts[_OVERFLOW_KEY] = (
                        self._counts.get(_OVERFLOW_KEY, 0) + n
                    )
            self.total += total
            self.overflow += overflow
        return self

    # ------------------------------------------------------------ export
    def collapsed(self, top: Optional[int] = None) -> List[str]:
        """Flamegraph collapsed-stack lines, biggest first:
        ``thread;frame;frame count``."""
        with self._lock:
            items = sorted(
                self._counts.items(), key=lambda kv: kv[1], reverse=True
            )
        if top is not None:
            items = items[: int(top)]
        return [";".join(key) + f" {n}" for key, n in items]

    def to_dict(self, top: Optional[int] = None) -> Dict[str, Any]:
        with self._lock:
            distinct = len(self._counts)
            total, overflow = self.total, self.overflow
        return {
            "total_samples": total,
            "distinct_stacks": distinct,
            "overflow_samples": overflow,
            "collapsed": self.collapsed(top),
        }

    def chrome_trace(self, hz: float) -> Dict[str, Any]:
        """Synthetic Chrome trace: per thread lane, one ``X`` slice per
        distinct stack with duration ``count / hz`` laid end to end —
        proportions match the sample shares, which is what a sampled
        profile can honestly claim."""
        hz = hz if hz > 0 else DEFAULT_HZ
        with self._lock:
            items = sorted(self._counts.items())
        events: List[Dict[str, Any]] = []
        cursor: Dict[str, float] = {}
        for key, n in items:
            thread, frames = key[0], key[1:]
            start = cursor.get(thread, 0.0)
            duration_us = n / hz * 1e6
            events.append(
                {
                    "name": frames[-1] if frames else thread,
                    "cat": "gordo_profile",
                    "ph": "X",
                    "ts": start,
                    "dur": duration_us,
                    "pid": os.getpid(),
                    "tid": thread,
                    "args": {"stack": ";".join(frames), "samples": n},
                }
            )
            cursor[thread] = start + duration_us
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "gordo_tpu_torch.observability.profiler",
                "hz": hz,
                "totalSamples": self.total,
            },
        }

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self.total = 0
            self.overflow = 0


_steady = StackCounter()


# ---------------------------------------------------------- steady sampler
def _sample_once(counter: StackCounter) -> int:
    """One tick: fold the current frame of every registered thread.
    Returns the number of samples folded; purges exited threads."""
    targets = registered_threads()
    if not targets:
        return 0
    frames = sys._current_frames()
    self_ident = threading.get_ident()
    folded = 0
    stale: List[int] = []
    for ident, name in targets.items():
        if ident == self_ident:
            continue
        frame = frames.get(ident)
        if frame is None:
            stale.append(ident)
            continue
        counter.fold(name, frame)
        folded += 1
    _purge(stale)
    return folded


class _Sampler(threading.Thread):
    def __init__(self, hz: float):
        super().__init__(daemon=True, name="gordo-profiler")
        self.hz = hz
        self._stop_event = threading.Event()

    def run(self) -> None:
        period = 1.0 / self.hz
        while not self._stop_event.wait(period):
            try:
                folded = _sample_once(_steady)
                if folded:
                    metric_catalog.PROFILE_SAMPLES.inc(folded)
            except Exception:  # pragma: no cover — sampling is advisory
                logger.exception("profiler: steady sample tick failed")

    def stop(self) -> None:
        self._stop_event.set()


_sampler: Optional[_Sampler] = None
_sampler_lock = threading.Lock()


def ensure_started() -> bool:
    """Start the steady sampler iff ``GORDO_TPU_PROFILE_HZ`` > 0 and it
    is not already running. Idempotent; returns True when a sampler is
    running after the call."""
    hz = steady_hz()
    if hz <= 0:
        return False
    global _sampler
    with _sampler_lock:
        if _sampler is not None and _sampler.is_alive():
            return True
        _sampler = _Sampler(hz)
        _sampler.start()
        logger.info("profiler: steady sampler started at %.1f Hz", hz)
        return True


def steady_running() -> bool:
    with _sampler_lock:
        return _sampler is not None and _sampler.is_alive()


def stop_steady() -> None:
    global _sampler
    with _sampler_lock:
        if _sampler is not None:
            _sampler.stop()
            _sampler = None


# ------------------------------------------------------------ burst capture
def burst(seconds: float, hz: Optional[float] = None) -> StackCounter:
    """On-demand burst capture: sample for ``seconds`` at ``hz`` into a
    fresh counter, independent of the steady sampler (works with it off).
    Samples the registered hot threads — falls back to every live thread
    when none registered so a capture is never silently empty. The
    sampling loop runs in a short-lived helper thread and the caller
    blocks on it, so a capture requested *from* a registered thread (the
    event-loop lane serving /debug/profile) still sees that thread's
    stack — serve_forever and the whole handler lineage included."""
    seconds = min(max(float(seconds), 0.05), 30.0)
    hz = min(max(float(hz or DEFAULT_HZ), 1.0), 999.0)
    period = 1.0 / hz
    counter = StackCounter()
    targets = registered_threads()
    if not targets:
        targets = {
            t.ident: t.name
            for t in threading.enumerate()
            if t.ident is not None
        }
    folded_box = [0]

    def _loop():
        self_ident = threading.get_ident()
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            frames = sys._current_frames()
            for ident, name in targets.items():
                if ident == self_ident:
                    continue
                frame = frames.get(ident)
                if frame is not None:
                    counter.fold(name, frame)
                    folded_box[0] += 1
            time.sleep(period)

    worker = threading.Thread(
        target=_loop, daemon=True, name="gordo-profiler-burst"
    )
    worker.start()
    worker.join(seconds + 5.0)
    if folded_box[0]:
        metric_catalog.PROFILE_SAMPLES.inc(folded_box[0])
    return counter


# ----------------------------------------------------------- device traces
def device_trace(seconds: float) -> Dict[str, Any]:
    """On-demand ``torch.profiler`` capture with CPU and CUDA activity:
    trace the process for ``seconds`` into ``GORDO_TPU_PROFILE_DIR`` (or a
    temporary directory) and report where the Chrome trace landed
    (``dir``, and the ``files`` and ``bytes`` this capture wrote there),
    the seconds its export took, and the
    CUDA kernels it recorded with each one's launches (``kernels``).

    Best-effort, as the JAX arm: a capture that cannot start answers
    ``{"error": ..., "dir": ...}`` and serving goes on. ``torch.profiler``
    allows one session a process, so a capture asked for while another one
    (or a ``GORDO_TPU_PROFILE_DIR`` build) holds it answers that error at
    once instead of waiting."""
    from ..util import profiling

    seconds = min(max(float(seconds), 0.1), 30.0)
    out_dir = os.environ.get("GORDO_TPU_PROFILE_DIR")
    if not profiling.SESSION_LOCK.acquire(blocking=False):
        return {"error": "a torch.profiler session is already running in this process",
                "dir": out_dir}
    try:
        if not out_dir:
            import tempfile

            out_dir = tempfile.mkdtemp(prefix="gordo-device-trace-")
        from torch.profiler import profile

        target = os.path.join(out_dir, "device_trace")
        os.makedirs(target, exist_ok=True)
        with profile(activities=profiling.activities()) as prof:
            time.sleep(seconds)
        written = profiling.export(prof, os.path.join(
            target, f"trace_{os.getpid()}_{time.time_ns()}.json"))
    except Exception as exc:  # noqa: BLE001 — capture is advisory
        return {"error": str(exc), "dir": out_dir}
    finally:
        profiling.SESSION_LOCK.release()
    # this capture's own file, not the directory's earlier ones
    return {"dir": target, "files": 1, "bytes": written["bytes"], "seconds": seconds,
            "path": written["path"], "export_s": written["export_s"],
            "kernels": written["kernels"]}


# ---------------------------------------------------------------- snapshots
def snapshot(top: int = 30) -> Dict[str, Any]:
    """The steady sampler's accumulated view (for /debug/profile,
    /debug/flight and the sentinel's fire-time attachments)."""
    out = _steady.to_dict(top)
    out["hz"] = steady_hz()
    out["running"] = steady_running()
    out["threads"] = sorted(set(registered_threads().values()))
    return out


def top_stacks(n: int = 10) -> List[str]:
    """Top collapsed stacks from the steady counter (empty when the
    steady sampler never ran)."""
    return _steady.collapsed(top=n)


def steady_counter() -> StackCounter:
    return _steady


def reset() -> None:
    """Test hook: stop the sampler, drop every registration and sample."""
    stop_steady()
    with _lock:
        _threads.clear()
    _steady.reset()
