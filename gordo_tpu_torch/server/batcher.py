"""
Cross-model request batcher: many models' predicts, one device call. The
port's counterpart of ``gordo_tpu/server/batcher.py``, by the same names.

Concurrent predicts whose models share a ModelSpec (and padded input shape)
are stacked on a leading axis and run as ONE stacked forward
(``ops.nn.stacked_forward``) on parameters gathered from a device-resident
bank; the results fan back out to the waiting request threads. Each
Transformer block of a fused call launches the flash forward once for the
whole group, at BH = (windows summed over the group) x heads.

- Modes, ``GORDO_TPU_SERVING_BATCH``: ``auto`` (what ``run-server`` sets)
  runs a one-time measured A/B per spec at first use, direct predicts
  against batched submits under thread load (``GORDO_TPU_BATCH_AB_USERS``,
  ``_ROUNDS``, ``_HOSTWORK_MS``), and stands down for the spec where
  batching loses; ``1`` forces batching on; anything else is off.
  Every estimator's ``predict`` (models/models.py) goes through
  :func:`maybe_submit`, which returns None (predict direct) when batching
  is off or stood down.
- Scheduling is work-conserving: the dispatcher (a thread named
  ``gordo-batcher``) fuses whatever requests piled up while the previous
  call ran, at most ``GORDO_TPU_BATCH_MAX`` (64) of them;
  ``GORDO_TPU_BATCH_WINDOW_MS`` turns a timed collection window on.
- Window cap: a group is cut into fused calls of at most
  :data:`MAX_WINDOWS` windows (the padded windows summed over its
  requests; a request above the cap runs alone). A forward's device memory
  grows with its windows: ``transformer-ae-512`` peaks at 4.52 MiB a
  window in float32 and 2.27 MiB in bf16, a fused call as a direct predict
  (PERF.md, ``chip_smoke.py`` on an H100 80GB HBM3 at 700 W), so 16
  full-width requests (16,384 windows, ~72 GiB in float32) would not fit
  the card beside anything else. 8,192 windows is eight full-width
  requests, 36.2 GiB in float32; the cap holds for bf16 too, where a
  full-width call is already device-bound and a wider one gains nothing.
- Failures: a fused call that raises (a CUDA out-of-memory included) is
  bisected and its halves retried, down to a serial rescue of one request
  through its own model, bypassing the bank and the gather (``_execute``).
- Device pipeline, ``GORDO_TPU_DEVICE_PIPELINE`` (on unless 0): the drain
  of fused call N (waiting on its device-to-host copy, fanning out) runs
  after the staging and launch of call N+1. On the card each device holds
  one dispatcher stream: bank writes, the host-to-device copies out of
  pinned, double-buffered staging (``_stacked_inputs``; a buffer is
  refilled only after the event behind its last copy has completed), the
  forward and the device-to-host copy into pinned memory all run on it in
  order, and ``_drain_call`` waits on the event behind that copy. The
  results are the same bytes with the pipeline on or off.
- The JAX package pads the fuse width to 1/4/16/64 lanes and the bank's
  capacity to powers of two to bound its XLA compiles. The port compiles
  nothing, so a fused call has no padding lanes; the bank's capacity still
  grows in powers of two (floor 8) so that it restacks rarely.

- Telemetry, as the JAX batcher emits it: a submit waits inside a
  ``serve_batch_queue`` span and carries its trace context
  (``tracing.capture``) to the dispatcher, which records one
  ``serve_device_call`` span into every rider's trace, linked to the other
  riders, and one event into the global trace; the catalog's queue wait,
  fuse width, bisections, serial rescues, abandons, pipeline overlaps and
  the bank's restacks and evictions; ``gordo_server_device_flops_total``
  (``ops.flops.forward_flops_per_sample(spec)`` x each rider's own
  ``n_pad`` windows, summed over the riders); and
  ``gordo_server_device_busy_seconds_total``. On the card a host interval
  would time the queue, not the work (the dispatcher launches on its
  stream and drains later), so each fused forward is bracketed by two CUDA
  timing events on the dispatcher's stream (the first after the
  parameter gather, whose small launches the host paces: on an H100 its
  kernels sat up to 5 ms apart under 16 request threads,
  ``chip_smoke.py``'s observability phase), read only after the wait
  :meth:`_drain_call` already makes (no synchronisation is added), and
  unioned with the previous call's interval as the JAX ``_account_busy``
  does. Each reading spans two events a call or a gap apart (the call's
  own pair, and the previous call's end to this call's begin), never the
  process's lifetime, so the milliseconds CUDA reports in float32 stay
  exact however long the server runs; on the CPU, and for
  a serial rescue, the host clock times the call. ``device_call_stuck_s``
  (the watchdog's reading) stays on the host clock. The dispatcher
  registers itself with the sampling profiler as ``gordo-batcher``.

Not ported here: the resilience request scope, deadlines, breakers and
output check (A9), the fault sites (A10), and ``load_shipped``/``prelower``
with the AOT programs they install (A10). Tests read the plain attributes
beside the catalog: ``stats``, ``calls``, ``spec_calls`` (fused calls by
spec) and each bank's ``generation``, ``restacks`` and ``evictions``.
"""

import contextlib
import contextvars
import logging
import os
import select
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..observability import metrics as metric_catalog, profiler, telemetry, tracing
from ..ops.flops import forward_flops_per_sample
from ..ops.nn import stacked_forward
from ..ops.predict import pad_for_predict, predict_fn, predict_padded, unfold_windows

logger = logging.getLogger(__name__)

# the padded windows of one fused call (see the module docstring)
MAX_WINDOWS = 8192
# the spec fields of the parallel axes: a spec with any above 1 predicts direct
PARALLEL_FIELDS = ("tensor_parallel", "pipeline_parallel", "expert_parallel", "data_parallel")


def device_pipeline_enabled() -> bool:
    """``GORDO_TPU_DEVICE_PIPELINE`` (on unless 0, false or no): overlap the
    drain of fused call N with the staging and launch of call N+1."""
    return os.environ.get("GORDO_TPU_DEVICE_PIPELINE", "1").lower() not in ("0", "false", "no")


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


# the model a request names, set by the server around its predict: the
# batcher's spans and logs carry it (the JAX batcher reads it off its
# resilience request scope)
_request_model: "contextvars.ContextVar[str]" = contextvars.ContextVar(
    "gordo_tpu_torch_request_model", default="")


@contextlib.contextmanager
def request_model(name: str):
    """Name the model of the predicts made inside the block."""
    token = _request_model.set(name)
    try:
        yield
    finally:
        _request_model.reset(token)


def _spec_forward_flops(spec) -> float:
    """Analytic forward FLOPs a window for the achieved-FLOPs counter; 0.0
    when the spec walk fails (accounting must never fail a device call)."""
    try:
        return float(forward_flops_per_sample(spec))
    except Exception:  # noqa: BLE001
        return 0.0


@dataclass
class _Item:
    spec: Any
    model: Any  # a TransformerModel: its identity keys the bank
    X_pad: np.ndarray
    n_pad: int
    n_keep: int
    device: torch.device
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    # set by a waiter that gave up: the dispatcher skips the item
    abandoned: bool = False
    # when it was queued (host clock), its model's name and the trace
    # context captured at its enqueue (None outside a traced request)
    t_submit: float = 0.0
    tag: str = ""
    trace_ctx: Any = None


class _SubmitRing:
    """Wait-free submit channel, many producers and one dispatcher: a
    producer publishes with one ``deque.append`` (a single step under the
    interpreter lock) and writes to the dispatcher's eventfd only when it is
    parked; the dispatcher drains with ``popleft``, spins briefly (yielding
    the lock) when the channel runs dry, and only then parks on the fd.
    Bounded: a producer that finds ``capacity`` items queued sleeps and
    retries."""

    SPINS = 100

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._q: "deque" = deque()
        self._parked = False
        try:
            fd = os.eventfd(0, os.EFD_NONBLOCK)
            self._rfd = self._wfd = fd
        except (AttributeError, OSError):  # no eventfd: a pipe
            self._rfd, self._wfd = os.pipe()
            os.set_blocking(self._rfd, False)
        self._fds_open = True

    def put(self, item) -> None:
        q = self._q
        while len(q) >= self.capacity:
            time.sleep(0.0005)
        q.append(item)
        # the dispatcher looks at the deque again after raising its flag,
        # so it sees either this item or this poke: no wakeup is lost
        if self._parked:
            try:
                os.write(self._wfd, b"\x01\x00\x00\x00\x00\x00\x00\x00")
            except OSError:  # closed at shutdown
                pass

    def pop(self):
        try:
            return self._q.popleft()
        except IndexError:
            return None

    def pop_wait(self, timeout: Optional[float] = None):
        """One item, blocking: spin, then park on the fd. None only when a
        timeout was given and expired."""
        q = self._q
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return q.popleft()
            except IndexError:
                pass
            for _ in range(self.SPINS):
                time.sleep(0)
                try:
                    return q.popleft()
                except IndexError:
                    continue
            self._parked = True
            try:
                try:  # an item published before the flag went up
                    return q.popleft()
                except IndexError:
                    pass
                if deadline is None:
                    select.select([self._rfd], [], [])
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return self.pop()
                    select.select([self._rfd], [], [], remaining)
                try:
                    os.read(self._rfd, 65536)
                except (BlockingIOError, InterruptedError):
                    pass
            finally:
                self._parked = False

    def close(self) -> None:
        """Close the wakeup fd (once)."""
        if self._fds_open:
            self._fds_open = False
            for fd in {self._rfd, self._wfd}:
                os.close(fd)


# a waiter Event per submitting thread, reused; a waiter that abandons its
# item drops it (the dispatcher may still set it late) and the next submit
# starts a fresh one
_waiter_pool = threading.local()


def _checkout_waiter() -> threading.Event:
    waiter = getattr(_waiter_pool, "event", None)
    if waiter is None:
        waiter = threading.Event()
        _waiter_pool.event = waiter
    waiter.clear()
    return waiter


def _discard_waiter() -> None:
    _waiter_pool.event = None


# the timing event the dispatcher's fused call records once its parameters
# are gathered, where its forward begins (set only on the card)
_forward_begin = threading.local()


def _stacked_apply(spec, bank_params, idx: torch.Tensor, X: torch.Tensor, n_pad: int
                   ) -> torch.Tensor:
    """One fused call: gather ``len(idx)`` models' parameters out of the
    bank by slot (``index_select``), unfold each request's padded rows
    (B, rows, D) into (B, n_pad, L, D) windows on the device, and run the
    stacked forward: (B, n_pad, outputs) in float32. B is the group's own
    size: the JAX package pads it to 1/4/16/64 lanes only to bound its
    compiled programs, and the port compiles nothing. The forward's begin
    event (:data:`_forward_begin`) is recorded after the gather, whose
    small launches the host paces."""
    params = [{name: value.index_select(0, idx) for name, value in layer.items()}
              for layer in bank_params]
    begin = getattr(_forward_begin, "event", None)
    if begin is not None:
        begin.record()
    return stacked_forward(spec, params, unfold_windows(spec, X, n_pad))


def _single_apply(item: _Item) -> np.ndarray:
    """The serial-rescue rung: one request through its own model, without
    the bank and the gather (when those are what broke, the rescue must not
    share their fate)."""
    return predict_padded(item.model, item.X_pad, item.n_pad)


class _ParamBank:
    """Device-resident stacked float32 parameters of every model of one
    spec on one device: one dict per layer of (capacity, ...) tensors.

    A model's parameters are written into a slot at its first batched
    predict; after that a fused call ships only a slot index per request.
    Slots are keyed by the identity of the model, and the bank holds a
    reference to it so that the identity stays unique. Capacity grows in
    powers of two with a floor of 8 (a growth restacks the bank). At
    ``GORDO_TPU_PARAM_BANK_MAX`` models (default 512) the least recently
    used model is evicted in place: the newcomer's parameters overwrite its
    slot, one slot write, no restack, every other slot still valid.
    ``generation`` goes up at every eviction or replacement so that a
    caller resolving a group's slots can see that one went stale.

    Writes run in inference mode on ``stream`` (the dispatcher's, on the
    card), so they are ordered after the fused calls already launched
    there, which read the bank; they first wait for the device's default
    stream, where the models' parameters were made. Thread-safe."""

    MAX_MODELS = 512

    def __init__(self, device: torch.device, stream=None):
        self._lock = threading.Lock()
        self.device = device
        self.stream = stream
        self.slots: "OrderedDict[int, int]" = OrderedDict()  # id(model) -> slot, LRU first
        self.models: List[Any] = []
        self.stacked: Optional[List[Dict[str, torch.Tensor]]] = None
        self.capacity = 0
        self.generation = 0
        self.restacks = 0
        self.evictions = 0
        raw = os.environ.get("GORDO_TPU_PARAM_BANK_MAX", "")
        try:
            configured = int(raw) if raw.strip() else 0
        except ValueError:
            logger.warning("invalid GORDO_TPU_PARAM_BANK_MAX=%r; using %d", raw,
                           self.MAX_MODELS)
            configured = 0
        self.max_models = configured if configured > 0 else self.MAX_MODELS

    def __len__(self) -> int:
        with self._lock:
            return len(self.models)

    @contextlib.contextmanager
    def _writing(self):
        with torch.inference_mode():
            if self.stream is None:
                yield
                return
            self.stream.wait_stream(torch.cuda.default_stream(self.device))
            with torch.cuda.stream(self.stream):
                yield

    def slot_of(self, model) -> int:
        with self._lock:
            key = id(model)
            slot = self.slots.get(key)
            if slot is not None:
                self.slots.move_to_end(key)  # now the most recently used
                return slot
            if len(self.models) >= self.max_models:
                _victim, slot = self.slots.popitem(last=False)
                self.evictions += 1
                metric_catalog.PARAM_BANK_EVICTIONS.inc()
                self.generation += 1
                self.models[slot] = model  # drops the victim's reference
                self.slots[key] = slot
                self._write(slot, model)
                return slot
            slot = len(self.models)
            self.models.append(model)
            self.slots[key] = slot
            cap = 8
            while cap < len(self.models):
                cap <<= 1
            cap = min(cap, max(8, self.max_models))
            if cap == self.capacity:
                self._write(slot, model)
            else:
                self._restack(cap)
            return slot

    def replace(self, old_model, new_model) -> Optional[int]:
        """Overwrite ``old_model``'s slot in place with ``new_model``'s
        parameters (a revision's hot swap): no restack, no change of
        capacity. Returns the slot, or None when ``old_model`` is not in
        the bank."""
        with self._lock:
            slot = self.slots.pop(id(old_model), None)
            if slot is None:
                return None
            self.generation += 1
            self.models[slot] = new_model
            self.slots[id(new_model)] = slot  # the most recently used
            self._write(slot, new_model)
            return slot

    def _write(self, slot: int, model) -> None:
        with self._writing():
            for bank, layer in zip(self.stacked, model.layer_params):
                for name, value in layer.items():
                    bank[name][slot].copy_(value.detach())

    def _restack(self, cap: int) -> None:
        """Stack every model into a bank of ``cap`` slots (the slots past
        the last model repeat the first)."""
        models = self.models + [self.models[0]] * (cap - len(self.models))
        with self._writing():
            self.stacked = [
                {name: torch.stack([m.layer_params[i][name].detach() for m in models])
                 for name in layer}
                for i, layer in enumerate(self.models[0].layer_params)
            ]
        self.capacity = cap
        self.restacks += 1
        metric_catalog.PARAM_BANK_RESTACKS.inc()


@dataclass
class _Call:
    """A fused call launched and not yet drained: its host output lands
    behind ``done`` (None on the CPU, where the call has already run).
    ``t0`` is its launch on the host clock; on the card ``begin`` and
    ``end`` are the timing events around its forward on the dispatcher's
    stream."""

    spec: Any
    items: List[_Item]
    out: torch.Tensor
    done: Any
    windows: int
    t0: float = 0.0
    begin: Any = None
    end: Any = None


_STOP = object()


class CrossModelBatcher:
    """Collects concurrent predict submissions and runs each same-shape
    group as stacked device calls."""

    def __init__(self, window_ms: float = 0.0, max_batch: int = 64,
                 timeout_s: Optional[float] = None, self_ab: bool = False):
        self.window_s = window_ms / 1e3
        self.max_batch = max_batch
        if timeout_s is None:
            timeout_s = float(os.environ.get("GORDO_TPU_BATCH_TIMEOUT_S", "300"))
        self.timeout_s = timeout_s if timeout_s > 0 else None  # <= 0: no limit
        self._ring = _SubmitRing()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._banks: Dict[Tuple, _ParamBank] = {}
        self._streams: Dict[torch.device, Any] = {}
        # auto mode: the per-spec decision and the A/B's numbers
        self.self_ab = self_ab
        self._spec_on: Dict[Any, bool] = {}
        self._calibrating: set = set()
        self.calibrations: Dict[Any, dict] = {}
        self._abandon_logged: set = set()
        # per (padded shape, device): two pinned staging pairs and a toggle
        self._stack_buffers: Dict[Tuple, list] = {}
        self.stats = {"items": 0, "device_calls": 0, "largest_batch": 0,
                      "pipeline_overlaps": 0, "bisections": 0, "serial_rescues": 0,
                      "abandoned": 0, "windows": 0, "mixed_spec_calls": 0}
        # (fuse width, windows) of the latest fused calls
        self.calls: "deque[Tuple[int, int]]" = deque(maxlen=4096)
        # fused calls by spec; a call whose items span more than one spec
        # (which the grouping never makes) counts in "mixed_spec_calls"
        self.spec_calls: Dict[Any, int] = {}
        self._pipeline = device_pipeline_enabled()
        # the launch of the device call in flight (host clock; None between
        # calls), the end of the last busy interval on the host clock, and
        # per device the end event of the last busy interval on its stream
        self._busy_since: Optional[float] = None
        self._busy_end: Dict[Any, float] = {}
        self._busy_end_event: Dict[Any, Any] = {}

    def device_call_stuck_s(self) -> float:
        """Seconds the dispatcher has been inside its current device call
        (0.0 between calls), on the host clock: the watchdog's reading."""
        t0 = self._busy_since
        return 0.0 if t0 is None else max(0.0, time.monotonic() - t0)

    # ------------------------------------------------------------- public
    def decision_counts(self) -> Tuple[int, int]:
        """(specs batching, specs stood down) of the auto mode."""
        decisions = list(self._spec_on.values())
        on = sum(1 for d in decisions if d)
        return on, len(decisions) - on

    def bank(self, spec, device: torch.device) -> _ParamBank:
        """The parameter bank of ``spec`` on ``device``."""
        with self._lock:
            key = (spec, device)
            if key not in self._banks:
                self._banks[key] = _ParamBank(device, self._stream(device))
            return self._banks[key]

    def submit(self, spec, model, X) -> Optional[np.ndarray]:
        """Blocking predict through the batch queue (thread-safe). In auto
        mode, None when the A/B decided that batching loses for this spec:
        the caller then predicts direct."""
        if self.self_ab:
            decision = self._spec_on.get(spec)
            if decision is None:
                decision = self._calibrate(spec, model, X)
            if not decision:
                return None
        return self._force_submit(spec, model, X)

    def close(self) -> None:
        """Stop the dispatcher after the items already queued, and close
        the submit channel."""
        if self._thread is not None and self._thread.is_alive():
            self._ring.put(_STOP)
            self._thread.join(timeout=60)
        else:
            self._ring.close()

    # -------------------------------------------------------- calibration
    def _calibrate(self, spec, model, X) -> bool:
        """One-time measured A/B for this spec: the per-call p50 of direct
        predicts against batched submits, each from
        ``GORDO_TPU_BATCH_AB_USERS`` threads of ``_ROUNDS`` calls with
        ``_HOSTWORK_MS`` of interpreter-holding work between calls (standing
        in for the request's parse and encode), on the live input; both arms
        run once before timing. Records and returns whether batching won."""
        with self._lock:
            if spec in self._spec_on:
                return self._spec_on[spec]
            if spec in self._calibrating:
                return False  # another thread is measuring it: go direct once
            self._calibrating.add(spec)
        won: Optional[bool] = None
        try:
            users = max(1, int(os.environ.get("GORDO_TPU_BATCH_AB_USERS", "8")))
            rounds = max(1, int(os.environ.get("GORDO_TPU_BATCH_AB_ROUNDS", "4")))
            hostwork_s = float(os.environ.get("GORDO_TPU_BATCH_AB_HOSTWORK_MS", "2")) / 1e3
            direct = predict_fn(model)

            def host_work():
                deadline = time.monotonic() + hostwork_s
                while time.monotonic() < deadline:
                    pass

            def drive(fn) -> float:
                """Median per-call latency over ``users`` threads."""
                errors: List[BaseException] = []
                times: List[float] = []
                lock = threading.Lock()

                def worker():
                    try:
                        for r in range(rounds):
                            if r:
                                host_work()
                            t0 = time.monotonic()
                            fn()
                            elapsed = time.monotonic() - t0
                            with lock:
                                times.append(elapsed)
                    except BaseException as exc:  # noqa: BLE001 -- raised below
                        errors.append(exc)

                threads = [threading.Thread(target=worker) for _ in range(users)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                if errors:
                    raise errors[0]
                times.sort()
                return times[len(times) // 2]

            direct(X)
            self._force_submit(spec, model, X)
            drive(lambda: self._force_submit(spec, model, X))
            p50_direct = drive(lambda: direct(X))
            p50_batched = drive(lambda: self._force_submit(spec, model, X))
            won = p50_batched < p50_direct
            self.calibrations[spec] = {"users": users, "rounds": rounds,
                                       "p50_direct_ms": 1e3 * p50_direct,
                                       "p50_batched_ms": 1e3 * p50_batched, "batching": won}
            logger.info(
                "serving batcher self-A/B (lookback %d, %d users x %d rounds): per-call p50 "
                "direct %.2fms, batched %.2fms -> batching %s", spec.lookback_window, users,
                rounds, 1e3 * p50_direct, 1e3 * p50_batched,
                "ON" if won else "OFF (stood down: the fused call loses to direct predicts)",
            )
        except Exception as exc:  # noqa: BLE001 -- a failed A/B stands down, never 500s
            logger.warning("batcher self-A/B failed (%s); standing down", exc)
            won = False
        finally:
            # the decision and the discard under one lock: no second A/B in
            # between; an interrupt records nothing and the next submit retries
            with self._lock:
                if won is not None:
                    self._spec_on[spec] = won
                self._calibrating.discard(spec)
        return won

    def _force_submit(self, spec, model, X) -> np.ndarray:
        """``submit`` without the auto gate. A waiter that times out
        (``GORDO_TPU_BATCH_TIMEOUT_S``) marks its item abandoned, and the
        dispatcher skips it."""
        X_pad, n_pad, n_keep = pad_for_predict(spec, X)
        item = _Item(spec, model, X_pad, n_pad, n_keep, _device_of(model),
                     done=_checkout_waiter(), t_submit=time.monotonic(),
                     tag=_request_model.get())
        self._ensure_thread()
        # the queue span covers enqueue to fan-out; the context captured
        # inside it is where the dispatcher parents the device-call span
        with telemetry.span("serve_batch_queue", model=item.tag):
            item.trace_ctx = tracing.capture()
            self._ring.put(item)
            if not item.done.wait(timeout=self.timeout_s):
                item.abandoned = True
                _discard_waiter()  # a late set() lands on an orphan Event
                self._record_abandoned(item)
                raise TimeoutError(f"batched predict timed out after {self.timeout_s:.0f}s")
        if item.error is not None:
            raise item.error
        return item.result

    def _record_abandoned(self, item: _Item) -> None:
        """Count one abandoned item; log once per (spec, shape)."""
        key = (item.spec, item.X_pad.shape)
        metric_catalog.BATCHER_ABANDONED.inc()
        with self._lock:
            self.stats["abandoned"] += 1
            if key in self._abandon_logged:
                return
            self._abandon_logged.add(key)
        logger.warning("batched predict abandoned by its waiter (padded shape %s); further "
                       "abandons of this (spec, shape) are counted, not logged",
                       item.X_pad.shape)

    # ------------------------------------------------------------ worker
    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._loop, daemon=True,
                                                name="gordo-batcher")
                self._thread.start()

    def _stream(self, device: torch.device):
        """The dispatcher's stream on a CUDA device (None on the CPU)."""
        if device.type != "cuda":
            return None
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def _loop(self) -> None:
        # inference mode is thread-local: entered here, in the thread that
        # makes the device calls
        profiler.register_thread("gordo-batcher")
        with torch.inference_mode():
            self._dispatch_until_stopped()

    def _dispatch_until_stopped(self) -> None:
        # the call launched but not yet drained (pipeline depth 1, matching
        # the two staging buffers)
        pending: List[_Call] = []
        while True:
            if pending:
                nxt = self._ring.pop()
                if nxt is None:
                    # nothing queued behind the call in flight: settle it now
                    for call in pending:
                        self._drain_call(call)
                    pending = []
                    self._busy_since = None
                    continue
                batch = [nxt]
            else:
                batch = [self._ring.pop_wait()]
            if self.window_s > 0:
                deadline = time.monotonic() + self.window_s
                while len(batch) < self.max_batch and batch[-1] is not _STOP:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    nxt = self._ring.pop_wait(timeout=remaining)
                    if nxt is None:
                        break
                    batch.append(nxt)
            else:
                # work-conserving: exactly the requests that piled up
                while len(batch) < self.max_batch and batch[-1] is not _STOP:
                    nxt = self._ring.pop()
                    if nxt is None:
                        break
                    batch.append(nxt)
            stop = batch[-1] is _STOP
            if stop:
                batch.pop()
            if not self._pipeline or self.window_s > 0:
                self._run(batch)
            else:
                # launch the new batch first, then drain the previous call:
                # its wait and fan-out overlap the new call on the device
                launched = self._run_async(batch)
                overlapped = len(launched) if pending else len(launched) - 1
                if overlapped > 0:
                    self.stats["pipeline_overlaps"] += overlapped
                    metric_catalog.DEVICE_PIPELINE_OVERLAPS.inc(overlapped)
                for call in pending + launched[:-1]:
                    self._drain_call(call)
                pending = launched[-1:]
                # the watchdog's reading follows whatever is still in flight
                self._busy_since = pending[0].t0 if pending else None
            if stop:
                for call in pending:
                    self._drain_call(call)
                self._ring.close()
                return

    def _groups(self, batch: List[_Item]) -> List[Tuple[Any, List[_Item]]]:
        """The batch by (spec, device, padded shape), each group cut into
        consecutive runs of at most :data:`MAX_WINDOWS` windows."""
        groups: Dict[Tuple, List[_Item]] = {}
        for item in batch:
            groups.setdefault((item.spec, item.device, item.X_pad.shape), []).append(item)
        runs = []
        for (spec, _device, _shape), items in groups.items():
            run, windows = [], 0
            for item in items:
                if run and windows + item.n_pad > MAX_WINDOWS:
                    runs.append((spec, run))
                    run, windows = [], 0
                run.append(item)
                windows += item.n_pad
            runs.append((spec, run))
        return runs

    @staticmethod
    def _observe_group(items: List[_Item]) -> None:
        """How long each rider queued before its fused call, and the call's
        fuse width."""
        now = time.monotonic()
        for item in items:
            metric_catalog.BATCHER_QUEUE_WAIT_SECONDS.observe(max(0.0, now - item.t_submit))
        metric_catalog.BATCHER_FUSE_WIDTH.observe(len(items))

    def _run(self, batch: List[_Item]) -> None:
        for spec, items in self._groups(batch):
            self._observe_group(items)
            self._run_group(spec, items)

    def _run_group(self, spec, items: List[_Item]) -> None:
        try:
            self._execute(spec, items)
        except BaseException as exc:  # noqa: BLE001 -- fanned out to the waiters
            for item in items:
                item.error = exc
                item.done.set()

    def _execute(self, spec, items: List[_Item]) -> None:
        """Run the fused call; on a failure bisect and retry the halves,
        down to a serial rescue of each request: one poisoned request fails
        alone, never its cohort."""
        try:
            self._device_call(spec, items)
        except Exception as exc:  # noqa: BLE001 -- the ladder, then the waiters
            if len(items) == 1:
                self._serial_rescue(items[0], exc)
                return
            self.stats["bisections"] += 1
            metric_catalog.GROUP_BISECTIONS.inc()
            logger.warning("fused device call over %d predicts failed (%s: %s); bisecting",
                           len(items), type(exc).__name__, exc)
            mid = len(items) // 2
            self._execute(spec, items[:mid])
            self._execute(spec, items[mid:])

    def _device_call(self, spec, items: List[_Item]) -> None:
        """The strict-serial device call: launch, wait, fan out; raises on
        any failure (the ladder takes it)."""
        try:
            call = self._device_dispatch(spec, items)
            if call is not None:
                self._finish(call)
        finally:
            self._busy_since = None

    # -------------------------------------------- pipelined device path
    def _run_async(self, batch: List[_Item]) -> List[_Call]:
        """Group a batch and launch each group without draining it. A group
        that fails at launch (nothing computed yet) takes the strict-serial
        ladder instead."""
        calls = []
        for spec, items in self._groups(batch):
            self._observe_group(items)
            try:
                call = self._device_dispatch(spec, items)
            except Exception as exc:  # noqa: BLE001 -- the ladder takes it
                logger.warning("pipelined launch over %d predicts failed (%s: %s); "
                               "re-running strict-serial", len(items), type(exc).__name__, exc)
                self._run_group(spec, items)
                continue
            if call is not None:
                calls.append(call)
        return calls

    def _device_dispatch(self, spec, items: List[_Item]) -> Optional[_Call]:
        """Resolve bank slots, stage the inputs, launch the fused call and
        the copy of its output to pinned host memory, on the dispatcher's
        stream; returns before the device is done (None when every rider
        was abandoned)."""
        items = [it for it in items if not it.abandoned]
        if not items:
            return None
        device = items[0].device
        bank = self.bank(spec, device)
        if len({id(it.model) for it in items}) > bank.max_models:
            raise RuntimeError(f"fused group of {len(items)} spans more distinct models than "
                               f"the parameter bank holds ({bank.max_models}); bisecting")
        gen = bank.generation
        slots = [bank.slot_of(it.model) for it in items]
        if bank.generation != gen:
            # an eviction or replacement during resolution: resolve once more,
            # and fail into the ladder if the bank churns again
            gen = bank.generation
            slots = [bank.slot_of(it.model) for it in items]
            if bank.generation != gen:
                raise RuntimeError("parameter bank churned twice during slot resolution")
        stream = bank.stream
        windows = items[0].n_pad * len(items)
        t0 = time.monotonic()
        self._busy_since = t0
        with contextlib.nullcontext() if stream is None else torch.cuda.stream(stream):
            X, idx = self._stacked_inputs(items, slots, device)
            if stream is None:
                out = _stacked_apply(spec, bank.stacked, idx, X, items[0].n_pad)
                return _Call(spec, items, out, None, windows, t0)
            # the forward's interval on the stream, for the busy seconds
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            _forward_begin.event = begin
            try:
                out = _stacked_apply(spec, bank.stacked, idx, X, items[0].n_pad)
            finally:
                _forward_begin.event = None
            end.record(stream)
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return _Call(spec, items, host, done, windows, t0, begin, end)

    def _stacked_inputs(self, items: List[_Item], slots: List[int], device: torch.device
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The group's padded rows (B, rows, D) and slots (B,) on the
        device. On the card they go through pinned staging buffers per
        padded shape, two of each, used in turn; a buffer is refilled only
        after the event recorded behind its last host-to-device copy has
        completed, so two consecutive calls can overlap."""
        n = len(items)
        if device.type != "cuda":
            return (torch.from_numpy(np.stack([it.X_pad for it in items])),
                    torch.tensor(slots, dtype=torch.long))
        sample = items[0].X_pad
        key = (sample.shape, device)
        entry = self._stack_buffers.get(key)
        if entry is None:
            if len(self._stack_buffers) >= 64:  # bounded under a pathological shape mix
                self._stack_buffers.clear()
            entry = [[torch.empty((self.max_batch,) + sample.shape, dtype=torch.float32,
                                  pin_memory=True),
                      torch.empty(self.max_batch, dtype=torch.long, pin_memory=True), None]
                     for _ in range(2)] + [0]
            self._stack_buffers[key] = entry
        toggle = entry[2]
        entry[2] = 1 - toggle
        X_host, idx_host, copied = entry[toggle]
        if copied is not None:
            copied.synchronize()
        staged = X_host.numpy()
        for i, item in enumerate(items):
            staged[i] = item.X_pad
        idx_host.numpy()[:n] = slots
        X = X_host[:n].to(device, non_blocking=True)
        idx = idx_host[:n].to(device, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        entry[toggle][2] = copied
        return X, idx

    def _account_busy(self, clock, start: float, end: float) -> None:
        """Busy seconds of one call's interval on ``clock`` (the host's, in
        seconds of ``time.monotonic``), unioned against that clock's previous interval:
        overlapping calls must not count twice, or the duty cycle would read
        above 1."""
        start = max(start, self._busy_end.get(clock, start))
        if end > start:
            metric_catalog.DEVICE_BUSY_SECONDS.inc(end - start)
        self._busy_end[clock] = max(end, self._busy_end.get(clock, end))

    def _account_events(self, clock, begin, end) -> None:
        """Busy seconds of one call's interval between two completed timing
        events on ``clock``'s stream, unioned against the end event of that
        stream's previous interval as :meth:`_account_busy` unions host
        times. Only the call's own length and its offset from the previous
        end are read: both are short next to the process's lifetime."""
        length = begin.elapsed_time(end) / 1e3
        prev = self._busy_end_event.get(clock)
        offset = 0.0 if prev is None else prev.elapsed_time(begin) / 1e3
        # the interval is [offset, offset + length] past the previous end
        if offset + length > max(offset, 0.0):
            metric_catalog.DEVICE_BUSY_SECONDS.inc(offset + length - max(offset, 0.0))
        if prev is None or offset + length > 0.0:
            self._busy_end_event[clock] = end

    def _account_call(self, call: _Call) -> None:
        """The busy seconds of a drained call: its forward's interval between
        the CUDA events on the dispatcher's stream (both have completed:
        they precede the copy ``done`` waits for); on the CPU, its launch
        to now."""
        if call.begin is None:
            self._account_busy("host", call.t0, time.monotonic())
            return
        self._account_events(call.items[0].device, call.begin, call.end)

    def _emit_device_span(self, items: List[_Item], t0: float,
                          error: Optional[BaseException] = None, rescue: bool = False) -> None:
        """Record the finished device call as a span in every rider's trace
        (parented at that rider's enqueue point, linked to the co-fused
        riders), and one event into the global trace buffer. The dispatcher
        holds no request context, hence the explicit fan-out."""
        duration = time.monotonic() - t0
        attrs: Dict[str, Any] = {"fused": len(items)}
        if rescue:
            attrs["rescue"] = 1
        if error is not None:
            attrs["error"] = type(error).__name__
        telemetry.add_trace_event("serve_device_call", t0, duration, **attrs)
        riders = [it for it in items if it.trace_ctx is not None]
        for item in riders:
            links = [(other.trace_ctx.trace_id, other.trace_ctx.span_id or "")
                     for other in riders if other is not item]
            tracing.record_into(item.trace_ctx, "serve_device_call", t0, duration,
                                links=links, model=item.tag, **attrs)

    def _finish(self, call: _Call) -> None:
        """Wait for a call's host output and fan it out; raises if the
        device call failed."""
        if call.done is not None:
            call.done.synchronize()
        self._account_call(call)
        # recorded before the fan-out: a rider resuming at its event must
        # already find the device-call span in its trace
        self._emit_device_span(call.items, call.t0)
        metric_catalog.DEVICE_FLOPS.inc(
            _spec_forward_flops(call.spec) * float(sum(item.n_pad for item in call.items)))
        out = call.out.numpy()
        n = len(call.items)
        self.stats["items"] += n
        self.stats["device_calls"] += 1
        self.stats["windows"] += call.windows
        self.stats["largest_batch"] = max(self.stats["largest_batch"], n)
        self.calls.append((n, call.windows))
        self.spec_calls[call.spec] = self.spec_calls.get(call.spec, 0) + 1
        if any(item.spec != call.spec for item in call.items):
            self.stats["mixed_spec_calls"] += 1
        for i, item in enumerate(call.items):
            item.result = out[i, : item.n_keep]
            item.done.set()

    def _drain_call(self, call: _Call) -> None:
        """The pipelined drain: :meth:`_finish`, and on a failure the whole
        group again through the strict-serial ladder (its results never
        left the device)."""
        try:
            self._finish(call)
        except Exception as exc:  # noqa: BLE001 -- the ladder takes it
            self._emit_device_span(call.items, call.t0, error=exc)
            logger.warning("pipelined fused call over %d predicts failed at drain (%s: %s); "
                           "re-running strict-serial", len(call.items), type(exc).__name__, exc)
            self._run_group(call.spec, call.items)

    def _serial_rescue(self, item: _Item, group_exc: BaseException) -> None:
        """The last rung: one request through its own model. Its failure
        lands on it alone."""
        if item.abandoned:
            return
        self.stats["serial_rescues"] += 1
        metric_catalog.GROUP_SERIAL_RESCUES.inc()
        t0 = time.monotonic()
        self._busy_since = t0
        try:
            item.result = _single_apply(item)[: item.n_keep]
        except Exception as exc:  # noqa: BLE001 -- this item's error
            logger.warning("serial rescue failed (group error %s: %s): %s",
                           type(group_exc).__name__, group_exc, exc)
            item.error = exc
        finally:
            # a synchronous predict on the model's own stream: the host clock
            self._busy_since = None
            self._account_busy("host", t0, time.monotonic())
        self._emit_device_span([item], t0, error=item.error, rescue=True)
        if item.error is None:
            metric_catalog.DEVICE_FLOPS.inc(_spec_forward_flops(item.spec) * float(item.n_pad))
        item.done.set()


# ------------------------------------------------------------ global switch
_batcher: Optional[CrossModelBatcher] = None
_batcher_lock = threading.Lock()


def peek_batcher() -> Optional[CrossModelBatcher]:
    """The process batcher if one exists; never creates one."""
    return _batcher


def get_batcher() -> Optional[CrossModelBatcher]:
    """The process batcher, made at first use when ``GORDO_TPU_SERVING_BATCH``
    is ``auto`` (on, with the per-spec A/B) or ``1``/``true``/``yes``
    (forced on); None otherwise."""
    global _batcher
    if _batcher is not None:
        return _batcher
    mode = os.environ.get("GORDO_TPU_SERVING_BATCH", "").lower()
    if mode not in ("1", "true", "yes", "auto"):
        return None
    with _batcher_lock:
        if _batcher is None:
            window_ms = float(os.environ.get("GORDO_TPU_BATCH_WINDOW_MS", "0"))
            max_batch = int(os.environ.get("GORDO_TPU_BATCH_MAX", "64"))
            _batcher = CrossModelBatcher(window_ms, max_batch, self_ab=mode == "auto")
            logger.info("cross-model batcher on (window %.1fms, max %d, self-A/B %s)",
                        window_ms, max_batch, "on" if mode == "auto" else "off")
    return _batcher


def reset_batcher() -> None:
    """Stop and drop the process batcher; the next :func:`get_batcher`
    reads the environment again."""
    global _batcher
    with _batcher_lock:
        batcher, _batcher = _batcher, None
    if batcher is not None:
        batcher.close()


def maybe_submit(spec, model, X) -> Optional[np.ndarray]:
    """Predict through the batcher when it is on; None means predict
    direct. The dispatcher thread never re-enters the queue (a predict made
    inside another would deadlock), and specs that cannot run stacked go
    direct, as in the JAX package: ring attention, and any parallel axis
    above 1."""
    batcher = get_batcher()
    if batcher is None:
        return None
    if threading.current_thread().name == "gordo-batcher":
        return None
    if any(getattr(layer, "attention_impl", None) == "ring" for layer in spec.layers):
        return None
    if any(int(getattr(spec, name, 0) or 0) > 1 for name in PARALLEL_FIELDS):
        return None
    return batcher.submit(spec, model, X)
