"""
Log-bucketed latency histograms (HDR-histogram style) for tail percentiles:
the port's copy of ``gordo_tpu/observability/latency.py``, whose
``to_dict`` payloads load in either package.

The telemetry spine's ``telemetry.histogram`` uses a fixed, coarse bucket
ladder — right for Prometheus exposition, useless for "what is p99.9 to
three digits". This module is the measurement-grade complement: each power
of two of the value range is split into ``subbuckets`` linear sub-buckets,
so every recorded value lands in a bucket whose width is at most
``1/subbuckets`` of the value itself. Quantiles read back from bucket
midpoints are therefore exact to a *relative* error bound of
``1/(2*subbuckets)`` (~0.8% at the default 64) across the whole dynamic
range — nanoseconds to hours — with O(1) record cost and a few KB of
memory, where a sorted-array percentile would retain every sample.

Built for load harnesses and the SLO windows (slo.py):

- **mergeable**: worker threads each record into their own histogram with
  zero contention and ``merge`` folds them associatively afterwards; a
  bench section child can ship its histogram across a process boundary as
  JSON (``to_dict``/``from_dict``) for the parent to merge.
- **coordinated-omission aware**: ``record_with_expected_interval``
  back-fills the latencies a stalled server *prevented from being
  measured* (the HdrHistogram correction): a closed-loop client that
  freezes for a second at 100 QPS failed to issue ~100 requests that
  would each have seen up to a second of queueing — dropping them hides
  the stall from p99 instead of reporting it. The open-loop generator
  measures from *intended* send time instead, which needs no correction;
  this method is for closed-loop callers.

Thread-safe throughout; ``record`` takes one lock, so prefer
per-thread instances + ``merge`` on hot paths.
"""

import math
import threading
from typing import Dict, Iterable, Optional, Sequence

DEFAULT_SUBBUCKETS = 64

# values are clamped into this range: latencies are positive and finite by
# construction, and a NaN/inf/negative slipping in must corrupt one bucket,
# not the index math
_MIN_VALUE = 1e-9
_MAX_VALUE = 1e9

# expected-interval back-fill is bounded: a pathological (value, interval)
# pair must not spin the recording thread (1e4 synthetic samples already
# saturate any quantile this module exports)
_MAX_BACKFILL = 10_000

_QUANTILES = (0.50, 0.90, 0.99, 0.999)

# per-histogram exemplar reservoir bound: enough to cover every occupied
# bucket of a realistic latency distribution; when full, smaller-indexed
# (faster) buckets are evicted first so the tail keeps its trace links
_MAX_EXEMPLARS = 64


class LatencyHistogram:
    """Sparse log-bucketed histogram of positive values (seconds)."""

    __slots__ = ("subbuckets", "_lock", "_buckets", "_count", "_sum",
                 "_min", "_max", "_exemplars")

    def __init__(self, subbuckets: int = DEFAULT_SUBBUCKETS):
        if subbuckets < 2:
            raise ValueError("subbuckets must be >= 2")
        self.subbuckets = int(subbuckets)
        self._lock = threading.Lock()
        self._buckets: Dict[int, int] = {}
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = 0.0
        # bucket index -> (trace_id, value): the latest traced sample seen
        # per bucket, so a tail bucket links to a real, recent trace; the
        # dict is bounded to _MAX_EXEMPLARS entries (tail buckets win)
        self._exemplars: Dict[int, tuple] = {}

    # ------------------------------------------------------------- indexing
    def _index(self, value: float) -> int:
        """Bucket index of ``value``: ``exponent * subbuckets + linear
        sub-bucket of the mantissa``. Uniquely decodable by ``divmod``
        because the sub-bucket is always in ``[0, subbuckets)``."""
        mantissa, exponent = math.frexp(value)  # value = m * 2**e, m in [0.5, 1)
        sub = int((mantissa * 2.0 - 1.0) * self.subbuckets)
        if sub >= self.subbuckets:  # fp edge: mantissa rounding at 1.0
            sub = self.subbuckets - 1
        return exponent * self.subbuckets + sub

    def _bounds(self, index: int):
        exponent, sub = divmod(index, self.subbuckets)
        low = math.ldexp(0.5 * (1.0 + sub / self.subbuckets), exponent)
        high = math.ldexp(0.5 * (1.0 + (sub + 1) / self.subbuckets), exponent)
        return low, high

    # ------------------------------------------------------------ recording
    def record(self, value: float, trace_id: Optional[str] = None) -> None:
        """Record one value (seconds). Non-finite / non-positive values are
        clamped to the range edge rather than raising: one bad sample in a
        million-request load run must not kill the run. ``trace_id`` (when
        the caller has one) becomes the bucket's exemplar — latest wins, so
        an exemplar always names a trace recent enough to still resolve."""
        if not (value > _MIN_VALUE):  # False for NaN too
            value = _MIN_VALUE
        elif value > _MAX_VALUE:
            value = _MAX_VALUE
        index = self._index(value)
        with self._lock:
            self._buckets[index] = self._buckets.get(index, 0) + 1
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value
            if trace_id:
                self._note_exemplar(index, trace_id, value)

    def _note_exemplar(self, index: int, trace_id: str, value: float) -> None:
        """Store ``(trace_id, value)`` for ``index``; caller holds the
        lock. Over the cap, the smallest (fastest) exemplared bucket is
        evicted — the slow tail is what exemplars exist to explain."""
        if index not in self._exemplars and \
                len(self._exemplars) >= _MAX_EXEMPLARS:
            evict = min(self._exemplars)
            if evict >= index:
                return
            del self._exemplars[evict]
        self._exemplars[index] = (trace_id, value)

    def exemplars(self) -> Dict[int, tuple]:
        """{bucket index: (trace_id, value)} — a snapshot."""
        with self._lock:
            return dict(self._exemplars)

    def record_with_expected_interval(
        self, value: float, expected_interval: Optional[float],
        trace_id: Optional[str] = None,
    ) -> None:
        """HdrHistogram's coordinated-omission correction for CLOSED-loop
        measurement: record ``value``, then back-fill ``value - k *
        expected_interval`` for k=1.. while positive — the latencies of the
        requests the client *should* have issued while this one stalled the
        loop. A server that freezes now inflates p99 instead of hiding it.
        Only the real sample carries the exemplar ``trace_id`` — the
        back-filled ones are synthetic and have no trace."""
        self.record(value, trace_id)
        if not expected_interval or expected_interval <= 0:
            return
        backfill = value - expected_interval
        steps = 0
        while backfill > 0 and steps < _MAX_BACKFILL:
            self.record(backfill)
            backfill -= expected_interval
            steps += 1

    # -------------------------------------------------------------- merging
    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other`` into self (associative and commutative up to fp
        addition order in ``sum``); returns self for chaining. Histograms
        with different ``subbuckets`` do not share an index space."""
        if other.subbuckets != self.subbuckets:
            raise ValueError(
                f"cannot merge subbuckets={other.subbuckets} "
                f"into subbuckets={self.subbuckets}"
            )
        with other._lock:
            buckets = dict(other._buckets)
            count, total = other._count, other._sum
            low, high = other._min, other._max
            exemplars = dict(other._exemplars)
        with self._lock:
            for index, n in buckets.items():
                self._buckets[index] = self._buckets.get(index, 0) + n
            self._count += count
            self._sum += total
            if low < self._min:
                self._min = low
            if high > self._max:
                self._max = high
            for index, (trace_id, value) in exemplars.items():
                self._note_exemplar(index, trace_id, value)
        return self

    @classmethod
    def merged(
        cls, histograms: Iterable["LatencyHistogram"],
        subbuckets: int = DEFAULT_SUBBUCKETS,
    ) -> "LatencyHistogram":
        out = cls(subbuckets)
        for histogram in histograms:
            out.merge(histogram)
        return out

    # ------------------------------------------------------------ quantiles
    @property
    def count(self) -> int:
        return self._count

    @property
    def error_bound(self) -> float:
        """Worst-case relative error of any reported quantile."""
        return 0.5 / self.subbuckets

    def quantile(self, q: float) -> Optional[float]:
        """Value at quantile ``q`` in [0, 1] (midpoint of the covering
        bucket, clamped to the exactly-tracked min/max), or None when
        empty."""
        with self._lock:
            if self._count == 0:
                return None
            if q <= 0.0:
                return self._min
            if q >= 1.0:
                return self._max
            rank = max(1, math.ceil(q * self._count))
            seen = 0
            for index in sorted(self._buckets):
                seen += self._buckets[index]
                if seen >= rank:
                    low, high = self._bounds(index)
                    mid = 0.5 * (low + high)
                    return min(max(mid, self._min), self._max)
            return self._max  # unreachable unless counts drifted

    def percentiles(
        self, qs: Sequence[float] = _QUANTILES
    ) -> Dict[str, Optional[float]]:
        """{"p50": ..., "p99.9": ...} in seconds (None when empty)."""
        out = {}
        for q in qs:
            label = f"{q * 100:g}"
            out[f"p{label}"] = self.quantile(q)
        return out

    def summary(self) -> Dict[str, object]:
        """Everything a report line needs, in seconds."""
        with self._lock:
            count, total = self._count, self._sum
            low = self._min if self._count else None
            high = self._max if self._count else None
        out: Dict[str, object] = {
            "count": count,
            "mean_s": (total / count) if count else None,
            "min_s": low,
            "max_s": high,
            "rel_error_bound": self.error_bound,
        }
        for label, value in self.percentiles().items():
            out[f"{label}_s"] = value
        return out

    # -------------------------------------------------------- serialization
    def to_dict(self) -> Dict[str, object]:
        """JSON-safe snapshot a child process can print and a parent can
        ``from_dict`` + ``merge`` (bucket keys stringified for JSON)."""
        with self._lock:
            payload: Dict[str, object] = {
                "subbuckets": self.subbuckets,
                "count": self._count,
                "sum": self._sum,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
                "buckets": {str(k): v for k, v in self._buckets.items()},
            }
            if self._exemplars:
                payload["exemplars"] = {
                    str(k): [trace_id, value]
                    for k, (trace_id, value) in self._exemplars.items()
                }
            return payload

    @classmethod
    def from_dict(cls, payload: Dict[str, object]) -> "LatencyHistogram":
        out = cls(int(payload.get("subbuckets", DEFAULT_SUBBUCKETS)))
        buckets = payload.get("buckets") or {}
        out._buckets = {int(k): int(v) for k, v in buckets.items()}
        out._count = int(payload.get("count", 0))
        out._sum = float(payload.get("sum", 0.0))
        minimum = payload.get("min")
        maximum = payload.get("max")
        out._min = float(minimum) if minimum is not None else math.inf
        out._max = float(maximum) if maximum is not None else 0.0
        # optional since the exemplar plane landed: payloads from older
        # writers simply carry none
        for key, entry in (payload.get("exemplars") or {}).items():
            try:
                out._exemplars[int(key)] = (str(entry[0]), float(entry[1]))
            except (TypeError, ValueError, IndexError):
                continue
        return out
