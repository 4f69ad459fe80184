"""
Cross-process telemetry aggregation without prometheus_client: the port's
copy of ``gordo_tpu/observability/shared.py``, whose shards and fleet text
it reads and writes the same way.

The telemetry spine (:mod:`.telemetry`) is process-local by design: under
a prefork serving pool each worker owns its registry, so a ``/metrics``
scrape (or ``/debug/vars``) answered by one worker shows that worker's
numbers only. The port serves from one process until ROADMAP.md's A9 ports
the worker pool, but the shard view is already what ``/metrics`` serves
without ``ENABLE_PROMETHEUS``, and the SLO and device samplers register on
it (slo.py, device.py).

This module is the dependency-free fleet view. Each process with
``GORDO_TPU_TELEMETRY_DIR`` set maintains one **shard**: a small
mmap-backed file (``telemetry_<pid>.shard``) holding a seqlock-framed JSON
snapshot of its registry (plus any registered extra payloads, e.g. the SLO
windows). Writers overwrite the single slot in place under a version
counter — bumped odd before the write, even after — so a reader that maps
a half-written slot sees an odd version (or a length/JSON mismatch) and
skips the shard instead of consuming torn bytes. A worker killed mid-write
therefore degrades to "one stale scrape interval", never to corrupt fleet
numbers.

Shard lifecycle: a serving arbiter calls :func:`mark_shard_dead` from its
reaper when a worker exits, so dead pids do not haunt the fleet view
(their last counters would otherwise be summed forever).

Merge semantics (associative, order-independent):

- **counters** are summed across shards;
- **gauges** are exported per-worker (an extra ``worker="<pid>"`` label)
  *plus* one aggregate series without the worker label — summed by
  default, max-merged for ratio/state/high-water gauges
  (:data:`GAUGE_MAX_MERGE`), where summing across workers would be a lie;
- **telemetry histograms** merge by element-wise bucket-count addition
  (the catalog is single-source, so ladders agree by construction);
- **latency.py histograms** shipped inside extra payloads merge through
  their existing associative :meth:`LatencyHistogram.merge`.

The renderer (:func:`render_fleet_text`) emits Prometheus text exposition
0.0.4 plus a ``gordo_server_fleet_workers`` gauge so operators can see how
many shards answered. Everything here is best-effort: a missing dir, a
torn shard, or an unserializable extra must never take down serving.
"""

import json
import mmap
import os
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import telemetry
from .telemetry import (
    MAX_EXEMPLARS_PER_FAMILY,
    _format_exemplar,
    _format_float,
    _render_labels,
)

ENV_DIR = "GORDO_TPU_TELEMETRY_DIR"
ENV_FLUSH_S = "GORDO_TPU_TELEMETRY_FLUSH_S"

SHARD_PREFIX = "telemetry_"
SHARD_SUFFIX = ".shard"

# slot header: magic, seqlock version (odd = write in progress), payload len
_MAGIC = b"GTSH"
_HEADER = struct.Struct("=4sQQ")
_SLAB_STEP = 64 * 1024  # shards grow in 64KiB steps

# gauges whose fleet aggregate is a max, not a sum: ratios, enum states,
# and high-water marks — summing 3 workers' busy_ratio=0.9 into 2.7 is a lie
GAUGE_MAX_MERGE = frozenset({
    "gordo_server_breaker_state",
    "gordo_server_device_busy_ratio",
    "gordo_server_device_mfu",
    "gordo_server_param_bank_occupancy",
    "gordo_server_slo_p99_ms",
    "gordo_server_slo_error_burn_rate",
    "gordo_server_slo_latency_burn_rate",
    "gordo_server_fleet_workers",
    "gordo_build_xla_persistent_cache_entries",
    "gordo_build_xla_persistent_cache_size_bytes",
})

PAYLOAD_SCHEMA = 1

_lock = threading.Lock()
_writer: Optional["_ShardWriter"] = None
_last_flush = 0.0
_extra_providers: Dict[str, Callable[[], Any]] = {}
_samplers: List[Callable[[], None]] = []


def enabled() -> bool:
    return bool(os.environ.get(ENV_DIR))


def shard_dir() -> Optional[str]:
    return os.environ.get(ENV_DIR) or None


def shard_path(pid: int, directory: Optional[str] = None) -> str:
    directory = directory or shard_dir() or "."
    return os.path.join(directory, f"{SHARD_PREFIX}{pid}{SHARD_SUFFIX}")


def register_extra(key: str, provider: Callable[[], Any]) -> None:
    """Attach an extra JSON-able payload section to this process's shard
    (e.g. the SLO windows, which live outside the metric registry). The
    provider runs at every flush; exceptions are swallowed per-section."""
    with _lock:
        _extra_providers[key] = provider


def register_sampler(sampler: Callable[[], None]) -> None:
    """Register a pre-flush sampler (e.g. device telemetry) that refreshes
    gauges in the local registry just before the shard is written."""
    with _lock:
        if sampler not in _samplers:
            _samplers.append(sampler)


class _ShardWriter:
    """One process's mmap-backed shard slot."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None
        self._mm: Optional[mmap.mmap] = None
        self._size = 0
        self._version = 0

    def _ensure(self, needed: int) -> None:
        size = self._size
        wanted = _HEADER.size + needed
        if self._mm is not None and wanted <= size:
            return
        new_size = ((wanted // _SLAB_STEP) + 1) * _SLAB_STEP
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._fh is None:
            self._fh = open(self.path, "a+b")
        self._fh.truncate(new_size)
        self._fh.flush()
        self._mm = mmap.mmap(self._fh.fileno(), new_size)
        self._size = new_size

    def write(self, payload: bytes) -> None:
        self._ensure(len(payload))
        mm = self._mm
        # seqlock: odd version while the slot is inconsistent
        self._version += 1
        mm[: _HEADER.size] = _HEADER.pack(_MAGIC, self._version, len(payload))
        mm[_HEADER.size: _HEADER.size + len(payload)] = payload
        self._version += 1
        mm[: _HEADER.size] = _HEADER.pack(_MAGIC, self._version, len(payload))

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# ---------------------------------------------------------- shard payloads
def snapshot_payload(
    registry: Optional[telemetry.MetricsRegistry] = None,
) -> Dict[str, Any]:
    """This process's registry (and extras) as a JSON-able shard payload."""
    registry = registry or telemetry.default_registry()
    metrics = []
    for metric in registry.collect():
        entry: Dict[str, Any] = {
            "name": metric.name,
            "kind": metric.kind,
            "help": metric.help,
            "labelnames": list(metric.labelnames),
        }
        if metric.kind == "histogram":
            entry["buckets"] = [
                "inf" if b == float("inf") else b for b in metric.buckets
            ]
            entry["series"] = [
                [list(key), [list(counts), total]]
                for key, (counts, total) in metric.snapshot()
            ]
            # optional (schema-1 compatible: readers ignore unknown keys):
            # exemplar trace links per series, [key, [[bucket_idx,
            # trace_id, value, unix_ts], ...]]
            exemplars = metric.exemplars()
            if exemplars:
                entry["exemplars"] = [
                    [
                        list(key),
                        [[i, tid, value, ts]
                         for i, (tid, value, ts) in per_bucket.items()],
                    ]
                    for key, per_bucket in exemplars.items()
                ]
        else:
            entry["series"] = [
                [list(key), value] for key, value in metric.snapshot()
            ]
        metrics.append(entry)
    extras: Dict[str, Any] = {}
    with _lock:
        providers = dict(_extra_providers)
    for key, provider in providers.items():
        try:
            extras[key] = provider()
        except Exception:  # noqa: BLE001 — one bad extra must not kill all
            continue
    return {
        "schema": PAYLOAD_SCHEMA,
        "pid": os.getpid(),
        "ts": time.time(),
        "metrics": metrics,
        "extras": extras,
    }


def _flush_interval() -> float:
    try:
        return float(os.environ.get(ENV_FLUSH_S, "0.25"))
    except ValueError:
        return 0.25


def flush(
    force: bool = False,
    registry: Optional[telemetry.MetricsRegistry] = None,
) -> bool:
    """Write this process's shard (throttled unless ``force``). Returns
    whether a write happened. No-op when :func:`enabled` is false."""
    global _writer, _last_flush
    directory = shard_dir()
    if directory is None:
        return False
    now = time.monotonic()
    with _lock:
        if not force and (now - _last_flush) < _flush_interval():
            return False
        _last_flush = now
        samplers = list(_samplers)
    for sampler in samplers:
        try:
            sampler()
        except Exception:  # noqa: BLE001 — sampling is best-effort
            continue
    payload = json.dumps(
        snapshot_payload(registry), separators=(",", ":"), allow_nan=False,
        default=_json_default,
    ).encode()
    with _lock:
        try:
            if _writer is None or _writer.path != shard_path(os.getpid()):
                # fresh process (or post-fork child inheriting the parent's
                # writer object): open this pid's own slot
                if _writer is not None:
                    _writer.close()
                os.makedirs(directory, exist_ok=True)
                _writer = _ShardWriter(shard_path(os.getpid(), directory))
            _writer.write(payload)
            return True
        except OSError:
            return False


def _json_default(value):
    """NaN/inf guards for allow_nan=False: non-finite gauge values are
    exposition-legal but JSON-illegal; stringify so the shard stays
    parseable and the renderer formats them back."""
    return str(value)


def reset_for_tests() -> None:
    global _writer, _last_flush
    with _lock:
        if _writer is not None:
            _writer.close()
        _writer = None
        _last_flush = 0.0
        _extra_providers.clear()
        del _samplers[:]


def mark_shard_dead(pid: int, directory: Optional[str] = None) -> None:
    """Remove a dead worker's shard so its final counters stop being summed
    into the fleet view (the analog of prometheus multiprocess
    mark_process_dead, called from the arbiter's reaper)."""
    directory = directory or shard_dir()
    if directory is None:
        return
    try:
        os.remove(shard_path(pid, directory))
    except OSError:
        pass


# ------------------------------------------------------------ shard reading
def _read_shard(path: str) -> Optional[Dict[str, Any]]:
    """Parse one shard file; None when torn/half-written/unparseable."""
    for _attempt in range(3):
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError:
            return None
        if len(blob) < _HEADER.size:
            return None
        magic, version, length = _HEADER.unpack_from(blob)
        if magic != _MAGIC or version % 2 == 1:
            time.sleep(0.001)
            continue  # writer mid-slot: retry, then give up
        if length <= 0 or _HEADER.size + length > len(blob):
            return None
        try:
            payload = json.loads(blob[_HEADER.size: _HEADER.size + length])
        except ValueError:
            time.sleep(0.001)
            continue
        if isinstance(payload, dict) and payload.get("schema") == PAYLOAD_SCHEMA:
            return payload
        return None
    return None


def read_shards(directory: Optional[str] = None) -> List[Dict[str, Any]]:
    """Every parseable shard in the telemetry dir, sorted by pid."""
    directory = directory or shard_dir()
    if directory is None:
        return []
    shards = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return []
    for name in names:
        if not (name.startswith(SHARD_PREFIX) and name.endswith(SHARD_SUFFIX)):
            continue
        payload = _read_shard(os.path.join(directory, name))
        if payload is not None:
            shards.append(payload)
    shards.sort(key=lambda p: p.get("pid", 0))
    return shards


# ------------------------------------------------------------------ merging
def _coerce(value) -> float:
    if isinstance(value, str):  # _json_default stringified non-finites
        try:
            return float(value)
        except ValueError:
            return 0.0
    return float(value)


def merge_shards(shards: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Merge shard metric sections into ``{name: family}`` where a family is
    ``{kind, help, labelnames, buckets?, series, per_worker}``:

    - ``series``: ``{labelkey_tuple: merged_value}`` (counters summed,
      gauges sum- or max-merged per :data:`GAUGE_MAX_MERGE`, histograms
      ``(counts, sum)`` added element-wise);
    - ``per_worker``: gauges only — ``{labelkey_tuple + (pid,): value}``.
    """
    families: Dict[str, Dict[str, Any]] = {}
    for shard in shards:
        pid = str(shard.get("pid", "?"))
        for entry in shard.get("metrics", ()):
            name = entry.get("name")
            kind = entry.get("kind")
            if not name or kind not in ("counter", "gauge", "histogram"):
                continue
            family = families.setdefault(name, {
                "kind": kind,
                "help": entry.get("help", ""),
                "labelnames": tuple(entry.get("labelnames", ())),
                "buckets": tuple(
                    float("inf") if b == "inf" else float(b)
                    for b in entry.get("buckets", ())
                ),
                "series": {},
                "per_worker": {},
                "exemplars": {},
            })
            if family["kind"] != kind:
                continue  # name collision across kinds: first wins
            if kind == "histogram":
                for raw_key, entries in entry.get("exemplars", ()):
                    key = tuple(str(part) for part in raw_key)
                    for item in entries:
                        try:
                            index, tid, value, ts = item
                            merged = (str(tid), float(value), float(ts))
                        except (TypeError, ValueError):
                            continue
                        prior = family["exemplars"].get((key, int(index)))
                        # newest traced observation wins across workers,
                        # so a rendered exemplar still resolves somewhere
                        if prior is None or merged[2] > prior[2]:
                            family["exemplars"][(key, int(index))] = merged
            for raw_key, raw_value in entry.get("series", ()):
                key = tuple(str(part) for part in raw_key)
                if kind == "histogram":
                    counts, total = raw_value
                    state = family["series"].get(key)
                    if state is None or len(state[0]) != len(counts):
                        family["series"][key] = [list(counts), _coerce(total)]
                    else:
                        for i, c in enumerate(counts):
                            state[0][i] += c
                        state[1] += _coerce(total)
                elif kind == "counter":
                    family["series"][key] = (
                        family["series"].get(key, 0.0) + _coerce(raw_value)
                    )
                else:  # gauge
                    value = _coerce(raw_value)
                    family["per_worker"][key + (pid,)] = value
                    if name in GAUGE_MAX_MERGE:
                        prior = family["series"].get(key)
                        family["series"][key] = (
                            value if prior is None else max(prior, value)
                        )
                    else:
                        family["series"][key] = (
                            family["series"].get(key, 0.0) + value
                        )
    return families


def render_fleet_text(directory: Optional[str] = None) -> Optional[str]:
    """Prometheus text exposition of the merged fleet view, or None when no
    telemetry dir is configured. The scraped worker flushes its own shard
    first so the merge always includes the process answering the scrape."""
    if (directory or shard_dir()) is None:
        return None
    flush(force=True)
    shards = read_shards(directory)
    families = merge_shards(shards)
    # how many shards answered — the fleet-health gauge operators alert on
    from . import metrics as metric_catalog

    workers_name = metric_catalog.FLEET_WORKERS.name
    families[workers_name] = {
        "kind": "gauge",
        "help": metric_catalog.FLEET_WORKERS.help,
        "labelnames": (),
        "series": {(): float(len(shards))},
        "per_worker": {},
    }
    lines: List[str] = []
    for name in sorted(families):
        family = families[name]
        help_text = str(family["help"]).replace("\\", r"\\").replace("\n", r"\n")
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {family['kind']}")
        labelnames = family["labelnames"]
        if family["kind"] == "histogram":
            all_exemplars = sorted(
                family.get("exemplars", {}).items(),
                key=lambda item: -item[1][2],  # newest first
            )
            exemplars = dict(all_exemplars[:MAX_EXEMPLARS_PER_FAMILY])
            for key in sorted(family["series"]):
                counts, total = family["series"][key]
                cumulative = 0
                for i, (bound, count) in enumerate(
                    zip(family["buckets"], counts)
                ):
                    cumulative += count
                    labels = _render_labels(
                        labelnames, key, extra=(("le", _format_float(bound)),)
                    )
                    line = f"{name}_bucket{labels} {cumulative}"
                    exemplar = exemplars.get((key, i))
                    if exemplar is not None:
                        line += _format_exemplar(*exemplar)
                    lines.append(line)
                labels = _render_labels(labelnames, key)
                lines.append(f"{name}_sum{labels} {_format_float(total)}")
                lines.append(f"{name}_count{labels} {cumulative}")
        else:
            for key in sorted(family["series"]):
                labels = _render_labels(labelnames, key)
                lines.append(
                    f"{name}{labels} "
                    f"{_format_float(family['series'][key])}"
                )
            for key in sorted(family["per_worker"]):
                labels = _render_labels(
                    tuple(labelnames) + ("worker",), key
                )
                lines.append(
                    f"{name}{labels} "
                    f"{_format_float(family['per_worker'][key])}"
                )
    return "\n".join(lines) + "\n"


def fleet_vars(directory: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The merged fleet view as a JSON-able dict for ``/debug/vars``: per
    metric the fleet value (histograms as count/sum), plus shard census."""
    if (directory or shard_dir()) is None:
        return None
    flush(force=True)
    shards = read_shards(directory)
    families = merge_shards(shards)
    merged: Dict[str, Any] = {}
    for name in sorted(families):
        family = families[name]
        series_out = {}
        for key, value in sorted(family["series"].items()):
            label = ",".join(key) if key else ""
            if family["kind"] == "histogram":
                counts, total = value
                series_out[label] = {"count": sum(counts), "sum": total}
            else:
                series_out[label] = value
        merged[name] = {"kind": family["kind"], "series": series_out}
    return {
        "dir": directory or shard_dir(),
        "workers": len(shards),
        "pids": [shard.get("pid") for shard in shards],
        "merged": merged,
    }


def fleet_extras(
    key: str, directory: Optional[str] = None
) -> List[Tuple[int, Any]]:
    """Every shard's extra payload section ``key`` as ``(pid, payload)``
    pairs (shards without that section are skipped)."""
    out = []
    for shard in read_shards(directory):
        extra = (shard.get("extras") or {}).get(key)
        if extra is not None:
            out.append((int(shard.get("pid", 0)), extra))
    return out
