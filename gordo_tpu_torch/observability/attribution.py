"""
Latency attribution: decompose a p50/p99 move into per-phase contributions.
The port's copy of ``gordo_tpu/observability/attribution.py``, whose shard
payloads merge with the JAX package's.

The server times each prediction request's phases (decode, predict,
encode: the ``Server-Timing`` entries) and its whole wall time; this module
turns those numbers into an explanation:

- **Live windows**: per-phase log-bucketed histograms (latency.py) in
  epoch-aligned rolling windows of ``GORDO_TPU_PERF_WINDOW_S`` seconds
  (keyed by ``int(now // width)``, as slo.py keys them, so worker shards
  merge by exact addition), riding the telemetry shards.
  ``GET /debug/perf`` serves the current-against-previous window
  decomposition.
- **Records**: :func:`phase_stats_from_record` and
  :func:`format_decomposition` read the same phase stats out of a bench
  record's dict; the command-line comparison that uses them is ROADMAP.md
  item A11's.

The decomposition contract: the rows always sum **exactly** to the headline
delta. The measured phases contribute their own deltas; ``server_other``
closes the gap between the phase sum and in-server wall time
(``request_walltime``), ``queue/transport`` the gap between in-server and
client-observed time, and ``unattributed`` the rest when no wall time was
recorded. Quantiles are not additive, so per-phase quantile deltas are an
attribution heuristic; the derived rows are where its error lands. A
separate **mix-shift** term (shift-share over the per-model traffic mix)
reports how much of the move is traffic composition.

Gated: :func:`observe` returns before taking any lock unless
``GORDO_TPU_PERF_ATTRIBUTION`` (or the perf sentinel, which feeds on these
windows) is set. Feeds ``gordo_server_phase_p50_seconds`` and
``gordo_server_phase_p99_seconds``.
"""


import json
import math
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from . import metrics as metric_catalog
from .latency import LatencyHistogram

_TRUTHY = ("1", "true", "yes")

# same resolution slo.py uses for its windows: ~1.6% relative error,
# a few hundred bytes per phase histogram
_SUBBUCKETS = 32

# phases the serving path actually times; anything else (a future
# ctx.phase name) folds into _OTHER_PHASE so cardinality stays bounded
_CORE_PHASES = ("decode", "predict", "encode")
_OTHER_PHASE = "_other_phase"
_MAX_MODELS = 256
_OVERFLOW_MODEL = "_other"

# windows kept: current + two closed (decompose needs one closed window
# as base; the extra one tolerates reads racing an epoch roll)
_KEPT_WINDOWS = 3


def enabled() -> bool:
    """Attribution is on when asked for directly, or when the perf
    sentinel is on (the sentinel feeds on these same windows)."""
    env = os.environ.get
    return (
        env("GORDO_TPU_PERF_ATTRIBUTION", "").lower() in _TRUTHY
        or env("GORDO_TPU_PERF_SENTINEL", "").lower() in _TRUTHY
    )


def window_s() -> float:
    try:
        value = float(os.environ.get("GORDO_TPU_PERF_WINDOW_S", "300"))
    except ValueError:
        return 300.0
    return value if value > 0 else 300.0


# ----------------------------------------------------------------- tracker
class _Window:
    __slots__ = ("phases", "models")

    def __init__(self):
        # phase name -> histogram of seconds ("total" = client wall,
        # "request_walltime" = in-server wall, "server_other" derived)
        self.phases: Dict[str, LatencyHistogram] = {}
        # model -> [count, sum_seconds] for the mix-shift term
        self.models: Dict[str, List[float]] = {}

    def hist(self, phase: str) -> LatencyHistogram:
        hist = self.phases.get(phase)
        if hist is None:
            hist = self.phases.setdefault(
                phase, LatencyHistogram(_SUBBUCKETS)
            )
        return hist


class _Tracker:
    def __init__(self):
        self.lock = threading.Lock()
        self.windows: Dict[int, _Window] = {}

    def window_for(self, index: int) -> _Window:
        window = self.windows.get(index)
        if window is None:
            window = self.windows.setdefault(index, _Window())
            for old in [
                i for i in self.windows if i <= index - _KEPT_WINDOWS
            ]:
                del self.windows[old]
        return window

    def reset(self):
        with self.lock:
            self.windows.clear()


_tracker = _Tracker()


def observe(
    model: str,
    total_s: float,
    phases: Optional[Dict[str, float]],
    now: Optional[float] = None,
) -> None:
    """Record one finished request's phase timings into the current
    window. No-op (before the lock) unless the gate is open."""
    if not enabled():
        return
    if not (isinstance(total_s, (int, float)) and math.isfinite(total_s)):
        return
    if now is None:
        now = time.time()
    index = int(now // window_s())
    with _tracker.lock:
        window = _tracker.window_for(index)
        window.hist("total").record(float(total_s))
        measured = 0.0
        for name, value in (phases or {}).items():
            if not isinstance(value, (int, float)) or not math.isfinite(
                value
            ):
                continue
            key = name if name in _CORE_PHASES else _OTHER_PHASE
            window.hist(key).record(float(value))
            measured += float(value)
        if phases:
            # the in-request time no timed phase accounts for — router,
            # header parse, response write (this is per-request additive,
            # so its histogram is a real distribution, not a residual)
            window.hist("server_other").record(
                max(float(total_s) - measured, 1e-9)
            )
        name = str(model or "(unknown)")
        if name not in window.models and len(window.models) >= _MAX_MODELS:
            name = _OVERFLOW_MODEL
        row = window.models.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += float(total_s)


# ------------------------------------------------------------- window stats
def _percentile_block(hist: LatencyHistogram) -> Dict[str, Optional[float]]:
    out: Dict[str, Optional[float]] = {}
    for label, q in (("p50_ms", 0.50), ("p99_ms", 0.99)):
        value = hist.quantile(q)
        out[label] = value * 1000.0 if value is not None else None
    out["count"] = hist.count
    return out


def window_stats(index: int) -> Optional[Dict[str, Any]]:
    """Phase stats for one epoch window, in the shape
    :func:`decompose_stats` consumes, or None when the window is empty."""
    with _tracker.lock:
        window = _tracker.windows.get(index)
        if window is None:
            return None
        blocks = {
            name: _percentile_block(hist)
            for name, hist in window.phases.items()
        }
        models = {
            name: {"count": int(c), "mean_ms": (s / c * 1000.0) if c else 0.0}
            for name, (c, s) in window.models.items()
        }
    total = blocks.pop("total", None)
    if total is None or not total.get("count"):
        return None
    return {"total": total, "phases": blocks, "models": models,
            "window_index": index}


def current_window_index(now: Optional[float] = None) -> int:
    return int((now if now is not None else time.time()) // window_s())


# ------------------------------------------------------------ decomposition
def _components(
    stats: Dict[str, Any], percentile: str
) -> Tuple[Optional[float], Dict[str, float]]:
    """Partition the headline quantile into additive components. The
    component values always sum to the headline (derived rows close the
    budget), so deltas over two calls sum to the headline delta."""
    total = (stats.get("total") or {}).get(percentile)
    if total is None:
        return None, {}
    phases = {
        name: block.get(percentile)
        for name, block in (stats.get("phases") or {}).items()
        if isinstance(block, dict) and block.get(percentile) is not None
    }
    comps: Dict[str, float] = {}
    for name in _CORE_PHASES:
        if name in phases:
            comps[name] = float(phases[name])
    walltime = phases.get("request_walltime")
    if walltime is not None:
        comps["server_other"] = float(walltime) - sum(comps.values())
        transport = float(total) - float(walltime)
        # the gateway's own span-derived overhead (Server-Timing
        # ``gateway_s``: routed wall minus upstream attempts) is part of
        # the client-to-server gap, not node walltime — carve it out of
        # queue/transport so a gateway regression shows under its own
        # name. NOT in _CORE_PHASES: summing it into server_other would
        # double-count time the node never saw.
        gateway = phases.get("gateway")
        if gateway is not None:
            comps["gateway"] = float(gateway)
            transport -= float(gateway)
        comps["queue/transport"] = transport
    else:
        if "server_other" in phases:
            comps["server_other"] = float(phases["server_other"])
        comps["unattributed"] = float(total) - sum(comps.values())
    return float(total), comps


def decompose_stats(
    base: Dict[str, Any],
    cur: Dict[str, Any],
    percentile: str = "p99_ms",
) -> Optional[Dict[str, Any]]:
    """Per-phase decomposition of ``cur[percentile] - base[percentile]``.
    Row deltas sum exactly to the headline delta (see module docstring
    for what the derived rows mean)."""
    base_total, base_comps = _components(base, percentile)
    cur_total, cur_comps = _components(cur, percentile)
    if base_total is None or cur_total is None:
        return None
    headline = cur_total - base_total
    rows: List[Dict[str, Any]] = []
    for name in list(_CORE_PHASES) + sorted(
        (set(base_comps) | set(cur_comps)) - set(_CORE_PHASES)
    ):
        if name not in base_comps and name not in cur_comps:
            continue
        if any(row["name"] == name for row in rows):
            continue
        base_ms = base_comps.get(name, 0.0)
        cur_ms = cur_comps.get(name, 0.0)
        delta = cur_ms - base_ms
        rows.append(
            {
                "name": name,
                "base_ms": base_ms,
                "cur_ms": cur_ms,
                "delta_ms": delta,
                "share": (delta / headline) if abs(headline) > 1e-12
                else None,
            }
        )
    return {
        "percentile": percentile,
        "base_ms": base_total,
        "cur_ms": cur_total,
        "headline_delta_ms": headline,
        "rows": rows,
        "mix_shift_ms": mix_shift(
            base.get("models"), cur.get("models")
        ),
    }


def mix_shift(
    base_models: Optional[Dict[str, Any]],
    cur_models: Optional[Dict[str, Any]],
) -> Optional[float]:
    """Shift-share mix term: how much the *mean* latency would have
    moved from traffic-composition change alone, holding every model at
    its base-window latency — ``sum((share_new - share_old) *
    mean_old)`` in ms. None when either window lacks per-model data."""
    if not base_models or not cur_models:
        return None
    base_n = sum(int(row.get("count", 0)) for row in base_models.values())
    cur_n = sum(int(row.get("count", 0)) for row in cur_models.values())
    if not base_n or not cur_n:
        return None
    shift = 0.0
    for name, base_row in base_models.items():
        base_share = int(base_row.get("count", 0)) / base_n
        cur_share = int(
            (cur_models.get(name) or {}).get("count", 0)
        ) / cur_n
        shift += (cur_share - base_share) * float(
            base_row.get("mean_ms", 0.0)
        )
    return shift


def live_decomposition(
    percentile: str = "p99_ms", now: Optional[float] = None
) -> Optional[Dict[str, Any]]:
    """Decompose the current (open) window against the most recent
    non-empty closed window. None until both exist."""
    index = current_window_index(now)
    cur = window_stats(index)
    if cur is None:
        return None
    base = None
    for back in range(1, _KEPT_WINDOWS):
        base = window_stats(index - back)
        if base is not None:
            break
    if base is None:
        return None
    out = decompose_stats(base, cur, percentile)
    if out is not None:
        out["base_window"] = base["window_index"]
        out["cur_window"] = cur["window_index"]
        out["window_s"] = window_s()
    return out


def snapshot() -> Dict[str, Any]:
    """Everything /debug/perf serves: current + previous window stats
    and the live decomposition at both tracked percentiles."""
    index = current_window_index()
    return {
        "enabled": enabled(),
        "window_s": window_s(),
        "current": window_stats(index),
        "previous": window_stats(index - 1),
        "decomposition": {
            "p50": live_decomposition("p50_ms"),
            "p99": live_decomposition("p99_ms"),
        },
    }


# ------------------------------------------------- BENCH record extraction
def _stats_from_qps_block(qps: Any) -> Optional[Dict[str, Any]]:
    if not isinstance(qps, dict):
        return None
    phases = qps.get("phases")
    if not isinstance(phases, dict) or not phases:
        return None
    total = {
        "p50_ms": qps.get("p50_ms"),
        "p99_ms": qps.get("p99_ms"),
    }
    if total["p50_ms"] is None and total["p99_ms"] is None:
        return None
    blocks = {
        name: {"p50_ms": row.get("p50_ms"), "p99_ms": row.get("p99_ms")}
        for name, row in phases.items()
        if isinstance(row, dict)
    }
    return {"total": total, "phases": blocks}


def phase_stats_from_record(
    record: Dict[str, Any], base_dir: str = "."
) -> Optional[Dict[str, Any]]:
    """Recover serving-phase stats from a BENCH record, trying in order:
    the ``parsed.serving_load.phases`` block (records >= r10), a
    ``{"detail": ...}`` JSON line in the record's captured tail, then
    the ``parsed.detail_file`` sidecar next to the record."""
    parsed = record.get("parsed") or {}
    serving = parsed.get("serving_load") or {}

    stats = _stats_from_qps_block(
        dict(
            serving,
            p50_ms=serving.get("p50_ms", parsed.get("server_load_p50_ms")),
            p99_ms=serving.get("p99_ms", parsed.get("server_load_p99_ms")),
        )
    )
    if stats:
        return stats

    detail = None
    tail = record.get("tail") or ""
    for line in reversed(tail.splitlines()):
        line = line.strip()
        if line.startswith("{") and '"detail"' in line:
            try:
                detail = json.loads(line).get("detail")
            except ValueError:
                continue
            if detail:
                break
    if detail is None:
        detail_file = parsed.get("detail_file")
        if detail_file:
            path = os.path.join(base_dir, str(detail_file))
            if os.path.exists(path):
                try:
                    with open(path) as fh:
                        detail = json.load(fh)
                except (OSError, ValueError):
                    detail = None
    if not isinstance(detail, dict):
        return None
    result = (detail.get("serving_load") or {}).get("result") or {}
    return _stats_from_qps_block(result.get("qps"))


def format_decomposition(decomp: Dict[str, Any]) -> List[str]:
    """Human-readable table lines for bench_compare / CLI output."""
    lines = [
        "  {:<18} {:>10} {:>10} {:>10} {:>8}".format(
            f"phase ({decomp['percentile']})", "base_ms", "new_ms",
            "delta", "share",
        )
    ]
    for row in decomp["rows"]:
        share = (
            f"{row['share'] * 100:.0f}%" if row["share"] is not None else "-"
        )
        lines.append(
            "  {:<18} {:>10.3f} {:>10.3f} {:>+10.3f} {:>8}".format(
                row["name"], row["base_ms"], row["cur_ms"],
                row["delta_ms"], share,
            )
        )
    lines.append(
        "  {:<18} {:>10.3f} {:>10.3f} {:>+10.3f} {:>8}".format(
            "headline", decomp["base_ms"], decomp["cur_ms"],
            decomp["headline_delta_ms"], "100%",
        )
    )
    if decomp.get("mix_shift_ms") is not None:
        lines.append(
            "  traffic mix-shift accounts for "
            f"{decomp['mix_shift_ms']:+.3f} ms of the mean move"
        )
    return lines


# ----------------------------------------------------------- fleet merge
def shard_payload() -> Dict[str, Any]:
    """This worker's windows for the telemetry shard plane; epoch-keyed
    histograms and model counters both merge by exact addition."""
    payload: Dict[str, Any] = {}
    with _tracker.lock:
        for index, window in _tracker.windows.items():
            payload[str(index)] = {
                "phases": {
                    name: hist.to_dict()
                    for name, hist in window.phases.items()
                },
                "models": {
                    name: list(row)
                    for name, row in window.models.items()
                },
            }
    return payload


def merge_payloads(
    pairs: Iterable[Tuple[int, Dict[str, Any]]]
) -> Dict[str, Any]:
    """Fleet merge over ``(pid, payload)`` shard pairs: histograms merge
    bucket-wise, model rows add; a reaped shard drops out of the sum."""
    merged: Dict[str, Dict[str, Any]] = {}
    for _pid, payload in pairs:
        if not isinstance(payload, dict):
            continue
        for index, row in payload.items():
            if not isinstance(row, dict):
                continue
            slot = merged.setdefault(
                str(index), {"phases": {}, "models": {}}
            )
            for name, hist_dict in (row.get("phases") or {}).items():
                try:
                    incoming = LatencyHistogram.from_dict(hist_dict)
                except (TypeError, ValueError):
                    continue
                existing = slot["phases"].get(name)
                if existing is None:
                    slot["phases"][name] = incoming
                else:
                    existing.merge(incoming)
            for name, counts in (row.get("models") or {}).items():
                agg = slot["models"].setdefault(name, [0, 0.0])
                agg[0] += int(counts[0])
                agg[1] += float(counts[1])
    return {
        index: {
            "phases": {
                name: hist.to_dict()
                for name, hist in row["phases"].items()
            },
            "models": row["models"],
        }
        for index, row in merged.items()
    }


# ----------------------------------------------------------- shard hooks
_hooks_installed = False


def refresh_gauges() -> None:
    """Current-window per-phase quantiles into the attribution gauge
    block (sampled at telemetry flush, like slo/device)."""
    stats = window_stats(current_window_index())
    if not stats:
        return
    blocks = dict(stats["phases"])
    blocks["total"] = stats["total"]
    for name, block in blocks.items():
        if block.get("p50_ms") is not None:
            metric_catalog.PHASE_P50.labels(phase=name).set(
                block["p50_ms"] / 1000.0
            )
        if block.get("p99_ms") is not None:
            metric_catalog.PHASE_P99.labels(phase=name).set(
                block["p99_ms"] / 1000.0
            )


def install_shard_hooks() -> None:
    """Idempotent: ride the telemetry-shard flush like slo/drift/device."""
    global _hooks_installed
    if _hooks_installed:
        return
    _hooks_installed = True
    from . import shared

    shared.register_sampler(refresh_gauges)
    shared.register_extra("perf", shard_payload)


def reset() -> None:
    """Test hook: drop every window."""
    _tracker.reset()
