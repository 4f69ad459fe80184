"""
Grafana dashboards over the server's and builders' Prometheus series: the
port's copy of ``gordo_tpu/observability/grafana.py``, derived from the
port's catalog (observability/metrics.py) and its server families
(server/prometheus/metrics.py), so that a dashboard cannot drift from what
the port exports.

Each dashboard is JSON-equal to the JAX package's, panel for panel, except
the panels over series that have no counterpart in the port, because it
compiles no program (its kernels are built once by ``nvcc``): on the build
dashboard the bucket-program cache panel
(``gordo_build_program_cache_requests_total``,
``gordo_build_compile_seconds_saved_total``) and the three XLA persistent
cache panels (``gordo_build_xla_persistent_cache_entries``,
``_size_bytes``, ``_entries_added_total``); on the fleet dashboard the AOT
serving programs panel (``gordo_server_aot_programs_total``,
``gordo_server_prelower_failures_total``). The JAX dashboards query no
trace-compile series, so none is left out for it. The remaining panels
keep their JAX ids.

Rates and latencies are timeseries panels, single current values stat
panels; latency panels use ``histogram_quantile`` over the duration
histograms. ``write_dashboards(out_dir)`` writes them as JSON files.
"""


import json
import os
from typing import Any, Dict, List, Optional

# label selector shared by every query; $project is a dashboard variable
_SEL = 'project=~"$project"'

_PANEL_W = 12
_PANEL_H = 8


def _timeseries(
    title: str,
    targets: List[Dict[str, str]],
    panel_id: int,
    x: int,
    y: int,
    unit: str = "short",
    description: str = "",
) -> Dict[str, Any]:
    return {
        "id": panel_id,
        "type": "timeseries",
        "title": title,
        "description": description,
        "gridPos": {"h": _PANEL_H, "w": _PANEL_W, "x": x, "y": y},
        "fieldConfig": {
            "defaults": {
                "unit": unit,
                "custom": {
                    "lineWidth": 2,
                    "fillOpacity": 0,
                    "showPoints": "never",
                    "spanNulls": True,
                },
            },
            "overrides": [],
        },
        "options": {
            "tooltip": {"mode": "multi"},
            "legend": {"displayMode": "list", "placement": "bottom"},
        },
        "targets": [
            {
                "expr": t["expr"],
                "legendFormat": t.get("legend", ""),
                "refId": chr(65 + i),
                # Grafana's per-target exemplar switch: overlays the
                # OpenMetrics exemplar dots (trace_id-linked) on the series
                **({"exemplar": True} if t.get("exemplar") else {}),
            }
            for i, t in enumerate(targets)
        ],
    }


def _stat(
    title: str,
    expr: str,
    panel_id: int,
    x: int,
    y: int,
    unit: str = "short",
) -> Dict[str, Any]:
    return {
        "id": panel_id,
        "type": "stat",
        "title": title,
        "gridPos": {"h": 4, "w": 6, "x": x, "y": y},
        "fieldConfig": {"defaults": {"unit": unit}, "overrides": []},
        "options": {"reduceOptions": {"calcs": ["lastNotNull"]}},
        "targets": [{"expr": expr, "refId": "A"}],
    }


def _dashboard(
    title: str, uid: str, panels: List[Dict[str, Any]], extra_vars: Optional[list] = None
) -> Dict[str, Any]:
    variables = [
        {
            "name": "project",
            "type": "query",
            "datasource": None,
            "query": "label_values(gordo_server_info, project)",
            "refresh": 2,
            "includeAll": True,
            "multi": True,
        }
    ] + (extra_vars or [])
    return {
        "title": title,
        "uid": uid,
        "schemaVersion": 36,
        "editable": True,
        "time": {"from": "now-6h", "to": "now"},
        "refresh": "30s",
        "templating": {"list": variables},
        "panels": panels,
    }


def servers_dashboard() -> Dict[str, Any]:
    """Fleet-level server dashboard (reference Gordo_servers dashboard)."""
    def latency(q: float) -> str:
        return (
            f"histogram_quantile({q}, sum(rate("
            f"gordo_server_request_duration_seconds_bucket{{{_SEL}}}[5m]"
            ")) by (le, path))"
        )
    panels = [
        _timeseries(
            "Requests per path",
            [
                {
                    "expr": f"sum(rate(gordo_server_requests_total{{{_SEL}}}[1m])) by (path)",
                    "legend": "{{path}}",
                }
            ],
            panel_id=1,
            x=0,
            y=0,
            unit="reqps",
        ),
        _timeseries(
            "Requests per project",
            [
                {
                    "expr": "sum(rate(gordo_server_requests_total"
                    f"{{{_SEL}}}[1m])) by (project)",
                    "legend": "{{project}}",
                }
            ],
            panel_id=2,
            x=_PANEL_W,
            y=0,
            unit="reqps",
        ),
        _timeseries(
            "Requests per minute by status code",
            [
                {
                    "expr": "sum(increase(gordo_server_requests_total"
                    f"{{{_SEL}}}[1m])) by (status_code)",
                    "legend": "{{status_code}}",
                }
            ],
            panel_id=3,
            x=0,
            y=_PANEL_H,
        ),
        _timeseries(
            "API latency p50 / p95 by path",
            [
                {"expr": latency(0.5), "legend": "p50 {{path}}"},
                {"expr": latency(0.95), "legend": "p95 {{path}}"},
            ],
            panel_id=4,
            x=_PANEL_W,
            y=_PANEL_H,
            unit="s",
            description=(
                "Tail-aware: histogram_quantile over the duration histogram, "
                "not an average"
            ),
        ),
        _timeseries(
            "Anomaly-prediction latency p50 / p95",
            [
                {
                    "expr": (
                        "histogram_quantile(0.5, sum(rate("
                        "gordo_server_request_duration_seconds_bucket"
                        f'{{{_SEL},path=~".*anomaly/prediction"}}[5m]'
                        ")) by (le))"
                    ),
                    "legend": "p50",
                },
                {
                    "expr": (
                        "histogram_quantile(0.95, sum(rate("
                        "gordo_server_request_duration_seconds_bucket"
                        f'{{{_SEL},path=~".*anomaly/prediction"}}[5m]'
                        ")) by (le))"
                    ),
                    "legend": "p95",
                },
            ],
            panel_id=5,
            x=0,
            y=2 * _PANEL_H,
            unit="s",
        ),
        _stat(
            "Server versions live",
            f"count(gordo_server_info{{{_SEL}}}) by (version)",
            panel_id=6,
            x=_PANEL_W,
            y=2 * _PANEL_H,
        ),
        _stat(
            "Error ratio (5m)",
            # `or vector(0)` keeps the stat at 0 (not NaN from 0/0) when idle
            "(sum(rate(gordo_server_requests_total"
            f'{{{_SEL},status_code=~"5.."}}[5m])) / '
            f"sum(rate(gordo_server_requests_total{{{_SEL}}}[5m]))) "
            "or vector(0)",
            panel_id=7,
            x=_PANEL_W + 6,
            y=2 * _PANEL_H,
            unit="percentunit",
        ),
        _timeseries(
            "Cross-model batcher (cumulative)",
            # gauges mirrored from the batcher's monotone totals — plotted
            # raw, not rate(): gauge semantics
            [
                {
                    "expr": f"sum(gordo_server_batcher_items{{{_SEL}}})",
                    "legend": "batched predicts",
                },
                {
                    "expr": (
                        f"sum(gordo_server_batcher_device_calls{{{_SEL}}})"
                    ),
                    "legend": "fused device calls",
                },
                {
                    "expr": (
                        f"max(gordo_server_batcher_largest_batch{{{_SEL}}})"
                    ),
                    "legend": "largest batch",
                },
            ],
            panel_id=8,
            x=0,
            y=3 * _PANEL_H,
            description=(
                "Predicts fused into shared device calls; flat lines mean "
                "the self-A/B stood batching down on this backend"
            ),
        ),
        _timeseries(
            "Batcher self-A/B decisions",
            [
                {
                    "expr": (
                        f"sum(gordo_server_batcher_specs{{{_SEL}}}) "
                        "by (decision)"
                    ),
                    "legend": "{{decision}}",
                }
            ],
            panel_id=9,
            x=_PANEL_W,
            y=3 * _PANEL_H,
            description=(
                "Architectures whose measured startup A/B kept batching on "
                "('batch') vs stood down to per-request dispatch ('direct')"
            ),
        ),
    ]
    return _dashboard("Gordo TPU servers", "gordo-tpu-servers", panels)


def machines_dashboard() -> Dict[str, Any]:
    """Per-machine dashboard (reference machines.json): request rates and
    latency for one selected model, driven by the gordo_name label."""
    sel = _SEL + ', gordo_name=~"$machine"'
    panels = [
        _timeseries(
            "Requests per machine",
            [
                {
                    "expr": f"sum(rate(gordo_server_requests_total{{{sel}}}[1m])) "
                    "by (gordo_name)",
                    "legend": "{{gordo_name}}",
                }
            ],
            panel_id=1,
            x=0,
            y=0,
            unit="reqps",
        ),
        _timeseries(
            "Latency p95 per machine",
            [
                {
                    "expr": (
                        "histogram_quantile(0.95, sum(rate("
                        "gordo_server_request_duration_seconds_bucket"
                        f"{{{sel}}}[5m])) by (le, gordo_name))"
                    ),
                    "legend": "{{gordo_name}}",
                }
            ],
            panel_id=2,
            x=_PANEL_W,
            y=0,
            unit="s",
        ),
        _timeseries(
            "Status codes per machine",
            [
                {
                    "expr": f"sum(increase(gordo_server_requests_total{{{sel}}}[1m])) "
                    "by (gordo_name, status_code)",
                    "legend": "{{gordo_name}} {{status_code}}",
                }
            ],
            panel_id=3,
            x=0,
            y=_PANEL_H,
        ),
    ]
    machine_var = {
        "name": "machine",
        "type": "query",
        "datasource": None,
        "query": "label_values(gordo_server_requests_total, gordo_name)",
        "refresh": 2,
        "includeAll": True,
        "multi": True,
    }
    return _dashboard(
        "Gordo TPU machines", "gordo-tpu-machines", panels, extra_vars=[machine_var]
    )


def build_dashboard() -> Dict[str, Any]:
    """Fleet-build telemetry dashboard over the gordo_build_* metrics the
    telemetry spine records (observability/metrics.py) — phase durations,
    fault-domain events, cache effectiveness, and the serving batcher's
    queue behavior. Build metrics carry no project label (one fleet build
    per process; textfile-exported by ``batch-build --metrics-file``), so
    panels query unselected names."""
    def phase_latency(q: float) -> str:
        return (
            f"histogram_quantile({q}, sum(rate("
            "gordo_build_phase_seconds_bucket[5m])) by (le, phase))"
        )

    def batcher_quantile(q: float, metric: str) -> str:
        return (
            f"histogram_quantile({q}, sum(rate("
            f"{metric}_bucket[5m])) by (le))"
        )

    panels = [
        _timeseries(
            "Build phase durations p50 / p95",
            [
                {"expr": phase_latency(0.5), "legend": "p50 {{phase}}"},
                {"expr": phase_latency(0.95), "legend": "p95 {{phase}}"},
            ],
            panel_id=1,
            x=0,
            y=0,
            unit="s",
            description=(
                "fetch/validate/compile/train/serialize/assemble spans from "
                "the fleet builder; cross_validation/fit from the serial "
                "builder"
            ),
        ),
        _timeseries(
            "Machines by outcome",
            [
                {
                    "expr": "sum(gordo_build_machines_total) by (outcome)",
                    "legend": "{{outcome}}",
                }
            ],
            panel_id=2,
            x=_PANEL_W,
            y=0,
        ),
        _timeseries(
            "Quarantines by stage",
            [
                {
                    "expr": "sum(gordo_build_quarantines_total) by (stage)",
                    "legend": "{{stage}}",
                }
            ],
            panel_id=3,
            x=0,
            y=_PANEL_H,
        ),
        _timeseries(
            "Fault-domain events",
            [
                {
                    "expr": "sum(gordo_build_fault_retries_total) "
                    "by (operation)",
                    "legend": "retries {{operation}}",
                },
                {
                    "expr": "sum(gordo_build_bucket_retries_total)",
                    "legend": "bucket retries",
                },
                {
                    "expr": "sum(gordo_build_oom_bisections_total)",
                    "legend": "OOM bisections",
                },
                {
                    "expr": "sum(gordo_build_serial_fallbacks_total) "
                    "by (reason)",
                    "legend": "serial fallback {{reason}}",
                },
            ],
            panel_id=4,
            x=_PANEL_W,
            y=_PANEL_H,
            description=(
                "The recovery ladder at work: absorbed retries, bucket "
                "bisections, and serial last-resort builds"
            ),
        ),
        _timeseries(
            "Serving batcher queue wait p50 / p95",
            [
                {
                    "expr": batcher_quantile(
                        0.5, "gordo_server_batcher_queue_wait_seconds"
                    ),
                    "legend": "p50",
                },
                {
                    "expr": batcher_quantile(
                        0.95, "gordo_server_batcher_queue_wait_seconds"
                    ),
                    "legend": "p95",
                },
            ],
            panel_id=9,
            x=0,
            y=3 * _PANEL_H,
            unit="s",
        ),
        _timeseries(
            "Serving batcher fuse width p50 / p95",
            [
                {
                    "expr": batcher_quantile(
                        0.5, "gordo_server_batcher_fuse_width"
                    ),
                    "legend": "p50",
                },
                {
                    "expr": batcher_quantile(
                        0.95, "gordo_server_batcher_fuse_width"
                    ),
                    "legend": "p95",
                },
            ],
            panel_id=10,
            x=_PANEL_W,
            y=3 * _PANEL_H,
        ),
    ]
    return _dashboard("Gordo TPU builds", "gordo-tpu-builds", panels)


def resilience_dashboard() -> Dict[str, Any]:
    """Serving-resilience dashboard over the fault-handling metrics
    plus the flight recorder: load shedding, deadline exhaustion,
    circuit breakers, the fused-group rescue ladder, the device watchdog,
    and flight-recorder occupancy. These series live in the telemetry
    registry (observability/metrics.py, bridged into /metrics) and carry
    no project label — panels query unselected names, like the build
    dashboard."""
    panels = [
        _timeseries(
            "Shed & deadline-exceeded requests",
            [
                {
                    "expr": "sum(rate(gordo_server_shed_total[5m])) "
                    "by (reason)",
                    "legend": "shed {{reason}}",
                },
                {
                    "expr": "sum(rate("
                    "gordo_server_deadline_exceeded_total[5m])) by (where)",
                    "legend": "deadline {{where}}",
                },
            ],
            panel_id=1,
            x=0,
            y=0,
            unit="reqps",
            description=(
                "Admission-control 503s and X-Gordo-Deadline-Ms 504s: the "
                "server protecting itself under overload"
            ),
        ),
        _timeseries(
            "Circuit breakers",
            [
                {
                    "expr": "max(gordo_server_breaker_state) by (model)",
                    "legend": "state {{model}}",
                },
                {
                    "expr": "sum(rate(gordo_server_breaker_opens_total[5m]))"
                    " by (model)",
                    "legend": "opens {{model}}",
                },
                {
                    "expr": "sum(rate("
                    "gordo_server_breaker_fast_failures_total[5m])) "
                    "by (model)",
                    "legend": "fast-fails {{model}}",
                },
            ],
            panel_id=2,
            x=_PANEL_W,
            y=0,
            description=(
                "Per-model breaker state (0 closed / 1 half-open / 2 open) "
                "with open transitions and fast-failed requests"
            ),
        ),
        _timeseries(
            "Fused-group rescue ladder",
            [
                {
                    "expr": "sum(rate("
                    "gordo_server_batcher_abandoned_total[5m]))",
                    "legend": "abandoned waits",
                },
                {
                    "expr": "sum(rate("
                    "gordo_server_group_bisections_total[5m]))",
                    "legend": "group bisections",
                },
                {
                    "expr": "sum(rate("
                    "gordo_server_group_serial_rescues_total[5m]))",
                    "legend": "serial rescues",
                },
            ],
            panel_id=3,
            x=0,
            y=_PANEL_H,
            description=(
                "The serving twin of the build recovery ladder: deadline-"
                "abandoned waiters, fused-call bisections, un-fused rescues"
            ),
        ),
        _timeseries(
            "Model load failures",
            [
                {
                    "expr": "sum(rate("
                    "gordo_server_model_load_failures_total[5m])) by (kind)",
                    "legend": "{{kind}}",
                }
            ],
            panel_id=4,
            x=_PANEL_W,
            y=_PANEL_H,
            description=(
                "fresh = a real deserialize failed (now negative-cached); "
                "cached = the TTL'd negative cache answered"
            ),
        ),
        _timeseries(
            "Flight recorder",
            [
                {
                    "expr": "sum(gordo_server_flight_traces) by (cls)",
                    "legend": "held {{cls}}",
                },
                {
                    "expr": "sum(rate("
                    "gordo_server_flight_recorded_total[5m])) by (cls)",
                    "legend": "kept/s {{cls}}",
                },
            ],
            panel_id=5,
            x=0,
            y=2 * _PANEL_H,
            description=(
                "Tail-sampled request traces held in the /debug/flight "
                "ring (error vs slow), and the keep rate — a rising error "
                "keep rate is an incident before the alert fires"
            ),
        ),
        _stat(
            "Watchdog trips",
            "sum(gordo_server_watchdog_trips_total)",
            panel_id=6,
            x=_PANEL_W,
            y=2 * _PANEL_H,
        ),
        _stat(
            "Breakers open now",
            "count(gordo_server_breaker_state == 2) or vector(0)",
            panel_id=7,
            x=_PANEL_W + 6,
            y=2 * _PANEL_H,
        ),
    ]
    return _dashboard(
        "Gordo TPU serving resilience", "gordo-tpu-resilience", panels
    )


def fleet_dashboard() -> Dict[str, Any]:
    """Fleet observability plane dashboard over the
    dependency-free shard-merged /metrics view (observability/shared.py):
    cross-worker traffic, device duty cycle and online MFU, param-bank
    residency, and per-model SLO burn rates. Like the build/resilience
    dashboards these series live in the telemetry registry and carry no
    project label — panels query unselected names. Gauge aggregates are
    exported without the worker label (sum- or max-merged at scrape), with
    per-worker series available under worker="<pid>"."""
    panels = [
        _timeseries(
            "Fleet requests by endpoint and status class",
            [
                {
                    "expr": "sum(rate(gordo_server_fleet_requests_total"
                    "[1m])) by (endpoint, status)",
                    "legend": "{{endpoint}} {{status}}",
                }
            ],
            panel_id=1,
            x=0,
            y=0,
            unit="reqps",
            description=(
                "Counters summed across every worker shard at scrape — no "
                "prometheus_client multiprocess dir involved"
            ),
        ),
        _timeseries(
            "Fleet request latency p50 / p99",
            [
                {
                    "expr": (
                        "histogram_quantile(0.5, sum(rate("
                        "gordo_server_fleet_request_seconds_bucket[5m]"
                        ")) by (le, endpoint))"
                    ),
                    "legend": "p50 {{endpoint}}",
                },
                {
                    "expr": (
                        "histogram_quantile(0.99, sum(rate("
                        "gordo_server_fleet_request_seconds_bucket[5m]"
                        ")) by (le, endpoint))"
                    ),
                    "legend": "p99 {{endpoint}}",
                },
            ],
            panel_id=2,
            x=_PANEL_W,
            y=0,
            unit="s",
            description=(
                "Per-worker histograms merge element-wise before exposition, "
                "so these quantiles are fleet-exact up to the bucket ladder"
            ),
        ),
        _timeseries(
            "Device duty cycle & online MFU",
            [
                {
                    "expr": 'max(gordo_server_device_busy_ratio'
                    '{worker=""} or gordo_server_device_busy_ratio)',
                    "legend": "busy ratio",
                },
                {
                    "expr": 'max(gordo_server_device_mfu{worker=""} '
                    "or gordo_server_device_mfu)",
                    "legend": "online MFU",
                },
            ],
            panel_id=3,
            x=0,
            y=_PANEL_H,
            unit="percentunit",
            description=(
                "Busy ratio: fraction of the sampling interval the "
                "dispatcher spent inside fused device calls "
                "(gordo_server_device_busy_seconds_total differentiated). "
                "MFU: achieved FLOP/s "
                "(gordo_server_device_flops_total, useful lanes only) over "
                "the chip peak — table, env, or measured-GEMM fallback"
            ),
        ),
        _timeseries(
            "Device memory",
            [
                {
                    "expr": "sum(gordo_server_device_memory_bytes) "
                    "by (device, stat)",
                    "legend": "dev{{device}} {{stat}}",
                }
            ],
            panel_id=4,
            x=_PANEL_W,
            y=_PANEL_H,
            unit="bytes",
        ),
        _timeseries(
            "Param-bank residency & program cache",
            [
                {
                    "expr": "sum(gordo_server_param_bank_bytes)",
                    "legend": "bank bytes",
                },
                {
                    "expr": "max(gordo_server_param_bank_occupancy)",
                    "legend": "occupancy",
                },
                {
                    "expr": "sum(gordo_server_program_cache_entries)",
                    "legend": "compiled programs",
                },
            ],
            panel_id=5,
            x=0,
            y=2 * _PANEL_H,
        ),
        _timeseries(
            "SLO burn rates (worst model)",
            [
                {
                    "expr": "max(gordo_server_slo_error_burn_rate) "
                    "by (window)",
                    "legend": "error burn {{window}}",
                },
                {
                    "expr": "max(gordo_server_slo_latency_burn_rate) "
                    "by (window)",
                    "legend": "latency burn {{window}}",
                },
            ],
            panel_id=6,
            x=_PANEL_W,
            y=2 * _PANEL_H,
            description=(
                "Burn rate 1.0 = consuming budget exactly as fast as "
                "allowed; the classic multi-window page rule is short-"
                "window burn > 14.4 AND long-window burn > 1"
            ),
        ),
        _timeseries(
            "Per-model p99 vs objective",
            [
                {
                    "expr": 'max(gordo_server_slo_p99_ms{window="5m"}) '
                    "by (model)",
                    "legend": "{{model}}",
                }
            ],
            panel_id=7,
            x=0,
            y=3 * _PANEL_H,
            unit="ms",
            description=(
                "Rolling-window p99 per model (gordo_server_slo_requests "
                "carries the sample counts behind each point); compare "
                "against the GORDO_TPU_SLO_P99_MS objective"
            ),
        ),
        _stat(
            "Workers in fleet view",
            "max(gordo_server_fleet_workers)",
            panel_id=8,
            x=_PANEL_W,
            y=3 * _PANEL_H,
        ),
        _stat(
            "Device busy seconds (total)",
            "sum(gordo_server_device_busy_seconds_total)",
            panel_id=9,
            x=_PANEL_W + 6,
            y=3 * _PANEL_H,
            unit="s",
        ),
    ]
    return _dashboard("Gordo TPU fleet", "gordo-tpu-fleet", panels)


def gateway_dashboard() -> Dict[str, Any]:
    """Serving gateway dashboard over the gordo_gateway_*
    family (server/gateway.py): ring occupancy, per-node liveness and
    latency burn, hedge/failover rates, drain events and breaker state.
    Gateway series live in the telemetry registry with node/reason/state
    labels and no project label — panels query unselected names."""
    panels = [
        _timeseries(
            "Routed requests by node and status",
            [
                {
                    "expr": "sum(rate(gordo_gateway_requests_total[1m])) "
                    "by (node, status)",
                    "legend": "{{node}} {{status}}",
                }
            ],
            panel_id=1,
            x=0,
            y=0,
            unit="reqps",
            description=(
                'node="none" marks requests the gateway answered itself: '
                "no live nodes (503) or every replica failed (502)"
            ),
        ),
        _timeseries(
            "Proxy latency p50 / p99",
            [
                {
                    "expr": (
                        "histogram_quantile(0.5, sum(rate("
                        "gordo_gateway_proxy_seconds_bucket[5m]"
                        ")) by (le, node))"
                    ),
                    "legend": "p50 {{node}}",
                },
                {
                    "expr": (
                        "histogram_quantile(0.99, sum(rate("
                        "gordo_gateway_proxy_seconds_bucket[5m]"
                        ")) by (le, node))"
                    ),
                    "legend": "p99 {{node}}",
                },
            ],
            panel_id=2,
            x=_PANEL_W,
            y=0,
            unit="s",
            description=(
                "Gateway-side wall time per routed request (placement + "
                "upstream + any hedge); compare against the node-side "
                "serving histograms for the routing overhead"
            ),
        ),
        _timeseries(
            "Ring occupancy by node",
            [
                {
                    "expr": "max(gordo_gateway_ring_share) by (node)",
                    "legend": "{{node}}",
                }
            ],
            panel_id=3,
            x=0,
            y=_PANEL_H,
            unit="percentunit",
            description=(
                "Fraction of the consistent-hash ring each node owns "
                "(GORDO_TPU_GATEWAY_VNODES smooths this); a dead node's "
                "share redistributes to its ring successors"
            ),
        ),
        _timeseries(
            "Node health & latency burn",
            [
                {
                    "expr": "max(gordo_gateway_nodes) by (state)",
                    "legend": "{{state}} nodes",
                },
                {
                    "expr": "max(gordo_gateway_node_latency_burn_rate) "
                    "by (node)",
                    "legend": "burn {{node}}",
                },
            ],
            panel_id=4,
            x=_PANEL_W,
            y=_PANEL_H,
            description=(
                "Per-node 5m latency burn from each node's /debug/slo; "
                "past GORDO_TPU_GATEWAY_DRAIN_BURN the node is marked "
                "draining and its segment pre-warms on the successors"
            ),
        ),
        _timeseries(
            "Hedges and failovers",
            [
                {
                    "expr": "sum(rate(gordo_gateway_hedges_total[5m])) "
                    "by (reason)",
                    "legend": "hedge {{reason}}",
                },
                {
                    "expr": "sum(rate(gordo_gateway_failovers_total[5m])) "
                    "by (node)",
                    "legend": "failover from {{node}}",
                },
            ],
            panel_id=5,
            x=0,
            y=2 * _PANEL_H,
            description=(
                "A hedge is one budgeted retry against the next ring "
                "replica (connect failure or upstream 503); sustained "
                "failovers from one node mean its shard is being served "
                "by successors"
            ),
        ),
        _timeseries(
            "Drain events & breaker state",
            [
                {
                    "expr": "sum(rate(gordo_gateway_drain_events_total"
                    "[5m])) by (node)",
                    "legend": "drain {{node}}",
                },
                {
                    "expr": "max(gordo_gateway_breaker_state) by (node)",
                    "legend": "breaker {{node}}",
                },
            ],
            panel_id=6,
            x=_PANEL_W,
            y=2 * _PANEL_H,
            description=(
                "Breaker state: 0 closed, 0.5 half-open (one probe in "
                "flight), 1 open (node skipped at placement)"
            ),
        ),
        _stat(
            "Live nodes",
            'max(gordo_gateway_nodes{state="live"})',
            panel_id=7,
            x=0,
            y=3 * _PANEL_H,
        ),
        _stat(
            "Draining nodes",
            'max(gordo_gateway_nodes{state="draining"})',
            panel_id=8,
            x=6,
            y=3 * _PANEL_H,
        ),
        _stat(
            "Prewarm touches",
            "sum(gordo_gateway_prewarm_total)",
            panel_id=9,
            x=_PANEL_W,
            y=3 * _PANEL_H,
        ),
        _stat(
            "Failovers (total)",
            "sum(gordo_gateway_failovers_total)",
            panel_id=10,
            x=_PANEL_W + 6,
            y=3 * _PANEL_H,
        ),
        _timeseries(
            "Proxy latency p99 with trace exemplars",
            [
                {
                    "expr": (
                        "histogram_quantile(0.99, sum(rate("
                        "gordo_gateway_proxy_seconds_bucket[5m]"
                        ")) by (le))"
                    ),
                    "legend": "p99",
                    "exemplar": True,
                },
            ],
            panel_id=11,
            x=0,
            y=4 * _PANEL_H,
            unit="s",
            description=(
                "Each exemplar dot carries a trace_id from the gateway's "
                "flight recorder; follow it with `gordo trace <id>` or "
                "GET /debug/flight?trace=<id> for the stitched "
                "gateway+node span tree of that exact request"
            ),
        ),
        _timeseries(
            "Trace stitch outcomes",
            [
                {
                    "expr": "sum(rate(gordo_gateway_trace_stitches_total"
                    "[5m])) by (outcome)",
                    "legend": "{{outcome}}",
                }
            ],
            panel_id=12,
            x=_PANEL_W,
            y=4 * _PANEL_H,
            unit="reqps",
            description=(
                "Cross-node stitch results from /debug/flight?trace=: "
                "'full' grafted every upstream subtree, 'partial' lost a "
                "node (dead or debug gate off), 'gateway_only' proxied "
                "nothing, 'miss' means the trace aged out of the flight "
                "recorder ring (raise GORDO_TPU_FLIGHT_RECENT)"
            ),
        ),
    ]
    return _dashboard("Gordo TPU gateway", "gordo-tpu-gateway", panels)


def drift_dashboard() -> Dict[str, Any]:
    """Self-healing drift-loop dashboard over the drift
    detector, rebuild queue, and hot-swap metrics (observability/drift.py,
    builder/drift_rebuild.py, server/hotswap.py). These series live in
    the telemetry registry with a model label and no project label —
    panels query unselected names like the other telemetry dashboards."""
    panels = [
        _timeseries(
            "Drift events by model",
            [
                {
                    "expr": "sum(rate(gordo_server_drift_events_total"
                    "[5m])) by (model)",
                    "legend": "{{model}}",
                }
            ],
            panel_id=1,
            x=0,
            y=0,
            description=(
                "CUSUM trigger crossings on the serving-path "
                "reconstruction-error statistic; hysteresis (the "
                "GORDO_TPU_DRIFT_COOLDOWN_S re-arm) keeps a flapping "
                "model from storming the rebuild queue"
            ),
        ),
        _timeseries(
            "Warm-start drift rebuilds by model",
            [
                {
                    "expr": "sum(rate(gordo_build_drift_rebuilds_total"
                    "[5m])) by (model)",
                    "legend": "{{model}}",
                }
            ],
            panel_id=2,
            x=_PANEL_W,
            y=0,
            description=(
                "Machines rebuilt by the drift-rebuilder into delta "
                "revision dirs; should track drift events ~1:1 — a gap "
                "means the queue is backing up or builds are failing"
            ),
        ),
        _timeseries(
            "Hot swaps & failures",
            [
                {
                    "expr": "sum(rate(gordo_server_hot_swaps_total[5m])) "
                    "by (model)",
                    "legend": "swap {{model}}",
                },
                {
                    "expr": "sum(rate("
                    "gordo_server_hot_swap_failures_total[5m])) by (model)",
                    "legend": "FAILED {{model}}",
                },
            ],
            panel_id=3,
            x=0,
            y=_PANEL_H,
            description=(
                "Zero-downtime cutovers on the serving nodes (param-bank "
                "slot overwrite + revision pointer flip); a failed swap "
                "leaves the old revision serving and retries next poll"
            ),
        ),
        _timeseries(
            "Rebuild queue depth & drifted models",
            [
                {
                    "expr": "max(gordo_server_drift_queue_depth)",
                    "legend": "queue depth",
                },
                {
                    "expr": "max(gordo_server_drifted_models)",
                    "legend": "drifted models",
                },
            ],
            panel_id=4,
            x=_PANEL_W,
            y=_PANEL_H,
            description=(
                "Pending rebuild requests in the drift queue and models "
                "currently past threshold; both should return to zero "
                "after the loop closes (rebuild + swap + recalibrate)"
            ),
        ),
        _stat(
            "Drift events (total)",
            "sum(gordo_server_drift_events_total)",
            panel_id=5,
            x=0,
            y=2 * _PANEL_H,
        ),
        _stat(
            "Drift rebuilds (total)",
            "sum(gordo_build_drift_rebuilds_total)",
            panel_id=6,
            x=6,
            y=2 * _PANEL_H,
        ),
        _stat(
            "Hot swaps (total)",
            "sum(gordo_server_hot_swaps_total)",
            panel_id=7,
            x=_PANEL_W,
            y=2 * _PANEL_H,
        ),
        _stat(
            "Swap failures (total)",
            "sum(gordo_server_hot_swap_failures_total)",
            panel_id=8,
            x=_PANEL_W + 6,
            y=2 * _PANEL_H,
        ),
    ]
    return _dashboard("Gordo TPU drift loop", "gordo-tpu-drift", panels)


def chaos_dashboard() -> Dict[str, Any]:
    """Availability-under-abuse dashboard over the chaos
    conductor's drill metrics (chaos/conductor.py). A drill publishes
    its availability, failover bound, fired fault actions and invariant
    verdicts into the telemetry registry, so a scrape during `gordo
    chaos run` (or the bench `abuse` section) lands here."""
    panels = [
        _timeseries(
            "Fault actions fired",
            [
                {
                    "expr": "sum(rate(gordo_server_chaos_actions_total"
                    "[5m])) by (action)",
                    "legend": "{{action}}",
                }
            ],
            panel_id=1,
            x=0,
            y=0,
            description=(
                "Timeline actions the conductor executed against the "
                "drill stack (kill_node, stop_node, lease corruption, "
                "gateway connection drops, fault-plan swaps)"
            ),
        ),
        _timeseries(
            "Invariant failures",
            [
                {
                    "expr": "sum(rate("
                    "gordo_server_chaos_invariant_failures_total[5m])) "
                    "by (invariant)",
                    "legend": "FAILED {{invariant}}",
                }
            ],
            panel_id=2,
            x=_PANEL_W,
            y=0,
            description=(
                "Machine-checked invariants (availability floor, "
                "zero-5xx, failover bound, breaker scoping, exact "
                "histogram merge) that did NOT hold — any point on this "
                "panel is a failed drill"
            ),
        ),
        _stat(
            "Drill availability",
            "max(gordo_server_chaos_availability_ratio)",
            panel_id=3,
            x=0,
            y=_PANEL_H,
            unit="percentunit",
        ),
        _stat(
            "Failover (kill to recovery)",
            "max(gordo_server_chaos_failover_seconds)",
            panel_id=4,
            x=6,
            y=_PANEL_H,
            unit="s",
        ),
        _stat(
            "Actions fired (total)",
            "sum(gordo_server_chaos_actions_total)",
            panel_id=5,
            x=_PANEL_W,
            y=_PANEL_H,
        ),
        _stat(
            "Invariant failures (total)",
            "sum(gordo_server_chaos_invariant_failures_total)",
            panel_id=6,
            x=_PANEL_W + 6,
            y=_PANEL_H,
        ),
    ]
    return _dashboard("Gordo TPU chaos drills", "gordo-tpu-chaos", panels)


def perf_dashboard() -> Dict[str, Any]:
    """Self-observing perf plane: the latency-attribution
    gauge block, the perf-regression sentinel, and the sampling profiler
    (observability/attribution.py, sentinel.py, profiler.py). Like the
    drift dashboard these are telemetry-registry series without a
    project label, so panels query unselected names."""
    panels = [
        _timeseries(
            "Per-phase p99 latency",
            [
                {
                    "expr": "max(gordo_server_phase_p99_seconds) "
                    "by (phase)",
                    "legend": "{{phase}}",
                }
            ],
            panel_id=1,
            x=0,
            y=0,
            unit="s",
            description=(
                "p99 of each serving phase (decode/predict/encode, the "
                "derived in-server remainder, the client total) over the "
                "current attribution window — the series /debug/perf "
                "decomposes a headline move against"
            ),
        ),
        _timeseries(
            "Per-phase p50 latency",
            [
                {
                    "expr": "max(gordo_server_phase_p50_seconds) "
                    "by (phase)",
                    "legend": "{{phase}}",
                }
            ],
            panel_id=2,
            x=_PANEL_W,
            y=0,
            unit="s",
            description=(
                "Median of each serving phase over the current "
                "attribution window; a p99 move without a p50 move is a "
                "tail problem, both moving is a throughput problem"
            ),
        ),
        _timeseries(
            "Perf-regression events by phase",
            [
                {
                    "expr": "sum(rate(gordo_server_perf_regression_total"
                    "[5m])) by (phase)",
                    "legend": "{{phase}}",
                }
            ],
            panel_id=3,
            x=0,
            y=_PANEL_H,
            description=(
                "Online sentinel fires: a phase's latency CUSUM crossed "
                "GORDO_TPU_PERF_SENTINEL_THRESHOLD against its frozen "
                "post-warmup baseline; each fire attaches the attribution "
                "snapshot and top stacks to /debug/flight"
            ),
        ),
        _timeseries(
            "Sentinel CUSUM by phase",
            [
                {
                    "expr": "max(gordo_server_perf_sentinel_cusum) "
                    "by (phase)",
                    "legend": "{{phase}}",
                }
            ],
            panel_id=4,
            x=_PANEL_W,
            y=_PANEL_H,
            description=(
                "The accumulating one-sided CUSUM statistic per phase "
                "(baseline sigma units): rising toward the threshold "
                "means a persistent slowdown is building before it pages"
            ),
        ),
        _timeseries(
            "Profiler sample rate",
            [
                {
                    "expr": "sum(rate("
                    "gordo_server_profile_samples_total[5m]))",
                    "legend": "samples/s",
                }
            ],
            panel_id=5,
            x=0,
            y=2 * _PANEL_H,
            description=(
                "Stack samples folded per second by the sampling "
                "profiler (GORDO_TPU_PROFILE_HZ steady ticks plus "
                "/debug/profile bursts) — zero means the profiler is "
                "off, a sag under load means the sampler is starved"
            ),
        ),
        _stat(
            "Regressions (1h)",
            "sum(increase(gordo_server_perf_regression_total[1h]))",
            panel_id=6,
            x=_PANEL_W,
            y=2 * _PANEL_H,
        ),
    ]
    return _dashboard(
        "Gordo TPU / Perf plane", "gordo-tpu-perf", panels
    )


def write_dashboards(out_dir: str) -> List[str]:
    """Write the dashboards as JSON files into ``out_dir``; returns paths."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name, build in (
        ("gordo_tpu_servers.json", servers_dashboard),
        ("gordo_tpu_machines.json", machines_dashboard),
        ("gordo_tpu_build.json", build_dashboard),
        ("gordo_tpu_resilience.json", resilience_dashboard),
        ("gordo_tpu_fleet.json", fleet_dashboard),
        ("gordo_tpu_gateway.json", gateway_dashboard),
        ("gordo_tpu_drift.json", drift_dashboard),
        ("gordo_tpu_chaos.json", chaos_dashboard),
        ("gordo_tpu_perf.json", perf_dashboard),
    ):
        path = os.path.join(out_dir, name)
        with open(path, "w") as fh:
            json.dump(build(), fh, indent=2, sort_keys=True)
            fh.write("\n")
        written.append(path)
    return written


if __name__ == "__main__":
    import sys

    target = sys.argv[1] if len(sys.argv) > 1 else "dashboards"
    for p in write_dashboards(target):
        print(p)
