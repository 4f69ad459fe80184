"""
The metric catalog: every build and serve telemetry series in one place,
copied whole from ``gordo_tpu/observability/metrics.py`` (81 series: the
same names, help texts, label names and buckets), so that a dashboard or
an alert written against the JAX package reads the port's ``/metrics``
unchanged. Naming contract: ``gordo_build_*`` for the build paths,
``gordo_server_*`` for serving, ``gordo_gateway_*`` for the routing tier;
every name is ``gordo_``-prefixed with non-empty help.

All series live in the telemetry default registry: process-local, no
prometheus_client, exported by ``batch-build --metrics-file`` (textfile)
and by the server's ``/metrics``.

Who feeds what in the port:

- builder/build_model.py and parallel/batch_trainer.py: the build phases
  (``BUILD_PHASE_SECONDS``), ``BUILD_MACHINES``, ``QUARANTINES``,
  ``OOM_BISECTIONS`` and ``SERIAL_FALLBACKS``;
- server/batcher.py: the queue wait and fuse width, the bank's restacks and
  evictions, bisections, serial rescues, abandons, pipeline overlaps, and
  the device's busy seconds and achieved FLOPs;
- server/views.py (through server/fast_codec.py): the codec counters;
- server/fastlane.py: the idle closes and the event loop's syscalls;
- server/server.py: the fleet request series and model-load failures,
  the flight recorder (flight.py) and the SLO windows (slo.py);
- observability/device.py: busy ratio, MFU, memory, the param banks'
  bytes and occupancy, and ``PROGRAM_CACHE_ENTRIES``, which stays 0: the
  port compiles no serving programs (its fused call is eager torch over
  hand-written kernels), so there is no program cache to count;
- observability/profiler.py: ``PROFILE_SAMPLES``.

Registered and not fed yet, by the ROADMAP.md item that feeds them: the
perf sentinel and attribution (A8's second part: ``PERF_REGRESSIONS``,
``PHASE_P50``, ``PHASE_P99``, ``SENTINEL_CUSUM``); resilience, drift, hot
swaps and warm starts (A9); the gateway and the chaos drills (A3); fault
and bucket retries (A10); the elastic scheduler (A7). With no counterpart
in the port, because it compiles nothing: the XLA persistent cache
(``XLA_CACHE_*``), the bucket-program jit cache (``PROGRAM_CACHE``,
``COMPILE_SECONDS_SAVED``), ``TRACE_COMPILES`` and the AOT serving
executables (``AOT_PROGRAMS``, ``PRELOWER_FAILURES``).
"""

from . import telemetry

# --------------------------------------------------------------- build path
# span-fed phase durations; the span names in parallel/batch_trainer.py and
# builder/build_model.py are the label values (fetch/validate/compile/train/
# serialize/cross_validation/fit)
BUILD_PHASE_SECONDS = telemetry.histogram(
    "gordo_build_phase_seconds",
    "Duration of build phases (fetch, validate, compile, train, serialize, "
    "cross_validation, fit) across the serial and fleet builders",
    ("phase",),
)
BUILD_MACHINES = telemetry.counter(
    "gordo_build_machines_total",
    "Machines leaving a build by outcome: built, cached (registry hit), "
    "or quarantined",
    ("outcome",),
)
FAULT_RETRIES = telemetry.counter(
    "gordo_build_fault_retries_total",
    "Transient-fault retries absorbed by the fault policy (util/faults.py), "
    "by operation key",
    ("operation",),
)
QUARANTINES = telemetry.counter(
    "gordo_build_quarantines_total",
    "Machines quarantined out of a fleet build, by stage "
    "(data_fetch, data_validation, training, serial_build, cache)",
    ("stage",),
)
OOM_BISECTIONS = telemetry.counter(
    "gordo_build_oom_bisections_total",
    "Bucket bisections performed after a device OOM "
    "(each halves the machine axis of one bucket)",
)
BUCKET_RETRIES = telemetry.counter(
    "gordo_build_bucket_retries_total",
    "Whole-bucket retries after a transient training failure",
)
SERIAL_FALLBACKS = telemetry.counter(
    "gordo_build_serial_fallbacks_total",
    "Machines routed to the serial ModelBuilder, by reason "
    "(unbatchable plan vs bucket-failure last resort)",
    ("reason",),
)
PROGRAM_CACHE = telemetry.counter(
    "gordo_build_program_cache_requests_total",
    "In-process bucket-program (jit) cache lookups, by result (hit/miss)",
    ("result",),
)
COMPILE_SECONDS_SAVED = telemetry.counter(
    "gordo_build_compile_seconds_saved_total",
    "Estimated compile seconds avoided by bucket-program cache hits "
    "(each hit credits that program's measured first-compile wall)",
)
XLA_CACHE_ENTRIES = telemetry.gauge(
    "gordo_build_xla_persistent_cache_entries",
    "Entries in the persistent XLA compile cache, measured at cache setup "
    "and again at export",
)
XLA_CACHE_BYTES = telemetry.gauge(
    "gordo_build_xla_persistent_cache_size_bytes",
    "Total size of the persistent XLA compile cache directory",
)
XLA_CACHE_ENTRIES_ADDED = telemetry.counter(
    "gordo_build_xla_persistent_cache_entries_added_total",
    "Entries the persistent XLA cache gained while this process ran "
    "(cold compiles that future builds will skip)",
)

# --------------------------------------- elastic fleet scheduler
# wired by parallel/scheduler.py + parallel/batch_trainer.py; a "steal" is
# any lease of a unit nominally owned by a peer (finish-early rebalance or
# expired-lease takeover)
SCHEDULER_LEASES = telemetry.counter(
    "gordo_build_scheduler_leases_total",
    "Work-unit leases acquired by this host from the shared fleet-build "
    "queue, by kind (fresh: own nominal share; steal: a peer's unit, "
    "either finish-early rebalance or expired-lease takeover)",
    ("kind",),
)
SCHEDULER_LEASE_EXPIRATIONS = telemetry.counter(
    "gordo_build_scheduler_lease_expirations_total",
    "Stale leases this host took over past GORDO_TPU_LEASE_TIMEOUT_S "
    "(the holder stopped heartbeating: host death or a wedged build)",
)
WARM_STARTS = telemetry.counter(
    "gordo_build_warm_starts_total",
    "Machines whose training initialized from the prior artifact's params "
    "(warm-start delta rebuild: config/spec unchanged, only data drifted)",
)
FLEET_MACHINES_REMAINING = telemetry.gauge(
    "gordo_build_fleet_machines_remaining",
    "Machines in fleet-build work units not yet marked done on the shared "
    "queue, sampled each time this host asks for a lease",
)

# ------------------------------------------------------------- serving path
# sub-second buckets: queue waits are bounded by one fused device call
BATCHER_QUEUE_WAIT_SECONDS = telemetry.histogram(
    "gordo_server_batcher_queue_wait_seconds",
    "Time a predict waited in the cross-model batcher queue before its "
    "fused device call started",
    buckets=(
        0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
        0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0, float("inf"),
    ),
)
BATCHER_FUSE_WIDTH = telemetry.histogram(
    "gordo_server_batcher_fuse_width",
    "Number of predicts fused into one device call by the cross-model "
    "batcher",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, float("inf")),
)
PARAM_BANK_RESTACKS = telemetry.counter(
    "gordo_server_param_bank_restacks_total",
    "Full device re-uploads of a param bank (capacity growth past a "
    "power-of-two bucket); warmup pre-registration exists to pay these "
    "before traffic, so steady-state increments indicate model churn",
)
PARAM_BANK_EVICTIONS = telemetry.counter(
    "gordo_server_param_bank_evictions_total",
    "Least-recently-used models evicted in place from a full param bank "
    "(GORDO_TPU_PARAM_BANK_MAX) — the evicted model re-registers into "
    "the freed slot on its next batched predict",
)

# ------------------------------------------------- serving resilience
# wired by server/resilience.py, server/server.py, server/views.py,
# server/batcher.py, server/utils.py
SERVER_SHED = telemetry.counter(
    "gordo_server_shed_total",
    "Requests shed by admission control (503 + Retry-After) instead of "
    "queueing behind a saturated device, by reason",
    ("reason",),
)
SERVER_DEADLINE_EXCEEDED = telemetry.counter(
    "gordo_server_deadline_exceeded_total",
    "Requests that exhausted their deadline budget "
    "(X-Gordo-Deadline-Ms / GORDO_TPU_DEADLINE_MS), by where the budget "
    "ran out (preflight, queue_wait)",
    ("where",),
)
BATCHER_ABANDONED = telemetry.counter(
    "gordo_server_batcher_abandoned_total",
    "Batched predicts whose waiter gave up (timeout or deadline) before "
    "the fused device call fanned results out; abandoned items still "
    "queued are skipped at fan-out instead of computed for nobody",
)
BREAKER_STATE = telemetry.gauge(
    "gordo_server_breaker_state",
    "Per-model circuit-breaker state: 0=closed, 1=half-open, 2=open",
    ("model",),
)
BREAKER_OPENS = telemetry.counter(
    "gordo_server_breaker_opens_total",
    "Circuit-breaker open transitions per model (consecutive predict/load "
    "failures crossed the threshold, or a permanent-class fault)",
    ("model",),
)
BREAKER_FAST_FAILURES = telemetry.counter(
    "gordo_server_breaker_fast_failures_total",
    "Requests answered by an open circuit breaker (fast 503 naming the "
    "model) without touching the model",
    ("model",),
)
GROUP_BISECTIONS = telemetry.counter(
    "gordo_server_group_bisections_total",
    "Fused-group device-call failures answered by bisecting the batch and "
    "retrying the halves (serving twin of the build-side OOM bisection)",
)
GROUP_SERIAL_RESCUES = telemetry.counter(
    "gordo_server_group_serial_rescues_total",
    "Single predicts retried through the serial (un-fused) program after "
    "their fused group failed — the last rung of the serving ladder",
)
WATCHDOG_TRIPS = telemetry.counter(
    "gordo_server_watchdog_trips_total",
    "Healthcheck probes answered 503 because the batcher dispatcher has "
    "been stuck in one device call past GORDO_TPU_WATCHDOG_S",
)
# --------------------------------------------------- serving codec
# wired by server/views.py around server/fast_codec.py
FAST_CODEC = telemetry.counter(
    "gordo_server_fast_codec_total",
    "Request frames that took the numpy-native codec fast path, by op "
    "(decode: payload parsed straight to a contiguous ndarray; encode: "
    "response serialized off the frame's blocks)",
    ("op",),
)
FAST_CODEC_FALLBACK = telemetry.counter(
    "gordo_server_fast_codec_fallback_total",
    "Request frames that fell back to the pandas codec path while the fast "
    "codec was enabled (multi-level / ragged / non-numeric payloads, "
    "non-canonical response frames), by op",
    ("op",),
)
# ----------------------------------------- event-loop fast lane
# wired by server/fastlane.py (both the selectors event loop and the
# thread-per-connection fallback lane) and ops/train.py
FASTLANE_IDLE_CLOSES = telemetry.counter(
    "gordo_server_fastlane_idle_closes_total",
    "Keep-alive connections the fast lane closed for sitting idle between "
    "requests past GORDO_TPU_FASTLANE_IDLE_S (event-loop sweep or thread "
    "lane socket timeout); mid-request stalls are governed separately by "
    "the request timeout",
)
FASTLANE_SYSCALLS = telemetry.counter(
    "gordo_server_fastlane_syscalls_total",
    "Socket syscalls issued by the event-loop fast lane, by op (recv: one "
    "per coalesced read; send: one per flush write — a vectored sendmsg "
    "covering a whole pipelined burst counts once). The numerator of the "
    "bench's syscalls-per-request key: writev batching should hold sends "
    "at O(1) per readiness event, not O(k) for a k-deep pipeline",
    ("op",),
)
TRACE_COMPILES = telemetry.counter(
    "gordo_server_trace_compiles_total",
    "jit trace+compile events in the serving path (incremented inside the "
    "traced function bodies, which only execute while tracing); warmup "
    "AOT pre-lowering exists to pay these before traffic, so a non-zero "
    "steady-state rate means requests are eating compile walls",
)
# ------------------------------- build-to-serve AOT programs
# wired by server/batcher.py (prelower / load_shipped) and server/warmup.py
AOT_PROGRAMS = telemetry.counter(
    "gordo_server_aot_programs_total",
    "Fused serving executables that entered the batcher's AOT program "
    "cache, by source: shipped (deserialized from the artifact's "
    "programs/ manifest — no trace, no XLA compile), compiled (lowered "
    "and compiled fresh at warmup), or rejected (a shipped manifest whose "
    "host fingerprint differs on real ISA features — never executed, the "
    "jit path serves instead)",
    ("source",),
)
PRELOWER_FAILURES = telemetry.counter(
    "gordo_server_prelower_failures_total",
    "AOT pre-lower attempts that failed and fell back to the lazy jit "
    "path (prelower is best-effort per fuse width; before this counter "
    "the failures were log-only and a cold fuse bucket at serve time had "
    "no signal to explain it)",
)
# ------------------------------------------------ flight recorder
# wired by observability/flight.py; read back through /debug/flight
FLIGHT_RECORDED = telemetry.counter(
    "gordo_server_flight_recorded_total",
    "Request traces kept by the flight recorder's tail sampling, by kept "
    "class (error: any 4xx/5xx incl. shed/504/breaker; slow: wall time "
    "over the GORDO_TPU_FLIGHT_SLOW_S or adaptive p99-ish threshold)",
    ("cls",),
)
FLIGHT_OCCUPANCY = telemetry.gauge(
    "gordo_server_flight_traces",
    "Traces currently held in the flight recorder's ring buffer, by class "
    "(each class has its own bounded ring, so errors are never evicted by "
    "a flood of slow-but-successful requests)",
    ("cls",),
)
MODEL_LOAD_FAILURES = telemetry.counter(
    "gordo_server_model_load_failures_total",
    "Model-load failures in the serving path, by kind: fresh (a real "
    "deserialize attempt failed, now negative-cached) or cached (the "
    "TTL'd negative cache answered without re-reading the artifact)",
    ("kind",),
)

# --------------------------------------- fleet observability plane
# cross-worker aggregation: observability/shared.py merges per-process
# telemetry shards (GORDO_TPU_TELEMETRY_DIR) into the fleet /metrics view
FLEET_WORKERS = telemetry.gauge(
    "gordo_server_fleet_workers",
    "Telemetry shards merged into the fleet view at the last scrape "
    "(live worker processes writing under GORDO_TPU_TELEMETRY_DIR)",
)
FLEET_REQUESTS = telemetry.counter(
    "gordo_server_fleet_requests_total",
    "Requests observed by the dependency-free fleet telemetry plane, by "
    "matched endpoint rule and status class (summed across workers at "
    "scrape; the per-worker prometheus_client counters remain the "
    "per-status-code detail view)",
    ("endpoint", "status"),
)
FLEET_REQUEST_SECONDS = telemetry.histogram(
    "gordo_server_fleet_request_seconds",
    "End-to-end request wall time observed by the fleet telemetry plane "
    "(per-worker histograms merge element-wise at scrape, so fleet "
    "quantiles are exact up to the bucket ladder)",
    ("endpoint",),
)

# device telemetry (observability/device.py): sampled at shard flush and
# at /metrics / /debug/vars time — never from a background thread
DEVICE_BUSY_SECONDS = telemetry.counter(
    "gordo_server_device_busy_seconds_total",
    "Cumulative wall seconds the batcher dispatcher spent inside fused "
    "(or serial-rescue) device calls — the duty-cycle numerator",
)
DEVICE_BUSY_RATIO = telemetry.gauge(
    "gordo_server_device_busy_ratio",
    "Fraction of the last sampling interval the dispatcher spent inside "
    "device calls (0 = idle accelerator, 1 = dispatch-bound)",
)
DEVICE_FLOPS = telemetry.counter(
    "gordo_server_device_flops_total",
    "Achieved forward FLOPs of fused serving device calls (useful lanes "
    "only — padding lanes excluded), per ops/flops.py analytic accounting",
)
DEVICE_MFU = telemetry.gauge(
    "gordo_server_device_mfu",
    "Online serving MFU: achieved FLOP/s over the last sampling interval "
    "divided by the chip peak (table, env override, or measured GEMM "
    "fallback — ops/flops.py peak_flops_with_source)",
)
DEVICE_MEMORY = telemetry.gauge(
    "gordo_server_device_memory_bytes",
    "JAX device memory stats (bytes_in_use, peak_bytes_in_use, "
    "bytes_limit) per local device; absent on backends without "
    "memory_stats (CPU)",
    ("device", "stat"),
)
DEVICE_PIPELINE_OVERLAPS = telemetry.counter(
    "gordo_server_device_pipeline_overlaps_total",
    "Fused device calls the batcher dispatched while a previous call's "
    "results were still in flight (GORDO_TPU_DEVICE_PIPELINE): each count "
    "is a drain (D2H + fan-out) that overlapped the next call's stage + "
    "compute instead of serializing after it — 0 under strict-serial "
    "fallback or an idle lane, climbing toward one-per-call under load",
)
PARAM_BANK_BYTES = telemetry.gauge(
    "gordo_server_param_bank_bytes",
    "Device-resident bytes held by the cross-model batcher's stacked "
    "param banks (all specs summed)",
)
PARAM_BANK_OCCUPANCY = telemetry.gauge(
    "gordo_server_param_bank_occupancy",
    "Used fraction of the param banks' stacked capacity (used slots over "
    "power-of-two capacity, all specs pooled)",
)
PROGRAM_CACHE_ENTRIES = telemetry.gauge(
    "gordo_server_program_cache_entries",
    "Compiled serving programs resident in the batcher's lru_caches "
    "(stacked-apply + serial-rescue variants)",
)

# per-model SLOs (observability/slo.py): rolling 5m/1h windows, burn rates
# against GORDO_TPU_SLO_P99_MS / GORDO_TPU_SLO_ERROR_BUDGET
SLO_REQUESTS = telemetry.gauge(
    "gordo_server_slo_requests",
    "Requests in the model's rolling SLO window",
    ("model", "window"),
)
SLO_P99_MS = telemetry.gauge(
    "gordo_server_slo_p99_ms",
    "Observed p99 latency (ms) over the model's rolling SLO window",
    ("model", "window"),
)
SLO_ERROR_BURN = telemetry.gauge(
    "gordo_server_slo_error_burn_rate",
    "Error-budget burn rate over the window: observed 5xx fraction / "
    "GORDO_TPU_SLO_ERROR_BUDGET (1.0 = burning exactly at budget; the "
    "classic page threshold is 14.4 on the short window)",
    ("model", "window"),
)
SLO_LATENCY_BURN = telemetry.gauge(
    "gordo_server_slo_latency_burn_rate",
    "Latency-objective burn rate over the window: fraction of requests "
    "slower than GORDO_TPU_SLO_P99_MS divided by the 1 percent allowance "
    "(>1 means the p99 objective is being missed)",
    ("model", "window"),
)

# ----------------------------------------------------------- serving gateway
# the cross-node gateway (server/gateway.py): consistent-hash placement over
# lease-registered nodes, hedged failover, SLO-burn-driven drain. Naming
# contract extension: ``gordo_gateway_*`` for the routing tier (the lint and
# the gateway dashboard read these same objects).
GATEWAY_REQUESTS = telemetry.counter(
    "gordo_gateway_requests_total",
    "Requests routed through the gateway, by upstream node and response "
    "status (status 502 with node 'none' means no live node could serve)",
    ("node", "status"),
)
GATEWAY_PROXY_SECONDS = telemetry.histogram(
    "gordo_gateway_proxy_seconds",
    "End-to-end gateway routing time per request (placement + upstream "
    "proxy + any hedged retry), by upstream node that finally answered",
    ("node",),
)
GATEWAY_HEDGES = telemetry.counter(
    "gordo_gateway_hedges_total",
    "Budgeted hedge attempts: requests re-sent to the next replica in ring "
    "order, by trigger (connect, status_503, transient)",
    ("reason",),
)
GATEWAY_FAILOVERS = telemetry.counter(
    "gordo_gateway_failovers_total",
    "Requests answered by a replica other than their ring-primary node, "
    "by the node that was failed away from",
    ("node",),
)
GATEWAY_NODES = telemetry.gauge(
    "gordo_gateway_nodes",
    "Membership-directory node counts by state (live, draining, dead); "
    "dead = lease older than GORDO_TPU_LEASE_TIMEOUT_S",
    ("state",),
)
GATEWAY_RING_SHARE = telemetry.gauge(
    "gordo_gateway_ring_share",
    "Fraction of the consistent-hash ring owned by each live node "
    "(vnode-weighted; sums to 1 over the fleet)",
    ("node",),
)
GATEWAY_DRAIN_EVENTS = telemetry.counter(
    "gordo_gateway_drain_events_total",
    "Graceful-drain transitions: a node's latency burn crossed "
    "GORDO_TPU_GATEWAY_DRAIN_BURN and its ring segment spilled to "
    "neighbors",
    ("node",),
)
GATEWAY_NODE_BURN = telemetry.gauge(
    "gordo_gateway_node_latency_burn_rate",
    "Worst-model 5m latency burn rate per node as read from its "
    "/debug/slo endpoint by the gateway health poller",
    ("node",),
)
GATEWAY_BREAKER_STATE = telemetry.gauge(
    "gordo_gateway_breaker_state",
    "Per-node gateway circuit breaker: 0 closed, 1 open "
    "(0.5 half-open probe window)",
    ("node",),
)
GATEWAY_TRACE_STITCHES = telemetry.counter(
    "gordo_gateway_trace_stitches_total",
    "Cross-node trace-stitch requests (/debug/flight?trace=<id>), by "
    "outcome: full (every node subtree grafted), partial (some nodes "
    "unreachable/gated — the stitched doc says which), gateway_only (no "
    "node subtree could be fetched), miss (the gateway never kept the id)",
    ("outcome",),
)
GATEWAY_PREWARMS = telemetry.counter(
    "gordo_gateway_prewarm_total",
    "Successor pre-warm touches issued when a node starts draining "
    "(metadata pre-registration on the machine's next replica), by "
    "warmed node",
    ("node",),
)

# -------------------------------------- self-healing drift loop
# wired by observability/drift.py (detect), parallel/drift_queue.py +
# builder/drift_rebuild.py (trigger/rebuild), server/hotswap.py (swap)
DRIFT_EVENTS = telemetry.counter(
    "gordo_server_drift_events_total",
    "Drift events emitted by the online detector: a model's reconstruction"
    "-error CUSUM crossed GORDO_TPU_DRIFT_THRESHOLD (one event per drift "
    "episode — hysteresis suppresses repeats until rebuild or cooldown)",
    ("model",),
)
DRIFTED_MODELS = telemetry.gauge(
    "gordo_server_drifted_models",
    "Models currently in the drifted state on this worker (detected, "
    "awaiting rebuild + hot-swap)",
)
DRIFT_QUEUE_DEPTH = telemetry.gauge(
    "gordo_server_drift_queue_depth",
    "Rebuild requests pending in the drift queue dir "
    "(GORDO_TPU_DRIFT_QUEUE_DIR), sampled on telemetry flushes",
)
DRIFT_REBUILDS = telemetry.counter(
    "gordo_build_drift_rebuilds_total",
    "Machines rebuilt by the drift rebuilder (warm-start delta rebuilds "
    "drained from the drift queue into a delta revision dir)",
    ("model",),
)
HOT_SWAPS = telemetry.counter(
    "gordo_server_hot_swaps_total",
    "Model revisions hot-swapped into serving with zero downtime (pointer "
    "flip after preload + warm + in-place param-bank replacement)",
    ("model",),
)
HOT_SWAP_FAILURES = telemetry.counter(
    "gordo_server_hot_swap_failures_total",
    "Hot-swap attempts that failed before the pointer flip (the old "
    "artifact keeps serving; the watcher retries next poll)",
    ("model",),
)

# ------------------------------------- self-observing perf plane
# wired by observability/profiler.py (sampling profiler),
# observability/attribution.py (per-phase windows + gauges) and
# observability/sentinel.py (online perf-regression CUSUM)
PROFILE_SAMPLES = telemetry.counter(
    "gordo_server_profile_samples_total",
    "Stack samples folded by the sampling profiler (steady sampler ticks "
    "at GORDO_TPU_PROFILE_HZ plus on-demand /debug/profile bursts), one "
    "per registered hot thread per tick",
)
PERF_REGRESSIONS = telemetry.counter(
    "gordo_server_perf_regression_total",
    "Perf-regression events from the online sentinel: a serving phase's "
    "latency CUSUM crossed GORDO_TPU_PERF_SENTINEL_THRESHOLD against its "
    "post-warmup frozen baseline (one event per episode — hysteresis "
    "suppresses repeats until cooldown)",
    ("phase",),
)
PHASE_P50 = telemetry.gauge(
    "gordo_server_phase_p50_seconds",
    "Median latency of each serving phase (decode/predict/encode, the "
    "derived in-server remainder, and the client total) over the current "
    "attribution window",
    ("phase",),
)
PHASE_P99 = telemetry.gauge(
    "gordo_server_phase_p99_seconds",
    "p99 latency of each serving phase over the current attribution "
    "window (the per-phase series /debug/perf decomposes a headline "
    "move against)",
    ("phase",),
)
SENTINEL_CUSUM = telemetry.gauge(
    "gordo_server_perf_sentinel_cusum",
    "Current one-sided CUSUM statistic of each phase's perf-regression "
    "detector, in baseline sigma units (fires at "
    "GORDO_TPU_PERF_SENTINEL_THRESHOLD)",
    ("phase",),
)

# --------------------------------------------------- chaos conductor
CHAOS_ACTIONS = telemetry.counter(
    "gordo_server_chaos_actions_total",
    "Fault actions fired by the chaos conductor (gordo chaos run): node "
    "kills/stops, lease tampering, connection drops, fault-plan re-arms",
    ("action",),
)
CHAOS_INVARIANT_FAILURES = telemetry.counter(
    "gordo_server_chaos_invariant_failures_total",
    "Chaos-scenario invariants that failed their machine check "
    "(availability floor, failover bound, breaker scoping, exact merge)",
    ("invariant",),
)
CHAOS_AVAILABILITY = telemetry.gauge(
    "gordo_server_chaos_availability_ratio",
    "Measured non-chaff availability of the last chaos drill: successful "
    "requests over scheduled requests, from the exactly-merged log",
)
CHAOS_FAILOVER_SECONDS = telemetry.gauge(
    "gordo_server_chaos_failover_seconds",
    "Seconds from the drill's node kill to the first successful answer "
    "for a machine whose ring primary was the killed node",
)
