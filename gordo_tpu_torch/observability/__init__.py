"""
The port's telemetry and observability plane (ROADMAP.md item A8, first
part): spans and the metric catalog (telemetry.py, metrics.py), request
traces (tracing.py), JSON logs (logs.py), the flight recorder (flight.py),
SLO windows (slo.py), latency histograms (latency.py), the per-process
shards and their fleet view (shared.py), device telemetry read from the
card (device.py) and the sampling profiler with its ``torch.profiler``
device traces (profiler.py). Each module is the counterpart of the module
of the same name in ``gordo_tpu/observability/``.
"""
