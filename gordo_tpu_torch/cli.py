"""
The port's command line, ``python -m gordo_tpu_torch``: the counterparts
of ``gordo build``, ``batch-build``, ``drift-rebuilder``, ``run-server``,
``run-gateway``, ``trace`` and ``chaos`` (``gordo_tpu/cli/cli.py``).

``build MACHINE OUTPUT_DIR`` builds one machine from its config, YAML
(JSON included) given as the argument or in the ``MACHINE`` environment
variable (the output directory likewise, or ``OUTPUT_DIR``), on the card
unless ``--device cpu`` is given. Configs are read as the JAX CLI reads
them with ``yaml.safe_load`` (util/yaml_subset.py). A ``model`` given as a
string is a Jinja template, rendered with the ``--model-parameter
key,value`` pairs (repeatable; the values stay strings until the rendered
text is read as YAML) through the Jinja subset of util/templates.py, then
read as YAML; a parameter the template uses but was not given raises
``ValueError("Model parameter missing value!")``. The model definition is
round-tripped so that every default is recorded, and after the build the
reporters of ``runtime.reporters`` run (reporters/). A failure exits with
the code of its exception's class, as the JAX CLI's table has them (a
reporter's failure 90), and with ``--exceptions-reporter-file``
(``EXCEPTIONS_REPORTER_FILE``) writes the JAX CLI's JSON report of it there
at ``--exceptions-report-level`` (``EXCEPTIONS_REPORT_LEVEL``: ``EXIT_CODE``,
``TYPE``, ``MESSAGE``, the default, or ``TRACEBACK``;
cli_exceptions_reporter.py); ``batch-build`` takes both too.

``batch-build CONFIG_FILE OUTPUT_DIR`` (or ``--output-dir``, as the JAX
command takes it) builds every machine of a project config (YAML, JSON
included) with the fleet trainer (parallel/batch_trainer.py) into
``OUTPUT_DIR/<name>``.
It exits 0 when every machine was built, 81 when some were quarantined and
82 when none was (the JAX CLI's codes), a line on stderr for each
quarantined machine (its stage, reason, attempts and error) and, with
``--quarantine-report-file`` (``GORDO_TPU_QUARANTINE_REPORT_FILE``), the
JSON report ``{"built": n, "quarantined": [record, ...]}``; ``--fail-fast``
stops at the first fault with the code of its exception. ``--trace-file`` (or
``GORDO_TPU_TRACE_FILE``) records the build's telemetry spans and writes
them as Chrome trace-event JSON; ``--metrics-file`` (or
``GORDO_TPU_METRICS_FILE``) writes the metric catalog as a Prometheus
textfile; both are written on every exit path, a partial build's included.
``--warm-start/--no-warm-start`` (``GORDO_TPU_WARM_START``, default on)
lets a machine whose cache key misses start from the artifact its warm key
names in ``--model-register-dir``. ``--drain-drift-queue`` builds, instead
of the whole config, the machines with a pending request in the drift queue
(``--drift-queue-dir``, ``GORDO_TPU_DRIFT_QUEUE_DIR``), their data windows
slid to the detection time, into a delta revision under ``OUTPUT_DIR``
(builder/drift_rebuild.py).

``drift-rebuilder CONFIG_FILE --queue-dir DIR`` drains the drift queue into
delta revisions under ``--output-dir`` (warm starts from
``--model-register-dir``) every ``--poll-interval`` seconds, or once with
``--once``; on the card it builds the kernels before its first drain;
``--metrics-file`` writes the catalog after each drain.

``run-server`` serves the artifacts of ``MODEL_COLLECTION_DIR`` on
``--host`` (an IP address) and ``--port`` (1 to 65535;
``GORDO_SERVER_HOST``, ``GORDO_SERVER_PORT``)
from ``--device``, as the JAX command does: a prefork pool of ``--workers``
processes (1 to 4, default 2, ``GORDO_SERVER_WORKERS``; 1 serves from one
process), each with a thread per connection, on one listener with a
backlog of ``--worker-connections`` (default 50,
``GORDO_SERVER_WORKER_CONNECTIONS``; at least 128); ``--warmup``
(``GORDO_TPU_SERVING_WARMUP``) warms every model in each worker before it
accepts (server/warmup.py). As the JAX command does, it batches predicts
by default: ``--batch-predicts`` (or
``GORDO_SERVER_BATCH_PREDICTS``) exports ``GORDO_TPU_SERVING_BATCH=auto``
before the server starts, ``--no-batch-predicts`` exports ``0``
(server/batcher.py). With ``GORDO_TPU_FAST_LANE=1`` it serves through the
socket fast lane (server/fastlane.py: an event loop, or a thread per
connection with ``GORDO_TPU_FAST_LANE_EVENT_LOOP=0``), as the JAX command
does. The server reads ``ENABLE_PROMETHEUS`` and ``PROJECT`` (its
``/metrics``), and every command ``GORDO_TPU_LOG_FORMAT=json`` (one JSON
object a log line, stamped with the request's trace and span ids:
observability/logs.py), as the JAX CLI reads them. With
``GORDO_TPU_GATEWAY_DIR`` set the server holds a lease in that membership
directory (``GORDO_TPU_GATEWAY_ADVERTISE`` the address it advertises), as
the JAX command's does.

``run-gateway`` runs the cross-node gateway (server/gateway.py) on
``--host`` (an IP address) and ``--port`` (``GORDO_GATEWAY_HOST``, ``GORDO_GATEWAY_PORT``,
default 5556) over ``--membership-dir`` (``GORDO_TPU_GATEWAY_DIR``). It
initialises no CUDA: the gateway computes nothing.

``trace TRACE_ID`` fetches one request's stitched cross-node trace from a
gateway's ``/debug/flight?trace=`` (``--host``, ``--port`` 5556; ``--out``
keeps the JSON) and prints its span tree and a ``stitch`` line per node, as
the JAX command prints them; it exits 2 when the gateway is unreachable and
1 on another answer than 200.

``chaos run SCENARIO`` runs one chaos drill (chaos/conductor.py; ``--dir``
its working directory, ``--out`` the JSON report, ``--verbose``) and exits
0 only when every invariant holds (a ``.json`` scenario is read as JSON,
any other as YAML); ``chaos list`` lists the scenarios of ``--dir``
(default the port's JSON copies, ``gordo_tpu_torch/chaos/scenarios``).

``workflow generate --machine-config FILE --project-name NAME`` renders the
project's Argo Workflow documents for NVIDIA GPUs
(workflow/workflow_generator.py, ``resources/gpu-workflow.yml.template``)
with the JAX command's options, names, defaults, environment variables
(``WORKFLOW_GENERATOR_*``) and checks; the TPU options are refused (exit 2)
naming their counterpart: ``--machines-per-gpu-worker``, ``--gpu-product``
(``nvidia.com/gpu.product``), one card a pod, or A7. A refused option or
config prints ``Error: <message>`` and exits 1, as click does; the rendered
documents are validated unless ``--no-validate``. ``workflow validate
[FILE]`` (stdin by default) validates rendered documents
(workflow/validate.py).
"""

import argparse
import json
import logging
import os
import sys
import traceback
from typing import List, Optional

from . import serializer
from .builder import ModelBuilder
from .builder.build_model import NonFiniteDataError
from .cli_exceptions_reporter import ExceptionsReporter, ReportLevel
from .custom_types import env_flag as _env_flag, host_ip as _host_ip
from .custom_types import choice, flag_pair, integer
from .custom_types import int_range as _int_range, key_value_par
from .dataset.datasets import InsufficientDataError
from .dataset.sensor_tag import SensorTagNormalizationError
from .machine import Machine
from .reporters.base import ReporterException
from .util import templates, yaml_subset
from .util.faults import EXIT_NONE_BUILT, EXIT_PARTIAL

logger = logging.getLogger(__name__)

EXIT_CODES = (
    (Exception, 1),
    (PermissionError, 20),
    (FileNotFoundError, 30),
    (SensorTagNormalizationError, 60),
    (InsufficientDataError, 80),
    (NonFiniteDataError, 83),
    (ReporterException, 90),
)
_exceptions_reporter = ExceptionsReporter(EXIT_CODES)


def exit_code(exc: BaseException) -> int:
    """The code of the closest class of ``exc`` in :data:`EXIT_CODES`."""
    return _exceptions_reporter.exception_exit_code(type(exc))


def report_exception(exc: BaseException, reporter_file: Optional[str],
                     report_level: str) -> int:
    """What a failed ``build`` or ``batch-build`` does, as the JAX CLI does
    it: the traceback on stderr, the JSON report in ``reporter_file`` where
    one is given (trimmed to a termination message's 2,024 bytes less 500),
    and the exit code of the exception's class, returned."""
    traceback.print_exception(type(exc), exc, exc.__traceback__)
    if reporter_file:
        _exceptions_reporter.safe_report(
            ReportLevel.get_by_name(report_level, ReportLevel.EXIT_CODE), type(exc), exc,
            exc.__traceback__, reporter_file, max_message_len=2024 - 500)
    return exit_code(exc)


def get_all_score_strings(machine: Machine) -> List[str]:
    """Katib-format ``'{metric}_{fold}={value}'`` lines of the CV scores."""
    all_scores = []
    scores = machine.metadata.build_metadata.model.cross_validation.scores
    for metric_name, metric_scores in scores.items():
        metric_name = metric_name.replace(" ", "-")
        for score_name, score_val in metric_scores.items():
            all_scores.append(f"{metric_name}_{score_name.replace(' ', '-')}={score_val}")
    return all_scores


def expand_model(model_config: str, model_parameters: dict):
    """A string model rendered as a Jinja template with
    ``model_parameters``, then read as YAML."""
    try:
        model_config = templates.render(model_config, model_parameters)
    except templates.UndefinedError as exc:
        raise ValueError("Model parameter missing value!") from exc
    return yaml_subset.load(model_config)


def build(machine_config: dict, output_dir: str, model_register_dir: Optional[str] = None,
          print_cv_scores: bool = False, device=None, model_parameter=()) -> None:
    """Build one machine and write its artifact into ``output_dir``; a
    string model is rendered first with the ``model_parameter`` pairs."""
    if isinstance(machine_config.get("model"), str):
        # rendered whenever it is a string, parameters or not, as in JAX
        machine_config["model"] = expand_model(machine_config["model"],
                                               dict(model_parameter or ()))
    machine = Machine.from_config(
        machine_config, project_name=machine_config.get("project_name", "project")
    )
    logger.info("Building, output will be at: %s", output_dir)
    # round-trip the model config so that every default is recorded
    machine.model = serializer.into_definition(serializer.from_definition(machine.model))
    _, machine_out = ModelBuilder(machine, device=device).build(output_dir, model_register_dir)
    machine_out.report()
    if print_cv_scores:
        for score in get_all_score_strings(machine_out):
            print(score)


def batch_build(config_file: str, output_dir: str, project_name: str = "batch",
                machines: str = "", model_register_dir: Optional[str] = None,
                serial_fallback: bool = True, fail_fast: bool = False, device=None,
                trace_file: Optional[str] = None, metrics_file: Optional[str] = None,
                warm_start: Optional[bool] = None, drain_drift_queue: bool = False,
                drift_queue_dir: Optional[str] = None,
                quarantine_report_file: Optional[str] = None) -> int:
    """Build the config's machines (or the comma-separated ``machines`` of
    it) as a fleet, or with ``drain_drift_queue`` those of them the drift
    queue asks for, into a delta revision; returns the exit code.
    ``trace_file`` and ``metrics_file`` receive the build's telemetry,
    written whatever the build's outcome; ``quarantine_report_file`` the
    quarantined machines' records."""
    from .observability import telemetry

    if trace_file:
        telemetry.start_trace()
    elif metrics_file:
        # metrics only: the phase histograms fill, no event buffer grows
        telemetry.enable_spans()
    try:
        return _batch_build(config_file, output_dir, project_name, machines,
                            model_register_dir, serial_fallback, fail_fast, device, warm_start,
                            drain_drift_queue, drift_queue_dir, quarantine_report_file)
    finally:
        _flush_telemetry(trace_file, metrics_file)


def _flush_telemetry(trace_file: Optional[str], metrics_file: Optional[str]) -> None:
    """Write the Chrome trace and/or the Prometheus textfile (atomic
    writes); an export failure is logged, never raised over the build's
    own outcome."""
    from .observability import telemetry

    try:
        if trace_file:
            telemetry.write_trace(trace_file)
            telemetry.stop_trace()
            print(f"telemetry trace written: {trace_file} (open in Perfetto or "
                  "chrome://tracing)", file=sys.stderr)
        if metrics_file:
            telemetry.write_metrics(metrics_file)
            print(f"telemetry metrics written: {metrics_file}", file=sys.stderr)
    except Exception:  # noqa: BLE001 -- export must not mask the build result
        logger.exception("telemetry export failed")


def _project_machines(config_file: str, project_name: str) -> list:
    from .workflow.normalized_config import NormalizedConfig

    with open(config_file) as f:
        config = yaml_subset.load(f)
    return NormalizedConfig(config, project_name=project_name).machines


def _batch_build(config_file: str, output_dir: str, project_name: str, machines: str,
                 model_register_dir: Optional[str], serial_fallback: bool, fail_fast: bool,
                 device, warm_start: Optional[bool], drain_drift_queue: bool,
                 drift_queue_dir: Optional[str], quarantine_report_file: Optional[str]) -> int:
    from .parallel.batch_trainer import BatchedModelBuilder

    selected = _project_machines(config_file, project_name)
    wanted = {name.strip() for name in machines.split(",") if name.strip()}
    if wanted:
        missing = wanted - {m.name for m in selected}
        if missing:
            raise ValueError(f"--machines names not in config: {sorted(missing)}")
        selected = [m for m in selected if m.name in wanted]
    if drain_drift_queue:
        if not drift_queue_dir:
            raise ValueError("--drain-drift-queue needs --drift-queue-dir "
                             "(or GORDO_TPU_DRIFT_QUEUE_DIR)")
        from .builder import drift_rebuild

        report = drift_rebuild.drain_drift_queue(
            selected, drift_queue_dir, output_dir, model_register_dir=model_register_dir,
            warm_start=warm_start, serial_fallback=serial_fallback, fail_fast=fail_fast,
            device=device)
        for name in report["built"]:
            print(f"drift-rebuilt: {name} -> "
                  f"{os.path.join(output_dir, report['revision'], name)}")
        if report["failed"]:
            print(f"drift rebuild failed: {report['failed']}", file=sys.stderr)
            return EXIT_PARTIAL if report["built"] else EXIT_NONE_BUILT
        return 0
    builder = BatchedModelBuilder(
        selected, serial_fallback=serial_fallback, output_dir=output_dir,
        model_register_dir=model_register_dir, fail_fast=fail_fast, device=device,
        warm_start=warm_start,
    )
    results = builder.build()
    for _, machine_out in results:
        machine_out.report()
        print(f"built: {machine_out.name} -> {os.path.join(output_dir, machine_out.name)}")
    return report_quarantine(builder.quarantine_records, len(results), quarantine_report_file)


def report_quarantine(records: list, n_built: int, report_file: Optional[str]) -> int:
    """The fleet build's exit report, as the JAX CLI's: a line on stderr for
    each quarantined machine, the JSON report in ``report_file`` where one
    is given, and the exit code (0 all built, 81 some, 82 none)."""
    for record in records:
        print(f"quarantined: {record.machine} stage={record.stage} reason={record.reason} "
              f"attempts={record.attempts} error={record.error}", file=sys.stderr)
    if report_file:
        with open(report_file, "w") as fh:
            json.dump({"built": n_built, "quarantined": [r.to_dict() for r in records]}, fh,
                      indent=2)
    if records:
        return EXIT_PARTIAL if n_built else EXIT_NONE_BUILT
    return 0


def drift_rebuilder(config_file: str, queue_dir: str, output_dir: str,
                    model_register_dir: Optional[str] = None, project_name: str = "batch",
                    once: bool = False, poll_interval: float = 30.0, device=None,
                    metrics_file: Optional[str] = None) -> int:
    """Drain the drift queue into warm-start delta rebuilds, every
    ``poll_interval`` seconds or ``once``; the kernels are built on the card
    before the first drain. ``metrics_file`` receives the metric catalog as
    a Prometheus textfile after every drain that built or failed."""
    import time

    from . import resolve_device
    from .builder import drift_rebuild
    from .parallel import drift_queue

    if resolve_device(device).type == "cuda":
        from .ops import _build

        _build.build_all()
    machines = _project_machines(config_file, project_name)
    while True:
        if drift_queue.depth(queue_dir):
            try:
                report = drift_rebuild.drain_drift_queue(
                    machines, queue_dir, output_dir, model_register_dir=model_register_dir,
                    device=device)
            finally:
                _flush_telemetry(None, metrics_file)
            if report["built"] or report["failed"]:
                seconds = ", ".join(f"{k} {v:.3f} s" for k, v in report["seconds"].items())
                print(f"drift drain: built={report['built']} failed={report['failed']} "
                      f"revision={report['revision']} ({seconds})", flush=True)
        if once:
            return 0
        time.sleep(poll_interval)


def prepare_run_server(batch_predicts: bool) -> None:
    """What ``run-server`` sets before its server starts: the batching mode,
    which the batcher reads at its first predict."""
    os.environ["GORDO_TPU_SERVING_BATCH"] = "auto" if batch_predicts else "0"


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m gordo_tpu_torch")
    parser.add_argument("--log-level", default=os.environ.get("GORDO_LOG_LEVEL", "INFO"),
                        choices=["CRITICAL", "ERROR", "WARNING", "INFO", "DEBUG"],
                        type=str.upper)
    commands = parser.add_subparsers(dest="command", required=True)
    build_cmd = commands.add_parser("build", help=build.__doc__)
    build_cmd.add_argument("machine_config", nargs="?", default=os.environ.get("MACHINE"),
                           help="the machine's config as YAML or JSON (default: $MACHINE)")
    build_cmd.add_argument("output_dir", nargs="?", default=os.environ.get("OUTPUT_DIR", "/data"),
                           help="where the artifact goes (default: $OUTPUT_DIR or /data)")
    build_cmd.add_argument("--model-register-dir",
                           default=os.environ.get("MODEL_REGISTER_DIR"))
    build_cmd.add_argument("--print-cv-scores", action="store_true",
                           help="print the CV scores to stdout")
    build_cmd.add_argument("--model-parameter", type=key_value_par, action="append",
                           default=[],
                           help="key,value for the model template's variables; repeatable")
    build_cmd.add_argument("--device", default=None, help="cuda (default) or cpu")
    _reporter_options(build_cmd)
    fleet_cmd = commands.add_parser("batch-build", help=batch_build.__doc__)
    fleet_cmd.add_argument("config_file", nargs="?", default=os.environ.get("CONFIG_FILE"),
                           help="the project config, YAML or JSON (default: $CONFIG_FILE)")
    fleet_cmd.add_argument("output_dir", nargs="?", default=os.environ.get("OUTPUT_DIR", "/data"),
                           help="where the artifacts go (default: $OUTPUT_DIR or /data)")
    fleet_cmd.add_argument("--output-dir", dest="output_dir_option", default=None,
                           help="where the artifacts go, as the JAX command takes it (wins "
                                "over OUTPUT_DIR)")
    fleet_cmd.add_argument("--project-name", default=os.environ.get("PROJECT_NAME", "batch"))
    fleet_cmd.add_argument("--machines", default=os.environ.get("MACHINES", ""),
                           help="comma-separated machine names: build only these")
    fleet_cmd.add_argument("--model-register-dir", default=os.environ.get("MODEL_REGISTER_DIR"))
    fleet_cmd.add_argument("--no-serial-fallback", action="store_true",
                           help="fail instead of building unbatchable machines serially")
    fleet_cmd.add_argument("--fail-fast", action="store_true",
                           help="stop at the first fault instead of quarantining the machine")
    fleet_cmd.add_argument("--device", default=None, help="cuda (default) or cpu")
    fleet_cmd.add_argument("--trace-file", default=os.environ.get("GORDO_TPU_TRACE_FILE"),
                           help="write the build's telemetry spans as Chrome trace-event "
                                "JSON to this path (open it in Perfetto)")
    fleet_cmd.add_argument("--metrics-file", default=os.environ.get("GORDO_TPU_METRICS_FILE"),
                           help="write the build's telemetry metrics as a Prometheus "
                                "textfile to this path")
    fleet_cmd.add_argument(
        "--warm-start", action=argparse.BooleanOptionalAction,
        default=_env_flag("GORDO_TPU_WARM_START", True),
        help="a machine whose cache key misses but whose config matches a registered "
             "artifact (only its data moved) starts from that artifact's parameters "
             "(default: on)")
    fleet_cmd.add_argument("--drain-drift-queue", action="store_true",
                           help="build only the machines with a pending drift request "
                                "(--drift-queue-dir), their data windows slid to the detection "
                                "time, into a delta revision under OUTPUT_DIR")
    fleet_cmd.add_argument("--drift-queue-dir",
                           default=os.environ.get("GORDO_TPU_DRIFT_QUEUE_DIR"),
                           help="the drift queue the servers enqueue into")
    fleet_cmd.add_argument("--quarantine-report-file",
                           default=os.environ.get("GORDO_TPU_QUARANTINE_REPORT_FILE"),
                           help="write the quarantined machines and their reasons to this JSON "
                                "file in addition to stderr")
    _reporter_options(fleet_cmd)
    drift_cmd = commands.add_parser("drift-rebuilder", help=drift_rebuilder.__doc__)
    drift_cmd.add_argument("config_file", nargs="?", default=os.environ.get("CONFIG_FILE"),
                           help="the project config, YAML or JSON (default: $CONFIG_FILE)")
    drift_cmd.add_argument("--queue-dir", default=os.environ.get("GORDO_TPU_DRIFT_QUEUE_DIR"),
                           help="the drift queue the servers enqueue into "
                                "(default: $GORDO_TPU_DRIFT_QUEUE_DIR)")
    drift_cmd.add_argument("--output-dir", default=os.environ.get("OUTPUT_DIR", "/data"),
                           help="where the delta revisions go: the parent of the served "
                                "collection (default: $OUTPUT_DIR or /data)")
    drift_cmd.add_argument("--model-register-dir", default=os.environ.get("MODEL_REGISTER_DIR"),
                           help="the register the warm starts read; without it the rebuilds "
                                "start cold")
    drift_cmd.add_argument("--project-name", default=os.environ.get("PROJECT_NAME", "batch"))
    drift_cmd.add_argument("--once", action="store_true",
                           help="one drain pass instead of polling for ever")
    drift_cmd.add_argument("--poll-interval", type=float,
                           default=float(os.environ.get("GORDO_TPU_DRIFT_POLL_S", "30")),
                           help="seconds between queue polls (default 30)")
    drift_cmd.add_argument("--device", default=None, help="cuda (default) or cpu")
    drift_cmd.add_argument("--metrics-file", default=os.environ.get("GORDO_TPU_METRICS_FILE"),
                           help="write the metric catalog as a Prometheus textfile to this "
                                "path after each drain")
    server_cmd = commands.add_parser("run-server", help="Serve MODEL_COLLECTION_DIR's models")
    # string defaults: argparse checks them by their type too, as click
    # checks the values of the environment variables
    server_cmd.add_argument("--host", type=_host_ip,
                            default=os.environ.get("GORDO_SERVER_HOST", "0.0.0.0"))
    server_cmd.add_argument("--port", type=_int_range(1, 65535),
                            default=os.environ.get("GORDO_SERVER_PORT", "5555"))
    server_cmd.add_argument("--device", default=None, help="cuda (default) or cpu")
    server_cmd.add_argument(
        "--batch-predicts", action=argparse.BooleanOptionalAction,
        default=_env_flag("GORDO_SERVER_BATCH_PREDICTS", True),
        help="fuse concurrent predicts of one architecture into one device call, where a "
             "measured A/B at first use finds that it wins (default: on)")
    server_cmd.add_argument("--workers", type=_int_range(1, 4),
                            default=int(os.environ.get("GORDO_SERVER_WORKERS", "2")),
                            help="worker processes of the prefork pool (1-4, default 2)")
    server_cmd.add_argument("--worker-connections", type=_int_range(1, 400),
                            default=int(os.environ.get("GORDO_SERVER_WORKER_CONNECTIONS", "50")),
                            help="the listener's backlog, at least 128 (1-400, default 50)")
    server_cmd.add_argument(
        "--warmup", action=argparse.BooleanOptionalAction,
        default=_env_flag("GORDO_TPU_SERVING_WARMUP", False),
        help="warm every model (its kernel libraries, one predict per row bucket, its "
             "parameters into the batcher's bank) in each worker before it accepts")
    gateway_cmd = commands.add_parser(
        "run-gateway", help="Run the cross-node serving gateway over a membership directory")
    gateway_cmd.add_argument("--host", type=_host_ip,
                             default=os.environ.get("GORDO_GATEWAY_HOST", "0.0.0.0"))
    gateway_cmd.add_argument("--port", type=_int_range(1, 65535),
                             default=os.environ.get("GORDO_GATEWAY_PORT", "5556"))
    gateway_cmd.add_argument("--membership-dir", default=os.environ.get("GORDO_TPU_GATEWAY_DIR"),
                             help="the shared directory the serving nodes heartbeat their leases "
                                  "into (default: $GORDO_TPU_GATEWAY_DIR)")
    trace_cmd = commands.add_parser(
        "trace", help="Fetch and print one request's stitched cross-node trace from a gateway")
    trace_cmd.add_argument("trace_id")
    trace_cmd.add_argument("--host", default="127.0.0.1",
                           help="the gateway's host (a node works too: its subtree)")
    trace_cmd.add_argument("--port", type=int, default=5556, help="the gateway's port (5556)")
    trace_cmd.add_argument("--out", default=None,
                           help="also write the stitched Chrome-trace JSON here")
    chaos_cmd = commands.add_parser("chaos", help="Failure drills against a gateway and a fleet")
    chaos_commands = chaos_cmd.add_subparsers(dest="chaos_command", required=True)
    chaos_run = chaos_commands.add_parser("run", help="Run one scenario; exit 0 iff every "
                                                      "invariant holds")
    chaos_run.add_argument("scenario")
    chaos_run.add_argument("--dir", dest="work_dir", default=None,
                           help="the drill's working directory (leases, drift queue); default a "
                                "fresh temporary directory, removed afterwards")
    chaos_run.add_argument("--out", default=None, help="also write the JSON report here")
    chaos_run.add_argument("--verbose", action="store_true",
                           help="the stack's and the gateway's logs on stderr")
    chaos_list = chaos_commands.add_parser("list", help="List the scenarios and their invariants")
    chaos_list.add_argument("--dir", dest="scenario_dir", default=None,
                            help="a directory of scenarios (default: the port's JSON copies)")
    workflow_cmd = commands.add_parser(
        "workflow", help="Generate workflow documents from machine configs")
    workflow_commands = workflow_cmd.add_subparsers(dest="workflow_command", required=True)
    _workflow_generate_options(workflow_commands.add_parser(
        "generate", help="Generate workflow documents for a machine config."))
    validate_cmd = workflow_commands.add_parser(
        "validate", help="Schema-validate rendered Workflow documents (file or stdin).")
    validate_cmd.add_argument("workflow_file", nargs="?", default="-")
    return parser


WORKFLOW_PREFIX = "WORKFLOW_GENERATOR"
# the JAX generator's TPU options, refused with their counterpart on the card
TPU_OPTIONS = {
    "--machines-per-tpu-worker": "it is --machines-per-gpu-worker on the card (the same "
                                 "chunks of machines)",
    "--tpu-accelerator-type": "it is --gpu-product on the card (the nvidia.com/gpu.product "
                              "node label)",
    "--tpu-topology": "a card has no topology; a builder takes one card, chosen by "
                      "--gpu-product",
    "--tpu-chips-per-worker": "each builder or server pod requests one card "
                              "(nvidia.com/gpu: 1), as one process drives one card",
    "--tpu-workers-per-slice": "multi-worker chunks are A7's (the parallel axes item)",
}


def _refused_option(counterpart: str):
    """An argparse action that refuses its option (exit 2), naming
    ``counterpart``."""
    class Refused(argparse.Action):
        def __init__(self, option_strings, dest, **kwargs):
            super().__init__(option_strings, dest, nargs="?", **kwargs)

        def __call__(self, parser, namespace, values, option_string=None):
            parser.error(f"{option_string} has no counterpart in gordo_tpu_torch: {counterpart}")

    return Refused


def _workflow_generate_options(command: argparse.ArgumentParser) -> None:
    """``workflow generate``'s options: the JAX command's, with the TPU ones
    mapped onto the card (workflow/workflow_generator.py)."""
    from . import __version__
    from .workflow.workflow_generator import DEFAULT_GPU_PRODUCT

    def option(name: str, default=None, type=None, env: bool = True, **kwargs):
        envvar = f"{WORKFLOW_PREFIX}_{name.lstrip('-').upper().replace('-', '_')}"
        value = os.environ.get(envvar, default) if env else default
        command.add_argument(name, default=value, type=type, **kwargs)

    option("--machine-config", help="Machine configuration file (YAML, or a Gordo CRD)")
    option("--workflow-template", env=False, help="Template file to expand")
    option("--project-name", help="Name of the project")
    option("--project-revision", "1")
    option("--output-file", env=False,
           help="Where to write the workflow documents (default: stdout)")
    option("--docker-registry", "ghcr.io/gordo-tpu")
    option("--docker-image", "gordo-tpu")
    option("--gordo-version", __version__, help="Version (docker tag) of gordo-tpu to deploy")
    option("--image-pull-policy", "", choice(["Always", "IfNotPresent", "Never", ""]), env=False,
           help="Override the derived imagePullPolicy")
    option("--retries", "5", integer, help="Retry limit for builder/client tasks")
    option("--machines-per-gpu-worker", "256", integer,
           help="How many machines one batched builder chunk trains on its card")
    option("--gpu-product", DEFAULT_GPU_PRODUCT,
           help="The card builder and server pods run on: the nvidia.com/gpu.product node "
                "label NVIDIA's GPU feature discovery sets")
    for name, counterpart in TPU_OPTIONS.items():
        command.add_argument(name, action=_refused_option(counterpart), default=argparse.SUPPRESS,
                             help=argparse.SUPPRESS)
    option("--server-replicas", "2", integer)
    option("--server-workers", "2", integer)
    option("--ml-server-hpa-type", "cpu", choice(["cpu", "keda"]))
    option("--ml-server-max-replicas", None, integer, help="Default: 10 x number of machines")
    option("--ml-server-min-replicas", None, integer,
           help="Default: --server-replicas (the Deployment itself pins no replica count; the "
                "autoscaler owns scaling)")
    option("--ml-server-hpa-cpu-target", "50", integer)
    option("--prometheus-server-address", "http://prometheus:9090")
    option("--keda-threshold", "10")
    command.add_argument("--resource-labels", type=key_value_par, action="append", default=None,
                         help="Key,value labels added to all resources; repeatable")
    option("--custom-model-builder-envs", "",
           help="JSON list of k8s EnvVar dicts for builder pods")
    option("--owner-references", None,
           help="JSON/YAML list of k8s ownerReferences for the workflow")
    option("--storage-claim-name", "gordo-storage")
    option("--service-account", "gordo-tpu")
    option("--deadline-seconds", "86400", integer)
    option("--client-start-date", "")
    option("--client-end-date", "")
    option("--split-workflows", "30", integer,
           help="Split the config into multiple Workflow docs of at most this many machines "
                "each (0 disables splitting)")
    option("--exceptions-report-level", "MESSAGE")
    option("--postgres-host", None,
           help="If set, a PostgresReporter pointed here is appended to every machine runtime")
    for on, off, name in (("--enable-clients", "--disable-clients", "ENABLE_CLIENTS"),
                          ("--enable-postgres", "--no-enable-postgres", "ENABLE_POSTGRES"),
                          ("--enable-influx", "--no-enable-influx", "ENABLE_INFLUX"),
                          ("--enable-grafana", "--no-enable-grafana", "ENABLE_GRAFANA"),
                          ("--spot-tolerations", "--no-spot-tolerations", "SPOT_TOLERATIONS"),
                          ("--validate", "--no-validate", "VALIDATE")):
        flag_pair(command, on, off, True, f"{WORKFLOW_PREFIX}_{name}")


def workflow_generate(args: argparse.Namespace, parser: argparse.ArgumentParser) -> int:
    """``workflow generate``: the documents on stdout or in
    ``--output-file``; a refused option or config is ``Error: ...`` and
    exit 1, a required option missing exit 2, as with click."""
    from .workflow.validate import WorkflowValidationError, validate_workflow_docs
    from .workflow.workflow_generator import WorkflowGeneratorError, generate_workflow_docs

    for name in ("machine_config", "project_name"):
        if not getattr(args, name):
            parser.error(f"Missing option '--{name.replace('_', '-')}'.")
    labels = args.resource_labels
    if labels is None:
        labels = [key_value_par(text) for text in
                  os.environ.get(f"{WORKFLOW_PREFIX}_RESOURCE_LABELS", "").split()]
    options = {key: value for key, value in vars(args).items() if key not in (
        "command", "workflow_command", "log_level", "validate", "resource_labels")}
    try:
        content = generate_workflow_docs(resource_labels=tuple(labels), **options)
        if args.validate:
            try:
                validate_workflow_docs(content)
            except WorkflowValidationError as exc:
                raise WorkflowGeneratorError(f"rendered workflow invalid: {exc}")
    except WorkflowGeneratorError as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    if args.output_file:
        with open(args.output_file, "w") as f:
            f.write(content)
    else:
        print(content)
    return 0


def workflow_validate(workflow_file: str) -> int:
    """``workflow validate``: ``workflow documents OK``, or ``Error: ...``
    and exit 1."""
    from .workflow.validate import validate_workflow_docs

    try:
        if workflow_file == "-":
            text = sys.stdin.read()
        else:
            with open(workflow_file) as fh:
                text = fh.read()
        validate_workflow_docs(text)
    except Exception as exc:  # noqa: BLE001 -- click's ClickException(str(exc))
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    print("workflow documents OK")
    return 0


def trace_lines(doc: dict, trace_id: str) -> List[str]:
    """The ``trace`` command's lines for a stitched ``/debug/flight``
    document: the span tree (indented, durations in ms, node-side spans
    tagged ``@<node>``), then a ``stitch`` line per node."""
    lines = [f"trace {trace_id}"]
    events = doc.get("traceEvents") or []
    known = {e.get("args", {}).get("span_id") for e in events}
    children: dict = {}
    roots = []
    for event in events:
        parent = event.get("args", {}).get("parent_span_id") or ""
        if parent and parent in known:
            children.setdefault(parent, []).append(event)
        else:
            roots.append(event)

    def emit(event, depth):
        args = dict(event.get("args") or {})
        span_id = args.get("span_id")
        node = args.pop("gordo_node", None)
        attrs = " ".join(f"{k}={args[k]}" for k in sorted(args)
                         if k not in ("trace_id", "span_id", "parent_span_id", "links"))
        where = f" @{node}" if node else ""
        dur_ms = float(event.get("dur", 0.0)) / 1000.0
        lines.append(f"{'  ' * depth}{event.get('name')}{where} {dur_ms:.2f}ms  {attrs}".rstrip())
        for child in sorted(children.get(span_id, ()), key=lambda c: c.get("ts", 0.0)):
            emit(child, depth + 1)

    for root in sorted(roots, key=lambda e: e.get("ts", 0.0)):
        emit(root, 1)
    stitch = doc.get("gordoStitch") or {}
    for entry in stitch.get("nodes", ()):
        mark = "ok" if entry.get("ok") else f"MISSING ({entry.get('reason')})"
        lines.append(f"stitch {entry.get('node')}: {mark}")
    if stitch and not stitch.get("complete"):
        lines.append("stitch: PARTIAL — some node subtrees are missing")
    return lines


def trace(trace_id: str, host: str, port: int, out: Optional[str]) -> int:
    """Print one request's stitched trace from ``host:port``'s
    ``/debug/flight?trace=`` (``GORDO_TPU_DEBUG_ENDPOINTS`` must be on
    there); 2 when unreachable, 1 on another answer than 200."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=10)
    try:
        conn.request("GET", f"/debug/flight?trace={trace_id}")
        resp = conn.getresponse()
        status, raw = resp.status, resp.read()
    except OSError as exc:
        print(f"error: cannot reach {host}:{port} ({exc})", file=sys.stderr)
        return 2
    finally:
        conn.close()
    if status != 200:
        print(f"error: {host}:{port} answered {status}: {raw[:200].decode(errors='replace')}",
              file=sys.stderr)
        return 1
    doc = json.loads(raw)
    if out:
        with open(out, "w") as fh:
            json.dump(doc, fh, indent=1)
    print("\n".join(trace_lines(doc, trace_id)))
    return 0


def chaos_run(scenario: str, work_dir: Optional[str], out: Optional[str], verbose: bool) -> int:
    """Run one chaos scenario; 0 iff every invariant holds."""
    import shutil
    import tempfile

    from .chaos import load_scenario, run_scenario

    if verbose:
        logging.getLogger().setLevel(logging.INFO)
    spec = load_scenario(scenario)
    directory = work_dir or tempfile.mkdtemp(prefix="gordo-chaos-")
    try:
        report = run_scenario(spec, directory)
    finally:
        if work_dir is None:
            shutil.rmtree(directory, ignore_errors=True)
    if out:
        with open(out, "w") as fh:
            json.dump(report, fh, indent=1)
    for res in report["invariants"]:
        print(f"[{'PASS' if res['ok'] else 'FAIL'}] {res['check']}: {res['detail']}")
    print(f"{report['scenario']}: availability={report['availability']} "
          f"p99={report['p99_ms']}ms failover_s={report['failover_s']} "
          f"-> {'OK' if report['ok'] else 'FAILED'}")
    return 0 if report["ok"] else 1


def chaos_list(scenario_dir: Optional[str]) -> int:
    """List the scenarios of ``scenario_dir`` and their invariants."""
    from .chaos.scenario import SCENARIO_DIR, load_scenario

    scenario_dir = scenario_dir or SCENARIO_DIR
    for name in sorted(os.listdir(scenario_dir)):
        if not name.endswith((".yaml", ".yml", ".json")):
            continue
        try:
            spec = load_scenario(os.path.join(scenario_dir, name))
        except Exception as exc:  # noqa: BLE001 -- a broken file is listed as such
            print(f"{name}: INVALID ({exc})")
            continue
        checks = ",".join(inv.check for inv in spec.invariants)
        print(f"{name}: {spec.name} — nodes={spec.nodes} phases={len(spec.phases)} "
              f"invariants=[{checks}]")
    return 0


def _reporter_options(command: argparse.ArgumentParser) -> None:
    """The exceptions-reporter options of ``build`` and ``batch-build``."""
    command.add_argument("--exceptions-reporter-file",
                         default=os.environ.get("EXCEPTIONS_REPORTER_FILE"),
                         help="JSON output file for exception information")
    command.add_argument("--exceptions-report-level", type=str.upper,
                         choices=ReportLevel.get_names(),
                         default=os.environ.get("EXCEPTIONS_REPORT_LEVEL", "MESSAGE"),
                         help="detail level for exception reporting (default MESSAGE)")


def main(argv: Optional[List[str]] = None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level),
        format="[%(asctime)s] %(levelname)s [%(name)s.%(funcName)s:%(lineno)d] %(message)s",
    )
    from .observability import logs

    # GORDO_TPU_LOG_FORMAT=json: JSON lines stamped with the trace ids
    logs.maybe_configure()
    if args.command == "run-server":
        from .server.server import run_server

        prepare_run_server(args.batch_predicts)
        run_server(args.host, args.port, args.device, None, None, args.workers,
                   args.worker_connections, args.warmup)
        return 0
    if args.command == "run-gateway":
        from .server.gateway import run_gateway

        run_gateway(host=args.host, port=args.port, directory=args.membership_dir)
        return 0
    if args.command == "trace":
        return trace(args.trace_id, args.host, args.port, args.out)
    if args.command == "workflow":
        if args.workflow_command == "validate":
            return workflow_validate(args.workflow_file)
        return workflow_generate(args, parser)
    if args.command == "chaos":
        if args.chaos_command == "run":
            return chaos_run(args.scenario, args.work_dir, args.out, args.verbose)
        return chaos_list(args.scenario_dir)
    try:
        if args.command == "batch-build":
            if args.config_file is None:
                raise ValueError("no config file: give it as an argument or in $CONFIG_FILE")
            return batch_build(args.config_file, args.output_dir_option or args.output_dir,
                               args.project_name,
                               args.machines, args.model_register_dir,
                               not args.no_serial_fallback, args.fail_fast, args.device,
                               args.trace_file, args.metrics_file, args.warm_start,
                               args.drain_drift_queue, args.drift_queue_dir,
                               args.quarantine_report_file)
        if args.command == "drift-rebuilder":
            if args.config_file is None:
                raise ValueError("no config file: give it as an argument or in $CONFIG_FILE")
            if not args.queue_dir:
                raise ValueError("no queue: give --queue-dir or $GORDO_TPU_DRIFT_QUEUE_DIR")
            return drift_rebuilder(args.config_file, args.queue_dir, args.output_dir,
                                   args.model_register_dir, args.project_name, args.once,
                                   args.poll_interval, args.device, args.metrics_file)
        if args.machine_config is None:
            raise ValueError("no machine config: give it as an argument or in $MACHINE")
        build(yaml_subset.load(args.machine_config), args.output_dir, args.model_register_dir,
              args.print_cv_scores, args.device, args.model_parameter)
    except Exception as exc:  # noqa: BLE001 -- the exit code reports the failure
        if args.command in ("build", "batch-build"):
            return report_exception(exc, args.exceptions_reporter_file,
                                    args.exceptions_report_level)
        traceback.print_exc()
        return exit_code(exc)
    return 0
