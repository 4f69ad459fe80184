"""
The port's command line, ``python -m gordo_tpu_torch``: the counterparts
of ``gordo build`` and ``gordo run-server`` (``gordo_tpu/cli/cli.py``).

``build MACHINE OUTPUT_DIR`` builds one machine from its config, a JSON
object given as the argument or in the ``MACHINE`` environment variable
(the output directory likewise, or ``OUTPUT_DIR``), on the card unless
``--device cpu`` is given. The model definition is round-tripped first so
that every default is recorded. A failure exits with the code of its
exception's class, as the JAX CLI's table has them. Jinja model templates
and the exceptions-reporter file are not ported.

``batch-build CONFIG_FILE OUTPUT_DIR`` builds every machine of a project
config (JSON, which is also YAML, so the JAX CLI reads the same file) with
the fleet trainer (parallel/batch_trainer.py) into ``OUTPUT_DIR/<name>``.
It exits 0 when every machine was built, 81 when some were quarantined and
82 when none was (the JAX CLI's codes); ``--fail-fast`` stops at the first
fault with the code of its exception. ``--trace-file`` (or
``GORDO_TPU_TRACE_FILE``) records the build's telemetry spans and writes
them as Chrome trace-event JSON; ``--metrics-file`` (or
``GORDO_TPU_METRICS_FILE``) writes the metric catalog as a Prometheus
textfile; both are written on every exit path, a partial build's included.

``run-server`` serves the artifacts of ``MODEL_COLLECTION_DIR`` on
``--host`` and ``--port`` (``GORDO_SERVER_HOST``, ``GORDO_SERVER_PORT``)
from ``--device``, one process with a thread per connection. As the JAX
command does, it batches predicts by default: ``--batch-predicts`` (or
``GORDO_SERVER_BATCH_PREDICTS``) exports ``GORDO_TPU_SERVING_BATCH=auto``
before the server starts, ``--no-batch-predicts`` exports ``0``
(server/batcher.py). With ``GORDO_TPU_FAST_LANE=1`` it serves through the
socket fast lane (server/fastlane.py: an event loop, or a thread per
connection with ``GORDO_TPU_FAST_LANE_EVENT_LOOP=0``), as the JAX command
does. The server reads ``ENABLE_PROMETHEUS`` and ``PROJECT`` (its
``/metrics``), and every command ``GORDO_TPU_LOG_FORMAT=json`` (one JSON
object a log line, stamped with the request's trace and span ids:
observability/logs.py), as the JAX CLI reads them. The JAX command's
workers and warm-up are not ported (ROADMAP.md item A9).
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
from .dataset.datasets import InsufficientDataError
from .dataset.sensor_tag import SensorTagNormalizationError
from .machine import Machine

logger = logging.getLogger(__name__)

EXIT_PARTIAL = 81
EXIT_NONE_BUILT = 82
EXIT_CODES = (
    (Exception, 1),
    (PermissionError, 20),
    (FileNotFoundError, 30),
    (SensorTagNormalizationError, 60),
    (InsufficientDataError, 80),
    (NonFiniteDataError, 83),
)


def exit_code(exc: BaseException) -> int:
    """The code of the closest class of ``exc`` in :data:`EXIT_CODES`."""
    codes = dict(EXIT_CODES)
    return next((codes[cls] for cls in type(exc).__mro__ if cls in codes), 1)


def get_all_score_strings(machine: Machine) -> List[str]:
    """Katib-format ``'{metric}_{fold}={value}'`` lines of the CV scores."""
    all_scores = []
    scores = machine.metadata.build_metadata.model.cross_validation.scores
    for metric_name, metric_scores in scores.items():
        metric_name = metric_name.replace(" ", "-")
        for score_name, score_val in metric_scores.items():
            all_scores.append(f"{metric_name}_{score_name.replace(' ', '-')}={score_val}")
    return all_scores


def build(machine_config: dict, output_dir: str, model_register_dir: Optional[str] = None,
          print_cv_scores: bool = False, device=None) -> None:
    """Build one machine and write its artifact into ``output_dir``."""
    if isinstance(machine_config.get("model"), str):
        raise ValueError(
            "the model is a string (a Jinja template): templates are not ported; "
            "give the model definition as a JSON object"
        )
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
                trace_file: Optional[str] = None, metrics_file: Optional[str] = None) -> int:
    """Build the config's machines (or the comma-separated ``machines`` of
    it) as a fleet; returns the exit code. ``trace_file`` and
    ``metrics_file`` receive the build's telemetry, written whatever the
    build's outcome."""
    from .observability import telemetry

    if trace_file:
        telemetry.start_trace()
    elif metrics_file:
        # metrics only: the phase histograms fill, no event buffer grows
        telemetry.enable_spans()
    try:
        return _batch_build(config_file, output_dir, project_name, machines,
                            model_register_dir, serial_fallback, fail_fast, device)
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


def _batch_build(config_file: str, output_dir: str, project_name: str, machines: str,
                 model_register_dir: Optional[str], serial_fallback: bool, fail_fast: bool,
                 device) -> int:
    from .parallel.batch_trainer import BatchedModelBuilder
    from .workflow.normalized_config import NormalizedConfig

    with open(config_file) as f:
        config = json.load(f)
    selected = NormalizedConfig(config, project_name=project_name).machines
    wanted = {name.strip() for name in machines.split(",") if name.strip()}
    if wanted:
        missing = wanted - {m.name for m in selected}
        if missing:
            raise ValueError(f"--machines names not in config: {sorted(missing)}")
        selected = [m for m in selected if m.name in wanted]
    builder = BatchedModelBuilder(
        selected, serial_fallback=serial_fallback, output_dir=output_dir,
        model_register_dir=model_register_dir, fail_fast=fail_fast, device=device,
    )
    results = builder.build()
    for _, machine_out in results:
        machine_out.report()
        print(f"built: {machine_out.name} -> {os.path.join(output_dir, machine_out.name)}")
    for record in builder.quarantine_records:
        print(f"quarantined: {record.machine} stage={record.stage} reason={record.reason} "
              f"error={record.error}", file=sys.stderr)
    if builder.quarantine_records:
        return EXIT_PARTIAL if results else EXIT_NONE_BUILT
    return 0


def _env_flag(name: str, default: bool) -> bool:
    """A boolean environment variable as click reads one."""
    value = os.environ.get(name, "").strip().lower()
    if not value:
        return default
    if value in ("1", "true", "t", "yes", "y", "on"):
        return True
    if value in ("0", "false", "f", "no", "n", "off"):
        return False
    raise ValueError(f"{name}={value!r} is not a boolean")


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
                           help="the machine's config as JSON (default: $MACHINE)")
    build_cmd.add_argument("output_dir", nargs="?", default=os.environ.get("OUTPUT_DIR", "/data"),
                           help="where the artifact goes (default: $OUTPUT_DIR or /data)")
    build_cmd.add_argument("--model-register-dir",
                           default=os.environ.get("MODEL_REGISTER_DIR"))
    build_cmd.add_argument("--print-cv-scores", action="store_true",
                           help="print the CV scores to stdout")
    build_cmd.add_argument("--device", default=None, help="cuda (default) or cpu")
    fleet_cmd = commands.add_parser("batch-build", help=batch_build.__doc__)
    fleet_cmd.add_argument("config_file", nargs="?", default=os.environ.get("CONFIG_FILE"),
                           help="the project config, JSON (default: $CONFIG_FILE)")
    fleet_cmd.add_argument("output_dir", nargs="?", default=os.environ.get("OUTPUT_DIR", "/data"),
                           help="where the artifacts go (default: $OUTPUT_DIR or /data)")
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
    server_cmd = commands.add_parser("run-server", help="Serve MODEL_COLLECTION_DIR's models")
    server_cmd.add_argument("--host", default=os.environ.get("GORDO_SERVER_HOST", "0.0.0.0"))
    server_cmd.add_argument("--port", type=int,
                            default=int(os.environ.get("GORDO_SERVER_PORT", "5555")))
    server_cmd.add_argument("--device", default=None, help="cuda (default) or cpu")
    server_cmd.add_argument(
        "--batch-predicts", action=argparse.BooleanOptionalAction,
        default=_env_flag("GORDO_SERVER_BATCH_PREDICTS", True),
        help="fuse concurrent predicts of one architecture into one device call, where a "
             "measured A/B at first use finds that it wins (default: on)")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
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
        run_server(args.host, args.port, args.device)
        return 0
    try:
        if args.command == "batch-build":
            if args.config_file is None:
                raise ValueError("no config file: give it as an argument or in $CONFIG_FILE")
            return batch_build(args.config_file, args.output_dir, args.project_name,
                               args.machines, args.model_register_dir,
                               not args.no_serial_fallback, args.fail_fast, args.device,
                               args.trace_file, args.metrics_file)
        if args.machine_config is None:
            raise ValueError("no machine config: give it as an argument or in $MACHINE")
        build(json.loads(args.machine_config), args.output_dir, args.model_register_dir,
              args.print_cv_scores, args.device)
    except Exception as exc:  # noqa: BLE001 -- the exit code reports the failure
        traceback.print_exc()
        return exit_code(exc)
    return 0
