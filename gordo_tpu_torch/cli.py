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
fault with the code of its exception.

``run-server`` serves the artifacts of ``MODEL_COLLECTION_DIR`` on
``--host`` and ``--port`` (``GORDO_SERVER_HOST``, ``GORDO_SERVER_PORT``)
from ``--device``, one process with a thread per connection: the JAX
command's workers, warm-up and batcher are not ported.
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
                serial_fallback: bool = True, fail_fast: bool = False, device=None) -> int:
    """Build the config's machines (or the comma-separated ``machines`` of
    it) as a fleet; returns the exit code."""
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
    server_cmd = commands.add_parser("run-server", help="Serve MODEL_COLLECTION_DIR's models")
    server_cmd.add_argument("--host", default=os.environ.get("GORDO_SERVER_HOST", "0.0.0.0"))
    server_cmd.add_argument("--port", type=int,
                            default=int(os.environ.get("GORDO_SERVER_PORT", "5555")))
    server_cmd.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level),
        format="[%(asctime)s] %(levelname)s [%(name)s.%(funcName)s:%(lineno)d] %(message)s",
    )
    if args.command == "run-server":
        from .server.server import run_server

        run_server(args.host, args.port, args.device)
        return 0
    try:
        if args.command == "batch-build":
            if args.config_file is None:
                raise ValueError("no config file: give it as an argument or in $CONFIG_FILE")
            return batch_build(args.config_file, args.output_dir, args.project_name,
                               args.machines, args.model_register_dir,
                               not args.no_serial_fallback, args.fail_fast, args.device)
        if args.machine_config is None:
            raise ValueError("no machine config: give it as an argument or in $MACHINE")
        build(json.loads(args.machine_config), args.output_dir, args.model_register_dir,
              args.print_cv_scores, args.device)
    except Exception as exc:  # noqa: BLE001 -- the exit code reports the failure
        traceback.print_exc()
        return exit_code(exc)
    return 0
