"""
The port's command line: ``python -m gordo_tpu_torch build``, the
counterpart of ``gordo build`` (``gordo_tpu/cli/cli.py``).

``build MACHINE OUTPUT_DIR`` builds one machine from its config, a JSON
object given as the argument or in the ``MACHINE`` environment variable
(the output directory likewise, or ``OUTPUT_DIR``), on the card unless
``--device cpu`` is given. The model definition is round-tripped first so
that every default is recorded. A failure exits with the code of its
exception's class, as the JAX CLI's table has them. Jinja model templates
and the exceptions-reporter file are not ported.
"""

import argparse
import json
import logging
import os
import traceback
from typing import List, Optional

from . import serializer
from .builder import ModelBuilder
from .builder.build_model import NonFiniteDataError
from .dataset.datasets import InsufficientDataError
from .dataset.sensor_tag import SensorTagNormalizationError
from .machine import Machine

logger = logging.getLogger(__name__)

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
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level),
        format="[%(asctime)s] %(levelname)s [%(name)s.%(funcName)s:%(lineno)d] %(message)s",
    )
    try:
        if args.machine_config is None:
            raise ValueError("no machine config: give it as an argument or in $MACHINE")
        build(json.loads(args.machine_config), args.output_dir, args.model_register_dir,
              args.print_cv_scores, args.device)
    except Exception as exc:  # noqa: BLE001 -- the exit code reports the failure
        traceback.print_exc()
        return exit_code(exc)
    return 0
