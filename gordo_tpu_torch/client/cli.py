"""
``python -m gordo_tpu_torch.client``: the port's counterpart of the
``gordo-tpu-client`` command (``gordo_tpu/client/cli.py``), with the same
options and the same ``GORDO_*`` environment defaults.

- ``predict START END [--target NAME ...] [--output-dir DIR]
  [--influx-uri HOST:PORT/DB] [--influx-api-key KEY]`` predicts the range
  for the targets (all machines by default), forwarding each batch into
  InfluxDB (``GORDO_INFLUX_URI``) or as parquet files under ``DIR``, and
  prints ``<name>: <rows> rows, <n> errors`` a machine; it exits 1 when a
  batch failed.
- ``metadata [--target NAME ...] [--output-file FILE]`` prints (or writes)
  the machines' metadata as JSON.
- ``download-model OUTPUT_DIR [--target NAME ...]`` writes each model's
  artifact, as served, into ``OUTPUT_DIR/<machine>``.

``--project`` (``GORDO_PROJECT``) is required; ``--host``
(``GORDO_HOST``), ``--port`` (``GORDO_PORT``, 443), ``--scheme``
(``GORDO_SCHEME``, https), ``--revision``, ``--batch-size`` and
``--parallelism`` as in JAX. Argument errors exit 2 in click's words.
"""

import argparse
import json
import logging
import os
import sys
from typing import List, Optional

from ..custom_types import integer
from .client import Client
from .forwarders import ForwardPredictionsIntoInflux, ForwardPredictionsToDisk

logger = logging.getLogger(__name__)


def _parser() -> argparse.ArgumentParser:
    env = os.environ.get
    parser = argparse.ArgumentParser(prog="python -m gordo_tpu_torch.client",
                                     description="Client for gordo model servers.")
    parser.add_argument("--project", default=env("GORDO_PROJECT"))
    parser.add_argument("--host", default=env("GORDO_HOST", "localhost"))
    parser.add_argument("--port", type=integer, default=env("GORDO_PORT", "443"))
    parser.add_argument("--scheme", default=env("GORDO_SCHEME", "https"))
    parser.add_argument("--revision", default=env("GORDO_REVISION"))
    parser.add_argument("--batch-size", type=integer, default=env("GORDO_BATCH_SIZE", "100000"))
    parser.add_argument("--parallelism", type=integer, default=env("GORDO_PARALLELISM", "10"))
    commands = parser.add_subparsers(dest="command", required=True)
    predict = commands.add_parser(
        "predict", help="Predict the time range [START, END] for the target machines.")
    predict.add_argument("start")
    predict.add_argument("end")
    predict.add_argument("--target", action="append", default=[],
                         help="Machine name; repeatable (default: all)")
    predict.add_argument("--output-dir", default=None,
                         help="Forward prediction batches as parquet files under this directory")
    predict.add_argument("--influx-uri", default=env("GORDO_INFLUX_URI"),
                         help="Forward prediction batches into InfluxDB at <host>:<port>/<db> "
                              "(the workflow's per-project influx side-deployment)")
    predict.add_argument("--influx-api-key", default=env("GORDO_INFLUX_API_KEY", ""))
    metadata = commands.add_parser(
        "metadata", help="Fetch metadata for the target machines as JSON.")
    metadata.add_argument("--target", action="append", default=[])
    metadata.add_argument("--output-file", default=None)
    download = commands.add_parser(
        "download-model", help="Download and save models into OUTPUT_DIR/<machine>/.")
    download.add_argument("output_dir")
    download.add_argument("--target", action="append", default=[])
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if not args.project:
        parser.error("Missing option '--project'.")
    logging.basicConfig(level=logging.INFO)
    options = dict(project=args.project, host=args.host, port=args.port, scheme=args.scheme,
                   revision=args.revision, batch_size=args.batch_size,
                   parallelism=args.parallelism)
    targets = list(args.target) or None
    if args.command == "predict":
        forwarder = None
        if args.influx_uri:
            forwarder = ForwardPredictionsIntoInflux(
                destination_influx_uri=args.influx_uri,
                destination_influx_api_key=args.influx_api_key,
            )
        elif args.output_dir:
            forwarder = ForwardPredictionsToDisk(args.output_dir)
        client = Client(**options, prediction_forwarder=forwarder)
        results = client.predict(args.start, args.end, targets=targets)
        failed = False
        for result in results:
            n = len(result.predictions) if result.predictions is not None else 0
            print(f"{result.name}: {n} rows, {len(result.error_messages)} errors", flush=True)
            for msg in result.error_messages:
                failed = True
                print(f"  error: {msg}", file=sys.stderr)
        return 1 if failed else 0
    client = Client(**options)
    if args.command == "metadata":
        content = json.dumps(client.get_metadata(targets=targets), indent=2, default=str)
        if args.output_file:
            with open(args.output_file, "w") as f:
                f.write(content)
        else:
            print(content)
        return 0
    for name, model_dir in client.download_artifacts(args.output_dir, targets=targets).items():
        print(f"saved: {name} -> {model_dir}")
    return 0
