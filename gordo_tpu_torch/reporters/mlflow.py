"""
``MlFlowReporter``: log a built machine to an MLflow tracking server. The
port's copy of ``gordo_tpu/reporters/mlflow.py``: the CV scores and the fit
history become metrics and the build's durations params, under the same
names and in batches of the same limits (200 metrics, 100 params a
``log_batch``), so both packages log the same batches for the same
metadata; the machine's JSON is attached as an artifact, one run a build.
The extraction and batching are pure; ``mlflow`` is imported only when the
reporter reports, and its absence raises :class:`MlFlowReporterException`.
"""

import json
import logging
import os
import tempfile
import time
from typing import Any, Dict, List, Tuple

from ..util.utils import capture_args
from .base import BaseReporter, ReporterException

logger = logging.getLogger(__name__)

# AzureML's service limits (reference mlflow.py:278-290)
MAX_METRICS_PER_BATCH = 200
MAX_PARAMS_PER_BATCH = 100


class MlFlowReporterException(ReporterException):
    pass


def extract_metrics_and_params(
        machine_dict: dict) -> Tuple[List[Tuple[str, float]], List[Tuple[str, str]]]:
    """The build metadata as (metrics, params): each CV score statistic and
    each epoch's fit history as metrics, the CV and training durations and
    the model's creation date as params."""
    metrics: List[Tuple[str, float]] = []
    params: List[Tuple[str, str]] = []
    build_meta = machine_dict.get("metadata", {}).get("build_metadata", {}) or {}
    model_meta = build_meta.get("model", {}) or {}

    cv = model_meta.get("cross_validation", {}) or {}
    for metric_name, stats in (cv.get("scores", {}) or {}).items():
        if isinstance(stats, dict):
            for stat_name, value in stats.items():
                if isinstance(value, (int, float)):
                    metrics.append((f"{metric_name}-{stat_name}", float(value)))
    if isinstance(cv.get("cv_duration_sec"), (int, float)):
        params.append(("cv_duration_sec", str(cv["cv_duration_sec"])))

    # the fit history is the estimator's metadata, under model_meta
    history = (model_meta.get("model_meta", {}) or {}).get("history", {}) or {}
    for key, values in history.items():
        if isinstance(values, list):
            for epoch, value in enumerate(values):
                if isinstance(value, (int, float)):
                    metrics.append((f"history-{key}-epoch-{epoch}", float(value)))

    for key in ("model_training_duration_sec", "model_creation_date"):
        value = model_meta.get(key)
        if value is not None:
            params.append((key, str(value)))
    return metrics, params


def batch(items: List[Any], size: int) -> List[List[Any]]:
    """``items`` in batches of at most ``size``."""
    if size < 1:
        raise ValueError("batch size must be >= 1")
    return [items[i:i + size] for i in range(0, len(items), size)]


def get_batch_kwargs(machine_dict: dict) -> List[Dict[str, list]]:
    """The keyword arguments of each ``MlflowClient.log_batch`` call, each
    within the metric and param limits."""
    metrics, params = extract_metrics_and_params(machine_dict)
    ts = int(time.time() * 1000)
    metric_batches = batch(metrics, MAX_METRICS_PER_BATCH)
    param_batches = batch(params, MAX_PARAMS_PER_BATCH)
    calls: List[Dict[str, list]] = []
    for i in range(max(len(metric_batches), len(param_batches))):
        calls.append({
            "metrics": [{"key": k, "value": v, "timestamp": ts, "step": 0}
                        for k, v in (metric_batches[i] if i < len(metric_batches) else [])],
            "params": [{"key": k, "value": str(v)[:250]}
                       for k, v in (param_batches[i] if i < len(param_batches) else [])],
        })
    return calls


class MlFlowReporter(BaseReporter):
    @capture_args
    def __init__(self, tracking_uri: str = "", experiment_name: str = "gordo-tpu", **kwargs):
        self.tracking_uri = tracking_uri
        self.experiment_name = experiment_name

    def report(self, machine) -> None:
        try:
            from mlflow.entities import Metric, Param
            from mlflow.tracking import MlflowClient
        except ImportError as exc:
            raise MlFlowReporterException("mlflow is not installed in this environment") from exc

        machine_dict = machine.to_dict()
        client = MlflowClient(tracking_uri=self.tracking_uri or None)
        experiment = client.get_experiment_by_name(self.experiment_name)
        experiment_id = (experiment.experiment_id if experiment
                         else client.create_experiment(self.experiment_name))
        run_id = client.create_run(experiment_id, run_name=machine.name).info.run_id
        try:
            for call in get_batch_kwargs(machine_dict):
                client.log_batch(run_id, metrics=[Metric(**m) for m in call["metrics"]],
                                 params=[Param(**p) for p in call["params"]])
            with tempfile.TemporaryDirectory() as tmpdir:
                artifact = os.path.join(tmpdir, f"{machine.name}.json")
                with open(artifact, "w") as fh:
                    json.dump(machine_dict, fh, default=str)
                client.log_artifact(run_id, artifact)
            client.set_terminated(run_id)
            logger.info("Reported machine %s to mlflow", machine.name)
        except Exception as exc:
            client.set_terminated(run_id, status="FAILED")
            raise MlFlowReporterException(
                f"Failed reporting machine {machine.name}: {exc}") from exc
