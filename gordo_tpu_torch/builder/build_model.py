"""
One machine in, one trained artifact out: the port's counterpart of
``ModelBuilder`` in ``gordo_tpu/builder/build_model.py``.

``build`` seeds numpy and ``random``, fetches the dataset, refuses
non-finite data, builds the model from its definition on the builder's
device, cross-validates it with a scorer per metric and tag (the model's
own ``cross_validate`` computes the anomaly thresholds), fits it on all the
data, and records the offset, the scores, the splits and the model's
metadata in the machine's ``BuildMetadata``. With a register directory it
first looks the machine's content hash up there and loads the artifact it
names instead of training. Each phase runs in the JAX builder's telemetry
span (``fetch``, ``validate``, ``cross_validation``, ``fit``,
``serialize``), timed into ``gordo_build_phase_seconds{phase}``, and every
machine leaving ``build`` counts in ``gordo_build_machines_total`` (built
or cached); the spans are no-ops unless a trace, span timing or
``GORDO_TPU_PROFILE_DIR`` is on (observability/telemetry.py). The retry
ladder and the shipped AOT programs of the JAX builder are not ported
(ROADMAP.md item A10).
"""

import datetime
import hashlib
import json
import logging
import os
import random
import time
from functools import partial
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from .. import IS_UNSTABLE_VERSION, MAJOR_VERSION, MINOR_VERSION, __version__, resolve_device
from .. import serializer
from ..dataset import GordoBaseDataset
from ..machine import Machine
from ..machine.metadata import (
    BuildMetadata, CrossValidationMetaData, DatasetBuildMetadata, ModelBuildMetadata,
)
from ..models.anomaly.diff import cross_validate
from ..models.base import extract_metadata
from ..models.utils import Frame, index_label, metric_wrapper
from ..observability import metrics as metric_catalog, telemetry
from ..serializer.resolver import locate
from ..util import disk_registry

logger = logging.getLogger(__name__)

DEFAULT_METRICS = [
    "sklearn.metrics.explained_variance_score",
    "sklearn.metrics.r2_score",
    "sklearn.metrics.mean_squared_error",
    "sklearn.metrics.mean_absolute_error",
]

_DEFAULT_CV = {"sklearn.model_selection.TimeSeriesSplit": {"n_splits": 3}}

_PHASE_FETCH = metric_catalog.BUILD_PHASE_SECONDS.labels(phase="fetch")
_PHASE_VALIDATE = metric_catalog.BUILD_PHASE_SECONDS.labels(phase="validate")
_PHASE_CV = metric_catalog.BUILD_PHASE_SECONDS.labels(phase="cross_validation")
_PHASE_FIT = metric_catalog.BUILD_PHASE_SECONDS.labels(phase="fit")
_PHASE_SERIALIZE = metric_catalog.BUILD_PHASE_SECONDS.labels(phase="serialize")


class NonFiniteDataError(ValueError):
    """The training data of a machine holds NaN or infinite values."""


def non_finite_report(X, y=None) -> Optional[str]:
    """None when every value is finite, else what is not."""
    for name, arr in (("X", X), ("y", y)):
        if arr is None:
            continue
        arr = np.asarray(arr)
        if np.issubdtype(arr.dtype, np.floating):
            n_bad = int(arr.size - np.count_nonzero(np.isfinite(arr)))
            if n_bad:
                return f"{n_bad} non-finite values in {name} (shape {arr.shape})"
    return None


def _fold_summary(fold_values: np.ndarray) -> Dict[str, Any]:
    """Per-metric CV record: aggregate stats plus each fold's raw score."""
    record: Dict[str, Any] = {
        "fold-mean": fold_values.mean(),
        "fold-std": fold_values.std(),
        "fold-max": fold_values.max(),
        "fold-min": fold_values.min(),
    }
    record.update((f"fold-{fold + 1}", score) for fold, score in enumerate(fold_values.tolist()))
    return record


class ModelBuilder:
    """Builds ``machine`` on ``device`` (``cuda`` unless ``"cpu"``)."""

    def __init__(self, machine: Machine, device=None):
        self.machine = machine
        self.device = device

    def build(self, output_dir: Optional[Union[os.PathLike, str]] = None,
              model_register_dir: Optional[Union[os.PathLike, str]] = None,
              replace_cache: bool = False) -> Tuple[Any, Machine]:
        """Build the model, or load it from the register's cache; write the
        artifact into ``output_dir`` and register it there."""
        resolve_device(self.device)  # no CUDA and no device named: raise before any work
        if not model_register_dir:
            model, machine = self._build()
        else:
            if replace_cache:
                disk_registry.delete_value(model_register_dir, self.cache_key)
            cached_model_path = self.check_cache(model_register_dir)
            if cached_model_path:
                model, machine = self.load_from_cache(cached_model_path, self.device)
                metric_catalog.BUILD_MACHINES.labels(outcome="cached").inc()
                if output_dir and os.path.realpath(str(output_dir)) == os.path.realpath(
                    str(cached_model_path)
                ):
                    # the artifact is already there: saving again would rewrite a
                    # good cache entry in place, with the from_cache mark in it
                    return model, machine
            else:
                model, machine = self._build()

        if output_dir:
            self._save_model(model, machine, output_dir)
            if model_register_dir:
                disk_registry.write_key(model_register_dir, self.cache_key, str(output_dir))
        return model, machine

    def _build(self) -> Tuple[Any, Machine]:
        """fetch, validate, (cross-validate), fit, describe, as the
        evaluation config says."""
        self.set_seed(seed=self.machine.evaluation.get("seed", 0))
        phases: Dict[str, float] = {}
        dataset, X, y, query_sec = self._fetch_data()
        phases["fetch"] = query_sec
        validate_started = time.time()
        with telemetry.span("validate", _PHASE_VALIDATE, machine=self.machine.name):
            bad = non_finite_report(X.values, y.values)
        phases["validate"] = time.time() - validate_started
        if bad is not None:
            raise NonFiniteDataError(f"machine {self.machine.name}: {bad}")
        model = serializer.from_definition(self.machine.model, self.device)
        machine_out = self._fresh_machine()
        dataset_meta = DatasetBuildMetadata(
            query_duration_sec=query_sec, dataset_meta=dataset.get_metadata()
        )

        cv_mode = self.machine.evaluation.get("cv_mode", "full_build").lower()
        scores: Dict[str, Any] = {}
        splits: Dict[str, Any] = {}
        cv_sec = None
        if cv_mode in ("cross_val_only", "full_build"):
            scores, splits, cv_sec = self._cross_validate(model, X, y)
            if cv_sec is not None:
                phases["cross_validation"] = cv_sec
            if cv_mode == "cross_val_only":
                machine_out.metadata.build_metadata = BuildMetadata(
                    model=ModelBuildMetadata(cross_validation=CrossValidationMetaData(
                        cv_duration_sec=cv_sec, scores=scores, splits=splits)),
                    dataset=dataset_meta,
                    phases=phases,
                )
                return model, machine_out

        fit_started = time.time()
        with telemetry.span("fit", _PHASE_FIT, machine=self.machine.name):
            model.fit(X.values, y.values)
        fit_sec = time.time() - fit_started
        phases["fit"] = fit_sec

        machine_out.metadata.build_metadata = BuildMetadata(
            model=ModelBuildMetadata(
                model_offset=self._determine_offset(model, X),
                model_creation_date=str(
                    datetime.datetime.now(datetime.timezone.utc).astimezone()
                ),
                model_builder_version=__version__,
                model_training_duration_sec=fit_sec,
                cross_validation=CrossValidationMetaData(
                    cv_duration_sec=cv_sec, scores=scores, splits=splits
                ),
                model_meta=extract_metadata(model),
            ),
            dataset=dataset_meta,
            phases=phases,
        )
        metric_catalog.BUILD_MACHINES.labels(outcome="built").inc()
        return model, machine_out

    def _fetch_data(self) -> Tuple[GordoBaseDataset, Frame, Frame, float]:
        started = time.time()
        with telemetry.span("fetch", _PHASE_FETCH, machine=self.machine.name):
            dataset = GordoBaseDataset.from_dict(self.machine.dataset.to_dict())
            X, y = dataset.get_data()
        return dataset, X, y, time.time() - started

    def _fresh_machine(self) -> Machine:
        """The output Machine: the same identity and config, metadata to fill."""
        source = self.machine
        return Machine(
            name=source.name,
            dataset=source.dataset.to_dict(),
            metadata=source.metadata,
            model=source.model,
            project_name=source.project_name,
            evaluation=source.evaluation,
            runtime=source.runtime,
        )

    def _cross_validate(self, model, X: Frame, y: Frame):
        """Fold scores and split boundaries, through the model's own
        ``cross_validate`` where it has one."""
        if not hasattr(model, "predict"):
            return {}, {}, None
        cv_started = time.time()
        evaluation = self.machine.evaluation
        scorers = self.build_metrics_dict(
            self.metrics_from_list(evaluation.get("metrics")), y,
            scaler=evaluation.get("scoring_scaler"),
        )
        splitter = serializer.from_definition(evaluation.get("cv", _DEFAULT_CV))
        splits = self.build_split_dict(X, splitter)
        runner = getattr(model, "cross_validate", None) or partial(cross_validate, model)
        with telemetry.span("cross_validation", _PHASE_CV, machine=self.machine.name):
            cv_result = runner(X=X.values, y=y.values, scoring=scorers, cv=splitter)
        scores = {name: _fold_summary(cv_result[f"test_{name}"]) for name in scorers}
        return scores, splits, time.time() - cv_started

    def set_seed(self, seed: int):
        logger.info("Setting random seed: %r", seed)
        np.random.seed(seed)
        random.seed(seed)

    @staticmethod
    def build_split_dict(X: Frame, split_obj) -> dict:
        """Each fold's first and last train and test timestamps, and row counts."""
        entries: Dict[str, Any] = {}
        for fold, (train_rows, test_rows) in enumerate(split_obj.split(X.values), start=1):
            for part, rows in (("train", train_rows), ("test", test_rows)):
                entries[f"fold-{fold}-{part}-start"] = index_label(X, rows[0])
                entries[f"fold-{fold}-{part}-end"] = index_label(X, rows[-1])
                entries[f"fold-{fold}-n-{part}"] = len(rows)
        return entries

    @staticmethod
    def build_metrics_dict(metrics_list: list, y: Frame, scaler=None) -> dict:
        """Per-tag scorers (``'{metric}-{tag}'``) and the aggregate
        ``'{metric}'`` scorer, each a metric of (y_true, y_pred) that takes
        a windowed model's shorter output and scales both first when a
        ``scaler`` (or its definition) is given."""
        if scaler:
            if isinstance(scaler, (str, dict)):
                scaler = serializer.from_definition(scaler)
            scaler.fit(y.values)

        def _column_view(metric_func, column):
            def scored(y_true, y_pred):
                return metric_func(np.asarray(y_true)[:, column], np.asarray(y_pred)[:, column])

            return scored

        scorers: Dict[str, Callable] = {}
        for metric_func in metrics_list:
            slug = metric_func.__name__.replace("_", "-")
            for column, tag in enumerate(y.columns):
                scorers[f"{slug}-{tag.replace(' ', '-')}"] = metric_wrapper(
                    _column_view(metric_func, column), scaler=scaler
                )
            scorers[slug] = metric_wrapper(metric_func, scaler=scaler)
        return scorers

    @staticmethod
    def _determine_offset(model, X: Frame) -> int:
        """len(X) - len(model output): the rows a windowed model's output lacks."""
        return len(X.values) - len(model.predict(X.values))

    @staticmethod
    def _save_model(model, machine: Machine, output_dir: Union[os.PathLike, str]):
        with telemetry.span("serialize", _PHASE_SERIALIZE, machine=machine.name):
            serializer.dump(
                model, str(output_dir),
                tags=[t.name for t in machine.dataset.tag_list],
                target_tags=[t.name for t in machine.dataset.target_tag_list],
                metadata=machine.to_dict(),
            )

    @property
    def cache_key(self) -> str:
        return self.calculate_cache_key(self.machine)

    @staticmethod
    def calculate_cache_key(machine: Machine) -> str:
        """sha3-512 over the name, the model, dataset and evaluation configs
        and the version, in the JAX builder's JSON layout."""
        json_rep = json.dumps(
            {
                "name": machine.name,
                "model_config": machine.model,
                "data_config": machine.dataset.to_dict(),
                "evaluation_config": machine.evaluation,
                "gordo-major-version": MAJOR_VERSION,
                "gordo-minor-version": MINOR_VERSION,
                "gordo_version": __version__ if IS_UNSTABLE_VERSION else "",
            },
            sort_keys=True,
            default=str,
        )
        return hashlib.sha3_512(json_rep.encode("ascii")).hexdigest()

    def check_cache(self, model_register_dir: Union[os.PathLike, str]) -> Optional[str]:
        """The cached artifact's path, if the register has one that exists."""
        location = disk_registry.get_value(model_register_dir, self.cache_key)
        if location and Path(location).exists():
            return location
        if location:
            logger.warning("Model path %s from registry does not exist", location)
        return None

    @staticmethod
    def load_from_cache(cached_model_path: Union[os.PathLike, str], device=None):
        """``(model, machine)`` of a cached artifact, the machine's user
        metadata marked ``from_cache``."""
        model = serializer.load(str(cached_model_path), device)
        metadata = serializer.load_metadata(str(cached_model_path))
        metadata["metadata"]["user_defined"]["build-metadata"] = dict(from_cache=True)
        return model, Machine(**metadata)

    @staticmethod
    def metrics_from_list(metric_list: Optional[List[str]] = None) -> List[Callable]:
        """The metric functions of their paths or names (default: the four)."""
        funcs = []
        for func_path in metric_list or DEFAULT_METRICS:
            func = locate(func_path if "." in func_path else f"sklearn.metrics.{func_path}")
            if func is None:
                raise ImportError(f'Could not locate metric: "{func_path}"')
            funcs.append(func)
        return funcs
