"""
The fleet trainer: the port's counterpart of the single-process path of
``BatchedModelBuilder`` in ``gordo_tpu/parallel/batch_trainer.py``.

Machines whose model config the planner can express (``_plan_machine``)
and whose data have one shape are bucketed; each bucket trains as one
stacked program on the card (``run_bucket``): per stage, the CV folds and
then the full fit, the inputs are min-max scaled over the stage's train
rows, every machine's parameters are initialised, the epochs run through
one ``StackedTransformerModel`` (so each Transformer block launches the
flash kernels once for the whole bucket, at BH = machines x batch x heads),
and the folds' models predict their test slices in chunks of windows. On
the host each machine then gets the serial detector's thresholds, the CV
scores and split metadata in its ``BuildMetadata``, and is written and
registered as soon as its chunk of machines is done, so a resumed build
loads it from the register's cache.

A machine whose fetch, validation or training raises is quarantined with
its reason, and the rest build on (``fail_fast`` raises instead). Machines
the planner cannot express (another detector, scaler or splitter, a
callback, ring attention) go to the port's serial ``ModelBuilder``.

Each machine's initial parameters per stage and its sample order per epoch
come from ``torch.Generator``s seeded by ``_machine_seed``, the stage and
the epoch (``draw_inputs``): the JAX package's PRNG streams cannot be
reproduced, so ``run_bucket`` takes them as arguments and the tests hand it
the JAX program's own draws. Not ported yet (ROADMAP.md queue A): the
elastic scheduler and multi-host fleets, warm starts, KFold and the KFCV
detector, the retry ladder and fault injection, the drift queue, and the
telemetry spans and metrics.
"""

import dataclasses
import datetime
import logging
import os
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import __version__, resolve_device, serializer
from ..builder.build_model import ModelBuilder, NonFiniteDataError, non_finite_report
from ..dataset import GordoBaseDataset
from ..machine import Machine
from ..machine.metadata import (
    BuildMetadata, CrossValidationMetaData, DatasetBuildMetadata, ModelBuildMetadata,
)
from ..models.anomaly.diff import DiffBasedAnomalyDetector, TimeSeriesSplit
from ..models.base import extract_metadata
from ..models.models import _FIT_KWARGS, WindowedSequenceEstimator
from ..models.scaler import MinMaxScaler, Pipeline
from ..models.spec import ModelSpec, TransformerBlock
from ..models.utils import Frame, index_label
from ..ops.nn import StackedTransformerModel, init_model_params, stack_params
from ..ops.predict import n_train_samples
from ..ops.train import make_optimizer, run_masked_epoch
from ..util import disk_registry

logger = logging.getLogger(__name__)

# machine-windows per predict launch: the serving path's 1,024 windows of
# one request, so that a bucket's fold predicts keep the serving peak
PREDICT_WINDOWS = 1024
METRIC_NAMES = ("explained_variance_score", "r2_score", "mean_squared_error",
                "mean_absolute_error")
STAGE_DATA_FETCH = "data_fetch"
STAGE_DATA_VALIDATION = "data_validation"
STAGE_TRAINING = "training"
STAGE_SERIAL_BUILD = "serial_build"


def _machine_seed(machine: Machine) -> int:
    """Combine evaluation.seed with the machine name into one RNG stream id."""
    seed = int(machine.evaluation.get("seed", 0))
    return (zlib.crc32(machine.name.encode()) ^ (seed * 2654435761)) & 0xFFFFFFFF


@dataclass
class QuarantineRecord:
    """Why one machine was dropped from a fleet build."""

    machine: str
    stage: str
    reason: str
    error: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# ------------------------------------------------------------------ planning
@dataclass
class _Plan:
    machine: Machine
    estimator_cls: type
    estimator_params: dict
    spec: ModelSpec
    scale_x: bool
    wrap_anomaly: bool
    anomaly_kwargs: Dict[str, Any] = field(default_factory=dict)
    epochs: int = 1
    batch_size: int = 32
    shuffle: bool = True
    n_splits: int = 3
    # filled during data load
    X: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None
    frame: Optional[Frame] = None
    target_columns: Optional[List[str]] = None
    query_duration: float = 0.0
    dataset_meta: Dict[str, Any] = field(default_factory=dict)

    def bucket_key(self) -> Tuple:
        return (self.spec, len(self.X), self.epochs, self.batch_size, self.shuffle,
                self.scale_x, self.n_splits)


def _plan_machine(machine: Machine) -> Optional[_Plan]:
    """The machine's model definition as a batchable plan, or None where
    the serial builder must build it, as the JAX planner decides."""
    evaluation = machine.evaluation
    if evaluation.get("cv_mode", "full_build") != "full_build":
        return None
    if any(m.rsplit(".", 1)[-1] not in METRIC_NAMES for m in evaluation.get("metrics") or []):
        return None
    try:
        model = serializer.from_definition(machine.model)
    except Exception:  # noqa: BLE001 -- anything the port cannot build goes serial
        return None
    anomaly_kwargs: Dict[str, Any] = {}
    inner = model
    wrap_anomaly = isinstance(model, DiffBasedAnomalyDetector)
    if wrap_anomaly:
        if type(model) is not DiffBasedAnomalyDetector or model.shuffle:
            return None
        if not isinstance(model.scaler, MinMaxScaler) or tuple(model.scaler.feature_range) != (0, 1):
            return None
        anomaly_kwargs = {"require_thresholds": model.require_thresholds, "window": model.window,
                          "smoothing_method": model.smoothing_method, "shuffle": model.shuffle}
        inner = model.base_estimator
    scale_x = False
    if isinstance(inner, Pipeline):
        steps = [step for _, step in inner.steps]
        if len(steps) == 2 and isinstance(steps[0], MinMaxScaler):
            if tuple(steps[0].feature_range) != (0, 1):
                return None
            scale_x, inner = True, steps[1]
        elif len(steps) == 1:
            inner = steps[0]
        else:
            return None
    if not isinstance(inner, WindowedSequenceEstimator):
        return None
    n_splits = 3
    if evaluation.get("cv") is not None:
        try:
            cv = serializer.from_definition(evaluation["cv"])
        except Exception:  # noqa: BLE001 -- gap/test_size/KFold: serial
            return None
        if not isinstance(cv, TimeSeriesSplit):
            return None
        n_splits = cv.n_splits
    fit_args = {k: v for k, v in inner.kwargs.items() if k in _FIT_KWARGS}
    if fit_args.get("callbacks") or fit_args.get("validation_split"):
        return None
    try:
        spec = inner.build_spec(len(machine.dataset.tag_list),
                                len(machine.dataset.target_tag_list))
    except Exception:  # noqa: BLE001 -- a parallel axis or unknown kind: serial
        return None
    if any(isinstance(layer, TransformerBlock) and layer.attention_impl == "ring"
           for layer in spec.layers):
        return None
    return _Plan(
        machine=machine, estimator_cls=type(inner), estimator_params=inner.get_params(),
        spec=spec, scale_x=scale_x, wrap_anomaly=wrap_anomaly, anomaly_kwargs=anomaly_kwargs,
        epochs=int(fit_args.get("epochs", 1)), batch_size=int(fit_args.get("batch_size", 32)),
        shuffle=bool(fit_args.get("shuffle", True)), n_splits=n_splits,
    )


def _fold_bounds(n_rows: int, n_splits: int) -> Tuple[Tuple[int, int, int], ...]:
    """``(train end, test start, test end)`` of each TimeSeriesSplit fold."""
    return tuple(
        (int(train_idx[-1]) + 1, int(test_idx[0]), int(test_idx[-1]) + 1)
        for train_idx, test_idx in TimeSeriesSplit(n_splits).split(np.zeros(n_rows))
    )


# ------------------------------------------------------------ the program
@dataclass(frozen=True)
class Stage:
    """One fit of the bucket program: its train rows, live and streamed
    sample counts, batch, and the test slice its model predicts (none for
    the full fit)."""

    train_rows: int
    n_valid: int
    n_max: int
    batch: int
    test_start: int = 0
    test_len: int = 0


def stages_of(spec: ModelSpec, n_rows: int, fold_bounds, batch_size: int) -> List[Stage]:
    """The folds, then the full fit. Where every fold's test slice has one
    length, every stage streams the full fit's sample count at its batch
    and runs only its own live steps (the JAX fused program); otherwise each
    fold is a fit of its own samples and batch (the unrolled program)."""
    n_full = n_train_samples(spec, n_rows)
    fused = len({end - start for _, start, end in fold_bounds}) == 1
    stages = []
    for train_end, test_start, test_end in fold_bounds:
        n_valid = n_train_samples(spec, train_end)
        n_max = n_full if fused else n_valid
        stages.append(Stage(train_end, n_valid, n_max, min(batch_size, max(n_max, 1)),
                            test_start, test_end - test_start))
    stages.append(Stage(n_rows, n_full, n_full, min(batch_size, max(n_full, 1))))
    return stages


def _generator(seed: int, stage: int, slot: int) -> torch.Generator:
    """A CPU generator for one machine's stage: slot 0 its initial
    parameters, slot e + 1 its order of epoch e."""
    return torch.Generator().manual_seed((seed << 32) | (stage << 16) | slot)


def draw_inputs(seeds: List[int], spec: ModelSpec, stages: List[Stage], epochs: int,
                shuffle: bool):
    """Each stage's initial parameters, stacked over machines, and each
    stage's and epoch's (M, n_max) valid-first sample orders, from
    generators seeded by each machine's seed, the stage and the epoch."""
    inits, orders = [], []
    for k, stage in enumerate(stages):
        inits.append(stack_params([
            [{name: value.numpy() for name, value in p.items()}
             for p in init_model_params(spec, _generator(seed, k, 0))]
            for seed in seeds
        ]))
        tail = torch.arange(stage.n_valid, stage.n_max)
        orders.append([
            torch.stack([
                torch.cat([torch.randperm(stage.n_valid, generator=_generator(seed, k, e + 1)),
                           tail]) if shuffle else torch.arange(stage.n_max)
                for seed in seeds
            ])
            for e in range(epochs)
        ])
    return inits, orders


def _minmax(X: torch.Tensor, train_rows: int) -> torch.Tensor:
    """Each machine's X scaled per feature by the min and max of its first
    ``train_rows`` rows (sklearn's MinMaxScaler, a span below 10 eps taken
    as 1), in float32 as the JAX program scales it."""
    train = X[:, :train_rows]
    low = train.amin(dim=1, keepdim=True)
    span = train.amax(dim=1, keepdim=True) - low
    tiny = 10 * torch.finfo(X.dtype).eps
    return (X - low) * (1.0 / torch.where(span < tiny, torch.ones_like(span), span))


def predict_windows(model: StackedTransformerModel, X: torch.Tensor) -> np.ndarray:
    """The stacked model's output over each machine's windows of X (M, rows,
    D), in chunks of PREDICT_WINDOWS machine-windows a launch."""
    spec = model.spec
    M, n_rows = X.shape[:2]
    n_out = n_rows - spec.lookback_window + 1 - spec.lookahead
    chunk = max(PREDICT_WINDOWS // M, 1)
    outs = []
    with torch.inference_mode():
        for start in range(0, n_out, chunk):
            stop = min(start + chunk, n_out)
            rows = X[:, start:stop + spec.lookback_window - 1]
            xb = rows.unfold(1, spec.lookback_window, 1).transpose(2, 3)  # (M, W, L, D)
            outs.append(model(xb).cpu())
    return torch.cat(outs, dim=1).numpy()


def run_bucket(spec: ModelSpec, X: np.ndarray, y: np.ndarray, stages: List[Stage], epochs: int,
               scale_x: bool, inits, orders, device):
    """The bucket program over M machines' stacked data (X (M, rows, D), y
    (M, rows, D_out)) with the given initial parameters and orders
    (:func:`draw_inputs`'s layout). Returns the full fit's stacked
    parameters (a ``StackedTransformerModel``), its epoch losses (M,
    epochs) and each fold's predictions of its test slice (M, windows,
    D_out)."""
    X_d = torch.as_tensor(np.asarray(X, np.float32), device=device)
    y_d = torch.as_tensor(np.asarray(y, np.float32), device=device)
    fold_preds = []
    for k, stage in enumerate(stages):
        Xs = _minmax(X_d, stage.train_rows) if scale_x else X_d
        model = StackedTransformerModel(spec, inits[k], device)
        optimizer = make_optimizer(spec.optimizer, model.parameters())
        losses = [run_masked_epoch(model, optimizer, Xs, y_d, orders[k][e], stage.n_valid,
                                   stage.batch)[0] for e in range(epochs)]
        if stage.test_len:
            fold_preds.append(predict_windows(
                model, Xs[:, stage.test_start:stage.test_start + stage.test_len]))
    return model, torch.stack(losses, dim=1).cpu().numpy(), fold_preds


def _diverged(params, losses: np.ndarray) -> Optional[str]:
    """None when a trained machine's losses and parameters are finite, else
    what is not (its artifact would serve garbage)."""
    if not np.all(np.isfinite(losses)):
        return "non-finite training loss"
    for layer in params:
        for name, value in layer.items():
            if not np.all(np.isfinite(value)):
                return f"non-finite model parameters ({name}, shape {value.shape})"
    return None


# ------------------------------------------------------- fold metrics
def _metric_per_column(name: str, yt: np.ndarray, yp: np.ndarray) -> np.ndarray:
    """One metric per column of (n, D) targets and predictions, sklearn's
    formulas (uniform over outputs when averaged)."""
    if name == "mean_squared_error":
        return ((yt - yp) ** 2).mean(axis=0)
    if name == "mean_absolute_error":
        return np.abs(yt - yp).mean(axis=0)
    if name == "r2_score":
        ss_res = ((yt - yp) ** 2).sum(axis=0)
        ss_tot = ((yt - yt.mean(axis=0)) ** 2).sum(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            r2 = 1.0 - ss_res / ss_tot
        return np.where(ss_tot == 0.0, np.where(ss_res == 0.0, 1.0, 0.0), r2)
    if name == "explained_variance_score":
        num, den = (yt - yp).var(axis=0), yt.var(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            ev = 1.0 - num / den
        return np.where(den == 0.0, np.where(num == 0.0, 1.0, 0.0), ev)
    raise ValueError(f"Unsupported metric {name!r}")


def _summary(values: np.ndarray) -> Dict[str, float]:
    entry = {"fold-mean": float(values.mean()), "fold-std": float(values.std()),
             "fold-max": float(values.max()), "fold-min": float(values.min())}
    entry.update({f"fold-{k + 1}": float(v) for k, v in enumerate(values)})
    return entry


# --------------------------------------------------------------- the builder
class BatchedModelBuilder:
    """Train many machines at once on one card (``cuda`` unless ``device``
    is ``"cpu"``).

    ``chunk_size``: machines per stacked program; a bucket is trained a
    chunk at a time, which bounds peak device memory, and a chunk that runs
    out of it is halved. The default, 64 (the JAX builder's is 256), is
    measured on an H100 80GB (``scripts/torch_fleet_memory.py``): a
    ``transformer-ae-512`` chunk peaks at 42.9 GiB in float32 at 64
    machines and runs out at 128 (bf16: 21.9 GiB at 64, 43.8 at 128), and
    at 64 a machine-step takes within 5% of the time it takes in the
    largest chunk that fits (float32 4.98 ms; bf16 1.96 ms, 1.87 at 128).
    ``output_dir``/``model_register_dir``: every machine is
    written into ``{output_dir}/{name}`` and registered under its cache key
    as soon as its chunk is done; a machine the register already has is
    loaded instead of trained, unless ``replace_cache``. ``fail_fast``: the
    first fault raises instead of quarantining the machine."""

    def __init__(self, machines: List[Machine], serial_fallback: bool = True,
                 chunk_size: int = 64, output_dir: Optional[str] = None,
                 model_register_dir: Optional[str] = None, replace_cache: bool = False,
                 fail_fast: bool = False, device=None):
        self.machines = machines
        self.serial_fallback = serial_fallback
        self.chunk_size = max(1, chunk_size)
        self.output_dir = output_dir
        self.model_register_dir = model_register_dir
        self.replace_cache = replace_cache
        self.fail_fast = fail_fast
        self.device = device
        # the outcome of the last build: quarantined machines with their
        # records, the machines built by the serial builder or loaded from
        # the register instead of the stacked program, and the chunks halved
        # after running out of device memory
        self.quarantine_records: List[QuarantineRecord] = []
        self.serial_built: List[str] = []
        self.from_cache: List[str] = []
        self.oom_bisections = 0

    def build(self) -> List[Tuple[Any, Machine]]:
        """Train and return ``(model, machine)`` for every machine built,
        in input order."""
        device = resolve_device(self.device)
        self.quarantine_records, self.serial_built, self.from_cache = [], [], []
        self.oom_bisections = 0
        results: Dict[int, Tuple[Any, Machine]] = {}
        plans: Dict[int, _Plan] = {}
        serial: List[int] = []
        for i, machine in enumerate(self.machines):
            cached = self._cached(machine)
            if cached is not None:
                results[i] = cached
                self.from_cache.append(machine.name)
                continue
            plan = _plan_machine(machine)
            if plan is None:
                serial.append(i)
            else:
                plans[i] = plan

        for i in serial:
            machine = self.machines[i]
            if not self.serial_fallback:
                raise ValueError(f"Machine {machine.name} is not batchable and "
                                 f"serial_fallback=False")
            logger.info("Machine %s: serial fallback", machine.name)
            built = self._guarded(machine, STAGE_SERIAL_BUILD, self._serial_build, machine)
            if built is not None:
                results[i] = built

        for i in list(plans):
            if self._guarded(plans[i].machine, STAGE_DATA_FETCH, self._load_data, plans[i]) is None:
                del plans[i]
        for i in list(plans):
            bad = non_finite_report(plans[i].X, plans[i].y)
            if bad is not None:
                error = NonFiniteDataError(f"machine {plans[i].machine.name}: {bad}")
                if self.fail_fast:
                    raise error
                self._quarantine(plans[i].machine, STAGE_DATA_VALIDATION, "non_finite_data", bad)
                del plans[i]

        buckets: Dict[Tuple, List[int]] = {}
        for i, plan in plans.items():
            buckets.setdefault(plan.bucket_key(), []).append(i)
        for idxs in buckets.values():
            results.update(self._build_bucket_guarded([plans[i] for i in idxs], idxs, device))
        return [results[i] for i in sorted(results)]

    # ------------------------------------------------------------ helpers
    def _guarded(self, machine: Machine, stage: str, fn, *args):
        """``fn(*args)``, or None with the machine quarantined at ``stage``
        if it raises (``fail_fast`` raises)."""
        try:
            return fn(*args)
        except Exception as exc:
            if self.fail_fast:
                raise
            reason = "fetch_failure" if stage == STAGE_DATA_FETCH else type(exc).__name__
            self._quarantine(machine, stage, reason, f"{type(exc).__name__}: {exc}")
            return None

    def _quarantine(self, machine: Machine, stage: str, reason: str, error: str) -> None:
        record = QuarantineRecord(machine.name, stage, reason, error)
        logger.error("Machine %s QUARANTINED at %s (%s): %s", machine.name, stage, reason, error)
        self.quarantine_records.append(record)

    def _machine_dir(self, name: str) -> Optional[str]:
        return os.path.join(self.output_dir, name) if self.output_dir else None

    def _cached(self, machine: Machine) -> Optional[Tuple[Any, Machine]]:
        """The register's artifact of the machine, copied into this build's
        output directory where it is elsewhere; None on a miss, with
        ``replace_cache``, or for a corrupt artifact (whose entry is
        evicted)."""
        if not self.model_register_dir:
            return None
        key = ModelBuilder.calculate_cache_key(machine)
        if self.replace_cache:
            disk_registry.delete_value(self.model_register_dir, key)
            return None
        path = ModelBuilder(machine).check_cache(self.model_register_dir)
        if not path:
            return None
        try:
            model, machine_out = ModelBuilder.load_from_cache(path, self.device)
        except Exception as exc:
            if self.fail_fast:
                raise
            logger.warning("Machine %s: corrupt cache artifact at %s (%s); rebuilding",
                           machine.name, path, exc)
            disk_registry.delete_value(self.model_register_dir, key)
            return None
        logger.info("Machine %s: loaded from cache", machine.name)
        target = self._machine_dir(machine.name)
        if target and os.path.realpath(target) != os.path.realpath(path):
            self._persist(machine, model, machine_out)
        return model, machine_out

    def _serial_build(self, machine: Machine) -> Tuple[Any, Machine]:
        built = ModelBuilder(machine, self.device).build(
            output_dir=self._machine_dir(machine.name),
            model_register_dir=self.model_register_dir)
        self.serial_built.append(machine.name)
        return built

    def _load_data(self, plan: _Plan) -> _Plan:
        started = time.time()
        dataset = GordoBaseDataset.from_dict(plan.machine.dataset.to_dict())
        X, y = dataset.get_data()
        plan.X = np.ascontiguousarray(X.values, np.float32)
        plan.y = np.ascontiguousarray(y.values, np.float32)
        plan.frame = X
        plan.target_columns = list(y.columns)
        plan.query_duration = time.time() - started
        plan.dataset_meta = dataset.get_metadata()
        return plan

    def _persist(self, machine: Machine, model, machine_out: Machine) -> None:
        """Write one machine's artifact and register it under its cache key."""
        model_dir = self._machine_dir(machine.name)
        if model_dir is None:
            return
        ModelBuilder._save_model(model, machine_out, model_dir)
        if self.model_register_dir:
            disk_registry.write_key(self.model_register_dir,
                                    ModelBuilder.calculate_cache_key(machine), model_dir)

    # ------------------------------------------------------------- buckets
    def _build_bucket_guarded(self, bucket: List[_Plan], idxs: List[int], device):
        """One bucket, ``chunk_size`` machines at a time (each chunk through
        :meth:`_build_chunk_guarded`); a bucket whose folds cannot train has
        each machine built by the serial builder."""
        plan0 = bucket[0]
        spec, n_rows = plan0.spec, len(plan0.X)
        fold_bounds = _fold_bounds(n_rows, plan0.n_splits)
        for train_end, _, _ in fold_bounds:
            if n_train_samples(spec, train_end) <= 0:
                error = ValueError(
                    f"CV fold with {train_end} rows yields no training samples for "
                    f"lookback_window={spec.lookback_window} lookahead={spec.lookahead} "
                    f"(machines: {[p.machine.name for p in bucket]})")
                if self.fail_fast:
                    raise error
                return self._serial_rebuild(bucket, idxs, error)
        stages = stages_of(spec, n_rows, fold_bounds, plan0.batch_size)
        out = {}
        for start in range(0, len(bucket), self.chunk_size):
            out.update(self._build_chunk_guarded(
                bucket[start:start + self.chunk_size], idxs[start:start + self.chunk_size],
                stages, fold_bounds, device))
        logger.info("Batched bucket: %d machines", len(bucket))
        return out

    def _build_chunk_guarded(self, group: List[_Plan], idxs: List[int], stages, fold_bounds,
                             device):
        """One chunk as one stacked program. A chunk of more than one
        machine that runs out of device memory is halved and each half
        built on its own, as the JAX builder bisects a bucket (counted in
        ``oom_bisections``); a chunk that fails otherwise has each machine
        built by the serial builder, quarantining those whose serial build
        fails too. ``fail_fast`` raises instead."""
        try:
            return self._build_chunk(group, idxs, stages, fold_bounds, device)
        except Exception as exc:
            if self.fail_fast:
                raise
            error, oom = exc, isinstance(exc, torch.OutOfMemoryError)
            # the failed program's tensors are held by the traceback's frames
            error.__traceback__ = None
        if oom and len(group) > 1:
            if device.type == "cuda":
                torch.cuda.empty_cache()
            mid = len(group) // 2
            logger.warning("Chunk of %d machines ran out of device memory (%s); bisecting "
                           "into %d + %d", len(group), error, mid, len(group) - mid)
            self.oom_bisections += 1
            return {**self._build_chunk_guarded(group[:mid], idxs[:mid], stages, fold_bounds,
                                                device),
                    **self._build_chunk_guarded(group[mid:], idxs[mid:], stages, fold_bounds,
                                                device)}
        return self._serial_rebuild(group, idxs, error)

    def _serial_rebuild(self, group: List[_Plan], idxs: List[int], error: Exception):
        logger.warning("Stacked program of %d machines failed (%s: %s); building each serially",
                       len(group), type(error).__name__, error)
        out = {}
        for i, plan in zip(idxs, group):
            built = self._guarded(plan.machine, STAGE_TRAINING, self._serial_build, plan.machine)
            if built is not None:
                out[i] = built
        return out

    def _build_chunk(self, group: List[_Plan], idxs: List[int], stages, fold_bounds, device):
        plan0 = group[0]
        started = time.time()
        inits, orders = draw_inputs([_machine_seed(p.machine) for p in group], plan0.spec,
                                    stages, plan0.epochs, plan0.shuffle)
        model, losses, fold_preds = run_bucket(
            plan0.spec, np.stack([p.X for p in group]), np.stack([p.y for p in group]), stages,
            plan0.epochs, plan0.scale_x, inits, orders, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        # the stacked program's wall, shared evenly by the chunk's machines,
        # the CV taking the folds' share of the stages
        per_machine = (time.time() - started) / len(group)
        cv_share = per_machine * len(fold_bounds) / len(stages)
        out = {}
        for j, plan in enumerate(group):
            params = model.machine_params(j)
            bad = _diverged(params, losses[j])
            if bad is not None:
                if self.fail_fast:
                    raise ValueError(f"machine {plan.machine.name} diverged: {bad}")
                self._quarantine(plan.machine, STAGE_TRAINING, "diverged", bad)
                continue
            built = self._assemble(plan, params, losses[j], [p[j] for p in fold_preds],
                                   fold_bounds, per_machine - cv_share, cv_share, device)
            self._persist(plan.machine, *built)
            out[idxs[j]] = built
        return out

    # ------------------------------------------------------------ assembly
    def _assemble(self, plan: _Plan, params, losses: np.ndarray, fold_preds, fold_bounds,
                  train_duration: float, cv_duration: float, device) -> Tuple[Any, Machine]:
        estimator = plan.estimator_cls(**plan.estimator_params)
        estimator.load_params(plan.spec, params, device)
        estimator.history = {
            "loss": [float(x) for x in losses],
            "params": {"epochs": plan.epochs, "batch_size": plan.batch_size,
                       "metrics": ["loss"]},
        }
        model: Any = estimator
        if plan.scale_x:
            model = Pipeline([("step_0", MinMaxScaler().fit(plan.X)), ("step_1", estimator)])
        if plan.wrap_anomaly:
            detector = DiffBasedAnomalyDetector(base_estimator=model, scaler=MinMaxScaler(),
                                                **plan.anomaly_kwargs)
            detector.scaler.fit(plan.y)
            # the serial detector's thresholds, from the program's fold predictions
            detector.set_thresholds(self._fold_errors(plan, fold_preds, fold_bounds))
            model = detector

        machine_out = ModelBuilder(plan.machine)._fresh_machine()
        machine_out.metadata.build_metadata = BuildMetadata(
            model=ModelBuildMetadata(
                model_offset=plan.spec.output_offset,
                model_creation_date=str(
                    datetime.datetime.now(datetime.timezone.utc).astimezone()),
                model_builder_version=__version__,
                model_training_duration_sec=train_duration,
                cross_validation=CrossValidationMetaData(
                    cv_duration_sec=cv_duration,
                    scores=self._fold_scores(plan, fold_preds, fold_bounds),
                    splits=self._split_metadata(plan.frame, fold_bounds)),
                model_meta=extract_metadata(model),
            ),
            dataset=DatasetBuildMetadata(query_duration_sec=plan.query_duration,
                                         dataset_meta=plan.dataset_meta),
            phases={"fetch": plan.query_duration, "cross_validation": cv_duration,
                    "fit": train_duration},
        )
        return model, machine_out

    @staticmethod
    def _fold_errors(plan: _Plan, fold_preds, fold_bounds):
        """Each fold's (scaled point MSE, absolute error per tag) on its test
        span, y scaled by the min and max of the fold's train targets."""
        offset = plan.spec.output_offset
        errors = []
        for (train_end, test_start, test_end), pred in zip(fold_bounds, fold_preds):
            truth = plan.y[test_start + offset:test_end]
            train_y = plan.y[:train_end]
            low = train_y.min(axis=0)
            span = train_y.max(axis=0) - low
            scale = 1.0 / np.where(span < 10 * np.finfo(span.dtype).eps, 1.0, span)
            errors.append(((((pred - truth) * scale) ** 2).mean(axis=1), np.abs(truth - pred)))
        return errors

    @staticmethod
    def _fold_scores(plan: _Plan, fold_preds, fold_bounds) -> Dict[str, Any]:
        """Per-tag and aggregate fold scores, with the serial builder's names."""
        evaluation = plan.machine.evaluation
        names = [m.rsplit(".", 1)[-1] for m in evaluation.get("metrics") or METRIC_NAMES]
        scaler = None
        if evaluation.get("scoring_scaler"):
            scaler = evaluation["scoring_scaler"]
            if isinstance(scaler, (str, dict)):
                scaler = serializer.from_definition(scaler)
            scaler.fit(plan.y)
        offset = plan.spec.output_offset
        per_fold = {name: [] for name in names}
        for (_, test_start, test_end), pred in zip(fold_bounds, fold_preds):
            truth = plan.y[test_start + offset:test_end]
            if scaler is not None:
                truth, pred = scaler.transform(truth), scaler.transform(pred)
            for name in names:
                per_fold[name].append(_metric_per_column(name, truth, pred))
        scores: Dict[str, Any] = {}
        for name in names:
            slug = name.replace("_", "-")
            columns = np.stack(per_fold[name])  # (folds, D)
            for d, tag in enumerate(plan.target_columns):
                scores[f"{slug}-{tag.replace(' ', '-')}"] = _summary(columns[:, d])
            scores[slug] = _summary(columns.mean(axis=1))
        return scores

    @staticmethod
    def _split_metadata(frame: Frame, fold_bounds) -> Dict[str, Any]:
        splits: Dict[str, Any] = {}
        for k, (train_end, test_start, test_end) in enumerate(fold_bounds, start=1):
            splits.update({
                f"fold-{k}-train-start": index_label(frame, 0),
                f"fold-{k}-train-end": index_label(frame, train_end - 1),
                f"fold-{k}-test-start": index_label(frame, test_start),
                f"fold-{k}-test-end": index_label(frame, test_end - 1),
                f"fold-{k}-n-train": train_end,
                f"fold-{k}-n-test": test_end - test_start,
            })
        return splits
