"""
The port's artifact: one directory per model holding

- ``model.json``: the detector's class, fields and thresholds (final and
  per cross-validation fold), the pipeline's transform steps (each by its
  definition path, its constructor arguments and its fitted attributes; a
  ``FeatureUnion`` with its transformers), the estimator class, kind,
  arguments and spec, the training history, and the tags;
- ``params.npz``: the parameters, keyed ``"{layer}/{name}"``;
- ``metadata.json``: the build metadata (a machine's ``to_dict``) that the
  server returns and reads the dataset's resolution from, with the model's
  own metadata (thresholds per fold, training history) at
  ``metadata.build_metadata.model.model_meta``, where the JAX
  ``ModelBuilder`` puts it.

``dump`` writes any detector of the port (``DiffBasedAnomalyDetector`` or
``DiffBasedKFCVAnomalyDetector``) over a ``Pipeline`` of ported steps
ending in a ported estimator, or over the bare estimator. ``load`` reads
that layout (``FORMAT``) and the one written before it (``FORMAT_V1``: a
detector over ``Pipeline[MinMaxScaler, estimator]``).

Every file is written atomically (a unique temp file, then a rename), as
``gordo_tpu/serializer/serializer.py`` writes its artifact. :func:`dumps`
packs an artifact directory into gzipped tar bytes (what the server's
``download-model`` answers) and :func:`loads` reads them back.

The JAX package's artifact may also carry compiled serving programs
(``gordo_tpu/serializer/programs.py``: XLA executables written under
``GORDO_TPU_SHIP_PROGRAMS`` and loaded at serving under
``GORDO_TPU_LOAD_SHIPPED_PROGRAMS``, so that a node does not compile). The
port has no counterpart because it has nothing to ship: it traces and
compiles no program, its kernels are built once a host from their sources
(``ops/_build.py``) and its server runs eager torch over them. With either
knob set, :func:`dump` or :func:`load` logs once a process that no program
is shipped or loaded, and nothing else changes.
"""

import copy
import io
import json
import logging
import os
import tarfile
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np

from ..models.anomaly.diff import DiffBasedAnomalyDetector, DiffBasedKFCVAnomalyDetector
from ..models.base import extract_metadata
from ..models.models import ESTIMATORS
from ..models.scaler import FeatureUnion, MinMaxScaler, Pipeline
from ..models.spec import spec_from_dict, spec_to_dict
from .from_definition import from_definition
from .into_definition import load_definition_from_params
from .resolver import definition_path

logger = logging.getLogger(__name__)

FORMAT = "gordo_tpu_torch/2"
FORMAT_V1 = "gordo_tpu_torch/1"
DETECTORS = {cls.__name__: cls
             for cls in (DiffBasedAnomalyDetector, DiffBasedKFCVAnomalyDetector)}
ARTIFACT_FILES = ("model.json", "params.npz", "metadata.json")
# the JAX package's knobs for shipped serving programs, by side
PROGRAM_KNOBS = {"ship": "GORDO_TPU_SHIP_PROGRAMS", "load": "GORDO_TPU_LOAD_SHIPPED_PROGRAMS"}
_programs_noted: set = set()


def note_no_programs(side: str) -> None:
    """Log once a process, where ``side``'s knob (:data:`PROGRAM_KNOBS`) is
    on, that the port ships and loads no compiled program."""
    knob = PROGRAM_KNOBS[side]
    if knob in _programs_noted or os.environ.get(knob, "").lower() not in ("1", "true", "yes"):
        return
    _programs_noted.add(knob)
    logger.info("%s is set, but the port %s no compiled serving program: it compiles none "
                "(eager torch over kernels built from their sources)", knob,
                "ships" if side == "ship" else "loads")


def _atomic_write(final: str, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(final), prefix=os.path.basename(final) + ".tmp-"
    )
    umask = os.umask(0)
    os.umask(umask)
    os.fchmod(fd, 0o666 & ~umask)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, final)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _scaler(fields: Dict[str, Any]) -> MinMaxScaler:
    """A ``FORMAT_V1`` scaler; JSON keeps no tuples, and the default
    ``feature_range`` is one."""
    return MinMaxScaler(**dict(fields, feature_range=tuple(fields["feature_range"])))


def _listed(value):
    """Arrays (also inside a per-fold dict) as lists; None stays None."""
    if isinstance(value, dict):
        return {key: _listed(v) for key, v in value.items()}
    return value.tolist() if isinstance(value, np.ndarray) else value


def _arrays(value):
    """Inverse of :func:`_listed` for threshold values."""
    if isinstance(value, dict):
        return {key: _arrays(v) for key, v in value.items()}
    return np.asarray(value, np.float64) if isinstance(value, list) else value


# detector attributes computed by cross_validate, stored as they are
_CV_ATTRIBUTES = (
    "smooth_feature_thresholds_", "smooth_aggregate_threshold_",
    "feature_thresholds_per_fold_", "aggregate_thresholds_per_fold_",
    "smooth_feature_thresholds_per_fold_", "smooth_aggregate_thresholds_per_fold_",
)


def _step_record(name: str, step) -> Dict[str, Any]:
    """A transform step as its definition path, constructor arguments and
    fitted attributes; a feature union with its transformers' records; a
    ``"passthrough"`` (or None) placeholder as it is."""
    if step is None or isinstance(step, str):
        return {"name": name, "placeholder": step}
    params = step.get_params(deep=False)
    record: Dict[str, Any] = {"name": name, "path": definition_path(type(step))}
    if isinstance(step, FeatureUnion):
        record["transformers"] = [_step_record(*pair) for pair in params.pop("transformer_list")]
    record["params"] = load_definition_from_params(params)
    record["fitted"] = {attr: _listed(getattr(step, attr))
                        for attr in step.fitted_attributes if hasattr(step, attr)}
    return record


def _step(record: Dict[str, Any]):
    """Inverse of :func:`_step_record`. JSON keeps no tuples: a list of
    numbers among the arguments (a ``feature_range``) is read as one."""
    if "path" not in record:
        return record["placeholder"]
    params = {key: tuple(value) if isinstance(value, list) and all(
                  isinstance(v, (int, float)) for v in value) else value
              for key, value in record["params"].items()}
    if "transformers" in record:
        step = FeatureUnion([(r["name"], _step(r)) for r in record["transformers"]], **params)
    else:
        step = from_definition({record["path"]: params})
    for attr, value in record["fitted"].items():
        setattr(step, attr, _arrays(value))
    return step


def dump(detector: DiffBasedAnomalyDetector, dest_dir: str, tags: List[str],
         target_tags: Optional[List[str]] = None, metadata: Optional[dict] = None):
    """Write ``detector`` (a detector of :data:`DETECTORS` over a
    ``Pipeline`` of ported transform steps ending in a ported estimator, or
    over that estimator alone) into ``dest_dir``."""
    note_no_programs("ship")
    if type(detector).__name__ not in DETECTORS:
        raise TypeError(
            f"the port's artifact holds a DiffBasedAnomalyDetector or a "
            f"DiffBasedKFCVAnomalyDetector, not a {type(detector).__name__}"
        )
    base = detector.base_estimator
    steps = base.steps[:-1] if isinstance(base, Pipeline) else None
    estimator = base.steps[-1][1] if isinstance(base, Pipeline) else base
    if type(estimator).__name__ not in ESTIMATORS:
        raise TypeError(f"the pipeline ends in a {type(estimator).__name__}, not an "
                        f"estimator of the port")
    os.makedirs(dest_dir, exist_ok=True)
    fields = {
        "class": type(detector).__name__,
        "scaler": _step_record("scaler", detector.scaler),
        "require_thresholds": detector.require_thresholds,
        "window": detector.window,
        "smoothing_method": detector.smoothing_method,
        "feature_thresholds": _listed(detector.feature_thresholds_),
        "aggregate_threshold": detector.aggregate_threshold_,
        "shuffle": detector.shuffle,
        **{name: _listed(getattr(detector, name)) for name in _CV_ATTRIBUTES},
    }
    if isinstance(detector, DiffBasedKFCVAnomalyDetector):
        fields["threshold_percentile"] = detector.threshold_percentile
    model = {
        "format": FORMAT,
        "detector": fields,
        "steps": None if steps is None else [_step_record(*pair) for pair in steps],
        "estimator_name": base.steps[-1][0] if steps is not None else None,
        "estimator": type(estimator).__name__,
        "kind": estimator.kind,
        "kwargs": estimator.kwargs,
        "spec": spec_to_dict(estimator.spec_),
        "history": estimator.history,
        "tags": list(tags),
        "target_tags": list(target_tags if target_tags is not None else tags),
    }
    arrays = {
        f"{i}/{name}": np.asarray(value, np.float32)
        for i, layer in enumerate(estimator.module_.params_numpy())
        for name, value in layer.items()
    }
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    _atomic_write(os.path.join(dest_dir, "params.npz"), buf.getvalue())
    _atomic_write(
        os.path.join(dest_dir, "model.json"), json.dumps(model, indent=1).encode()
    )
    metadata = copy.deepcopy(metadata or {})
    build = metadata.setdefault("metadata", {}).setdefault("build_metadata", {})
    build.setdefault("model", {})["model_meta"] = extract_metadata(detector)
    _atomic_write(
        os.path.join(dest_dir, "metadata.json"), json.dumps(metadata, default=str).encode()
    )


def load_params(path: str, n_layers: int) -> List[Dict[str, np.ndarray]]:
    params: List[Dict[str, np.ndarray]] = [{} for _ in range(n_layers)]
    with np.load(path) as npz:
        for key in npz.files:
            layer, name = key.split("/", 1)
            params[int(layer)][name] = npz[key]
    return params


def load(source_dir: str, device=None) -> DiffBasedAnomalyDetector:
    """Read an artifact written by :func:`dump` (or in ``FORMAT_V1``), with
    the model's parameters placed on ``device`` (``cuda`` unless
    ``"cpu"``)."""
    note_no_programs("load")
    with open(os.path.join(source_dir, "model.json")) as f:
        model = json.load(f)
    if model.get("format") not in (FORMAT, FORMAT_V1):
        raise ValueError(f"{source_dir} is not a {FORMAT} artifact")
    spec = spec_from_dict(model["spec"])
    estimator = ESTIMATORS[model["estimator"]](model["kind"], **model["kwargs"])
    estimator.load_params(
        spec, load_params(os.path.join(source_dir, "params.npz"), len(spec.layers)),
        device,
    )
    estimator.history = model.get("history")
    det = model["detector"]
    if model["format"] == FORMAT_V1:
        base = Pipeline([("scaler", _scaler(model["input_scaler"])), ("estimator", estimator)])
        scaler, cls, extra = _scaler(det["scaler"]), DiffBasedAnomalyDetector, {}
    else:
        base = estimator
        if model["steps"] is not None:
            base = Pipeline([(r["name"], _step(r)) for r in model["steps"]]
                            + [(model["estimator_name"], estimator)])
        scaler, cls = _step(det["scaler"]), DETECTORS[det["class"]]
        extra = ({"threshold_percentile": det["threshold_percentile"]}
                 if "threshold_percentile" in det else {})
    detector = cls(
        base_estimator=base,
        scaler=scaler,
        require_thresholds=det["require_thresholds"],
        shuffle=det.get("shuffle", False),
        window=det["window"],
        smoothing_method=det["smoothing_method"],
        feature_thresholds=det["feature_thresholds"],
        aggregate_threshold=det["aggregate_threshold"],
        **extra,
    )
    for name in _CV_ATTRIBUTES:
        setattr(detector, name, _arrays(det.get(name)))
    return detector


def load_model_json(source_dir: str) -> Dict[str, Any]:
    with open(os.path.join(source_dir, "model.json")) as f:
        return json.load(f)


def load_metadata(source_dir: str) -> dict:
    """``metadata.json`` of an artifact, or ``{}`` when it has none."""
    path = os.path.join(source_dir, "metadata.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def dumps(source_dir: str) -> bytes:
    """The artifact in ``source_dir`` as the bytes of a gzipped tar of its
    files."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz", compresslevel=1) as tar:
        for name in ARTIFACT_FILES:
            path = os.path.join(source_dir, name)
            if os.path.exists(path):
                tar.add(path, arcname=name)
    return buf.getvalue()


def unpack(data: bytes, directory: str) -> None:
    """Write the artifact files of bytes made by :func:`dumps` into
    ``directory``; only the artifact's own files are read from the tar."""
    os.makedirs(directory, exist_ok=True)
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
        for member in tar.getmembers():
            if member.isfile() and member.name in ARTIFACT_FILES:
                with open(os.path.join(directory, member.name), "wb") as f:
                    f.write(tar.extractfile(member).read())


def loads(data: bytes, device=None) -> DiffBasedAnomalyDetector:
    """The detector of bytes made by :func:`dumps`, its parameters on
    ``device`` (``cuda`` unless ``"cpu"``)."""
    with tempfile.TemporaryDirectory() as directory:
        unpack(data, directory)
        return load(directory, device)
