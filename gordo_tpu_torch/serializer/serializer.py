"""
The port's artifact: one directory per model holding

- ``model.json``: the estimator class, the spec, the input scaler, the
  training history, the detector's fields and thresholds (final and per
  cross-validation fold), and the tags;
- ``params.npz``: the parameters, keyed ``"{layer}/{name}"``;
- ``metadata.json``: the build metadata (a machine's ``to_dict``) that the
  server returns and reads the dataset's resolution from, with the model's
  own metadata (thresholds per fold, training history) at
  ``metadata.build_metadata.model.model_meta``, where the JAX
  ``ModelBuilder`` puts it.

Every file is written atomically (a unique temp file, then a rename), as
``gordo_tpu/serializer/serializer.py`` writes its artifact. :func:`dumps`
packs an artifact directory into gzipped tar bytes (what the server's
``download-model`` answers) and :func:`loads` reads them back.
"""

import copy
import io
import json
import os
import tarfile
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np

from ..models.anomaly.diff import DiffBasedAnomalyDetector
from ..models.base import extract_metadata
from ..models.models import ESTIMATORS
from ..models.scaler import MinMaxScaler, Pipeline
from ..models.spec import spec_from_dict, spec_to_dict

FORMAT = "gordo_tpu_torch/1"
ARTIFACT_FILES = ("model.json", "params.npz", "metadata.json")


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


def _scaler_dict(scaler: MinMaxScaler) -> Dict[str, Any]:
    return {"min_": scaler.min_.tolist(), "scale_": scaler.scale_.tolist(),
            "feature_range": list(scaler.feature_range), "clip": scaler.clip}


def _scaler(fields: Dict[str, Any]) -> MinMaxScaler:
    """Inverse of :func:`_scaler_dict`; JSON keeps no tuples, and the
    default ``feature_range`` is one."""
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


def dump(detector: DiffBasedAnomalyDetector, dest_dir: str, tags: List[str],
         target_tags: Optional[List[str]] = None, metadata: Optional[dict] = None):
    """Write ``detector`` (a DiffBasedAnomalyDetector over
    ``Pipeline[MinMaxScaler, estimator]``) into ``dest_dir``."""
    if not isinstance(detector, DiffBasedAnomalyDetector):
        raise TypeError(
            f"the port's artifact holds a DiffBasedAnomalyDetector over "
            f"Pipeline[MinMaxScaler, estimator], not a {type(detector).__name__}"
        )
    os.makedirs(dest_dir, exist_ok=True)
    (_, input_scaler), (_, estimator) = detector.base_estimator.steps
    model = {
        "format": FORMAT,
        "estimator": type(estimator).__name__,
        "kind": estimator.kind,
        "kwargs": estimator.kwargs,
        "spec": spec_to_dict(estimator.spec_),
        "input_scaler": _scaler_dict(input_scaler),
        "detector": {
            "scaler": _scaler_dict(detector.scaler),
            "require_thresholds": detector.require_thresholds,
            "window": detector.window,
            "smoothing_method": detector.smoothing_method,
            "feature_thresholds": (
                None if detector.feature_thresholds_ is None
                else detector.feature_thresholds_.tolist()
            ),
            "aggregate_threshold": detector.aggregate_threshold_,
            "shuffle": detector.shuffle,
            **{name: _listed(getattr(detector, name)) for name in _CV_ATTRIBUTES},
        },
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
    """Read an artifact written by :func:`dump`, with the model's
    parameters placed on ``device`` (``cuda`` unless ``"cpu"``)."""
    with open(os.path.join(source_dir, "model.json")) as f:
        model = json.load(f)
    if model.get("format") != FORMAT:
        raise ValueError(f"{source_dir} is not a {FORMAT} artifact")
    spec = spec_from_dict(model["spec"])
    estimator = ESTIMATORS[model["estimator"]](model["kind"], **model["kwargs"])
    estimator.load_params(
        spec, load_params(os.path.join(source_dir, "params.npz"), len(spec.layers)),
        device,
    )
    estimator.history = model.get("history")
    det = model["detector"]
    detector = DiffBasedAnomalyDetector(
        base_estimator=Pipeline([
            ("scaler", _scaler(model["input_scaler"])),
            ("estimator", estimator),
        ]),
        scaler=_scaler(det["scaler"]),
        require_thresholds=det["require_thresholds"],
        shuffle=det.get("shuffle", False),
        window=det["window"],
        smoothing_method=det["smoothing_method"],
        feature_thresholds=det["feature_thresholds"],
        aggregate_threshold=det["aggregate_threshold"],
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


def loads(data: bytes, device=None) -> DiffBasedAnomalyDetector:
    """The detector of bytes made by :func:`dumps`, its parameters on
    ``device`` (``cuda`` unless ``"cpu"``). Only the artifact's own files
    are read from the tar."""
    with tempfile.TemporaryDirectory() as directory:
        with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
            for member in tar.getmembers():
                if member.isfile() and member.name in ARTIFACT_FILES:
                    with open(os.path.join(directory, member.name), "wb") as f:
                        f.write(tar.extractfile(member).read())
        return load(directory, device)
