"""
The port's configuration layer against the JAX package's on the CPU: the
definition DSL (``from_definition``/``into_definition`` round-trip the JAX
package's own Transformer definitions and the reference ``gordo.*``
aliases into the definition the JAX package writes), callbacks built from
definitions, the seven optimizers against optax over 10 steps, the
default metrics against sklearn, and ``Machine``/``NormalizedConfig``
against the JAX ones for configs with globals.
"""

import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import sklearn.metrics
import torch

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.machine.metadata import BuildMetadata as JaxBuildMetadata
from gordo_tpu.models.spec import OptimizerSpec as JaxOptimizerSpec
from gordo_tpu.ops.train import make_optimizer as jax_make_optimizer
from gordo_tpu.workflow.normalized_config import NormalizedConfig as JaxNormalizedConfig
from gordo_tpu_torch import serializer
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.machine.metadata import BuildMetadata, CrossValidationMetaData
from gordo_tpu_torch.models import base
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.base import clone
from gordo_tpu_torch.models.callbacks import EarlyStopping
from gordo_tpu_torch.models.models import TransformerAutoEncoder, TransformerForecast
from gordo_tpu_torch.models.spec import OptimizerSpec
from gordo_tpu_torch.ops.train import make_optimizer
from gordo_tpu_torch.util import disk_registry
from gordo_tpu_torch.workflow.normalized_config import NormalizedConfig

# float32 parameters after 10 steps of the same gradients, the largest error
# relative to the largest parameter (entries near 0 carry the others' rounding)
TOL_OPTIMIZER_REL = 1e-6
TOL_METRIC_REL = 1e-12  # float64, sums in another order

SMALL = {"kind": "transformer_model", "lookback_window": 16, "d_model": 16, "num_heads": 2,
         "ff_dim": 32, "num_blocks": 1, "epochs": 1}
DEFINITIONS = {
    # tests/gordo_tpu/test_attention_models.py
    "estimator": {"gordo_tpu.models.models.TransformerAutoEncoder": {
        "kind": "transformer_model", "lookback_window": 12, "d_model": 8, "num_heads": 2,
        "epochs": 1}},
    # tests/test_torch_serving.py, and chip_smoke.py's BUILD_CONFIG at a small width
    "detector": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {
        "window": 6,
        "base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler",
            {"gordo_tpu.models.models.TransformerAutoEncoder": SMALL}]}}}},
    "forecast": {"sklearn.pipeline.Pipeline": {"steps": [
        {"sklearn.preprocessing.MinMaxScaler": {"feature_range": [-1, 1]}},
        {"gordo_tpu.models.models.TransformerForecast": {**SMALL, "batch_size": 8}}]}},
    "reference-aliases": {"gordo.machine.model.anomaly.diff.DiffBasedAnomalyDetector": {
        "shuffle": True,
        "scaler": "MinMaxScaler",
        "base_estimator": {"Pipeline": {"steps": [
            "MinMaxScaler",
            {"gordo_tpu.models.models.TransformerAutoEncoder": {
                **SMALL, "callbacks": [
                    {"tensorflow.keras.callbacks.EarlyStopping": {"patience": 2}},
                    {"keras.callbacks.EarlyStopping": {"monitor": "loss"}}]}}]}}}},
    "short-alias": {"DiffBasedAnomalyDetector": {
        "base_estimator": {"gordo_tpu.models.models.TransformerAutoEncoder": SMALL}}},
}


def _json(definition) -> dict:
    return json.loads(json.dumps(definition))


@pytest.mark.parametrize("name", sorted(DEFINITIONS))
def test_definitions_round_trip_like_jax(name):
    definition = DEFINITIONS[name]
    ours = serializer.into_definition(serializer.from_definition(definition, device="cpu"))
    theirs = jax_serializer.into_definition(jax_serializer.from_definition(definition))
    assert _json(ours) == _json(theirs)
    # what the port writes, it reads back to the same definition
    again = serializer.into_definition(serializer.from_definition(_json(ours)))
    assert _json(again) == _json(ours)


def test_definitions_build_the_port_objects_on_the_given_device():
    detector = serializer.from_definition(DEFINITIONS["reference-aliases"], device="cpu")
    assert isinstance(detector, DiffBasedAnomalyDetector) and detector.shuffle
    (name, scaler), (_, estimator) = detector.base_estimator.steps
    assert name == "step_0" and isinstance(estimator, TransformerAutoEncoder)
    assert estimator.device == "cpu" and clone(detector).base_estimator.steps[1][1].device == "cpu"
    # callbacks stay definitions until fit builds them, as in the JAX package
    assert estimator.kwargs["callbacks"][0] == {
        "tensorflow.keras.callbacks.EarlyStopping": {"patience": 2}}
    forecast = serializer.from_definition(DEFINITIONS["forecast"])
    assert isinstance(forecast.steps[1][1], TransformerForecast)
    assert forecast.steps[1][1].device is None  # cuda, resolved when it runs
    assert tuple(forecast.steps[0][1].feature_range) == (-1, 1)


@pytest.mark.parametrize("path", ["subprocess.Popen", "gordo.reporters.mlflow.MlFlowReporter",
                                  "gordo_tpu.reporters.postgres.PostgresReporter",
                                  "sklearn.decomposition.TruncatedSVD"])
def test_paths_the_port_lacks_raise_import_error(path):
    with pytest.raises(ImportError, match=path.replace(".", r"\.")):
        serializer.from_definition({path: {}})


def test_callbacks_given_as_definitions_train():
    rng = np.random.RandomState(0)
    X = np.sin(np.arange(120)[:, None] / (3.0 + np.arange(3))) + 0.05 * rng.randn(120, 3)
    np.random.seed(0)
    est = serializer.from_definition({"gordo_tpu.models.models.TransformerAutoEncoder": {
        **SMALL, "epochs": 4, "callbacks": [
            {"keras.callbacks.EarlyStopping": {"monitor": "loss", "min_delta": 1e9}}]}},
        device="cpu")
    est.fit(X, X)
    # no epoch improves by 1e9: the callback stops the second epoch
    assert est.history["params"]["epochs"] == 2
    assert isinstance(serializer.load_params_from_definition(
        {"callbacks": [{"keras.callbacks.EarlyStopping": {}}]})["callbacks"][0], EarlyStopping)


OPTIMIZERS = [("Adam", {}), ("Adam", {"learning_rate": 0.01, "beta_1": 0.8}),
              ("SGD", {}), ("SGD", {"momentum": 0.9, "nesterov": True}), ("SGD", {"nesterov": True}),
              ("RMSprop", {}), ("RMSprop", {"rho": 0.8, "momentum": 0.5}),
              ("Adagrad", {}), ("Nadam", {}), ("Adamax", {"lr": 0.01}), ("AdamW", {})]


@pytest.mark.parametrize("name, kwargs", OPTIMIZERS)
def test_optimizers_follow_optax(name, kwargs):
    rng = np.random.RandomState(len(name))
    p0 = rng.randn(5, 7).astype(np.float32)
    grads = rng.randn(10, 5, 7).astype(np.float32)
    transform = jax_make_optimizer(JaxOptimizerSpec.create(name, kwargs))
    theirs = jnp.asarray(p0)
    state = transform.init(theirs)
    ours = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    optimizer = make_optimizer(OptimizerSpec.create(name, kwargs), [ours])
    for g in grads:
        updates, state = transform.update(jnp.asarray(g), state, theirs)
        theirs = optax.apply_updates(theirs, updates)
        ours.grad = torch.from_numpy(g.copy())
        optimizer.step()
    theirs = np.asarray(theirs)
    error = np.abs(ours.detach().numpy() - theirs).max() / np.abs(theirs).max()
    assert error <= TOL_OPTIMIZER_REL
    assert np.abs(theirs - p0).max() > 1e3 * TOL_OPTIMIZER_REL * np.abs(theirs).max()  # moved


@pytest.mark.parametrize("metric", ["explained_variance_score", "r2_score",
                                    "mean_squared_error", "mean_absolute_error"])
@pytest.mark.parametrize("shape", [(40,), (40, 3)])
def test_metrics_match_sklearn(metric, shape):
    rng = np.random.RandomState(2)
    y, pred = rng.rand(*shape), rng.rand(*shape)
    if len(shape) > 1:
        y[:, 1] = 2.0  # a constant column
    ours, theirs = getattr(base, metric), getattr(sklearn.metrics, metric)
    for p in (pred, y):
        np.testing.assert_allclose(ours(y, p), theirs(y, p), rtol=TOL_METRIC_REL, atol=1e-15)


GLOBALS = {
    "model": DEFINITIONS["detector"],
    "dataset": {"resolution": "10min", "train_start_date": "2020-01-01T00:00:00+00:00",
                "train_end_date": "2020-01-03T00:00:00+00:00",
                "data_provider": {"type": "RandomDataProvider", "seed": 1}},
    "evaluation": {"cv_mode": "cross_val_only", "seed": 3},
    "runtime": {"builder": {"resources": {"requests": {"memory": 9000},
                                          "limits": {"memory": 4000}}}},
    "metadata": {"owner": "ops"},
}
MACHINES = [
    {"name": "m-global", "dataset": {"tags": ["a", "b"], "resolution": "1h"}},
    {"name": "m-own", "dataset": {"tags": [["c", "asset-1"], {"name": "d"}]},
     "evaluation": {"cv_mode": "full_build"}, "metadata": {"note": 1},
     "model": DEFINITIONS["forecast"], "runtime": {"server": {"resources": {}}}},
]


@pytest.mark.parametrize("index", range(len(MACHINES)))
def test_machine_from_config_matches_jax(index):
    ours = Machine.from_config(MACHINES[index], "proj", config_globals=GLOBALS)
    theirs = JaxMachine.from_config(MACHINES[index], "proj", config_globals=GLOBALS)
    assert _json(ours.to_dict()) == _json(theirs.to_dict())
    assert ours.dataset.resolution == "10min"  # the globals win for the dataset
    assert Machine.from_dict(ours.to_dict()) == ours
    assert json.loads(str(ours)) == _json(ours.to_dict())


def test_normalized_config_matches_jax():
    config = {"machines": MACHINES, "globals": GLOBALS}
    ours = NormalizedConfig(config, project_name="proj")
    theirs = JaxNormalizedConfig(config, project_name="proj")
    assert _json(ours.globals) == _json(theirs.globals)
    assert [_json(m.to_dict()) for m in ours.machines] == [
        _json(m.to_dict()) for m in theirs.machines]


def test_machine_refusals():
    config = {"name": "ok-name", "model": DEFINITIONS["estimator"],
              "dataset": {"type": "RandomDataset", "tags": ["a"],
                          "train_start_date": "2020-01-01T00:00:00+00:00",
                          "train_end_date": "2020-01-02T00:00:00+00:00"}}
    Machine.from_config(config).report()
    for bad in ({"name": "Not_valid"}, {"model": {"subprocess.Popen": {}}}, {"model": "a: b"}):
        with pytest.raises(ValueError):
            Machine.from_config({**config, **bad})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Machine.from_config({**config, "runtime": {"reporters": [{"x": {}}]}}).report()


def test_build_metadata_records_match_jax():
    record = BuildMetadata(phases={"fit": 1.5})
    record.model.cross_validation = CrossValidationMetaData(scores={"a": {"fold-1": 1.0}})
    as_dict = record.to_dict()
    assert as_dict == JaxBuildMetadata.from_dict(as_dict).to_dict()
    assert BuildMetadata.from_dict(as_dict) == record
    assert BuildMetadata.from_dict({"unknown": 1}) == BuildMetadata()


def test_disk_registry(tmp_path):
    assert disk_registry.get_value(tmp_path, "a/b") is None
    disk_registry.write_key(tmp_path, "a/b", "/some/where")
    disk_registry.write_key(tmp_path, "a/b", "/else/where")
    assert disk_registry.get_value(tmp_path, "a/b") == "/else/where"
    assert disk_registry.delete_value(tmp_path, "a/b")
    assert not disk_registry.delete_value(tmp_path, "a/b")


# a long estimator repr: sklearn wraps it at 80 columns under the name's
# parenthesis, and elides the middle past 700 non-blank characters
LONG = {**SMALL, "activation": "gelu", "compute_dtype": "bfloat16", "pool": "mean",
        "optimizer": "SGD", "optimizer_kwargs": {"learning_rate": 0.01, "momentum": 0.5},
        "dropout": 0.0, "max_wavelength": 10000.0}
LONGEST = {**LONG, "optimizer_kwargs": {f"k{i}": float(i) for i in range(60)}}


@pytest.mark.parametrize("name", sorted(DEFINITIONS) + ["long", "longest", "scaler-range"])
def test_estimator_strings_match_sklearn_reprs(name):
    """The strings the detector writes as ``model_meta``'s ``scaler`` and
    ``base_estimator`` (and any estimator's repr) equal sklearn's
    changed-only, wrapped repr of the JAX package's objects."""
    definition = {
        "long": {"sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler",
            {"gordo_tpu.models.models.TransformerAutoEncoder": LONG}]}},
        "longest": {"gordo_tpu.models.models.TransformerAutoEncoder": LONGEST},
        "scaler-range": {"sklearn.preprocessing.MinMaxScaler": {
            "feature_range": (-1, 1), "clip": True}},
    }.get(name) or DEFINITIONS[name]
    ours = serializer.from_definition(definition, device="cpu")
    theirs = jax_serializer.from_definition(definition)
    assert repr(ours) == repr(theirs)
    for attribute in ("scaler", "base_estimator"):
        if hasattr(theirs, attribute):
            assert str(getattr(ours, attribute)) == str(getattr(theirs, attribute))
