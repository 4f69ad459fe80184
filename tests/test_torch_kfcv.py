"""
The KFCV detector, the detectors' default base estimator, and the
feedforward machines of ``examples/config.yaml`` end to end, the port
against the JAX package on the CPU:

- ``DiffBasedKFCVAnomalyDetector.cross_validate`` with every fold model on
  the same carried weights (each fold's fit replaced by loading the JAX
  package's initial parameters for that fold, on both sides: the RNG
  streams differ, so training is not compared): thresholds, fold scores,
  fold predictions scattered onto the test rows, and metadata;
- definitions: the example machines' models round-trip through
  ``from_definition``/``into_definition`` as the JAX package writes them;
- artifacts: a JAX-built feedforward detector (both kinds) carried into a
  port artifact and served by both servers answers with the same blocks,
  sub-columns and index keys, values within 1e-4; an artifact in the
  layout written before this port's feedforward family still loads;
- builds: the example machines built by the port's builder on the CPU,
  their KFold splits sklearn's, their artifacts answering both routes.
"""

import json
import os
import pickle
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
import yaml
from sklearn.model_selection import KFold as SkKFold

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder.local_build import local_build as jax_local_build
from gordo_tpu.models import models as jax_models
from gordo_tpu.models.anomaly import diff as jax_diff
from gordo_tpu.ops import nn as jax_nn
from gordo_tpu.server.server import build_app
from gordo_tpu_torch import serializer
from gordo_tpu_torch.builder.local_build import local_build
from gordo_tpu_torch.models import models
from gordo_tpu_torch.models.anomaly import diff
from gordo_tpu_torch.models.scaler import MinMaxScaler, Pipeline
from gordo_tpu_torch.serializer.from_jax import params_from_numpy, spec_from_dataclass
from gordo_tpu_torch.server.server import make_server
from test_torch_serving import REPO

TOL = dict(rtol=1e-5, atol=1e-6)  # float32 models on both sides
TOL_SERVED = 1e-4  # a served value, JAX against the port
EXAMPLES = os.path.join(REPO, "examples", "config.yaml")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _example_machines(**estimator):
    """The example config's two feedforward machines as written, the
    estimators' arguments updated by ``estimator``."""
    with open(EXAMPLES) as f:
        config = yaml.safe_load(f)["spec"]["config"]
    config["machines"] = [m for m in config["machines"]
                          if m["name"] in ("pump-station-a", "turbine-c")]
    for machine in config["machines"]:
        detector = next(iter(machine["model"].values()))
        steps = detector["base_estimator"]["sklearn.pipeline.Pipeline"]["steps"]
        steps[1]["gordo_tpu.models.models.AutoEncoder"].update(estimator)
    return config


# ------------------------------------------------------------- the detector
class _CarriedFits:
    """Each estimator fit, in order, loads the next of ``params`` (numpy,
    the JAX layout) instead of training, on both sides."""

    def __init__(self, monkeypatch, params):
        self.params, self.jax_fits, self.fits = params, 0, 0
        outer = self

        def jax_fit(estimator, X, y, **kwargs):
            estimator.spec_ = estimator.build_spec(X.shape[1], y.shape[1])
            estimator.params_ = outer.params[outer.jax_fits]
            outer.jax_fits += 1
            return estimator

        def port_fit(estimator, X, y, **kwargs):
            spec = estimator.build_spec(np.shape(X)[1], np.shape(y)[1])
            estimator.load_params(spec, params_from_numpy(spec, outer.params[outer.fits]), "cpu")
            outer.fits += 1
            return estimator

        monkeypatch.setattr(jax_models.AutoEncoder, "fit", jax_fit)
        monkeypatch.setattr(models.AutoEncoder, "fit", port_fit)


def _detectors(**kwargs):
    """(port, JAX) KFCV detectors over Pipeline[MinMaxScaler, AutoEncoder]."""
    from sklearn.pipeline import Pipeline as SkPipeline
    from sklearn.preprocessing import MinMaxScaler as SkMinMaxScaler

    ours = diff.DiffBasedKFCVAnomalyDetector(
        base_estimator=Pipeline([("step_0", MinMaxScaler()), ("step_1", models.AutoEncoder(
            "feedforward_hourglass", device="cpu"))]), **kwargs)
    theirs = jax_diff.DiffBasedKFCVAnomalyDetector(
        base_estimator=SkPipeline([("step_0", SkMinMaxScaler()), ("step_1", jax_models.AutoEncoder(
            kind="feedforward_hourglass"))]), **kwargs)
    return ours, theirs


def _fold_params(n_folds: int, n_features: int):
    spec = jax_models.AutoEncoder(kind="feedforward_hourglass").build_spec(n_features, n_features)
    return [[{k: np.asarray(v) for k, v in p.items()}
             for p in jax_nn.init_model_params(jax.random.PRNGKey(fold), spec)]
            for fold in range(n_folds)]


KFCV_CASES = {
    "defaults": ({}, None),
    "sma window 12, percentile 0.9": ({"window": 12, "smoothing_method": "sma",
                                       "threshold_percentile": 0.9}, None),
    "ewma window 24": ({"window": 24, "smoothing_method": "ewma"}, None),
    "KFold(3) unshuffled": ({"window": 12}, 3),
}


@pytest.mark.parametrize("case", list(KFCV_CASES))
def test_kfcv_thresholds_and_folds_match_jax_on_carried_weights(monkeypatch, case):
    kwargs, n_splits = KFCV_CASES[case]
    rng = np.random.RandomState(1)
    t = np.arange(400)[:, None]
    X = np.sin(t / (5.0 + 7 * rng.rand(1, 3))) + 0.1 * rng.randn(400, 3)
    ours, theirs = _detectors(**kwargs)
    cv = None
    if n_splits:
        from sklearn.model_selection import KFold as JaxKFold

        cv = (diff.KFold(n_splits), JaxKFold(n_splits))
    n_folds = n_splits or 5
    _CarriedFits(monkeypatch, _fold_params(n_folds, 3))
    out = ours.cross_validate(X=X, y=X, cv=cv and cv[0])
    jax_out = theirs.cross_validate(X=X, y=X, cv=cv and cv[1], return_estimator=True)
    np.testing.assert_allclose(ours.aggregate_threshold_, theirs.aggregate_threshold_, **TOL)
    np.testing.assert_allclose(ours.feature_thresholds_,
                               np.asarray(theirs.feature_thresholds_), **TOL)
    np.testing.assert_allclose(out["test_score"], jax_out["test_score"], rtol=1e-5, atol=1e-5)
    assert len(out["estimator"]) == len(jax_out["estimator"]) == n_folds
    splitter = cv[0] if cv else diff.KFold(5, shuffle=True, random_state=0)
    for (_, test), model, jax_model in zip(splitter.split(X), out["estimator"],
                                           jax_out["estimator"]):
        np.testing.assert_allclose(model.predict(X[test]), jax_model.predict(X[test]), **TOL)
    metadata, jax_metadata = ours.get_metadata(), theirs.get_metadata()
    assert sorted(metadata) == sorted(jax_metadata)
    for key, value in jax_metadata.items():
        if key in ("feature-thresholds", "aggregate-threshold"):
            np.testing.assert_allclose(metadata[key], value, **TOL)
        else:
            assert metadata[key] == value, key


def test_kfcv_refuses_an_estimator_with_an_offset_like_jax():
    ours = diff.DiffBasedKFCVAnomalyDetector(base_estimator=models.TransformerAutoEncoder(
        lookback_window=8, device="cpu"))
    theirs = jax_diff.DiffBasedKFCVAnomalyDetector(
        base_estimator=jax_models.TransformerAutoEncoder(kind="transformer_model",
                                                         lookback_window=8))
    X = np.zeros((50, 2))
    with pytest.raises(ValueError) as mine:
        ours.cross_validate(X=X, y=X)
    with pytest.raises(ValueError) as jax_error:
        theirs.cross_validate(X=X, y=X)
    assert str(mine.value) == str(jax_error.value)


@pytest.mark.parametrize("name", ["DiffBasedAnomalyDetector", "DiffBasedKFCVAnomalyDetector"])
def test_detectors_default_to_the_hourglass_autoencoder_like_jax(name):
    ours, theirs = getattr(diff, name)(), getattr(jax_diff, name)()
    assert repr(ours) == repr(theirs)
    assert isinstance(ours.base_estimator, models.AutoEncoder)
    assert ours.base_estimator.kind == theirs.base_estimator.kind == "feedforward_hourglass"
    built = serializer.from_definition({f"gordo_tpu.models.anomaly.diff.{name}": {}},
                                       device="cpu")
    assert built.base_estimator.device == "cpu" and repr(built) == repr(theirs)


# ------------------------------------------------------------- definitions
@pytest.mark.parametrize("machine", ["pump-station-a", "turbine-c"])
def test_example_definitions_round_trip_like_jax(machine):
    definition = next(m["model"] for m in _example_machines()["machines"]
                      if m["name"] == machine)
    ours, theirs = serializer.from_definition(definition), jax_serializer.from_definition(
        definition)
    assert repr(ours) == repr(theirs)
    written = serializer.into_definition(ours)
    assert written == jax_serializer.into_definition(theirs)
    assert serializer.into_definition(serializer.from_definition(written)) == written


# ------------------------------------------------------------- artifacts
def _carry(jax_model, device="cpu"):
    """The port's detector of an unpickled JAX detector: the same
    definition, the fitted scalers' arrays, the estimator's parameters and
    the thresholds."""
    detector = serializer.from_definition(jax_serializer.into_definition(jax_model), device)
    for (_, step), (_, jax_step) in zip(detector.base_estimator.steps[:-1],
                                        jax_model.base_estimator.steps[:-1]):
        for attr in step.fitted_attributes:
            setattr(step, attr, np.asarray(getattr(jax_step, attr)))
    jax_estimator = jax_model.base_estimator.steps[-1][1]
    spec = spec_from_dataclass(jax_estimator.spec_)
    estimator = detector.base_estimator.steps[-1][1]
    estimator.load_params(spec, params_from_numpy(spec, jax_estimator.params_), device)
    estimator.history = jax_estimator.history
    detector.scaler.min_, detector.scaler.scale_ = jax_model.scaler.min_, jax_model.scaler.scale_
    detector.feature_thresholds_ = np.asarray(jax_model.feature_thresholds_, np.float64)
    detector.aggregate_threshold_ = float(jax_model.aggregate_threshold_)
    return detector


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(JAX collection, port collection): the example's two feedforward
    machines built by the JAX package (1 epoch, 2 days), each carried into
    a port artifact."""
    root = tmp_path_factory.mktemp("kfcv")
    config = _example_machines(epochs=1)
    for machine in config["machines"]:
        machine["dataset"]["train_end_date"] = "2019-01-03T00:00:00+00:00"
    for model, machine in jax_local_build(yaml.safe_dump(config)):
        jax_dir = root / "jax" / "1" / machine.name
        jax_serializer.dump(model, str(jax_dir), metadata=machine.to_dict())
        with open(jax_dir / "model.pkl", "rb") as f:
            carried = _carry(pickle.load(f))
        serializer.dump(carried, str(root / "port" / "1" / machine.name),
                        tags=[t.name for t in machine.dataset.tag_list],
                        metadata=jax_serializer.load_metadata(str(jax_dir)))
    return root / "jax" / "1", root / "port" / "1"


def _serve(collection):
    server = make_server("127.0.0.1", 0, device="cpu", collection_dir=str(collection))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _bench_payload(tags, n_rows=100, seed=0):
    """``bench.py``'s anomaly request shape: 100 rows of each tag."""
    rng = np.random.RandomState(seed)
    stamps = [f"2019-01-05T{h:02d}:{m:02d}:00+00:00" for h in range(24) for m in range(0, 60, 10)]
    frame = lambda: {tag: dict(zip(stamps[:n_rows], rng.rand(n_rows).tolist()))  # noqa: E731
                     for tag in tags}
    return {"X": frame(), "y": frame()}


@pytest.mark.parametrize("machine", ["pump-station-a", "turbine-c"])
@pytest.mark.parametrize("route", ["prediction", "anomaly/prediction"])
def test_jax_artifact_served_by_the_port_answers_like_jax(served, machine, route):
    with open(EXAMPLES) as f:
        tags = next(m["dataset"]["tags"] for m in yaml.safe_load(f)["spec"]["config"]["machines"]
                    if m["name"] == machine)
    path = f"/gordo/v0/proj/{machine}/{route}?all_columns"
    payload = _bench_payload(tags)
    resp = build_app({"MODEL_COLLECTION_DIR": str(served[0])}).test_client().post(
        path, json=payload)
    server, thread, url = _serve(served[1])
    try:
        status, ours = _post(url + path, payload)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert status == resp.status_code == 200
    theirs = resp.get_json()
    assert sorted(ours) == sorted(theirs)
    assert len(ours["data"]["model-output"][tags[0]]) == 100
    # the blocks, sub-columns and index keys exactly; values within TOL_SERVED
    assert sorted(ours["data"]) == sorted(theirs["data"])
    for top, block in theirs["data"].items():
        assert sorted(ours["data"][top]) == sorted(block), top
        for sub, column in block.items():
            assert list(ours["data"][top][sub]) == list(column), (top, sub)
            for key, value in column.items():
                mine = ours["data"][top][sub][key]
                if isinstance(value, float):
                    assert abs(mine - value) <= TOL_SERVED * max(1.0, abs(value)), (top, sub, key)
                else:
                    assert mine == value


def test_artifact_of_the_earlier_layout_still_loads(tmp_path):
    """An artifact in ``gordo_tpu_torch/1``'s layout (a detector over
    ``Pipeline[MinMaxScaler, TransformerAutoEncoder]``, the scalers as
    min/scale lists), written by hand, loads and predicts."""
    spec = models.TransformerAutoEncoder(lookback_window=4, d_model=8, num_heads=2, ff_dim=8,
                                         num_blocks=1).build_spec(2, 2)
    from gordo_tpu_torch.models.spec import spec_to_dict
    from gordo_tpu_torch.ops.nn import init_model_params

    params = init_model_params(spec, torch.Generator().manual_seed(0))
    np.savez(tmp_path / "params.npz", **{f"{i}/{k}": v.numpy() for i, p in enumerate(params)
                                         for k, v in p.items()})
    scaler = {"min_": [0.0, -1.0], "scale_": [1.0, 0.5], "feature_range": [0, 1], "clip": False}
    (tmp_path / "model.json").write_text(json.dumps({
        "format": "gordo_tpu_torch/1", "estimator": "TransformerAutoEncoder",
        "kind": "transformer_model",
        "kwargs": {"lookback_window": 4, "batch_size": 32, "d_model": 8, "num_heads": 2,
                   "ff_dim": 8, "num_blocks": 1},
        "spec": spec_to_dict(spec), "input_scaler": scaler,
        "detector": {"scaler": scaler, "require_thresholds": True, "window": 6,
                     "smoothing_method": "smm", "feature_thresholds": [1.0, 2.0],
                     "aggregate_threshold": 0.5, "shuffle": False,
                     "aggregate_thresholds_per_fold_": {"fold-0": 0.4}},
        "history": {"loss": [1.0]}, "tags": ["a", "b"], "target_tags": ["a", "b"]}))
    (tmp_path / "metadata.json").write_text("{}")
    detector = serializer.load(str(tmp_path), device="cpu")
    assert type(detector) is diff.DiffBasedAnomalyDetector and detector.window == 6
    (_, scaler_step), (_, estimator) = detector.base_estimator.steps
    assert scaler_step.feature_range == (0, 1)
    np.testing.assert_array_equal(scaler_step.scale_, [1.0, 0.5])
    assert detector.aggregate_thresholds_per_fold_ == {"fold-0": 0.4}
    X = np.random.RandomState(2).rand(10, 2)
    assert detector.predict(X).shape == (7, 2)
    serializer.dump(detector, str(tmp_path / "again"), tags=["a", "b"])
    again = serializer.load(str(tmp_path / "again"), device="cpu")
    np.testing.assert_array_equal(again.predict(X), detector.predict(X))


# ------------------------------------------------------------- builds
@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The example's two feedforward machines built by the port on the
    CPU, as written, and written as artifacts."""
    root = tmp_path_factory.mktemp("built") / "1"
    out = []
    for model, machine in local_build(_example_machines(), project_name="proj", device="cpu"):
        serializer.dump(model, str(root / machine.name),
                        tags=[t.name for t in machine.dataset.tag_list],
                        metadata=machine.to_dict())
        out.append((model, machine))
    return root, out


def test_example_machines_build_with_the_port(built):
    _, results = built
    assert [m.name for _, m in results] == ["pump-station-a", "turbine-c"]
    (pump, pump_machine), (turbine, turbine_machine) = results
    assert type(pump) is diff.DiffBasedAnomalyDetector
    assert type(turbine) is diff.DiffBasedKFCVAnomalyDetector
    for model, machine in results:
        assert np.isfinite(model.feature_thresholds_).all()
        assert np.isfinite(model.aggregate_threshold_)
        assert machine.metadata.build_metadata.model.model_offset == 0
        estimator = model.base_estimator.steps[-1][1]
        epochs = 5 if machine.name == "pump-station-a" else 3
        assert len(estimator.history["loss"]) == epochs
    # the KFCV machine's folds are sklearn's KFold(5, shuffle=True, random_state=0)
    splits = turbine_machine.metadata.build_metadata.model.cross_validation.splits
    n_rows = 1008
    for fold, (train, test) in enumerate(
            SkKFold(5, shuffle=True, random_state=0).split(np.zeros(n_rows)), start=1):
        assert splits[f"fold-{fold}-n-train"] == len(train)
        assert splits[f"fold-{fold}-n-test"] == len(test)
    scores = turbine_machine.metadata.build_metadata.model.cross_validation.scores
    assert sorted(scores["explained-variance-score"]) == sorted(
        ["fold-mean", "fold-std", "fold-max", "fold-min"] + [f"fold-{k}" for k in range(1, 6)])


@pytest.mark.parametrize("route", ["prediction", "anomaly/prediction"])
def test_built_example_artifacts_answer_both_routes(built, route):
    root, results = built
    server, thread, url = _serve(root)
    try:
        for model, machine in results:
            tags = [t.name for t in machine.dataset.tag_list]
            status, body = _post(f"{url}/gordo/v0/proj/{machine.name}/{route}",
                                 _bench_payload(tags, seed=3))
            assert status == 200, body
            block = body["data"]["model-output"]
            assert sorted(block) == sorted(tags) and len(block[tags[0]]) == 100
            assert all(v is not None and np.isfinite(v) for col in block.values()
                       for v in col.values())
            again = serializer.load(str(root / machine.name), device="cpu")
            assert repr(again) == repr(model)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_chip_smokes_example_machines_are_the_yaml_ones():
    """chip_smoke.py carries examples/config.yaml's feedforward machines as
    JSON (the card's machine has no yaml): the same dicts."""
    import chip_smoke

    assert chip_smoke.EXAMPLE_MACHINES == _example_machines()["machines"]
