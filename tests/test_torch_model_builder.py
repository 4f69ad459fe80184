"""
The port's build path (gordo_tpu_torch/builder, cli.py) against the JAX
package's on the CPU, at a small width (lookback 16, d_model 16, 2 heads,
ff 32, 1 block, 4 tags, 2 days of 10-minute rows, one epoch):

- for the same machine config, both builders fetch bit-identical X and y
  and record equal splits, model offsets and score keys, and the same key
  structure throughout ``build_metadata``;
- on a detector carried across with ``serializer/from_jax.py``, the port's
  scorers equal the JAX scorers (rtol 1e-5: float32 models);
- a cache hit trains nothing and is not saved onto itself; two builds
  with the same seed give identical parameters;
- ``python -m gordo_tpu_torch build`` exits 0 and prints the CV scores, and
  each exit code of its table is reached.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gordo_tpu.builder import ModelBuilder as JaxModelBuilder
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu_torch import cli
from gordo_tpu_torch.builder import ModelBuilder, local_build
from gordo_tpu_torch.builder.build_model import NonFiniteDataError
from gordo_tpu_torch.dataset import InsufficientDataError
from gordo_tpu_torch.dataset.sensor_tag import SensorTagNormalizationError
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.models import models as port_models
from gordo_tpu_torch.serializer.from_jax import detector_from_arrays, spec_from_dataclass

TOL_SCORE_REL = 1e-5  # float32 models on both sides, sums in another order
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAGS = [f"tag-{i}" for i in range(4)]
ESTIMATOR = {"kind": "transformer_model", "lookback_window": 16, "d_model": 16,
             "num_heads": 2, "ff_dim": 32, "num_blocks": 1, "epochs": 1}
CONFIG = {
    "name": "small-machine",
    "dataset": {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00+00:00",
                "train_end_date": "2020-01-03T00:00:00+00:00", "tags": TAGS,
                "resolution": "10min"},
    "model": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {
        "base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler",
            {"gordo_tpu.models.models.TransformerAutoEncoder": ESTIMATOR}]}}}},
    "evaluation": {"cv_mode": "full_build", "seed": 0},
}


@pytest.fixture(scope="module")
def builds():
    """(port builder, port model, port machine, JAX builder, JAX model,
    JAX machine) of CONFIG."""
    ours = ModelBuilder(Machine.from_config(CONFIG, "proj"), device="cpu")
    model, machine = ours.build()
    theirs = JaxModelBuilder(JaxMachine.from_config(CONFIG, "proj"))
    jax_model, jax_machine = theirs.build()
    return ours, model, machine, theirs, jax_model, jax_machine


def _keys(tree, path=""):
    if not isinstance(tree, dict):
        return set()
    return {f"{path}/{k}" for k in tree} | {
        key for k, v in tree.items() for key in _keys(v, f"{path}/{k}")}


def test_builders_fetch_bit_identical_data(builds):
    ours, _, _, theirs, _, _ = builds
    _, X, y, _, _ = ours._fetch_data()
    _, jX, jy, _, _ = theirs._fetch_data()
    for frame, expected in ((X, jX), (y, jy)):
        np.testing.assert_array_equal(frame.values, expected.to_numpy())
        assert frame.columns == list(expected.columns)
        np.testing.assert_array_equal(frame.index.view(np.int64), expected.index.as_unit("ns").asi8)


def test_build_metadata_matches_jax(builds):
    _, model, machine, _, jax_model, jax_machine = builds
    ours = machine.metadata.build_metadata.to_dict()
    theirs = jax_machine.metadata.build_metadata.to_dict()
    assert _keys(ours) == _keys(theirs)
    assert ours["model"]["model_offset"] == theirs["model"]["model_offset"] == 15
    splits = theirs["model"]["cross_validation"]["splits"]
    assert ours["model"]["cross_validation"]["splits"] == {k: v if isinstance(v, int) else str(v)
                                                           for k, v in splits.items()}
    scores = ours["model"]["cross_validation"]["scores"]
    assert len(scores) == 4 * (len(TAGS) + 1)
    assert all(np.isfinite(v) for s in scores.values() for v in s.values())
    dataset, jax_dataset = ours["dataset"]["dataset_meta"], theirs["dataset"]["dataset_meta"]
    for meta in (dataset, jax_dataset):
        meta.pop("query_duration_sec")
    assert dataset == jax_dataset
    assert sorted(ours["phases"]) == ["cross_validation", "fetch", "fit", "validate"]
    assert machine.model == jax_machine.model and machine.name == jax_machine.name
    assert ModelBuilder.calculate_cache_key(machine) == JaxModelBuilder.calculate_cache_key(
        jax_machine)


@pytest.mark.parametrize("scaler", [None, "sklearn.preprocessing.MinMaxScaler"])
def test_scorers_match_jax_on_a_carried_detector(builds, scaler):
    ours, _, _, theirs, jax_model, _ = builds
    _, X, y, _, _ = ours._fetch_data()
    _, jX, jy, _, _ = theirs._fetch_data()
    (_, in_scaler), (_, estimator) = jax_model.base_estimator.steps
    detector = detector_from_arrays(
        spec_from_dataclass(estimator.spec_),
        [{k: np.asarray(v) for k, v in p.items()} for p in estimator.params_],
        in_scaler.min_, in_scaler.scale_, jax_model.scaler.min_, jax_model.scaler.scale_,
        estimator_kwargs=estimator.kwargs, device="cpu")
    metrics = ModelBuilder.metrics_from_list(None)
    our_scorers = ModelBuilder.build_metrics_dict(metrics, y, scaler=scaler)
    their_scorers = JaxModelBuilder.build_metrics_dict(
        JaxModelBuilder.metrics_from_list(None), jy, scaler=scaler)
    assert list(our_scorers) == list(their_scorers)
    test = slice(216, 288)  # the last fold's test span
    pred = detector.predict(X.values[test])
    for name, scorer in our_scorers.items():
        np.testing.assert_allclose(
            scorer(y.values[test], pred),
            their_scorers[name](jax_model, jX.iloc[test], jy.iloc[test]),
            rtol=TOL_SCORE_REL, atol=1e-7, err_msg=name)


def _params(model):
    return model.base_estimator.steps[-1][1].module_.state_dict()


def test_same_seed_builds_identical_parameters(builds):
    _, model, _, _, _, _ = builds
    again, _ = ModelBuilder(Machine.from_config(CONFIG, "proj"), device="cpu").build()
    for (name, a), b in zip(_params(model).items(), _params(again).values()):
        assert torch.equal(a, b), name


def test_cache_hit_trains_nothing_and_is_not_resaved(tmp_path, monkeypatch):
    output, register = tmp_path / "model", tmp_path / "register"
    builder = ModelBuilder(Machine.from_config(CONFIG, "proj"), device="cpu")
    model, _ = builder.build(output, register)
    written = {p.name: p.stat().st_mtime_ns for p in output.iterdir()}

    def no_training(*args, **kwargs):
        raise AssertionError("a cache hit trained")

    monkeypatch.setattr(port_models, "fit_arrays", no_training)
    cached, machine = ModelBuilder(Machine.from_config(CONFIG, "proj"), "cpu").build(
        output, register)
    assert machine.metadata.user_defined["build-metadata"] == {"from_cache": True}
    assert {p.name: p.stat().st_mtime_ns for p in output.iterdir()} == written
    for a, b in zip(_params(model).values(), _params(cached).values()):
        assert torch.equal(a, b)
    # a hit to another directory is saved there, still without training
    ModelBuilder(Machine.from_config(CONFIG, "proj"), "cpu").build(tmp_path / "copy", register)
    assert (tmp_path / "copy" / "params.npz").exists()


def test_local_build_takes_a_json_project_config():
    config = {"machines": [{"name": "m-1", "dataset": CONFIG["dataset"]}],
              "globals": {"model": CONFIG["model"], "evaluation": {"metrics": ["r2_score"]}}}
    (model, machine), = local_build(json.dumps(config), device="cpu")
    scores = machine.metadata.build_metadata.model.cross_validation.scores
    assert sorted(scores) == sorted(["r2-score", *(f"r2-score-{t}" for t in TAGS)])
    assert np.isfinite(model.aggregate_threshold_)


def test_cli_build_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO, "MACHINE": json.dumps(CONFIG),
           "OUTPUT_DIR": str(tmp_path / "out")}
    result = subprocess.run(
        [sys.executable, "-m", "gordo_tpu_torch", "build", "--device", "cpu",
         "--model-register-dir", str(tmp_path / "register"), "--print-cv-scores"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stderr
    lines = result.stdout.splitlines()
    assert len(lines) == 4 * (len(TAGS) + 1) * 7  # mean, std, max, min and 3 folds
    assert lines[0].startswith("explained-variance-score-tag-0_fold-mean=")
    with open(tmp_path / "out" / "metadata.json") as f:
        metadata = json.load(f)
    model = metadata["metadata"]["build_metadata"]["model"]
    assert model["model_offset"] == 15 and model["model_meta"]["aggregate-threshold"] > 0
    # the definition is recorded with every default, as the JAX CLI records it
    steps = metadata["model"]["gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector"][
        "base_estimator"]["sklearn.pipeline.Pipeline"]["steps"]
    assert steps[0] == {"sklearn.preprocessing._data.MinMaxScaler": {
        "clip": False, "copy": True, "feature_range": [0, 1]}}


@pytest.mark.parametrize("error, code", [
    (RuntimeError("x"), 1), (PermissionError("x"), 20), (FileNotFoundError("x"), 30),
    (SensorTagNormalizationError("x"), 60), (InsufficientDataError("x"), 80),
    (NonFiniteDataError("x"), 83),
])
def test_cli_exit_codes(error, code, monkeypatch, tmp_path):
    def failing_build(self, *args, **kwargs):
        raise error

    monkeypatch.setattr(ModelBuilder, "build", failing_build)
    assert cli.main(["build", json.dumps(CONFIG), str(tmp_path), "--device", "cpu"]) == code


@pytest.mark.parametrize("change, code", [
    ({"dataset": {**CONFIG["dataset"], "n_samples_threshold": 10_000}}, 80),
    ({"dataset": {**CONFIG["dataset"], "tags": [{"asset": "a"}]}}, 60),
    ({"model": "{{ a jinja template }}"}, 1),
])
def test_cli_exit_codes_of_real_failures(change, code, tmp_path):
    argv = ["build", json.dumps({**CONFIG, **change}), str(tmp_path / "out"), "--device", "cpu"]
    assert cli.main(argv) == code


def test_build_refuses_non_finite_data(monkeypatch):
    builder = ModelBuilder(Machine.from_config(CONFIG, "proj"), device="cpu")
    fetch = builder._fetch_data

    def poisoned():
        dataset, X, y, seconds, attempts = fetch()
        X.values[3, 1] = np.nan
        return dataset, X, y, seconds, attempts

    monkeypatch.setattr(builder, "_fetch_data", poisoned)
    with pytest.raises(NonFiniteDataError, match="1 non-finite values in X"):
        builder.build()
