"""
A whole build from real sensor data, the port's against the JAX package's
on the CPU: a small Transformer machine (lookback 8, d_model 16, 2 heads,
ff 32, one block, one epoch) reading four tags' CSV files through
``ParquetFilesProvider(file_format="csv")`` (one tag's rows missing, which
interpolation fills; another's first rows empty, which dropna removes), a
``row_filter`` over two backticked tags, metrics by name and a
``TimeSeriesSplit`` with a gap and a test size, built by each package's
``ModelBuilder``. Each JAX fit's trained parameters are carried into the
port's same fit, so both predict with the same weights: the datasets,
split metadata and ``model_offset`` are equal, and the CV scores and the
thresholds, per fold and final, agree within TOL_REL (float32 models, sums
in another order, and CSV floats read by pandas' fast parser on one side).
"""

import copy
import json

import numpy as np
import pandas as pd
import pytest

from gordo_tpu.builder import ModelBuilder as JaxModelBuilder
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.models import models as jax_models
from gordo_tpu_torch import cli
from gordo_tpu_torch.builder import ModelBuilder
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.models import models
from gordo_tpu_torch.serializer.from_jax import params_from_numpy

TOL_REL = 1e-4
TOL_ABS = 1e-6
TAGS = ["TRA-1.PV", "TRA-2.PV", "tag-3", "tag-4"]
ESTIMATOR = {"kind": "transformer_model", "lookback_window": 8, "d_model": 16,
             "num_heads": 2, "ff_dim": 32, "num_blocks": 1, "epochs": 1}
METRICS = ["median_absolute_error", "mean_absolute_percentage_error", "r2_score",
           "sklearn.metrics.root_mean_squared_error", "max_error", "mean_pinball_loss"]


def _write(base):
    index = pd.date_range("2020-01-01", periods=600, freq="10min", name="time")
    t = np.arange(600)[:, None]
    rng = np.random.RandomState(0)
    values = np.sin(t / (7.0 + 3 * np.arange(4))) * 3 + 0.2 * rng.randn(600, 4) + 10
    for j, tag in enumerate(TAGS):
        frame = pd.DataFrame({"value": values[:, j]}, index=index)
        if j == 2:
            frame.iloc[:12, 0] = np.nan
        if j == 3:
            frame = frame.drop(frame.index[300:304])
        (base / "plant").mkdir(exist_ok=True)
        frame.to_csv(base / "plant" / f"{tag}.csv")


def _config(base) -> dict:
    return {
        "name": "from-files",
        "dataset": {"type": "TimeSeriesDataset", "asset": "plant", "tags": TAGS,
                    "train_start_date": "2020-01-01T00:00:00+00:00",
                    "train_end_date": "2020-01-05T04:00:00+00:00",
                    "data_provider": {"type": "ParquetFilesProvider", "base_path": str(base),
                                      "file_format": "csv"},
                    "row_filter": "`TRA-1.PV` > 8.5 | `TRA-2.PV` < 11"},
        "model": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {
            "window": 6,
            "base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
                "sklearn.preprocessing.MinMaxScaler",
                {"gordo_tpu.models.models.TransformerAutoEncoder": ESTIMATOR}]}}}},
        "evaluation": {"cv_mode": "full_build", "seed": 0, "metrics": METRICS,
                       "cv": {"sklearn.model_selection.TimeSeriesSplit": {
                           "n_splits": 3, "gap": 8, "test_size": 90}}},
    }


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    base = tmp_path_factory.mktemp("files")
    _write(base)
    config = _config(base)
    trained = []
    fit = jax_models.TransformerAutoEncoder.fit

    def recording_fit(estimator, X, y, **kwargs):
        out = fit(estimator, X, y, **kwargs)
        trained.append([{k: np.asarray(v) for k, v in layer.items()}
                        for layer in estimator.params_])
        return out

    def carried_fit(estimator, X, y, **kwargs):
        spec = estimator.build_spec(np.shape(X)[1], np.shape(y)[1])
        estimator.load_params(spec, params_from_numpy(spec, trained[carried_fit.fits]), "cpu")
        carried_fit.fits += 1
        return estimator

    carried_fit.fits = 0
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_models.TransformerAutoEncoder, "fit", recording_fit)
        jax_model, jax_machine = JaxModelBuilder(JaxMachine.from_config(
            copy.deepcopy(config), "proj")).build()
        mp.setattr(models.TransformerAutoEncoder, "fit", carried_fit)
        model, machine = ModelBuilder(Machine.from_config(copy.deepcopy(config), "proj"),
                                      device="cpu").build()
    finally:
        mp.undo()
    assert len(trained) == carried_fit.fits == 4  # three folds and the final fit
    return config, model, machine, jax_model, jax_machine


def test_the_datasets_splits_and_offsets_are_equal(builds):
    _, _, machine, _, jax_machine = builds
    ours = machine.metadata.build_metadata.to_dict()
    theirs = jax_machine.metadata.build_metadata.to_dict()
    assert ours["model"]["model_offset"] == theirs["model"]["model_offset"] == 7
    splits = theirs["model"]["cross_validation"]["splits"]
    assert ours["model"]["cross_validation"]["splits"] == {
        k: v if isinstance(v, int) else str(v) for k, v in splits.items()}
    assert splits["fold-1-n-test"] == 90
    rows = ours["dataset"]["dataset_meta"]["dataset_meta"]["row_count"]
    assert rows == theirs["dataset"]["dataset_meta"]["dataset_meta"]["row_count"]
    assert 300 < rows < 588  # the NaN rows and the filter dropped some


def test_the_cv_scores_agree(builds):
    _, _, machine, _, jax_machine = builds
    ours = machine.metadata.build_metadata.model.cross_validation.scores
    theirs = jax_machine.metadata.build_metadata.model.cross_validation.scores
    assert sorted(ours) == sorted(theirs)
    assert len(ours) == len(METRICS) * (len(TAGS) + 1)
    for name, record in theirs.items():
        for key, value in record.items():
            if np.isnan(value):  # max_error of several outputs: NaN in both
                assert np.isnan(ours[name][key]), (name, key)
                continue
            np.testing.assert_allclose(ours[name][key], value, rtol=TOL_REL, atol=TOL_ABS,
                                       err_msg=f"{name} {key}")
    assert np.isnan(ours["max-error"]["fold-1"])


def test_the_thresholds_agree(builds):
    _, model, _, jax_model, _ = builds
    ours, theirs = model.get_metadata(), jax_model.get_metadata()
    for key in ("feature-thresholds", "aggregate-threshold", "smooth-feature-thresholds",
                "smooth-aggregate-threshold"):
        np.testing.assert_allclose(np.asarray(ours[key], np.float64),
                                   np.asarray(theirs[key], np.float64),
                                   rtol=TOL_REL, atol=TOL_ABS, err_msg=key)
    for fold, value in theirs["aggregate-thresholds-per-fold"].items():
        np.testing.assert_allclose(ours["aggregate-thresholds-per-fold"][fold], value,
                                   rtol=TOL_REL, atol=TOL_ABS)


def test_the_cli_builds_it_with_every_option(builds, tmp_path):
    config = builds[0]
    code = cli.main(["build", json.dumps(config), str(tmp_path / "out"), "--device", "cpu",
                     "--exceptions-reporter-file", str(tmp_path / "report.json")])
    assert code == 0 and not (tmp_path / "report.json").exists()
    assert (tmp_path / "out" / "params.npz").exists()
