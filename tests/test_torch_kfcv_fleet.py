"""
The fleet trainer's KFCV plans against the JAX package's on the CPU: the
planner's decisions for ``DiffBasedKFCVAnomalyDetector`` machines, the
seeded-KFold fold geometry (the per-stage row permutations and the padded
bounds), the thresholds from fold predictions against the JAX
``_set_kfcv_thresholds`` (float64, 1e-9), a KFCV hourglass bucket through
``run_bucket`` on the JAX program's draws and permutations (1e-5), and a
KFCV machine built by the fleet against the serial builder (split metadata
equal, thresholds of one order).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.models.anomaly import diff as jax_diff
from gordo_tpu.parallel import batch_trainer as jax_bt
from gordo_tpu_torch.models.anomaly import diff
from gordo_tpu_torch.parallel import batch_trainer as bt
from gordo_tpu_torch.serializer.from_jax import spec_from_dataclass
from test_torch_feedforward import ff_config
from test_torch_fleet import _fleet_data, _machines, jax_draws, machine_config

TOL_BUCKET = dict(rtol=1e-5, atol=1e-5)  # float32 programs, summed in other orders
TOL_THRESHOLD = 1e-9  # the same float64 math on the same predictions
SEEDED_KFOLD = {"sklearn.model_selection.KFold": {"n_splits": 5, "shuffle": True,
                                                  "random_state": 0}}


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def kfcv_config(name, cv=SEEDED_KFOLD, **kwargs):
    """A small KFCV hourglass machine (288 rows, 4 tags) under ``cv``."""
    evaluation = {"cv_mode": "full_build", "seed": 0,
                  "scoring_scaler": "sklearn.preprocessing.MinMaxScaler"}
    if cv is not None:
        evaluation["cv"] = cv
    return ff_config(name, detector="DiffBasedKFCVAnomalyDetector", window=12,
                     evaluation=evaluation, **kwargs)


class _PortSubclass(diff.DiffBasedKFCVAnomalyDetector):
    pass


class _JaxSubclass(jax_diff.DiffBasedKFCVAnomalyDetector):
    pass


def _as_subclass(module, subclass, monkeypatch):
    """Make ``module``'s planner read every KFCV detector as ``subclass``."""
    original = module.serializer.from_definition

    def from_definition(definition, *args, **kwargs):
        made = original(definition, *args, **kwargs)
        if type(made).__name__ == "DiffBasedKFCVAnomalyDetector":
            return subclass(**made.get_params())
        return made

    monkeypatch.setattr(module.serializer, "from_definition", from_definition)


PLAN_CASES = {
    "seeded KFold": (kfcv_config("m"), ("kfold", 5, True, 0)),
    "unseeded shuffled KFold": (kfcv_config("m", cv={"sklearn.model_selection.KFold": {
        "n_splits": 5, "shuffle": True}}), None),
    "unshuffled KFold": (kfcv_config("m", cv={"sklearn.model_selection.KFold": {
        "n_splits": 4}}), ("kfold", 4, False, None)),
    "default TimeSeriesSplit": (kfcv_config("m", cv=None), ("tss", 3)),
    "KFold outside KFCV": (ff_config("m", evaluation={"cv": SEEDED_KFOLD}), None),
    "windowed KFCV": (dict(machine_config("m"), model={
        "gordo_tpu.models.anomaly.diff.DiffBasedKFCVAnomalyDetector": dict(
            machine_config("m")["model"]["gordo_tpu.models.anomaly.diff."
                                         "DiffBasedAnomalyDetector"])}), None),
    "another subclass": (kfcv_config("m"), None),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_kfcv_plans_match_jax(case, monkeypatch):
    config, cv = PLAN_CASES[case]
    if case == "another subclass":
        _as_subclass(bt, _PortSubclass, monkeypatch)
        _as_subclass(jax_bt, _JaxSubclass, monkeypatch)
    ours, theirs = _machines([config])
    plan, jax_plan = bt._plan_machine(ours[0]), jax_bt._plan_machine(theirs[0])
    assert (plan is None) == (jax_plan is None) == (cv is None)
    if plan is None:
        return
    assert plan.cv == jax_plan.cv == cv
    assert plan.kfcv and jax_plan.kfcv
    assert plan.anomaly_kwargs == jax_plan.anomaly_kwargs
    assert plan.anomaly_kwargs["threshold_percentile"] == 0.99
    assert plan.spec == spec_from_dataclass(jax_plan.spec)
    for key in ("scale_x", "wrap_anomaly", "epochs", "batch_size", "shuffle", "n_splits"):
        assert getattr(plan, key) == getattr(jax_plan, key), key


def test_kfcv_and_plain_detectors_share_a_tss_bucket_and_not_a_kfold_one():
    plans = [bt._plan_machine(m) for m in _machines([
        ff_config("plain"), kfcv_config("tss", cv=None), kfcv_config("kfold")])[0]]
    for plan in plans:
        plan.X = np.zeros((288, 4))
    keys = [plan.bucket_key() for plan in plans]
    assert keys[0] == keys[1] != keys[2]
    assert [plan.kfcv for plan in plans] == [False, True, True]


def _jax_kfold_geometry(n_rows, n_splits, seed):
    """The JAX builder's seeded-KFold geometry (``_build_bucket``), written
    out on sklearn's KFold as it is there."""
    from sklearn.model_selection import KFold

    folds = list(KFold(n_splits=n_splits, shuffle=True, random_state=seed)
                 .split(np.zeros((n_rows, 1))))
    te_max = max(len(te) for _, te in folds)
    bounds = tuple((len(tr), n_rows - te_max, n_rows) for tr, _ in folds)
    perms = np.stack([np.concatenate([tr, te]) for tr, te in folds]
                     + [np.arange(n_rows)]).astype(np.int32)
    return folds, bounds, perms


@pytest.mark.parametrize("n_rows, n_splits, seed", [(302, 5, 0), (288, 5, 0), (1008, 5, 0),
                                                    (100, 3, 7)])
def test_kfold_geometry_is_jax_index_for_index(n_rows, n_splits, seed):
    folds, bounds, perms = _jax_kfold_geometry(n_rows, n_splits, seed)
    our_bounds, our_rows, our_perms = bt.fold_geometry(("kfold", n_splits, True, seed), n_rows)
    assert our_bounds == bounds
    np.testing.assert_array_equal(our_perms, perms)
    for (train, test), (jax_train, jax_test) in zip(our_rows, folds):
        np.testing.assert_array_equal(train, jax_train)
        np.testing.assert_array_equal(test, jax_test)
    assert sorted(np.concatenate([test for _, test in our_rows]).tolist()) == list(range(n_rows))


def test_tss_geometry_is_the_contiguous_folds():
    bounds, rows, perms = bt.fold_geometry(("tss", 3), 288)
    assert perms is None and bounds == bt._fold_bounds(288, 3)
    for (train, test), (train_end, test_start, test_end) in zip(rows, bounds):
        assert train.tolist() == list(range(train_end))
        assert test.tolist() == list(range(test_start, test_end))


def _fold_predictions(X, y, folds, longest):
    """Each fold's least-squares predictions of its test rows, a padded
    fold's tail led by rows of 1e6 that the assembly must drop."""
    preds = []
    for train, test in folds:
        A = np.c_[X[train], np.ones(len(train))]
        coef = np.linalg.lstsq(A, y[train], rcond=None)[0]
        pred = np.c_[X[test], np.ones(len(test))] @ coef
        pad = longest - len(test)
        preds.append(np.vstack([np.full((pad, y.shape[1]), 1e6), pred]) if pad else pred)
    return preds


@pytest.mark.parametrize("geometry", ["kfold", "tss"])
def test_kfcv_thresholds_match_jax(geometry):
    """302 rows (KFold(5): folds of 61, 61, 60, 60 and 60, padded to 61) or
    TimeSeriesSplit(3): the same fold predictions through the port's
    ``_set_kfcv_thresholds`` and the JAX builder's, called with
    ``self=None`` as ``test_kfold_kfcv_threshold_math_matches_serial`` calls
    it; the port's are also the serial detector's own math."""
    rng = np.random.RandomState(11)
    n_rows = 302
    X = rng.rand(n_rows, 4)
    y = X @ rng.rand(4, 4) + 0.01 * rng.rand(n_rows, 4)
    cv = ("kfold", 5, True, 0) if geometry == "kfold" else ("tss", 3)
    bounds, rows, _ = bt.fold_geometry(cv, n_rows)
    longest = max(len(test) for _, test in rows)
    preds = _fold_predictions(X, y, rows, longest)
    if geometry == "kfold":
        assert [len(test) for _, test in rows] == [61, 61, 60, 60, 60]
    ours = diff.DiffBasedKFCVAnomalyDetector(base_estimator=None, window=24, shuffle=False)
    bt._set_kfcv_thresholds(ours, y, preds, rows)
    theirs = jax_diff.DiffBasedKFCVAnomalyDetector(base_estimator=None, window=24, shuffle=False)
    jax_bt.BatchedModelBuilder._set_kfcv_thresholds(
        None, theirs, SimpleNamespace(y=y), preds, bounds,
        [tuple(fold) for fold in rows] if geometry == "kfold" else None)
    np.testing.assert_allclose(ours.aggregate_threshold_, theirs.aggregate_threshold_,
                               rtol=TOL_THRESHOLD)
    np.testing.assert_allclose(np.asarray(ours.feature_thresholds_),
                               np.asarray(theirs.feature_thresholds_), rtol=TOL_THRESHOLD)
    serial = diff.DiffBasedKFCVAnomalyDetector(base_estimator=None, window=24, shuffle=False)
    serial.set_fold_thresholds(y, [
        (test, pred[len(pred) - len(test):], diff.MinMaxScaler().fit(y[train]))
        for (train, test), pred in zip(rows, preds)])
    assert serial.aggregate_threshold_ == ours.aggregate_threshold_
    np.testing.assert_array_equal(serial.feature_thresholds_, ours.feature_thresholds_)


def test_kfcv_bucket_program_matches_jax():
    """Three KFCV hourglass machines under the seeded KFold(5) through the
    JAX bucket program (``use_perms``) and the port's ``run_bucket`` on the
    JAX program's draws and permutations: losses, every fold's padded test
    tail and the parameters."""
    from gordo_tpu.parallel.batch_trainer import _bucket_program

    jax_plan = jax_bt._plan_machine(JaxMachine.from_config(kfcv_config("m"), "p"))
    spec = spec_from_dataclass(jax_plan.spec)
    X = _fleet_data(3)
    n_rows = len(X[0])
    seeds = [jax_bt._machine_seed(JaxMachine.from_config(kfcv_config(f"m-{m}"), "p"))
             for m in range(3)]
    _, bounds, perms = _jax_kfold_geometry(n_rows, 5, 0)
    program = _bucket_program(jax_plan.spec, n_rows, bounds, jax_plan.epochs,
                              jax_plan.batch_size, True, True, use_perms=True)
    jax_params, jax_losses, jax_preds = program(
        jnp.asarray(X), jnp.asarray(X), jnp.asarray(np.array(seeds, np.uint32)),
        jnp.asarray(perms))
    our_bounds, _, our_perms = bt.fold_geometry(jax_plan.cv, n_rows)
    stages = bt.stages_of(spec, n_rows, our_bounds, jax_plan.batch_size)
    assert [s.test_len for s in stages] == [58] * 5 + [0]
    inits, orders = jax_draws(jax_plan.spec)(seeds, spec, stages, jax_plan.epochs, True)
    model, losses, preds = bt.run_bucket(spec, X, X, stages, jax_plan.epochs, True, inits,
                                         orders, torch.device("cpu"), our_perms)
    np.testing.assert_allclose(losses, np.asarray(jax_losses), **TOL_BUCKET)
    for ours, theirs in zip(preds, jax_preds):
        assert ours.shape == theirs.shape == (3, 58, 4)
        np.testing.assert_allclose(ours, np.asarray(theirs), **TOL_BUCKET)
    for m in range(3):
        for mine, layer in zip(model.machine_params(m), jax_params):
            for name, value in layer.items():
                np.testing.assert_allclose(mine[name], np.asarray(value)[m], **TOL_BUCKET)


@pytest.mark.parametrize("cv", [SEEDED_KFOLD, None], ids=["seeded KFold", "TimeSeriesSplit"])
def test_kfcv_fleet_build_against_the_serial_builder(cv):
    """A KFCV machine built by the fleet (no serial fallback) and by the
    serial ``ModelBuilder``: the split metadata equal key for key, the
    detector a KFCV one, the thresholds finite and within 1/3 to 3 times
    the serial build's (independent trainings), as the JAX package's own
    test holds its batched build to its serial one; the fold scores have
    the serial builder's names."""
    from gordo_tpu_torch.builder import ModelBuilder
    from gordo_tpu_torch.machine import Machine

    config = kfcv_config("kfcv-e2e", cv=cv)
    np.random.seed(0)
    builder = bt.BatchedModelBuilder([Machine.from_config(config, "p")], serial_fallback=False,
                                     device="cpu")
    [(model, machine)] = builder.build()
    assert not builder.serial_built and not builder.quarantine_records
    serial_model, serial_machine = ModelBuilder(Machine.from_config(config, "p"),
                                                device="cpu").build()
    assert isinstance(model, diff.DiffBasedKFCVAnomalyDetector)
    built = machine.metadata.build_metadata.model.cross_validation
    serial = serial_machine.metadata.build_metadata.model.cross_validation
    assert built.splits == serial.splits
    assert sorted(built.scores) == sorted(serial.scores)
    n_folds = 5 if cv else 3
    assert f"fold-{n_folds}-n-test" in built.splits
    ratio = model.aggregate_threshold_ / serial_model.aggregate_threshold_
    assert 1 / 3 < ratio < 3, ratio
    feature_ratio = np.asarray(model.feature_thresholds_) / np.asarray(
        serial_model.feature_thresholds_)
    assert np.all((feature_ratio > 1 / 3) & (feature_ratio < 3)), feature_ratio
    assert model.get_metadata().keys() == serial_model.get_metadata().keys()
