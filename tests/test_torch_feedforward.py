"""
The feedforward autoencoder family of the port against the JAX package on
the CPU: the hourglass dimension math and each factory's spec, the
``AutoEncoder`` and ``RawModelRegressor`` predicts on the same parameters
(initialised by the JAX package and carried across as numpy), the l1
activity penalty's loss and gradients on a padded, part-weighted batch and
one epoch in a fixed order, a stacked masked epoch of two machines against
each machine's serial epoch, and the estimators' contract (repr, metadata,
refusals).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.models import models as jax_models
from gordo_tpu.models.factories import feedforward_autoencoder as jax_ff
from gordo_tpu.models.factories.utils import hourglass_calc_dims as jax_dims
from gordo_tpu.ops import nn as jax_nn, train as jax_train
from gordo_tpu_torch.models import models
from gordo_tpu_torch.models.base import clone
from gordo_tpu_torch.models.factories import feedforward_autoencoder as ff
from gordo_tpu_torch.models.factories.utils import check_dim_func_len, hourglass_calc_dims
from gordo_tpu_torch.models.spec import spec_to_dict
from gordo_tpu_torch.ops import nn, train
from gordo_tpu_torch.serializer.from_jax import estimator_from_arrays, spec_from_dataclass

TOL = dict(rtol=1e-5, atol=1e-6)  # float32 on both sides, summed in other orders
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)  # the JAX package's bf16 tolerance


@pytest.fixture(autouse=True)
def one_thread():
    """torch's CPU kernels on one thread: the 1e-5 parity gates stay off the
    loaded machine's thread-pool rounding."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DIMS_CASES = [(0.5, 3, 10, (8, 7, 5)), (0.2, 3, 10, (7, 5, 2)), (0.5, 1, 10, (5,)),
              (0.5, 3, 5, (4, 4, 3)), (0.5, 3, 4, (3, 3, 2)), (1.0, 2, 4, (4, 4)),
              (0.0, 3, 4, (3, 2, 1)), (0.3, 4, 64, (53, 42, 31, 20))]


@pytest.mark.parametrize("factor, layers, n, expected", DIMS_CASES)
def test_hourglass_calc_dims_matches_jax(factor, layers, n, expected):
    assert hourglass_calc_dims(factor, layers, n) == jax_dims(factor, layers, n) == expected


@pytest.mark.parametrize("factor, layers", [(1.5, 3), (-0.1, 3), (0.5, 0)])
def test_hourglass_calc_dims_refuses_like_jax(factor, layers):
    with pytest.raises(ValueError) as ours:
        hourglass_calc_dims(factor, layers, 10)
    with pytest.raises(ValueError) as theirs:
        jax_dims(factor, layers, 10)
    assert str(ours.value) == str(theirs.value)


def test_check_dim_func_len_refuses_like_jax():
    from gordo_tpu.models.factories.utils import check_dim_func_len as jax_check

    with pytest.raises(ValueError) as ours:
        check_dim_func_len("encoding", (4, 3), ("tanh",))
    with pytest.raises(ValueError) as theirs:
        jax_check("encoding", (4, 3), ("tanh",))
    assert str(ours.value) == str(theirs.value)


FACTORY_CASES = [
    ("feedforward_hourglass", dict(n_features=10)),
    ("feedforward_hourglass", dict(n_features=4, compression_factor=0.2, func="relu")),
    ("feedforward_hourglass", dict(n_features=10, encoding_layers=1, n_features_out=3)),
    ("feedforward_symmetric", dict(n_features=6, dims=(5, 3), funcs=("tanh", "relu"))),
    ("feedforward_model", dict(n_features=4)),
    ("feedforward_model", dict(n_features=4, encoding_dim=(8, 2), encoding_func=("tanh", "elu"),
                               decoding_dim=(2, 8), decoding_func=("linear", "tanh"),
                               out_func="sigmoid", optimizer="SGD",
                               optimizer_kwargs={"learning_rate": 0.1},
                               compile_kwargs={"loss": "mae"})),
]


@pytest.mark.parametrize("kind, kwargs", FACTORY_CASES)
def test_factory_spec_equals_jax(kind, kwargs):
    ours, theirs = getattr(ff, kind)(**kwargs), getattr(jax_ff, kind)(**kwargs)
    assert spec_to_dict(ours) == spec_to_dict(theirs)
    l1 = [layer.l1_activity for layer in ours.layers]
    n_encoding = len(kwargs.get("dims") or kwargs.get("encoding_dim") or [0] * (
        kwargs.get("encoding_layers", 3)))
    assert l1 == [0.0] + [ff._L1_ACTIVITY] * (n_encoding - 1) + [0.0] * (len(l1) - n_encoding)


def test_factories_are_filed_under_their_estimators():
    assert sorted(models.FACTORIES["AutoEncoder"]) == sorted(
        jax_models.register_model_builder.factories["AutoEncoder"])
    with pytest.raises(ValueError, match="not an available model for type: AutoEncoder"):
        models.AutoEncoder("transformer_model")
    with pytest.raises(ValueError, match="type: TransformerAutoEncoder"):
        models.TransformerAutoEncoder("feedforward_hourglass")


def _jax_params(spec, seed: int):
    return [{k: np.asarray(v) for k, v in p.items()}
            for p in jax_nn.init_model_params(jax.random.PRNGKey(seed), spec)]


def _pair(estimator: str, kind, n_features: int, seed: int = 0, **kwargs):
    """(port estimator, JAX estimator) on the same JAX-initialised params."""
    theirs = getattr(jax_models, estimator)(kind=kind, **kwargs)
    spec = theirs.build_spec(n_features, n_features)
    theirs.spec_, theirs.params_ = spec, _jax_params(spec, seed)
    ours = estimator_from_arrays(spec_from_dataclass(spec), theirs.params_, estimator, kind,
                                 kwargs, device="cpu")
    return ours, theirs


RAW_KIND = {"spec": {"layers": [{"Dense": {"units": 6, "activation": "tanh"}},
                                {"keras.layers.Dense": {"units": 3, "activation": "relu"}},
                                {"Dense": {"units": 4}}]},
            "compile": {"loss": "mse", "optimizer": "adam"}}
PREDICT_CASES = [
    ("AutoEncoder", "feedforward_hourglass", {}, TOL),
    ("AutoEncoder", "feedforward_symmetric", {"dims": (16, 8), "funcs": ("relu", "tanh")}, TOL),
    ("AutoEncoder", "feedforward_model", {"out_func": "sigmoid"}, TOL),
    ("AutoEncoder", "feedforward_hourglass", {"compute_dtype": "bfloat16"}, TOL_BF16),
    ("RawModelRegressor", RAW_KIND, {}, TOL),
]


@pytest.mark.parametrize("estimator, kind, kwargs, tol", PREDICT_CASES)
def test_predict_matches_jax(estimator, kind, kwargs, tol):
    ours, theirs = _pair(estimator, kind, 4, **kwargs)
    X = np.random.RandomState(1).rand(37, 4).astype(np.float32)
    got, want = ours.predict(X), np.asarray(theirs.predict(X))
    assert got.shape == want.shape == (37, 4)
    np.testing.assert_allclose(got, want, **tol)
    assert ours.output_offset == theirs.output_offset == 0
    assert ours.score(X, X) == pytest.approx(theirs.score(X, X), rel=1e-4, abs=1e-5)


def _padded_batch(seed: int = 2, n_live: int = 11, batch: int = 16):
    """A batch of ``n_live`` samples padded to ``batch`` with zero-weighted
    repeats of sample 0, as an epoch's last step is."""
    rng = np.random.RandomState(seed)
    X = rng.rand(40, 4).astype(np.float32)
    idx = np.zeros(batch, np.int64)
    idx[:n_live] = rng.permutation(40)[:n_live]
    wb = np.zeros(batch, np.float32)
    wb[:n_live] = 1.0
    return X, idx, wb


def test_l1_penalty_loss_and_gradients_match_jax_value_and_grad():
    jax_spec = jax_ff.feedforward_hourglass(4)
    spec = spec_from_dataclass(jax_spec)
    params = _jax_params(jax_spec, 3)
    X, idx, wb = _padded_batch()
    loss, grads = jax.value_and_grad(jax_train._loss_terms, argnums=1)(
        jax_spec, params, jnp.asarray(X[idx]), jnp.asarray(X[idx]), jnp.asarray(wb))
    model = nn.TransformerModel(spec, params, torch.device("cpu"))
    xb = torch.from_numpy(X[idx])
    ours = train._loss_terms(spec, model, xb, xb, torch.from_numpy(wb))
    ours.backward()
    assert float(ours) == pytest.approx(float(loss), rel=1e-5)
    # the penalty is a real share of the loss: the gate would catch it left
    # out, or divided by the live samples instead of the batch
    _, penalty = model.forward_with_penalty(xb)
    assert float(penalty) > 10 * 1e-5 * float(loss)
    assert float(penalty) * 16 / 11 - float(penalty) > 1e-5 * float(loss)
    for p_ours, p_jax in zip(model.layer_params, grads):
        for name in p_jax:
            np.testing.assert_allclose(p_ours[name].grad.numpy(), np.asarray(p_jax[name]),
                                       rtol=1e-5, atol=1e-5 * float(np.abs(p_jax[name]).max()))


@pytest.mark.parametrize("shuffle", [False, True])
def test_one_epoch_with_the_penalty_matches_jax(shuffle):
    """One epoch of 100 samples at batch 32 (the last step 4 live samples
    and 28 zero-weighted repeats of sample 0), Adam, in JAX's order."""
    jax_spec = jax_ff.feedforward_hourglass(4)
    spec = spec_from_dataclass(jax_spec)
    params = _jax_params(jax_spec, 4)
    X = np.random.RandomState(5).rand(100, 4).astype(np.float32)
    rng = jax.random.PRNGKey(6)
    opt = jax_train.make_optimizer(jax_spec.optimizer)
    epoch = jax_train.make_epoch_fn(jax_spec, 100, 32, shuffle)
    jax_params, _, jax_loss = epoch(params, opt.init(params), jnp.asarray(X), jnp.asarray(X),
                                    rng)
    order = np.asarray(jax.random.permutation(rng, 100)) if shuffle else np.arange(100)
    model = nn.TransformerModel(spec, params, torch.device("cpu"))
    X_t = torch.from_numpy(X)
    loss, _ = train.run_epoch(model, train.make_optimizer(spec.optimizer, model.parameters()),
                              X_t, X_t, torch.from_numpy(order), 32)
    assert loss == pytest.approx(float(jax_loss), rel=1e-5)
    for p_ours, p_jax in zip(model.params_numpy(), jax_params):
        for name in p_jax:
            np.testing.assert_allclose(p_ours[name], np.asarray(p_jax[name]), rtol=1e-5,
                                       atol=1e-5 * float(np.abs(p_jax[name]).max()))


def test_stacked_masked_epoch_equals_two_serial_epochs():
    """Two machines stacked, each with its own valid-first order over 90 of
    120 slots (dead slots clamped to sample 0, weight 0) at batch 32: each
    machine's step losses and parameters equal its own serial epoch's over
    its 90 live samples, penalty included."""
    spec = ff.feedforward_hourglass(4)
    params = [_jax_params(jax_ff.feedforward_hourglass(4), seed) for seed in (7, 8)]
    rng = np.random.RandomState(9)
    X = torch.from_numpy(rng.rand(2, 120, 4).astype(np.float32))
    orders = torch.stack([torch.cat([torch.from_numpy(rng.permutation(90)),
                                     torch.arange(90, 120)]) for _ in range(2)])
    stacked = nn.StackedTransformerModel(spec, nn.stack_params(params), torch.device("cpu"))
    epoch_losses, step_losses = train.run_masked_epoch(
        stacked, train.make_optimizer(spec.optimizer, stacked.parameters()), X, X, orders, 90, 32)
    assert step_losses.shape == (3, 2)
    for m in range(2):
        serial = nn.TransformerModel(spec, params[m], torch.device("cpu"))
        loss, losses = train.run_epoch(serial, train.make_optimizer(
            spec.optimizer, serial.parameters()), X[m], X[m], orders[m, :90], 32)
        np.testing.assert_allclose(step_losses[:, m].numpy(), losses.numpy(), **TOL)
        assert float(epoch_losses[m]) == pytest.approx(loss, rel=1e-5)
        for p_stacked, p_serial in zip(stacked.machine_params(m), serial.params_numpy()):
            for name, value in p_serial.items():
                np.testing.assert_allclose(p_stacked[name], value, rtol=1e-5, atol=1e-6)


def test_stacked_gather_takes_unwindowed_rows():
    spec = ff.feedforward_hourglass(3)
    X = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    idx = torch.tensor([[4, 0], [1, 3]])
    xb, yb = train._gather_batch(spec, X, -X, idx)
    assert xb.shape == yb.shape == (2, 2, 3)
    assert torch.equal(xb[0], X[0, [4, 0]]) and torch.equal(xb[1], X[1, [1, 3]])
    assert torch.equal(yb, -xb)


def test_init_model_params_draws_the_jax_layout():
    spec = ff.feedforward_hourglass(10)
    ours = nn.init_model_params(spec, torch.Generator().manual_seed(0))
    theirs = jax_nn.init_model_params(jax.random.PRNGKey(0), jax_ff.feedforward_hourglass(10))
    for p_ours, p_jax in zip(ours, theirs):
        assert sorted(p_ours) == sorted(p_jax) == ["bias", "kernel"]
        for name in p_jax:
            assert tuple(p_ours[name].shape) == p_jax[name].shape
        assert not p_ours["bias"].any()
        limit = np.sqrt(6.0 / sum(p_jax["kernel"].shape))
        assert float(p_ours["kernel"].abs().max()) <= limit


def test_validation_split_loss_pads_like_jax():
    """The held-out loss of a penalised spec over 70 samples in batches of
    64: the last batch padded with zero-weighted repeats of sample 0, as
    the JAX package's evaluation pads it."""
    jax_spec = jax_ff.feedforward_hourglass(4)
    spec = spec_from_dataclass(jax_spec)
    params = _jax_params(jax_spec, 10)
    X = np.random.RandomState(11).rand(70, 4).astype(np.float32)
    theirs = jax_train._build_eval_fn(jax_spec, 70, 64)(params, jnp.asarray(X), jnp.asarray(X))
    model = nn.TransformerModel(spec, params, torch.device("cpu"))
    X_t = torch.from_numpy(X)
    assert train.evaluate_loss(model, X_t, X_t, 64) == pytest.approx(float(theirs), rel=1e-5)


def test_autoencoder_fits_and_reports_like_jax():
    X = np.random.RandomState(12).rand(200, 4).astype(np.float32)
    np.random.seed(0)
    ours = models.AutoEncoder("feedforward_hourglass", device="cpu", epochs=3, batch_size=64)
    theirs = jax_models.AutoEncoder(kind="feedforward_hourglass", epochs=3, batch_size=64)
    assert repr(ours) == repr(theirs)
    ours.fit(X, X)
    theirs.fit(X, X)
    assert ours.predict(X).shape == (200, 4)
    assert sorted(ours.get_metadata()) == sorted(theirs.get_metadata()) == ["history"]
    assert ours.history["params"] == theirs.history["params"]
    assert len(ours.history["loss"]) == 3 and ours.history["loss"][-1] < ours.history["loss"][0]
    again = clone(ours)
    assert repr(again) == repr(ours) and not hasattr(again, "module_")
    assert again.into_definition() == theirs.into_definition()


def test_raw_model_regressor_reads_dense_and_refuses_lstm():
    """Dense and LSTM layers parse to the JAX spec; a layer type neither
    package reads raises the JAX package's ValueError."""
    ours = models.RawModelRegressor(RAW_KIND, device="cpu")
    theirs = jax_models.RawModelRegressor(kind=RAW_KIND)
    assert repr(ours) == repr(theirs)
    assert spec_to_dict(ours.build_spec(4, 4)) == spec_to_dict(theirs.build_spec(4, 4))
    lstm = {"spec": {"layers": [{"LSTM": {"units": 4, "activation": "relu",
                                          "return_sequences": True}},
                                {"keras.layers.LSTM": {"units": 3}}, {"Dense": {"units": 4}}]},
            "compile": {"loss": "mse"}, "lookback_window": 5}
    assert spec_to_dict(models.RawModelRegressor(lstm).build_spec(4, 4)) == spec_to_dict(
        jax_models.RawModelRegressor(kind=lstm).build_spec(4, 4))
    gru = {"spec": {"layers": [{"GRU": {"units": 4}}, {"Dense": {"units": 4}}]},
           "compile": {"loss": "mse"}}
    with pytest.raises(ValueError) as refused:
        models.RawModelRegressor(gru).build_spec(4, 4)
    with pytest.raises(ValueError) as jax_refused:
        jax_models.RawModelRegressor(kind=gru).build_spec(4, 4)
    assert str(refused.value) == str(jax_refused.value) == "Unsupported raw layer type: 'GRU'"
    with pytest.raises(ValueError, match="must be a config dict"):
        models.RawModelRegressor("feedforward_hourglass")


# ------------------------------------------------------------ the fleet
def ff_config(name, estimator=None, evaluation=None, detector="DiffBasedAnomalyDetector",
              **kwargs):
    """A small hourglass machine on 2 days of RandomDataset rows (288), as
    ``tests/test_torch_fleet.py``'s Transformer machines are."""
    from test_torch_fleet import machine_config

    config = machine_config(name, evaluation=evaluation, **kwargs)
    config["model"] = {f"gordo_tpu.models.anomaly.diff.{detector}": {
        **config["model"]["gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector"],
        "base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler",
            {"gordo_tpu.models.models.AutoEncoder": estimator or {
                "kind": "feedforward_hourglass", "epochs": 2, "batch_size": 32}}]}}}}
    return config


RAW_ESTIMATOR = {"kind": {"spec": {"layers": [{"Dense": {"units": 3, "activation": "tanh"}},
                                              {"Dense": {"units": 4}}]},
                          "compile": {"loss": "mse", "optimizer": "adam"}},
                 "epochs": 2, "batch_size": 32}
FLEET_PLAN_CASES = {
    "hourglass": ff_config("m"),
    "raw regressor": ff_config("m", estimator=RAW_ESTIMATOR),
    "KFCV": ff_config("m", detector="DiffBasedKFCVAnomalyDetector"),
    "KFold CV": ff_config("m", evaluation={"cv": {"sklearn.model_selection.KFold": {
        "n_splits": 3}}}),
}


@pytest.mark.parametrize("case", sorted(FLEET_PLAN_CASES))
def test_fleet_plans_feedforward_machines_like_jax(case):
    from gordo_tpu.parallel import batch_trainer as jax_bt
    from gordo_tpu_torch.parallel import batch_trainer as bt
    from test_torch_fleet import _machines

    config = FLEET_PLAN_CASES[case]
    if case == "raw regressor":
        config["model"] = {
            "gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": {
                "sklearn.pipeline.Pipeline": {"steps": [
                    "sklearn.preprocessing.MinMaxScaler",
                    {"gordo_tpu.models.models.RawModelRegressor": RAW_ESTIMATOR}]}}}}
    ours, theirs = _machines([config])
    plan, jax_plan = bt._plan_machine(ours[0]), jax_bt._plan_machine(theirs[0])
    # a KFCV machine is bucketed, a KFold outside KFCV stays serial
    assert (plan is None) == (jax_plan is None) == (case == "KFold CV")
    if plan is not None:
        assert plan.spec == spec_from_dataclass(jax_plan.spec)
        for key in ("scale_x", "wrap_anomaly", "kfcv", "epochs", "batch_size", "shuffle",
                    "n_splits", "cv", "anomaly_kwargs"):
            assert getattr(plan, key) == getattr(jax_plan, key), key


def test_feedforward_bucket_program_matches_jax():
    """Three hourglass machines through the JAX bucket program and the
    port's, on the JAX program's draws: losses (the penalty in each), fold
    predictions and parameters."""
    from gordo_tpu.machine import Machine as JaxMachine
    from gordo_tpu.parallel import batch_trainer as jax_bt
    from gordo_tpu_torch.parallel import batch_trainer as bt
    from test_torch_fleet import _fleet_data, jax_draws

    jax_plan = jax_bt._plan_machine(JaxMachine.from_config(ff_config("m"), "p"))
    spec = spec_from_dataclass(jax_plan.spec)
    X = _fleet_data(3)
    seeds = [jax_bt._machine_seed(JaxMachine.from_config(ff_config(f"m-{m}"), "p"))
             for m in range(3)]
    bounds = bt._fold_bounds(len(X[0]), 3)
    program = jax_bt._bucket_program(jax_plan.spec, len(X[0]), bounds, jax_plan.epochs,
                                     jax_plan.batch_size, True, True)
    jax_params, jax_losses, jax_preds = program(jnp.asarray(X), jnp.asarray(X),
                                                jnp.asarray(np.array(seeds, np.uint32)))
    stages = bt.stages_of(spec, len(X[0]), bounds, jax_plan.batch_size)
    inits, orders = jax_draws(jax_plan.spec)(seeds, spec, stages, jax_plan.epochs, True)
    model, losses, preds = bt.run_bucket(spec, X, X, stages, jax_plan.epochs, True, inits,
                                         orders, torch.device("cpu"))
    np.testing.assert_allclose(losses, np.asarray(jax_losses), rtol=1e-5)
    for ours, theirs in zip(preds, jax_preds):
        assert ours.shape == theirs.shape == (3, 72, 4)
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=1e-5, atol=1e-5)
    for m in range(3):
        for mine, layer in zip(model.machine_params(m), jax_params):
            for name, value in layer.items():
                np.testing.assert_allclose(mine[name], np.asarray(value)[m], rtol=1e-5,
                                           atol=1e-5)


def test_mixed_fleet_keeps_families_apart_and_buckets_kfcv(monkeypatch, tmp_path):
    """Hourglass machines, Transformer machines, a KFCV machine under the
    default TimeSeriesSplit and examples/config.yaml's ``turbine-c`` (KFCV,
    seeded shuffled KFold(5)) in one fleet: every machine from a stacked
    program, none by the serial builder; the KFCV machine shares the
    hourglass machines' bucket (only its assembly differs), ``turbine-c``
    has a bucket of its own (its tags and its KFold), the Transformers
    theirs; every artifact loads and predicts, and the KFCV ones are KFCV
    detectors with finite thresholds."""
    from chip_smoke import EXAMPLE_MACHINES
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.machine import Machine
    from gordo_tpu_torch.models.anomaly.diff import DiffBasedKFCVAnomalyDetector
    from gordo_tpu_torch.parallel import batch_trainer as bt
    from test_torch_fleet import ESTIMATOR, machine_config

    turbine = next(dict(c) for c in EXAMPLE_MACHINES if c["name"] == "turbine-c")
    configs = ([ff_config(f"ff-{m}") for m in range(3)]
               + [machine_config(f"tf-{m}", estimator=dict(ESTIMATOR, epochs=1)) for m in range(2)]
               + [ff_config("kfcv", detector="DiffBasedKFCVAnomalyDetector", window=12), turbine])
    buckets = []
    run_bucket = bt.run_bucket

    def recorded(spec, X, *args, **kwargs):
        buckets.append((spec, len(X)))
        return run_bucket(spec, X, *args, **kwargs)

    monkeypatch.setattr(bt, "run_bucket", recorded)
    builder = bt.BatchedModelBuilder([Machine.from_config(c, "p") for c in configs],
                                     device="cpu", output_dir=str(tmp_path))
    built = builder.build()
    assert [m.name for _, m in built] == [c["name"] for c in configs]
    assert builder.serial_built == [] and not builder.quarantine_records
    assert sorted(n for _, n in buckets) == [1, 2, 4]
    assert len({spec for spec, _ in buckets}) == 3
    for (model, machine), config in zip(built, configs):
        n_tags = len(config["dataset"]["tags"])
        X = np.random.RandomState(13).rand(30, n_tags)
        again = serializer.load(str(tmp_path / machine.name), device="cpu")
        assert type(again).__name__ == type(model).__name__
        assert isinstance(model, DiffBasedKFCVAnomalyDetector) == (
            machine.name in ("kfcv", "turbine-c"))
        offset = 15 if machine.name.startswith("tf") else 0
        assert again.predict(X).shape == (30 - offset, n_tags)
        np.testing.assert_allclose(again.predict(X), model.predict(X), rtol=1e-6, atol=1e-6)
        assert np.isfinite(model.aggregate_threshold_)
        assert np.all(np.isfinite(model.feature_thresholds_))


def test_feedforward_fleet_build_matches_jax_batched_builder(monkeypatch):
    """Three hourglass machines built by both fleet trainers on the JAX
    program's draws: parameters, losses, thresholds, scores and splits."""
    from gordo_tpu.machine import Machine as JaxMachine
    from gordo_tpu.parallel import batch_trainer as jax_bt
    from gordo_tpu_torch.parallel import batch_trainer as bt
    from test_torch_fleet import _close, _jax_fleet, _machines, jax_draws

    configs = [ff_config(f"m-{m}") for m in range(3)]
    theirs = _jax_fleet(configs)
    jax_plan = jax_bt._plan_machine(JaxMachine.from_config(configs[0], "proj"))
    monkeypatch.setattr(bt, "draw_inputs", jax_draws(jax_plan.spec))
    builder = bt.BatchedModelBuilder(_machines(configs)[0], serial_fallback=False, device="cpu")
    ours = builder.build()
    assert not builder.serial_built and not builder.quarantine_records
    for (model, machine), (jax_model, jax_machine) in zip(ours, theirs):
        estimator = model.base_estimator.steps[1][1]
        jax_estimator = jax_model.base_estimator.steps[1][1]
        for mine, layer in zip(estimator.module_.params_numpy(), jax_estimator.params_):
            for name, value in layer.items():
                np.testing.assert_allclose(mine[name], np.asarray(value), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(estimator.history["loss"], jax_estimator.history["loss"],
                                   rtol=1e-5)
        _close(model.feature_thresholds_, jax_model.feature_thresholds_, rel=1e-4)
        _close(model.aggregate_threshold_, jax_model.aggregate_threshold_, rel=1e-4)
        _close(model.smooth_feature_thresholds_, jax_model.smooth_feature_thresholds_, rel=1e-4)
        built = machine.metadata.build_metadata.model
        jax_built = jax_machine.metadata.build_metadata.model
        assert built.model_offset == jax_built.model_offset == 0
        scores, jax_scores = built.cross_validation.scores, jax_built.cross_validation.scores
        assert sorted(scores) == sorted(jax_scores)
        for key, entry in jax_scores.items():
            _close([scores[key][k] for k in sorted(entry)], [entry[k] for k in sorted(entry)],
                   rel=1e-4)
        assert built.cross_validation.splits == {
            k: v if isinstance(v, int) else str(v)
            for k, v in jax_built.cross_validation.splits.items()}


# ------------------------------------------------------------ the batcher
def test_batcher_fuses_feedforward_and_transformer_predicts_apart(monkeypatch):
    """Concurrent predicts of three hourglass autoencoders and two small
    Transformers through the process batcher, forced on with a collection
    window: every fused call holds one spec (the counters say so), the
    hourglass rows go through the stacked forward without windows, and each
    answer equals the model's direct predict and the JAX batcher's."""
    from gordo_tpu.server import batcher as jax_batcher
    from gordo_tpu_torch.server import batcher
    from test_torch_batcher import _concurrently, _models

    ff_models = [_pair("AutoEncoder", "feedforward_hourglass", 4, seed=s) for s in range(3)]
    tf_models = [est for _, _, est in _models(2)]
    estimators = [ours for ours, _ in ff_models] + tf_models
    # rows that pad to one shape per spec: 64 rows, and 64 windows
    inputs = [np.random.RandomState(20 + i).rand(rows, 4).astype(np.float32)
              for i, rows in enumerate((50, 55, 60, 80, 90))]
    monkeypatch.delenv("GORDO_TPU_SERVING_BATCH", raising=False)
    batcher.reset_batcher()
    direct = [est.predict(X) for est, X in zip(estimators, inputs)]
    jax_fused = jax_batcher.CrossModelBatcher(window_ms=200, max_batch=8)
    theirs = _concurrently(lambda i: np.asarray(jax_fused.submit(
        ff_models[i][1].spec_, jax.device_put(ff_models[i][1].params_), inputs[i])), 3)
    monkeypatch.setenv("GORDO_TPU_SERVING_BATCH", "1")
    monkeypatch.setenv("GORDO_TPU_BATCH_WINDOW_MS", "300")
    batcher.reset_batcher()
    try:
        fused = _concurrently(lambda i: estimators[i].predict(inputs[i]), len(estimators))
        stats = dict(batcher.peek_batcher().stats)
        spec_calls = dict(batcher.peek_batcher().spec_calls)
    finally:
        batcher.reset_batcher()
    assert stats["items"] == len(estimators) and stats["mixed_spec_calls"] == 0
    assert sorted(spec_calls.values()) == [1, 1]  # one fused call per spec
    assert {ff_models[0][0].spec_, tf_models[0].spec_} == set(spec_calls)
    for got, want in zip(fused, direct):
        np.testing.assert_allclose(got, want, **TOL)
    for got, jax_got in zip(fused, theirs):
        assert got.shape == jax_got.shape
        np.testing.assert_allclose(got, jax_got, **TOL)
