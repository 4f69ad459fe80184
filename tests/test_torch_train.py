"""
The port's training slice (gordo_tpu_torch/ops/train.py, models/models.py,
models/anomaly/diff.py, serializer) against the JAX package on the CPU:

- the epoch function and ``fit_arrays`` on the same parameters (carried
  across with ``serializer/from_jax.py``) and the same sample orders, with
  the attention through the flash path on both sides (the Pallas kernels in
  interpret mode; the port's autograd Function over its plain twins);
- ``cross_validate``'s thresholds with one deterministic stub estimator in
  both detectors;
- the slice end to end: train, cross-validate, dump, load and serve.
"""

import json
import math
import threading
import urllib.request
from datetime import datetime, timedelta, timezone

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.base import BaseEstimator
from sklearn.metrics import explained_variance_score as sk_explained_variance
from sklearn.model_selection import TimeSeriesSplit as SkTimeSeriesSplit
from sklearn.preprocessing import MinMaxScaler as SkMinMaxScaler
from sklearn.utils import shuffle as sk_shuffle

from gordo_tpu.models.anomaly.diff import DiffBasedAnomalyDetector as JaxDetector
from gordo_tpu.models.callbacks import EarlyStopping as JaxEarlyStopping
from gordo_tpu.models.factories import transformer_model as jax_transformer_model
from gordo_tpu.ops import nn as jax_nn
from gordo_tpu.ops import train as jax_train
from gordo_tpu_torch import serializer
from gordo_tpu_torch.models.anomaly.diff import (
    DiffBasedAnomalyDetector,
    TimeSeriesSplit,
    shuffled_order,
)
from gordo_tpu_torch.models.base import clone, explained_variance_score
from gordo_tpu_torch.models.callbacks import EarlyStopping
from gordo_tpu_torch.models.models import TransformerAutoEncoder
from gordo_tpu_torch.models.scaler import MinMaxScaler, Pipeline
from gordo_tpu_torch.models.spec import OptimizerSpec
from gordo_tpu_torch.ops import nn, train
from gordo_tpu_torch.serializer.from_jax import (
    detector_from_arrays,
    params_from_numpy,
    spec_from_dataclass,
)
from gordo_tpu_torch.server.server import make_server

SMALL = dict(n_features=4, lookback_window=32, d_model=16, num_heads=2, ff_dim=32,
             num_blocks=2, attention="flash")
BATCH = 8
N_SAMPLES = 45  # not a multiple of the batch: each epoch ends on a short batch
# float32 on both sides, sums in another order. The parameters stay within
# one float32 ulp of the JAX package's step after step, but this small
# model's loss moves so fast (6.4 to 0.3 in 12 steps) that those ulps move
# the step losses apart by up to ~2e-5 relative within an epoch, the same
# with plain attention on both sides: a loss tolerance of 1e-5 holds for
# the first epoch only, so the per-epoch losses are held to 1e-4.
TOL_LOSS_REL = 1e-4
TOL_PARAM_ABS = 1e-4  # after at most 20 Adam steps
TOL_OUTPUT = dict(atol=1e-5, rtol=1e-5)  # one model, two bk values
TOL_THRESHOLD_REL = 1e-9  # float64 numpy on both sides


def _jax_setup(seed=0):
    spec = jax_transformer_model(**SMALL)
    params = jax_nn.init_model_params(jax.random.PRNGKey(seed), spec)
    return spec, [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _port_model(jax_spec, params):
    spec = spec_from_dataclass(jax_spec)
    return nn.TransformerModel(spec, params_from_numpy(spec, params), torch.device("cpu"))


def _assert_same_params(model, jax_params, jax_spec, X):
    """Every parameter within TOL_PARAM_ABS, except the key biases ``bk``:
    their true gradient is exactly zero (they shift each query's scores by a
    constant), so Adam, which divides by sqrt(v) + eps, turns the two
    frameworks' rounding noise into different values. For them the check is
    that they change nothing: the model with the JAX package's ``bk`` gives
    the same output."""
    ours = model.params_numpy()
    for i, (theirs, mine) in enumerate(zip(jax_params, ours)):
        for name, value in theirs.items():
            if name != "bk":
                np.testing.assert_allclose(mine[name], np.asarray(value), rtol=0,
                                           atol=TOL_PARAM_ABS, err_msg=f"{i}/{name}")
    swapped = [dict(p, **({"bk": np.asarray(t["bk"])} if "bk" in p else {}))
               for p, t in zip(ours, jax_params)]
    x = torch.from_numpy(X[None, :SMALL["lookback_window"]])
    with torch.no_grad():
        np.testing.assert_allclose(
            _port_model(jax_spec, swapped)(x).numpy(), model(x).numpy(), **TOL_OUTPUT)


def test_epochs_match_jax_on_the_same_orders():
    jax_spec, params = _jax_setup()
    X = np.random.RandomState(0).rand(N_SAMPLES + 31, 4).astype(np.float32)
    result = jax_train.fit_arrays(
        jax_spec, [{k: jnp.asarray(v) for k, v in p.items()} for p in params], X, X,
        epochs=3, batch_size=BATCH, shuffle=True, rng=jax.random.PRNGKey(1),
    )
    # the JAX package's per-epoch orders (ops/train.py: split, then permutation)
    key, orders = jax.random.PRNGKey(1), []
    for _ in range(3):
        key, epoch_key = jax.random.split(key)
        orders.append(np.array(jax.random.permutation(epoch_key, N_SAMPLES)))

    model = _port_model(jax_spec, params)
    optimizer = train.make_optimizer(model.spec.optimizer, model.parameters())
    Xt = torch.from_numpy(X)
    for epoch, order in enumerate(orders):
        loss, steps = train.run_epoch(model, optimizer, Xt, Xt, torch.from_numpy(order), BATCH)
        assert steps.shape == (math.ceil(N_SAMPLES / BATCH),)
        assert math.isclose(loss, result.history["loss"][epoch], rel_tol=TOL_LOSS_REL)
    _assert_same_params(model, result.params, jax_spec, X)


def test_fit_arrays_matches_jax_with_validation_and_early_stopping():
    jax_spec, params = _jax_setup(seed=1)
    # 20% held out must still hold one 32-row window: 160 rows, 97 train samples
    X = np.random.RandomState(1).rand(160, 4).astype(np.float32)
    kwargs = dict(epochs=4, batch_size=16, shuffle=False, validation_split=0.2)
    result = jax_train.fit_arrays(
        jax_spec, [{k: jnp.asarray(v) for k, v in p.items()} for p in params], X, X,
        callbacks=[JaxEarlyStopping(patience=0, min_delta=10.0)], **kwargs,
    )
    model = _port_model(jax_spec, params)
    ours = train.fit_arrays(model, X, X, callbacks=[EarlyStopping(patience=0, min_delta=10.0)],
                            **kwargs)
    # min_delta 10 stops both after the second epoch: 14 steps of 16 (7 per epoch)
    assert ours.epochs_trained == result.epochs_trained == 2
    assert set(ours.history) == set(result.history) == {"loss", "val_loss"}
    for key, values in result.history.items():
        np.testing.assert_allclose(ours.history[key], values, rtol=TOL_LOSS_REL)
    _assert_same_params(model, result.params, jax_spec, X)


def test_early_stopping_restores_the_best_state():
    model = _port_model(*_jax_setup(seed=2))
    cb = EarlyStopping(monitor="loss", patience=1, restore_best_weights=True)
    cb.on_train_begin()
    assert not cb.on_epoch_end(0, {"loss": 1.0}, model)
    best = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    assert cb.on_epoch_end(1, {"loss": 2.0}, model)
    for name, value in cb.on_train_end(model).items():
        torch.testing.assert_close(value, best[name])


def test_optimizers():
    params = [torch.nn.Parameter(torch.zeros(3))]
    adam = train.make_optimizer(OptimizerSpec.create("Adam"), params)
    assert adam.defaults["lr"] == 1e-3 and adam.defaults["eps"] == 1e-7
    assert adam.defaults["betas"] == (0.9, 0.999)
    sgd = train.make_optimizer(OptimizerSpec.create("SGD", {"momentum": 0.5}), params)
    assert isinstance(sgd, torch.optim.SGD) and sgd.defaults["momentum"] == 0.5
    # the other five follow optax's update rules (tests/test_torch_definition.py)
    rmsprop = train.make_optimizer(OptimizerSpec.create("RMSprop"), params)
    assert isinstance(rmsprop, train.OptaxRMSprop) and rmsprop.defaults["eps"] == 1e-7
    adamw = train.make_optimizer(OptimizerSpec.create("AdamW"), params)
    assert adamw.defaults["weight_decay"] == 1e-4 and not adamw.defaults["nesterov"]
    assert train.make_optimizer(OptimizerSpec.create("Nadam"), params).defaults["nesterov"]
    with pytest.raises(ValueError):
        train.make_optimizer(OptimizerSpec.create("Bogus"), params)


def test_estimator_trains_on_cuda_unless_asked_for_the_cpu():
    X = np.random.RandomState(3).rand(60, 4)
    est = TransformerAutoEncoder(lookback_window=16, d_model=16, num_heads=2, ff_dim=32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            est.fit(X, X)
    cpu = TransformerAutoEncoder(lookback_window=16, d_model=16, num_heads=2, ff_dim=32,
                                 epochs=2, device="cpu")
    np.random.seed(0)
    cpu.fit(X, X)
    assert next(cpu.module_.parameters()).device.type == "cpu"
    assert cpu.history["params"] == {"epochs": 2, "batch_size": 32, "metrics": ["loss"]}
    assert cpu.get_metadata() == {"history": cpu.history, "forecast_steps": 0}
    out = cpu.predict(X)
    assert out.shape == (45, 4)
    # the estimator scores in float32, as the JAX estimator does
    expected = sk_explained_variance(X[-45:].astype(np.float32), out)
    assert math.isclose(cpu.score(X, X), expected, rel_tol=1e-6)


# ------------------------------------------------------------------ thresholds
class WindowedStub(BaseEstimator):
    """A deterministic windowed regressor: least squares, output rows from
    the ``lookback``-th row on."""

    def __init__(self, lookback: int = 5):
        self.lookback = lookback

    def fit(self, X, y):
        self.coef_ = np.linalg.lstsq(np.asarray(X), np.asarray(y), rcond=None)[0]
        return self

    def predict(self, X):
        return (np.asarray(X) @ self.coef_)[self.lookback - 1:]

    def score(self, X, y):
        out = self.predict(X)
        return -float(np.mean((np.asarray(y)[-len(out):] - out) ** 2))


def _assert_close_tree(ours, theirs, path=""):
    if isinstance(theirs, dict):
        assert sorted(map(str, ours)) == sorted(map(str, theirs)), path
        mine = {str(k): v for k, v in ours.items()}
        for key, value in theirs.items():
            _assert_close_tree(mine[str(key)], value, f"{path}/{key}")
    elif isinstance(theirs, (list, np.ndarray)) or np.ndim(theirs):
        np.testing.assert_allclose(np.asarray(ours, np.float64), np.asarray(theirs, np.float64),
                                   rtol=TOL_THRESHOLD_REL, atol=0, err_msg=path)
    elif isinstance(theirs, (float, np.floating)):
        np.testing.assert_allclose(ours, theirs, rtol=TOL_THRESHOLD_REL, atol=0, err_msg=path)
    else:
        assert ours == theirs, path


@pytest.mark.parametrize("window", [None, 12])
def test_cross_validate_thresholds_match_jax(window):
    rng = np.random.RandomState(4)
    X = rng.rand(400, 3)
    y = X @ rng.rand(3, 3) + 0.1 * rng.rand(400, 3)
    theirs = JaxDetector(base_estimator=WindowedStub(), scaler=SkMinMaxScaler(), window=window)
    ours = DiffBasedAnomalyDetector(base_estimator=WindowedStub(), scaler=MinMaxScaler(),
                                    window=window)
    jax_cv = theirs.cross_validate(X=X, y=y)
    port_cv = ours.cross_validate(X=X, y=y)
    assert set(port_cv) == {"estimator", "fit_time", "score_time", "test_score"}
    assert len(port_cv["estimator"]) == 3
    np.testing.assert_allclose(port_cv["test_score"], jax_cv["test_score"],
                               rtol=TOL_THRESHOLD_REL)
    _assert_close_tree(ours.get_metadata(), theirs.get_metadata())
    assert list(ours.aggregate_thresholds_per_fold_) == ["fold-0", "fold-1", "fold-2"]
    assert ours.aggregate_threshold_ == ours.aggregate_thresholds_per_fold_["fold-2"]


@pytest.mark.parametrize("n", [4, 10, 400, 6144])
def test_time_series_split_and_shuffle_match_sklearn(n):
    X = np.arange(n)[:, None]
    for (a, b), (c, d) in zip(TimeSeriesSplit(3).split(X), SkTimeSeriesSplit(3).split(X)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    np.testing.assert_array_equal(X[shuffled_order(n)], sk_shuffle(X, random_state=0))


def test_clone_and_explained_variance():
    est = TransformerAutoEncoder(lookback_window=16, d_model=16, device="cpu",
                                 callbacks=[EarlyStopping(patience=2)])
    detector = DiffBasedAnomalyDetector(
        Pipeline([("scaler", MinMaxScaler().fit(np.eye(3))), ("estimator", est)]),
        shuffle=True, window=6)
    copy = clone(detector)
    assert copy.get_params().keys() == detector.get_params().keys()
    assert copy.shuffle and copy.window == 6 and copy.smoothing_method == "smm"
    (_, scaler), (_, twin) = copy.base_estimator.steps
    assert scaler.scale_ is None and twin is not est
    assert twin.get_params()["device"] == "cpu"
    assert twin.kwargs["callbacks"][0] is not est.kwargs["callbacks"][0]
    rng = np.random.RandomState(5)
    y, pred = rng.rand(30, 3), rng.rand(30, 3)
    y[:, 1] = 2.0  # a constant column
    for p in (pred, y):
        assert math.isclose(explained_variance_score(y, p), sk_explained_variance(y, p),
                            rel_tol=1e-12)


# ---------------------------------------------------------------- end to end
TAGS = [f"tag-{i}" for i in range(4)]
E2E = dict(lookback_window=16, d_model=32, num_heads=2, ff_dim=64, num_blocks=2)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _structure(data):
    return {top: {sub: list(column) for sub, column in block.items()}
            for top, block in data.items()}


def test_trained_slice_end_to_end_on_the_cpu(tmp_path):
    rng = np.random.RandomState(6)
    X = np.sin(np.arange(240)[:, None] / (5.0 + np.arange(4))) + 0.05 * rng.randn(240, 4)
    np.random.seed(0)
    detector = DiffBasedAnomalyDetector(
        Pipeline([("scaler", MinMaxScaler()),
                  ("estimator", TransformerAutoEncoder(**E2E, epochs=1, device="cpu"))]),
        window=6)
    cv = detector.cross_validate(X=X, y=X)
    assert np.all(np.isfinite(cv["test_score"]))
    detector.fit(X, X)
    estimator = detector.base_estimator.steps[-1][1]
    assert all(math.isfinite(v) for v in estimator.history["loss"])
    assert np.all(np.isfinite(detector.feature_thresholds_))

    collection = tmp_path / "7"
    serializer.dump(detector, str(collection / "trained"), tags=TAGS,
                    metadata={"name": "trained", "dataset": {"resolution": "10min"}})
    # the seeded-weights path of the serving slice, on the same spec and scalers
    scaler = detector.base_estimator.steps[0][1]
    seeded = detector_from_arrays(
        estimator.spec_,
        [{k: v.numpy() for k, v in p.items()}
         for p in nn.init_model_params(estimator.spec_, torch.Generator().manual_seed(0))],
        scaler.min_, scaler.scale_, detector.scaler.min_, detector.scaler.scale_,
        estimator_kwargs=E2E, feature_thresholds=detector.feature_thresholds_,
        aggregate_threshold=detector.aggregate_threshold_, window=6, device="cpu")
    serializer.dump(seeded, str(collection / "seeded"), tags=TAGS)

    loaded = serializer.load(str(collection / "trained"), device="cpu")
    assert loaded.base_estimator.steps[-1][1].history == estimator.history
    _assert_close_tree(loaded.get_metadata(), detector.get_metadata())
    np.testing.assert_array_equal(loaded.base_estimator.predict(X), detector.base_estimator.predict(X))

    server = make_server("127.0.0.1", 0, device="cpu", collection_dir=str(collection))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/p"
        t0 = datetime(2020, 1, 1, tzinfo=timezone.utc)
        stamps = [(t0 + timedelta(minutes=10 * i)).isoformat() for i in range(40)]
        frame = {tag: dict(zip(stamps, X[:40, j].tolist())) for j, tag in enumerate(TAGS)}
        answers = {}
        for name in ("trained", "seeded"):
            status, body = _post(f"{url}/{name}/anomaly/prediction", {"X": frame, "y": frame})
            assert status == 200
            answers[name] = body["data"]
        assert _structure(answers["trained"]) == _structure(answers["seeded"])
        assert all(math.isfinite(x) for x in answers["trained"]["total-anomaly-scaled"][""].values())
        with urllib.request.urlopen(f"{url}/trained/metadata", timeout=60) as resp:
            meta = json.loads(resp.read())["metadata"]["metadata"]["build_metadata"][
                "model"]["model_meta"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert meta["history"]["params"]["epochs"] == 1
    assert sorted(meta["aggregate-thresholds-per-fold"]) == ["fold-0", "fold-1", "fold-2"]
    assert sorted(meta["feature-thresholds-per-fold"]) == [str(i) for i in range(4)]
    assert "smooth-aggregate-thresholds-per-fold" in meta
