"""
The LSTM and TCN families of the port against the JAX package on the CPU,
at small sizes (units <= 8, windows <= 16, two blocks), parameters made by
the JAX package and carried across as numpy:

- the layers against ``apply_model`` (LSTM with every return form and
  other activations, TCN with and without its residual projection and with
  a tap past the window's start), in float32 and bf16; stacked against
  serial at M = 1 and M = 3;
- the LSTM recurrence's plain twin: its hand-written backward against
  autograd through its own forward, and the layer's gradients against
  ``jax.grad`` through ``_apply_lstm``; one epoch against the JAX epoch;
- the factories' specs and refusals, the estimators' fit and predict on
  carried weights, repr and metadata, ``RawModelRegressor`` with LSTM
  layers, and the JAX package's lookback-1 defect refused with its cause;
- the fleet: the planner's plans, a two-machine bucket against the JAX
  bucket program, and LSTM and TCN machines in one ``batch-build``;
- serving: a fused batcher call per spec, and a JAX-built artifact of each
  family carried to the port and answering both routes like the JAX
  server.

Tolerances: TOL (1e-5) for float32 on both sides, summed in other orders;
TOL_BF16 (2e-2), the JAX package's own bf16 tolerance, where a rounding of
bf16 falls differently (the port rounds the input projection and the
recurrent product apart, the JAX code their sum).
"""

import ctypes
import json
import pickle
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder.local_build import local_build as jax_local_build
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.models import models as jax_models
from gordo_tpu.models import spec as jax_spec
from gordo_tpu.models.factories import lstm_autoencoder as jax_lstm, tcn as jax_tcn
from gordo_tpu.ops import nn as jax_nn, train as jax_train
from gordo_tpu.parallel import batch_trainer as jax_bt
from gordo_tpu.server.server import build_app
from gordo_tpu_torch import serializer
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.models import models
from gordo_tpu_torch.models.factories import lstm_autoencoder as lstm_f, tcn as tcn_f
from gordo_tpu_torch.models.spec import spec_to_dict
from gordo_tpu_torch.ops import lstm, nn, train
from gordo_tpu_torch.parallel import batch_trainer as bt
from gordo_tpu_torch.serializer.from_jax import (
    estimator_from_arrays, params_from_numpy, spec_from_dataclass,
)

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True)
def one_thread():
    """torch's CPU kernels on one thread: the 1e-5 gates stay off the loaded
    machine's thread-pool rounding."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_params(spec, seed: int = 0):
    return [{k: np.asarray(v) for k, v in p.items()}
            for p in jax_nn.init_model_params(jax.random.PRNGKey(seed), spec)]


def _spec(layers, n_features=3, n_out=3, lookback=7, lookahead=0, dtype="float32"):
    return jax_spec.ModelSpec(layers=tuple(layers), n_features=n_features,
                              n_features_out=n_out, lookback_window=lookback,
                              lookahead=lookahead, compute_dtype=dtype)


def _windows(n=5, lookback=7, n_features=3, seed=0):
    return np.random.RandomState(seed).rand(n, lookback, n_features).astype(np.float32)


def _both(spec, params, x):
    """(port output, JAX output) of one spec and its parameters on x."""
    theirs, _ = jax_nn.apply_model(spec, params, jnp.asarray(x))
    model = nn.TransformerModel(spec_from_dataclass(spec), params, torch.device("cpu"))
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    return ours, np.asarray(theirs)


L = jax_spec.LSTMLayer
LAYER_CASES = {
    "lstm sequence then last": [L(6, return_sequences=True), L(5), jax_spec.DenseLayer(3)],
    "lstm sequences pooled": [L(4, return_sequences=True), L(8, return_sequences=True),
                              jax_spec.PoolLayer("mean"), jax_spec.DenseLayer(3)],
    "lstm gelu / hard_sigmoid": [L(5, "gelu", "hard_sigmoid", True), L(3, "elu", "softsign"),
                                 jax_spec.DenseLayer(3)],
    "lstm relu / sigmoid": [L(4, "relu", return_sequences=True), L(4, "swish"),
                            jax_spec.DenseLayer(3, "tanh")],
    "tcn with projection": [jax_spec.TCNBlock(5, 3, 1), jax_spec.TCNBlock(5, 3, 2),
                            jax_spec.PoolLayer(), jax_spec.DenseLayer(3)],
    # dilation 4 at a 7-row window: the first tap's offset 8 passes the start
    "tcn skipped tap": [jax_spec.TCNBlock(3, 3, 4, "tanh"), jax_spec.TCNBlock(4, 2, 1),
                        jax_spec.PoolLayer("max"), jax_spec.DenseLayer(3)],
}


@pytest.mark.parametrize("dtype, tol", [("float32", TOL), ("bfloat16", TOL_BF16)])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layers_match_apply_model(case, dtype, tol):
    spec = _spec(LAYER_CASES[case], dtype=dtype)
    ours, theirs = _both(spec, _jax_params(spec, 1), _windows())
    assert ours.shape == theirs.shape == (5, 3)
    np.testing.assert_allclose(ours, theirs, **tol)


@pytest.mark.parametrize("return_sequences", [True, False])
def test_lstm_layer_alone_matches_jax(return_sequences):
    layer = L(6, return_sequences=return_sequences)
    p = jax_nn.init_lstm_layer(jax.random.PRNGKey(3), 4, 6)
    x = _windows(n=4, lookback=9, n_features=4, seed=2)
    theirs = np.asarray(jax_nn._apply_lstm(layer, p, jnp.asarray(x)))
    ours = nn._apply_lstm(spec_from_dataclass(_spec([layer])).layers[0],
                          {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()},
                          torch.from_numpy(x), stacked=False)
    assert ours.shape == theirs.shape == ((4, 9, 6) if return_sequences else (4, 6))
    np.testing.assert_allclose(ours.numpy(), theirs, **TOL)


@pytest.mark.parametrize("width, dilation, t", [(3, 1, 7), (3, 2, 7), (2, 4, 5), (3, 4, 7),
                                                (1, 1, 4)])
def test_causal_conv1d_matches_jax(width, dilation, t):
    kernel = np.random.RandomState(4).randn(width, 3, 5).astype(np.float32)
    x = _windows(n=2, lookback=t)
    theirs = np.asarray(jax_nn._causal_conv1d(jnp.asarray(x), jnp.asarray(kernel), dilation))
    ours = nn._causal_conv1d(torch.from_numpy(x), torch.from_numpy(kernel), dilation)
    np.testing.assert_allclose(ours.numpy(), theirs, **TOL)


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("case", ["lstm sequence then last", "lstm gelu / hard_sigmoid",
                                  "tcn with projection", "tcn skipped tap"])
def test_stacked_forward_equals_serial(case, m):
    """M models of one spec through ``stacked_forward`` (the fleet's and the
    batcher's form, (M, windows, T, D)) against each model alone."""
    spec = spec_from_dataclass(_spec(LAYER_CASES[case]))
    params = [_jax_params(_spec(LAYER_CASES[case]), seed) for seed in range(m)]
    x = np.stack([_windows(seed=10 + i) for i in range(m)])
    stacked = nn.stack_params(params)
    with torch.no_grad():
        out = nn.stacked_forward(spec, [{k: torch.from_numpy(v) for k, v in p.items()}
                                        for p in stacked], torch.from_numpy(x))
        for i in range(m):
            alone = nn.TransformerModel(spec, params[i], torch.device("cpu"))(
                torch.from_numpy(x[i]))
            np.testing.assert_allclose(out[i].numpy(), alone.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("act, rec", [("tanh", "sigmoid"), ("gelu", "hard_sigmoid"),
                                      ("elu", "softsign"), ("selu", "swish"),
                                      ("softplus", "sigmoid"), ("leaky_relu", "linear")])
@pytest.mark.parametrize("return_sequences", [True, False])
def test_plain_backward_equals_autograd_of_the_plain_forward(act, rec, return_sequences):
    """The hand-written backward of the twin (the kernel's arithmetic)
    against autograd through the twin's forward, in float64."""
    g = torch.Generator().manual_seed(0)
    zx = torch.randn((2, 3, 6, 16), generator=g, dtype=torch.float64, requires_grad=True)
    rk = (0.5 * torch.randn((2, 4, 16), generator=g, dtype=torch.float64)).requires_grad_()
    out, (z, c, h) = lstm.lstm_recurrence_forward_plain(zx, rk, act, rec, return_sequences,
                                                        training=True)
    grad = torch.randn(out.shape, generator=g, dtype=torch.float64)
    want = torch.autograd.grad(out, (zx, rk), grad)
    dz = lstm.lstm_recurrence_backward_plain(grad, z.detach(), c.detach(), rk.detach(), act, rec,
                                             return_sequences)
    got = (dz, lstm.recurrent_kernel_grad(h.detach(), dz))
    for mine, theirs in zip(got, want):
        np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("return_sequences", [True, False])
def test_lstm_gradients_match_jax_grad(return_sequences):
    """d(sum(out * w)) for the layer's kernel, recurrent kernel, bias and
    input: the port's LSTM layer (the input projection's matmul, then
    ``LSTMRecurrence`` on its plain twins) against ``jax.grad`` through
    ``_apply_lstm``."""
    layer = L(5, return_sequences=return_sequences)
    p = {k: np.asarray(v) for k, v in jax_nn.init_lstm_layer(jax.random.PRNGKey(5), 3, 5).items()}
    x = _windows(n=4, lookback=8, seed=6)
    out_shape = (4, 8, 5) if return_sequences else (4, 5)
    w = np.random.RandomState(7).randn(*out_shape).astype(np.float32)

    def loss(params, xs):
        return jnp.sum(jax_nn._apply_lstm(layer, params, xs) * w)

    jax_grads, jax_dx = jax.grad(loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = nn._apply_lstm(spec_from_dataclass(_spec([layer])).layers[0], tp, tx, stacked=False)
    (out * torch.from_numpy(w)).sum().backward()
    for name, value in jax_grads.items():
        np.testing.assert_allclose(tp[name].grad.numpy(), np.asarray(value), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(value).max()), err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jax_dx), rtol=1e-5, atol=1e-6)


def test_lstm_bf16_gradients_match_jax_grad():
    """The same gradients under bf16: the port's bf16 dZ and products
    against JAX's, within the bf16 tolerance."""
    spec = _spec([L(6, return_sequences=True), L(4), jax_spec.DenseLayer(3)], dtype="bfloat16")
    params = _jax_params(spec, 8)
    x = _windows(n=6, seed=9)

    def loss(ps):
        out, _ = jax_nn.apply_model(spec, ps, jnp.asarray(x))
        return jnp.mean(out ** 2)

    theirs = jax.grad(loss)(params)
    model = nn.TransformerModel(spec_from_dataclass(spec), params, torch.device("cpu"))
    (model(torch.from_numpy(x)) ** 2).mean().backward()
    for mine, layer in zip(model.layer_params, theirs):
        for name, value in layer.items():
            scale = float(np.abs(value).max())
            np.testing.assert_allclose(mine[name].grad.numpy(), np.asarray(value), rtol=5e-2,
                                       atol=3e-2 * scale, err_msg=name)


@pytest.mark.parametrize("spec_case", ["lstm", "tcn"])
def test_one_epoch_matches_jax(spec_case):
    """One shuffled epoch of 26 windows at batch 8 (the last step 2 live
    samples), Adam, in JAX's order: the epoch loss and every parameter."""
    layers = (LAYER_CASES["lstm sequence then last"] if spec_case == "lstm"
              else LAYER_CASES["tcn with projection"])
    jspec = _spec(layers, lookback=6)
    spec = spec_from_dataclass(jspec)
    params = _jax_params(jspec, 11)
    X = np.random.RandomState(12).rand(31, 3).astype(np.float32)
    rng = jax.random.PRNGKey(13)
    opt = jax_train.make_optimizer(jspec.optimizer)
    epoch = jax_train.make_epoch_fn(jspec, 26, 8, True)
    jax_params, _, jax_loss = epoch(params, opt.init(params), jnp.asarray(X), jnp.asarray(X), rng)
    order = np.asarray(jax.random.permutation(rng, 26))
    model = nn.TransformerModel(spec, params, torch.device("cpu"))
    X_t = torch.from_numpy(X)
    loss, _ = train.run_epoch(model, train.make_optimizer(spec.optimizer, model.parameters()),
                              X_t, X_t, torch.from_numpy(order), 8)
    assert loss == pytest.approx(float(jax_loss), rel=1e-5)
    for mine, layer in zip(model.params_numpy(), jax_params):
        for name, value in layer.items():
            np.testing.assert_allclose(mine[name], np.asarray(value), rtol=1e-4,
                                       atol=1e-5 * float(np.abs(value).max()), err_msg=name)


def test_init_draws_the_jax_layout():
    spec = _spec([L(5, return_sequences=True), L(3), jax_spec.TCNBlock(3, 2),
                  jax_spec.TCNBlock(4, 3), jax_spec.DenseLayer(3)])
    ours = nn.init_model_params(spec_from_dataclass(spec), torch.Generator().manual_seed(0))
    theirs = _jax_params(spec)
    for p_ours, p_jax in zip(ours, theirs):
        assert sorted(p_ours) == sorted(p_jax)
        for name, value in p_jax.items():
            assert tuple(p_ours[name].shape) == value.shape, name
    for p, units in ((ours[0], 5), (ours[1], 3)):
        bias = p["bias"].numpy()
        assert (bias[units:2 * units] == 1).all() and not bias[:units].any()
        assert not bias[2 * units:].any()
        rk = p["recurrent_kernel"].numpy()  # orthonormal rows
        np.testing.assert_allclose(rk @ rk.T, np.eye(units), atol=1e-5)
    assert "res_kernel" not in ours[2] and ours[3]["res_kernel"].shape == (1, 3, 4)
    assert nn.layer_out_dim(spec_from_dataclass(spec).layers[2], 7) == 3


# ------------------------------------------------------------ factories
FACTORY_CASES = [
    ("lstm_hourglass", dict(n_features=4, lookback_window=24)),
    ("lstm_hourglass", dict(n_features=10, compression_factor=0.2, func="relu",
                            lookahead=1)),
    ("lstm_symmetric", dict(n_features=8, dims=(64, 32), funcs=("tanh", "tanh"),
                            lookback_window=144)),
    ("lstm_model", dict(n_features=4)),
    ("lstm_model", dict(n_features=4, encoding_dim=(8, 2), encoding_func=("tanh", "elu"),
                        decoding_dim=(2, 8), decoding_func=("linear", "tanh"),
                        out_func="sigmoid", optimizer="SGD",
                        optimizer_kwargs={"learning_rate": 0.1},
                        compile_kwargs={"loss": "mae"}, n_features_out=2)),
    ("tcn_model", dict(n_features=8)),
    ("tcn_model", dict(n_features=3, lookback_window=16, filters=6, kernel_size=2,
                       dilations=(1, 3), func="tanh", pool="mean", lookahead=1)),
]


@pytest.mark.parametrize("kind, kwargs", FACTORY_CASES)
def test_factory_spec_equals_jax(kind, kwargs):
    module, jax_module = (tcn_f, jax_tcn) if kind == "tcn_model" else (lstm_f, jax_lstm)
    assert spec_to_dict(getattr(module, kind)(**kwargs)) == spec_to_dict(
        getattr(jax_module, kind)(**kwargs))


@pytest.mark.parametrize("kind, kwargs", [
    ("lstm_symmetric", dict(dims=(), funcs=())),
    ("lstm_model", dict(encoding_dim=(4, 3), encoding_func=("tanh",))),
    ("tcn_model", dict(lookback_window=1)),
    ("tcn_model", dict(num_blocks=0)),
    ("tcn_model", dict(dilations=())),
])
def test_factories_refuse_like_jax(kind, kwargs):
    module, jax_module = (tcn_f, jax_tcn) if kind == "tcn_model" else (lstm_f, jax_lstm)
    with pytest.raises(ValueError) as ours:
        getattr(module, kind)(4, **kwargs)
    with pytest.raises(ValueError) as theirs:
        getattr(jax_module, kind)(4, **kwargs)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("estimator", ["LSTMAutoEncoder", "LSTMForecast", "TCNAutoEncoder",
                                       "TCNForecast"])
def test_factories_are_filed_under_their_estimators(estimator):
    assert sorted(models.FACTORIES[estimator]) == sorted(
        jax_models.register_model_builder.factories[estimator])
    with pytest.raises(ValueError, match=f"type: {estimator}"):
        getattr(models, estimator)("feedforward_hourglass")


# ------------------------------------------------------------ estimators
def _pair(estimator: str, kind, n_features: int, seed: int = 0, **kwargs):
    """(port estimator, JAX estimator) on the same JAX-initialised params."""
    theirs = getattr(jax_models, estimator)(kind=kind, **kwargs)
    spec = theirs.build_spec(n_features, n_features)
    theirs.spec_, theirs.params_ = spec, _jax_params(spec, seed)
    ours = estimator_from_arrays(spec_from_dataclass(spec), theirs.params_, estimator, kind,
                                 kwargs, device="cpu")
    return ours, theirs


SMALL_LSTM = dict(dims=(6, 4), funcs=("tanh", "tanh"), lookback_window=8)
SMALL_TCN = dict(filters=5, num_blocks=2, lookback_window=8)
PREDICT_CASES = [
    ("LSTMAutoEncoder", "lstm_symmetric", SMALL_LSTM, 7, TOL),
    ("LSTMForecast", "lstm_symmetric", SMALL_LSTM, 8, TOL),
    ("LSTMAutoEncoder", "lstm_hourglass", dict(lookback_window=5), 4, TOL),
    ("LSTMForecast", "lstm_hourglass", {}, 1, TOL),  # lookback 1: windowed by its lookahead
    ("LSTMAutoEncoder", "lstm_symmetric", dict(SMALL_LSTM, compute_dtype="bfloat16"), 7,
     TOL_BF16),
    ("TCNAutoEncoder", "tcn_model", SMALL_TCN, 7, TOL),
    ("TCNForecast", "tcn_model", SMALL_TCN, 8, TOL),
    ("TCNAutoEncoder", "tcn_model", dict(SMALL_TCN, compute_dtype="bfloat16"), 7, TOL_BF16),
]


@pytest.mark.parametrize("estimator, kind, kwargs, offset, tol", PREDICT_CASES)
def test_predict_matches_jax(estimator, kind, kwargs, offset, tol):
    ours, theirs = _pair(estimator, kind, 4, **kwargs)
    X = np.random.RandomState(1).rand(37, 4).astype(np.float32)
    got, want = ours.predict(X), np.asarray(theirs.predict(X))
    assert got.shape == want.shape == (37 - offset, 4)
    np.testing.assert_allclose(got, want, **tol)
    assert ours.output_offset == theirs.output_offset == offset
    assert ours.score(X, X) == pytest.approx(float(theirs.score(X, X)), rel=1e-3, abs=1e-4)


@pytest.mark.parametrize("estimator, kind, kwargs", [
    ("LSTMAutoEncoder", "lstm_hourglass", dict(lookback_window=24, epochs=3)),
    ("LSTMAutoEncoder", "lstm_symmetric", dict(dims=(4, 3), funcs=("tanh", "relu"),
                                               lookback_window=6, batch_size=8, epochs=2)),
    ("LSTMForecast", "lstm_model", {}),
    ("TCNAutoEncoder", "tcn_model", dict(filters=4, num_blocks=2, lookback_window=8)),
    ("TCNForecast", "tcn_model", dict(lookback_window=144, batch_size=32, epochs=2)),
])
def test_estimators_repr_definition_and_metadata_like_jax(estimator, kind, kwargs):
    ours = getattr(models, estimator)(kind, device="cpu", **kwargs)
    theirs = getattr(jax_models, estimator)(kind=kind, **kwargs)
    assert repr(ours) == repr(theirs)
    assert ours.get_params() == {**theirs.get_params(), "device": "cpu"}
    assert ours.into_definition() == theirs.into_definition()
    assert ours.lookback_window == theirs.lookback_window
    assert ours.output_offset == theirs.output_offset
    assert spec_to_dict(ours.build_spec(4, 4)) == spec_to_dict(theirs.build_spec(4, 4))
    assert serializer.into_definition(ours) == jax_serializer.into_definition(theirs)


@pytest.mark.parametrize("estimator, kind, kwargs", [
    ("LSTMAutoEncoder", "lstm_symmetric", dict(dims=(4, 3), funcs=("tanh", "tanh"),
                                               lookback_window=5, batch_size=8, epochs=2)),
    ("LSTMForecast", "lstm_hourglass", dict(epochs=1, batch_size=16)),
    ("TCNForecast", "tcn_model", dict(filters=4, num_blocks=2, lookback_window=6, epochs=2,
                                      batch_size=16)),
])
def test_estimators_fit_and_report_like_jax(estimator, kind, kwargs):
    X = np.random.RandomState(14).rand(60, 4).astype(np.float32)
    np.random.seed(0)
    ours = getattr(models, estimator)(kind, device="cpu", **kwargs).fit(X, X)
    theirs = getattr(jax_models, estimator)(kind=kind, **kwargs).fit(X, X)
    assert ours.predict(X).shape == np.asarray(theirs.predict(X)).shape
    assert ours.history["params"] == theirs.history["params"]
    assert sorted(ours.get_metadata()) == sorted(theirs.get_metadata())
    assert ours.get_metadata()["forecast_steps"] == theirs.get_metadata()["forecast_steps"]
    assert all(np.isfinite(ours.history["loss"]))


RAW_LSTM = {"spec": {"layers": [{"LSTM": {"units": 5, "return_sequences": True}},
                                {"keras.layers.LSTM": {"units": 3, "activation": "relu"}},
                                {"Dense": {"units": 4}}]},
            "compile": {"loss": "mse", "optimizer": "adam"}, "lookback_window": 6}


def test_raw_model_regressor_with_lstm_layers_matches_jax():
    ours, theirs = models.RawModelRegressor(RAW_LSTM, device="cpu"), jax_models.RawModelRegressor(
        kind=RAW_LSTM)
    assert repr(ours) == repr(theirs)
    spec = theirs.build_spec(4, 4)
    assert spec_to_dict(ours.build_spec(4, 4)) == spec_to_dict(spec)
    params = _jax_params(spec, 15)
    ours.load_params(spec_from_dataclass(spec), params_from_numpy(spec_from_dataclass(spec),
                                                                  params), "cpu")
    theirs.spec_, theirs.params_ = spec, params
    X = np.random.RandomState(16).rand(20, 4).astype(np.float32)
    np.testing.assert_allclose(ours.predict(X), np.asarray(theirs.predict(X)), **TOL)


def test_lookback_one_defect_is_refused_with_its_cause():
    """The JAX package fails on an unwindowed LSTM spec (the LSTM
    estimators' own default lookback_window=1) deep in its scan; the port
    refuses the same configurations with a ValueError naming
    lookback_window. LSTMForecast at lookback 1 is windowed by its
    lookahead and trains in both."""
    X = np.random.RandomState(17).rand(30, 4).astype(np.float32)
    raw = {k: v for k, v in RAW_LSTM.items() if k != "lookback_window"}
    for make_ours, make_theirs in (
            (lambda: models.LSTMAutoEncoder("lstm_hourglass", device="cpu", epochs=1),
             lambda: jax_models.LSTMAutoEncoder(kind="lstm_hourglass", epochs=1)),
            (lambda: models.RawModelRegressor(raw, device="cpu"),
             lambda: jax_models.RawModelRegressor(kind=raw))):
        with pytest.raises(ValueError, match="lookback_window"):
            make_ours().fit(X, X)
        with pytest.raises(ValueError, match="out of bounds"):
            make_theirs().fit(X, X)
    np.random.seed(0)
    ours = models.LSTMForecast("lstm_hourglass", device="cpu", epochs=1, batch_size=8).fit(X, X)
    theirs = jax_models.LSTMForecast(kind="lstm_hourglass", epochs=1, batch_size=8).fit(X, X)
    assert ours.predict(X).shape == np.asarray(theirs.predict(X)).shape == (29, 4)
    with pytest.raises(ValueError, match="lookback_window"):
        nn._apply_lstm(spec_from_dataclass(_spec([L(3)])).layers[0], {}, torch.zeros(4, 3),
                       stacked=False)


PLAN_SOURCE = Path(lstm.__file__).resolve().parent / "csrc" / "lstm_plan.cuh"


@pytest.fixture(scope="module")
def plan_library(tmp_path_factory):
    """The kernels' launch plan and index maps (csrc/lstm_plan.cuh, plain
    C++ that the CUDA source includes) built for the host with g++, bound
    as the wrapper binds the card's library."""
    out = tmp_path_factory.mktemp("lstm_plan") / "liblstm_plan.so"
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(out),
                    str(PLAN_SOURCE)], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def _plans(plan_library, monkeypatch):
    monkeypatch.setattr(lstm, "_plan_library", lambda: plan_library)
    lstm.check_launch_limits.cache_clear()


def test_recurrence_checks_its_inputs_and_names_its_limits(monkeypatch, plan_library):
    """The inputs' checks, and the launch limits: the machines against
    grid.y here, the shared memory through the CUDA source's plan (its
    host build; the plan on the card is held in
    test_torch_kernels_cuda.py)."""
    with pytest.raises(ValueError, match="Unknown activation"):
        lstm.activation_code("mish")
    with pytest.raises(ValueError, match="do not match"):
        lstm.lstm_recurrence(torch.zeros(1, 2, 3, 8), torch.zeros(1, 3, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lstm.lstm_recurrence(torch.zeros(1, 2, 3, 8, dtype=torch.float64),
                             torch.zeros(1, 2, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="grid.y"):
        lstm.check_launch_limits(70000, 4, 8)
    _plans(plan_library, monkeypatch)
    with pytest.raises(ValueError, match="the legacy step buffers need 768000 bytes of shared "
                                         "memory at batch tile 8"):
        lstm.check_launch_limits(1, 4096, 4000)
    lstm.check_launch_limits(64, 64, 256)
    lstm.check_launch_limits.cache_clear()
    assert [lstm.batch_tile(m, b) for m, b in ((1, 1), (1, 64), (1, 2048), (64, 64))] == [
        1, 1, 8, 8]
    assert lstm.ACTIVATION_CODES == tuple(sorted(nn.ACTIVATIONS, key=lstm.ACTIVATION_CODES.index))
    assert sorted(lstm.ACTIVATION_CODES) == sorted(jax_nn.ACTIVATIONS)


def _legacy_takes(u, bt, backward):
    """The first port's plan alone (the legacy kernels): its step buffers within a
    block."""
    threads = min(-(-4 * u // 32) * 32, 256)
    parts = 1 if u >= threads else threads // u
    return 4 * (6 if not backward else 5 + parts) * bt * u <= 232448


@pytest.mark.parametrize("u", [1, 3, 8, 16, 64, 100, 256, 512, 600, 1000, 1200, 1210, 3000,
                               9000])
def test_plan_takes_every_shape_the_legacy_plan_took(monkeypatch, plan_library, u):
    """check_launch_limits accepts every (M, B, U) that the first port's
    plan accepted, in both dtypes; it may accept more."""
    _plans(plan_library, monkeypatch)
    for m, b in ((1, 1), (1, 64), (64, 64), (1, 4096), (3, 101)):
        bt = lstm.batch_tile(m, b)
        if not (_legacy_takes(u, bt, False) and _legacy_takes(u, bt, True)):
            continue
        for elem in (4, 2):
            lstm.check_launch_limits(m, b, u, elem)
    lstm.check_launch_limits.cache_clear()


def _smoke_shapes():
    import chip_smoke

    return [shape[1:] for shape in chip_smoke.LSTM_SHAPES + chip_smoke.LSTM_CHECK_SHAPES] + [
        (1, 32, 144, 128), (1, 32, 144, 512), (32, 64, 144, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backward", [False, True])
def test_every_smoke_shape_gets_a_plan_within_the_card(monkeypatch, plan_library, dtype,
                                                       backward):
    """Every shape chip_smoke.py launches (LSTM_SHAPES, LSTM_CHECK_SHAPES,
    and U 128, 256 and 512) gets a plan within a block's 232,448 bytes of
    shared memory and 512 threads, a cluster of at most 16 that divides
    the padded units into whole tiles, and the tensor-core routes from U 8
    on (but for float32 U <= 64 over at most 132 rows, where the legacy
    kernels are faster): R held in the cluster at U 256 and below."""
    _plans(plan_library, monkeypatch)
    for m, b, _, u in _smoke_shapes():
        plan = lstm.kernel_plan(m, b, u, dtype, backward)
        assert 0 < plan["smem_bytes"] <= 232448 and 0 < plan["threads"] <= 512, plan
        assert plan["cluster"] in (1, 2, 4, 8, 16), plan
        legacy = u < 8 or (dtype == torch.float32 and u <= 64 and m * b <= 132)
        assert plan["route"] == ("legacy" if legacy else "cluster" if u <= 256 else
                                 "stream" if dtype == torch.float32 else "cluster"), (u, plan)
        if plan["route"] != "legacy":
            # whole tiles a CTA: unit blocks of 8 forward, m16 tiles backward
            assert (-(-u // 16) * 16) % ((16 if backward else 8) * plan["cluster"]) == 0
            assert plan["rows"] in (8, 16, 32) and plan["threads"] % 32 == 0


def _cells(plan_library, m_b_u, plan, backward):
    """Every (unit, row) the plan's threads own, with repeats."""
    _, b, u = m_b_u
    up = -(-u // 16) * 16
    uc = up // plan["cluster"]
    unit, row = ctypes.c_int(), ctypes.c_int()
    cells = []
    slots = (4 if backward else 2 * plan["tiles_a_warp"]) // plan["ksplit"]
    for tile in range(-(-b // plan["rows"])):
        for rank in range(plan["cluster"]):
            for warp in range(plan["threads"] // 32):
                for lane in range(32):
                    for s in range(slots):
                        plan_library.gordo_lstm_cell_of(
                            int(backward), uc, plan["rows"], plan["tiles_a_warp"],
                            plan["ksplit"], rank, tile, warp, lane, s, ctypes.byref(unit),
                            ctypes.byref(row))
                        cells.append((unit.value, row.value))
    return cells


def test_set_route_forces_the_librarys_plan(monkeypatch, plan_library):
    """The forced route lives in the plan's library alone: set_route changes
    what kernel_plan and check_launch_limits read from it, and None gives
    back the plan's own rule."""
    _plans(plan_library, monkeypatch)
    own = lstm.kernel_plan(1, 64, 64, torch.float32, False)
    assert own["route"] == "legacy"
    lstm.check_launch_limits(1, 64, 64)
    try:
        lstm.set_route("cluster", rows=8)
        forced = lstm.kernel_plan(1, 64, 64, torch.float32, False)
        assert (forced["route"], forced["rows"], forced["cluster"]) == ("cluster", 8, 1)
        lstm.set_route("cluster", cluster=16)  # 64 units do not split over 16 CTAs
        with pytest.raises(ValueError, match="no tensor-core route"):
            lstm.check_launch_limits(1, 64, 64)
    finally:
        lstm.set_route(None)
    assert lstm.kernel_plan(1, 64, 64, torch.float32, False) == own
    lstm.check_launch_limits(1, 64, 64)


@pytest.mark.parametrize("backward", [False, True])
def test_the_tiles_cover_each_row_once(monkeypatch, plan_library, backward):
    """At every smoke shape on a tensor-core route, the threads of the
    plan's CTAs (row tiles x cluster) finish each (unit, batch row) of a
    machine exactly once, in both dtypes' plans and every k split (cell_of,
    the map the kernels use)."""
    _plans(plan_library, monkeypatch)
    # the smoke's shapes on the plan's own route, and small ones (which
    # the plan gives the legacy route) on the held-R route, forced
    shapes = _smoke_shapes() + [(1, 1, 1, 8), (2, 20, 1, 40), (1, 64, 1, 64), (1, 64, 1, 32)]
    plans = []
    try:
        for i, (m, b, _, u) in enumerate(shapes):
            lstm.set_route(None if i < len(_smoke_shapes()) else "cluster")
            plans += [lstm.kernel_plan(m, b, u, dtype, backward)
                      for dtype in (torch.float32, torch.bfloat16)]
    finally:
        lstm.set_route(None)
    assert {plan["ksplit"] for plan in plans if plan["route"] != "legacy"} == (
        {2, 4} if backward else {1, 2})
    for (m, b, _, u), plan in zip([s for s in shapes for _ in range(2)], plans):
        if plan["route"] == "legacy":
            continue
        cells = [c for c in _cells(plan_library, (m, b, u), plan, backward)
                 if c[0] < u and c[1] < b]
        assert sorted(cells) == [(k, r) for k in range(u) for r in range(b)], (u, b, plan)


def _interleaved(plan_library, u):
    up = -(-u // 16) * 16
    return [plan_library.gordo_lstm_interleaved_column(u, q) for q in range(4 * up)]


@pytest.mark.parametrize("u", [3, 8, 16, 20, 64, 256])
def test_gate_interleaved_order_round_trips(plan_library, u):
    """The forward's rows (R's columns gate-interleaved in blocks of 8
    units, -1 for a padded unit) are a permutation of R's 4U columns, and
    every m16 tile holds two whole gates of one block: the thread holding
    (unit, row) in a block's two tiles holds its i, f, g and o."""
    order = _interleaved(plan_library, u)
    columns = [col for col in order if col >= 0]
    assert sorted(columns) == list(range(4 * u))
    inverse = np.argsort(columns)
    assert (np.asarray(columns)[inverse] == np.arange(4 * u)).all()
    for q, col in enumerate(order):
        unit = (q // 32) * 8 + q % 8
        assert col == ((q % 32) // 8 * u + unit if unit < u else -1)


def test_plain_twin_through_the_interleaved_order_matches_jax(plan_library):
    """The layer's recurrent kernel and input projection carried through the
    kernels' interleaved order: the product in that order is the product's
    columns reordered, and the twin fed the order's inverse of them gives
    the JAX ``_apply_lstm``."""
    u = 20
    layer = L(u, return_sequences=True)
    p = jax_nn.init_lstm_layer(jax.random.PRNGKey(5), 4, u)
    x = _windows(n=3, lookback=6, n_features=4, seed=4)
    theirs = np.asarray(jax_nn._apply_lstm(layer, p, jnp.asarray(x)))
    columns = [col for col in _interleaved(plan_library, u) if col >= 0]
    inverse = np.argsort(columns)
    kernel, rk, bias = (torch.from_numpy(np.asarray(p[k])) for k in
                        ("kernel", "recurrent_kernel", "bias"))
    rk_il, zx_il = rk[:, columns], (torch.from_numpy(x) @ kernel + bias)[..., columns]
    h = torch.from_numpy(np.random.RandomState(0).rand(3, u).astype(np.float32))
    torch.testing.assert_close(h @ rk_il, (h @ rk)[:, columns], rtol=0, atol=0)
    ours, _ = lstm.lstm_recurrence_forward_plain(zx_il[..., inverse][None], rk_il[:, inverse][None],
                                                 "tanh", "sigmoid", True)
    np.testing.assert_allclose(ours[0].numpy(), theirs, **TOL)


def test_chip_smokes_lstm_model_family_is_the_jax_factorys_default():
    """chip_smoke.py's fourth windowed family, lstm_model_144: the JAX
    factory's lstm_model at its defaults (encoding 256, 128, 64, decoding
    64, 128, 256, tanh), an LSTMAutoEncoder over 8 tags at lookback 144."""
    import chip_smoke

    cls, kwargs = chip_smoke.WINDOWED_FAMILIES["lstm_model_144"]
    assert cls == "LSTMAutoEncoder" and kwargs == {"kind": "lstm_model"}
    ours = getattr(models, cls)(**kwargs, lookback_window=chip_smoke.WINDOWED_FIT[
        "lookback_window"], device="cpu").build_spec(8, 8)
    theirs = jax_lstm.lstm_model(8, lookback_window=144)
    assert spec_to_dict(ours) == spec_to_dict(spec_from_dataclass(theirs))
    assert [layer.units for layer in ours.layers if hasattr(layer, "recurrent_activation")] == [
        256, 128, 64, 64, 128, 256]


# ------------------------------------------------------------ the fleet
def windowed_config(name, estimator_cls, estimator, **detector):
    """A small windowed machine on 2 days of RandomDataset rows (288)."""
    from test_torch_fleet import machine_config

    config = machine_config(name, **detector)
    config["model"]["gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector"][
        "base_estimator"]["sklearn.pipeline.Pipeline"]["steps"][1] = {
        f"gordo_tpu.models.models.{estimator_cls}": estimator}
    return config


LSTM_ESTIMATOR = {"kind": "lstm_symmetric", "dims": [4, 3], "funcs": ["tanh", "tanh"],
                  "lookback_window": 8, "epochs": 1, "batch_size": 16}
TCN_ESTIMATOR = {"kind": "tcn_model", "filters": 4, "num_blocks": 2, "lookback_window": 8,
                 "epochs": 1, "batch_size": 16}
FLEET_PLAN_CASES = {
    "lstm autoencoder": ("LSTMAutoEncoder", LSTM_ESTIMATOR),
    "lstm forecast": ("LSTMForecast", LSTM_ESTIMATOR),
    "tcn autoencoder": ("TCNAutoEncoder", TCN_ESTIMATOR),
    "tcn forecast": ("TCNForecast", TCN_ESTIMATOR),
}


@pytest.mark.parametrize("case", sorted(FLEET_PLAN_CASES))
def test_fleet_plans_windowed_machines_like_jax(case):
    from test_torch_fleet import _machines

    ours, theirs = _machines([windowed_config("m", *FLEET_PLAN_CASES[case])])
    plan, jax_plan = bt._plan_machine(ours[0]), jax_bt._plan_machine(theirs[0])
    assert plan is not None and jax_plan is not None
    assert plan.spec == spec_from_dataclass(jax_plan.spec)
    for key in ("scale_x", "wrap_anomaly", "kfcv", "epochs", "batch_size", "shuffle",
                "n_splits", "cv"):
        assert getattr(plan, key) == getattr(jax_plan, key), key


def test_kfcv_machine_with_an_offset_stays_serial_like_jax():
    from test_torch_fleet import _machines

    config = windowed_config("m", "LSTMAutoEncoder", LSTM_ESTIMATOR)
    config["model"] = {"gordo_tpu.models.anomaly.diff.DiffBasedKFCVAnomalyDetector":
                       config["model"]["gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector"]}
    ours, theirs = _machines([config])
    assert bt._plan_machine(ours[0]) is None and jax_bt._plan_machine(theirs[0]) is None


@pytest.mark.parametrize("case", ["lstm autoencoder", "tcn forecast"])
def test_bucket_program_matches_jax(case):
    """Two machines through the JAX bucket program and the port's, on the
    JAX program's draws: losses, fold predictions and parameters."""
    from test_torch_fleet import _fleet_data, jax_draws

    estimator_cls, estimator = FLEET_PLAN_CASES[case]
    jax_plan = jax_bt._plan_machine(JaxMachine.from_config(
        windowed_config("m", estimator_cls, estimator), "p"))
    spec = spec_from_dataclass(jax_plan.spec)
    X = _fleet_data(2)
    seeds = [jax_bt._machine_seed(JaxMachine.from_config(
        windowed_config(f"m-{m}", estimator_cls, estimator), "p")) for m in range(2)]
    bounds = bt._fold_bounds(len(X[0]), 3)
    program = jax_bt._bucket_program(jax_plan.spec, len(X[0]), bounds, jax_plan.epochs,
                                     jax_plan.batch_size, True, True)
    jax_params, jax_losses, jax_preds = program(jnp.asarray(X), jnp.asarray(X),
                                                jnp.asarray(np.array(seeds, np.uint32)))
    stages = bt.stages_of(spec, len(X[0]), bounds, jax_plan.batch_size)
    inits, orders = jax_draws(jax_plan.spec)(seeds, spec, stages, jax_plan.epochs, True)
    model, losses, preds = bt.run_bucket(spec, X, X, stages, jax_plan.epochs, True, inits,
                                         orders, torch.device("cpu"))
    np.testing.assert_allclose(losses, np.asarray(jax_losses), rtol=1e-4)
    offset = spec.output_offset
    for ours, theirs in zip(preds, jax_preds):
        assert ours.shape == theirs.shape == (2, 72 - offset, 4)
        np.testing.assert_allclose(ours, np.asarray(theirs), atol=1e-4)
    for m in range(2):
        for mine, layer in zip(model.machine_params(m), jax_params):
            for name, value in layer.items():
                np.testing.assert_allclose(mine[name], np.asarray(value)[m], atol=1e-4,
                                           err_msg=name)


def test_windowed_fleet_buckets_each_family_apart(monkeypatch, tmp_path):
    """Two LSTM autoencoders, an LSTM forecaster and two TCN machines in one
    fleet: every machine from a stacked program (no serial build), one
    bucket per spec, and every artifact loads and predicts as built."""
    configs = ([windowed_config(f"lstm-{m}", "LSTMAutoEncoder", LSTM_ESTIMATOR)
                for m in range(2)]
               + [windowed_config("forecast", "LSTMForecast", LSTM_ESTIMATOR)]
               + [windowed_config(f"tcn-{m}", "TCNAutoEncoder", TCN_ESTIMATOR)
                  for m in range(2)])
    buckets = []
    run_bucket = bt.run_bucket

    def recorded(spec, X, *args, **kwargs):
        buckets.append((spec, len(X)))
        return run_bucket(spec, X, *args, **kwargs)

    monkeypatch.setattr(bt, "run_bucket", recorded)
    builder = bt.BatchedModelBuilder([Machine.from_config(c, "p") for c in configs],
                                     device="cpu", output_dir=str(tmp_path))
    built = builder.build()
    assert builder.serial_built == [] and not builder.quarantine_records
    assert sorted(n for _, n in buckets) == [1, 2, 2] and len({s for s, _ in buckets}) == 3
    X = np.random.RandomState(18).rand(30, 4)
    for model, machine in built:
        offset = 8 if machine.name == "forecast" else 7
        assert machine.metadata.build_metadata.model.model_offset == offset
        again = serializer.load(str(tmp_path / machine.name), device="cpu")
        assert again.predict(X).shape == (30 - offset, 4)
        np.testing.assert_allclose(again.predict(X), model.predict(X), rtol=1e-6, atol=1e-6)
        assert np.isfinite(model.aggregate_threshold_)


# ------------------------------------------------------------ serving
def test_batcher_fuses_lstm_and_tcn_predicts_apart(monkeypatch):
    """Concurrent predicts of three LSTM and two TCN models through the
    process batcher, forced on with a collection window: one fused call a
    spec, and each answer equal to the model's direct predict."""
    from gordo_tpu_torch.server import batcher
    from test_torch_batcher import _concurrently

    lstm_models = [_pair("LSTMAutoEncoder", "lstm_symmetric", 4, seed=s, **SMALL_LSTM)[0]
                   for s in range(3)]
    tcn_models = [_pair("TCNAutoEncoder", "tcn_model", 4, seed=s, **SMALL_TCN)[0]
                  for s in range(2)]
    estimators = lstm_models + tcn_models
    # rows that pad to one shape per spec: 64 windows
    inputs = [np.random.RandomState(20 + i).rand(rows, 4).astype(np.float32)
              for i, rows in enumerate((50, 60, 70, 55, 65))]
    monkeypatch.delenv("GORDO_TPU_SERVING_BATCH", raising=False)
    batcher.reset_batcher()
    direct = [est.predict(X) for est, X in zip(estimators, inputs)]
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
    assert sorted(spec_calls.values()) == [1, 1]
    assert {lstm_models[0].spec_, tcn_models[0].spec_} == set(spec_calls)
    for got, want in zip(fused, direct):
        np.testing.assert_allclose(got, want, **TOL)


SERVED_FAMILIES = {
    "lstm": ("LSTMAutoEncoder", {"kind": "lstm_symmetric", "dims": [4, 3],
                                 "funcs": ["tanh", "tanh"], "lookback_window": 6,
                                 "epochs": 1, "batch_size": 32}),
    "lstm-forecast": ("LSTMForecast", {"kind": "lstm_hourglass", "lookback_window": 4,
                                       "epochs": 1, "batch_size": 32}),
    "tcn": ("TCNAutoEncoder", {"kind": "tcn_model", "filters": 4, "num_blocks": 2,
                               "lookback_window": 6, "epochs": 1}),
}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(JAX collection, port collection): one machine of each family built
    by the JAX package (1 day), each carried into a port artifact."""
    from test_torch_kfcv import _carry

    root = tmp_path_factory.mktemp("windowed")
    machines = []
    for name, (cls, estimator) in SERVED_FAMILIES.items():
        config = windowed_config(name, cls, estimator)
        config["dataset"]["train_end_date"] = "2020-01-02T00:00:00+00:00"
        machines.append(config)
    config = {"machines": machines, "globals": {"runtime": {"reporters": []}}}
    for model, machine in jax_local_build(yaml.safe_dump(config)):
        jax_dir = root / "jax" / "1" / machine.name
        jax_serializer.dump(model, str(jax_dir), metadata=machine.to_dict())
        with open(jax_dir / "model.pkl", "rb") as f:
            carried = _carry(pickle.load(f))
        serializer.dump(carried, str(root / "port" / "1" / machine.name),
                        tags=[t.name for t in machine.dataset.tag_list],
                        metadata=jax_serializer.load_metadata(str(jax_dir)))
    return root / "jax" / "1", root / "port" / "1"


@pytest.mark.parametrize("machine", sorted(SERVED_FAMILIES))
@pytest.mark.parametrize("route", ["prediction", "anomaly/prediction"])
def test_jax_artifact_served_by_the_port_answers_like_jax(served, machine, route):
    from test_torch_kfcv import TOL_SERVED, _bench_payload, _post, _serve

    tags = [f"{machine}-tag-{j}" for j in range(4)]
    path = f"/gordo/v0/proj/{machine}/{route}?all_columns"
    payload = _bench_payload(tags, n_rows=60)
    resp = build_app({"MODEL_COLLECTION_DIR": str(served[0])}).test_client().post(
        path, json=payload)
    server, thread, url = _serve(served[1])
    try:
        status, ours = _post(url + path, payload)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert status == resp.status_code == 200, ours
    theirs = resp.get_json()
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


def test_chip_smokes_lstm_example_machine_is_the_yaml_one():
    """chip_smoke.py carries examples/config.yaml's compressor-b as JSON
    (the card's machine has no yaml): the same dict."""
    import chip_smoke
    from test_torch_serving import REPO

    with open(f"{REPO}/examples/config.yaml") as f:
        machines = yaml.safe_load(f)["spec"]["config"]["machines"]
    assert chip_smoke.LSTM_EXAMPLE_MACHINE == next(m for m in machines
                                                   if m["name"] == "compressor-b")
    machine = chip_smoke.LSTM_EXAMPLE_MACHINE
    assert json.loads(json.dumps(machine)) == machine
