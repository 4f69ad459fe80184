"""
The port's layers and model (gordo_tpu_torch/ops/nn.py, ops/predict.py)
against the JAX package's ``gordo_tpu.ops.nn`` on the same inputs and the
same parameters, carried across as numpy by ``params_from_numpy``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.models.factories import transformer_model as jax_transformer_model
from gordo_tpu.models import spec as jax_spec
from gordo_tpu.ops import nn as jax_nn
from gordo_tpu.ops import train as jax_train
from gordo_tpu_torch.models import spec as port_spec
from gordo_tpu_torch.models.factories import transformer_model
from gordo_tpu_torch.ops import nn
from gordo_tpu_torch.ops.predict import pad_for_predict, predict_fn
from gordo_tpu_torch.serializer.from_jax import params_from_numpy, spec_from_dataclass

# float32 on both sides; the two frameworks sum in different orders
TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(n_features=4, lookback_window=16, d_model=32, num_heads=2, ff_dim=64,
             num_blocks=2)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_params(spec, seed=0):
    params = jax_nn.init_model_params(jax.random.PRNGKey(seed), spec)
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _to_torch(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


@pytest.mark.parametrize("activation", sorted(jax_nn.ACTIVATIONS))
def test_dense_matches_jax(activation):
    layer = jax_spec.DenseLayer(units=5, activation=activation)
    p = {"kernel": _rand(7, 5, seed=1), "bias": _rand(5, seed=2)}
    x = _rand(3, 7)
    ref = jax_nn._apply_dense(layer, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    out = nn._apply_dense(port_spec.DenseLayer(5, activation), _to_torch(p), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_layer_norm_matches_jax():
    x, scale, bias = _rand(2, 5, 32), _rand(32, seed=1), _rand(32, seed=2)
    ref = jax_nn._layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    out = nn._layer_norm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("d", [1, 7, 32])
def test_positional_encoding_matches_jax(d):
    x = _rand(2, 40, d)
    ref = jax_nn._apply_positional_encoding(jax_spec.PositionalEncoding(), jnp.asarray(x))
    out = nn._apply_positional_encoding(port_spec.PositionalEncoding(), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mode", ["last", "mean", "max"])
def test_pool_matches_jax(mode):
    x = _rand(3, 9, 4)
    ref = jax_nn._apply_pool(jax_spec.PoolLayer(mode), jnp.asarray(x))
    out = nn._apply_pool(port_spec.PoolLayer(mode), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("causal", [False, True])
def test_transformer_block_matches_jax(impl, causal):
    kw = dict(d_model=32, num_heads=2, ff_dim=64, causal=causal, attention_impl=impl,
              activation="gelu")
    jax_layer = jax_spec.TransformerBlock(**kw)
    p = {k: np.asarray(v) for k, v in
         jax_nn.init_transformer_block(jax.random.PRNGKey(3), 32, jax_layer).items()}
    # non-trivial norms and biases, so every parameter is exercised
    for name in ("ln1_bias", "ln2_bias", "bq", "bk", "bv", "bo", "b_ff1", "b_ff2"):
        p[name] = 0.1 * _rand(*p[name].shape, seed=len(name))
    x = _rand(2, 16, 32, seed=4)
    ref = jax_nn._apply_transformer_block(
        jax_layer, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)
    )
    out = nn._apply_transformer_block(
        port_spec.TransformerBlock(**kw), _to_torch(p), torch.from_numpy(x)
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("lookback", [16, 256])
def test_whole_model_matches_apply_model(lookback):
    spec = jax_transformer_model(**{**SMALL, "lookback_window": lookback}, attention="flash")
    params = _jax_params(spec, seed=lookback)
    x = _rand(3, lookback, 4, seed=5)
    ref, _ = jax_nn.apply_model(spec, [{k: jnp.asarray(v) for k, v in p.items()}
                                       for p in params], jnp.asarray(x))
    port = spec_from_dataclass(spec)
    model = nn.TransformerModel(port, params_from_numpy(port, params), torch.device("cpu"))
    # the parameters are trainable, so the output carries a graph
    out = model(torch.from_numpy(x)).detach()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_predict_pads_and_windows_like_jax():
    spec = jax_transformer_model(**SMALL)
    params = _jax_params(spec, seed=7)
    X = _rand(45, 4, seed=8)  # 30 windows, padded to 32
    ref = jax_train.predict_fn(spec)(params, X)
    port = spec_from_dataclass(spec)
    model = nn.TransformerModel(port, params_from_numpy(port, params), torch.device("cpu"))
    out = predict_fn(model)(X)
    assert out.shape == (30, 4)
    np.testing.assert_allclose(out, ref, **TOL)
    for a, b in zip(pad_for_predict(port, X), jax_train.pad_for_predict(spec, X)):
        np.testing.assert_array_equal(a, b)


def test_factory_and_spec_round_trip_match_jax():
    spec = transformer_model(**SMALL)
    assert spec_from_dataclass(jax_transformer_model(**SMALL)) == spec
    assert port_spec.spec_from_dict(port_spec.spec_to_dict(spec)) == spec
    assert spec.output_offset == 15


def test_init_matches_jax_shapes_and_bounds():
    spec = transformer_model(**SMALL)
    ours = nn.init_model_params(spec, torch.Generator().manual_seed(0))
    theirs = _jax_params(jax_transformer_model(**SMALL))
    assert [sorted(p) for p in ours] == [sorted(p) for p in theirs]
    for p, q in zip(ours, theirs):
        for name in p:
            assert tuple(p[name].shape) == q[name].shape
            if p[name].ndim == 2:
                limit = np.sqrt(6.0 / sum(p[name].shape))
                assert p[name].abs().max() <= limit
                assert p[name].std() > limit / 3  # uniform: std = limit / sqrt(3)
            else:
                np.testing.assert_array_equal(p[name].numpy(), q[name])


def test_unported_layers_and_dtypes_raise():
    # the MoE block is ported (tests/test_torch_moe.py); bfloat16 and
    # float16 are ported (tests/test_torch_bf16.py, tests/test_torch_float16.py)
    # but for an LSTM layer at float16; float64 is no compute dtype
    from gordo_tpu_torch.models.factories.lstm_autoencoder import lstm_model

    lstm16 = dataclasses.replace(lstm_model(4, lookback_window=8), compute_dtype="float16")
    with pytest.raises(NotImplementedError, match="A12's LSTM part in ROADMAP"):
        nn.TransformerModel(lstm16, nn.init_model_params(lstm16), torch.device("cpu"))
    fp64 = dataclasses.replace(transformer_model(**SMALL), compute_dtype="float64")
    with pytest.raises(NotImplementedError, match="'float64' is not ported"):
        nn.TransformerModel(fp64, nn.init_model_params(fp64), torch.device("cpu"))
