"""
The Switch-MoE Transformer of the port against the JAX package on the CPU,
at small sizes (2 blocks, d_model 32, 4 heads, 4 experts of 16, windows
of 16-24), parameters made by the JAX package and carried across as
numpy:

- ``moe_capacity``, ``moe_dispatch_ffn`` and ``moe_aux_loss`` against the
  JAX functions: output, top-1 and kept set, with tokens over capacity, a
  skewed router and a capacity of 1;
- the MoE block and the whole model (output and penalty) against
  ``_apply_moe_block`` and ``apply_model`` in float32 and bf16, the router
  left float32 under bf16; gradients against ``jax.grad``;
- a padded predict, whose capacity follows the padded window count;
  ``stacked_forward`` of three machines against ``apply_model`` under a
  ``vmap``; a fused batcher call against direct predicts;
- the factory, the planner (buckets, and a ring spec sent serial), the
  JAX bucket program, a ``batch-build``, and a JAX-built artifact served
  by the port.

Every comparison of two MoE computations compares their routing first
(``chip_smoke.routing_gate``): a token whose top-1 expert differs must be
within the rounding gate (a logit gap under 1e-5 in float32, one bf16 ulp
of its top logit in bf16) and taints its window; the outputs are then
compared on the untainted windows. Tolerances: TOL (1e-5 relative) in
float32, TOL_BF16 (2e-2) in bf16, the port's bf16 tests' tolerance.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder.local_build import local_build as jax_local_build
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.models import models as jax_models
from gordo_tpu.models import spec as jax_spec
from gordo_tpu.models.factories import transformer as jax_factories
from gordo_tpu.ops import nn as jax_nn, train as jax_train
from gordo_tpu.parallel import batch_trainer as jax_bt
from gordo_tpu.server.server import build_app
from gordo_tpu_torch import serializer
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.models import models
from gordo_tpu_torch.models.factories import FACTORIES, transformer as factories
from gordo_tpu_torch.models.spec import spec_to_dict
from gordo_tpu_torch.ops import nn, train
from gordo_tpu_torch.parallel import batch_trainer as bt
from gordo_tpu_torch.serializer.from_jax import (
    estimator_from_arrays, params_from_numpy, spec_from_dataclass,
)

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
TOL_REL = {"float32": 1e-5, "bfloat16": 2e-2}  # of the largest entry
SMALL = dict(lookback_window=16, d_model=32, num_heads=4, num_experts=4, expert_dim=16,
             num_blocks=2)


@pytest.fixture(autouse=True)
def one_thread():
    """torch's CPU kernels on one thread: the 1e-5 gates stay off the
    loaded machine's thread-pool rounding."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_spec(dtype="float32", n_features=4, **kwargs):
    spec = jax_factories.moe_transformer_model(n_features, **{**SMALL, **kwargs})
    return dataclasses.replace(spec, compute_dtype=dtype)


def _jax_params(spec, seed=0):
    return [{k: np.asarray(v) for k, v in p.items()}
            for p in jax_nn.init_model_params(jax.random.PRNGKey(seed), spec)]


def _windows(n=6, lookback=16, n_features=4, seed=0):
    return np.random.RandomState(seed).rand(n, lookback, n_features).astype(np.float32)


def _layer(**kwargs):
    return jax_spec.MoEBlock(d_model=8, num_experts=4, expert_dim=6, **kwargs)


def _port(layer):
    return spec_from_dataclass(jax_spec.ModelSpec(layers=(layer,), n_features=8,
                                                  n_features_out=8)).layers[0]


def _jax_route(layer, gates):
    """The JAX dispatch's top-1 and kept set, from its own arithmetic."""
    top1 = jnp.argmax(gates, axis=-1)
    onehot = jax.nn.one_hot(top1, layer.num_experts, dtype=jnp.float32)
    pos = (jnp.cumsum(onehot, axis=0) * onehot - 1.0)[jnp.arange(len(top1)), top1]
    return np.asarray(top1), np.asarray(pos.astype(jnp.int32) < jax_nn.moe_capacity(
        layer, gates.shape[0]))


def jax_routing(spec, params, x):
    """``apply_model``'s output on x (..., T, F) and each MoE block's
    routing (numpy ``logits``, ``top1``, ``keep``, ``capacity``), walking
    the layers with the JAX package's own functions (bf16: every parameter
    but the router cast, as ``apply_model`` casts them)."""
    dtype = jnp.dtype(spec.compute_dtype)
    out, records = jnp.asarray(x).astype(dtype), []
    for layer, p in zip(spec.layers, params):
        p = {k: jnp.asarray(v) if k == "router" else jnp.asarray(v).astype(dtype)
             for k, v in p.items()}
        if isinstance(layer, jax_spec.MoEBlock):
            h = jax_nn._layer_norm(jax_nn._attention_sublayer(layer, p, out), p["ln2_scale"],
                                   p["ln2_bias"])
            logits = h.reshape(-1, h.shape[-1]).astype(jnp.float32) @ p["router"]
            top1, keep = _jax_route(layer, jax.nn.softmax(logits, axis=-1))
            records.append({"logits": np.asarray(logits), "top1": top1, "keep": keep,
                            "capacity": jax_nn.moe_capacity(layer, logits.shape[0])})
            out = jax_nn._apply_moe_block(layer, p, out)
        elif isinstance(layer, jax_spec.DenseLayer):
            out = jax_nn._apply_dense(layer, p, out)
        elif isinstance(layer, jax_spec.PositionalEncoding):
            out = jax_nn._apply_positional_encoding(layer, out)
        elif isinstance(layer, jax_spec.PoolLayer):
            out = jax_nn._apply_pool(layer, out)
    return np.asarray(out.astype(jnp.float32)), records


def _routed_compare(label, theirs, ours, lookback, dtype):
    """chip_smoke's routing-first comparison, JAX's side the reference;
    returns its report."""
    return chip_smoke.moe_compare(label, theirs, ours, lookback, dtype, TOL_REL[dtype])


# ------------------------------------------------------------ the routed FFN
@pytest.mark.parametrize("n_tokens", [1, 7, 16, 100, 4096, 524288])
@pytest.mark.parametrize("capacity_factor", [0.1, 0.5, 1.0, 1.25, 2.0])
def test_capacity_matches_jax(n_tokens, capacity_factor):
    layer = _layer(capacity_factor=capacity_factor)
    assert nn.moe_capacity(_port(layer), n_tokens) == jax_nn.moe_capacity(layer, n_tokens)


DISPATCH_CASES = {
    # (capacity factor, router scale, router skew onto expert 0, tokens)
    "default capacity": (1.25, 1.0, 0.0, 64),
    "over capacity": (0.5, 1.0, 0.0, 64),
    "skewed router": (1.25, 1.0, 12.0, 64),
    "capacity of one": (0.05, 1.0, 0.0, 40),
    "tied gates": (1.25, 0.0, 0.0, 24),
}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_dispatch_ffn_and_aux_loss_match_jax(case):
    """The routed FFN on the same tokens and gates: top-1, kept set, output
    (1e-5) and the load-balancing loss; a zero router ties every gate, and
    both sides take expert 0 (the first)."""
    capacity_factor, scale, skew, n = DISPATCH_CASES[case]
    layer = _layer(capacity_factor=capacity_factor)
    rng = np.random.RandomState(3)
    h = (rng.randn(n, 8) + 0.5).astype(np.float32)
    router = (scale * rng.randn(8, 4)).astype(np.float32)
    router[:, 0] += skew / 8  # logit 0 up by skew times the mean of h, ~0.5 skew
    gates = jax.nn.softmax(jnp.asarray(h) @ jnp.asarray(router), axis=-1)
    expert_w = {"w1": rng.randn(4, 8, 6), "b1": rng.randn(4, 6), "w2": rng.randn(4, 6, 8),
                "b2": rng.randn(4, 8)}
    expert_w = {k: v.astype(np.float32) for k, v in expert_w.items()}
    theirs = np.asarray(jax_nn.moe_dispatch_ffn(
        layer, {k: jnp.asarray(v) for k, v in expert_w.items()}, jnp.asarray(h), gates, 0, 4))
    top1, keep = _jax_route(layer, gates)
    port_layer = _port(layer)
    gates_t = torch.from_numpy(np.asarray(gates))
    route = nn.moe_route(port_layer, gates_t)
    ours = nn.moe_dispatch_ffn(port_layer, {k: torch.from_numpy(v)[None]
                                            for k, v in expert_w.items()},
                               torch.from_numpy(h)[None], nn.moe_route(port_layer, gates_t[None]))[0]
    np.testing.assert_array_equal(route.top1.numpy(), top1)
    np.testing.assert_array_equal(route.keep.numpy(), keep)
    assert route.capacity == jax_nn.moe_capacity(layer, n)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-5,
                               atol=1e-5 * np.abs(theirs).max())
    assert (ours.numpy()[~keep] == 0).all()
    aux = nn.moe_aux_loss(port_layer, gates_t, route.top1)
    assert float(aux) == pytest.approx(float(jax_nn.moe_aux_loss(layer, gates)), rel=1e-6)
    if case == "capacity of one":
        assert route.capacity == 1 and keep.sum() == len(set(top1.tolist()))
    if case in ("over capacity", "skewed router", "capacity of one", "tied gates"):
        assert (~keep).sum() > 0  # tokens over capacity pass through
    if case == "tied gates":
        assert (top1 == 0).all()
    if case == "skewed router":
        assert np.bincount(top1, minlength=4)[0] > n // 2


def test_init_draws_the_jax_layout():
    """``init_model_params`` of an MoE spec: the JAX package's names and
    shapes (experts stacked on a leading axis), glorot bounds from each
    expert's own fans, zero biases."""
    jspec = _jax_spec()
    ours = nn.init_model_params(spec_from_dataclass(jspec), torch.Generator().manual_seed(0))
    theirs = _jax_params(jspec)
    assert [sorted(p) for p in ours] == [sorted(p) for p in theirs]
    for p, q in zip(ours, theirs):
        for name in p:
            assert tuple(p[name].shape) == q[name].shape, name
            if name in ("router", "w1", "w2"):
                limit = np.sqrt(6.0 / sum(p[name].shape[-2:]))
                assert p[name].abs().max() <= limit and p[name].std() > limit / 3
            elif name in ("b1", "b2"):
                assert not p[name].any()


# ------------------------------------------------------------ block and model
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_matches_jax(dtype):
    """One MoE block (attention, router, experts, aux) on (6, 16, 32)."""
    jspec = _jax_spec(dtype, capacity_factor=0.5)
    layer, params = jspec.layers[2], _jax_params(jspec)[2]
    x = np.random.RandomState(4).randn(6, 16, 32).astype(np.float32)
    cd = jnp.dtype(dtype)
    jp = {k: jnp.asarray(v) if k == "router" else jnp.asarray(v).astype(cd)
          for k, v in params.items()}
    theirs, jax_aux = jax_nn._apply_moe_block(layer, jp, jnp.asarray(x).astype(cd),
                                              return_aux=True)
    tp = {k: torch.from_numpy(v) if k == "router" else torch.from_numpy(v).to(
        nn.COMPUTE_DTYPES[dtype]) for k, v in params.items()}
    routing = []
    ours, aux = nn._apply_moe_block(_port(layer), tp, torch.from_numpy(x).to(
        nn.COMPUTE_DTYPES[dtype]), stacked=False, with_aux=True, routing=routing)
    assert ours.dtype == nn.COMPUTE_DTYPES[dtype] and routing[0]["logits"].dtype == torch.float32
    assert (~routing[0]["keep"]).sum() > 0
    tol = TOL if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs.astype(jnp.float32)),
                               **tol)
    assert float(aux) == pytest.approx(float(jax_aux), rel=tol["rtol"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_model_matches_apply_model(dtype, capacity_factor, monkeypatch):
    """The whole model's output and penalty against ``apply_model``,
    routing first; under bf16 each block gets a float32 router beside its
    bf16 experts."""
    jspec = _jax_spec(dtype, capacity_factor=capacity_factor)
    params = _jax_params(jspec, seed=5)
    x = _windows(8, seed=6)
    theirs = jax_routing(jspec, params, x)
    _, jax_penalty = jax_nn.apply_model(jspec, params, jnp.asarray(x))
    np.testing.assert_array_equal(theirs[0], np.asarray(
        jax_nn.apply_model(jspec, params, jnp.asarray(x))[0]))
    dtypes = []
    apply_block = nn._apply_moe_block

    def recorded(layer, p, *args, **kwargs):
        dtypes.append((p["router"].dtype, p["w1"].dtype, p["wq"].dtype))
        return apply_block(layer, p, *args, **kwargs)

    monkeypatch.setattr(nn, "_apply_moe_block", recorded)
    model = nn.TransformerModel(spec_from_dataclass(jspec), params, torch.device("cpu"))
    with torch.no_grad():
        out, routing = model.forward_with_routing(torch.from_numpy(x))
        _, penalty = model.forward_with_penalty(torch.from_numpy(x))
    cd = nn.COMPUTE_DTYPES[dtype]
    assert dtypes and all(d == (torch.float32, cd, cd) for d in dtypes)
    _routed_compare(f"{dtype} model", theirs, (out.numpy(), chip_smoke._routing_numpy(routing)),
                    16, dtype)
    assert float(penalty) == pytest.approx(float(jax_penalty), rel=TOL_REL[dtype])
    assert float(penalty) > 0.0  # the aux term, at aux_loss_weight 0.01
    if capacity_factor < 1:
        assert sum(int((~r["keep"]).sum()) for r in routing) > 0


def test_gradients_match_jax_grad():
    """``jax.grad`` of the JAX loss (weighted MSE plus the aux penalty over
    the whole padded batch) against autograd of the port's, on one batch
    with tokens over capacity and two zero-weighted padding samples: every
    parameter, the router included, within 1e-5 of its gradient's largest
    entry (``bk`` left out: its true gradient is 0, rounding noise)."""
    jspec = _jax_spec(capacity_factor=0.5)
    params = _jax_params(jspec, seed=7)
    x, y = _windows(8, seed=8), np.random.RandomState(9).rand(8, 4).astype(np.float32)
    w = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    jax_grads = jax.grad(lambda p: jax_train._loss_terms(jspec, p, jnp.asarray(x),
                                                         jnp.asarray(y), jnp.asarray(w)))(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params])
    spec = spec_from_dataclass(jspec)
    model = nn.TransformerModel(spec, params, torch.device("cpu"))
    with torch.no_grad():
        _, routing = model.forward_with_routing(torch.from_numpy(x))
    assert sum(int((~r["keep"]).sum()) for r in routing) > 0
    _routed_compare("gradient batch", jax_routing(jspec, params, x),
                    (model(torch.from_numpy(x)).detach().numpy(),
                     chip_smoke._routing_numpy(routing)), 16, "float32")
    loss = train._loss_terms(spec, model, torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(w))
    loss.backward()
    checked = 0
    for layer, (ours, theirs) in enumerate(zip(model.layer_params, jax_grads)):
        for name, value in theirs.items():
            if name == "bk":
                continue
            want = np.asarray(value)
            np.testing.assert_allclose(ours[name].grad.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(), err_msg=f"{layer}/{name}")
            checked += name == "router"
    assert checked == 2


# ------------------------------------------------------------ predict, stacked, fused
def _pair(seed=0, **kwargs):
    """(port estimator, JAX estimator) on the same JAX-initialised params."""
    theirs = jax_models.TransformerAutoEncoder(kind="moe_transformer_model",
                                               **{**SMALL, **kwargs})
    spec = theirs.build_spec(4, 4)
    theirs.spec_, theirs.params_ = spec, _jax_params(spec, seed)
    ours = estimator_from_arrays(spec_from_dataclass(spec), theirs.params_,
                                 "TransformerAutoEncoder", "moe_transformer_model",
                                 {**SMALL, **kwargs}, device="cpu")
    return ours, theirs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_predict_matches_jax(dtype):
    """37 rows give 22 windows, padded to 32 as both packages pad a predict:
    the capacity counts the 32 windows' tokens, and the real windows'
    outputs match JAX's predict, routing first."""
    ours, theirs = _pair(seed=10, capacity_factor=0.5, compute_dtype=dtype)
    X = np.random.RandomState(11).rand(37, 4).astype(np.float32)
    got, want = ours.predict(X), np.asarray(theirs.predict(X))
    assert got.shape == want.shape == (22, 4)
    X_pad, n_pad, n_keep = jax_train.pad_for_predict(theirs.spec_, X)
    assert (n_pad, n_keep) == (32, 22)
    windows = X_pad[np.arange(n_pad)[:, None] + np.arange(16)]
    ref_out, ref_routing = jax_routing(theirs.spec_, theirs.params_, windows)
    # the walk runs op by op, the predict as one jitted program: rounding apart
    np.testing.assert_allclose(ref_out[:n_keep], want, **(TOL if dtype == "float32" else TOL_BF16))
    direct = chip_smoke._moe_direct(ours.module_, X, "cpu")
    np.testing.assert_array_equal(direct[0], got)
    layer = ours.spec_.layers[2]
    assert [r["capacity"] for r in direct[1]] == [nn.moe_capacity(layer, 32 * 16)] * 2
    assert nn.moe_capacity(layer, 32 * 16) != nn.moe_capacity(layer, 22 * 16)
    _routed_compare(f"{dtype} padded predict", (ref_out[:n_keep], ref_routing), direct, 16,
                    dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_forward_matches_vmapped_apply_model(dtype):
    """Three machines of one spec with their own parameters (and so their
    own routing) as one ``stacked_forward``: each machine's capacity,
    routing and penalty its own, against ``apply_model`` under ``vmap``."""
    jspec = _jax_spec(dtype, capacity_factor=0.5)
    per_machine = [_jax_params(jspec, seed=20 + m) for m in range(3)]
    x = np.stack([_windows(6, seed=30 + m) for m in range(3)])
    stacked = nn.stack_params(per_machine)
    vmapped, jax_penalty = jax.vmap(lambda p, xm: jax_nn.apply_model(jspec, p, xm))(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in stacked], jnp.asarray(x))
    spec = spec_from_dataclass(jspec)
    routing = []
    with torch.no_grad():
        out = nn.stacked_forward(spec, [{k: torch.from_numpy(v) for k, v in p.items()}
                                        for p in stacked], torch.from_numpy(x), routing)
        model = nn.StackedTransformerModel(spec, stacked, torch.device("cpu"))
        _, penalty = model.forward_with_penalty(torch.from_numpy(x))
    assert [r["top1"].shape for r in routing] == [(3, 6 * 16)] * 2
    assert {r["capacity"] for r in routing} == {nn.moe_capacity(spec.layers[2], 6 * 16)}
    assert len({tuple(r["top1"][m].tolist()) for r in routing[:1] for m in range(3)}) == 3
    for m in range(3):
        theirs = jax_routing(jspec, per_machine[m], x[m])
        np.testing.assert_array_equal(theirs[0], np.asarray(vmapped[m]))
        _routed_compare(f"{dtype} machine {m}", theirs,
                        (out[m].numpy(), chip_smoke._routing_numpy(routing, m)), 16, dtype)
    np.testing.assert_allclose(penalty.numpy(), np.asarray(jax_penalty), rtol=TOL_REL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batcher_fuses_moe_predicts_like_direct(dtype, monkeypatch):
    """Concurrent predicts of three MoE models through the process batcher,
    forced on with a collection window: one fused call whose lanes keep
    their own capacity, each answer the fused call recomputed with its
    routing, and each lane against the model's direct predict routing
    first."""
    from gordo_tpu_torch.server import batcher
    from test_torch_batcher import _concurrently

    estimators = [_pair(seed=40 + s, capacity_factor=0.5, compute_dtype=dtype)[0]
                  for s in range(3)]
    inputs = [np.random.RandomState(50 + i).rand(rows, 4).astype(np.float32)
              for i, rows in enumerate((50, 60, 70))]  # 35-55 windows, padded to 64
    monkeypatch.setenv("GORDO_TPU_SERVING_BATCH", "1")
    monkeypatch.setenv("GORDO_TPU_BATCH_WINDOW_MS", "300")
    batcher.reset_batcher()
    try:
        fused = _concurrently(lambda i: estimators[i].predict(inputs[i]), len(estimators))
        stats = dict(batcher.peek_batcher().stats)
    finally:
        batcher.reset_batcher()
    assert stats["items"] == 3 and stats["device_calls"] == 1
    spec = estimators[0].spec_
    lanes = chip_smoke._moe_fused(spec, [e.module_ for e in estimators], inputs, "cpu")
    for est, X, answer, lane in zip(estimators, inputs, fused, lanes):
        np.testing.assert_array_equal(answer, lane[0])
        assert [r["capacity"] for r in lane[1]] == [nn.moe_capacity(spec.layers[2], 64 * 16)] * 2
        direct = chip_smoke._moe_direct(est.module_, X, "cpu")
        report = chip_smoke.moe_compare(f"{dtype} lane", direct, lane, 16, dtype,
                                        TOL_REL[dtype])
        assert report["windows_compared"] == len(answer)


# ------------------------------------------------------------ the routing gate
def test_routing_gate_counts_rounding_flips_and_refuses_others():
    """A flip under the gap taints its window and the capacity shift it
    causes later in its expert; a flip over the gap, or a shift with no
    flip before it, fails."""
    logits = np.array([[1.0, 0.0], [0.5, 0.5 - 1e-6], [1.0, 0.0], [1.0, 0.0]], np.float32)
    ref = [{"logits": logits, "top1": np.array([0, 0, 0, 0]),
            "keep": np.array([True, True, False, False]), "capacity": 2}]
    got = [{"logits": logits, "top1": np.array([0, 1, 0, 0]),
            "keep": np.array([True, True, True, False]), "capacity": 2}]
    tainted, report = chip_smoke.routing_gate(ref, got, 2, (1e-5, 0.0))
    assert tainted.tolist() == [True, True] and report["flips"] == [1]
    assert report["capacity_shifts"] == [1]
    with pytest.raises(AssertionError, match="above the rounding gate"):
        chip_smoke.routing_gate(ref, got, 2, (1e-7, 0.0))
    shifted = [dict(ref[0], keep=np.array([True, True, True, False]))]
    with pytest.raises(AssertionError, match="no earlier flip"):
        chip_smoke.routing_gate(ref, shifted, 2, (1e-5, 0.0))


# ------------------------------------------------------------ factory, planner
FACTORY_CASES = [
    {},
    dict(lookback_window=512, d_model=256, num_heads=4, num_experts=8, expert_dim=512,
         capacity_factor=1.25, num_blocks=2, causal=True, pool="last"),
    dict(SMALL, func="gelu", pool="mean", attention="flash", optimizer="SGD",
         optimizer_kwargs={"learning_rate": 0.1}, compile_kwargs={"loss": "mae"}),
]


@pytest.mark.parametrize("kwargs", FACTORY_CASES, ids=["defaults", "moe-ae-512", "options"])
@pytest.mark.parametrize("n_features_out", [None, 3])
def test_factory_spec_equals_jax(kwargs, n_features_out):
    ours = factories.moe_transformer_model(8, n_features_out, **kwargs)
    theirs = jax_factories.moe_transformer_model(8, n_features_out, **kwargs)
    assert spec_to_dict(ours) == spec_to_dict(theirs)
    assert ours == spec_from_dataclass(theirs)


@pytest.mark.parametrize("kwargs", [dict(num_blocks=0), dict(lookback_window=1),
                                    dict(num_experts=1), dict(attention="sparse")])
def test_factory_refuses_like_jax(kwargs):
    with pytest.raises(ValueError) as theirs:
        jax_factories.moe_transformer_model(4, **kwargs)
    with pytest.raises(ValueError, match=str(theirs.value).split(",")[0]):
        factories.moe_transformer_model(4, **kwargs)


@pytest.mark.parametrize("estimator", ["TransformerAutoEncoder", "TransformerForecast"])
def test_factory_is_filed_under_the_transformer_estimators(estimator):
    assert FACTORIES[estimator]["moe_transformer_model"] is factories.moe_transformer_model
    spec = getattr(models, estimator)("moe_transformer_model", **SMALL).build_spec(4, 4)
    jax_built = getattr(jax_models, estimator)(kind="moe_transformer_model", **SMALL)
    assert spec == spec_from_dataclass(jax_built.build_spec(4, 4))


def test_expert_parallel_is_refused_with_its_item():
    estimator = models.TransformerAutoEncoder("moe_transformer_model", expert_parallel=2, **SMALL)
    with pytest.raises(NotImplementedError,
                       match="expert_parallel is not ported yet: see the ring attention / "
                             "parallel axes item of ROADMAP.md queue A"):
        estimator.build_spec(4, 4)


MOE_ESTIMATOR = {"kind": "moe_transformer_model", **SMALL, "capacity_factor": 0.5,
                 "epochs": 1, "batch_size": 16}


def _config(name, **estimator):
    from test_torch_fleet import machine_config

    return machine_config(name, estimator={**MOE_ESTIMATOR, **estimator})


def test_fleet_plans_moe_machines_like_jax():
    from test_torch_fleet import _machines

    ours, theirs = _machines([_config("m")])
    plan, jax_plan = bt._plan_machine(ours[0]), jax_bt._plan_machine(theirs[0])
    assert plan is not None and jax_plan is not None
    assert plan.spec == spec_from_dataclass(jax_plan.spec)
    for key in ("scale_x", "wrap_anomaly", "kfcv", "epochs", "batch_size", "shuffle",
                "n_splits", "cv"):
        assert getattr(plan, key) == getattr(jax_plan, key), key


def test_moe_ring_spec_plans_serial_like_jax():
    """Ring attention on an MoE block sends the machine to the serial
    builder, as the JAX planner's ``spec_may_use_ring`` reads every layer
    with an ``attention_impl``."""
    from test_torch_fleet import _machines

    ours, theirs = _machines([_config("m", attention="ring")])
    assert bt._plan_machine(ours[0]) is None and jax_bt._plan_machine(theirs[0]) is None


def test_bucket_program_matches_jax():
    """Two MoE machines (tokens over capacity) through the JAX bucket
    program and the port's, on the JAX program's draws: losses (1e-4, as
    the fleet tests hold them), fold predictions and parameters."""
    from test_torch_fleet import _assert_same_params, _fleet_data, jax_draws

    jax_plan = jax_bt._plan_machine(JaxMachine.from_config(_config("m"), "p"))
    spec = spec_from_dataclass(jax_plan.spec)
    X = _fleet_data(2)
    seeds = [jax_bt._machine_seed(JaxMachine.from_config(_config(f"m-{m}"), "p"))
             for m in range(2)]
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
    for ours, theirs in zip(preds, jax_preds):
        assert ours.shape == theirs.shape == (2, 72 - 15, 4)
        np.testing.assert_allclose(ours, np.asarray(theirs), atol=1e-4)
    for m in range(2):
        _assert_same_params(spec, model.machine_params(m),
                            [{k: np.asarray(v)[m] for k, v in p.items()} for p in jax_params],
                            1e-4)


def test_batch_build_buckets_moe_machines_and_the_builder_builds_one(tmp_path):
    """Two MoE machines and a Transformer machine in one fleet: the MoE
    pair in one stacked program, none built serially, each artifact
    predicting as built; the same MoE machine through ``ModelBuilder``
    builds with finite thresholds and its offset."""
    from gordo_tpu_torch.builder import ModelBuilder
    from test_torch_fleet import machine_config

    configs = [_config(f"moe-{m}") for m in range(2)] + [machine_config("dense")]
    buckets = []
    run_bucket = bt.run_bucket

    def recorded(spec, X, *args, **kwargs):
        buckets.append((spec, len(X)))
        return run_bucket(spec, X, *args, **kwargs)

    original, bt.run_bucket = bt.run_bucket, recorded
    try:
        builder = bt.BatchedModelBuilder([Machine.from_config(c, "p") for c in configs],
                                         device="cpu", output_dir=str(tmp_path / "fleet"))
        built = builder.build()
    finally:
        bt.run_bucket = original
    assert builder.serial_built == [] and not builder.quarantine_records
    assert sorted(n for _, n in buckets) == [1, 2]
    X = np.random.RandomState(60).rand(40, 4)
    for model, machine in built:
        again = serializer.load(str(tmp_path / "fleet" / machine.name), device="cpu")
        np.testing.assert_allclose(again.predict(X), model.predict(X), rtol=1e-6, atol=1e-6)
        assert np.isfinite(model.aggregate_threshold_)
    np.random.seed(0)
    model, machine = ModelBuilder(Machine.from_config(_config("serial"), "p"),
                                  device="cpu").build()
    assert machine.metadata.build_metadata.model.model_offset == 15
    assert np.isfinite(model.aggregate_threshold_) and model.predict(X).shape == (25, 4)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(JAX collection, port collection): an MoE machine built by the JAX
    package (1 day), carried into a port artifact."""
    from test_torch_kfcv import _carry

    root = tmp_path_factory.mktemp("moe")
    config = _config("moe")
    config["dataset"]["train_end_date"] = "2020-01-02T00:00:00+00:00"
    for model, machine in jax_local_build(yaml.safe_dump({
            "machines": [config], "globals": {"runtime": {"reporters": []}}})):
        jax_dir = root / "jax" / "1" / machine.name
        jax_serializer.dump(model, str(jax_dir), metadata=machine.to_dict())
        with open(jax_dir / "model.pkl", "rb") as f:
            carried = _carry(pickle.load(f))
        serializer.dump(carried, str(root / "port" / "1" / machine.name),
                        tags=[t.name for t in machine.dataset.tag_list],
                        metadata=jax_serializer.load_metadata(str(jax_dir)))
    return root / "jax" / "1", root / "port" / "1"


@pytest.mark.parametrize("route", ["prediction", "anomaly/prediction"])
def test_jax_artifact_served_by_the_port_answers_like_jax(served, route):
    """The JAX-built MoE artifact through ``build_app`` and through the
    port's server: the same response structure, values within TOL_SERVED."""
    from test_torch_kfcv import TOL_SERVED, _bench_payload, _post, _serve

    tags = [f"moe-tag-{j}" for j in range(4)]
    path = f"/gordo/v0/proj/moe/{route}?all_columns"
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
    assert sorted(ours) == sorted(theirs) and sorted(ours["data"]) == sorted(theirs["data"])
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


def test_chip_smokes_moe_configurations_are_the_jax_factorys():
    """chip_smoke.py's moe-transformer-ae-512 is transformer-ae-512 with
    Switch experts, and its moe_model_144 the JAX factory at its defaults."""
    big = models.TransformerAutoEncoder(**chip_smoke.MOE_CONFIG).build_spec(8, 8)
    assert big == spec_from_dataclass(jax_factories.moe_transformer_model(
        8, lookback_window=512, d_model=256, num_heads=4, num_experts=8, expert_dim=512,
        capacity_factor=1.25))
    small = models.TransformerAutoEncoder(**chip_smoke.MOE144_CONFIG).build_spec(8, 8)
    assert small == spec_from_dataclass(jax_factories.moe_transformer_model(8))
    assert small.layers[2].d_model // small.layers[2].num_heads == 16
