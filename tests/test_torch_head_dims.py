"""
A Transformer whose head dim is one of those the flash kernels take through
a padded class (d_model 192 over 2 heads: dh 96), against the JAX model on
the same parameters: the forward and one training step's gradients, and
the port's dispatcher sending its attention to the flash kernels' wrapper,
not to the plain path.

The JAX model names ``attention="flash"``, so on the CPU it runs the Pallas
kernels in interpret mode; the port's model names ``"auto"``, so its
dispatcher decides, and on the CPU the wrapper runs the kernels' plain
twin (the CUDA kernels are held against that twin on the card in
``tests/test_torch_kernels_cuda.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.models.factories import transformer_model as jax_transformer_model
from gordo_tpu.ops import nn as jax_nn
from gordo_tpu.ops import train as jax_train
from gordo_tpu_torch.models.models import TransformerAutoEncoder
from gordo_tpu_torch.models.spec import TransformerBlock
from gordo_tpu_torch.ops import attention, train
from gordo_tpu_torch.serializer.from_jax import params_from_numpy, spec_from_dataclass

WIDTH = dict(lookback_window=32, d_model=192, num_heads=2, ff_dim=64, causal=True,
             pool="last")
N_TAGS = 4
BATCH = 6
# float32 on both sides, sums in another order: the forward as
# tests/test_torch_nn.py holds the whole model; each gradient relative to
# its largest entry as the JAX package holds its flash kernel's gradients
# (tests/gordo_tpu/test_attention_models.py)
TOL_OUT = dict(atol=1e-5, rtol=1e-5)
TOL_GRAD_REL = 1e-4


def _setup(num_blocks: int):
    jax_spec = jax_transformer_model(n_features=N_TAGS, num_blocks=num_blocks, **WIDTH,
                                     attention="flash")
    layers = [{k: np.asarray(v) for k, v in p.items()}
              for p in jax_nn.init_model_params(jax.random.PRNGKey(num_blocks), jax_spec)]
    estimator = TransformerAutoEncoder(kind="transformer_model", num_blocks=num_blocks,
                                       **WIDTH, attention="auto", device="cpu")
    spec = estimator.build_spec(N_TAGS, N_TAGS)
    # the port's own spec of this width is the JAX one, but for its attention
    as_flash = dataclasses.replace(spec, layers=tuple(
        dataclasses.replace(layer, attention_impl="flash")
        if isinstance(layer, TransformerBlock) else layer for layer in spec.layers))
    assert as_flash == spec_from_dataclass(jax_spec)
    assert {layer.d_model // layer.num_heads for layer in spec.layers
            if isinstance(layer, TransformerBlock)} == {96}
    estimator.load_params(spec, params_from_numpy(spec, layers), "cpu")
    rng = np.random.RandomState(num_blocks)
    xb = rng.rand(BATCH, WIDTH["lookback_window"], N_TAGS).astype(np.float32)
    yb = rng.rand(BATCH, N_TAGS).astype(np.float32)
    return jax_spec, layers, estimator.module_, xb, yb


@pytest.fixture
def dispatch_counts(monkeypatch):
    """Calls of the flash wrapper and of the plain path by the dispatcher."""
    counts = {"flash": 0, "plain": 0}
    for name, key in (("flash_attention", "flash"), ("dot_product_attention_plain", "plain")):
        fn = getattr(attention, name)

        def counted(*args, _fn=fn, _key=key, **kwargs):
            counts[_key] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(attention, name, counted)
    return counts


@pytest.mark.parametrize("num_blocks", [1, 2])
def test_dh96_model_matches_jax_through_the_flash_path(num_blocks, dispatch_counts):
    jax_spec, layers, model, xb, yb = _setup(num_blocks)
    params = [{k: jnp.asarray(v) for k, v in p.items()} for p in layers]
    ref, _ = jax_nn.apply_model(jax_spec, params, jnp.asarray(xb))
    out = model(torch.from_numpy(xb)).detach()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL_OUT)
    assert dispatch_counts == {"flash": num_blocks, "plain": 0}

    # one training step's gradients: the batch loss of both trainers
    wb = np.ones(BATCH, np.float32)
    jax_grads = jax.grad(lambda p: jax_train._loss_terms(
        jax_spec, p, jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(wb)))(params)
    names = [name for name, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(
        train._loss_terms(model.spec, model, torch.from_numpy(xb), torch.from_numpy(yb),
                          torch.from_numpy(wb)), list(model.parameters()))))
    assert dispatch_counts == {"flash": 2 * num_blocks, "plain": 0}
    checked = 0
    for i, layer_grads in enumerate(jax_grads):
        if not layer_grads:  # a layer without parameters
            continue
        scale = max(float(np.abs(np.asarray(g)).max()) for g in layer_grads.values())
        for key, want in layer_grads.items():
            want = np.asarray(want)
            got = grads[next(n for n in names if n.endswith(f"{i}.{key}"))].numpy()
            assert got.shape == want.shape, (i, key)
            if key == "bk":
                # its true gradient is exactly 0 (a per-query shift of the
                # scores): rounding noise in both, held against the layer's
                # largest gradient
                assert np.abs(got - want).max() <= TOL_GRAD_REL * scale, (i, key)
            else:
                err = np.abs(got - want).max() / np.abs(want).max()
                assert err <= TOL_GRAD_REL, (i, key, err)
            checked += 1
    assert checked == len(names)
