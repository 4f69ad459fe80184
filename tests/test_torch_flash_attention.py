"""
The port's flash attention (gordo_tpu_torch/ops/flash_attention.py) against
the JAX package's Pallas kernel run in interpret mode and its XLA reference.

On the CPU the port's wrapper runs the kernel's plain PyTorch twin; the
CUDA kernel itself is held against that twin in
``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.ops.attention import dot_product_attention_xla
from gordo_tpu.ops.pallas_kernels.flash_attention import _flash_forward
from gordo_tpu_torch.ops import flash_attention as fa
from gordo_tpu_torch.ops.attention import (
    dot_product_attention,
    dot_product_attention_plain,
    merge_heads,
    multihead_attention,
    split_heads,
)

# float32 on both sides; the two frameworks sum in different orders
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the plain twins on torch's calling thread alone. On a loaded
    machine, torch's CPU ``exp`` has come out up to 1.5e-4 off (relative) on
    about half of a tensor, the part one intra-op worker thread computed, in
    one fresh process of forty with two threads, and in none of forty with
    one (``scripts/torch_cpu_exp_threads.py``): enough to miss this file's
    1e-5 tolerance under a parallel test run. What the tests check does not
    depend on the thread count."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _qkv(shape, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 2, 256, 64), (1, 2, 128, 16)])
def test_forward_matches_pallas_kernel(shape, causal):
    q, k, v = _qkv(shape)
    t, dh = shape[-2:]
    ref_out, ref_lse = _flash_forward(
        *(jnp.asarray(x.reshape(-1, t, dh)) for x in (q, k, v)), causal, True
    )
    out, lse = fa.flash_attention_forward(
        *(torch.from_numpy(x) for x in (q, k, v)), causal
    )
    assert out.shape == shape and lse.shape == shape[:-1]
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref_out).reshape(shape), **TOL
    )
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(ref_lse)[..., 0].reshape(shape[:-1]), **TOL
    )
    xla = dot_product_attention_xla(*(jnp.asarray(x) for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_matches_xla_reference(causal):
    q, k, v = _qkv((2, 3, 40, 8), seed=1)
    ref = dot_product_attention_xla(*(jnp.asarray(x) for x in (q, k, v)), causal=causal)
    out = dot_product_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_lse_is_the_row_logsumexp():
    q, k, v = (torch.from_numpy(x) for x in _qkv((3, 50, 16), seed=2))
    _, lse = fa.flash_attention_forward(q, k, v, causal=True)
    s = (q @ k.transpose(-1, -2)) / 4.0
    s = s.masked_fill(~torch.ones(50, 50, dtype=torch.bool).tril(), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), **TOL)


def test_cpu_path_counts_no_launch():
    before = fa.LAUNCHES
    fa.flash_attention(*(torch.from_numpy(x) for x in _qkv((1, 16, 16))))
    assert fa.LAUNCHES == before


@pytest.mark.parametrize(
    "make, error",
    [
        (lambda q: (q, q[:, :10], q[:, :10]), ValueError),  # cross-length
        (lambda q: (q.double(),) * 3, TypeError),
        (lambda q: (q.transpose(1, 2),) * 3, ValueError),  # not contiguous
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(make, error):
    q = torch.zeros(2, 16, 16)
    with pytest.raises(error):
        fa.flash_attention_forward(*make(q))


def test_wrapper_refuses_other_devices():
    q = torch.zeros(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention_forward(q, q, q)


def test_dispatcher_routes_and_refuses_ring(monkeypatch):
    """Ring attention on one device is plain attention, as the JAX
    package's ``ring_attention`` runs ``dot_product_attention_xla`` on one
    device; over more devices it is refused until it is ported."""
    from gordo_tpu_torch.ops import attention

    qkv = _qkv((1, 2, 24, 16), seed=3)
    q, k, v = (torch.from_numpy(x) for x in qkv)
    plain = dot_product_attention(q, k, v, True, impl="xla")
    flash = dot_product_attention(q, k, v, True, impl="auto")
    torch.testing.assert_close(flash, plain, **TOL)
    ring = dot_product_attention(q, k, v, True, impl="ring")
    torch.testing.assert_close(ring, plain, rtol=0, atol=0)
    xla = dot_product_attention_xla(*(jnp.asarray(x) for x in qkv), causal=True)
    np.testing.assert_allclose(ring.numpy(), np.asarray(xla), **TOL)
    monkeypatch.setattr(attention, "_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dot_product_attention(q, k, v, impl="ring")
    with pytest.raises(ValueError):
        dot_product_attention(q, k, v, impl="bogus")


def test_heads_split_and_merge_like_jax():
    from gordo_tpu.ops.attention import merge_heads as jax_merge, split_heads as jax_split

    x = np.random.RandomState(4).randn(2, 6, 12).astype(np.float32)
    heads = split_heads(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(heads.numpy(), np.asarray(jax_split(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(merge_heads(heads).numpy(), x)
    np.testing.assert_array_equal(
        multihead_attention(*(torch.from_numpy(x),) * 3, 3, impl="xla").numpy().shape,
        x.shape,
    )
    np.testing.assert_array_equal(np.asarray(jax_merge(jnp.asarray(heads.numpy()))), x)
