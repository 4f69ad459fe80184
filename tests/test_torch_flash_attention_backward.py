"""
The port's flash-attention backward (gordo_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas backward kernels run in interpret mode, and
against PyTorch's own autograd through the plain attention.

On the CPU the wrapper runs the kernels' plain PyTorch twin; the CUDA
kernels themselves are held against that twin in
``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.ops.pallas_kernels.flash_attention import _flash_backward, _flash_forward
from gordo_tpu_torch.ops import flash_attention as fa
from gordo_tpu_torch.ops.attention import (
    _flash_ok,
    dot_product_attention,
    dot_product_attention_plain,
)

# float32 on both sides, sums in another order: the largest error of each
# gradient relative to that gradient's largest entry
TOL_PLAIN = 1e-5
# the autograd Function against the same references, as the JAX package's
# own gradient test holds its flash kernel (tests/gordo_tpu/test_attention_models.py)
TOL_FUNCTION = 1e-4
SHAPES = [(2, 128, 16), (1, 64, 32)]


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def _rel_err(ours, theirs) -> float:
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    return float(np.abs(ours - theirs).max() / np.abs(theirs).max())


def _pallas_grads(q, k, v, do, causal):
    """(dq, dk, dv) of the Pallas kernels in interpret mode, with the
    forward's output and its lane-0 logsumexp (BH, T)."""
    qj, kj, vj, doj = (jnp.asarray(x) for x in (q, k, v, do))
    out, lse = _flash_forward(qj, kj, vj, causal, True)
    grads = _flash_backward(qj, kj, vj, out, lse, doj, causal, True)
    return [np.asarray(g) for g in grads], np.asarray(out), np.asarray(lse)[..., 0]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_pallas_kernels_and_autograd(shape, causal):
    q, k, v, do = _inputs(shape)
    ref, out, lse = _pallas_grads(q, k, v, do, causal)
    grads = fa.flash_attention_backward_plain(
        *(torch.from_numpy(x) for x in (q, k, v, out, lse, do)), causal
    )
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    auto = torch.autograd.grad(
        dot_product_attention_plain(qt, kt, vt, causal), (qt, kt, vt), torch.from_numpy(do)
    )
    for name, g, r, a in zip("qkv", grads, ref, auto):
        assert _rel_err(g.numpy(), r) <= TOL_PLAIN, name
        assert _rel_err(g.numpy(), a.numpy()) <= TOL_PLAIN, name


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_autograd_function_gradients_match_pallas_kernels(shape, causal):
    q, k, v, do = _inputs(shape, seed=1)
    ref, _, _ = _pallas_grads(q, k, v, do, causal)
    # through split heads, as the model calls it: (B, H, T, dh)
    qt, kt, vt = (torch.from_numpy(x.reshape(1, *x.shape)).requires_grad_()
                  for x in (q, k, v))
    out = fa.FlashAttention.apply(qt, kt, vt, causal)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do[None]))
    for name, g, r in zip("qkv", grads, ref):
        assert _rel_err(g[0].numpy(), r) <= TOL_FUNCTION, name


def test_cpu_backward_counts_no_launch_and_checks_lse():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs((2, 16, 16), seed=2))
    o, lse = fa.flash_attention_forward(q, k, v, True)
    before = (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    dq, dk, dv = fa.flash_attention_backward(q, k, v, o, lse, do, True)
    assert dq.shape == dk.shape == dv.shape == q.shape
    assert (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) == before
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_backward(q, k, v, o, lse[:, :-1], do, True)
    with pytest.raises(ValueError, match="one shape"):
        fa.flash_attention_backward(q, k, v, o, lse, do[:, :-1], True)


def test_inference_mode_runs_the_forward_only():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs((1, 2, 16, 16), seed=3))
    with torch.inference_mode():
        out = fa.flash_attention(q, k, v, True)
    assert not out.requires_grad
    torch.testing.assert_close(out, dot_product_attention_plain(q, k, v, True))


@pytest.mark.parametrize(
    "shape_q, shape_k, dtype, ok",
    [
        ((2, 4, 24, 16), (2, 4, 24, 16), torch.float32, True),
        ((2, 4, 24, 128), (2, 4, 24, 128), torch.float32, True),
        ((2, 4, 24, 8), (2, 4, 24, 8), torch.float32, False),  # d_model 32, 4 heads
        ((2, 4, 24, 48), (2, 4, 24, 48), torch.float32, False),
        ((2, 4, 24, 16), (2, 4, 12, 16), torch.float32, False),  # cross-length
        ((2, 4, 24, 16), (2, 4, 24, 16), torch.float64, False),
    ],
)
def test_flash_predicate(shape_q, shape_k, dtype, ok):
    q, k = torch.zeros(shape_q, dtype=dtype), torch.zeros(shape_k, dtype=dtype)
    assert _flash_ok(q, k) is ok


def test_auto_takes_the_plain_path_for_head_dims_the_kernels_lack():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs((1, 4, 24, 8), seed=4))
    qt = q.clone().requires_grad_()
    out = dot_product_attention(qt, k, v, True, impl="auto")
    # the plain path keeps PyTorch's own autograd: no FlashAttention node
    assert "FlashAttention" not in type(out.grad_fn).__name__
    torch.testing.assert_close(out, dot_product_attention_plain(q, k, v, True))
    flash = dot_product_attention(q.clone().requires_grad_(), k, v, True, impl="flash")
    assert "FlashAttention" in type(flash.grad_fn).__name__
