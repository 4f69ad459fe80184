"""
The port's CUDA kernels against their plain PyTorch versions on the card.

Imports only torch and the port, so it runs on a machine without JAX or
the JAX package's dependencies. Every test here is marked ``cuda`` and
skips without a card; on the card, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from gordo_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, causal",
    [((2, 4, 512, 64), True), ((2, 4, 512, 64), False), ((4, 4, 144, 16), True),
     ((3, 2, 77, 32), False), ((2, 2, 200, 128), True), ((1, 1, 1, 64), True)],
)
def test_kernel_matches_plain_on_the_card(cuda_device, shape, causal):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(shape, device=cuda_device, generator=g) for _ in range(3))
    before = fa.LAUNCHES
    out, lse = fa.flash_attention_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    ref_out, ref_lse = fa.flash_attention_forward_plain(q, k, v, causal)
    rel = ((out - ref_out).abs().max() / ref_out.abs().max()).item()
    assert rel <= 1e-4
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_kernel_refuses_unsupported_head_dim(cuda_device):
    q = torch.zeros(1, 8, 24, device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_forward(q, q, q)


BACKWARD_SHAPES = [((128, 512, 64), True), ((128, 512, 64), False), ((16, 144, 16), True),
                   ((6, 77, 32), False), ((4, 200, 128), True), ((1, 1, 64), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, causal", BACKWARD_SHAPES)
def test_backward_kernels_match_plain_on_the_card(cuda_device, shape, causal):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(shape, device=cuda_device, generator=g) for _ in range(4))
    o, lse = fa.flash_attention_forward(q, k, v, causal)
    before = (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    grads = fa.flash_attention_backward(q, k, v, o, lse, do, causal)
    again = fa.flash_attention_backward(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) == (before[0] + 2, before[1] + 2)
    refs = fa.flash_attention_backward_plain(q, k, v, o, lse, do, causal)
    for name, grad, rerun, ref in zip("qkv", grads, again, refs):
        # float32 sums in another order than the plain version's matmuls;
        # relative to the largest entry, and absolute below 1 (standard
        # normal inputs): at T = 1, dq and dk are exactly 0
        rel = ((grad - ref).abs().max() / max(ref.abs().max().item(), 1.0)).item()
        assert rel <= 1e-4, (name, rel)
        assert torch.equal(grad, rerun), name  # no atomics: bit-identical reruns


@pytest.mark.cuda
def test_autograd_function_runs_the_three_kernels(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn((2, 4, 144, 16), device=cuda_device, generator=g,
                           requires_grad=True) for _ in range(3))
    before = (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    out = fa.flash_attention(q, k, v, True)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) == tuple(b + 1 for b in before)
    from gordo_tpu_torch.ops.attention import dot_product_attention_plain

    ref_out = dot_product_attention_plain(q, k, v, True)
    refs = torch.autograd.grad(ref_out.square().sum(), (q, k, v))
    for grad, ref in zip(grads, refs):
        assert ((grad - ref).abs().max() / ref.abs().max()).item() <= 1e-4


@pytest.mark.cuda
def test_auto_sends_unsupported_head_dims_to_the_plain_path(cuda_device):
    from gordo_tpu_torch.ops.attention import dot_product_attention, dot_product_attention_plain

    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn((1, 4, 24, 8), device=cuda_device, generator=g) for _ in range(3))
    before = fa.LAUNCHES
    out = dot_product_attention(q, k, v, True, impl="auto")
    assert fa.LAUNCHES == before
    torch.testing.assert_close(out, dot_product_attention_plain(q, k, v, True))
    with pytest.raises(ValueError, match="head dims"):
        dot_product_attention(q, k, v, True, impl="flash")


def _rel(got, ref):
    # relative to the largest entry, and absolute below 1 (standard normal
    # inputs): at T = 1, dq and dk are exactly 0
    return ((got - ref).abs().max() / max(ref.abs().max().item(), 1.0)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [1, 63, 65, 200])
@pytest.mark.parametrize("dh", [64, 128])
def test_forward_kernel_at_ragged_lengths(cuda_device, dh, t, causal):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn((2, 3, t, dh), device=cuda_device, generator=g) for _ in range(3))
    out, lse = fa.flash_attention_forward(q, k, v, causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_forward_plain(q, k, v, causal)
    assert ((out - ref_out).abs().max() / ref_out.abs().max()).item() <= 1e-4
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [1, 63, 65, 200])
@pytest.mark.parametrize("dh", [64, 128])
def test_dkv_kernel_at_ragged_lengths(cuda_device, dh, t, causal):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v, do = (torch.randn((6, t, dh), device=cuda_device, generator=g) for _ in range(4))
    o, lse = fa.flash_attention_forward(q, k, v, causal)
    before = fa.DKV_LAUNCHES
    dk, dv = fa.launch_dkv(q, k, v, o, lse, do, causal)
    dk2, dv2 = fa.launch_dkv(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert fa.DKV_LAUNCHES == before + 2
    _, ref_dk, ref_dv = fa.flash_attention_backward_plain(q, k, v, o, lse, do, causal)
    assert _rel(dk, ref_dk) <= 1e-4
    assert _rel(dv, ref_dv) <= 1e-4
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.cuda
def test_dkv_kernel_is_bit_identical_on_rerun(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v, do = (torch.randn((128, 512, 64), device=cuda_device, generator=g)
                   for _ in range(4))
    o, lse = fa.flash_attention_forward(q, k, v, True)
    first = fa.launch_dkv(q, k, v, o, lse, do, True)
    for _ in range(3):
        again = fa.launch_dkv(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [1, 63, 65, 200])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_dq_kernel_at_ragged_lengths(cuda_device, dh, t, causal):
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v, do = (torch.randn((6, t, dh), device=cuda_device, generator=g) for _ in range(4))
    o, lse = fa.flash_attention_forward(q, k, v, causal)
    before = fa.DQ_LAUNCHES
    dq = fa.launch_dq(q, k, v, o, lse, do, causal)
    dq2 = fa.launch_dq(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert fa.DQ_LAUNCHES == before + 2
    ref_dq = fa.flash_attention_backward_plain(q, k, v, o, lse, do, causal)[0]
    assert _rel(dq, ref_dq) <= 1e-4
    assert torch.equal(dq, dq2)


@pytest.mark.cuda
def test_dq_kernel_is_bit_identical_on_rerun(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v, do = (torch.randn((128, 512, 64), device=cuda_device, generator=g)
                   for _ in range(4))
    o, lse = fa.flash_attention_forward(q, k, v, True)
    first = fa.launch_dq(q, k, v, o, lse, do, True)
    for _ in range(3):
        again = fa.launch_dq(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        assert torch.equal(first, again)
