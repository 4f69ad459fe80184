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


# --- bf16 ---

BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative to the value
TOL_BF16_SHARE = 0.01  # share of outputs that may differ from the twin at all
TOL_BF16_LSE_REL = 1e-5  # relative, absolute below 1


def _assert_bf16_close(got, ref, name, exact=None):
    """Every element within one bf16 ulp of the twin's (absolute 1e-6 near
    0), and at most 1% of them different at all: the kernels compute in
    float32 as the twins do and round only the output. Gradient elements
    that are exactly 0 in float64 (``exact``: dQ of a query that sees one
    key, dQ and dK at T = 1) are float32 rounding noise in both: they are
    held to |x| <= 1e-6 and left out of the share."""
    a, b = got.float(), ref.float()
    ok = (a - b).abs() <= BF16_ULP * torch.maximum(a.abs(), b.abs()) + 1e-6
    differs = a != b
    if exact is not None:
        zero = exact == 0
        ok = torch.where(zero, a.abs() <= 1e-6, ok)
        differs = differs & ~zero
    assert bool(ok.all()), name
    assert differs.float().mean().item() <= TOL_BF16_SHARE, name


def _exact_backward(q, k, v, o, lse, do, causal):
    return fa.flash_attention_backward_plain(*(x.double() for x in (q, k, v, o, lse, do)),
                                             causal)


def _bf16_inputs(shape, seed, n, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, device=device, generator=g).bfloat16() for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, causal", [((2, 4, 512, 64), True), ((2, 4, 512, 64), False)]
                         + BACKWARD_SHAPES)
def test_bf16_kernels_match_plain_on_the_card(cuda_device, shape, causal):
    q, k, v, do = _bf16_inputs(shape, 8, 4, cuda_device)
    before = (fa.BF16_LAUNCHES, fa.BF16_DQ_LAUNCHES, fa.BF16_DKV_LAUNCHES)
    out, lse = fa.flash_attention_forward(q, k, v, causal)
    grads = fa.flash_attention_backward(q, k, v, out, lse, do, causal)
    again = fa.flash_attention_backward(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert (fa.BF16_LAUNCHES, fa.BF16_DQ_LAUNCHES, fa.BF16_DKV_LAUNCHES) == (
        before[0] + 1, before[1] + 2, before[2] + 2)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref_out, ref_lse = fa.flash_attention_forward_plain(q, k, v, causal)
    _assert_bf16_close(out, ref_out, "out")
    assert ((lse - ref_lse).abs() <= TOL_BF16_LSE_REL * ref_lse.abs().clamp_min(1.0)).all()
    refs = fa.flash_attention_backward_plain(q, k, v, out, lse, do, causal)
    exact = _exact_backward(q, k, v, out, lse, do, causal)
    for name, grad, rerun, ref, ref64 in zip(("dq", "dk", "dv"), grads, again, refs, exact):
        assert grad.dtype == torch.bfloat16
        _assert_bf16_close(grad, ref, name, ref64)
        assert torch.equal(grad, rerun), name  # no atomics: bit-identical reruns


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [1, 63, 65, 200])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_bf16_kernels_at_ragged_lengths(cuda_device, dh, t, causal):
    q, k, v, do = _bf16_inputs((6, t, dh), 9, 4, cuda_device)
    out, lse = fa.flash_attention_forward(q, k, v, causal)
    grads = fa.flash_attention_backward(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    _assert_bf16_close(out, fa.flash_attention_forward_plain(q, k, v, causal)[0], "out")
    refs = fa.flash_attention_backward_plain(q, k, v, out, lse, do, causal)
    exact = _exact_backward(q, k, v, out, lse, do, causal)
    for name, grad, ref, ref64 in zip(("dq", "dk", "dv"), grads, refs, exact):
        _assert_bf16_close(grad, ref, name, ref64)


@pytest.mark.cuda
def test_bf16_autograd_goes_through_the_bf16_kernels(cuda_device):
    from gordo_tpu_torch.ops.attention import dot_product_attention

    q, k, v = (x.requires_grad_() for x in _bf16_inputs((2, 4, 144, 16), 10, 3, cuda_device))
    before = (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES,
              fa.BF16_LAUNCHES, fa.BF16_DQ_LAUNCHES, fa.BF16_DKV_LAUNCHES)
    out = dot_product_attention(q, k, v, True, impl="auto")
    grads = torch.autograd.grad(out.float().square().sum(), (q, k, v))
    torch.cuda.synchronize()
    after = (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES,
             fa.BF16_LAUNCHES, fa.BF16_DQ_LAUNCHES, fa.BF16_DKV_LAUNCHES)
    assert [b - a for a, b in zip(before, after)] == [0, 0, 0, 1, 1, 1]
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g).all() for g in grads)


# The bf16 kernels run on wgmma fed by TMA through 3-D tensor maps
# (dh, T, BH), which zero-fill the rows at or past T of each head: at a T
# that is not a multiple of the tiles (64 keys, 64-row warpgroup slices of
# 128- or 192-row query tiles, 128-row key tiles, 32- or 64-row query tiles
# in dK/dV), with BH >= 2, a tile that crosses T reads zeros, never the next
# head's rows. dQ is also held to the gate against the float64 result
# rounded to bf16, as chip_smoke.py holds it.
WGMMA_T = [1, 77, 144, 200, 513]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", WGMMA_T)
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_wgmma_kernels_at_ragged_lengths_across_heads(cuda_device, dh, t, causal):
    q, k, v, do = _bf16_inputs((3, t, dh), 11, 4, cuda_device)
    before = (fa.BF16_LAUNCHES, fa.BF16_DQ_LAUNCHES, fa.BF16_DKV_LAUNCHES)
    out, lse = fa.flash_attention_forward(q, k, v, causal)
    runs = [(fa.launch_dq(q, k, v, out, lse, do, causal),
             *fa.launch_dkv(q, k, v, out, lse, do, causal)) for _ in range(2)]
    torch.cuda.synchronize()
    assert (fa.BF16_LAUNCHES, fa.BF16_DQ_LAUNCHES, fa.BF16_DKV_LAUNCHES) == (
        before[0] + 1, before[1] + 2, before[2] + 2)
    ref_out, ref_lse = fa.flash_attention_forward_plain(q, k, v, causal)
    _assert_bf16_close(out, ref_out, "out")
    assert ((lse - ref_lse).abs() <= TOL_BF16_LSE_REL * ref_lse.abs().clamp_min(1.0)).all()
    refs = fa.flash_attention_backward_plain(q, k, v, out, lse, do, causal)
    exact = _exact_backward(q, k, v, out, lse, do, causal)
    for name, got, again, ref, ref64 in zip(("dq", "dk", "dv"), *runs, refs, exact):
        _assert_bf16_close(got, ref, name, ref64)
        assert torch.equal(got, again), name  # no atomics: bit-identical reruns
    _assert_bf16_close(runs[0][0], exact[0].to(torch.bfloat16), "dq vs float64", exact[0])
