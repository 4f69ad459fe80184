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


# Head dims from 64 to 256 run by classes of instantiations, a dh inside a
# class with its columns past dh zero-filled: every float32 class (the
# multiples of 32) and dims inside classes; every bf16 class (whole
# 64-column panels) and dims inside them
F32_RAGGED_DIMS = [64, 72, 96, 128, 136, 160, 192, 200, 224, 256]
BF16_RAGGED_DIMS = [64, 72, 96, 120, 128, 136, 192, 200, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [8, 24, 48, 60, 264])
def test_flash_raises_outside_the_head_dim_rule(cuda_device, dh):
    """impl="flash" at a dh the kernels do not take raises on the card,
    naming the rule, and "auto" takes the plain path without a launch."""
    from gordo_tpu_torch.ops.attention import dot_product_attention, dot_product_attention_plain

    g = torch.Generator(device=cuda_device).manual_seed(12)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((1, 2, 24, dh), device=cuda_device, generator=g).to(dtype)
                   for _ in range(3))
        with pytest.raises(ValueError, match="every multiple of 8 from 64 to 256"):
            dot_product_attention(q, k, v, True, impl="flash")
        before = (fa.LAUNCHES, fa.BF16_LAUNCHES)
        out = dot_product_attention(q, k, v, True, impl="auto")
        assert (fa.LAUNCHES, fa.BF16_LAUNCHES) == before
        torch.testing.assert_close(out, dot_product_attention_plain(q, k, v, True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [72, 96, 136, 200, 256])
def test_auto_launches_the_kernels_at_every_head_dim_of_the_rule(cuda_device, dh, dtype):
    from gordo_tpu_torch.ops.attention import dot_product_attention

    g = torch.Generator(device=cuda_device).manual_seed(13)
    q, k, v = (torch.randn((1, 2, 40, dh), device=cuda_device, generator=g).to(dtype)
               .requires_grad_() for _ in range(3))
    names = (("BF16_LAUNCHES", "BF16_DQ_LAUNCHES", "BF16_DKV_LAUNCHES")
             if dtype == torch.bfloat16 else ("LAUNCHES", "DQ_LAUNCHES", "DKV_LAUNCHES"))
    before = [getattr(fa, name) for name in names]
    out = dot_product_attention(q, k, v, True, impl="auto")
    grads = torch.autograd.grad(out.float().square().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert [getattr(fa, name) - b for name, b in zip(names, before)] == [1, 1, 1]
    assert all(g.shape == q.shape and torch.isfinite(g).all() for g in grads)


def _rel(got, ref):
    # relative to the largest entry, and absolute below 1 (standard normal
    # inputs): at T = 1, dq and dk are exactly 0
    return ((got - ref).abs().max() / max(ref.abs().max().item(), 1.0)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [1, 63, 65, 200])
@pytest.mark.parametrize("dh", F32_RAGGED_DIMS)
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
@pytest.mark.parametrize("dh", F32_RAGGED_DIMS)
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
@pytest.mark.parametrize("dh", [16, 32] + F32_RAGGED_DIMS)
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
@pytest.mark.parametrize("dh", [16, 32] + BF16_RAGGED_DIMS)
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
@pytest.mark.parametrize("dh", [16, 32] + BF16_RAGGED_DIMS)
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


# --- fp16: the bf16 sources' fp16 instantiations ---

F16_ULP = 2.0 ** -10  # one fp16 ulp, relative to the value
F16_SUBNORMAL = 2.0 ** -24  # fp16's least subnormal: its ulp below 2^-14
TOL_F16_SHARE = 0.01


def _assert_f16_close(got, ref, name, exact=None, atol=1e-6, ulp=True):
    """chip_smoke.py's fp16 gate (``_f16_gate``): every element within one
    fp16 ulp of the reference's (at least fp16's least subnormal, plus
    ``atol``: 1e-6 times the scale of dO), at most 1% of them different at
    all; elements exactly 0 in float64 held to |x| <= ``atol``. Against the
    float32 twin (``ulp`` false) only the share: the twin's own error near
    0 is of the order of ``atol``, so it is no judge of one ulp there."""
    a, b = got.float(), ref.float()
    bound = torch.clamp(F16_ULP * torch.maximum(a.abs(), b.abs()), min=F16_SUBNORMAL) + atol
    ok = (a - b).abs() <= bound
    differs = a != b
    if exact is not None:
        zero = exact == 0
        ok = torch.where(zero, a.abs() <= atol, ok)
        differs = differs & ~zero
    assert bool(ok.all()) or not ulp, name
    assert differs.float().mean().item() <= TOL_F16_SHARE, name


def _f16_inputs(shape, seed, device, do_scale=1.0):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, device=device, generator=g) for _ in range(4))
    return [x.half() for x in (q, k, v, do * do_scale)]


def _f16_against_twins(q, k, v, do, causal, do_scale):
    """Forward, dQ and dK/dV (the backward twice) against the float64 twin
    rounded to fp16 and, by share, the float32 twin; returns the launches
    made."""
    before = (fa.F16_LAUNCHES, fa.F16_DQ_LAUNCHES, fa.F16_DKV_LAUNCHES)
    out, lse = fa.flash_attention_forward(q, k, v, causal)
    runs = [(fa.launch_dq(q, k, v, out, lse, do, causal),
             *fa.launch_dkv(q, k, v, out, lse, do, causal)) for _ in range(2)]
    torch.cuda.synchronize()
    launched = tuple(b - a for a, b in zip(before, (fa.F16_LAUNCHES, fa.F16_DQ_LAUNCHES,
                                                    fa.F16_DKV_LAUNCHES)))
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    ref_out, ref_lse = fa.flash_attention_forward_plain(q, k, v, causal)
    _assert_f16_close(out, ref_out, "out", ulp=False)
    exact_out = fa.flash_attention_forward_plain(q.double(), k.double(), v.double(), causal)[0]
    _assert_f16_close(out, exact_out.half(), "out vs float64")
    assert ((lse - ref_lse).abs() <= TOL_BF16_LSE_REL * ref_lse.abs().clamp_min(1.0)).all()
    refs = fa.flash_attention_backward_plain(q, k, v, out, lse, do, causal)
    exact = _exact_backward(q, k, v, out, lse, do, causal)
    for name, got, again, ref, ref64 in zip(("dq", "dk", "dv"), *runs, refs, exact):
        assert got.dtype == torch.float16
        _assert_f16_close(got, ref, name, ref64, 1e-6 * do_scale, ulp=False)
        _assert_f16_close(got, ref64.half(), f"{name} vs float64", ref64, 1e-6 * do_scale)
        assert torch.equal(got, again), name  # no atomics: bit-identical reruns
    return launched


@pytest.mark.cuda
@pytest.mark.parametrize("do_scale", [1.0, 1e-4])
@pytest.mark.parametrize("shape, causal", BACKWARD_SHAPES)
def test_f16_kernels_match_plain_on_the_card(cuda_device, shape, causal, do_scale):
    """At the training shapes and the small and wide ones, with dO at unit
    scale and at 1e-4 (where an unscaled split of dS would be subnormal)."""
    q, k, v, do = _f16_inputs(shape, 12, cuda_device, do_scale)
    assert _f16_against_twins(q, k, v, do, causal, do_scale) == (1, 2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("do_scale", [1.0, 1e-4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", WGMMA_T)
@pytest.mark.parametrize("dh", [16, 32] + BF16_RAGGED_DIMS)
def test_f16_kernels_at_ragged_lengths_across_heads(cuda_device, dh, t, causal, do_scale):
    q, k, v, do = _f16_inputs((3, t, dh), 13, cuda_device, do_scale)
    assert _f16_against_twins(q, k, v, do, causal, do_scale) == (1, 2, 2)


@pytest.mark.cuda
def test_f16_autograd_goes_through_the_f16_kernels(cuda_device):
    from gordo_tpu_torch.ops.attention import dot_product_attention

    q, k, v = (x.requires_grad_() for x in _f16_inputs((2, 4, 144, 16), 14, cuda_device)[:3])
    counters = ("LAUNCHES", "DQ_LAUNCHES", "DKV_LAUNCHES", "BF16_LAUNCHES", "BF16_DQ_LAUNCHES",
                "BF16_DKV_LAUNCHES", "F16_LAUNCHES", "F16_DQ_LAUNCHES", "F16_DKV_LAUNCHES")
    before = [getattr(fa, name) for name in counters]
    out = dot_product_attention(q, k, v, True, impl="auto")
    grads = torch.autograd.grad(out.float().square().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert [getattr(fa, name) - n for name, n in zip(counters, before)] == [0] * 6 + [1] * 3
    assert all(g.dtype == torch.float16 and torch.isfinite(g).all() for g in grads)


# ------------------------------------------------------------ the LSTM recurrence
# (M, B, T, U): compressor-b's (the legacy route), lstm_ae_144's, a ragged
# batch, U 128, 256 and 512 (clusters of 2 to 16 CTAs; float32 U 512
# streams R from L2), a batch that is not a multiple of the row tile (20,
# 101), M > 1 on the cluster routes, and one step
LSTM_SHAPES = [(1, 1, 24, 3), (1, 64, 144, 64), (3, 17, 9, 32), (2, 5, 7, 256), (1, 2, 1, 8),
               (1, 20, 12, 128), (2, 20, 9, 256), (1, 6, 5, 512), (3, 101, 24, 64)]


def _lstm_inputs(shape, dtype, device, r_scale=None, seed=0):
    m, b, t, u = shape
    g = torch.Generator(device=device).manual_seed(seed)
    zx = (0.5 * torch.randn((m, b, t, 4 * u), device=device, generator=g)).to(dtype)
    rk = (torch.randn((m, u, 4 * u), device=device, generator=g)
          * (u ** -0.5 if r_scale is None else r_scale)).to(dtype)
    return zx, rk, g


def _lstm_against_twins(zx, rk, act, rec, return_sequences, tol, g):
    """The forward (output and saved z, c, h), the serving forward and the
    backward (dZ from the kernel's saved tensors, twice) against the plain
    twins; returns the launches made, by counter."""
    from gordo_tpu_torch.ops import lstm

    names = ("FORWARD_LAUNCHES", "BACKWARD_LAUNCHES", "BF16_FORWARD_LAUNCHES",
             "BF16_BACKWARD_LAUNCHES")
    before = {name: getattr(lstm, name) for name in names}
    out, saved = lstm.lstm_recurrence_forward(zx, rk, act, rec, return_sequences, True)
    serve, _ = lstm.lstm_recurrence_forward(zx, rk, act, rec, return_sequences, False)
    dout = torch.randn(out.shape, device=zx.device, generator=g).to(zx.dtype)
    dz = lstm.lstm_recurrence_backward(dout, saved[0], saved[1], rk, act, rec, return_sequences)
    again = lstm.lstm_recurrence_backward(dout, saved[0], saved[1], rk, act, rec,
                                          return_sequences)
    torch.cuda.synchronize()
    ref, ref_saved = lstm.lstm_recurrence_forward_plain(zx, rk, act, rec, return_sequences, True)
    ref_dz = lstm.lstm_recurrence_backward_plain(dout, saved[0], saved[1], rk, act, rec,
                                                 return_sequences)
    for got, want in ((out, ref), *zip(saved, ref_saved), (dz, ref_dz)):
        assert torch.isfinite(want.float()).all()
        rel = ((got.float() - want.float()).abs().max()
               / want.float().abs().max().clamp_min(1e-30)).item()
        assert rel <= tol
    assert torch.equal(dz, again)  # no atomics, a fixed order: bit-identical
    assert torch.equal(serve, out)  # the serving forward is the training forward
    return {name: getattr(lstm, name) - n for name, n in before.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("return_sequences", [True, False])
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", LSTM_SHAPES)
def test_lstm_kernels_match_their_twins_on_the_card(cuda_device, shape, dtype, tol,
                                                    return_sequences):
    """The recurrence's forward (output and saved z, c, h) and backward (dZ
    from the kernel's saved tensors) against the plain twins on the plan's
    own route, the backward bit-identical on a second launch and the
    serving forward equal to the training forward."""
    zx, rk, g = _lstm_inputs(shape, dtype, cuda_device)
    launched = _lstm_against_twins(zx, rk, "tanh", "sigmoid", return_sequences, tol, g)
    prefix = "BF16_" if dtype == torch.bfloat16 else ""
    assert launched[prefix + "FORWARD_LAUNCHES"] == 2
    assert launched[prefix + "BACKWARD_LAUNCHES"] == 2
    assert sum(launched.values()) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("route, shape", [
    ("legacy", (1, 64, 20, 64)), ("legacy", (2, 9, 7, 256)), ("cluster", (1, 1, 24, 3)),
    ("cluster", (2, 9, 7, 256)), ("stream", (1, 64, 20, 64)), ("stream", (2, 9, 7, 256)),
    ("stream", (1, 40, 6, 32))])
def test_every_lstm_route_matches_the_twins(cuda_device, route, shape, dtype, tol):
    """Each route of the plan, forced with lstm.set_route, at shapes the
    plan gives another route or its own."""
    from gordo_tpu_torch.ops import lstm

    zx, rk, g = _lstm_inputs(shape, dtype, cuda_device)
    lstm.set_route(route)
    try:
        assert lstm.kernel_plan(*shape[:2], shape[3], dtype, False)["route"] == route
        for return_sequences in (True, False):
            _lstm_against_twins(zx, rk, "tanh", "sigmoid", return_sequences, tol, g)
    finally:
        lstm.set_route(None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("route, u", [(None, 3), (None, 16), ("cluster", 16), ("cluster", 256)])
@pytest.mark.parametrize("act, rec, r_scale", [
    ("gelu", "hard_sigmoid", 0.25), ("elu", "softsign", 0.25), ("relu", "linear", 0.25),
    ("selu", "swish", 0.25), ("leaky_relu", "tanh", 0.25), ("tanh", "sigmoid", 0.25),
    # exponential gates have no bound: through R, h overflows float32 within
    # a few steps in the twin too, so R is 0 here and the cell alone runs
    ("softplus", "exponential", 0.0)])
def test_lstm_kernels_take_every_activation(cuda_device, act, rec, r_scale, route, u, dtype,
                                            tol):
    """Every activation pair against the twins on both routes that ship: the
    plan's own (the legacy kernels below U 8, and for float32 U 16 over 12
    rows; bf16 U 16 on the tensor cores) and the tensor-core route, forced
    (U 16 without a cluster, U 256 in a cluster)."""
    from gordo_tpu_torch.ops import lstm

    shape = (2, 6, 11, u)
    zx, rk, g = _lstm_inputs(shape, dtype, cuda_device, r_scale=r_scale * 16 ** 0.5 * u ** -0.5)
    lstm.set_route(route)
    try:
        want = route or ("legacy" if u < 8 or dtype == torch.float32 else "cluster")
        for backward in (False, True):
            assert lstm.kernel_plan(2, 6, u, dtype, backward)["route"] == want
        _lstm_against_twins(zx, rk, act, rec, True, tol, g)
    finally:
        lstm.set_route(None)


@pytest.mark.cuda
def test_lstm_launches_from_threads_at_plans_of_other_sizes(cuda_device):
    """Launches from eight threads at once, of one instantiation at plans
    that differ in shared memory (the legacy kernels at float32 U 16 and 64
    over 8 rows, the tensor-core kernels at bf16 U 32 and 64), each launch
    and give what a launch alone gives. A launch sets its kernel's
    shared-memory size and launches under one lock: a served model's layers
    under concurrent requests failed with CUDA error 1 where a thread set a
    smaller size in between. The threads call the C entry point itself, as
    the wrapper does, so that the launches overlap more than the wrapper's
    Python lets them."""
    import threading

    from gordo_tpu_torch.ops import lstm

    cases = []
    for dtype, units in ((torch.float32, (16, 64)), (torch.bfloat16, (32, 64))):
        for u in units:
            zx, rk, _ = _lstm_inputs((1, 8, 2, u), dtype, cuda_device, seed=u)
            want, _ = lstm.lstm_recurrence_forward(zx, rk, "tanh", "sigmoid", True, False)
            cases.append((zx, rk, want))
    stream = torch.cuda.current_stream(cuda_device)
    codes = (lstm.activation_code("tanh"), lstm.activation_code("sigmoid"))
    failures = []

    def worker(i):
        outs = [torch.empty_like(want) for _, _, want in cases]
        for r in range(2000):
            k = (i + r) % len(cases)
            zx, rk, _ = cases[k]
            m, b, t, g4 = zx.shape
            rc = lstm._kernel(False, zx.dtype)(
                zx.data_ptr(), rk.data_ptr(), outs[k].data_ptr(), None, None, None, m, b, t,
                g4 // 4, lstm.batch_tile(m, b), *codes, 1, stream.cuda_stream)
            if rc != 0:
                failures.append((i, r, k, rc))
        stream.synchronize()
        failures.extend((i, k, "differs") for k, (_, _, want) in enumerate(cases)
                        if not torch.equal(outs[k], want))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not failures, (len(failures), failures[:5])


@pytest.mark.cuda
def test_lstm_launch_limits_follow_the_kernels_plan(cuda_device):
    """check_launch_limits raises where no route of the CUDA source's plan
    takes a shape; the plan holds R in shared memory at U 64 (one CTA) and
    U 256 (16 CTAs), streams float32 U 512, keeps compressor-b's U 3 and
    float32 U 64 over 64 rows on the legacy route, fills the card at the
    fleet step and the served shape, and takes every shape the legacy plan
    alone took (U up to 1,200 at the largest batch tile)."""
    from gordo_tpu_torch.ops import lstm

    with pytest.raises(ValueError, match="shared memory"):
        lstm.check_launch_limits(1, 4096, 4000)
    lstm.check_launch_limits(64, 64, 256)
    for u in (1, 3, 64, 100, 256, 512, 1000, 1200):
        lstm.check_launch_limits(1, 4096, u)
        lstm.check_launch_limits(64, 64, u, 2)
    plan = lambda u, dtype, backward, m=1, b=32: lstm.kernel_plan(m, b, u, dtype, backward)
    assert plan(3, torch.float32, True)["route"] == "legacy"
    for backward in (False, True):
        # float32 U <= 64 over at most 132 rows: the legacy kernels, a block a
        # row; bf16 there on the tensor cores, one CTA holding R
        assert plan(64, torch.float32, backward, 1, 64)["route"] == "legacy"
        small = plan(64, torch.bfloat16, backward, 1, 64)
        assert (small["route"], small["cluster"], small["rows"]) == ("cluster", 1, 8), small
        # the default width: R over 16 CTAs
        for dtype in lstm.DTYPES:
            wide = plan(256, dtype, backward)
            assert (wide["route"], wide["cluster"], wide["r_in_smem"]) == ("cluster", 16, True)
        assert plan(512, torch.float32, backward)["route"] == "stream"
        assert plan(512, torch.bfloat16, backward)["route"] == "cluster"
        # the fleet step and a served request without a cluster, in one wave
        # of 128 CTAs: forward rows of 32 and 16, backward 16 (k split 2)
        fleet = plan(64, torch.float32, backward, 64, 64)
        assert (fleet["cluster"], fleet["rows"]) == (1, 16 if backward else 32), fleet
        served = plan(64, torch.float32, backward, 1, 2048)
        assert (served["cluster"], served["rows"]) == (1, 16), served


@pytest.mark.cuda
def test_lstm_tensor_core_kernels_fit_their_plan(cuda_device):
    """Each built tensor-core instantiation takes the threads its plans
    launch with (at most 512: 128 registers a thread)."""
    from gordo_tpu_torch.ops import lstm

    for dtype in lstm.DTYPES:
        for backward, tiles, ksplit, held in (
                (False, 1, 1, True), (False, 1, 2, True), (False, 2, 1, True), (True, 1, 2, True),
                (True, 1, 4, True), (False, 1, 1, False), (True, 1, 2, False)):
            for constants in (True, False):
                got = lstm.kernel_attributes(backward, dtype, constants, tiles, ksplit, held)
                assert got["max_threads"] >= 512 and got["registers"] <= 128, got


@pytest.mark.cuda
def test_lstm_layer_trains_through_the_kernels(cuda_device):
    """An LSTM layer's forward and backward on the card go through the
    kernels (one launch each) and give the plain path's gradients."""
    from gordo_tpu_torch.models.spec import LSTMLayer
    from gordo_tpu_torch.ops import lstm, nn

    layer = LSTMLayer(8, return_sequences=True)
    g = torch.Generator().manual_seed(2)
    params = nn.init_lstm_layer(g, 5, 8)
    x = torch.rand((4, 12, 5), generator=g)
    grads = []
    for device in ("cpu", cuda_device):
        p = {k: v.detach().clone().to(device).requires_grad_() for k, v in params.items()}
        before = (lstm.FORWARD_LAUNCHES, lstm.BACKWARD_LAUNCHES)
        nn._apply_lstm(layer, p, x.to(device), stacked=False).square().sum().backward()
        launched = (lstm.FORWARD_LAUNCHES - before[0], lstm.BACKWARD_LAUNCHES - before[1])
        assert launched == ((0, 0) if device == "cpu" else (1, 1))
        grads.append({k: v.grad.cpu() for k, v in p.items()})
    for name, want in grads[0].items():
        assert ((grads[1][name] - want).abs().max() / want.abs().max()).item() <= 1e-4
