"""
Why the port's tensor-core kernels take three TF32 products, not one.

The forward, dQ and dK/dV kernels (``gordo_tpu_torch/ops/csrc/mma_tf32x3.cuh``)
run their float32 products on the tensor cores in TF32 (10 explicit mantissa
bits). Each operand x is split into big = x rounded to TF32 (to nearest,
ties away from zero, as ``cvt.rna.tf32.f32``) and small = x - big, of which
the tensor core reads the top 19 bits (rounding it toward zero), and each
product is summed as small*big + big*small + big*big. This file emulates
that arithmetic in plain PyTorch on the CPU and holds attention and its
backward computed with it against the float32 plain twins at the main
path's statistics, with the gates that ``chip_smoke.py`` holds the kernels
to.

The emulation's sums are float32 matmuls rounded to nearest; the tensor
core truncates its sums, which the kernels answer by adding each product's
terms in a fresh accumulator (measured on the card, not here). Products of
two TF32 values are exact in float32, as in the tensor core.
"""

import numpy as np
import pytest
import torch

from gordo_tpu_torch.ops import flash_attention as fa

TOL_OUT_REL = 1e-4  # chip_smoke.py's gates for the forward kernel
TOL_LSE_ABS = 1e-4
TOL_GRAD_REL = 1e-4  # and for the backward kernels
SHAPE = (4, 512, 64)  # BH, T, dh of the main path (BH cut to size)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32, to nearest with ties away from zero: add half
    of the 13 dropped bits to the sign-magnitude pattern, then clear them."""
    return ((_bits(x) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_rz(x: torch.Tensor) -> torch.Tensor:
    """The top 19 bits of float32, as the tensor core reads a TF32 operand."""
    return (_bits(x) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rz(x - big)


def matmul_3xtf32(a, b):
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def matmul_1xtf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def attention(q, k, v, causal: bool, matmul):
    """The forward kernel's function with its two products done by
    ``matmul``; returns (out, lse)."""
    s = matmul(q, k.transpose(-1, -2)) * (1.0 / q.shape[-1] ** 0.5)
    if causal:
        t = s.shape[-1]
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), fa.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return matmul(p, v) / denom, (m + torch.log(denom)).squeeze(-1)


def attention_backward(q, k, v, o, lse, do, causal: bool, matmul):
    """The backward kernels' function (``fa.flash_attention_backward_plain``)
    with its five products done by ``matmul``; returns (dq, dk, dv)."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s = matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        t = s.shape[-1]
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), fa.NEG_INF)
    p = torch.exp(s - lse.unsqueeze(-1))
    dv = matmul(p.transpose(-1, -2), do)
    delta = (do * o).sum(dim=-1, keepdim=True)
    ds = p * (matmul(do, v.transpose(-1, -2)) - delta)
    return matmul(ds, k) * scale, matmul(ds.transpose(-1, -2), q) * scale, dv


@pytest.fixture
def qkv():
    rng = np.random.RandomState(0)
    return [torch.from_numpy(rng.randn(*SHAPE).astype(np.float32)) for _ in range(3)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    # see tests/test_torch_flash_attention.py: torch's CPU exp has come out
    # ~1e-4 off on an intra-op worker thread on a loaded machine
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _errors(got, ref):
    (out, lse), (ref_out, ref_lse) = got, ref
    return ((out - ref_out).abs().max() / ref_out.abs().max()).item(), \
        (lse - ref_lse).abs().max().item()


@pytest.mark.parametrize(
    "x, rounded",
    [(1 + 2.0**-11, 1 + 2.0**-10),  # a tie goes away from zero
     (-(1 + 2.0**-11), -(1 + 2.0**-10)),
     (1 + 2.0**-11 - 2.0**-23, 1.0),  # below the tie: down
     (1 + 2.0**-10 + 2.0**-12, 1 + 2.0**-10)],
)
def test_tf32_rounding_is_to_nearest_ties_away(x, rounded):
    got = tf32_rna(torch.tensor([x], dtype=torch.float32)).item()
    assert got == rounded
    big, small = split(torch.tensor([x], dtype=torch.float32))
    assert abs(big.item() + small.item() - x) <= 2.0**-22 * abs(x)


@pytest.mark.parametrize("causal", [True, False])
def test_three_tf32_products_hold_the_float32_gates(qkv, causal):
    ref = fa.flash_attention_forward_plain(*qkv, causal)
    out_rel, lse_abs = _errors(attention(*qkv, causal, matmul_3xtf32), ref)
    assert out_rel <= TOL_OUT_REL and lse_abs <= TOL_LSE_ABS
    # and as close to float64 as float32 itself is: within 4x its error
    ref64 = attention(*(x.double() for x in qkv), causal, torch.matmul)
    out64, lse64 = _errors(attention(*qkv, causal, matmul_3xtf32), ref64)
    plain_out64, plain_lse64 = _errors(ref, ref64)
    assert out64 <= 4 * plain_out64 and lse64 <= 4 * plain_lse64


@pytest.mark.parametrize("causal", [True, False])
def test_one_tf32_product_misses_the_gates(qkv, causal):
    ref = fa.flash_attention_forward_plain(*qkv, causal)
    out_rel, lse_abs = _errors(attention(*qkv, causal, matmul_1xtf32), ref)
    # one pass keeps ~3 decimal digits: it misses a gate by at least 2.5x
    # (measured: out 3.2e-4 and lse 6.1e-4 causal; 5.7e-4 and 2.6e-4 not)
    assert max(out_rel / TOL_OUT_REL, lse_abs / TOL_LSE_ABS) >= 2.5


@pytest.fixture
def backward_inputs():
    """q, k, v, dO (standard normal) and the plain forward's o and lse, per
    causal flag."""
    rng = np.random.RandomState(1)
    q, k, v, do = (torch.from_numpy(rng.randn(*SHAPE).astype(np.float32)) for _ in range(4))
    return lambda causal: (q, k, v, *fa.flash_attention_forward_plain(q, k, v, causal), do)


def _grad_rel(got, ref) -> float:
    # as chip_smoke.py holds the backward kernels: relative to the largest
    # entry, and absolute below 1
    return ((got.double() - ref.double()).abs().max() / max(ref.abs().max().item(), 1.0)).item()


@pytest.mark.parametrize("causal", [True, False])
def test_three_tf32_products_hold_the_backward_gates(backward_inputs, causal):
    inputs = backward_inputs(causal)
    plain = fa.flash_attention_backward_plain(*inputs, causal)
    ref64 = fa.flash_attention_backward_plain(*(x.double() for x in inputs), causal)
    got = attention_backward(*inputs, causal, matmul_3xtf32)
    for name, grad, plain_grad, grad64 in zip(("dq", "dk", "dv"), got, plain, ref64):
        assert _grad_rel(grad, plain_grad) <= TOL_GRAD_REL, name
        # as close to float64 as float32 itself is: within 4x its error
        # (measured: 0.58-1.86x)
        assert _grad_rel(grad, grad64) <= 4 * _grad_rel(plain_grad, grad64), name


@pytest.mark.parametrize("causal", [True, False])
def test_one_tf32_product_misses_the_backward_gate(backward_inputs, causal):
    inputs = backward_inputs(causal)
    plain = fa.flash_attention_backward_plain(*inputs, causal)
    got = attention_backward(*inputs, causal, matmul_1xtf32)
    # each gradient misses the gate by at least 2.5x (measured: dq 9.2e-4,
    # dk 8.2e-4, dv 5.3e-4 causal; 4.9e-4, 4.2e-4 and 2.8e-4 not)
    for name, grad, plain_grad in zip(("dq", "dk", "dv"), got, plain):
        assert _grad_rel(grad, plain_grad) >= 2.5 * TOL_GRAD_REL, name
