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
