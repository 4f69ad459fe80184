"""
Multi-head scaled-dot-product attention with a dispatcher: the port's
counterpart of ``gordo_tpu/ops/attention.py``.

- ``impl="auto"`` or ``"flash"``: the flash kernel (ops/flash_attention.py).
  On the card it takes every self-attention shape the kernel supports and
  raises for anything else; on the CPU its plain twin runs. The JAX
  package's shape gate ``_flash_ok`` encodes Mosaic/VMEM limits of the TPU
  and has no counterpart here.
- ``impl="xla"``, named explicitly in a spec: the plain PyTorch path,
  :func:`dot_product_attention_plain`, as the JAX package runs XLA.
- ``impl="ring"``: not ported yet.

Unlike the JAX dispatcher, no environment variable overrides the choice.
"""

import torch

from .flash_attention import flash_attention

NEG_INF = -1e30

RING_NOT_PORTED = (
    "ring attention is not ported yet: see the ring attention / parallel "
    "axes item of ROADMAP.md queue A"
)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, D//H), a view."""
    b, t, d = x.shape
    if d % num_heads:
        raise ValueError(f"model dim {d} not divisible by num_heads {num_heads}")
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, Dh) -> (B, T, H*Dh)"""
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def dot_product_attention_plain(q, k, v, causal: bool = False) -> torch.Tensor:
    """Reference attention over (..., T, Dh), softmax in float32: the
    counterpart of ``dot_product_attention_xla``."""
    dh = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(dh, dtype=torch.float32))
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale.to(q.device)
    if causal:
        t_q, t_k = logits.shape[-2:]
        mask = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril(t_k - t_q)
        logits = logits.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


def dot_product_attention(q, k, v, causal: bool = False, impl: str = "auto"):
    """Dispatching attention over (..., T, Dh) tensors."""
    if impl in ("auto", "flash"):
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal)
    if impl == "xla":
        return dot_product_attention_plain(q, k, v, causal)
    if impl == "ring":
        raise NotImplementedError(RING_NOT_PORTED)
    raise ValueError(f"Unknown attention impl {impl!r}")


def multihead_attention(q, k, v, num_heads: int, causal: bool = False,
                        impl: str = "auto") -> torch.Tensor:
    """Multi-head attention over (B, T, D) tensors (projections applied by
    the caller). Returns (B, T, D)."""
    out = dot_product_attention(
        split_heads(q, num_heads),
        split_heads(k, num_heads),
        split_heads(v, num_heads),
        causal=causal,
        impl=impl,
    )
    return merge_heads(out)
