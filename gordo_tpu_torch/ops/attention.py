"""
Multi-head scaled-dot-product attention with a dispatcher: the port's
counterpart of ``gordo_tpu/ops/attention.py``.

- ``impl="auto"``: the flash kernels (ops/flash_attention.py, forward and
  backward through one ``torch.autograd.Function``) for every shape
  :func:`_flash_ok` accepts, decided before any launch; every other shape
  takes the plain path, as the JAX dispatcher sends the shapes its kernel
  cannot take to XLA. The JAX package's own gate encodes Mosaic/VMEM limits
  of the TPU; this one encodes what the CUDA kernels take.
- ``impl="flash"``, named explicitly: the flash kernels for every shape; on
  the card an unsupported shape raises. On the CPU their plain twins run.
- ``impl="xla"``, named explicitly in a spec: the plain PyTorch path,
  :func:`dot_product_attention_plain`, as the JAX package runs XLA, with
  PyTorch's own autograd.
- ``impl="ring"``: on one device the plain path, as the JAX package's
  ``ring_attention`` runs plain attention on one device, so ring-configured
  models serve on a single card unchanged. Sequence parallelism over more
  than one device is not ported yet.

Unlike the JAX dispatcher, no environment variable overrides the choice.
"""

import torch

from .flash_attention import DTYPES as FLASH_DTYPES, SUPPORTED_HEAD_DIMS, flash_attention

NEG_INF = -1e30

RING_NOT_PORTED = (
    "ring attention over more than one device is not ported yet: see the "
    "ring attention / parallel axes item of ROADMAP.md queue A"
)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(..., T, D) -> (..., H, T, D//H), a view."""
    *lead, t, d = x.shape
    if d % num_heads:
        raise ValueError(f"model dim {d} not divisible by num_heads {num_heads}")
    return x.reshape(*lead, t, num_heads, d // num_heads).transpose(-3, -2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(..., H, T, Dh) -> (..., T, H*Dh)"""
    *lead, h, t, dh = x.shape
    return x.transpose(-3, -2).reshape(*lead, t, h * dh)


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


def _flash_ok(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the flash kernels take these shapes: self-attention (equal
    query and key lengths), q and k of one dtype the kernels are built for
    (float32 or bfloat16), and a head dim they are built for."""
    return (
        k.shape[-2] == q.shape[-2]
        and q.dtype == k.dtype
        and q.dtype in FLASH_DTYPES
        and q.shape[-1] in SUPPORTED_HEAD_DIMS
    )


def _world_size() -> int:
    """The devices a ring would span: the process group's size, 1 without
    one."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def dot_product_attention(q, k, v, causal: bool = False, impl: str = "auto"):
    """Dispatching attention over (..., T, Dh) tensors."""
    if impl == "auto":
        impl = "flash" if _flash_ok(q, k) else "xla"
    if impl == "flash":
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal)
    if impl == "xla":
        return dot_product_attention_plain(q, k, v, causal)
    if impl == "ring":
        if _world_size() > 1:
            raise NotImplementedError(RING_NOT_PORTED)
        return dot_product_attention_plain(q, k, v, causal)
    raise ValueError(f"Unknown attention impl {impl!r}")


def multihead_attention(q, k, v, num_heads: int, causal: bool = False,
                        impl: str = "auto") -> torch.Tensor:
    """Multi-head attention over (..., T, D) tensors (projections applied by
    the caller): the heads of every leading index go to the kernels as one
    (..., H) batch. Returns (..., T, D)."""
    out = dot_product_attention(
        split_heads(q, num_heads),
        split_heads(k, num_heads),
        split_heads(v, num_heads),
        causal=causal,
        impl=impl,
    )
    return merge_heads(out)
