"""
Flash attention forward: the wrapper of the hand-written CUDA kernel
``csrc/flash_attention.cu`` and its plain PyTorch twin.

The kernel replaces ``_flash_kernel`` / ``_flash_forward`` of
``gordo_tpu/ops/pallas_kernels/flash_attention.py``: blockwise online-softmax
self-attention, scale 1/sqrt(dh), optional causal mask, returning the
output and the per-row logsumexp (stored here as (BH, T), without the TPU's
128-lane replication). On this card it is bound by float32 FMA throughput;
the source note says what its design does about that.

Dispatch is by where the tensors lie: CPU tensors take
:func:`flash_attention_forward_plain`, CUDA tensors launch the kernel or
raise. There is no fallback from one to the other.
"""

import ctypes
import functools
import threading

import torch

from . import _build

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)

# kernel launches made by flash_attention_forward on CUDA tensors
LAUNCHES = 0
_launches_lock = threading.Lock()


def flash_attention_forward_plain(q, k, v, causal: bool = False):
    """The kernel's function in plain PyTorch. q, k, v: (..., T, Dh).
    Returns ``(out, lse)`` with lse shaped (..., T), float32."""
    dh = q.shape[-1]
    scale = 1.0 / dh**0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        t_q, t_k = s.shape[-2:]
        mask = torch.ones(t_q, t_k, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, v.float()) / denom
    lse = (m + torch.log(denom)).squeeze(-1)
    return out.to(q.dtype), lse


def _check(q, k, v) -> None:
    t, dh = q.shape[-2:]
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape:
            # the key loop and causal mask assume start-aligned
            # self-attention, as the TPU kernel does
            raise ValueError(
                f"flash_attention needs q, k, v of one shape, got q "
                f"{tuple(q.shape)} and {name} {tuple(x.shape)}"
            )
        if x.device != q.device:
            raise ValueError(f"q and {name} lie on {q.device} and {x.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32:
            raise TypeError(f"flash_attention takes float32, got {name} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention needs contiguous inputs; {name} is not")
    if t < 1:
        raise ValueError("flash_attention needs T >= 1")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load_library("flash_attention").gordo_flash_attention_forward_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal: bool):
    global LAUNCHES
    bh, t, dh = q.shape
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"the flash kernel supports head dims {SUPPORTED_HEAD_DIMS}, got {dh}"
        )
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    if bh == 0:
        return out, lse
    kernel = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, t, dh, 1.0 / dh**0.5, int(causal), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {rc}")
    with _launches_lock:
        LAUNCHES += 1
    return out, lse


def flash_attention_forward(q, k, v, causal: bool = False):
    """Flash attention over (..., T, Dh) float32 tensors of one shape.
    Returns ``(out, lse)``: out (..., T, Dh) and lse (..., T) float32."""
    _check(q, k, v)
    lead = q.shape[:-2]
    t, dh = q.shape[-2:]
    qf, kf, vf = (x.reshape(-1, t, dh) for x in (q, k, v))
    if q.device.type == "cpu":
        out, lse = flash_attention_forward_plain(qf, kf, vf, causal)
    elif q.device.type == "cuda":
        out, lse = _launch(qf, kf, vf, causal)
    else:
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return out.reshape(*lead, t, dh), lse.reshape(*lead, t)


def flash_attention(q, k, v, causal: bool = False):
    """Flash attention output only (see :func:`flash_attention_forward`)."""
    return flash_attention_forward(q, k, v, causal)[0]
