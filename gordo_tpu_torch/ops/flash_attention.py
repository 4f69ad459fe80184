"""
Flash attention, forward and backward: the wrappers of the hand-written
CUDA kernels, their plain PyTorch twins, and the ``torch.autograd.Function``
that joins them. Each kernel has a float32, a bf16 and an fp16 build:
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bf16.cu`` (forward;
the latter a template on the element type, bf16 and fp16),
``csrc/flash_attention_bwd.cu`` and ``csrc/flash_attention_bwd_bf16.cu``
(dQ and dK/dV, likewise).

The kernels replace the three Pallas kernels of
``gordo_tpu/ops/pallas_kernels/flash_attention.py``: ``_flash_kernel``
(blockwise online-softmax self-attention, scale 1/sqrt(dh), optional
causal mask, returning the output and the per-row logsumexp, stored here as
(BH, T) without the TPU's 128-lane replication), ``_flash_dq_kernel`` and
``_flash_dkv_kernel`` (the backward, recomputing P = exp(S - lse)). Like
the Pallas kernels, all of them take float32, bf16 or float16 inputs,
compute in float32 and write out, dq, dk and dv in the input dtype; lse is
float32. The float32 kernels run their products on the tensor cores in
3xTF32 (``csrc/mma_tf32x3.cuh``), the bf16 and fp16 kernels in their
element type with float32 sums, all three on Hopper's ``wgmma``, fed by TMA
in warp-specialised blocks (``csrc/wgmma_bf16.cuh``; in fp16, P and dS are
split with a power-of-two scale per row, which keeps them out of fp16's
subnormals); the source notes say what bounds each and what its design
does about that. The plain twins compute in float32 for every input dtype,
so they are the fp16 kernels' twins as they are the bf16 kernels'.

Head dims: 16, 32, and every multiple of 8 from 64 to 256 (the JAX
dispatcher sends every ``dh % 8 == 0, dh >= 64`` to its Pallas kernels).
Each kernel is built for a few head-dim classes and runs a dh with its
class's tiles, the columns past dh zero-filled and left unstored
(``csrc/head_dim.cuh`` names the classes).

Dispatch is by where the tensors lie: CPU tensors take the plain twins,
CUDA tensors launch the kernels or raise. There is no fallback from one to
the other.
"""

import ctypes
import functools
import threading

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIM_RULE = "16, 32 and every multiple of 8 from 64 to 256"
SUPPORTED_HEAD_DIMS = (16, 32, *range(64, 257, 8))
# The kernels take BH as a 32-bit int and count their works (a head and a
# tile of at least 64 rows) and blocks in 32-bit ints; the persistent
# kernels' loops step past the last work by at most their grid (one block
# per SM), which the headroom covers.
MIN_TILE_ROWS = 64
MAX_WORKS = 2**31 - 1 - 65536
DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# kernel launches made on CUDA tensors: the float32 forward (LAUNCHES) and
# the float32 backward's dQ and dK/dV kernels; then the same for bf16 and
# for fp16
LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
BF16_LAUNCHES = 0
BF16_DQ_LAUNCHES = 0
BF16_DKV_LAUNCHES = 0
F16_LAUNCHES = 0
F16_DQ_LAUNCHES = 0
F16_DKV_LAUNCHES = 0
# the same launches by (counter name, head dim)
HEAD_DIM_LAUNCHES = {}
_launches_lock = threading.Lock()


def _scores(q, k, causal: bool):
    """S = q k^T * scale in float32 (float64 for float64 inputs, a
    reference for the kernels' rounding), scale = 1/sqrt(dh) as the kernels
    take it; NEG_INF past the diagonal if causal."""
    dtype = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(dtype), k.to(dtype).transpose(-1, -2)) * (1.0 / q.shape[-1] ** 0.5)
    if causal:
        t_q, t_k = s.shape[-2:]
        mask = torch.ones(t_q, t_k, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    return s


def flash_attention_forward_plain(q, k, v, causal: bool = False):
    """The kernel's function in plain PyTorch. q, k, v: (..., T, Dh).
    Computes in float32 (float64 for float64 inputs) and returns
    ``(out, lse)``: out in the input dtype, lse shaped (..., T) in float32."""
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, v.to(s.dtype)) / denom
    lse = (m + torch.log(denom)).squeeze(-1)
    return out.to(q.dtype), lse


def flash_attention_backward_plain(q, k, v, o, lse, do, causal: bool = False):
    """The backward kernels' function in plain PyTorch, with their own
    arithmetic: P = exp(S - lse), D = rowsum(dO * O), dS = P * (dO V^T - D).
    q, k, v, o, do: (..., T, Dh); lse: (..., T). Every input is taken to
    float32 (float64 for float64 inputs), D from the stored ``o`` as the
    kernels read it; returns ``(dq, dk, dv)`` in the input dtype."""
    dtype = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, of, dof = (x.to(dtype) for x in (q, k, v, o, do))
    scale = 1.0 / q.shape[-1] ** 0.5
    p = torch.exp(_scores(qf, kf, causal) - lse.to(dtype).unsqueeze(-1))
    dv = torch.matmul(p.transpose(-1, -2), dof)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(*tensors, names="qkv") -> None:
    q = tensors[0]
    t = q.shape[-2]
    for name, x in zip(names[1:], tensors[1:]):
        if x.shape != q.shape:
            # the key loop and causal mask assume start-aligned
            # self-attention, as the TPU kernel does
            raise ValueError(
                f"flash_attention needs {', '.join(names)} of one shape, got q "
                f"{tuple(q.shape)} and {name} {tuple(x.shape)}"
            )
        if x.device != q.device:
            raise ValueError(f"q and {name} lie on {q.device} and {x.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32, bfloat16 or float16, got q {q.dtype}")
    for name, x in zip(names, tensors):
        if x.dtype != q.dtype:
            raise TypeError(
                f"flash_attention needs {', '.join(names)} of one dtype, got q "
                f"{q.dtype} and {name} {x.dtype}"
            )
        if not x.is_contiguous():
            raise ValueError(f"flash_attention needs contiguous inputs; {name} is not")
    if t < 1:
        raise ValueError("flash_attention needs T >= 1")


def _c_function(stem: str, symbol: str, n_pointers: int):
    fn = getattr(_build.load_library(stem), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel():
    return _c_function("flash_attention", "gordo_flash_attention_forward_f32", 5)


@functools.lru_cache(maxsize=None)
def _dq_kernel():
    return _c_function("flash_attention_bwd", "gordo_flash_attention_backward_dq_f32", 7)


@functools.lru_cache(maxsize=None)
def _dkv_kernel():
    return _c_function("flash_attention_bwd", "gordo_flash_attention_backward_dkv_f32", 8)


@functools.lru_cache(maxsize=None)
def _bf16_kernel():
    return _c_function("flash_attention_bf16", "gordo_flash_attention_forward_bf16", 5)


@functools.lru_cache(maxsize=None)
def _bf16_dq_kernel():
    return _c_function("flash_attention_bwd_bf16",
                       "gordo_flash_attention_backward_dq_bf16", 7)


@functools.lru_cache(maxsize=None)
def _bf16_dkv_kernel():
    return _c_function("flash_attention_bwd_bf16",
                       "gordo_flash_attention_backward_dkv_bf16", 8)


@functools.lru_cache(maxsize=None)
def _f16_kernel():
    return _c_function("flash_attention_bf16", "gordo_flash_attention_forward_f16", 5)


@functools.lru_cache(maxsize=None)
def _f16_dq_kernel():
    return _c_function("flash_attention_bwd_bf16",
                       "gordo_flash_attention_backward_dq_f16", 7)


@functools.lru_cache(maxsize=None)
def _f16_dkv_kernel():
    return _c_function("flash_attention_bwd_bf16",
                       "gordo_flash_attention_backward_dkv_f16", 8)


# per input dtype: the forward, dQ and dK/dV kernels' getters, their labels
# in errors and their counters (the getters are looked up at each launch,
# so a caller may stand another in)
_BY_DTYPE = {
    torch.float32: (("_kernel", "_dq_kernel", "_dkv_kernel"), "flash attention",
                    ("LAUNCHES", "DQ_LAUNCHES", "DKV_LAUNCHES")),
    torch.bfloat16: (("_bf16_kernel", "_bf16_dq_kernel", "_bf16_dkv_kernel"),
                     "bf16 flash attention",
                     ("BF16_LAUNCHES", "BF16_DQ_LAUNCHES", "BF16_DKV_LAUNCHES")),
    torch.float16: (("_f16_kernel", "_f16_dq_kernel", "_f16_dkv_kernel"),
                    "fp16 flash attention",
                    ("F16_LAUNCHES", "F16_DQ_LAUNCHES", "F16_DKV_LAUNCHES")),
}


def _kernel_of(dtype, which: int):
    """``(C function, label, counter)`` of kernel ``which`` (0 forward, 1 dQ,
    2 dK/dV) for inputs of ``dtype``."""
    getters, label, counters = _BY_DTYPE[dtype]
    return (globals()[getters[which]](), label + ("", " dQ", " dK/dV")[which],
            counters[which])


def _count(name: str, dh: int) -> None:
    with _launches_lock:
        globals()[name] += 1
        HEAD_DIM_LAUNCHES[name, dh] = HEAD_DIM_LAUNCHES.get((name, dh), 0) + 1


def check_launch_limits(bh: int, t: int, dh: int) -> None:
    """Raise, naming the limit, for a shape the kernels cannot count."""
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"the flash kernels take head dims {HEAD_DIM_RULE}, got {dh}")
    works = bh * -(-t // MIN_TILE_ROWS)
    if works > MAX_WORKS:
        raise ValueError(
            f"BH {bh} x T {t}: {works} (head, {MIN_TILE_ROWS}-row tile) works, above "
            f"the {MAX_WORKS} the kernels' 32-bit work counters take; split the batch"
        )


def _call(kernel, label: str, tensors, bh: int, t: int, dh: int, causal: bool) -> None:
    """Launch a C kernel on (bh, t, dh) CUDA tensors on the current stream,
    raising if the launch failed."""
    check_launch_limits(bh, t, dh)
    for x in tensors:
        if x.data_ptr() % 16:
            raise ValueError(f"{label}: an input is not 16-byte aligned")
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = kernel(*(x.data_ptr() for x in tensors), bh, t, dh, 1.0 / dh**0.5,
                    int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"{label} kernel launch failed: CUDA error {rc}")


def _launch(q, k, v, causal: bool):
    bh, t, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    if bh == 0:
        return out, lse
    kernel, label, counter = _kernel_of(q.dtype, 0)
    _call(kernel, label, (q, k, v, out, lse), bh, t, dh, causal)
    _count(counter, dh)
    return out, lse


def launch_dq(q, k, v, o, lse, do, causal: bool):
    """dQ by the CUDA kernel of the inputs' dtype: (bh, t, dh) tensors and
    lse (bh, t)."""
    bh, t, dh = q.shape
    dq = torch.empty_like(q)
    if bh == 0:
        return dq
    kernel, label, counter = _kernel_of(q.dtype, 1)
    _call(kernel, label, (q, k, v, o, lse, do, dq), bh, t, dh, causal)
    _count(counter, dh)
    return dq


def launch_dkv(q, k, v, o, lse, do, causal: bool):
    """(dK, dV) by the CUDA kernel of the inputs' dtype: (bh, t, dh) tensors
    and lse (bh, t)."""
    bh, t, dh = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if bh == 0:
        return dk, dv
    kernel, label, counter = _kernel_of(q.dtype, 2)
    _call(kernel, label, (q, k, v, o, lse, do, dk, dv), bh, t, dh, causal)
    _count(counter, dh)
    return dk, dv


def flash_attention_forward(q, k, v, causal: bool = False):
    """Flash attention over (..., T, Dh) tensors of one shape and one dtype,
    float32, bfloat16 or float16. Returns ``(out, lse)``: out (..., T, Dh) in that
    dtype and lse (..., T) float32."""
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


def flash_attention_backward(q, k, v, o, lse, do, causal: bool = False):
    """Gradients ``(dq, dk, dv)`` of flash attention over (..., T, Dh)
    tensors of one dtype (float32, bfloat16 or float16), from the forward's output
    ``o`` and float32 logsumexp ``lse`` (..., T) and the output's gradient
    ``do``. On CUDA tensors the dQ kernel, then the dK/dV kernel, on the
    current stream."""
    _check(q, k, v, o, do, names=("q", "k", "v", "o", "do"))
    lead = q.shape[:-2]
    t, dh = q.shape[-2:]
    if lse.shape != lead + (t,) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(
            f"lse must be float32 of shape {tuple(lead) + (t,)} on {q.device}, got "
            f"{lse.dtype} {tuple(lse.shape)} on {lse.device}"
        )
    flat = [x.reshape(-1, t, dh) for x in (q, k, v, o)]
    lse_f, do_f = lse.contiguous().reshape(-1, t), do.reshape(-1, t, dh)
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_backward_plain(*flat, lse_f, do_f, causal)
    elif q.device.type == "cuda":
        dq = launch_dq(*flat, lse_f, do_f, causal)
        dk, dv = launch_dkv(*flat, lse_f, do_f, causal)
    else:
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return tuple(g.reshape(*lead, t, dh) for g in (dq, dk, dv))


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward kernel, then the dQ
    and dK/dV kernels, the counterpart of the JAX package's
    ``jax.custom_vjp`` around ``_flash_forward`` / ``_flash_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout.contiguous(), ctx.causal
        )
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False):
    """Flash attention output, differentiable through the backward kernels
    (see :func:`flash_attention_forward`)."""
    return FlashAttention.apply(q, k, v, causal)
