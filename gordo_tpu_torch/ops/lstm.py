"""
The LSTM recurrence: the wrappers of the hand-written CUDA kernel pair
(``csrc/lstm_recurrence.cu``), their plain PyTorch twins, and the
``torch.autograd.Function`` that joins them.

The JAX package's LSTM layer (``_apply_lstm``, ``gordo_tpu/ops/nn.py:205``)
is one ``lax.scan`` over the concatenated ``[x_t, h] @ [kernel;
recurrent_kernel]`` product, not a Pallas kernel. The port splits it as
cuDNN does (ops/nn.py ``_apply_lstm``): ``Zx = X @ kernel + bias`` for
every time step as one matmul, then the recurrence here over M stacked
layers (a leading machine axis; M = 1 for one model):

    z_t = Zx_t + h_{t-1} @ recurrent_kernel
    i, f, g, o = rec(z_i), rec(z_f), act(z_g), rec(z_o)     (gate order i, f, g, o)
    c_t = f * c_{t-1} + i * g;   h_t = o * act(c_t)

c and h are carried in float32. Under bf16 the product takes h rounded to
bf16 and the pre-activation z is rounded to bf16 before it is taken to
float32, where the JAX code rounds; the outputs are h in the input dtype.
The backward gives dZ of every step (the kernel's reverse sweep); the
recurrent kernel's gradient ``sum_t h_{t-1}^T dz_t`` is one batched matmul
here, and the input projection's gradients are autograd's through its
matmul.

Dispatch is by where the tensors lie: CPU tensors take the plain twins
(the step loop in torch, used by the CPU tests), CUDA tensors launch the
kernels or raise. There is no fallback from one to the other.

On the card each launch takes the route, cluster, row tile and k split of
the CUDA source's plan (``csrc/lstm_plan.cuh``, asked through
``gordo_lstm_plan``): the tensor-core kernels with R held in a cluster's
shared memory or streamed from L2, or the first port's CUDA-core kernels
(the legacy route: below U 8, for float32 U <= 64 over at most 132 rows,
and where no tensor-core route holds the buffers; ``batch_tile`` picks its
rows). ``set_route`` forces a route or plan for measurements and the card's
tests.
"""

import ctypes
import functools
import threading
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .activations import ACTIVATION_CODES, ACTIVATION_GRADS, activation

DTYPES = (torch.float32, torch.bfloat16)
# grid.y of the kernels (csrc/lstm_recurrence.cu) holds the machines
MAX_MACHINES = 65535
# the legacy route's batch tiles, and the blocks its tile aims at: two a
# streaming multiprocessor
BATCH_TILES = (1, 2, 4, 8)
TARGET_BLOCKS = 2 * 132

# kernel launches made on CUDA tensors: the float32 forward and backward,
# then the same for bf16
FORWARD_LAUNCHES = 0
BACKWARD_LAUNCHES = 0
BF16_FORWARD_LAUNCHES = 0
BF16_BACKWARD_LAUNCHES = 0
# the same launches by (counter name, units U)
UNIT_LAUNCHES: Dict[Tuple[str, int], int] = {}
_launches_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def activation_code(name: str) -> int:
    """The kernels' code of an activation; an unknown name raises the
    port's ValueError."""
    activation(name)
    return ACTIVATION_CODES.index(name)


# ------------------------------------------------------------ the twins
def lstm_recurrence_forward_plain(zx, rk, act: str = "tanh", rec: str = "sigmoid",
                                  return_sequences: bool = False, training: bool = False):
    """The forward kernel's function in plain PyTorch. zx (M, B, T, 4U) and
    rk (M, U, 4U) of one dtype; computes in float32 (float64 for float64
    inputs, a reference for the kernels' rounding). Returns ``(out,
    saved)``: out (M, B, T, U) with ``return_sequences``, else the last
    step's (M, B, U), in that dtype; with ``training``, saved is ``(z, c,
    h)`` of every step (z (M, B, T, 4U) and c (M, B, T, U) in the compute
    dtype, h in the input dtype), else None."""
    m, b, t, g4 = zx.shape
    u = g4 // 4
    dtype = zx.dtype
    calc = torch.promote_types(dtype, torch.float32)
    act_fn, rec_fn = activation(act), activation(rec)
    rk_c = rk.to(calc)
    h = torch.zeros((m, b, u), dtype=calc, device=zx.device)
    c = torch.zeros_like(h)
    zs, cs, hs = [], [], []
    for step in range(t):
        z = (zx[:, :, step].to(calc) + torch.bmm(h.to(dtype).to(calc), rk_c)).to(dtype).to(calc)
        zi, zf, zg, zo = z.split(u, dim=-1)
        c = rec_fn(zf) * c + rec_fn(zi) * act_fn(zg)
        h = rec_fn(zo) * act_fn(c)
        if training:
            zs.append(z)
            cs.append(c)
        if training or return_sequences:
            hs.append(h.to(dtype))
    out = torch.stack(hs, dim=2) if return_sequences else h.to(dtype)
    if not training:
        return out, None
    return out, (torch.stack(zs, dim=2), torch.stack(cs, dim=2), torch.stack(hs, dim=2))


def lstm_recurrence_backward_plain(dout, z, c, rk, act: str = "tanh", rec: str = "sigmoid",
                                   return_sequences: bool = False):
    """The backward kernel's function in plain PyTorch, with its arithmetic:
    from dout (the output's gradient, (M, B, T, U) or (M, B, U), in rk's
    dtype) and the forward's saved z and c, dZ (M, B, T, 4U) in rk's dtype,
    each step's dz and recurrent dh rounded to it; computed in float32
    (float64 for float64 inputs)."""
    m, b, t, g4 = z.shape
    u = g4 // 4
    dtype = rk.dtype
    calc = torch.promote_types(dtype, torch.float32)
    act_fn, rec_fn = activation(act), activation(rec)
    act_grad, rec_grad = ACTIVATION_GRADS[act], ACTIVATION_GRADS[rec]
    z, c = z.to(calc), c.to(calc)
    rkt = rk.to(calc).transpose(1, 2)
    dh_rec = torch.zeros((m, b, u), dtype=calc, device=z.device)
    dc = torch.zeros_like(dh_rec)
    dz_all = torch.empty((m, b, t, g4), dtype=dtype, device=z.device)
    for step in reversed(range(t)):
        dh = dh_rec
        if return_sequences:
            dh = dh + dout[:, :, step].to(calc)
        elif step == t - 1:
            dh = dh + dout.to(calc)
        zi, zf, zg, zo = z[:, :, step].split(u, dim=-1)
        ct = c[:, :, step]
        c_prev = c[:, :, step - 1] if step else torch.zeros_like(ct)
        d_o = dh * act_fn(ct)
        dc = dc + dh * rec_fn(zo) * act_grad(ct)
        dz = torch.cat([dc * act_fn(zg) * rec_grad(zi), dc * c_prev * rec_grad(zf),
                        dc * rec_fn(zi) * act_grad(zg), d_o * rec_grad(zo)], dim=-1).to(dtype)
        dc = dc * rec_fn(zf)
        dz_all[:, :, step] = dz
        dh_rec = torch.bmm(dz.to(calc), rkt).to(dtype).to(calc)
    return dz_all


# ------------------------------------------------------------ the kernels
# the plan's routes (csrc/lstm_plan.cuh ``Route``): the tensor-core kernels
# with R held in a cluster's shared memory or streamed from L2, and the
# legacy CUDA-core kernels
ROUTES = ("legacy", "cluster", "stream")


def batch_tile(m: int, b: int) -> int:
    """Rows a block of the legacy route takes: the smallest tile that keeps
    the blocks at most TARGET_BLOCKS, else the largest."""
    for bt in BATCH_TILES:
        if m * -(-b // bt) <= TARGET_BLOCKS:
            return bt
    return BATCH_TILES[-1]


@functools.lru_cache(maxsize=1024)
def check_launch_limits(m: int, b: int, u: int, elem_bytes: int = 4) -> None:
    """Raise, naming the limit, for a shape the kernels cannot launch: the
    machines against grid.y, and the forward's and the backward's plan (the
    CUDA source's own, ``gordo_lstm_plan``: a tensor-core route, else the
    legacy route's step buffers at the chosen batch tile against the shared
    memory a block takes) for inputs of ``elem_bytes``."""
    if m > MAX_MACHINES:
        raise ValueError(
            f"{m} stacked layers: the LSTM kernels take at most {MAX_MACHINES} (grid.y); "
            f"split the machines")
    bt = batch_tile(m, b)
    for backward in (False, True):
        rc, plan = _plan(m, b, u, bt, elem_bytes, backward)
        if rc != 0:
            raise ValueError(
                f"LSTM units {u}: no tensor-core route holds the "
                f"{'backward' if backward else 'forward'} kernel's buffers, and the legacy "
                f"step buffers need {plan['smem_bytes']} bytes of shared memory at batch tile "
                f"{bt}, more than a block takes")


def bind(lib: ctypes.CDLL, backward: bool, dtype: torch.dtype):
    """The forward or backward entry point of a build of the CUDA source
    for ``dtype``, typed for ctypes."""
    name = "backward" if backward else "forward"
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    fn = getattr(lib, f"gordo_lstm_{name}_{suffix}")
    fn.argtypes = [ctypes.c_void_p] * (5 if backward else 6) + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel(backward: bool, dtype: torch.dtype):
    return bind(_build.load_library("lstm_recurrence"), backward, dtype)


def _plan_library() -> ctypes.CDLL:
    """The library whose ``gordo_lstm_plan`` plans the launches: the
    kernels' own (the CPU tests stand in a host build of csrc/lstm_plan.cuh)."""
    return _build.load_library("lstm_recurrence")


PLAN_FIELDS = ("route", "rows", "cluster", "threads", "smem_bytes", "r_in_smem", "tiles_a_warp",
               "ksplit")


def _plan(m: int, b: int, u: int, bt: int, elem_bytes: int, backward: bool
          ) -> Tuple[int, dict]:
    fn = _plan_library().gordo_lstm_plan
    out = [ctypes.c_int() for _ in PLAN_FIELDS]
    rc = fn(m, b, u, bt, elem_bytes, int(backward), *(ctypes.byref(x) for x in out))
    plan = dict(zip(PLAN_FIELDS, (x.value for x in out)))
    plan["route"] = ROUTES[plan["route"]]
    plan["r_in_smem"] = bool(plan["r_in_smem"])
    return rc, plan


def kernel_plan(m: int, b: int, u: int, dtype: torch.dtype, backward: bool) -> dict:
    """The plan a launch of (M, B, U) in ``dtype`` takes, for reports: its
    route, batch rows and cluster of a CTA, threads, dynamic shared memory,
    whether R sits in it, the n-tiles a forward warp takes and the warps
    that split a tile's K."""
    rc, plan = _plan(m, b, u, batch_tile(m, b), torch.tensor([], dtype=dtype).element_size(),
                     backward)
    if rc != 0:
        raise RuntimeError(f"LSTM kernel plan failed: CUDA error {rc}")
    return plan


def set_route(route: Optional[str] = None, cluster: Optional[int] = None,
              rows: Optional[int] = None, ksplit: Optional[int] = None) -> None:
    """Make every later launch take ``route`` (one of ROUTES) and, on a
    tensor-core route, ``cluster`` CTAs a cluster, ``rows`` batch rows a CTA
    and ``ksplit`` warps a tile; None leaves each to the plan's rule. A
    measurement hook (scripts/torch_lstm_ab.py and the card's tests hold and
    time each route and plan with one library). The library keeps the
    forcing, and its plan (``kernel_plan``, ``check_launch_limits``) follows
    it. A launch the forced plan cannot take raises."""
    forced = (-1 if route is None else ROUTES.index(route), cluster or -1, rows or -1,
              ksplit or -1)
    rc = _plan_library().gordo_lstm_set_route(*forced)
    if rc != 0:
        raise RuntimeError(f"gordo_lstm_set_route{forced} failed: CUDA error {rc}")
    check_launch_limits.cache_clear()


def kernel_attributes(backward: bool, dtype: torch.dtype, constants: bool = True,
                      tiles_a_warp: int = 1, ksplit: int = 1, held: bool = True) -> dict:
    """Registers, spilled (local) bytes and most threads a block of one
    built tensor-core instantiation (cudaFuncGetAttributes): the forward's
    layouts (tiles_a_warp, ksplit) (1, 1), (1, 2) and (2, 1), the
    backward's ksplit 1, 2 and 4."""
    fn = _build.load_library("lstm_recurrence").gordo_lstm_kernel_attributes
    out = (ctypes.c_int * 3)()
    rc = fn(int(backward), int(dtype == torch.bfloat16), int(constants), tiles_a_warp, ksplit,
            int(held), out)
    if rc != 0:
        raise RuntimeError(f"gordo_lstm_kernel_attributes failed: CUDA error {rc}")
    return {"registers": out[0], "local_bytes": out[1], "max_threads": out[2]}


def _count(name: str, u: int) -> None:
    with _launches_lock:
        globals()[name] += 1
        UNIT_LAUNCHES[name, u] = UNIT_LAUNCHES.get((name, u), 0) + 1


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _call(fn, label: str, tensors, m: int, b: int, t: int, u: int, act: str, rec: str,
          return_sequences: bool, device) -> None:
    check_launch_limits(m, b, u, tensors[0].element_size())
    args = (*(_ptr(x) for x in tensors), m, b, t, u, batch_tile(m, b), activation_code(act),
            activation_code(rec), int(return_sequences))
    if device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{label} kernel launch failed: CUDA error {rc}")


def _launch_forward(zx, rk, act, rec, return_sequences, training):
    m, b, t, g4 = zx.shape
    u = g4 // 4
    out = torch.empty((m, b, t, u) if return_sequences else (m, b, u), dtype=zx.dtype,
                      device=zx.device)
    saved = None
    if training:
        z = torch.empty((m, b, t, g4), dtype=torch.float32, device=zx.device)
        c = torch.empty((m, b, t, u), dtype=torch.float32, device=zx.device)
        h = out if return_sequences else torch.empty((m, b, t, u), dtype=zx.dtype,
                                                     device=zx.device)
        saved = (z, c, h)
    if m * b * t == 0:
        return out, saved
    # with return_sequences the output is the saved h: written once
    h_save = saved[2] if training and not return_sequences else None
    _call(_kernel(False, zx.dtype), "LSTM forward",
          (zx, rk, out, h_save, *(saved[:2] if training else (None, None))),
          m, b, t, u, act, rec, return_sequences, zx.device)
    _count("BF16_FORWARD_LAUNCHES" if zx.dtype == torch.bfloat16 else "FORWARD_LAUNCHES", u)
    return out, saved


def _launch_backward(dout, z, c, rk, act, rec, return_sequences):
    m, b, t, g4 = z.shape
    dz = torch.empty((m, b, t, g4), dtype=rk.dtype, device=z.device)
    if m * b * t == 0:
        return dz
    rkt = rk.transpose(1, 2).contiguous()
    _call(_kernel(True, rk.dtype), "LSTM backward", (dout, z, c, rkt, dz),
          m, b, t, g4 // 4, act, rec, return_sequences, z.device)
    _count("BF16_BACKWARD_LAUNCHES" if rk.dtype == torch.bfloat16 else "BACKWARD_LAUNCHES",
           g4 // 4)
    return dz


def _check(zx, rk) -> None:
    if zx.dim() != 4 or rk.dim() != 3:
        raise ValueError(f"the LSTM recurrence takes zx (M, B, T, 4U) and rk (M, U, 4U), got "
                         f"{tuple(zx.shape)} and {tuple(rk.shape)}")
    m, _, _, g4 = zx.shape
    if g4 % 4 or tuple(rk.shape) != (m, g4 // 4, g4):
        raise ValueError(f"zx {tuple(zx.shape)} and rk {tuple(rk.shape)} do not match")
    if zx.dtype not in DTYPES or rk.dtype != zx.dtype:
        raise TypeError(f"the LSTM recurrence takes float32 or bfloat16 zx and rk of one dtype, "
                        f"got {zx.dtype} and {rk.dtype}")
    if zx.device != rk.device:
        raise ValueError(f"zx and rk lie on {zx.device} and {rk.device}")


def lstm_recurrence_forward(zx, rk, act: str = "tanh", rec: str = "sigmoid",
                            return_sequences: bool = False, training: bool = False
                            ) -> Tuple[torch.Tensor, Optional[tuple]]:
    """The recurrence's forward over (M, B, T, 4U) zx and (M, U, 4U) rk:
    the kernel on CUDA tensors, the plain twin on CPU tensors (see
    :func:`lstm_recurrence_forward_plain` for what it returns)."""
    _check(zx, rk)
    zx, rk = zx.contiguous(), rk.contiguous()
    if zx.device.type == "cpu":
        return lstm_recurrence_forward_plain(zx, rk, act, rec, return_sequences, training)
    if zx.device.type == "cuda":
        return _launch_forward(zx, rk, act, rec, return_sequences, training)
    raise ValueError(f"the LSTM recurrence runs on cuda or cpu, not {zx.device}")


def lstm_recurrence_backward(dout, z, c, rk, act: str = "tanh", rec: str = "sigmoid",
                             return_sequences: bool = False) -> torch.Tensor:
    """dZ (M, B, T, 4U) from the output's gradient and the training
    forward's z and c: the kernel on CUDA tensors, the plain twin on CPU
    tensors."""
    dout = dout.to(rk.dtype).contiguous()
    if z.device.type == "cpu":
        return lstm_recurrence_backward_plain(dout, z, c, rk, act, rec, return_sequences)
    if z.device.type == "cuda":
        return _launch_backward(dout, z, c, rk.contiguous(), act, rec, return_sequences)
    raise ValueError(f"the LSTM recurrence runs on cuda or cpu, not {z.device}")


def recurrent_kernel_grad(h: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """sum_t h_{t-1}^T dz_t (h_{-1} = 0) of every stacked layer: h (M, B, T,
    U) and dz (M, B, T, 4U) in one dtype, one batched matmul -> (M, U, 4U)."""
    m, b, t, u = h.shape
    h_prev = torch.cat([torch.zeros_like(h[:, :, :1]), h[:, :, :-1]], dim=2)
    return torch.bmm(h_prev.reshape(m, b * t, u).transpose(1, 2), dz.reshape(m, b * t, 4 * u))


class LSTMRecurrence(torch.autograd.Function):
    """The recurrence with its backward: the forward kernel (storing z, c
    and h when a gradient is wanted), then the backward kernel and the
    recurrent kernel's gradient as one batched matmul."""

    @staticmethod
    def forward(ctx, zx, rk, act: str, rec: str, return_sequences: bool, training: bool):
        out, saved = lstm_recurrence_forward(zx, rk, act, rec, return_sequences, training)
        ctx.act, ctx.rec, ctx.return_sequences = act, rec, return_sequences
        if training:
            ctx.save_for_backward(rk, *saved)
        return out

    @staticmethod
    def backward(ctx, dout):
        rk, z, c, h = ctx.saved_tensors
        dz = lstm_recurrence_backward(dout, z, c, rk, ctx.act, ctx.rec, ctx.return_sequences)
        return dz, recurrent_kernel_grad(h, dz), None, None, None, None


def lstm_recurrence(zx, rk, act: str = "tanh", rec: str = "sigmoid",
                    return_sequences: bool = False) -> torch.Tensor:
    """The recurrence's output, differentiable through the backward kernel
    when a gradient is wanted (see :func:`lstm_recurrence_forward`)."""
    training = torch.is_grad_enabled() and (zx.requires_grad or rk.requires_grad)
    return LSTMRecurrence.apply(zx, rk, act, rec, return_sequences, training)

