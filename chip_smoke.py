"""
Drive the PyTorch/CUDA port (gordo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

1. Device: the card's name and power limit, CUDA version; TF32 is turned
   off for matmuls and cuDNN, so every reference below is float32.
2. Build: every kernel of ``gordo_tpu_torch/ops/csrc`` with nvcc, the
   sources compiled in parallel.
3. Kernel phases: the forward kernel, then the dQ and dK/dV kernels, each
   against its plain PyTorch version on the card at the main paths'
   shapes (and ragged, small-head and large-head shapes), with the times
   of the kernel, the plain version, the bound, and the PyTorch library
   call that computes the same function (timed here only as a yardstick).
   The forward is timed at the serving shape and at the training shape.
   The backward kernels must also give bit-identical results twice, and at
   the training shape each is read against a float64 plain backward beside
   plain float32's own error: dQ's may be at most F64_ERR_FACTOR times
   plain float32's. The build's registers and spills (``-Xptxas -v``),
   each kernel's shared memory and blocks per SM, and the tensor-core
   instructions in its SASS (``cuobjdump``, where the toolkit has it) are
   printed: the three bf16 kernels, built on ``wgmma``, must hold HGMMA and
   no HMMA, the three float32 ``mma.sync`` kernels HMMA. Each timed entry
   gets its achieved TFLOP/s and the share of its bound it reaches; the
   ``wgmma`` kernels' host time of encoding their TMA tensor maps is
   printed beside their registers. All six are also held against their
   plain twins at the fleet's training shape (FLEET_SHAPE, BH 1,024; the
   float32 and bf16 gates above) and timed there beside their bounds and
   ``scaled_dot_product_attention``.
4. Serving path: a ``transformer-ae-512`` artifact (TransformerAutoEncoder,
   lookback 512, d_model 256, 4 heads, ff 512, 2 blocks, 8 tags; weights
   from a seed) is served by the port's HTTP server on the card, and three
   anomaly requests (1,535, 700 and 1,535 rows) are checked: status, blocks,
   row counts, finite values, one kernel launch per Transformer block per
   request, and the first answer's model output against the same model with
   the plain attention.
5. Server surface: the same artifact served as ``run-server`` serves it,
   with ``EXPECTED_MODELS`` naming it: every GET route (readiness met, and
   unmet for a sibling revision without the model), three base requests
   (``POST …/prediction``; 1,535, 700 and 1,535 rows), each one forward
   launch per block, its model output equal to the anomaly route's and
   the first held against plain attention, and ``download-model``'s bytes
   loaded back on the card, predicting as served.
6. Build path: one step's gradients and the first 20 step losses of the
   model against the same parameters with the plain attention; then the
   ``transformer-ae-512`` machine is built from its config
   (``BUILD_CONFIG``: RandomDataset, 6,144 rows, a ``DiffBasedAnomalyDetector``
   over ``Pipeline[MinMaxScaler, TransformerAutoEncoder]``, Adam, MSE, batch
   32) by ``ModelBuilder`` on the card: 3-fold CV with the default scorers
   and a fit, 420 steps, two dQ and two dK/dV launches per step. Its phase
   seconds, ms per step, CV scores, losses, held-out error (against the
   seeded initial weights) and thresholds are printed and checked; a second
   build must come from the register's cache and launch nothing; the CLI
   (``python -m gordo_tpu_torch build``) builds it once more in a
   subprocess; the built artifact answers one request and its metadata
   request through the server.
7. bf16: the bf16 forward, dQ and dK/dV kernels against their plain twins
   on bf16 inputs at the same shapes (every element within one bf16 ulp of
   the twin's, at most 1% of them different at all, lse within 1e-5
   relative, bit-identical backward reruns; dQ also within that gate of the
   float64 result rounded to bf16), timed beside their bounds at
   the bf16 rate and ``scaled_dot_product_attention`` on the same bf16
   inputs; then ``transformer-ae-512-bf16`` (``BUILD_CONFIG`` with
   ``compute_dtype: bfloat16``) is built by ``ModelBuilder`` on the card and
   checked as above, its training and predicts going through the bf16
   kernels alone, and the built artifact answers a 1,535-row request whose
   model output is held against the same bf16 model with plain attention.
8. Fleet: eight ``transformer-ae-512`` machines (each its own tags, so its
   own data) built by ``BatchedModelBuilder`` on the card, in float32 and
   in bf16: every machine from the stacked program, one dQ and one dK/dV
   launch per block a stacked step for the whole bucket (attention BH =
   machines x batch x heads), no plain attention, each machine's held-out
   error below its seeded weights', finite thresholds; the wall, ms per
   stacked step and peak memory beside the serial build x 8. A two-machine
   bucket against the serial model on the same parameters: one batch's
   output and parameter gradients (float32 within TOL_GRAD_REL, bf16
   within TOL_BF16_MODEL_REL), then 20 float32 step losses against the
   serial trainer's on the same orders; ``python -m gordo_tpu_torch batch-build`` in a
   subprocess, and one of its artifacts answering a base and an anomaly
   request.
9. A ``kernels`` JSON line (six entries: three float32, three bf16), then
   the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failure raises, so the exit code is not 0 and no result line is
printed. Without CUDA, or outside a checkout, it exits 2 at once.
"""

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 0
TAGS = [f"tag-{i}" for i in range(8)]
CONFIG = dict(kind="transformer_model", lookback_window=512, d_model=256, num_heads=4,
              ff_dim=512, num_blocks=2, causal=True, pool="last", attention="auto")
REQUEST_ROWS = (1535, 700, 1535)
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s
# on the CUDA cores, and TF32 FLOP/s on the tensor cores. The three
# kernels do float32-accurate products in 3xTF32 (three TF32 products
# each), so their least time is set at a third of the TF32 rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32X3_FLOP_PER_S = 495e12 / 3
# the kernels' operations at their dtype's tensor-core rate: 3xTF32 for the
# float32 kernels, the dense bf16 rate for the bf16 kernels
PEAK_FLOP_PER_S = {"float32": TF32X3_FLOP_PER_S, "bfloat16": 989e12}
TOL_OUT_REL = 1e-4  # kernel vs plain, float32, sums in another order
TOL_LSE_ABS = 1e-4
TOL_MODEL_REL = 1e-4  # served model output vs the same model with plain attention
TRAIN_SHAPE = (128, 512, 64)  # one training step's attention: batch 32 x 4 heads
BACKWARD_SHAPES = [(TRAIN_SHAPE, True), (TRAIN_SHAPE, False), ((16, 144, 16), True),
                   ((6, 77, 32), False), ((4, 200, 128), True), ((1, 1, 64), True)]
TOL_GRAD_REL = 1e-4  # backward kernels vs plain, and one step's parameter gradients
TOL_LOSS_REL = 1e-3  # 20 step losses, flash vs plain attention
# dQ against a float64 plain backward: within this factor of plain float32's
# own error against it (3xTF32 keeps ~22 of float32's 24 bits)
F64_ERR_FACTOR = 4.0
BATCH = 32
LOSS_STEPS = 20
SERVE_SHAPE = (1024 * 4, 512, 64)  # 1,024 windows x 4 heads of the main path
# bf16 kernels vs their twins: each element within one bf16 ulp
# (|a - b| <= 2^-7 max(|a|, |b|) + 1e-6), at most 1% of the elements
# different at all, lse within 1e-5 relative (absolute below 1); gradient
# elements that are exactly 0 in float64 are rounding noise (_bf16_gate)
BF16_ULP = 2.0 ** -7
TOL_BF16_SHARE = 0.01
TOL_BF16_LSE_REL = 1e-5
# the served bf16 model vs the same model with plain attention: the JAX
# package's own bf16 tolerance (tests/gordo_tpu/test_attention_models.py)
TOL_BF16_MODEL_REL = 2e-2
# FLOP per visible (query, key) pair, per dh: float32 (3xTF32 counted once)
# and bf16, where P and dS go through three bf16 products
# (gordo_tpu_torch/ops/csrc/wgmma_bf16.cuh)
FLOP_PER_PAIR = {"float32": {"forward": 4, "dq": 6, "dkv": 8},
                 "bfloat16": {"forward": 8, "dq": 10, "dkv": 16}}
def build_config(name: str, tags=TAGS, **estimator) -> dict:
    """A transformer-ae-512 machine: 6,144 ten-minute RandomDataset rows of
    ``tags``, the model written with the JAX package's paths (``estimator``
    added to the TransformerAutoEncoder's arguments), the default CV and
    metrics."""
    return {
        "name": name,
        "dataset": {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00+00:00",
                    "train_end_date": "2020-02-12T16:00:00+00:00", "tags": list(tags),
                    "resolution": "10min"},
        "model": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {
            "base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
                "sklearn.preprocessing.MinMaxScaler",
                {"gordo_tpu.models.models.TransformerAutoEncoder": {
                    **CONFIG, "epochs": 1, "batch_size": BATCH, **estimator}},
            ]}}}},
        "evaluation": {"cv_mode": "full_build", "seed": 0},
    }


BUILD_CONFIG = build_config("transformer-ae-512")
# every width the same, at the JAX package's TPU compute dtype for windowed
# fleets (bench.py)
BUILD_CONFIG_BF16 = build_config("transformer-ae-512-bf16", compute_dtype="bfloat16")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _sdpa_ms(q, k, v, iters: int, do=None) -> dict:
    """``scaled_dot_product_attention`` (causal) on the same (BH, T, dh)
    inputs, its forward or, with ``do``, its backward through autograd:
    given as one (1, BH, T, dh) batch, where PyTorch may pick its fused
    kernels (``library_ms``), and as the (BH, T, dh) tensors themselves
    (``library_3d_ms``, which takes its unfused path)."""
    import torch
    import torch.nn.functional as F

    times = {}
    for key, view in (("library_ms", lambda x: x.unsqueeze(0)),
                      ("library_3d_ms", lambda x: x)):
        if do is None:
            qv, kv, vv = (view(x) for x in (q, k, v))
            times[key] = _time_ms(
                lambda: F.scaled_dot_product_attention(qv, kv, vv, is_causal=True), iters)
        else:
            leaves = [view(x).clone().requires_grad_() for x in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=True)
            grad = view(do)
            times[key] = _time_ms(
                lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True), iters)
    return times


def _flash_bound_ms(bh: int, t: int, dh: int, causal: bool, n_tensors: int = 4,
                    flop_per_pair: int = 4, bytes_per_element: int = 4,
                    dtype: str = "float32") -> dict:
    """The least time of the work: ``n_tensors`` (bh, t, dh) tensors of
    ``bytes_per_element`` read or written once plus the float32 lse, and
    ``flop_per_pair * dh`` FLOP per visible (query, key) pair at the
    tensor-core rate of ``dtype`` (PEAK_FLOP_PER_S). The forward moves
    q/k/v/out (4), dQ q/k/v/o/dO/dQ (6), dK/dV q/k/v/o/dO/dK/dV (7); the
    FLOP per pair are FLOP_PER_PAIR's. For float32, ``fp32_core_bound_ms``
    takes the operations at the CUDA cores' float32 rate."""
    n_bytes = bytes_per_element * n_tensors * bh * t * dh + 4 * bh * t
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = flop_per_pair * dh * bh * pairs
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOP_PER_S[dtype]
    bound = {"bound_ms": 1e3 * max(by_bytes, by_ops),
             "bound_by": "bytes" if by_bytes > by_ops else "operations",
             "flop": flops, "bytes": n_bytes}
    if dtype == "float32":
        bound["fp32_core_bound_ms"] = 1e3 * max(by_bytes, flops / FP32_FLOP_PER_S)
    return bound


def _rates(timed: dict) -> dict:
    """The achieved rate of a timed entry (``ms`` beside ``_flash_bound_ms``'s
    ``flop`` and ``bound_ms``): TFLOP/s, and the share of the bound it
    reaches."""
    return {"achieved_tflop_s": timed["flop"] / (timed["ms"] * 1e9),
            "bound_share": timed["bound_ms"] / timed["ms"]}


def _occupancy() -> dict:
    """Per tensor-core kernel and head dim: its dynamic shared memory and
    the blocks of it that one SM holds (``cudaOccupancy...``)."""
    import ctypes

    from gordo_tpu_torch.ops import _build

    report = {}
    for name, stem, symbol in (
        ("flash_attention_forward", "flash_attention",
         "gordo_flash_attention_forward_f32_occupancy"),
        ("flash_attention_backward_dq", "flash_attention_bwd",
         "gordo_flash_attention_backward_dq_f32_occupancy"),
        ("flash_attention_backward_dkv", "flash_attention_bwd",
         "gordo_flash_attention_backward_dkv_f32_occupancy"),
        ("flash_attention_forward_bf16", "flash_attention_bf16",
         "gordo_flash_attention_forward_bf16_occupancy"),
        ("flash_attention_backward_dq_bf16", "flash_attention_bwd_bf16",
         "gordo_flash_attention_backward_dq_bf16_occupancy"),
        ("flash_attention_backward_dkv_bf16", "flash_attention_bwd_bf16",
         "gordo_flash_attention_backward_dkv_bf16_occupancy"),
    ):
        fn = getattr(_build.load_library(stem), symbol)
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for dh in (16, 32, 64, 128):
            smem, blocks = ctypes.c_int(), ctypes.c_int()
            rc = fn(dh, ctypes.byref(smem), ctypes.byref(blocks))
            if rc != 0:
                raise RuntimeError(f"{symbol}({dh}) failed: CUDA error {rc}")
            report.setdefault(name, {})[dh] = {"smem_bytes": smem.value,
                                               "blocks_per_sm": blocks.value}
            print(f"  {name} dh {dh}: {smem.value} B shared memory, "
                  f"{blocks.value} blocks per SM", flush=True)
    return report


def _sass_mma(libs: dict) -> dict:
    """Tensor-core instructions per kernel in the built libraries' SASS:
    ``{function: {"HMMA": n, "HGMMA": n}}`` (``mma.sync`` compiles to HMMA,
    ``wgmma`` to HGMMA), where the toolkit has ``cuobjdump``; empty without
    it."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        print("  cuobjdump not found: SASS not inspected", flush=True)
        return {}
    counts = {}
    for path in libs.values():
        sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        function = None
        for line in sass.splitlines():
            if "Function :" in line:
                function = line.split("Function :")[1].strip()
                counts.setdefault(function, {"HMMA": 0, "HGMMA": 0})
            elif function:
                for op in ("HGMMA", "HMMA"):
                    if op in line:
                        counts[function][op] += 1
    for function, n in sorted(counts.items()):
        print(f"  SASS {function}: {n['HMMA']} HMMA, {n['HGMMA']} HGMMA", flush=True)
    return counts


# the wgmma kernels: their C symbol prefix, the source stem, and the
# __global__ name in the build log
WGMMA_KERNELS = {
    "flash_attention_forward_bf16": ("gordo_flash_attention_forward_bf16", "flash_attention_bf16",
                                     "flash_forward_bf16"),
    "flash_attention_backward_dq_bf16": ("gordo_flash_attention_backward_dq_bf16",
                                         "flash_attention_bwd_bf16", "flash_bwd_dq_bf16"),
    "flash_attention_backward_dkv_bf16": ("gordo_flash_attention_backward_dkv_bf16",
                                          "flash_attention_bwd_bf16", "flash_bwd_dkv_bf16"),
}


def _ptxas(stem: str, kernel: str) -> dict:
    """``{dh: (registers, spill store bytes)}`` of ``kernel``'s instantiations
    from the ``-Xptxas -v`` output of this build of ``stem`` (empty when
    the library was loaded as built)."""
    from gordo_tpu_torch.ops import _build

    report, dh = {}, None
    for line in _build.BUILD_LOGS.get(stem, "").splitlines():
        if "Compiling entry function" in line:
            dh = None
            if kernel in line:
                dh = int(line.split(kernel + "ILi", 1)[1].split("E", 1)[0])
                report[dh] = [None, 0]
        elif dh is not None and "spill stores" in line:
            report[dh][1] = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif dh is not None and "Used" in line and "registers" in line:
            report[dh][0] = int(line.split("Used")[1].split("registers")[0])
    return {dh: tuple(v) for dh, v in report.items()}


def wgmma_report(occupancy: dict) -> dict:
    """Per wgmma kernel and head dim: registers a thread as built (before
    setmaxnreg moves them to the consumers), spilled bytes, dynamic shared
    memory, blocks per SM, and the host microseconds of encoding the
    kernel's TMA tensor maps at the training shape (mean of 1,000)."""
    import ctypes

    import torch

    from gordo_tpu_torch.ops import _build

    base = torch.empty(TRAIN_SHAPE[0] * TRAIN_SHAPE[1] * 128, dtype=torch.bfloat16,
                       device="cuda")
    report = {}
    for name, (symbol, stem, kernel) in WGMMA_KERNELS.items():
        fn = getattr(_build.load_library(stem), symbol + "_encode_us")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        built = _ptxas(stem, kernel)
        for dh in (16, 32, 64, 128):
            us = ctypes.c_float()
            rc = fn(base.data_ptr(), TRAIN_SHAPE[0], TRAIN_SHAPE[1], dh, 1000, ctypes.byref(us))
            if rc != 0:
                raise RuntimeError(f"{symbol}_encode_us({dh}) failed: CUDA error {rc}")
            registers, spilled = built.get(dh, (None, None))
            entry = {"registers": registers, "spill_store_bytes": spilled,
                     **occupancy[name][dh], "tensor_map_encode_us": us.value}
            report.setdefault(name, {})[dh] = entry
            print(f"  {name} dh {dh}: {registers} registers built ({spilled} B spilled), "
                  f"{entry['smem_bytes']} B shared memory, {entry['blocks_per_sm']} blocks per "
                  f"SM, tensor maps encoded in {us.value:.2f} us a launch", flush=True)
    return report


def kernel_phase(card: str) -> dict:
    """Flash kernel vs its plain version at each shape; times at the main
    path's shape. Returns the kernel's entry of the ``kernels`` line."""
    import torch

    from gordo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED)
    main_shape = SERVE_SHAPE
    shapes = [((2, 4, 512, 64), True), ((2, 4, 512, 64), False),
              (main_shape, True), ((4, 4, 144, 16), True)]
    worst = dict(out_rel=0.0, out_abs=0.0, lse_abs=0.0)
    for shape, causal in shapes:
        q, k, v = (torch.randn(shape, device="cuda", generator=g) for _ in range(3))
        out, lse = fa.flash_attention_forward(q, k, v, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_forward_plain(q, k, v, causal)
        out_abs = (out - ref_out).abs().max().item()
        out_rel = out_abs / ref_out.abs().max().item()
        lse_abs = (lse - ref_lse).abs().max().item()
        print(f"flash_attention {shape} causal={causal}: out max rel err {out_rel:.3e}, "
              f"lse max abs err {lse_abs:.3e}", flush=True)
        if not (out_rel <= TOL_OUT_REL and lse_abs <= TOL_LSE_ABS):
            raise AssertionError(f"flash kernel disagrees with plain at {shape}")
        worst = {key: max(worst[key], val) for key, val in
                 (("out_rel", out_rel), ("out_abs", out_abs), ("lse_abs", lse_abs))}
        del out, lse, ref_out, ref_lse

    timed = {}
    for shape, iters in ((main_shape, 20), (TRAIN_SHAPE, 100)):
        q, k, v = (torch.randn(shape, device="cuda", generator=g) for _ in range(3))
        ms = _time_ms(lambda: fa.flash_attention_forward(q, k, v, True), iters)
        plain_ms = _time_ms(lambda: fa.flash_attention_forward_plain(q, k, v, True),
                            max(iters // 4, 5))
        library = _sdpa_ms(q, k, v, iters)
        bound = _flash_bound_ms(*shape, causal=True)
        print(f"flash_attention {shape} causal on {card}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, scaled_dot_product_attention {library['library_ms']:.4f} "
              f"ms ({library['library_3d_ms']:.4f} given 3-D tensors), "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}, 3xTF32), "
              f"{bound['fp32_core_bound_ms']:.4f} ms on the CUDA cores", flush=True)
        timed[shape] = {"ms": ms, "plain_ms": plain_ms, **bound, **library,
                        "shape": list(shape), "causal": True}
        timed[shape].update(_rates(timed[shape]))
        del q, k, v
    return {
        "name": "flash_attention_forward", "route": "cuda",
        "source": "gordo_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "gordo_tpu/ops/pallas_kernels/flash_attention.py:41",
        "dtype": "float32", "launches": None, "max_abs_err": worst["out_abs"],
        "out_max_rel_err": worst["out_rel"], "lse_max_abs_err": worst["lse_abs"],
        **timed[main_shape], "training_shape": timed[TRAIN_SHAPE],
    }


def float64_errors(inputs, causal: bool, grads) -> dict:
    """``grads`` (dq, dk, dv, or the first of them) against the plain
    backward in float64 of the same ``inputs`` (q, k, v, o, lse, dO), beside
    the plain float32 backward's own error: ``{"dq": (grad's, plain's),
    ...}``, each the largest error relative to the largest entry, absolute
    below 1."""
    from gordo_tpu_torch.ops import flash_attention as fa

    ref64 = fa.flash_attention_backward_plain(*(x.double() for x in inputs), causal)
    plain32 = fa.flash_attention_backward_plain(*inputs, causal)
    errors = {}
    for name, got, plain, ref in zip(("dq", "dk", "dv"), grads, plain32, ref64):
        scale = max(ref.abs().max().item(), 1.0)
        errors[name] = ((got.double() - ref).abs().max().item() / scale,
                        (plain.double() - ref).abs().max().item() / scale)
    return errors


def backward_kernel_phase(card: str) -> list:
    """The dQ and dK/dV kernels vs the plain backward at each shape, and run
    twice for bit-identical results; times at the training shape. Returns
    the two kernels' entries of the ``kernels`` line."""
    import torch

    from gordo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    worst_rel = dict(worst)
    for shape, causal in BACKWARD_SHAPES:
        q, k, v, do = (torch.randn(shape, device="cuda", generator=g) for _ in range(4))
        o, lse = fa.flash_attention_forward(q, k, v, causal)
        runs = [(fa.launch_dq(q, k, v, o, lse, do, causal),
                 *fa.launch_dkv(q, k, v, o, lse, do, causal)) for _ in range(2)]
        torch.cuda.synchronize()
        refs = fa.flash_attention_backward_plain(q, k, v, o, lse, do, causal)
        errs = []
        for name, got, again, ref in zip(("dq", "dk", "dv"), *runs, refs):
            abs_err = (got - ref).abs().max().item()
            # relative to the largest entry, and absolute below 1 (the inputs
            # are standard normal): at T = 1, dq and dk are exactly 0
            rel = abs_err / max(ref.abs().max().item(), 1.0)
            errs.append(f"{name} {rel:.3e}")
            if not rel <= TOL_GRAD_REL:
                raise AssertionError(f"{name} kernel disagrees with plain at {shape}: {rel}")
            if not torch.equal(got, again):
                raise AssertionError(f"{name} differs between two launches at {shape}")
            worst[name] = max(worst[name], abs_err)
            worst_rel[name] = max(worst_rel[name], rel)
        print(f"flash backward {shape} causal={causal}: max rel err {', '.join(errs)}; "
              f"bit-identical on a second launch", flush=True)
        del runs, refs, q, k, v, do, o, lse

    shape = BACKWARD_SHAPES[0][0]
    q, k, v, do = (torch.randn(shape, device="cuda", generator=g) for _ in range(4))
    o, lse = fa.flash_attention_forward(q, k, v, True)
    dq_ms = _time_ms(lambda: fa.launch_dq(q, k, v, o, lse, do, True), 50)
    dkv_ms = _time_ms(lambda: fa.launch_dkv(q, k, v, o, lse, do, True), 50)
    plain_ms = _time_ms(lambda: fa.flash_attention_backward_plain(q, k, v, o, lse, do, True), 10)
    library = _sdpa_ms(q, k, v, 20, do=do)
    f64 = float64_errors((q, k, v, o, lse, do), True, (
        fa.launch_dq(q, k, v, o, lse, do, True), *fa.launch_dkv(q, k, v, o, lse, do, True)))
    print(f"flash backward {shape} causal against a float64 plain backward: max rel err "
          + ", ".join(f"{n} kernel {k:.3e} (plain float32 {p:.3e})" for n, (k, p) in f64.items()),
          flush=True)
    if not f64["dq"][0] <= F64_ERR_FACTOR * f64["dq"][1]:
        raise AssertionError(f"dq kernel's error against float64 {f64['dq'][0]:.3e} is above "
                             f"{F64_ERR_FACTOR}x plain float32's {f64['dq'][1]:.3e}")
    dq_bound = _flash_bound_ms(*shape, causal=True, n_tensors=6,
                               flop_per_pair=FLOP_PER_PAIR["float32"]["dq"])
    dkv_bound = _flash_bound_ms(*shape, causal=True, n_tensors=7,
                                flop_per_pair=FLOP_PER_PAIR["float32"]["dkv"])
    print(f"flash backward {shape} causal on {card}: dQ kernel {dq_ms:.4f} ms (bound "
          f"{dq_bound['bound_ms']:.4f} 3xTF32, {dq_bound['fp32_core_bound_ms']:.4f} CUDA "
          f"cores), dK/dV kernel {dkv_ms:.4f} ms (bound {dkv_bound['bound_ms']:.4f} "
          f"3xTF32, {dkv_bound['fp32_core_bound_ms']:.4f} CUDA cores), both "
          f"{dq_ms + dkv_ms:.4f} ms; plain backward {plain_ms:.4f} ms; "
          f"scaled_dot_product_attention backward {library['library_ms']:.4f} ms "
          f"({library['library_3d_ms']:.4f} given 3-D tensors; dq, dk, dv together)",
          flush=True)
    common = {"route": "cuda", "source": "gordo_tpu_torch/ops/csrc/flash_attention_bwd.cu",
              "dtype": "float32", "launches": None, "plain_ms": plain_ms, **library,
              "plain_and_library_compute": "dq, dk and dv together",
              "shape": list(shape), "causal": True}
    entries = [
        {"name": "flash_attention_backward_dq",
         "replaces": "gordo_tpu/ops/pallas_kernels/flash_attention.py:89",
         "max_abs_err": worst["dq"], "max_rel_err": worst_rel["dq"], "ms": dq_ms,
         "f64_max_rel_err": f64["dq"][0], "plain_f32_f64_max_rel_err": f64["dq"][1],
         **dq_bound, **common},
        {"name": "flash_attention_backward_dkv",
         "replaces": "gordo_tpu/ops/pallas_kernels/flash_attention.py:127",
         "max_abs_err": max(worst["dk"], worst["dv"]),
         "max_rel_err": max(worst_rel["dk"], worst_rel["dv"]), "ms": dkv_ms,
         "f64_max_rel_err": max(f64["dk"][0], f64["dv"][0]),
         "plain_f32_f64_max_rel_err": max(f64["dk"][1], f64["dv"][1]),
         **dkv_bound, **common},
    ]
    for entry in entries:
        entry.update(_rates(entry))
    return entries


def _bf16_gate(got, ref, exact=None) -> tuple:
    """(every element within one bf16 ulp of the twin's, the share of
    elements that differ at all, the largest absolute difference). With
    ``exact`` (the float64 plain result), elements that are exactly 0 there
    (dQ of a query that sees one key, dQ and dK at T = 1: dP - D cancels
    exactly) are float32 rounding noise in the kernel and in the twin
    alike: they are held to |x| <= 1e-6 instead, and left out of the
    share."""
    import torch

    a, b = got.float(), ref.float()
    diff = (a - b).abs()
    ok = diff <= BF16_ULP * torch.maximum(a.abs(), b.abs()) + 1e-6
    differs = a != b
    if exact is not None:
        zero = exact == 0
        ok = torch.where(zero, a.abs() <= 1e-6, ok)
        differs = differs & ~zero
    return bool(ok.all()), differs.float().mean().item(), diff.max().item()


def bf16_kernel_phase(card: str) -> list:
    """The bf16 forward, dQ and dK/dV kernels against their plain twins on
    bf16 inputs at each shape (the backward also run twice for
    bit-identical results); times at the serving and training shapes.
    Returns the three kernels' entries of the ``kernels`` line."""
    import torch

    from gordo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def bf16_randn(shape, n):
        return [torch.randn(shape, device="cuda", generator=g).bfloat16() for _ in range(n)]

    def check(label, got, ref, exact=None):
        within, share, max_abs = _bf16_gate(got, ref, exact)
        if not (within and share <= TOL_BF16_SHARE):
            raise AssertionError(f"bf16 {label}: within one ulp {within}, share that "
                                 f"differs {share:.3e}")
        return share, max_abs

    worst = {name: [0.0, 0.0] for name in ("out", "dq", "dk", "dv")}  # share, max abs
    lse_worst = 0.0
    dq_f64_share = 0.0
    shapes = [((2, 4, 512, 64), True), ((2, 4, 512, 64), False), (SERVE_SHAPE, True),
              ((4, 4, 144, 16), True), ((3, 2, 77, 32), False), ((2, 2, 200, 128), True),
              ((1, 1, 1, 64), True)]
    for shape, causal in shapes:
        q, k, v = bf16_randn(shape, 3)
        out, lse = fa.flash_attention_forward(q, k, v, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_forward_plain(q, k, v, causal)
        share, max_abs = check(f"out {shape}", out, ref_out)
        lse_rel = ((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1.0)).max().item()
        print(f"bf16 flash_attention {shape} causal={causal}: out within one ulp, share "
              f"that differs {share:.3e}, max abs {max_abs:.3e}; lse max rel err "
              f"{lse_rel:.3e}", flush=True)
        if not lse_rel <= TOL_BF16_LSE_REL:
            raise AssertionError(f"bf16 lse disagrees with plain at {shape}: {lse_rel}")
        worst["out"] = [max(a, b) for a, b in zip(worst["out"], (share, max_abs))]
        lse_worst = max(lse_worst, lse_rel)
        del q, k, v, out, lse, ref_out, ref_lse
    for shape, causal in BACKWARD_SHAPES:
        q, k, v, do = bf16_randn(shape, 4)
        o, lse = fa.flash_attention_forward(q, k, v, causal)
        runs = [(fa.launch_dq(q, k, v, o, lse, do, causal),
                 *fa.launch_dkv(q, k, v, o, lse, do, causal)) for _ in range(2)]
        torch.cuda.synchronize()
        refs = fa.flash_attention_backward_plain(q, k, v, o, lse, do, causal)
        exact = fa.flash_attention_backward_plain(*(x.double() for x in (q, k, v, o, lse, do)),
                                                  causal)
        report = []
        for name, got, again, ref, ref64 in zip(("dq", "dk", "dv"), *runs, refs, exact):
            share, max_abs = check(f"{name} {shape}", got, ref, ref64)
            if not torch.equal(got, again):
                raise AssertionError(f"bf16 {name} differs between two launches at {shape}")
            worst[name] = [max(a, b) for a, b in zip(worst[name], (share, max_abs))]
            report.append(f"{name} {share:.3e}")
        # dQ against the float64 result itself, rounded to bf16
        share, _ = check(f"dq {shape} against float64", runs[0][0], exact[0].bfloat16(),
                         exact[0])
        dq_f64_share = max(dq_f64_share, share)
        report.append(f"dq against float64 {share:.3e}")
        print(f"bf16 flash backward {shape} causal={causal}: within one ulp, share that "
              f"differs {', '.join(report)}; bit-identical on a second launch", flush=True)
        del runs, refs, exact, q, k, v, do, o, lse

    entries = {}
    for shape, iters in ((SERVE_SHAPE, 20), (TRAIN_SHAPE, 100)):
        q, k, v = bf16_randn(shape, 3)
        ms = _time_ms(lambda: fa.flash_attention_forward(q, k, v, True), iters)
        plain_ms = _time_ms(lambda: fa.flash_attention_forward_plain(q, k, v, True),
                            max(iters // 4, 5))
        library = _sdpa_ms(q, k, v, iters)
        bound = _flash_bound_ms(*shape, causal=True, bytes_per_element=2, dtype="bfloat16",
                                flop_per_pair=FLOP_PER_PAIR["bfloat16"]["forward"])
        print(f"bf16 flash_attention {shape} causal on {card}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, scaled_dot_product_attention {library['library_ms']:.4f} "
              f"ms ({library['library_3d_ms']:.4f} given 3-D tensors), bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})", flush=True)
        entries[shape] = {"ms": ms, "plain_ms": plain_ms, **bound, **library,
                          "shape": list(shape), "causal": True}
        entries[shape].update(_rates(entries[shape]))
        del q, k, v
    forward = {
        "name": "flash_attention_forward_bf16", "route": "cuda",
        "source": "gordo_tpu_torch/ops/csrc/flash_attention_bf16.cu",
        "replaces": "gordo_tpu/ops/pallas_kernels/flash_attention.py:41",
        "dtype": "bfloat16", "launches": None, "max_abs_err": worst["out"][1],
        "share_differing": worst["out"][0], "lse_max_rel_err": lse_worst,
        **entries[SERVE_SHAPE], "training_shape": entries[TRAIN_SHAPE],
    }

    shape = TRAIN_SHAPE
    q, k, v, do = bf16_randn(shape, 4)
    o, lse = fa.flash_attention_forward(q, k, v, True)
    dq_ms = _time_ms(lambda: fa.launch_dq(q, k, v, o, lse, do, True), 50)
    dkv_ms = _time_ms(lambda: fa.launch_dkv(q, k, v, o, lse, do, True), 50)
    plain_ms = _time_ms(
        lambda: fa.flash_attention_backward_plain(q, k, v, o, lse, do, True), 10)
    library = _sdpa_ms(q, k, v, 20, do=do)
    bounds = {name: _flash_bound_ms(*shape, causal=True, n_tensors=n, bytes_per_element=2,
                                    flop_per_pair=FLOP_PER_PAIR["bfloat16"][name],
                                    dtype="bfloat16")
              for name, n in (("dq", 6), ("dkv", 7))}
    print(f"bf16 flash backward {shape} causal on {card}: dQ kernel {dq_ms:.4f} ms (bound "
          f"{bounds['dq']['bound_ms']:.4f}, {bounds['dq']['bound_by']}), dK/dV kernel "
          f"{dkv_ms:.4f} ms (bound {bounds['dkv']['bound_ms']:.4f}, "
          f"{bounds['dkv']['bound_by']}), both {dq_ms + dkv_ms:.4f} ms; plain backward "
          f"{plain_ms:.4f} ms; scaled_dot_product_attention backward "
          f"{library['library_ms']:.4f} ms ({library['library_3d_ms']:.4f} given 3-D "
          f"tensors; dq, dk, dv together)", flush=True)
    common = {"route": "cuda", "source": "gordo_tpu_torch/ops/csrc/flash_attention_bwd_bf16.cu",
              "dtype": "bfloat16", "launches": None, "plain_ms": plain_ms, **library,
              "plain_and_library_compute": "dq, dk and dv together",
              "shape": list(shape), "causal": True}
    backward = [
        {"name": "flash_attention_backward_dq_bf16",
         "replaces": "gordo_tpu/ops/pallas_kernels/flash_attention.py:89",
         "max_abs_err": worst["dq"][1], "share_differing": worst["dq"][0],
         "f64_share_differing": dq_f64_share, "ms": dq_ms, **bounds["dq"], **common},
        {"name": "flash_attention_backward_dkv_bf16",
         "replaces": "gordo_tpu/ops/pallas_kernels/flash_attention.py:127",
         "max_abs_err": max(worst["dk"][1], worst["dv"][1]),
         "share_differing": max(worst["dk"][0], worst["dv"][0]), "ms": dkv_ms,
         **bounds["dkv"], **common},
    ]
    for entry in backward:
        entry.update(_rates(entry))
    return [forward, *backward]


def _series(n_rows: int, offset: int, rng) -> np.ndarray:
    """Eight sine tags with noise, rows ``offset .. offset + n_rows``."""
    t = np.arange(offset, offset + n_rows)[:, None]
    period = 144.0 * (1.0 + np.arange(len(TAGS)) / 4.0)
    return np.sin(2 * np.pi * t / period) + 0.05 * rng.randn(n_rows, len(TAGS))


def write_artifact(collection: Path, device: str = "cuda", **estimator):
    """The transformer-ae-512 artifact: seeded weights, scalers fitted on a
    training span, thresholds from a held-out span (the JAX package's
    rule: the max over the span of the rolling(6) minimum of the error);
    ``estimator`` adds to the estimator's arguments."""
    import torch

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.models.anomaly.diff import _rolling
    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.models.scaler import MinMaxScaler
    from gordo_tpu_torch.ops.nn import init_model_params
    from gordo_tpu_torch.serializer.from_jax import detector_from_arrays

    rng = np.random.RandomState(SEED)
    train, held_out = _series(4096, 0, rng), _series(2048, 4096, rng)
    estimator = TransformerAutoEncoder(**CONFIG, **estimator)
    spec = estimator.build_spec(len(TAGS), len(TAGS))
    params = init_model_params(spec, torch.Generator().manual_seed(SEED))
    scaler = MinMaxScaler().fit(train)
    layers = [{k: v.numpy() for k, v in p.items()} for p in params]
    detector = detector_from_arrays(
        spec, layers, scaler.min_, scaler.scale_, scaler.min_, scaler.scale_,
        estimator_kwargs=estimator.kwargs, device=device,
    )
    pred = detector.base_estimator.predict(held_out)
    truth = held_out[-len(pred):]
    abs_err = np.abs(truth - pred)
    mse = np.square(scaler.transform(pred) - scaler.transform(truth)).mean(axis=1)
    detector.feature_thresholds_ = np.nanmax(_rolling(abs_err, 6, np.min), axis=0)
    detector.aggregate_threshold_ = float(np.nanmax(_rolling(mse, 6, np.min)))
    metadata = {"name": "transformer-ae-512", "model": CONFIG,
                "dataset": {"tags": TAGS, "resolution": "10min"}}
    serializer.dump(detector, str(collection / "transformer-ae-512"), tags=TAGS,
                    metadata=metadata)
    return spec, layers, scaler


def _payload(values: np.ndarray, start: datetime) -> dict:
    stamps = [(start + timedelta(minutes=10 * i)).isoformat() for i in range(len(values))]
    frame = {tag: dict(zip(stamps, values[:, j].tolist())) for j, tag in enumerate(TAGS)}
    return {"X": frame, "y": frame}


def _with_attention(spec, impl: str):
    from gordo_tpu_torch.models.spec import TransformerBlock

    return dataclasses.replace(spec, layers=tuple(
        dataclasses.replace(layer, attention_impl=impl)
        if isinstance(layer, TransformerBlock) else layer for layer in spec.layers))


# the wrappers' launch counters: the forward, dQ and dK/dV kernels of each dtype
COUNTERS = {"float32": ("LAUNCHES", "DQ_LAUNCHES", "DKV_LAUNCHES"),
            "bfloat16": ("BF16_LAUNCHES", "BF16_DQ_LAUNCHES", "BF16_DKV_LAUNCHES")}


def _reset_launches() -> None:
    from gordo_tpu_torch.ops import flash_attention as fa

    for names in COUNTERS.values():
        for name in names:
            setattr(fa, name, 0)


def _launches(dtype: str) -> dict:
    """``{"forward": n, "dq": n, "dkv": n}``: the launches of ``dtype``'s
    kernels since the counters were last reset."""
    from gordo_tpu_torch.ops import flash_attention as fa

    return {key: getattr(fa, name) for key, name in zip(("forward", "dq", "dkv"),
                                                         COUNTERS[dtype])}


def main_path(card: str, spec, layers, scaler, collection: Path, device: str = "cuda",
              name: str = "transformer-ae-512", request_rows=REQUEST_ROWS):
    """Serve anomaly requests to model ``name`` through the port's server on
    the card and check them: each request launches the forward kernel of
    the spec's compute dtype once per Transformer block, and nothing else.
    Returns the forward launches the requests made."""
    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.models.spec import TransformerBlock
    from gordo_tpu_torch.server.server import make_server

    dtype = spec.compute_dtype
    other = next(d for d in COUNTERS if d != dtype)
    server = make_server("127.0.0.1", 0, device=device, collection_dir=str(collection))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{server.server_address[1]}"
           f"/gordo/v0/smoke/{name}/anomaly/prediction")
    rng = np.random.RandomState(SEED + 1)
    start = datetime(2020, 1, 1, tzinfo=timezone.utc)
    expected = {"start", "end", "model-input", "model-output", "tag-anomaly-scaled",
                "total-anomaly-scaled", "tag-anomaly-unscaled", "total-anomaly-unscaled",
                "anomaly-confidence", "total-anomaly-confidence"}
    first = None
    try:
        _reset_launches()
        for i, n_rows in enumerate(request_rows):
            values = _series(n_rows, 8192 + 2000 * i, rng)
            before = _launches(dtype)["forward"]
            req = urllib.request.Request(
                url, data=json.dumps(_payload(values, start)).encode(),
                headers={"Content-Type": "application/json"},
            )
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as resp:
                status, body = resp.status, json.loads(resp.read())
            latency_ms = 1e3 * (time.perf_counter() - t0)
            data = body["data"]
            n_out = n_rows - spec.lookback_window + 1
            if status != 200 or set(data) != expected:
                raise AssertionError(f"request {i}: status {status}, blocks {sorted(data)}")
            for top, block in data.items():
                for sub, column in block.items():
                    if len(column) != n_out:
                        raise AssertionError(f"{top}/{sub}: {len(column)} rows, not {n_out}")
                    if top not in ("start", "end") and not all(
                        isinstance(x, float) and math.isfinite(x) for x in column.values()
                    ):
                        raise AssertionError(f"{top}/{sub} has non-finite values")
            launched = _launches(dtype)["forward"] - before
            print(f"request {i}: {n_rows} rows -> {n_out} windows, status {status}, "
                  f"{latency_ms:.1f} ms on {card}, {dtype} flash launches {launched}",
                  flush=True)
            n_blocks = sum(isinstance(layer, TransformerBlock) for layer in spec.layers)
            if launched != n_blocks:
                raise AssertionError(f"{launched} flash launches, expected {n_blocks}")
            if first is None:
                first = (values, data["model-output"])
        launches = _launches(dtype)
        if launches["dq"] or launches["dkv"] or any(_launches(other).values()):
            raise AssertionError("serving launched a backward kernel or another dtype's")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)

    # the first answer's model output against the same model with plain attention
    plain = TransformerAutoEncoder(**CONFIG).load_params(
        _with_attention(spec, "xla"), layers, device)
    before = _launches(dtype)["forward"]
    ref = plain.predict(scaler.transform(first[0]))
    if _launches(dtype)["forward"] != before:
        raise AssertionError("the plain reference launched the kernel")
    served = np.array([list(first[1][tag].values()) for tag in TAGS]).T
    err = np.abs(served - ref).max() / np.abs(ref).max()
    tol = TOL_BF16_MODEL_REL if dtype == "bfloat16" else TOL_MODEL_REL
    print(f"served model-output vs plain attention ({dtype}): max rel err {err:.3e}",
          flush=True)
    if not err <= tol:
        raise AssertionError("served model output disagrees with the plain model")
    return launches["forward"]


def gradient_and_loss_errors(card: str, rows: np.ndarray, spec) -> dict:
    """One step's parameter gradients and the first LOSS_STEPS step losses
    of the model with the flash kernels against the same parameters with the
    plain attention (PyTorch's own autograd), on the same batches. Returns
    the largest relative gradient error (``grad``; ``grad_bk``: the ``bk``
    gradients, absolute against their block's largest) and loss difference
    (``loss``)."""
    import torch

    from gordo_tpu_torch.models.scaler import MinMaxScaler
    from gordo_tpu_torch.ops import train
    from gordo_tpu_torch.ops.nn import TransformerModel, init_model_params
    from gordo_tpu_torch.ops.predict import n_train_samples

    params = init_model_params(spec, torch.Generator().manual_seed(SEED))
    models = [TransformerModel(s, params, torch.device("cuda"))
              for s in (spec, _with_attention(spec, "xla"))]
    X = torch.as_tensor(MinMaxScaler().fit(rows).transform(rows), dtype=torch.float32,
                        device="cuda")
    order = torch.randperm(n_train_samples(spec, len(rows)),
                           generator=torch.Generator().manual_seed(SEED))
    xb, yb = train._gather_batch(spec, X, X, order[:BATCH].cuda())
    wb = torch.ones(BATCH, device="cuda")
    grads = [dict(zip((n for n, _ in m.named_parameters()), torch.autograd.grad(
        train._loss_terms(spec, m, xb, yb, wb), list(m.parameters())))) for m in models]
    worst, worst_bk = 0.0, 0.0
    for name, ref in grads[1].items():
        err = (grads[0][name] - ref).abs().max().item()
        if name.endswith(".bk"):
            # the true gradient is exactly 0 (a per-query shift of the
            # scores): held by absolute error against the block's scale
            layer = name.rsplit(".", 1)[0]
            scale = max(g.abs().max().item() for n, g in grads[1].items()
                        if n.rsplit(".", 1)[0] == layer)
            worst_bk = max(worst_bk, err / scale)
        else:
            worst = max(worst, err / ref.abs().max().item())
    print(f"one step's gradients, flash vs plain attention: max rel err {worst:.3e} "
          f"(bk: abs err {worst_bk:.3e} of the block's largest gradient)", flush=True)

    curves = []
    for model in models:
        optimizer = train.make_optimizer(spec.optimizer, model.parameters())
        _, losses = train.run_epoch(model, optimizer, X, X, order[:LOSS_STEPS * BATCH], BATCH)
        curves.append(losses.cpu().numpy())
    rel = float(np.max(np.abs(curves[0] - curves[1]) / np.abs(curves[1])))
    print(f"{LOSS_STEPS} step losses, flash vs plain attention: {curves[0][0]:.5f} -> "
          f"{curves[0][-1]:.5f}, max rel diff {rel:.3e} on {card}", flush=True)
    return {"grad": worst, "grad_bk": worst_bk, "loss": rel}


def gradient_and_loss_checks(card: str, rows: np.ndarray, spec) -> None:
    """:func:`gradient_and_loss_errors` held to TOL_GRAD_REL and TOL_LOSS_REL."""
    errors = gradient_and_loss_errors(card, rows, spec)
    if not (errors["grad"] <= TOL_GRAD_REL and errors["grad_bk"] <= TOL_GRAD_REL):
        raise AssertionError("parameter gradients through the flash kernels disagree")
    if not errors["loss"] <= TOL_LOSS_REL:
        raise AssertionError("the loss curve through the flash kernels disagrees")


def _provider_continuation(n_train: int, n_rows: int, rng, tags=TAGS) -> np.ndarray:
    """Rows ``n_train .. n_train + n_rows`` of each tag's RandomDataProvider
    signal: its three sines and its offset continued past the training
    span, with fresh noise of the same scale (the provider's own draws, in
    its order; gordo_tpu_torch/dataset/data_provider.py)."""
    from gordo_tpu_torch.dataset import RandomDataProvider, SensorTag

    provider = RandomDataProvider()
    t = np.arange(n_train, n_train + n_rows, dtype=np.float64)
    columns = []
    for tag in tags:
        draws = np.random.RandomState(provider._tag_seed(SensorTag(tag)))
        freqs, amps, phases = (draws.uniform(low, high, size=3)
                               for low, high in ((0.001, 0.05), (0.5, 2.0), (0, 2 * np.pi)))
        draws.normal(0, 0.1, size=n_train)
        offset = draws.uniform(-10, 10)
        base = sum(a * np.sin(2 * np.pi * f * t + p) for f, a, p in zip(freqs, amps, phases))
        columns.append(base + rng.normal(0, 0.1, size=n_rows) + offset)
    return np.stack(columns, axis=1)


def _get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=300) as resp:
        return json.loads(resp.read())


def served_metadata(collection: Path, name: str, device: str = "cuda") -> dict:
    """``GET …/metadata`` of model ``name`` from the port's server on the card."""
    from gordo_tpu_torch.server.server import make_server

    server = make_server("127.0.0.1", 0, device=device, collection_dir=str(collection))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        return _get_json(f"http://127.0.0.1:{server.server_address[1]}"
                         f"/gordo/v0/smoke/{name}/metadata")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)


def cli_build(collection: Path, register: Path) -> None:
    """``python -m gordo_tpu_torch build`` on the card, the machine config in
    ``MACHINE``; it must exit 0 and print every CV score line."""
    started = time.perf_counter()
    result = subprocess.run(
        [sys.executable, "-m", "gordo_tpu_torch", "--log-level", "WARNING", "build",
         "--model-register-dir", str(register), "--print-cv-scores"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(REPO), "MACHINE": json.dumps(BUILD_CONFIG),
             "OUTPUT_DIR": str(collection / "transformer-ae-512-cli")},
    )
    lines = [line for line in result.stdout.splitlines() if "_fold-" in line]
    print(f"python -m gordo_tpu_torch build: exit {result.returncode} in "
          f"{time.perf_counter() - started:.1f} s, {len(lines)} score lines, first "
          f"{lines[:1]}", flush=True)
    if result.returncode != 0:
        print(result.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"the build CLI exited {result.returncode}")
    # 4 metrics x (8 tags + the aggregate) x (mean, std, max, min, 3 folds)
    expected = 4 * (len(TAGS) + 1) * 7
    if len(lines) != expected or not all(
            math.isfinite(float(line.rsplit("=", 1)[1])) for line in lines):
        raise AssertionError(f"expected {expected} finite score lines, got {len(lines)}")


def _config_rows(config: dict) -> int:
    """The ten-minute rows of a build config's dataset (6,144)."""
    dataset = config["dataset"]
    return (datetime.fromisoformat(dataset["train_end_date"])
            - datetime.fromisoformat(dataset["train_start_date"])) // timedelta(minutes=10)


def build_and_check(card: str, config: dict, spec, output: Path, register: Path):
    """Build ``config``'s machine through ``ModelBuilder`` on the card (3-fold
    CV and a fit over the config's 6,144 RandomDataset rows, 420 steps) and
    check it: two dQ and two dK/dV launches of the spec's compute dtype per
    step and none of the other dtype's, finite losses, CV scores and
    thresholds, ``model_offset``, and a held-out scaled error below the
    seeded initial weights'. Returns ``(model, launches)``."""
    import torch

    from gordo_tpu_torch.builder import ModelBuilder
    from gordo_tpu_torch.machine import Machine
    from gordo_tpu_torch.models import models as port_models
    from gordo_tpu_torch.models.anomaly.diff import TimeSeriesSplit
    from gordo_tpu_torch.models.spec import TransformerBlock
    from gordo_tpu_torch.ops.predict import n_train_samples

    dtype = spec.compute_dtype
    other = next(d for d in COUNTERS if d != dtype)
    n_rows = _config_rows(config)
    steps = [math.ceil(n_train_samples(spec, len(train_idx)) / BATCH)
             for train_idx, _ in TimeSeriesSplit(3).split(np.zeros(n_rows))]
    steps.append(math.ceil(n_train_samples(spec, n_rows) / BATCH))
    n_blocks = sum(isinstance(layer, TransformerBlock) for layer in spec.layers)

    # each fit's epoch losses, read where the estimators call the training loop
    losses = []
    fit_arrays = port_models.fit_arrays

    def recording_fit(*args, **kwargs):
        result = fit_arrays(*args, **kwargs)
        losses.append(result.history["loss"])
        return result

    shutil.rmtree(register, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _reset_launches()
    port_models.fit_arrays = recording_fit
    try:
        t0 = time.perf_counter()
        model, machine = ModelBuilder(Machine.from_config(config, "chip-smoke"), "cuda").build(
            output, register)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        port_models.fit_arrays = fit_arrays
    launches = _launches(dtype)
    built = machine.metadata.build_metadata
    phases = built.phases
    scores = built.model.cross_validation.scores
    print(f"build of {config['name']} ({dtype}) on {card}: {seconds:.2f} s in all; phases "
          f"(s) {phases}; CV {steps[:3]} steps, fit {steps[3]} steps, "
          f"{1e3 * phases['fit'] / steps[3]:.2f} ms per fit step; {dtype} launches "
          f"{launches}; model_offset {built.model.model_offset}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for metric in ("explained-variance-score", "r2-score", "mean-squared-error",
                   "mean-absolute-error"):
        print(f"  CV {metric}: {scores[metric]}", flush=True)
    if not launches["dq"] == launches["dkv"] == n_blocks * sum(steps):
        raise AssertionError(f"expected {n_blocks * sum(steps)} dQ and dK/dV launches, "
                             f"got {launches}")
    if not launches["forward"] >= launches["dq"]:
        raise AssertionError(f"fewer forward launches than training steps: {launches}")
    if any(_launches(other).values()):
        raise AssertionError(f"the {dtype} build launched {other} kernels: "
                             f"{_launches(other)}")
    if built.model.model_offset != spec.lookback_window - 1:
        raise AssertionError(f"model_offset {built.model.model_offset}")
    print(f"epoch losses (folds, then fit): {losses}", flush=True)
    if len(losses) != 4 or not all(math.isfinite(x) for h in losses for x in h):
        raise AssertionError("a training loss is not finite")
    if not all(math.isfinite(v) for s in scores.values() for v in s.values()):
        raise AssertionError("a CV score is not finite")

    mse = held_out_mse(model, spec, n_rows)
    print(f"held-out scaled MSE: trained {mse['trained']:.6f}, seeded initial weights "
          f"{mse['seeded']:.6f}", flush=True)
    if not mse["trained"] < mse["seeded"]:
        raise AssertionError("training did not lower the held-out error")
    thresholds = [*model.feature_thresholds_, model.aggregate_threshold_]
    print(f"thresholds: feature {model.feature_thresholds_.tolist()}, aggregate "
          f"{model.aggregate_threshold_}", flush=True)
    if not all(math.isfinite(x) for x in thresholds):
        raise AssertionError("a threshold is not finite")
    return model, launches, seconds


def held_out_mse(model, spec, n_rows: int, tags=TAGS) -> dict:
    """The scaled MSE of a built detector (``trained``) and of the same
    model with the seeded initial weights (``seeded``) on 2,048 rows of the
    provider's signal of ``tags`` past the ``n_rows`` of the training span."""
    import torch

    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.ops.nn import init_model_params

    held_out = _provider_continuation(n_rows, 2048, np.random.RandomState(SEED + 3), tags)
    input_scaler = model.base_estimator.steps[0][1]
    seeded = TransformerAutoEncoder(**CONFIG).load_params(
        spec, init_model_params(spec, torch.Generator().manual_seed(SEED)), "cuda")
    truth = model.scaler.transform(held_out[spec.lookback_window - 1:])
    return {name: float(np.mean(np.square(model.scaler.transform(pred) - truth)))
            for name, pred in (
                ("trained", model.base_estimator.predict(held_out)),
                ("seeded", seeded.predict(input_scaler.transform(held_out))))}


def build_path(card: str, root: Path) -> dict:
    """Build the transformer-ae-512 machine from its config on the card
    (:func:`build_and_check`), build it again from the register's cache,
    build it once more through the CLI, and serve the built artifact.
    Returns the kernels' launches in the build and in the served request,
    and the build's seconds."""
    import torch

    from gordo_tpu_torch.machine import Machine
    from gordo_tpu_torch.builder import ModelBuilder
    from gordo_tpu_torch.models.models import TransformerAutoEncoder

    rng = np.random.RandomState(SEED)
    rows = np.concatenate([_series(4096, 0, rng), _series(2048, 4096, rng)])
    spec = TransformerAutoEncoder(**CONFIG).build_spec(len(TAGS), len(TAGS))
    gradient_and_loss_checks(card, rows, spec)
    output, register = root / "transformer-ae-512-built", root.parent / "register"
    model, launches, seconds = build_and_check(card, BUILD_CONFIG, spec, output, register)
    input_scaler = model.base_estimator.steps[0][1]

    # the same machine again: a cache hit, which trains and launches nothing
    written = (output / "params.npz").stat().st_mtime_ns
    _reset_launches()
    t0 = time.perf_counter()
    _, cached = ModelBuilder(Machine.from_config(BUILD_CONFIG, "chip-smoke"), "cuda").build(
        output, register)
    again = tuple(n for dtype in COUNTERS for n in _launches(dtype).values())
    print(f"second build: {time.perf_counter() - t0:.2f} s, user metadata "
          f"{cached.metadata.user_defined}, launches {again}", flush=True)
    if cached.metadata.user_defined.get("build-metadata") != {"from_cache": True} or any(again):
        raise AssertionError("the second build did not come from the cache")
    if (output / "params.npz").stat().st_mtime_ns != written:
        raise AssertionError("the cache hit was saved onto itself")

    torch.cuda.empty_cache()
    cli_build(root, register)

    layers = model.base_estimator.steps[-1][1].module_.params_numpy()
    launches["serving"] = main_path(card, spec, layers, input_scaler, root,
                                    name=output.name, request_rows=(1535,))
    body = served_metadata(root, output.name)
    served = body["metadata"]["metadata"]["build_metadata"]["model"]
    print(f"GET {output.name}/metadata: build_metadata.model keys {sorted(served)}", flush=True)
    if not (served.get("model_offset") == spec.lookback_window - 1
            and served["cross_validation"].get("scores")
            and served["cross_validation"].get("splits")
            and served.get("model_meta", {}).get("aggregate-threshold") is not None):
        raise AssertionError("the served metadata lacks the build's model metadata")
    return launches, seconds


def bf16_build_path(card: str, root: Path) -> dict:
    """Build transformer-ae-512-bf16 from its config on the card
    (:func:`build_and_check`) and serve the built artifact: one 1,535-row
    request, its model output against the same bf16 model with plain
    attention. Returns the bf16 kernels' launches in the build and in the
    served request, and the build's seconds."""
    from gordo_tpu_torch.models.models import TransformerAutoEncoder

    spec = TransformerAutoEncoder(**CONFIG, compute_dtype="bfloat16").build_spec(
        len(TAGS), len(TAGS))
    output = root / "transformer-ae-512-bf16-built"
    model, launches, seconds = build_and_check(card, BUILD_CONFIG_BF16, spec, output,
                                               root.parent / "register-bf16")
    layers = model.base_estimator.steps[-1][1].module_.params_numpy()
    launches["serving"] = main_path(card, spec, layers, model.base_estimator.steps[0][1],
                                    root, name=output.name, request_rows=(1535,))
    return launches, seconds


class _PlainAttentionCalls:
    """Counts the calls of the plain attention path while it is entered: a
    phase on the card that reaches it fails."""

    def __enter__(self):
        from gordo_tpu_torch.ops import attention

        self.calls, self._plain = 0, attention.dot_product_attention_plain

        def counted(*args, **kwargs):
            self.calls += 1
            return self._plain(*args, **kwargs)

        attention.dot_product_attention_plain = counted
        return self

    def __exit__(self, *exc):
        from gordo_tpu_torch.ops import attention

        attention.dot_product_attention_plain = self._plain


def _request(url: str, payload=None) -> tuple:
    """``(status, body bytes, headers, ms)`` of a GET (or a POST of
    ``payload``), HTTP errors included."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, body, headers = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as err:
        status, body, headers = err.code, err.read(), err.headers
    return status, body, headers, 1e3 * (time.perf_counter() - t0)


def _columns(block: dict, tags) -> np.ndarray:
    return np.array([list(block[tag].values()) for tag in tags]).T


def server_surface_path(card: str, spec, layers, scaler, collection: Path,
                        device: str = "cuda") -> int:
    """The rest of the server's routes on the transformer-ae-512 artifact,
    served as ``run-server`` serves it (``make_server``, then
    ``serve_forever``) with ``EXPECTED_MODELS`` naming it: every GET route
    (status and keys; readiness met, and unmet for a sibling revision
    without the model), three base requests (1,535, 700 and 1,535 rows),
    each launching the forward once per block and nothing else, its
    ``model-output`` equal to the anomaly route's for the same request and
    the first held against plain attention; and ``download-model``'s bytes
    loaded back on the card, predicting as served. Returns the forward
    launches of the base requests alone (the anomaly requests beside them
    are not counted)."""
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.models.spec import TransformerBlock
    from gordo_tpu_torch.server.server import make_server

    started = time.perf_counter()
    name, dtype = "transformer-ae-512", spec.compute_dtype
    n_blocks = sum(isinstance(layer, TransformerBlock) for layer in spec.layers)
    previous = os.environ.get("EXPECTED_MODELS")
    os.environ["EXPECTED_MODELS"] = json.dumps([name])
    try:
        server = make_server("127.0.0.1", 0, device=device, collection_dir=str(collection))
    finally:
        if previous is None:
            del os.environ["EXPECTED_MODELS"]
        else:
            os.environ["EXPECTED_MODELS"] = previous
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    project = f"{base}/gordo/v0/smoke"
    sibling = sorted(p.name for p in collection.parent.iterdir() if p.name != collection.name)[0]
    revisions = sorted(p.name for p in collection.parent.iterdir())
    gets = [  # (path, status, keys of the body, the body where it is known)
        ("/healthcheck", 200, None, None),
        ("/readiness", 200, {"ready"}, {"ready": True}),
        (f"/readiness?revision={sibling}", 503, {"ready", "missing", "n_missing"},
         {"ready": False, "missing": [name], "n_missing": 1}),
        ("/server-version", 200, {"version", "revision"}, None),
        ("/gordo/v0/smoke/models", 200, {"models", "revision"},
         {"models": [name], "revision": collection.name}),
        ("/gordo/v0/smoke/revisions", 200, {"latest", "available-revisions", "revision"},
         {"latest": collection.name, "available-revisions": revisions,
          "revision": collection.name}),
        ("/gordo/v0/smoke/expected-models", 200, {"expected-models", "revision"},
         {"expected-models": [name], "revision": collection.name}),
        (f"/gordo/v0/smoke/{name}/metadata", 200,
         {"gordo-server-version", "metadata", "env", "revision"}, None),
        (f"/gordo/v0/smoke/{name}/healthcheck", 200,
         {"gordo-server-version", "metadata", "env", "revision"}, None),
        ("/gordo/v0/smoke/nope/metadata", 404, {"message", "revision"}, None),
        (f"/gordo/v0/smoke/{name}/metadata?revision=nope", 410, {"error"}, None),
    ]
    rng = np.random.RandomState(SEED + 5)
    start = datetime(2020, 1, 1, tzinfo=timezone.utc)
    first, base_launches = None, 0
    try:
        for path, status, keys, expected in gets:
            got, body, _, ms = _request(base + path)
            parsed = json.loads(body) if body else None
            print(f"GET {path}: {got} in {ms:.1f} ms on {card}", flush=True)
            if got != status or (keys is not None and set(parsed) != keys) or (
                    expected is not None and parsed != expected):
                raise AssertionError(f"GET {path}: {got} {parsed}")
        _reset_launches()
        with _PlainAttentionCalls() as plain:
            for i, n_rows in enumerate(REQUEST_ROWS):
                payload = _payload(_series(n_rows, 16384 + 2000 * i, rng), start)
                before = _launches(dtype)["forward"]
                status, body, _, ms = _request(f"{project}/{name}/prediction", payload)
                launched = _launches(dtype)["forward"] - before
                data = json.loads(body)["data"]
                n_out = n_rows - spec.lookback_window + 1
                if status != 200 or set(data) != {"start", "end", "model-input", "model-output"}:
                    raise AssertionError(f"base request {i}: {status}, blocks {sorted(data)}")
                for top, block in data.items():
                    for column in block.values():
                        if len(column) != n_out:
                            raise AssertionError(f"{top}: {len(column)} rows, not {n_out}")
                        if top not in ("start", "end") and not all(
                                isinstance(x, float) and math.isfinite(x) for x in column.values()):
                            raise AssertionError(f"{top} has non-finite values")
                _, anomaly, _, anomaly_ms = _request(f"{project}/{name}/anomaly/prediction",
                                                     payload)
                same = json.loads(anomaly)["data"]["model-output"] == data["model-output"]
                print(f"POST {name}/prediction {i}: {n_rows} rows -> {n_out} windows, status "
                      f"{status}, {ms:.1f} ms on {card} (anomaly route {anomaly_ms:.1f} ms), "
                      f"{dtype} flash launches {launched}, model-output equal to the anomaly "
                      f"route's: {same}", flush=True)
                if launched != n_blocks or not same:
                    raise AssertionError(f"base request {i}: {launched} launches, equal {same}")
                base_launches += launched
                if first is None:
                    first = (payload, data["model-output"])
        launches = _launches(dtype)
        if launches["dq"] or launches["dkv"] or plain.calls:
            raise AssertionError(f"the base route launched a backward kernel or reached the "
                                 f"plain attention ({plain.calls} calls)")
        status, blob, headers, ms = _request(f"{project}/{name}/download-model")
        if status != 200 or headers["Content-Disposition"] != "attachment; filename=model.tar.gz":
            raise AssertionError(f"download-model: {status} {dict(headers)}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)

    values = np.array([list(first[0]["X"][tag].values()) for tag in TAGS]).T
    served = _columns(first[1], TAGS)
    plain = TransformerAutoEncoder(**CONFIG).load_params(_with_attention(spec, "xla"), layers,
                                                         device)
    ref = plain.predict(scaler.transform(values))
    err = np.abs(served - ref).max() / np.abs(ref).max()
    loaded = serializer.loads(blob, device=device)
    reloaded = np.abs(loaded.predict(values) - served).max() / np.abs(served).max()
    print(f"base route model-output vs plain attention: max rel err {err:.3e}; download-model "
          f"({len(blob)} bytes in {ms:.1f} ms) loaded back on {device}: max rel err "
          f"{reloaded:.3e}; server surface phase {time.perf_counter() - started:.1f} s",
          flush=True)
    if not (err <= TOL_MODEL_REL and reloaded <= TOL_MODEL_REL):
        raise AssertionError("the base route or the downloaded model disagrees")
    return base_launches


# the fleet phase's machines: each its own tags, so that their data differ
FLEET_MACHINES = 8
FLEET_TAGS = [[f"m{m}-tag-{j}" for j in range(len(TAGS))] for m in range(FLEET_MACHINES)]
# one stacked training step's attention: machines x batch 32 x 4 heads (the
# fold predicts run at SERVE_SHAPE: 1,024 machine-windows x 4 heads)
FLEET_SHAPE = (FLEET_MACHINES * BATCH * 4, 512, 64)


def _plain_in_parts(fn, tensors, causal: bool, parts: int = 4) -> list:
    """``fn`` (a plain twin returning a tuple) over ``parts`` slices of BH,
    its results joined: a quarter of its score matrices alive at once."""
    import torch

    pieces = [fn(*xs, causal) for xs in zip(*(x.chunk(parts) for x in tensors))]
    return [torch.cat(outs) for outs in zip(*pieces)]


def fleet_kernel_gates(q, k, v, do, o, lse) -> dict:
    """The forward, dQ and dK/dV of one dtype at the fleet's shape held
    against their plain twins on the same inputs (``o`` and ``lse`` from
    the forward kernel, as training has them): float32 at TOL_OUT_REL,
    TOL_LSE_ABS and TOL_GRAD_REL as the kernel phases hold them; bf16 by
    ``_bf16_gate`` (one ulp, at most TOL_BF16_SHARE differing, the elements
    that float64 makes exactly 0 held near 0) and lse at TOL_BF16_LSE_REL.
    Raises on a miss; returns ``{kernel: errors}``."""
    import torch

    from gordo_tpu_torch.ops import flash_attention as fa

    causal = True
    bf16 = q.dtype == torch.bfloat16
    inputs = (q, k, v, o, lse, do)
    out, lse_k = fa.flash_attention_forward(q, k, v, causal)
    got = {"out": out, "dq": fa.launch_dq(*inputs, causal)}
    got["dk"], got["dv"] = fa.launch_dkv(*inputs, causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = _plain_in_parts(fa.flash_attention_forward_plain, (q, k, v), causal)
    refs = dict(zip(("dq", "dk", "dv"),
                    _plain_in_parts(fa.flash_attention_backward_plain, inputs, causal)))
    refs["out"] = ref_out
    exact = (dict(zip(("dq", "dk", "dv"), _plain_in_parts(
        fa.flash_attention_backward_plain, [x.double() for x in inputs], causal)))
        if bf16 else {})
    errors = {}
    if bf16:
        lse_err = ((lse_k - ref_lse).abs() / ref_lse.abs().clamp_min(1.0)).max().item()
        ok = lse_err <= TOL_BF16_LSE_REL
        for name in ("out", "dq", "dk", "dv"):
            within, share, max_abs = _bf16_gate(got[name], refs[name], exact.get(name))
            errors[name] = {"within_one_ulp": within, "share_differing": share,
                            "max_abs_err": max_abs}
            ok = ok and within and share <= TOL_BF16_SHARE
    else:
        lse_err = (lse_k - ref_lse).abs().max().item()
        ok = lse_err <= TOL_LSE_ABS
        for name in ("out", "dq", "dk", "dv"):
            max_abs = (got[name] - refs[name]).abs().max().item()
            # out relative to its largest entry; the gradients as the
            # backward phase holds them, absolute below 1
            scale = refs[name].abs().max().item()
            rel = max_abs / (scale if name == "out" else max(scale, 1.0))
            errors[name] = {"max_abs_err": max_abs, "max_rel_err": rel}
            ok = ok and rel <= (TOL_OUT_REL if name == "out" else TOL_GRAD_REL)
    errors["lse"] = lse_err
    print(f"{'bf16' if bf16 else 'float32'} kernels at the fleet's {tuple(q.shape)} causal "
          f"against their plain twins: {errors}", flush=True)
    if not ok:
        raise AssertionError(f"a kernel disagrees with its plain twin at {tuple(q.shape)}")
    return errors


def fleet_kernel_times(card: str) -> dict:
    """The six kernels at FLEET_SHAPE, causal: each held against its plain
    twin there (:func:`fleet_kernel_gates`), and its time beside its bound,
    the plain twin's (the forward, or the whole backward) and
    ``scaled_dot_product_attention``'s forward or whole backward on the
    same inputs. Returns ``{kernel entry name: timings and errors}``."""
    import torch

    from gordo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    times = {}
    for dtype, name, suffix, size in ((torch.float32, "float32", "", 4),
                                      (torch.bfloat16, "bfloat16", "_bf16", 2)):
        q, k, v, do = (torch.randn(FLEET_SHAPE, device="cuda", generator=g).to(dtype)
                       for _ in range(4))
        o, lse = fa.flash_attention_forward(q, k, v, True)
        errors = fleet_kernel_gates(q, k, v, do, o, lse)
        torch.cuda.empty_cache()
        forward_lib, backward_lib = _sdpa_ms(q, k, v, 20), _sdpa_ms(q, k, v, 10, do=do)
        plain_forward = _time_ms(lambda: fa.flash_attention_forward_plain(q, k, v, True), 5)
        plain_backward = _time_ms(
            lambda: fa.flash_attention_backward_plain(q, k, v, o, lse, do, True), 5)
        torch.cuda.empty_cache()
        for kernel, entry, call, n_tensors, library, plain_ms, checked in (
                ("forward", "flash_attention_forward",
                 lambda: fa.flash_attention_forward(q, k, v, True), 4, forward_lib,
                 plain_forward, {"out": errors["out"], "lse": errors["lse"]}),
                ("dq", "flash_attention_backward_dq",
                 lambda: fa.launch_dq(q, k, v, o, lse, do, True), 6, backward_lib,
                 plain_backward, {"dq": errors["dq"]}),
                ("dkv", "flash_attention_backward_dkv",
                 lambda: fa.launch_dkv(q, k, v, o, lse, do, True), 7, backward_lib,
                 plain_backward, {"dk": errors["dk"], "dv": errors["dv"]})):
            ms = _time_ms(call, 50)
            bound = _flash_bound_ms(*FLEET_SHAPE, causal=True, n_tensors=n_tensors,
                                    flop_per_pair=FLOP_PER_PAIR[name][kernel],
                                    bytes_per_element=size, dtype=name)
            times[entry + suffix] = {"shape": list(FLEET_SHAPE), "ms": ms,
                                     "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
                                     "bound_by": bound["bound_by"], **library,
                                     "against_plain": checked}
            print(f"{entry}{suffix} at the fleet's {FLEET_SHAPE} causal on {card}: {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms{'' if kernel == 'forward' else ' (whole backward)'}, "
                  f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
                  f"scaled_dot_product_attention {library['library_ms']:.4f} ms "
                  f"({library['library_3d_ms']:.4f} given 3-D tensors"
                  f"{'' if kernel == 'forward' else '; its whole backward'})", flush=True)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return times


def fleet_configs(**estimator) -> list:
    return [build_config(f"transformer-ae-512-m{m}", tags=FLEET_TAGS[m], **estimator)
            for m in range(FLEET_MACHINES)]


def fleet_path(card: str, root: Path, serial_seconds: float, device: str = "cuda",
               **estimator) -> dict:
    """FLEET_MACHINES transformer-ae-512 machines (``estimator`` added to
    their arguments) built by ``BatchedModelBuilder`` on the card: every
    machine from the stacked program (no serial fallback, no quarantine, no
    plain attention), each stacked step launching the dtype's dQ and dK/dV
    once per block for the whole bucket, and each machine's held-out error
    below its seeded weights', its thresholds finite. Prints the wall, ms
    per stacked step and peak device memory beside ``serial_seconds`` (one
    serial build of the same run) times the machines. Returns the launches
    and the models."""
    import torch

    from gordo_tpu_torch.machine import Machine
    from gordo_tpu_torch.models.anomaly.diff import TimeSeriesSplit
    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.models.spec import TransformerBlock
    from gordo_tpu_torch.ops.predict import n_train_samples
    from gordo_tpu_torch.parallel import batch_trainer as bt

    configs = fleet_configs(**estimator)
    spec = TransformerAutoEncoder(**CONFIG, **estimator).build_spec(len(TAGS), len(TAGS))
    dtype = spec.compute_dtype
    other = next(d for d in COUNTERS if d != dtype)
    n_blocks = sum(isinstance(layer, TransformerBlock) for layer in spec.layers)
    n_rows = _config_rows(configs[0])
    steps = [math.ceil(n_train_samples(spec, len(train_idx)) / BATCH)
             for train_idx, _ in TimeSeriesSplit(3).split(np.zeros(n_rows))]
    steps.append(math.ceil(n_train_samples(spec, n_rows) / BATCH))
    epochs = []  # (seconds, steps) of each stacked epoch
    run_masked_epoch = bt.run_masked_epoch

    def synchronize():
        if device == "cuda":
            torch.cuda.synchronize()

    def timed_epoch(model, optimizer, X, y, orders, n_valid, batch_size):
        synchronize()
        t0 = time.perf_counter()
        out = run_masked_epoch(model, optimizer, X, y, orders, n_valid, batch_size)
        synchronize()
        epochs.append((time.perf_counter() - t0, len(out[1])))
        return out

    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    builder = bt.BatchedModelBuilder([Machine.from_config(c, "chip-smoke") for c in configs],
                                     serial_fallback=False, device=device,
                                     output_dir=str(root / f"fleet-{dtype}"))
    _reset_launches()
    bt.run_masked_epoch = timed_epoch
    try:
        with _PlainAttentionCalls() as plain:
            t0 = time.perf_counter()
            results = builder.build()
            seconds = time.perf_counter() - t0
    finally:
        bt.run_masked_epoch = run_masked_epoch
    launches = _launches(dtype)
    peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else float("nan")
    train_s, n_steps = sum(s for s, _ in epochs), sum(n for _, n in epochs)
    bh = FLEET_MACHINES * BATCH * next(
        layer.num_heads for layer in spec.layers if isinstance(layer, TransformerBlock))
    print(f"fleet of {FLEET_MACHINES} ({dtype}) on {card}: {seconds:.2f} s in all, "
          f"{len(results)} built, serial {builder.serial_built}, chunks halved for memory "
          f"{builder.oom_bisections}, quarantined "
          f"{[r.to_dict() for r in builder.quarantine_records]}; {n_steps} stacked steps "
          f"(CV {steps[:3]}, fit {steps[3]}) in {train_s:.2f} s, "
          f"{1e3 * train_s / n_steps:.2f} ms per stacked step at attention BH {bh}; {dtype} "
          f"launches {launches}; peak device memory {peak:.2f} GiB; the serial build x "
          f"{FLEET_MACHINES}: {serial_seconds * FLEET_MACHINES:.2f} s "
          f"({serial_seconds:.2f} s each)", flush=True)
    if (len(results) != FLEET_MACHINES or builder.serial_built or builder.quarantine_records
            or builder.oom_bisections):
        raise AssertionError("a machine did not come out of the stacked program")
    if plain.calls:
        raise AssertionError(f"the fleet reached the plain attention {plain.calls} times")
    if n_steps != sum(steps) or not launches["dq"] == launches["dkv"] == n_blocks * sum(steps):
        raise AssertionError(f"expected {n_blocks * sum(steps)} dQ and dK/dV launches, one "
                             f"per block a stacked step, got {launches} in {n_steps} steps")
    if any(_launches(other).values()):
        raise AssertionError(f"the {dtype} fleet launched {other} kernels")
    for (model, machine), tags in zip(results, FLEET_TAGS):
        mse = held_out_mse(model, spec, n_rows, tags)
        thresholds = [*model.feature_thresholds_, model.aggregate_threshold_]
        print(f"  {machine.name}: held-out scaled MSE {mse['trained']:.6f} (seeded "
              f"{mse['seeded']:.6f}), aggregate threshold {model.aggregate_threshold_:.6f}, "
              f"fit losses {model.base_estimator.steps[1][1].history['loss']}", flush=True)
        if not (mse["trained"] < mse["seeded"] and all(math.isfinite(x) for x in thresholds)):
            raise AssertionError(f"{machine.name}: held-out error {mse} or thresholds "
                                 f"{thresholds}")
    return {**launches, "bh": bh, "seconds": seconds,
            "ms_per_stacked_step": 1e3 * train_s / n_steps, "peak_gib": peak}


def _one_batch_diffs(spec, params, X, orders, device: str) -> tuple:
    """One batch through a two-machine stacked model and through each
    machine's own model at the same parameters: the largest differences of
    the outputs and of the parameter gradients (``bk`` left out: its true
    gradient is 0, rounding noise), each relative to the serial one's
    largest entry."""
    import torch

    from gordo_tpu_torch.ops import nn, train

    stacked = nn.StackedTransformerModel(spec, nn.stack_params(params), torch.device(device))
    serials = [nn.TransformerModel(spec, p, torch.device(device)) for p in params]
    xb, yb = train._gather_batch(spec, X, X, orders[:, :BATCH].to(device))
    wb = torch.ones(len(params), BATCH, device=device)
    stacked_grads = torch.autograd.grad(train._loss_terms(spec, stacked, xb, yb, wb).sum(),
                                        list(stacked.parameters()))
    with torch.no_grad():
        stacked_out = stacked(xb)
    out_diff = grad_diff = 0.0
    for m, model in enumerate(serials):
        with torch.no_grad():
            ref = model(xb[m])
        out_diff = max(out_diff, ((stacked_out[m] - ref).abs().max() / ref.abs().max()).item())
        grads = torch.autograd.grad(train._loss_terms(spec, model, xb[m], yb[m], wb[m]),
                                    list(model.parameters()))
        for (name, _), got, want in zip(model.named_parameters(), stacked_grads, grads):
            if not name.endswith(".bk"):
                grad_diff = max(grad_diff, ((got[m] - want).abs().max()
                                            / want.abs().max()).item())
    return out_diff, grad_diff


def fleet_loss_check(card: str, device: str = "cuda") -> dict:
    """A two-machine bucket against the serial trainer given the same
    initial parameters and orders. The gate that tells a stacking fault
    (a wrong machine slice, a wrong loss sum) from rounding: one batch's
    output and parameter gradients, stacked against serial, within
    TOL_GRAD_REL in float32 and TOL_BF16_MODEL_REL in bf16. Then LOSS_STEPS
    float32 step losses per machine within TOL_LOSS_REL of the serial
    trainer's, printed beside how far the serial trainer drifts from
    parameters one float32 ulp up. Returns the differences."""
    import torch

    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.models.scaler import MinMaxScaler
    from gordo_tpu_torch.ops import nn, train

    spec = TransformerAutoEncoder(**CONFIG).build_spec(len(TAGS), len(TAGS))
    n_rows = LOSS_STEPS * BATCH + spec.lookback_window - 1
    rng = np.random.RandomState(SEED + 6)
    rows = [MinMaxScaler().fit(x).transform(x) for x in (_series(n_rows, 0, rng),
                                                         _series(n_rows, 5000, rng))]
    X = torch.as_tensor(np.stack(rows), dtype=torch.float32, device=device)
    params = [[{k: v.numpy() for k, v in p.items()}
               for p in nn.init_model_params(spec, torch.Generator().manual_seed(SEED + m))]
              for m in range(2)]
    orders = torch.stack([torch.randperm(LOSS_STEPS * BATCH,
                                         generator=torch.Generator().manual_seed(m))
                          for m in range(2)])
    diffs = {}
    for dtype, tol in (("float32", TOL_GRAD_REL), ("bfloat16", TOL_BF16_MODEL_REL)):
        dtype_spec = TransformerAutoEncoder(**CONFIG, compute_dtype=dtype).build_spec(
            len(TAGS), len(TAGS))
        out_diff, grad_diff = _one_batch_diffs(dtype_spec, params, X, orders, device)
        print(f"two-machine bucket vs the serial model ({dtype}), one batch: output max rel "
              f"diff {out_diff:.3e}, gradients max rel diff {grad_diff:.3e} (gate {tol:g})",
              flush=True)
        if not (out_diff <= tol and grad_diff <= tol):
            raise AssertionError(f"the {dtype} stacked model's batch disagrees with serial")
        diffs[dtype] = {"out": out_diff, "grad": grad_diff}

    stacked = nn.StackedTransformerModel(spec, nn.stack_params(params), torch.device(device))
    _, losses = train.run_masked_epoch(stacked, train.make_optimizer(
        spec.optimizer, stacked.parameters()), X, X, orders, LOSS_STEPS * BATCH, BATCH)
    worst, per_step, ulp = 0.0, [], []
    for m in range(2):
        curves = []
        # the serial trainer, and again from every parameter one float32 ulp
        # up: how far rounding alone moves these 20 losses
        for start in ([dict(p) for p in params[m]],
                      [{k: np.nextafter(v, np.float32(np.inf)) for k, v in p.items()}
                       for p in params[m]]):
            model = nn.TransformerModel(spec, start, torch.device(device))
            curves.append(train.run_epoch(model, train.make_optimizer(
                spec.optimizer, model.parameters()), X[m], X[m], orders[m], BATCH)[1])
        rel = (losses[:, m] - curves[0]).abs().div(curves[0].abs())
        worst = max(worst, rel.max().item())
        per_step.append([float(f"{x:.2e}") for x in rel.tolist()])
        ulp.append((curves[1] - curves[0]).abs().div(curves[0].abs()).max().item())
    print(f"two-machine bucket vs the serial trainer, {LOSS_STEPS} step losses each: max rel "
          f"diff {worst:.3e} on {card}; by step {per_step}; the serial trainer from "
          f"parameters one ulp up, per machine: {[f'{x:.3e}' for x in ulp]}", flush=True)
    if not worst <= TOL_LOSS_REL:
        raise AssertionError("the stacked losses disagree with the serial trainer's")
    return {**diffs, "losses": worst, "ulp": max(ulp)}


def cli_batch_build(root: Path, device: str = "cuda") -> None:
    """``python -m gordo_tpu_torch batch-build`` of the float32 fleet in a
    subprocess on the card (it must exit 0 and report every machine); one
    of its artifacts then answers a base and an anomaly request through the
    server."""
    from gordo_tpu_torch.server.server import make_server

    config = root / "fleet.json"
    config.write_text(json.dumps({"machines": fleet_configs()}))
    output = root / "fleet-cli"
    command = [sys.executable, "-m", "gordo_tpu_torch", "--log-level", "WARNING",
               "batch-build", str(config), str(output), "--project-name", "smoke"]
    if device != "cuda":
        command += ["--device", device]
    started = time.perf_counter()
    result = subprocess.run(command, cwd=REPO, capture_output=True, text=True, timeout=600,
                            env={**os.environ, "PYTHONPATH": str(REPO)})
    built = [line for line in result.stdout.splitlines() if line.startswith("built: ")]
    print(f"python -m gordo_tpu_torch batch-build: exit {result.returncode} in "
          f"{time.perf_counter() - started:.1f} s, {len(built)} machines built", flush=True)
    if result.returncode != 0 or len(built) != FLEET_MACHINES:
        print(result.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"batch-build exited {result.returncode}")
    server = make_server("127.0.0.1", 0, device=device, collection_dir=str(output))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/smoke/transformer-ae-512-m0"
        values = _provider_continuation(_config_rows(fleet_configs()[0]), 1535,
                                        np.random.RandomState(SEED + 7), FLEET_TAGS[0])
        stamps = [(datetime(2020, 2, 12, 16, tzinfo=timezone.utc) + timedelta(minutes=10 * i))
                  .isoformat() for i in range(len(values))]
        frame = {tag: dict(zip(stamps, values[:, j].tolist()))
                 for j, tag in enumerate(FLEET_TAGS[0])}
        for route in ("prediction", "anomaly/prediction"):
            status, body, _, ms = _request(f"{url}/{route}", {"X": frame, "y": frame})
            rows = len(json.loads(body)["data"]["model-output"][FLEET_TAGS[0][0]])
            print(f"fleet artifact POST {route}: {status}, {rows} rows in {ms:.1f} ms", flush=True)
            if status != 200 or rows != len(values) - CONFIG["lookback_window"] + 1:
                raise AssertionError(f"the fleet artifact's {route}: {status}, {rows} rows")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "gordo_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from gordo_tpu_torch.ops import _build

    card = _card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for stem, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"  {stem}: {line.strip()}")
    occupancy = _occupancy()
    mma = _sass_mma(libs)
    wgmma = wgmma_report(occupancy)

    forward = kernel_phase(card)
    dq, dkv = backward_kernel_phase(card)
    bf16_forward, bf16_dq, bf16_dkv = bf16_kernel_phase(card)
    entries = [forward, dq, dkv, bf16_forward, bf16_dq, bf16_dkv]
    # each kernel's __global__ name and the tensor-core instruction its SASS
    # must hold: HGMMA (wgmma) and no HMMA for the three bf16 kernels, HMMA
    # (mma.sync) for the float32 ones
    for entry, kernel, op in zip(entries, (
            "flash_forward_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32",
            "flash_forward_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"),
            ("HMMA", "HMMA", "HMMA", "HGMMA", "HGMMA", "HGMMA")):
        entry["occupancy_by_head_dim"] = occupancy[entry["name"]]
        if entry["name"] in wgmma:
            entry["wgmma_by_head_dim"] = wgmma[entry["name"]]
        for key in ("HMMA", "HGMMA"):
            entry[f"sass_{key.lower()}"] = (sum(n[key] for f, n in mma.items() if kernel in f)
                                            if mma else None)
        if mma and not entry[f"sass_{op.lower()}"]:
            raise AssertionError(f"{kernel}'s SASS holds no {op} instruction")
        if mma and op == "HGMMA" and entry["sass_hmma"]:
            raise AssertionError(f"{kernel}'s SASS holds HMMA beside its HGMMA")
    fleet_times = fleet_kernel_times(card)
    torch.cuda.empty_cache()

    collections = [REPO / "build" / "chip_smoke" / rev for rev in ("1", "2", "3")]
    fleet_root = REPO / "build" / "chip_smoke_fleet"
    for collection in collections + [fleet_root]:
        shutil.rmtree(collection, ignore_errors=True)
        collection.mkdir(parents=True)
    spec, layers, scaler = write_artifact(collections[0])
    serving = main_path(card, spec, layers, scaler, collections[0])
    torch.cuda.empty_cache()
    base_route = server_surface_path(card, spec, layers, scaler, collections[0])
    torch.cuda.empty_cache()
    build, serial_seconds = build_path(card, collections[1])
    torch.cuda.empty_cache()
    bf16_build, bf16_serial_seconds = bf16_build_path(card, collections[2])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fleet = fleet_path(card, fleet_root, serial_seconds)
    torch.cuda.empty_cache()
    bf16_fleet = fleet_path(card, fleet_root, bf16_serial_seconds, compute_dtype="bfloat16")
    torch.cuda.empty_cache()
    fleet_loss_check(card)
    cli_batch_build(fleet_root)
    print(f"fleet phase: {time.perf_counter() - t0:.1f} s", flush=True)

    forward["launches_by_path"] = {"serving": serving, "server_surface": base_route,
                                   "build": build["forward"], "serving_built": build["serving"],
                                   "fleet": fleet["forward"]}
    bf16_forward["launches_by_path"] = {"build": bf16_build["forward"],
                                        "serving_built": bf16_build["serving"],
                                        "fleet": bf16_fleet["forward"]}
    for entry, key, launches, fleet_launches in (
            (dq, "dq", build, fleet), (dkv, "dkv", build, fleet),
            (bf16_dq, "dq", bf16_build, bf16_fleet), (bf16_dkv, "dkv", bf16_build, bf16_fleet)):
        entry["launches_by_path"] = {"build": launches[key], "fleet": fleet_launches[key]}
    for entry in entries:
        entry["launches"] = sum(entry["launches_by_path"].values())
        entry["fleet_shape"] = fleet_times[entry["name"]]
        if entry["launches"] < 1:
            raise AssertionError(f"the main paths launched no {entry['name']} kernel")

    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
