"""
Drive the PyTorch/CUDA port (gordo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

1. Device: the card's name and power limit, CUDA version; TF32 is turned
   off for matmuls and cuDNN, so every reference below is float32.
2. Build: every kernel of ``gordo_tpu_torch/ops/csrc`` with nvcc, the
   sources compiled in parallel, and beside them the request codec's
   native library (``gordo_tpu_torch/native/gordo_native.cpp``) with g++.
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
   float32 gates above, bf16 within one ulp of the twin run in float64 and
   at most 1% different from either twin) and timed there beside their
   bounds and ``scaled_dot_product_attention``. The LSTM recurrence's forward and
   backward kernels (``lstm_recurrence.cu``, no Pallas counterpart) are
   held against their plain twins in float32 (1e-4 relative) and bf16
   (2e-2) at compressor-b's, bench.py's lstm_ae_144 (alone and as a
   64-machine fleet step), the factories' default width, the served
   shapes and U 128 and 512, the backward bit-identical on a rerun and the
   serving forward equal to the training forward, and timed beside their
   bounds, their twins and cuDNN's ``torch.nn.LSTM``; each tensor-core
   instantiation's registers, spills and HMMA count are printed (its SASS
   must hold HMMA). The wide head dims (the kernels take 16,
   32 and every multiple of 8 from 64 to 256, each through its class,
   csrc/head_dim.cuh): all six kernels against their twins at dh 72, 80,
   96, 120, 136, 192, 200 and 256, at small BH and ragged T, causal and
   not, and at the d384 path's training shapes (BH 128 and 256, T 512, dh
   96), then at dh 96 and 256, BH 4,096 and 1,024, T 512, causal (the
   gates of the fleet's shape, the backward bit-identical on a rerun),
   timed there beside their bounds (from the true dh), their twins and
   ``scaled_dot_product_attention``; each class's registers, spills,
   shared memory and blocks per SM are printed.
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
6. Batcher path (float32 here, bf16 after step 8): the JAX package's
   default serving path, its bench's batcher A/B. Eight
   ``transformer-ae-512`` artifacts with their own seeded weights are served
   by the port's server; 16 threads each POST 2 anomaly requests of 600 rows
   (89 windows, padded to 128), round robin over the models, in the
   rectangular body the native parser takes, with
   ``GORDO_TPU_SERVING_BATCH`` 0, then 1, then auto; then 8 concurrent
   1,535-row requests, one per model, unbatched and batched. Every answer
   is 200, every body parsed and every answer encoded natively, the codec
   not poisoned, no plain attention, no bisection or serial rescue; forced
   on, the forward launches once per block a fused call and there are
   fewer fused calls than requests; each batched model output is within
   the dtype's served tolerance (TOL_OUT_REL, TOL_BF16_MODEL_REL) of the
   same request unbatched. Then the codec's stages for one 1,535-row
   request (native against the dict path), 16 requests queued at once with
   ``GORDO_TPU_DEVICE_PIPELINE`` 0 and 1 (the same fused calls, identical
   outputs), the peak device memory per window of a direct predict and of
   one fused call of eight 1,535-row requests, and the forward kernel at
   that call's BH against its twin, its bound and SDPA.
7. Build path: one step's gradients and the first 20 step losses of the
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
8. bf16: the bf16 forward, dQ and dK/dV kernels against their plain twins
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
9. Fleet: eight ``transformer-ae-512`` machines (each its own tags, so its
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
10. Feedforward build: ``python -m gordo_tpu_torch build`` of
   examples/config.yaml's two feedforward machines as written
   (``pump-station-a``, a DiffBasedAnomalyDetector, and ``turbine-c``, a
   DiffBasedKFCVAnomalyDetector with shuffled KFold(5) folds), two
   processes at once on the card: finite thresholds, held-out error below
   the seeded weights', the KFCV folds sklearn's.
11. Feedforward serving: both artifacts and a ``transformer-ae-512``
   artifact in one collection served with batching ``auto`` (run-server's
   default): bench.py's request (100 samples of the machine's tags) on
   both routes within TOL_FF of the direct predict, 100 sequential
   anomaly requests a model (p50, p95, samples a second, Server-Timing's
   phases), the auto A/B's decisions; then, batching forced on, 48
   feedforward and 8 Transformer requests from 16 users at once: no fused
   call holding two specs (the batcher's counters), one forward launch
   per block a fused Transformer call, every answer within its tolerance
   of the direct predict.
12. Feedforward fleet: two hourglass machines stacked against serial on one
   batch (TOL_FF); then ``batch-build`` of bench.py's training shape,
   FF_FLEET_MACHINES hourglass autoencoders (4 tags, 7 days of 10-minute
   rows, 5 epochs, batch 128, TimeSeriesSplit(3) with thresholds), and
   the fleet's eight ``transformer-ae-512`` machines in one config: exit 0,
   every machine an artifact, the buckets apart, the Transformer bucket's
   dQ and dK/dV launches; machines a minute beside one serial build x N.
13. Fast lanes: the float32 batcher artifacts and ``pump-station-a``
   served by the default lane (HTTP/1.1, keep-alive), the fast lane's
   thread lane and its event loop, batching forced on and ``auto``, the
   clients in a child process: 16 users on keep-alive connections sending
   600-row anomaly requests round robin, one request a Transformer in
   turn, and bench.py's 100 sequential requests over one connection and
   over a connection each. Every answer 200, the sequential answers the
   default lane's bytes (forced on), the rest within TOL_MODEL_REL,
   connections reused, the forward launched once per block a fused call
   (a request alone in each on the event loop); ``openapi.json`` served.
14. KFCV fleet: ``batch-build`` of ``turbine-c``, ``pump-station-a``,
   128 KFCV bench machines under a seeded KFold(5), 128 under the default
   TimeSeriesSplit and the eight ``transformer-ae-512``: no machine built
   serially, the geometries' buckets apart, the KFold machines' split
   metadata sklearn's, the thresholds the plain KFCV math on the program's
   fold predictions (1e-9) and within 3x of a serial build's, dQ and dK/dV
   launched by the Transformer bucket alone.
15. LSTM example build: ``build`` of examples/config.yaml's LSTM machine
   (``compressor-b``, an LSTMAutoEncoder, lstm_hourglass, lookback 24, 3
   epochs, batch 1) as written, through the port's CLI in this process:
   finite thresholds, the offset 23, held-out error below the seeded
   weights', the float32 recurrence backward launched once per LSTM layer a
   step; then a step's host-clock ms on the kernels and on the plain twin.
16. Windowed serving: ``lstm_ae_144``, ``lstm_forecast_144``, ``tcn_144``
   and ``lstm_model_144`` (the LSTM factory at its defaults: U 256, 128 and
   64) artifacts (seeded weights, float32 and bf16) and a
   ``transformer-ae-512`` artifact in one collection: 1,535-row anomaly
   requests with batching ``auto`` (p50), then forced on, each answer
   within its dtype's tolerance of the direct predict, no fused call of two
   specs, the recurrence forward once per LSTM layer a fused LSTM call (U
   256 twice a fused ``lstm_model_144`` call), the flash forward once per
   block a fused Transformer call.
17. Windowed fleet: ``batch-build`` of WINDOWED_FLEET_MACHINES bf16 machines
   of each windowed family beside the eight ``transformer-ae-512``: no
   serial build, one family a stacked program, the bf16 recurrence
   backward once per LSTM layer a stacked step (U 256 twice a step of
   ``lstm_model_144``'s bucket), dQ and dK/dV from the
   Transformer bucket alone, held-out errors below the seeded weights';
   the wall beside one serial build of each family x N.
18. ``transformer-ae-512-d384`` (``transformer-ae-512`` at d_model 384
   over 4 heads, dh 96, ff 768): ``build`` through the port's CLI in this
   process in float32 and bf16 (every CV score line, finite thresholds,
   held-out error below the seeded weights', dQ and dK/dV once per block a
   step, no plain attention; phases, ms a fit step, peak memory); both
   artifacts served as ``run-server`` serves them, 5 requests of 1,535 rows
   direct and with the batcher forced on (the fused answers within the
   dtype's tolerance of the direct, the direct within TOL_MODEL_REL, bf16
   TOL_BF16_MODEL_REL, of plain attention; the peak memory a window of a
   direct predict and of a fused call of 8,192 windows); a stacked
   two-machine bucket against the serial trainer (``fleet_loss_check``).
19. The Switch-MoE Transformer (``moe_path``): ``moe-transformer-ae-512``
   (``transformer-ae-512`` with each FFN 8 Switch experts of 512, capacity
   factor 1.25) built through the port's CLI in this process in float32
   and bf16 (as step 18's builds: the dtype's dQ and dK/dV once per block
   a step, no plain attention; phases, ms a fit step, peak memory); both
   artifacts served as ``run-server`` serves them, 5 requests of 1,535
   rows direct and with the batcher forced on, the served answers equal to
   the direct predict and the fused lane recomputed with their routing;
   every comparison of two MoE computations compares their routing first
   (``routing_gate``: a token routed to another expert must have a logit
   gap under MOE_FLIP_GAP, 1e-5 in float32 and one bf16 ulp of its top
   logit in bf16, and taints its window; the untainted windows are held
   to the dtype's tolerance): the fused lane against the direct predict,
   the direct against plain attention, and each lane of one fused call of
   eight full-width requests (8,192 windows, its peak memory) against its
   direct predict; the tokens dropped per block and each expert's load;
   some token of the served requests must go over capacity. Then stacked
   buckets of it and of ``moe_model_144`` (the JAX factory's defaults:
   lookback 144, d_model 64, 4 heads of 16, 8 experts of 128) against the
   serial trainer (``fleet_loss_check``), a ``batch-build`` of two of each
   (two stacked programs, no serial build, float32 dQ and dK/dV once per
   block a stacked step at dh 64 and at dh 16 by the wrapper's head-dim
   tally, held-out errors below the seeded weights'), and the six flash
   kernels timed at dh 16 at ``moe_model_144``'s stacked step (BH 256, T
   144) beside their bounds, twins and SDPA.
20. Telemetry and observability (``observability_path``): the batcher
   phases' first ``transformer-ae-512`` and ``transformer-ae-512-bf16``
   artifacts served as ``run-server`` serves them (batching forced on) with
   ``GORDO_TPU_DEBUG_ENDPOINTS``, ``ENABLE_PROMETHEUS``,
   ``GORDO_TPU_SLO_P99_MS``, ``GORDO_TPU_LOG_FORMAT=json`` and a small
   ``GORDO_TPU_FLIGHT_SLOW_S``, on the default lane, then on the event-loop
   fast lane: 16 users of two 1,535-row requests, every fourth with a
   ``traceparent``, then a 404 and a 400. Gates: ``X-Gordo-Trace`` on every
   answer (a sent trace id echoed); ``/metrics`` counting exactly these
   requests by the reference's labels and the fleet series by rule and
   status class; the fuse-width count the batcher's fused calls; the
   achieved FLOPs the analytic sum; the busy ratio in (0, 1], busy seconds
   within the wall, online MFU in (0, 1); ``bytes_in_use`` equal to
   ``torch.cuda.memory_allocated()`` at rest; ``/debug/flight`` holding the
   404, the 400 and a slow traced request with its linked device call;
   ``/debug/slo`` reporting both models. On the default lane also: the busy
   seconds of one steady burst (16 users of OBS_BUSY_REQUESTS requests)
   within OBS_BUSY_TOL of the union of the kernel intervals on the
   dispatcher's stream in a ``torch.profiler`` trace of the burst;
   ``/debug/profile?device=1&seconds=2`` under load without error,
   naming the flash forward of each dtype; a burst ``/debug/profile``
   naming ``gordo-batcher``; JSON log lines carrying sent trace ids. Then
   p50 and p99 of the same traffic to each dtype's model with every knob
   unset and every knob on (printed); and a ``batch-build`` of two
   ``transformer-ae-512`` machines (16 days of rows) with ``--trace-file``,
   ``--metrics-file`` and ``GORDO_TPU_PROFILE_DIR``: the build's span names
   and phase labels, and the ``torch.profiler`` trace naming the float32 dQ
   and dK/dV kernels (its size and export time printed).
21. A ``batcher_path`` JSON line (both dtypes' numbers), a ``feedforward``
   JSON line, a ``fastlane``/``kfcv_fleet`` JSON line, a ``windowed`` JSON
   line, a ``transformer-ae-512-d384`` JSON line, a ``moe`` JSON line, an
   ``observability`` JSON line, a
   ``kernels`` JSON line (twenty-two entries: the six flash kernels at dh
   64 with their results by head dim and the observability phase's
   launches among their paths, the six again at dh 96 with the d384
   path's launches and at dh 16 with the MoE fleet's, then the LSTM
   recurrence's forward and backward in float32 and bf16), then
   the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failure raises, so the exit code is not 0 and no result line is
printed. Without CUDA, or outside a checkout, it exits 2 at once.
"""

import concurrent.futures
import dataclasses
import gc
import json
import math
import os
import re
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
def build_config(name: str, tags=TAGS, base=None, **estimator) -> dict:
    """A transformer-ae-512 machine: 6,144 ten-minute RandomDataset rows of
    ``tags``, the model written with the JAX package's paths (``estimator``
    added to the TransformerAutoEncoder's arguments, ``base``, CONFIG by
    default), the default CV and metrics."""
    return {
        "name": name,
        "dataset": {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00+00:00",
                    "train_end_date": "2020-02-12T16:00:00+00:00", "tags": list(tags),
                    "resolution": "10min"},
        "model": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {
            "base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
                "sklearn.preprocessing.MinMaxScaler",
                {"gordo_tpu.models.models.TransformerAutoEncoder": {
                    **(CONFIG if base is None else base), "epochs": 1, "batch_size": BATCH,
                    **estimator}},
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


def _sdpa_ms(q, k, v, iters: int, do=None, three_d: bool = True) -> dict:
    """``scaled_dot_product_attention`` (causal) on the same (BH, T, dh)
    inputs, its forward or, with ``do``, its backward through autograd:
    given as one (1, BH, T, dh) batch, where PyTorch may pick its fused
    kernels (``library_ms``), and, unless ``three_d`` is false, as the
    (BH, T, dh) tensors themselves (``library_3d_ms``, which takes its
    unfused path and holds the (BH, T, T) scores)."""
    import torch
    import torch.nn.functional as F

    times = {"library_3d_ms": None}
    for key, view in (("library_ms", lambda x: x.unsqueeze(0)),
                      ("library_3d_ms", lambda x: x))[:2 if three_d else 1]:
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


def _head_dim_class(name: str, dh: int) -> int:
    """The head-dim class whose instantiation of kernel ``name`` runs dh,
    as its library has it (csrc/head_dim.cuh); 0 where it takes no dh."""
    from gordo_tpu_torch.ops import _build

    stem, tag = (("flash_attention_bf16", "bf16") if name.endswith("_bf16")
                 else ("flash_attention", "f32"))
    return getattr(_build.load_library(stem), f"gordo_flash_attention_{tag}_head_dim_class")(dh)


def _classes(name: str) -> tuple:
    """The head-dim classes of kernel ``name``: those of the supported dims."""
    from gordo_tpu_torch.ops.flash_attention import SUPPORTED_HEAD_DIMS

    return tuple(sorted({_head_dim_class(name, dh) for dh in SUPPORTED_HEAD_DIMS}))


def _occupancy() -> dict:
    """Per tensor-core kernel and head-dim class: its dynamic shared memory
    and the blocks of it that one SM holds (``cudaOccupancy...``)."""
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
        for dh in _classes(name):
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
    """``{dh class: (registers, spill store bytes)}`` of ``kernel``'s
    instantiation that runs the dh filling each class (``kernel<DH,
    false>`` where the class has it, else ``kernel<DH, true>``, or
    ``kernel_dh<DH>``; csrc/head_dim.cuh), from the ``-Xptxas -v`` output
    of this build of ``stem`` (empty when the library was loaded as
    built)."""
    from gordo_tpu_torch.ops import _build

    pattern = re.compile(re.escape(kernel) + r"(?:ILi(\d+)ELb([01])E|_dh(\d+))")
    report, key = {}, None
    for line in _build.BUILD_LOGS.get(stem, "").splitlines():
        if "Compiling entry function" in line:
            key = None
            match = pattern.search(line)
            if match:
                key = (int(match.group(1) or match.group(3)), match.group(2) == "1")
                report[key] = [None, 0]
        elif key is not None and "spill stores" in line:
            report[key][1] = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif key is not None and "Used" in line and "registers" in line:
            report[key][0] = int(line.split("Used")[1].split("registers")[0])
    return {dh: tuple(report.get((dh, False), report.get((dh, True))))
            for dh in sorted({dh for dh, _ in report})}


def wgmma_report(occupancy: dict) -> dict:
    """Per wgmma kernel and head-dim class: registers a thread as built (before
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
        for dh in _classes(name):
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


# ------------------------------------------------------------ wide head dims
# head dims from 64 to 256 that the kernels run through their padded
# classes: held against the twins at every class and inside classes, at
# small BH and ragged T; timed at dh 96 (transformer-ae-512-d384: d_model
# 384 over 4 heads) and 256 (d_model 1,024), at the serving and fleet BH
GATE_HEAD_DIMS = (72, 80, 96, 120, 136, 192, 200, 256)
GATE_SHAPES = ((3, 77), (2, 200))  # (BH, T)
# (BH, T, dh) of the d384 path's training steps: a serial step (batch 32 x
# 4 heads) and a stacked two-machine step, many works to each persistent block
PATH_GATE_SHAPES = ((128, 512, 96), (256, 512, 96))
TIMED_HEAD_DIMS = (96, 256)
TIMED_BH = (4096, 1024)
ENTRY_NAMES = {"forward": "flash_attention_forward", "dq": "flash_attention_backward_dq",
               "dkv": "flash_attention_backward_dkv"}
N_TENSORS = {"forward": 4, "dq": 6, "dkv": 7}


def head_dim_gates(dtype: str) -> dict:
    """The forward, dQ and dK/dV kernels of ``dtype`` against their twins
    (:func:`twin_gates`) at each of GATE_HEAD_DIMS and GATE_SHAPES, causal
    and not, and at PATH_GATE_SHAPES, causal. Raises on a miss; returns
    ``{kernel: {dh: worst error}}`` (float32: the relative error, bf16: the
    share that differs), ``lse`` likewise, and, under ``max_abs``, the
    largest absolute differences."""
    import torch

    from gordo_tpu_torch.ops import flash_attention as fa

    bf16 = dtype == "bfloat16"
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    worst = {name: {} for name in ("forward", "lse", "dq", "dkv", "max_abs")}
    cases = [(bh, t, dh, causal) for dh in GATE_HEAD_DIMS for bh, t in GATE_SHAPES
             for causal in (True, False)] + [(*shape, True) for shape in PATH_GATE_SHAPES]
    for bh, t, dh, causal in cases:
        q, k, v, do = (torch.randn((bh, t, dh), device="cuda", generator=g)
                       .to(torch.bfloat16 if bf16 else torch.float32) for _ in range(4))
        out, lse = fa.flash_attention_forward(q, k, v, causal)
        errors = twin_gates(q, k, v, do, out, lse, causal)
        worst["lse"][dh] = max(worst["lse"].get(dh, 0.0), errors["lse"])
        for kernel, names in (("forward", ("out",)), ("dq", ("dq",)), ("dkv", ("dk", "dv"))):
            err = max(errors[n]["share_differing" if bf16 else "max_rel_err"] for n in names)
            max_abs = max(errors[n]["max_abs_err"] for n in names)
            worst[kernel][dh] = max(worst[kernel].get(dh, 0.0), err)
            by_dh = worst["max_abs"].setdefault(kernel, {})
            by_dh[dh] = max(by_dh.get(dh, 0.0), max_abs)
        del q, k, v, do, out, lse
    for dh in sorted(worst["forward"]):
        shapes = [(bh, t) for bh, t, d, _ in cases if d == dh]
        print(f"{dtype} kernels at dh {dh} against their twins, (BH, T) {sorted(set(shapes))}: "
              f"worst {'share that differs' if bf16 else 'rel err'} forward "
              f"{worst['forward'][dh]:.3e}, dq {worst['dq'][dh]:.3e}, dkv {worst['dkv'][dh]:.3e}; "
              f"lse {worst['lse'][dh]:.3e}; backward bit-identical on a rerun", flush=True)
    return worst


def head_dim_times(card: str, dtype: str, dims=TIMED_HEAD_DIMS, bhs=TIMED_BH,
                   t: int = None) -> dict:
    """Each kernel of ``dtype`` at (BH, T, dh), causal, for BH in ``bhs``
    and dh in ``dims`` (T the main path's lookback unless ``t`` is given):
    held against its plain twin on the same
    inputs (:func:`twin_gates`), and timed by CUDA events beside its bound
    (from the true dh: the class's padded columns show as a lower share),
    the plain twin (the forward, or the whole backward) and
    ``scaled_dot_product_attention``'s forward or whole backward given
    (1, BH, T, dh). Returns ``{kernel: {dh: {bh: timings and errors}}}``."""
    import torch

    from gordo_tpu_torch.ops import flash_attention as fa

    torch_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    size = 2 if dtype == "bfloat16" else 4
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    times = {kernel: {} for kernel in ENTRY_NAMES}
    t = CONFIG["lookback_window"] if t is None else t
    for dh in dims:
        for bh in bhs:
            q, k, v, do = (torch.randn((bh, t, dh), device="cuda", generator=g).to(torch_dtype)
                           for _ in range(4))
            o, lse = fa.flash_attention_forward(q, k, v, True)
            errors = twin_gates(q, k, v, do, o, lse)
            print(f"{dtype} kernels at ({bh}, {t}, {dh}) causal against their plain twins: "
                  f"{errors}; backward bit-identical on a rerun", flush=True)
            torch.cuda.empty_cache()
            iters = 10 if bh > 1024 else 20
            library = {"forward": _sdpa_ms(q, k, v, iters, three_d=False)["library_ms"],
                       "backward": _sdpa_ms(q, k, v, iters // 2, do=do,
                                            three_d=False)["library_ms"]}
            torch.cuda.empty_cache()
            plain = {"forward": _time_ms(lambda: fa.flash_attention_forward_plain(q, k, v, True),
                                         2),
                     "backward": _time_ms(lambda: fa.flash_attention_backward_plain(
                         q, k, v, o, lse, do, True), 2)}
            torch.cuda.empty_cache()
            for kernel, call, checked in (
                    ("forward", lambda: fa.flash_attention_forward(q, k, v, True),
                     {"out": errors["out"], "lse": errors["lse"]}),
                    ("dq", lambda: fa.launch_dq(q, k, v, o, lse, do, True),
                     {"dq": errors["dq"]}),
                    ("dkv", lambda: fa.launch_dkv(q, k, v, o, lse, do, True),
                     {"dk": errors["dk"], "dv": errors["dv"]})):
                ms = _time_ms(call, iters)
                bound = _flash_bound_ms(bh, t, dh, True, n_tensors=N_TENSORS[kernel],
                                        flop_per_pair=FLOP_PER_PAIR[dtype][kernel],
                                        bytes_per_element=size, dtype=dtype)
                side = "forward" if kernel == "forward" else "backward"
                entry = {"shape": [bh, t, dh], "ms": ms, "plain_ms": plain[side],
                         "library_ms": library[side], "bound_ms": bound["bound_ms"],
                         "bound_by": bound["bound_by"], "flop": bound["flop"],
                         "plain_and_library_compute": "the forward" if side == "forward"
                         else "dq, dk and dv together", "against_plain": checked}
                entry.update(_rates(entry))
                times[kernel].setdefault(dh, {})[bh] = entry
                print(f"{ENTRY_NAMES[kernel]} ({dtype}) at ({bh}, {t}, {dh}) causal on {card}: "
                      f"{ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}, "
                      f"{100 * entry['bound_share']:.1f}%), {entry['achieved_tflop_s']:.1f} "
                      f"TFLOP/s; plain {plain[side]:.4f} ms, scaled_dot_product_attention "
                      f"{library[side]:.4f} ms ({entry['plain_and_library_compute']})",
                      flush=True)
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    return times


# ------------------------------------------------------------ the LSTM recurrence
# the recurrence kernels' shapes, (label, machines M, batch B, steps T,
# units U): examples/config.yaml's compressor-b (lstm_hourglass of 4 tags:
# units 3, 3, 2, 2, 3, 3; batch 1, lookback 24: its widest), bench.py's lstm_ae_144
# (lstm_symmetric dims 64, 32: batch 64, lookback 144) alone and as a
# stacked fleet step of 64 machines, the factories' default width
# (lstm_model's encoding_dim 256), and the served shapes (one or two
# stacked models over 2,048 windows, as pad_for_predict pads a 1,535-row
# request's 1,392)
LSTM_SHAPES = (("compressor-b", 1, 1, 24, 3),
               ("lstm_ae_144", 1, 64, 144, 64), ("lstm_ae_144", 1, 64, 144, 32),
               ("lstm_ae_144 fleet step", 64, 64, 144, 64),
               ("lstm_ae_144 fleet step", 64, 64, 144, 32),
               ("default width", 1, 32, 144, 256),
               ("served", 1, 2048, 144, 64), ("served stacked", 2, 2048, 144, 32))
# held against the twins only, untimed: the smoke's 32-machine fleet step, a
# batch that is not a multiple of its row tile, U 128 (a cluster of 2 in
# float32), U 512 (16 CTAs; float32 streams R from L2) and U 256 over
# stacked models and a ragged batch (M > 1 on the cluster route)
LSTM_CHECK_SHAPES = (("smoke fleet step", 32, 64, 144, 64), ("ragged tile", 3, 101, 24, 64),
                     ("U 128", 1, 32, 144, 128), ("U 512", 1, 32, 144, 512),
                     ("U 256 stacked", 4, 20, 24, 256))
# the entries' top-level numbers: lstm_ae_144 served (its 64-window training
# batch takes the legacy route)
LSTM_MAIN_SHAPE = ("served", 1, 2048, 144, 64)
TOL_LSTM_REL = 1e-4  # float32 kernel vs twin, relative to the largest entry
LSTM_SOURCE = "gordo_tpu_torch/ops/csrc/lstm_recurrence.cu"
# no Pallas kernel: the JAX package's LSTM layer is a lax.scan
LSTM_REPLACES = "gordo_tpu/ops/nn.py:205 (lax.scan, no Pallas kernel)"


def _rel_err(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max().item()
            / max(ref.float().abs().max().item(), 1e-30))


def _lstm_inputs(m: int, b: int, t: int, u: int, dtype, g):
    """Zx as an input projection gives it (entries ~ N(0, 0.25)), a recurrent
    kernel of an orthogonal's scale (1/sqrt(U)) and an output gradient, all
    on the card."""
    import torch

    zx = (0.5 * torch.randn((m, b, t, 4 * u), device="cuda", generator=g)).to(dtype)
    rk = (torch.randn((m, u, 4 * u), device="cuda", generator=g) / u ** 0.5).to(dtype)
    return zx, rk


def _cudnn_lstm_ms(b: int, t: int, u: int, dtype, iters: int) -> dict:
    """cuDNN's ``torch.nn.LSTM`` (tanh, sigmoid; U inputs and U units, one
    layer) in ``dtype`` over (B, T, U) on the card: its forward without
    gradients, and the backward of its output through autograd. It is the
    yardstick only: the port never calls it. None where it does not take
    the dtype."""
    import torch

    try:
        lstm = torch.nn.LSTM(u, u, batch_first=True).to(device="cuda", dtype=dtype)
        x = torch.randn((b, t, u), device="cuda", dtype=dtype, requires_grad=True)
        with torch.no_grad():
            forward = _time_ms(lambda: lstm(x), iters)
        out = lstm(x)[0]
        grad = torch.randn_like(out)
        leaves = [x, *lstm.parameters()]
        backward = _time_ms(lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True),
                            iters)
    except RuntimeError as err:
        print(f"cuDNN LSTM at {dtype}: {err}", flush=True)
        return {"forward": None, "backward": None}
    return {"forward": forward, "backward": backward}


def _lstm_bound(m: int, b: int, t: int, u: int, dtype: str, backward: bool,
                return_sequences: bool) -> dict:
    """The least time of one launch: its bytes read and written once at the
    HBM rate, against h_{t-1} R (or dz R^T) at the card's peak for the
    operand type (PEAK_FLOP_PER_S, as the flash kernels' bounds).
    Forward: zx and R read, the output written; backward: the output's
    gradient, z and c (float32) and R^T read, dZ written.
    ``fp32_core_bound_ms`` takes the operations at the CUDA cores' float32
    rate, where the legacy route computes (below U 8)."""
    elem = 2 if dtype == "bfloat16" else 4
    rows, g4 = m * b * t, 4 * u
    out = rows * u if return_sequences else m * b * u
    if backward:
        n_bytes = elem * out + 4 * rows * g4 + 4 * rows * u + elem * m * u * g4 + elem * rows * g4
    else:
        n_bytes = elem * rows * g4 + elem * m * u * g4 + elem * out
    flops = 2 * rows * u * g4  # the cell's elementwise work is not counted
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOP_PER_S[dtype]
    return {"bound_ms": 1e3 * max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes > by_ops else "operations",
            "fp32_core_bound_ms": 1e3 * max(by_bytes, flops / FP32_FLOP_PER_S),
            "flop": flops, "bytes": n_bytes}


def lstm_kernel_phase(card: str) -> list:
    """The recurrence's forward and backward kernels against their plain
    twins on the card, in float32 and bf16, at each of LSTM_SHAPES and
    LSTM_CHECK_SHAPES: the forward's output and saved z and c, both
    ``return_sequences``; the backward's dZ from the kernel forward's saved
    tensors, bit-identical on a second launch; the serving forward (nothing
    saved) equal to the training forward. Then, at each of LSTM_SHAPES,
    the kernels' times with CUDA events beside their bounds, the twins' and
    cuDNN's ``torch.nn.LSTM`` (at M 1), each with the plan it launched
    with (route, cluster, row tile, k split; csrc/lstm_plan.cuh).
    Returns the four kernels' entries of the ``kernels`` line (float32 and
    bf16, forward and backward)."""
    import torch

    from gordo_tpu_torch.ops import lstm

    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    tol = {torch.float32: TOL_LSTM_REL, torch.bfloat16: TOL_BF16_MODEL_REL}
    worst = {(dtype, kind, err): 0.0 for dtype in tol for kind in ("forward", "backward")
             for err in ("rel", "abs")}
    for label, m, b, t, u in LSTM_SHAPES + LSTM_CHECK_SHAPES:
        for dtype in tol:
            zx, rk = _lstm_inputs(m, b, t, u, dtype, g)
            for return_sequences in (True, False):
                out, (z, c, h) = lstm.lstm_recurrence_forward(zx, rk, "tanh", "sigmoid",
                                                              return_sequences, True)
                serve, _ = lstm.lstm_recurrence_forward(zx, rk, "tanh", "sigmoid",
                                                        return_sequences, False)
                dout = torch.randn(out.shape, device="cuda", generator=g).to(dtype)
                dz = lstm.lstm_recurrence_backward(dout, z, c, rk, "tanh", "sigmoid",
                                                   return_sequences)
                again = lstm.lstm_recurrence_backward(dout, z, c, rk, "tanh", "sigmoid",
                                                      return_sequences)
                torch.cuda.synchronize()
                ref, (ref_z, ref_c, ref_h) = lstm.lstm_recurrence_forward_plain(
                    zx, rk, "tanh", "sigmoid", return_sequences, True)
                ref_dz = lstm.lstm_recurrence_backward_plain(dout, z, c, rk, "tanh", "sigmoid",
                                                             return_sequences)
                fwd = max(_rel_err(out, ref), _rel_err(z, ref_z), _rel_err(c, ref_c),
                          _rel_err(h, ref_h))
                bwd = _rel_err(dz, ref_dz)
                print(f"lstm recurrence {label} M {m} B {b} T {t} U {u} {dtype} "
                      f"return_sequences={return_sequences}: forward max rel err {fwd:.3e}, "
                      f"backward {bwd:.3e}", flush=True)
                if not (fwd <= tol[dtype] and bwd <= tol[dtype]):
                    raise AssertionError(f"the LSTM kernels disagree with their twins at "
                                         f"{label} {dtype}: {fwd:.3e}, {bwd:.3e}")
                if not torch.equal(dz, again):
                    raise AssertionError(f"the LSTM backward differs between two launches "
                                         f"at {label} {dtype}")
                if not torch.equal(serve, out):
                    raise AssertionError(f"the serving forward differs from the training "
                                         f"forward at {label} {dtype}")
                for kind, rel, got, want in (("forward", fwd, out, ref),
                                             ("backward", bwd, dz, ref_dz)):
                    worst[dtype, kind, "rel"] = max(worst[dtype, kind, "rel"], rel)
                    worst[dtype, kind, "abs"] = max(worst[dtype, kind, "abs"], (
                        got.float() - want.float()).abs().max().item())
                del out, z, c, h, serve, dout, dz, again, ref, ref_z, ref_c, ref_h, ref_dz
            del zx, rk
    print(f"lstm recurrence kernels: within their twins at every shape, the backward "
          f"bit-identical on a rerun", flush=True)

    timed = {(dtype, kind): [] for dtype in tol for kind in ("forward", "backward")}
    for label, m, b, t, u in LSTM_SHAPES:
        for dtype in tol:
            cudnn = _cudnn_lstm_ms(b, t, u, dtype, 10) if m == 1 else {
                "forward": None, "backward": None}
            zx, rk = _lstm_inputs(m, b, t, u, dtype, g)
            out, (z, c, _) = lstm.lstm_recurrence_forward(zx, rk, "tanh", "sigmoid", True, True)
            dout = torch.randn(out.shape, device="cuda", generator=g).to(dtype)
            iters = 20
            ms = {
                "forward": _time_ms(lambda: lstm.lstm_recurrence_forward(
                    zx, rk, "tanh", "sigmoid", True, False), iters),
                "backward": _time_ms(lambda: lstm.lstm_recurrence_backward(
                    dout, z, c, rk, "tanh", "sigmoid", True), iters),
            }
            plain = {
                "forward": _time_ms(lambda: lstm.lstm_recurrence_forward_plain(
                    zx, rk, "tanh", "sigmoid", True, False), 3),
                "backward": _time_ms(lambda: lstm.lstm_recurrence_backward_plain(
                    dout, z, c, rk, "tanh", "sigmoid", True), 3),
            }
            training_ms = _time_ms(lambda: lstm.lstm_recurrence_forward(
                zx, rk, "tanh", "sigmoid", True, True), iters)
            for kind in ("forward", "backward"):
                bound = _lstm_bound(m, b, t, u, str(dtype).replace("torch.", ""),
                                    kind == "backward", True)
                row = {"label": label, "shape": [m, b, t, u], "return_sequences": True,
                       "ms": ms[kind], "plain_ms": plain[kind],
                       "library_ms": cudnn[kind],
                       "batch_tile": lstm.batch_tile(m, b),
                       "plan": lstm.kernel_plan(m, b, u, dtype, kind == "backward"),
                       **bound}
                row["bound_share"] = bound["bound_ms"] / ms[kind]
                row["fp32_core_bound_share"] = bound["fp32_core_bound_ms"] / ms[kind]
                row["achieved_tflop_s"] = bound["flop"] / (ms[kind] * 1e9)
                if kind == "forward":
                    row["training_forward_ms"] = training_ms
                timed[dtype, kind].append(row)
                print(f"lstm recurrence {kind} {label} M {m} B {b} T {t} U {u} {dtype} on "
                      f"{card}: kernel {ms[kind]:.4f} ms, bound {bound['bound_ms']:.4f} ms "
                      f"({bound['bound_by']}, {row['bound_share']:.1%}; CUDA cores "
                      f"{bound['fp32_core_bound_ms']:.4f} ms, "
                      f"{row['fp32_core_bound_share']:.1%}), plain "
                      f"{plain[kind]:.4f} ms, cuDNN LSTM {row['library_ms']} ms; plan "
                      f"{row['plan']}", flush=True)
            del zx, rk, out, z, c, dout

    entries = []
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        for kind in ("forward", "backward"):
            rows = timed[dtype, kind]
            main = next((r for r in rows if (r["label"], *r["shape"]) == LSTM_MAIN_SHAPE), {})
            entries.append({
                "name": f"lstm_recurrence_{kind}{suffix}", "route": "cuda",
                "source": LSTM_SOURCE, "replaces": LSTM_REPLACES,
                "dtype": str(dtype).replace("torch.", ""), "launches": None,
                "max_abs_err": worst[dtype, kind, "abs"],
                "max_rel_err": worst[dtype, kind, "rel"],
                "ms": main.get("ms"), "plain_ms": main.get("plain_ms"),
                "bound_ms": main.get("bound_ms"), "bound_by": main.get("bound_by"),
                "fp32_core_bound_ms": main.get("fp32_core_bound_ms"),
                "library_ms": main.get("library_ms"),
                "library": "cuDNN torch.nn.LSTM in the dtype (U in, U units, one layer, "
                           "input projection included); none takes M stacked layers",
                "shape": main.get("shape"), "shapes": rows,
            })
    return entries


# the recurrence's tensor-core instantiations besides dtype and activation
# pair: (backward, n-tiles a forward warp, k split, R held in shared memory)
# (STREAM is built in one layout a direction)
LSTM_TC_INSTANTIATIONS = ((False, 1, 1, True), (False, 1, 2, True), (False, 2, 1, True),
                          (True, 1, 2, True), (True, 1, 4, True),
                          (False, 1, 1, False), (True, 1, 2, False))


def lstm_build_report(mma: dict) -> list:
    """Each tensor-core instantiation of the recurrence kernels as built:
    registers, spilled (local) bytes and the most threads a block
    (cudaFuncGetAttributes), and the HMMA and HGMMA count of its SASS
    (``_sass_mma``'s, by its mangled name); fails where one's SASS holds
    no HMMA. The shared memory and cluster of a launch are its plan's
    (``lstm_kernel_phase``' rows)."""
    import torch

    from gordo_tpu_torch.ops import lstm

    report = []
    for dtype in lstm.DTYPES:
        mangled_t = "f" if dtype == torch.float32 else "13__nv_bfloat16"
        for backward, tiles, ksplit, held in LSTM_TC_INSTANTIATIONS:
            for constants in (True, False):
                layout = f"Li{4 // ksplit}E" if backward else f"Li{tiles}ELi{ksplit}E"
                name = (f"tc_{'backward' if backward else 'forward'}I{mangled_t}"
                        f"{'Li1ELi3E' if constants else 'Lin1ELin1E'}{layout}Lb{int(held)}EE")
                sass = next((n for f, n in mma.items() if name in f), None)
                entry = {"kernel": "backward" if backward else "forward",
                         "dtype": str(dtype).replace("torch.", ""), "tiles_a_warp": tiles,
                         "ksplit": ksplit, "r_in_smem": held, "tanh_sigmoid_constants": constants,
                         **lstm.kernel_attributes(backward, dtype, constants, tiles, ksplit,
                                                  held),
                         "sass_hmma": sass["HMMA"] if sass else None,
                         "sass_hgmma": sass["HGMMA"] if sass else None}
                report.append(entry)
                print(f"  lstm {entry['kernel']} {entry['dtype']} tiles_a_warp {tiles} ksplit "
                      f"{ksplit} R "
                      f"{'held' if held else 'streamed'} "
                      f"{'(tanh, sigmoid)' if constants else 'run-time pair'}: "
                      f"{entry['registers']} registers, {entry['local_bytes']} B local "
                      f"(spills), {entry['sass_hmma']} HMMA, {entry['sass_hgmma']} HGMMA",
                      flush=True)
                if mma and not entry["sass_hmma"]:
                    raise AssertionError(f"the recurrence's {name} holds no HMMA in its SASS")
    return report


def _series(n_rows: int, offset: int, rng) -> np.ndarray:
    """Eight sine tags with noise, rows ``offset .. offset + n_rows``."""
    t = np.arange(offset, offset + n_rows)[:, None]
    period = 144.0 * (1.0 + np.arange(len(TAGS)) / 4.0)
    return np.sin(2 * np.pi * t / period) + 0.05 * rng.randn(n_rows, len(TAGS))


def write_artifact(collection: Path, device: str = "cuda", name: str = "transformer-ae-512",
                   seed: int = SEED, estimator_cls: str = "TransformerAutoEncoder",
                   config: dict = None, **estimator):
    """The artifact ``name`` of a windowed estimator of 8 tags (by default
    the transformer-ae-512 one: ``CONFIG``): weights from ``seed``, scalers
    fitted on a training span, thresholds from a held-out span (the JAX
    package's rule: the max over the span of the rolling(6) minimum of the
    error); ``estimator`` adds to the estimator's arguments."""
    import torch

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.models.anomaly.diff import _rolling
    from gordo_tpu_torch.models.models import ESTIMATORS
    from gordo_tpu_torch.models.scaler import MinMaxScaler
    from gordo_tpu_torch.ops.nn import init_model_params
    from gordo_tpu_torch.serializer.from_jax import detector_from_arrays

    config = CONFIG if config is None else config
    rng = np.random.RandomState(SEED)
    train, held_out = _series(4096, 0, rng), _series(2048, 4096, rng)
    estimator = ESTIMATORS[estimator_cls](**config, **estimator)
    spec = estimator.build_spec(len(TAGS), len(TAGS))
    params = init_model_params(spec, torch.Generator().manual_seed(seed))
    scaler = MinMaxScaler().fit(train)
    layers = [{k: v.numpy() for k, v in p.items()} for p in params]
    detector = detector_from_arrays(
        spec, layers, scaler.min_, scaler.scale_, scaler.min_, scaler.scale_,
        estimator=estimator_cls, kind=config["kind"], estimator_kwargs=estimator.kwargs,
        device=device,
    )
    pred = detector.base_estimator.predict(held_out)
    truth = held_out[-len(pred):]
    abs_err = np.abs(truth - pred)
    mse = np.square(scaler.transform(pred) - scaler.transform(truth)).mean(axis=1)
    detector.feature_thresholds_ = np.nanmax(_rolling(abs_err, 6, np.min), axis=0)
    detector.aggregate_threshold_ = float(np.nanmax(_rolling(mse, 6, np.min)))
    metadata = {"name": name, "model": config,
                "dataset": {"tags": TAGS, "resolution": "10min"}}
    serializer.dump(detector, str(collection / name), tags=TAGS, metadata=metadata)
    return spec, layers, scaler


def _payload(values: np.ndarray, start: datetime) -> dict:
    stamps = [(start + timedelta(minutes=10 * i)).isoformat() for i in range(len(values))]
    frame = {tag: dict(zip(stamps, values[:, j].tolist())) for j, tag in enumerate(TAGS)}
    return {"X": frame, "y": frame}


def _with_attention(spec, impl: str):
    """``spec`` with every attention layer (Transformer and MoE blocks) on
    ``impl``."""
    return dataclasses.replace(spec, layers=tuple(
        dataclasses.replace(layer, attention_impl=impl)
        if hasattr(layer, "attention_impl") else layer for layer in spec.layers))


def _attention_blocks(spec) -> int:
    """The layers of ``spec`` that run attention (Transformer and MoE blocks)."""
    return sum(hasattr(layer, "attention_impl") for layer in spec.layers)


# the wrappers' launch counters: the forward, dQ and dK/dV kernels of each dtype
COUNTERS = {"float32": ("LAUNCHES", "DQ_LAUNCHES", "DKV_LAUNCHES"),
            "bfloat16": ("BF16_LAUNCHES", "BF16_DQ_LAUNCHES", "BF16_DKV_LAUNCHES")}


# the LSTM recurrence's counters: its forward and backward kernels of each dtype
LSTM_COUNTERS = {"float32": ("FORWARD_LAUNCHES", "BACKWARD_LAUNCHES"),
                 "bfloat16": ("BF16_FORWARD_LAUNCHES", "BF16_BACKWARD_LAUNCHES")}


def _reset_launches() -> None:
    from gordo_tpu_torch.ops import flash_attention as fa, lstm

    for names in COUNTERS.values():
        for name in names:
            setattr(fa, name, 0)
    fa.HEAD_DIM_LAUNCHES.clear()
    for names in LSTM_COUNTERS.values():
        for name in names:
            setattr(lstm, name, 0)
    lstm.UNIT_LAUNCHES.clear()


def _lstm_launches(dtype: str) -> dict:
    """``{"forward": n, "backward": n}``: the launches of ``dtype``'s LSTM
    recurrence kernels since the counters were last reset."""
    from gordo_tpu_torch.ops import lstm

    return {key: getattr(lstm, name)
            for key, name in zip(("forward", "backward"), LSTM_COUNTERS[dtype])}


def _lstm_unit_launches(dtype: str) -> dict:
    """``{"forward": {U: n}, "backward": {U: n}}``: the launches of
    ``dtype``'s LSTM recurrence kernels by units since the counters were
    last reset."""
    from gordo_tpu_torch.ops import lstm

    return {key: {u: n for (counter, u), n in sorted(lstm.UNIT_LAUNCHES.items(),
                                                      key=lambda item: item[0][1])
                  if counter == name}
            for key, name in zip(("forward", "backward"), LSTM_COUNTERS[dtype])}


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


# the batcher phase: the JAX bench's batcher A/B (16 users, 8 models, round
# robin), each user posting BATCHER_REQUESTS anomaly requests of BATCHER_ROWS
# rows: 89 windows, padded to 128, attention BH 512 a request. Two requests a
# user (the JAX bench's four cost the script ~2 s a dtype) and the auto
# mode's A/B at AB_ROUNDS rounds keep the script near its earlier time.
BATCHER_MODELS = 8
BATCHER_USERS = 16
BATCHER_REQUESTS = 2
AB_ROUNDS = 2
BATCHER_ROWS = 600
FULL_ROWS = 1535  # a full-width request: 1,024 windows
# the pipeline check: this many requests of BATCHER_ROWS rows queued at once
# into a batcher fusing at most PIPELINE_FUSE of them a call
PIPELINE_ITEMS = 16
PIPELINE_FUSE = 4


def _rect_body(values: np.ndarray) -> bytes:
    """An anomaly request body in the rectangular form the native parser
    takes: ``{"X": [[...]], "y": [[...]]}``."""
    rows = values.tolist()
    return json.dumps({"X": rows, "y": rows}).encode()


def _drive(project: str, requests: list, users: int) -> tuple:
    """POST ``requests`` (``(model name, body)``) to the anomaly route from
    ``users`` threads, user u sending requests u, u + users, ... one after
    another. Returns ``([(status, body, ms)], wall seconds)``."""
    results = [None] * len(requests)

    def user(u):
        for i in range(u, len(requests), users):
            name, body = requests[i]
            req = urllib.request.Request(f"{project}/{name}/anomaly/prediction", data=body,
                                         headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=300) as resp:
                    status, answer = resp.status, resp.read()
            except urllib.error.HTTPError as err:
                status, answer = err.code, err.read()
            except OSError as err:  # no answer at all
                status, answer = None, repr(err).encode()
            results[i] = (status, answer, 1e3 * (time.perf_counter() - t0))

    threads = [threading.Thread(target=user, args=(u,)) for u in range(users)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return results, time.perf_counter() - t0


def _reset_codec() -> None:
    from gordo_tpu_torch.server import fast_codec

    for name in fast_codec.COUNTERS:
        setattr(fast_codec, name, 0)


def _codec_counts() -> dict:
    from gordo_tpu_torch.server import fast_codec

    return {name.lower(): getattr(fast_codec, name) for name in fast_codec.COUNTERS}


def _served_run(card: str, project: str, requests: list, users: int, mode: str, dtype: str,
                n_blocks: int, n_out: int, label: str, must_fuse: bool = True) -> dict:
    """One run of ``requests`` through the server with
    ``GORDO_TPU_SERVING_BATCH=mode`` and a fresh batcher, checked: every
    answer 200, each body parsed and each answer encoded by the native codec
    (no fallback, no poisoning), no plain attention; with the batcher forced
    on, ``n_blocks`` forward launches a fused call, fewer fused calls than
    requests (where ``must_fuse``), no bisection and no serial rescue;
    batching off, ``n_blocks``
    launches a request. Returns the run's outputs, numbers and batcher."""
    from gordo_tpu_torch.server import batcher

    os.environ["GORDO_TPU_SERVING_BATCH"] = mode
    batcher.reset_batcher()
    _reset_codec()
    _reset_launches()
    with _PlainAttentionCalls() as plain:
        results, wall = _drive(project, requests, users)
    launched = _launches(dtype)["forward"]
    codec = _codec_counts()
    fused = batcher.peek_batcher()
    stats = dict(fused.stats) if fused else None
    statuses = [r[0] if r else None for r in results]
    if any(status != 200 for status in statuses):
        raise AssertionError(f"{label} ({mode}): statuses {statuses}, first failure "
                             f"{next(r[1][:300] for r in results if r[0] != 200)}")
    outputs = [_columns(json.loads(r[1])["data"]["model-output"], TAGS) for r in results]
    if any(out.shape[0] != n_out or not np.isfinite(out).all() for out in outputs):
        raise AssertionError(f"{label} ({mode}): model-output not {n_out} finite rows")
    latencies = sorted(r[2] for r in results)
    run = {"mode": mode, "requests": len(requests), "wall_s": wall,
           "p50_ms": latencies[len(latencies) // 2], "max_ms": latencies[-1],
           "samples_per_s": len(requests) * n_out / wall, "forward_launches": launched,
           "codec": codec, "plain_attention_calls": plain.calls, "batcher": stats,
           "fused_calls": list(fused.calls) if fused else None,
           "self_ab": ({str(k.lookback_window): v for k, v in fused.calibrations.items()}
                       if fused else None)}
    print(f"{label}, GORDO_TPU_SERVING_BATCH={mode} on {card} ({dtype}): {len(requests)} "
          f"requests from {users} users in {wall:.3f} s, per-call p50 {run['p50_ms']:.2f} ms "
          f"(max {run['max_ms']:.2f}), {run['samples_per_s']:.1f} samples/s; forward "
          f"launches {launched}; batcher {stats}; fuse widths and windows per fused call "
          f"{run['fused_calls']}; self-A/B {run['self_ab']}; codec {codec}", flush=True)
    if (codec["native_parses"] != len(requests) or codec["native_encodes"] != len(requests)
            or codec["parse_fallbacks"] or codec["encode_fallbacks"] or codec["poisonings"]):
        raise AssertionError(f"{label} ({mode}): a body or answer left the native codec")
    if plain.calls:
        raise AssertionError(f"{label} ({mode}): reached the plain attention")
    if mode == "0" and launched != n_blocks * len(requests):
        raise AssertionError(f"{label}: {launched} launches unbatched, not {n_blocks} a request")
    if mode == "1" and not (launched == n_blocks * stats["device_calls"]
                            and (stats["device_calls"] < len(requests) or not must_fuse)
                            and stats["items"] == len(requests)):
        raise AssertionError(f"{label}: {launched} launches for {stats}")
    if stats and (stats["bisections"] or stats["serial_rescues"]):
        raise AssertionError(f"{label} ({mode}): the batcher bisected or rescued: {stats}")
    run["outputs"] = outputs
    return run


def _max_rel(got: list, ref: list) -> float:
    return max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(got, ref))


def _queued(fused, items: list) -> list:
    """Queue ``items`` (``(estimator, X)``) on the batcher ``fused`` before
    its dispatcher starts, so that the first drain takes them in order and
    the fused calls are known; wait for every result. Returns the results."""
    from gordo_tpu_torch.ops.predict import pad_for_predict
    from gordo_tpu_torch.server import batcher

    queued = []
    for est, X in items:
        X_pad, n_pad, n_keep = pad_for_predict(est.spec_, X)
        item = batcher._Item(est.spec_, est.module_, X_pad, n_pad, n_keep,
                             batcher._device_of(est.module_))
        fused._ring.put(item)
        queued.append(item)
    fused._ensure_thread()
    for item in queued:
        if not item.done.wait(timeout=300):
            raise AssertionError("a queued batcher item was not answered")
        if item.error is not None:
            raise item.error
    fused.close()
    return [item.result for item in queued]


def pipeline_check(card: str, estimators: list, n_blocks: int, dtype: str, rng) -> dict:
    """PIPELINE_ITEMS requests of BATCHER_ROWS rows queued at once into a
    batcher fusing PIPELINE_FUSE a call, with ``GORDO_TPU_DEVICE_PIPELINE``
    0 and then 1: the same fused calls, and the outputs must be the same
    bytes; the pipelined run must have overlapped calls, and each run
    launches the forward once per block a fused call."""
    from gordo_tpu_torch.server import batcher

    items = [(estimators[i % len(estimators)],
              _series(BATCHER_ROWS, 50000 + 700 * i, rng).astype(np.float32))
             for i in range(PIPELINE_ITEMS)]
    outs, stats = {}, {}
    for flag in ("0", "1"):
        os.environ["GORDO_TPU_DEVICE_PIPELINE"] = flag
        fused = batcher.CrossModelBatcher(max_batch=PIPELINE_FUSE)
        _reset_launches()
        with _PlainAttentionCalls() as plain:
            outs[flag] = _queued(fused, items)
        stats[flag] = {**fused.stats, "launches": _launches(dtype)["forward"],
                       "calls": list(fused.calls), "plain": plain.calls}
    same = all(np.array_equal(a, b) for a, b in zip(outs["0"], outs["1"]))
    print(f"pipeline check on {card} ({dtype}): {PIPELINE_ITEMS} requests, {PIPELINE_FUSE} a "
          f"fused call; GORDO_TPU_DEVICE_PIPELINE=0 {stats['0']}; =1 {stats['1']}; outputs "
          f"identical: {same}", flush=True)
    for flag, st in stats.items():
        if st["launches"] != n_blocks * st["device_calls"] or st["plain"] or (
                st["bisections"] or st["serial_rescues"]):
            raise AssertionError(f"pipeline {flag}: {st}")
    if not same or stats["1"]["pipeline_overlaps"] < 1 or stats["0"]["calls"] != stats["1"]["calls"]:
        raise AssertionError("the pipelined batcher's outputs or calls differ from the serial")
    return stats


def fused_memory(card: str, estimators: list, dtype: str, rng, tol: float) -> dict:
    """Peak device memory of one direct FULL_ROWS-row predict and of one
    fused call of every model's FULL_ROWS-row request (queued at once: one
    call of BATCHER_MODELS x 1,024 windows), each above what was allocated
    before it, per window; the fused lanes against the direct predicts."""
    import torch

    from gordo_tpu_torch.server import batcher

    items = [(est, _series(FULL_ROWS, 70000 + 2000 * m, rng).astype(np.float32))
             for m, est in enumerate(estimators)]
    torch.cuda.synchronize()
    direct = []
    for i, (est, X) in enumerate(items):
        if i == 0:
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        direct.append(est.predict(X))
        if i == 0:
            direct_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    windows = direct[0].shape[0]
    fused = batcher.CrossModelBatcher()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lanes = _queued(fused, items)
    seconds = time.perf_counter() - t0
    fused_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    calls = list(fused.calls)
    err = _max_rel(lanes, direct)
    out = {"direct_gib": direct_gib, "direct_windows": windows,
           "direct_mib_per_window": direct_gib * 1024 / windows, "fused_gib": fused_gib,
           "fused_calls": calls, "fused_mib_per_window": fused_gib * 1024 / calls[0][1],
           "fused_s": seconds, "fused_vs_direct_max_rel": err}
    print(f"fused memory on {card} ({dtype}): one direct {FULL_ROWS}-row predict "
          f"({windows} windows) peaks {direct_gib:.3f} GiB above its start "
          f"({out['direct_mib_per_window']:.3f} MiB a window); one fused call (width, "
          f"windows) {calls} peaks {fused_gib:.3f} GiB ({out['fused_mib_per_window']:.3f} MiB "
          f"a window) in {seconds:.3f} s; fused lanes vs direct max rel err {err:.3e}",
          flush=True)
    if len(calls) != 1 or not err <= tol:
        raise AssertionError(f"the full-width fused call: {calls}, max rel err {err}")
    return out


def codec_stages(card: str, entry, body: bytes, dict_body: bytes, reps: int = 3) -> dict:
    """The codec's stages for one FULL_ROWS-row anomaly request, in-process,
    medians over ``reps``: the native one-pass parse against ``json`` and
    ``decode_frame``, and the native template encode against ``json.dumps``
    of ``to_dict()``, on the rectangular body and on the time-indexed
    column-dict body (whose column-dict ``y`` the native grammar leaves to
    ``json``)."""
    from gordo_tpu_torch.server import fast_codec, views

    def median_ms(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            result = fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return sorted(times)[reps // 2], result

    out = {}
    for label, raw_body in (("rect", body), ("column_dict", dict_body)):
        native_ms, parsed = median_ms(lambda: fast_codec.decode_body_xy(raw_body))
        parse_ms, payload = median_ms(lambda: json.loads(raw_body))
        decode_ms, (X, y) = median_ms(
            lambda: views.extract_X_y(payload, entry.tags, entry.target_tags))
        raw = entry.detector.anomaly_raw(X, y, frequency=entry.frequency)
        dict_ms, expected = median_ms(lambda: json.dumps(raw.to_dict()))
        encode_ms, fragment = median_ms(lambda: fast_codec.encode_raw(raw))
        out[label] = {"native_parse_ms": native_ms if parsed is not None else None,
                      "json_parse_ms": parse_ms, "decode_frame_ms": decode_ms,
                      "native_encode_ms": encode_ms, "dict_encode_ms": dict_ms,
                      "body_bytes": len(raw_body), "answer_bytes": len(expected)}
        print(f"codec stages on {card}, one {FULL_ROWS}-row {label} request "
              f"({len(raw_body)} bytes in, {len(expected)} out): native parse "
              f"{'%.3f ms' % native_ms if parsed is not None else 'not taken (y as a column dict)'}"
              f"; json parse {parse_ms:.3f} ms + decode_frame {decode_ms:.3f} ms; native encode "
              f"{encode_ms:.3f} ms; json.dumps of to_dict() {dict_ms:.3f} ms", flush=True)
        if fragment != expected:
            raise AssertionError(f"the native encode of the {label} answer differs")
        if label == "rect" and parsed is None:
            raise AssertionError("the native parser refused the rectangular body")
    return out


def fused_forward_times(card: str, bh: int, dtype: str) -> dict:
    """The forward kernel of ``dtype`` at the fused call's (bh, 512, 64),
    causal: held against its plain twin (in 8 slices of BH), and timed
    beside the twin, its bound and ``scaled_dot_product_attention``."""
    import torch

    from gordo_tpu_torch.ops import flash_attention as fa

    shape = (bh, CONFIG["lookback_window"], CONFIG["d_model"] // CONFIG["num_heads"])
    torch_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    q, k, v = (torch.randn(shape, device="cuda", generator=g).to(torch_dtype) for _ in range(3))
    out, lse = fa.flash_attention_forward(q, k, v, True)
    ref_out, ref_lse = _plain_in_parts(fa.flash_attention_forward_plain, (q, k, v), True, 8)
    if dtype == "bfloat16":
        within, share, max_abs = _bf16_gate(out, ref_out)
        ok = within and share <= TOL_BF16_SHARE
        errors = {"within_one_ulp": within, "share_differing": share, "max_abs_err": max_abs}
    else:
        max_abs = (out - ref_out).abs().max().item()
        rel = max_abs / ref_out.abs().max().item()
        ok = rel <= TOL_OUT_REL and (lse - ref_lse).abs().max().item() <= TOL_LSE_ABS
        errors = {"max_rel_err": rel, "max_abs_err": max_abs}
    del out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    ms = _time_ms(lambda: fa.flash_attention_forward(q, k, v, True), 5)
    plain_ms = _time_ms(lambda: _plain_in_parts(fa.flash_attention_forward_plain,
                                                (q, k, v), True, 8), 1)
    # given as 3-D tensors SDPA would hold (BH, T, T) float32 scores: 32 GiB
    library = _sdpa_ms(q, k, v, 5, three_d=False)
    bound = _flash_bound_ms(*shape, causal=True, flop_per_pair=FLOP_PER_PAIR[dtype]["forward"],
                            bytes_per_element=q.element_size(), dtype=dtype)
    del q, k, v
    torch.cuda.empty_cache()
    timed = {"shape": list(shape), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
             "bound_by": bound["bound_by"], **library, "against_plain": errors}
    print(f"flash_attention_forward ({dtype}) at the fused call's {shape} causal on {card}: "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}), scaled_dot_product_attention {library['library_ms']:.4f} ms "
          f"(given 3-D tensors: not measured, its scores need {shape[0] * shape[1] ** 2 * 4 / 2**30:.0f} "
          f"GiB); against plain {errors}", flush=True)
    if not ok:
        raise AssertionError(f"the {dtype} forward disagrees with its twin at {shape}")
    return timed


def batcher_path(card: str, root: Path, device: str = "cuda", **estimator) -> dict:
    """The JAX package's default serving path on the card: BATCHER_MODELS
    transformer-ae-512 artifacts (``estimator`` added to their arguments,
    each its own seeded weights) served by the port's server, and
    BATCHER_USERS threads each POSTing BATCHER_REQUESTS anomaly requests of
    BATCHER_ROWS rows, round robin over the models, with
    ``GORDO_TPU_SERVING_BATCH`` 0, then 1, then auto (:func:`_served_run`
    checks each run); the batched answers within the dtype's served-output
    tolerance of the unbatched; then one FULL_ROWS-row request per model, all
    at once, unbatched and batched; the codec's stages; the pipeline check;
    the fused call's memory; and the forward kernel at the fused call's BH.
    Returns the numbers and the forward launches of the batched run."""
    import torch

    from gordo_tpu_torch.models.spec import TransformerBlock
    from gordo_tpu_torch.server import batcher
    from gordo_tpu_torch.server.server import make_server

    started = time.perf_counter()
    collection = root / "1"
    names = [f"batcher-m{m}" for m in range(BATCHER_MODELS)]
    for m, name in enumerate(names):
        spec = write_artifact(collection, device, name=name, seed=SEED + 100 + m, **estimator)[0]
    dtype = spec.compute_dtype
    n_blocks = sum(isinstance(layer, TransformerBlock) for layer in spec.layers)
    heads = next(layer.num_heads for layer in spec.layers if isinstance(layer, TransformerBlock))
    tol = TOL_BF16_MODEL_REL if dtype == "bfloat16" else TOL_OUT_REL
    rng = np.random.RandomState(SEED + 9)
    traffic = [(names[(u + r) % BATCHER_MODELS],
                _rect_body(_series(BATCHER_ROWS, 20000 + 700 * (r * BATCHER_USERS + u), rng)))
               for r in range(BATCHER_REQUESTS) for u in range(BATCHER_USERS)]
    full = [(name, _rect_body(_series(FULL_ROWS, 90000 + 2000 * m, rng)))
            for m, name in enumerate(names)]
    n_out = BATCHER_ROWS - spec.lookback_window + 1
    n_full = FULL_ROWS - spec.lookback_window + 1
    knobs = ("GORDO_TPU_SERVING_BATCH", "GORDO_TPU_DEVICE_PIPELINE",
             "GORDO_TPU_BATCH_AB_ROUNDS")
    previous = {knob: os.environ.get(knob) for knob in knobs}
    os.environ["GORDO_TPU_BATCH_AB_ROUNDS"] = str(AB_ROUNDS)
    server = make_server("127.0.0.1", 0, device=device, collection_dir=str(collection))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    project = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/smoke"
    try:
        runs = {mode: _served_run(card, project, traffic, BATCHER_USERS, mode, dtype, n_blocks,
                                  n_out, f"batcher traffic ({BATCHER_ROWS} rows)")
                for mode in ("0", "1", "auto")}
        full_runs = {mode: _served_run(card, project, full, len(full), mode, dtype, n_blocks,
                                       n_full, f"{len(full)} concurrent {FULL_ROWS}-row requests",
                                       must_fuse=False)
                     for mode in ("0", "1")}
        entries = server.models
        estimators = [entries[name].detector.base_estimator.steps[1][1] for name in names]
        os.environ["GORDO_TPU_SERVING_BATCH"] = "0"
        batcher.reset_batcher()
        stages = codec_stages(card, entries[names[0]], full[0][1], json.dumps(_payload(
            _series(FULL_ROWS, 90000, np.random.RandomState(SEED + 11)),
            datetime(2020, 1, 1, tzinfo=timezone.utc))).encode())
        pipeline = pipeline_check(card, estimators, n_blocks, dtype, rng)
        memory = fused_memory(card, estimators, dtype, rng, tol)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        batcher.reset_batcher()
        for knob, value in previous.items():
            if value is None:
                os.environ.pop(knob, None)
            else:
                os.environ[knob] = value
    errors = {mode: _max_rel(run["outputs"], runs["0"]["outputs"])
              for mode, run in runs.items() if mode != "0"}
    errors[f"full_{FULL_ROWS}"] = _max_rel(full_runs["1"]["outputs"], full_runs["0"]["outputs"])
    print(f"batched model-output vs unbatched ({dtype}, tolerance {tol:g}): max rel err "
          f"{errors}; auto decision {runs['auto']['self_ab']}; batched p50 "
          f"{runs['1']['p50_ms']:.2f} ms and {runs['1']['samples_per_s']:.1f} samples/s against "
          f"unbatched {runs['0']['p50_ms']:.2f} ms and {runs['0']['samples_per_s']:.1f}; "
          f"batcher phase {time.perf_counter() - started:.1f} s", flush=True)
    if not all(err <= tol for err in errors.values()):
        raise AssertionError(f"batched answers disagree with unbatched: {errors}")
    fused_bh = memory["fused_calls"][0][1] * heads
    forward = fused_forward_times(card, fused_bh, dtype)
    for run in [*runs.values(), *full_runs.values()]:
        del run["outputs"]
    return {"launches": runs["1"]["forward_launches"], "runs": runs, "full_runs": full_runs,
            "errors": errors, "codec_stages": stages, "pipeline": pipeline, "memory": memory,
            "fused_forward": forward, "seconds": time.perf_counter() - started}


# the fleet phase's machines: each its own tags, so that their data differ
FLEET_MACHINES = 8
FLEET_TAGS = [[f"m{m}-tag-{j}" for j in range(len(TAGS))] for m in range(FLEET_MACHINES)]
# one stacked training step's attention: machines x batch 32 x 4 heads (the
# fold predicts run at SERVE_SHAPE: 1,024 machine-windows x 4 heads)
FLEET_SHAPE = (FLEET_MACHINES * BATCH * 4, 512, 64)


def _plain_in_parts(fn, tensors, causal: bool, parts: int = 4, dtype=None) -> list:
    """``fn`` (a plain twin returning a tuple) over ``parts`` slices of BH,
    its results joined: a ``parts``-th of its score matrices alive at once;
    with ``dtype``, each slice cast to it first."""
    import torch

    pieces = [fn(*(x if dtype is None else x.to(dtype) for x in xs), causal)
              for xs in zip(*(x.chunk(parts) for x in tensors))]
    return [torch.cat(outs) for outs in zip(*pieces)]


def twin_gates(q, k, v, do, o, lse, causal: bool = True) -> dict:
    """The forward, dQ and dK/dV of one dtype held against their plain twins
    on the same inputs (``o`` and ``lse`` from the forward kernel, as
    training has them), the backward launched twice for bit-identical
    results, the twins run over slices of at most 256 of BH: float32 at
    TOL_OUT_REL, TOL_LSE_ABS and TOL_GRAD_REL (absolute below 1); bf16 by
    ``_bf16_gate``: every element within one ulp of the twin run in
    float64 and rounded to bf16 (the elements that float64 makes exactly 0
    held near 0), at most TOL_BF16_SHARE differing from it and from the
    float32 twin, and lse at TOL_BF16_LSE_REL. The float32 twin is no
    judge of one ulp near 0: its own error there is of the order of the
    gate's 1e-6 (one bf16 dK element at (1024, 512, 256), within one ulp of
    float64, is not within one ulp of the float32 twin). Raises on a miss;
    returns ``{kernel: errors}``."""
    import torch

    from gordo_tpu_torch.ops import flash_attention as fa

    bf16 = q.dtype == torch.bfloat16
    inputs = (q, k, v, o, lse, do)
    parts = max(1, q.shape[0] // 256)
    where = f"{'bf16' if bf16 else 'float32'} {tuple(q.shape)} causal {causal}"
    out, lse_k = fa.flash_attention_forward(q, k, v, causal)
    runs = [(fa.launch_dq(*inputs, causal), *fa.launch_dkv(*inputs, causal)) for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f"{where}: the backward differs between two launches")
    got = {"out": out, **dict(zip(("dq", "dk", "dv"), runs[0]))}
    del runs
    ref_out, ref_lse = _plain_in_parts(fa.flash_attention_forward_plain, (q, k, v), causal,
                                       parts)
    refs = dict(zip(("dq", "dk", "dv"),
                    _plain_in_parts(fa.flash_attention_backward_plain, inputs, causal, parts)))
    refs["out"] = ref_out
    errors = {}
    if bf16:
        exact = dict(zip(("dq", "dk", "dv"), _plain_in_parts(
            fa.flash_attention_backward_plain, inputs, causal, parts, torch.float64)))
        exact["out"] = _plain_in_parts(fa.flash_attention_forward_plain, (q, k, v), causal,
                                       parts, torch.float64)[0]
        lse_err = ((lse_k - ref_lse).abs() / ref_lse.abs().clamp_min(1.0)).max().item()
        ok = lse_err <= TOL_BF16_LSE_REL
        for name in ("out", "dq", "dk", "dv"):
            within, share_f64, max_abs_f64 = _bf16_gate(got[name], exact[name].bfloat16(),
                                                        exact[name])
            within_twin, share, max_abs = _bf16_gate(got[name], refs[name], exact[name])
            errors[name] = {"within_one_ulp": within, "share_differing": share,
                            "max_abs_err": max_abs, "f64_share_differing": share_f64,
                            "f64_max_abs_err": max_abs_f64,
                            "within_one_ulp_of_float32_twin": within_twin}
            ok = ok and within and max(share, share_f64) <= TOL_BF16_SHARE
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
    if not ok:
        raise AssertionError(f"{where}: a kernel disagrees with its plain twin: {errors}")
    return errors


def fleet_kernel_times(card: str) -> dict:
    """The six kernels at FLEET_SHAPE, causal: each held against its plain
    twin there (:func:`twin_gates`), and its time beside its bound,
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
        errors = twin_gates(q, k, v, do, o, lse)
        print(f"{name} kernels at the fleet's {FLEET_SHAPE} causal against their plain twins: "
              f"{errors}; backward bit-identical on a rerun", flush=True)
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
    largest entry. An MoE spec's routing is compared first
    (:func:`routing_gate`): the windows a rounding flip taints are left out
    of the outputs compared and weighted 0 in both losses."""
    import torch

    from gordo_tpu_torch.ops import nn, train

    stacked = nn.StackedTransformerModel(spec, nn.stack_params(params), torch.device(device))
    serials = [nn.TransformerModel(spec, p, torch.device(device)) for p in params]
    xb, yb = train._gather_batch(spec, X, X, orders[:, :BATCH].to(device))
    wb = torch.ones(len(params), BATCH, device=device)
    with torch.no_grad():
        stacked_out, stacked_routing = stacked.forward_with_routing(xb)
        runs = [model.forward_with_routing(xb[m]) for m, model in enumerate(serials)]
    clean = []
    for m, (_, routing) in enumerate(runs):
        tainted = np.zeros(BATCH, bool)
        if routing:
            tainted, report = routing_gate(_routing_numpy(routing),
                                           _routing_numpy(stacked_routing, m),
                                           spec.lookback_window, MOE_FLIP_GAP[spec.compute_dtype])
            print(f"machine {m} stacked vs serial routing ({spec.compute_dtype}): {report}",
                  flush=True)
        wb[m, torch.from_numpy(tainted).to(device)] = 0.0
        clean.append(torch.from_numpy(~tainted).to(device))
    stacked_grads = torch.autograd.grad(train._loss_terms(spec, stacked, xb, yb, wb).sum(),
                                        list(stacked.parameters()))
    out_diff = grad_diff = 0.0
    for m, model in enumerate(serials):
        ref = runs[m][0]
        out_diff = max(out_diff, ((stacked_out[m] - ref)[clean[m]].abs().max()
                                  / ref.abs().max()).item())
        grads = torch.autograd.grad(train._loss_terms(spec, model, xb[m], yb[m], wb[m]),
                                    list(model.parameters()))
        for (name, _), got, want in zip(model.named_parameters(), stacked_grads, grads):
            if not name.endswith(".bk"):
                grad_diff = max(grad_diff, ((got[m] - want).abs().max()
                                            / want.abs().max()).item())
    return out_diff, grad_diff


def fleet_loss_check(card: str, device: str = "cuda", config: dict = None) -> dict:
    """A two-machine bucket of ``config`` (``CONFIG`` by default) against
    the serial trainer given the same initial parameters and orders. The
    gate that tells a stacking fault (a wrong machine slice, a wrong loss
    sum) from rounding: one batch's output and parameter gradients, stacked
    against serial, within
    TOL_GRAD_REL in float32 and TOL_BF16_MODEL_REL in bf16. Then LOSS_STEPS
    float32 step losses per machine within TOL_LOSS_REL of the serial
    trainer's, printed beside how far the serial trainer drifts from
    parameters one float32 ulp up. Returns the differences."""
    import torch

    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.models.scaler import MinMaxScaler
    from gordo_tpu_torch.ops import nn, train

    config = CONFIG if config is None else config
    spec = TransformerAutoEncoder(**config).build_spec(len(TAGS), len(TAGS))
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
        dtype_spec = TransformerAutoEncoder(**config, compute_dtype=dtype).build_spec(
            len(TAGS), len(TAGS))
        out_diff, grad_diff = _one_batch_diffs(dtype_spec, params, X, orders, device)
        print(f"two-machine bucket (d_model {config['d_model']}) vs the serial model "
              f"({dtype}), one batch: output max rel "
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


# ---------------------------------------------------- the feedforward family
# examples/config.yaml's two feedforward machines as written there, in JSON
# (the card's machine has no yaml; tests/test_torch_kfcv.py holds this copy
# equal to the file)
_EXAMPLE_DATASET = {"train_start_date": "2019-01-01T00:00:00+00:00",
                    "train_end_date": "2019-01-08T00:00:00+00:00",
                    "data_provider": {"type": "RandomDataProvider"}}


def _example_model(detector: str, epochs: int, **arguments) -> dict:
    return {f"gordo_tpu.models.anomaly.diff.{detector}": {
        "require_thresholds": True, **arguments,
        "base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler",
            {"gordo_tpu.models.models.AutoEncoder": {"kind": "feedforward_hourglass",
                                                     "epochs": epochs}}]}}}}


EXAMPLE_MACHINES = [
    {"name": "pump-station-a",
     "dataset": {"tags": ["pump-a-pressure", "pump-a-temperature", "pump-a-flow",
                          "pump-a-vibration"], **_EXAMPLE_DATASET},
     "model": _example_model("DiffBasedAnomalyDetector", 5)},
    {"name": "turbine-c",
     "dataset": {"tags": ["turb-c-speed", "turb-c-torque", "turb-c-temperature"],
                 **_EXAMPLE_DATASET},
     "model": _example_model("DiffBasedKFCVAnomalyDetector", 3, window=144),
     "evaluation": {"cv": {"sklearn.model_selection.KFold": {
         "n_splits": 5, "shuffle": True, "random_state": 0}}}},
]
# examples/config.yaml's LSTM machine as written: an LSTMAutoEncoder
# (lstm_hourglass, lookback 24, 3 epochs, the estimator's batch size of 1)
LSTM_EXAMPLE_MACHINE = {
    "name": "compressor-b",
    "dataset": {"tags": ["comp-b-pressure", "comp-b-temperature", "comp-b-rpm",
                         "comp-b-power"], **_EXAMPLE_DATASET},
    "model": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {
        "require_thresholds": True,
        "base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler",
            {"gordo_tpu.models.models.LSTMAutoEncoder": {
                "kind": "lstm_hourglass", "lookback_window": 24, "epochs": 3}}]}}}},
}
EXAMPLE_ROWS = 1008  # 7 days of 10-minute rows
TOL_FF = 1e-5  # a served feedforward answer against its direct predict; a stacked batch
BENCH_ROWS = 100  # bench.py's anomaly request: 100 samples of the machine's tags
BENCH_ROUNDS = 100  # bench.py's sequential requests (BENCH_SERVER_ROUNDS)
FF_USERS = 16
FF_REQUESTS = 48  # concurrent feedforward requests across the two models
FF_FLEET_MACHINES = 1024  # bench.py's fleet (BENCH_MACHINES)


def _kfold_reference(n: int, n_splits: int, seed: int) -> list:
    """sklearn's shuffled KFold test rows, written out plainly: the indices
    permuted by ``np.random.RandomState(seed).shuffle``, cut into folds
    (the first ``n % n_splits`` one longer), each fold's rows ascending."""
    indices = np.arange(n)
    np.random.RandomState(seed).shuffle(indices)
    sizes = [n // n_splits + (k < n % n_splits) for k in range(n_splits)]
    bounds = np.cumsum([0] + sizes)
    return [np.sort(indices[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


def _row_label(row: int) -> str:
    start = datetime.fromisoformat(_EXAMPLE_DATASET["train_start_date"])
    return str(start + timedelta(minutes=10 * int(row)))


def _seeded_error(model, tags, n_rows: int, device: str) -> dict:
    """The scaled MSE of a built detector (``trained``) and of the same
    model with the seeded initial weights (``seeded``) on ``n_rows`` rows
    of the provider's signal past the training span (a windowed model's
    output against the last rows)."""
    import torch

    from gordo_tpu_torch.ops.nn import init_model_params

    held_out = _provider_continuation(EXAMPLE_ROWS, n_rows, np.random.RandomState(SEED + 12),
                                      tags)
    (_, input_scaler), (_, estimator) = model.base_estimator.steps
    seeded = type(estimator)(estimator.kind, **estimator.kwargs).load_params(
        estimator.spec_, init_model_params(estimator.spec_, torch.Generator().manual_seed(SEED)),
        device)
    truth = model.scaler.transform(held_out)
    return {name: float(np.mean(np.square(model.scaler.transform(pred) - truth[-len(pred):])))
            for name, pred in (("trained", model.base_estimator.predict(held_out)),
                               ("seeded", seeded.predict(input_scaler.transform(held_out))))}


def feedforward_build_path(card: str, root: Path, device: str = "cuda") -> dict:
    """``python -m gordo_tpu_torch build`` of examples/config.yaml's
    feedforward machines as written, the two builds at once in two
    processes on the card. Each must exit 0 with finite thresholds and a
    held-out error below its seeded weights'; the KFCV machine's folds must
    be sklearn's shuffled KFold(5, random_state=0) (its split metadata
    against :func:`_kfold_reference`), the hourglass machine's the three
    TimeSeriesSplit folds. Returns the seconds and the builds' phases."""
    from gordo_tpu_torch import serializer

    started = time.perf_counter()
    procs = {}
    for config in EXAMPLE_MACHINES:
        command = [sys.executable, "-m", "gordo_tpu_torch", "--log-level", "WARNING", "build",
                   json.dumps(config), str(root / config["name"]), "--print-cv-scores"]
        if device != "cuda":
            command += ["--device", device]
        procs[config["name"]] = subprocess.Popen(
            command, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "PYTHONPATH": str(REPO)})
    outputs = {name: proc.communicate(timeout=600) for name, proc in procs.items()}
    seconds = time.perf_counter() - started
    result = {"seconds": seconds, "machines": {}}
    for config in EXAMPLE_MACHINES:
        name, tags = config["name"], config["dataset"]["tags"]
        stdout, stderr = outputs[name]
        if procs[name].returncode != 0:
            print(stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"python -m gordo_tpu_torch build {name}: exit "
                                 f"{procs[name].returncode}")
        model = serializer.load(str(root / name), device)
        built = serializer.load_metadata(str(root / name))["metadata"]["build_metadata"]
        splits = built["model"]["cross_validation"]["splits"]
        mse = _seeded_error(model, tags, EXAMPLE_ROWS, device)
        thresholds = [float(x) for x in (*model.feature_thresholds_, model.aggregate_threshold_)]
        folds = 5 if name == "turbine-c" else 3
        entry = {"detector": type(model).__name__, "phases": built["phases"],
                 "offset": built["model"]["model_offset"], "held_out_mse": mse,
                 "aggregate_threshold": model.aggregate_threshold_,
                 "score_lines": sum("_fold-" in line for line in stdout.splitlines())}
        result["machines"][name] = entry
        print(f"feedforward build {name} ({entry['detector']}) on {card}: phases "
              f"{entry['phases']}, offset {entry['offset']}, held-out scaled MSE "
              f"{mse['trained']:.6f} (seeded {mse['seeded']:.6f}), thresholds {thresholds}, "
              f"{entry['score_lines']} CV score lines", flush=True)
        if not (mse["trained"] < mse["seeded"] and all(math.isfinite(x) for x in thresholds)
                and entry["offset"] == 0 and f"fold-{folds}-n-test" in splits
                and f"fold-{folds + 1}-n-test" not in splits):
            raise AssertionError(f"{name}: held-out error {mse}, thresholds {thresholds}, "
                                 f"offset {entry['offset']}, splits {sorted(splits)}")
        if name == "turbine-c":
            for k, test in enumerate(_kfold_reference(EXAMPLE_ROWS, 5, 0), start=1):
                want = {f"fold-{k}-n-test": len(test), f"fold-{k}-n-train": EXAMPLE_ROWS - len(test),
                        f"fold-{k}-test-start": _row_label(test[0]),
                        f"fold-{k}-test-end": _row_label(test[-1])}
                got = {key: splits[key] for key in want}
                if got != want:
                    raise AssertionError(f"turbine-c fold {k}: {got}, sklearn's KFold {want}")
    print(f"feedforward build path: two CLI builds at once in {seconds:.1f} s", flush=True)
    return result


def _bench_body(n_tags: int, seed: int, rows: int = BENCH_ROWS) -> bytes:
    """bench.py's anomaly request: ``rows`` samples of each tag in
    [0, 1), as X and as y, rectangular."""
    values = np.random.RandomState(seed).random_sample((rows, n_tags))
    return _rect_body(values)


def _direct(detector, X: np.ndarray) -> np.ndarray:
    """The detector's model output, predicted without the batcher."""
    from gordo_tpu_torch.ops.predict import predict_fn

    steps = detector.base_estimator.steps
    for _, step in steps[:-1]:
        X = step.transform(X)
    return predict_fn(steps[-1][1].module_)(X)


def _spec_label(spec) -> str:
    """A spec's family (by its sequence layers), window, lookahead and dtype,
    or the feedforward family's tags."""
    if spec.lookback_window <= 1 and spec.lookahead == 0:
        return f"feedforward {spec.n_features} tags"
    names = {type(layer).__name__ for layer in spec.layers}
    family = next((f for f, layer in (("transformer", "TransformerBlock"), ("lstm", "LSTMLayer"),
                                      ("tcn", "TCNBlock")) if layer in names), "dense")
    return (f"{family} lookback {spec.lookback_window} lookahead {spec.lookahead} "
            f"{spec.compute_dtype}")


def feedforward_served_path(card: str, root: Path, built: Path, device: str = "cuda") -> dict:
    """One collection served as ``run-server`` serves it (batching ``auto``):
    the two feedforward artifacts of :func:`feedforward_build_path` and a
    ``transformer-ae-512`` artifact. Single requests of bench.py's shape on
    both routes of both feedforward models, each model output within TOL_FF
    of the direct predict; BENCH_ROUNDS sequential anomaly requests a model
    (p50, p95, samples a second, Server-Timing's phases); what the auto
    A/B decided for each spec. Then, forced on, FF_USERS users sending
    FF_REQUESTS feedforward requests and BATCHER_MODELS 600-row
    Transformer requests at once: every answer 200 and within its
    tolerance of the direct predict, no fused call holding two specs (the
    batcher's counters), the Transformer requests launching the forward
    kernel once per block a fused call. Returns the numbers and launches."""
    from gordo_tpu_torch.models.spec import TransformerBlock
    from gordo_tpu_torch.server import batcher
    from gordo_tpu_torch.server.server import make_server

    collection = root / "served"
    shutil.rmtree(collection, ignore_errors=True)
    collection.mkdir(parents=True)
    for config in EXAMPLE_MACHINES:
        shutil.copytree(built / config["name"], collection / config["name"])
    spec, _, _ = write_artifact(collection, device)
    n_blocks = sum(isinstance(layer, TransformerBlock) for layer in spec.layers)
    previous = os.environ.get("GORDO_TPU_SERVING_BATCH")
    os.environ["GORDO_TPU_SERVING_BATCH"] = "auto"  # run-server's default
    batcher.reset_batcher()
    server = make_server("127.0.0.1", 0, device=device, collection_dir=str(collection))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    project = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/smoke"
    result = {"models": {}}
    try:
        for k, config in enumerate(EXAMPLE_MACHINES):
            name, tags = config["name"], config["dataset"]["tags"]
            body = _bench_body(len(tags), SEED + 20 + k)
            X = np.asarray(json.loads(body)["X"])
            for route in ("prediction", "anomaly/prediction"):
                req = urllib.request.Request(f"{project}/{name}/{route}", data=body,
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as resp:
                    status, answer = resp.status, json.loads(resp.read())
                out = _columns(answer["data"]["model-output"], tags)
                want = _direct(server.models[name].detector, X)
                diff = float(np.abs(out - want).max() / np.abs(want).max())
                print(f"feedforward served {name} POST {route}: {status}, {out.shape} output, "
                      f"max rel diff from the direct predict {diff:.3e} (gate {TOL_FF:g})",
                      flush=True)
                if status != 200 or out.shape != (BENCH_ROWS, len(tags)) or not diff <= TOL_FF:
                    raise AssertionError(f"{name} {route}: {status}, {out.shape}, {diff}")
            times, phases = [], {"decode_s": [], "predict_s": [], "encode_s": []}
            for _ in range(BENCH_ROUNDS):
                req = urllib.request.Request(f"{project}/{name}/anomaly/prediction", data=body,
                                             headers={"Content-Type": "application/json"})
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=300) as resp:
                    resp.read()
                    timing = resp.headers["Server-Timing"]
                times.append(time.perf_counter() - t0)
                for entry in timing.split(", "):
                    key, _, seconds = entry.partition(";dur=")
                    if key in phases:
                        phases[key].append(float(seconds))
            times.sort()
            numbers = {"p50_ms": 1e3 * times[len(times) // 2],
                       "p95_ms": 1e3 * times[int(len(times) * 0.95)],
                       "samples_per_s": BENCH_ROWS / (sum(times) / len(times)),
                       **{f"{key[:-2]}_p50_ms": 1e3 * sorted(v)[len(v) // 2]
                          for key, v in phases.items()}}
            result["models"][name] = numbers
            print(f"feedforward served {name}, {BENCH_ROUNDS} sequential {BENCH_ROWS} x "
                  f"{len(tags)} anomaly requests on {card}: {numbers}", flush=True)
        fused = batcher.peek_batcher()
        result["self_ab"] = {_spec_label(s): v for s, v in fused.calibrations.items()}
        print(f"the auto mode's A/B for the feedforward specs: {result['self_ab']}", flush=True)

        os.environ["GORDO_TPU_SERVING_BATCH"] = "1"
        batcher.reset_batcher()
        rng = np.random.RandomState(SEED + 30)
        requests, refs = [], []
        for i in range(FF_REQUESTS):
            config = EXAMPLE_MACHINES[i % 2]
            body = _bench_body(len(config["dataset"]["tags"]), SEED + 40 + i)
            requests.append((config["name"], body))
        for m in range(BATCHER_MODELS):
            values = _series(BATCHER_ROWS, 50000 + 700 * m, rng)
            requests.append(("transformer-ae-512", _rect_body(values)))
        _reset_launches()
        with _PlainAttentionCalls() as plain:
            results, wall = _drive(project, requests, FF_USERS)
        launches = _launches("float32")
        fused = batcher.peek_batcher()
        stats, spec_calls = dict(fused.stats), dict(fused.spec_calls)
        statuses = [r[0] if r else None for r in results]
        if any(status != 200 for status in statuses):
            raise AssertionError(f"concurrent mixed requests: statuses {statuses}")
        worst = {"feedforward": 0.0, "transformer": 0.0}
        for (name, body), (_, answer, _) in zip(requests, results):
            entry = server.models[name]
            out = _columns(json.loads(answer)["data"]["model-output"], entry.tags)
            want = _direct(entry.detector, np.asarray(json.loads(body)["X"]))
            family = "transformer" if name == "transformer-ae-512" else "feedforward"
            worst[family] = max(worst[family],
                                float(np.abs(out - want).max() / np.abs(want).max()))
        latencies = sorted(r[2] for r in results)
        n_ff_samples = FF_REQUESTS * BENCH_ROWS
        result["concurrent"] = {
            "requests": len(requests), "users": FF_USERS, "wall_s": wall,
            "p50_ms": latencies[len(latencies) // 2], "max_ms": latencies[-1],
            "feedforward_samples_per_s": n_ff_samples / wall, "batcher": stats,
            "fused_calls_by_spec": {_spec_label(s): n for s, n in spec_calls.items()},
            "max_rel_diff": worst, "launches": launches, "plain_attention_calls": plain.calls}
        print(f"concurrent mixed requests (batching forced on) on {card}: "
              f"{result['concurrent']}", flush=True)
        transformer_calls = spec_calls.get(spec, 0)
        if (stats["mixed_spec_calls"] or len(spec_calls) != 3
                or stats["items"] != len(requests) or stats["bisections"]
                or stats["serial_rescues"] or plain.calls):
            raise AssertionError(f"the mixed collection's fused calls: {stats}, {spec_calls}")
        if not (transformer_calls and launches["forward"] == n_blocks * transformer_calls):
            raise AssertionError(f"{launches} forward launches for {transformer_calls} fused "
                                 f"Transformer calls of {n_blocks} blocks")
        if not (worst["feedforward"] <= TOL_FF and worst["transformer"] <= TOL_MODEL_REL):
            raise AssertionError(f"fused answers off their direct predicts: {worst}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        batcher.reset_batcher()
        if previous is None:
            os.environ.pop("GORDO_TPU_SERVING_BATCH", None)
        else:
            os.environ["GORDO_TPU_SERVING_BATCH"] = previous
    result["forward"] = launches["forward"]
    return result


def bench_machine_config(name: str) -> dict:
    """bench.py's machine (``_machine_config``): a 4-tag hourglass
    autoencoder (5 epochs, batch 128) over MinMaxScaler in a
    DiffBasedAnomalyDetector, on 7 days of 10-minute RandomDataset rows,
    the default 3-fold TimeSeriesSplit CV with thresholds."""
    return {
        "name": name,
        "dataset": {"type": "RandomDataset", "tags": [f"{name}-tag-{j}" for j in range(4)],
                    "train_start_date": "2019-01-01T00:00:00+00:00",
                    "train_end_date": "2019-01-08T00:00:00+00:00"},
        "model": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {
            "require_thresholds": True,
            "base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
                "sklearn.preprocessing.MinMaxScaler",
                {"gordo_tpu.models.models.AutoEncoder": {
                    "kind": "feedforward_hourglass", "epochs": 5, "batch_size": 128}}]}}}},
    }


def feedforward_one_batch_check(card: str, device: str = "cuda") -> dict:
    """Two hourglass machines stacked against each machine's own model on
    the same parameters: one batch's output and parameter gradients (the
    l1 activity penalty in the loss) within TOL_FF."""
    import torch

    from gordo_tpu_torch.models.models import AutoEncoder
    from gordo_tpu_torch.ops import nn

    spec = AutoEncoder("feedforward_hourglass").build_spec(4, 4)
    rng = np.random.RandomState(SEED + 13)
    X = torch.as_tensor(rng.rand(2, 4 * BATCH, 4), dtype=torch.float32, device=device)
    params = [[{k: v.numpy() for k, v in p.items()}
               for p in nn.init_model_params(spec, torch.Generator().manual_seed(SEED + m))]
              for m in range(2)]
    orders = torch.stack([torch.randperm(4 * BATCH, generator=torch.Generator().manual_seed(m))
                          for m in range(2)])
    out_diff, grad_diff = _one_batch_diffs(spec, params, X, orders, device)
    print(f"two hourglass machines stacked vs serial, one batch on {card}: output max rel diff "
          f"{out_diff:.3e}, gradients {grad_diff:.3e} (gate {TOL_FF:g})", flush=True)
    if not (out_diff <= TOL_FF and grad_diff <= TOL_FF):
        raise AssertionError("the stacked hourglass batch disagrees with serial")
    return {"out": out_diff, "grad": grad_diff}


def feedforward_fleet_path(card: str, root: Path, device: str = "cuda") -> dict:
    """``batch-build`` (``cli.batch_build``, in this process so that the
    launches count) of one config: FF_FLEET_MACHINES of bench.py's hourglass
    machines and the FLEET_MACHINES ``transformer-ae-512`` machines of
    :func:`fleet_configs`. Gates: exit 0, every machine an artifact, every
    stacked program of one family (the buckets apart: the feedforward
    machines in their bucket's chunks, the Transformers in one), the
    Transformer bucket launching dQ and dK/dV once per block a stacked step,
    sampled artifacts finite; one stacked hourglass batch against serial
    (:func:`feedforward_one_batch_check`). Prints the machines a minute, the
    stacked programs' share, the peak device memory, and one serial build
    of a bench machine times FF_FLEET_MACHINES beside it."""
    import contextlib
    import io

    import torch

    from gordo_tpu_torch import cli, serializer
    from gordo_tpu_torch.builder import ModelBuilder
    from gordo_tpu_torch.machine import Machine
    from gordo_tpu_torch.models.anomaly.diff import TimeSeriesSplit
    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.models.spec import TransformerBlock
    from gordo_tpu_torch.ops.predict import n_train_samples
    from gordo_tpu_torch.parallel import batch_trainer as bt

    one_batch = feedforward_one_batch_check(card, device)
    names = [f"bench-ae-{i}" for i in range(FF_FLEET_MACHINES)]
    config = root / "mixed.json"
    config.write_text(json.dumps({"machines": [bench_machine_config(n) for n in names]
                                  + fleet_configs()}))
    output = root / "mixed"
    shutil.rmtree(output, ignore_errors=True)
    tf_spec = TransformerAutoEncoder(**CONFIG).build_spec(len(TAGS), len(TAGS))
    n_blocks = sum(isinstance(layer, TransformerBlock) for layer in tf_spec.layers)
    n_rows = _config_rows(fleet_configs()[0])
    steps = [math.ceil(n_train_samples(tf_spec, len(train_idx)) / BATCH)
             for train_idx, _ in TimeSeriesSplit(3).split(np.zeros(n_rows))]
    steps.append(math.ceil(n_train_samples(tf_spec, n_rows) / BATCH))
    programs = []  # (spec, machines, seconds) of each stacked program
    run_bucket = bt.run_bucket

    def timed_bucket(spec, X, *args, **kwargs):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_bucket(spec, X, *args, **kwargs)
        if device == "cuda":
            torch.cuda.synchronize()
        programs.append((spec, len(X), time.perf_counter() - t0))
        return out

    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    bt.run_bucket = timed_bucket
    stdout = io.StringIO()
    try:
        with _PlainAttentionCalls() as plain, contextlib.redirect_stdout(stdout):
            t0 = time.perf_counter()
            code = cli.batch_build(str(config), str(output), "smoke-fleet", device=device)
            seconds = time.perf_counter() - t0
    finally:
        bt.run_bucket = run_bucket
    launches = _launches("float32")
    peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else float("nan")
    built = [line for line in stdout.getvalue().splitlines() if line.startswith("built: ")]
    artifacts = sum((output / name / "model.json").exists()
                    for name in names + [c["name"] for c in fleet_configs()])
    families = {}
    for spec, machines, secs in programs:
        family = families.setdefault(_spec_label(spec), {"programs": 0, "machines": 0,
                                                         "seconds": 0.0, "spec": spec})
        family["programs"] += 1
        family["machines"] += machines
        family["seconds"] += secs
    # one serial build of a bench machine, for the serial build x N
    machine = Machine.from_config(bench_machine_config("bench-ae-serial"), "smoke-fleet")
    t0 = time.perf_counter()
    ModelBuilder(machine, device).build()
    serial_seconds = time.perf_counter() - t0
    n_all = FF_FLEET_MACHINES + FLEET_MACHINES
    result = {
        "machines": n_all, "feedforward_machines": FF_FLEET_MACHINES, "seconds": seconds,
        "machines_per_minute": 60.0 * n_all / seconds,
        "stacked_programs": {label: {k: v for k, v in f.items() if k != "spec"}
                             for label, f in families.items()},
        "peak_gib": peak, "serial_build_s": serial_seconds,
        "serial_build_x_feedforward_s": serial_seconds * FF_FLEET_MACHINES,
        "launches": launches, "one_batch": one_batch}
    print(f"mixed batch-build of {FF_FLEET_MACHINES} hourglass + {FLEET_MACHINES} "
          f"transformer-ae-512 machines on {card}: exit {code} in {seconds:.2f} s "
          f"({result['machines_per_minute']:.1f} machines a minute), {len(built)} built, "
          f"{artifacts} artifacts; stacked programs {result['stacked_programs']}; peak device "
          f"memory {peak:.2f} GiB; float32 launches {launches}; one serial hourglass build "
          f"{serial_seconds:.2f} s, x {FF_FLEET_MACHINES} = "
          f"{result['serial_build_x_feedforward_s']:.1f} s", flush=True)
    if code != 0 or len(built) != n_all or artifacts != n_all:
        raise AssertionError(f"batch-build exited {code}: {len(built)} built, {artifacts} "
                             f"artifacts of {n_all}")
    ff = families.get("feedforward 4 tags")
    tf = families.get(_spec_label(tf_spec))
    if not (len(families) == 2 and ff and tf and ff["machines"] == FF_FLEET_MACHINES
            and tf["machines"] == FLEET_MACHINES and tf["spec"] == tf_spec):
        raise AssertionError(f"the buckets did not stay apart: {result['stacked_programs']}")
    if plain.calls or not launches["dq"] == launches["dkv"] == n_blocks * sum(steps):
        raise AssertionError(f"expected {n_blocks * sum(steps)} dQ and dK/dV launches, got "
                             f"{launches}; plain attention {plain.calls}")
    for name in (names[0], names[-1], fleet_configs()[0]["name"]):
        model = serializer.load(str(output / name), device)
        thresholds = [*model.feature_thresholds_, model.aggregate_threshold_]
        if not all(math.isfinite(x) for x in thresholds):
            raise AssertionError(f"{name}: thresholds {thresholds}")
    return result


# ---------------------------------------------------------- the fast lanes
FAST_LANES = ("default", "thread", "loop")
LANE_REQUESTS = 2  # anomaly requests a user, BATCHER_ROWS rows, round robin
LANE_BENCH_MODEL = "pump-station-a"
_TIME_SECONDS = re.compile(rb'"time-seconds": "[0-9.]+"')


def _masked(body: bytes) -> bytes:
    """A response body with its one wall-clock value masked."""
    return _TIME_SECONDS.sub(b'"time-seconds": "T"', body)


def _model_output(body: bytes) -> np.ndarray:
    """The ``model-output`` block of an answer, (rows, tags)."""
    block = json.loads(body)["data"]["model-output"]
    return np.array([list(column.values()) for column in block.values()]).T


def lane_client(job: dict) -> dict:
    """The clients of one run, in a process of their own (standard library
    only): for each of the job's phases, ``users`` threads, user u sending
    requests u, u + users, ... one after another over one keep-alive
    ``http.client`` connection (or a new connection a request, with
    ``Connection: close``, where the phase's ``keep_alive`` is false).
    Returns each phase's ``[status, ms, body or None]`` a request and its
    wall seconds."""
    import base64
    import http.client

    out = {}
    for phase in job["phases"]:
        requests, users = phase["requests"], phase["users"]
        results = [None] * len(requests)
        headers = {"Content-Type": "application/json"}
        if not phase["keep_alive"]:
            headers["Connection"] = "close"

        def user(u, phase=phase, requests=requests, results=results, users=users):
            conn = None
            for i in range(u, len(requests), users):
                path, body = requests[i]
                if conn is None:
                    conn = http.client.HTTPConnection("127.0.0.1", job["port"], timeout=300)
                t0 = time.perf_counter()
                try:
                    conn.request("POST", path, body.encode(), headers)
                    resp = conn.getresponse()
                    status, data = resp.status, resp.read()
                except OSError as err:  # no answer at all
                    status, data = None, repr(err).encode()
                    conn.close()
                    conn = None
                keep = phase["bodies"] is True or i < phase["bodies"]
                results[i] = [status, 1e3 * (time.perf_counter() - t0),
                              base64.b64encode(data).decode() if keep or status != 200 else None]
                if conn is not None and (not phase["keep_alive"] or resp.will_close):
                    conn.close()
                    conn = None
            if conn is not None:
                conn.close()

        threads = [threading.Thread(target=user, args=(u,)) for u in range(users)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        out[phase["name"]] = {"results": results, "wall_s": time.perf_counter() - t0}
    return out


def _run_clients(job: dict, root: Path) -> dict:
    """:func:`lane_client` of ``job`` in a child process; its results, with
    the bodies decoded."""
    import base64

    job_file, out_file = root / "client_job.json", root / "client_out.json"
    job_file.write_text(json.dumps(job))
    code = ("import json, sys, chip_smoke; json.dump(chip_smoke.lane_client("
            "json.load(open(sys.argv[1]))), open(sys.argv[2], 'w'))")
    proc = subprocess.run([sys.executable, "-c", code, str(job_file), str(out_file)], cwd=REPO,
                          capture_output=True, text=True, timeout=900,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    if proc.returncode != 0:
        raise AssertionError(f"the client process exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    out = json.loads(out_file.read_text())
    for phase in out.values():
        for result in phase["results"]:
            if result[2] is not None:
                result[2] = base64.b64decode(result[2])
    return out


class _Lane:
    """One front end of ``collection`` in a thread: ``default`` (the
    server's own HTTP/1.1 handler), ``thread`` (the fast lane, a thread a
    connection) or ``loop`` (the fast lane's event loop)."""

    def __init__(self, kind: str, collection: Path, device: str):
        from gordo_tpu_torch.server import fastlane
        from gordo_tpu_torch.server.server import make_server

        if kind == "default":
            self.app = self.server = make_server("127.0.0.1", 0, device=device,
                                                 collection_dir=str(collection))
            self.port = self.server.server_address[1]
        else:
            self.app = make_server("127.0.0.1", 0, device=device, collection_dir=str(collection),
                                   bind_and_activate=False)
            cls = fastlane.EventLoopServer if kind == "loop" else fastlane.FastLaneServer
            self.server = cls(self.app, host="127.0.0.1", port=0, uds="")
            self.port = self.server.server_port
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        if self.app is not self.server:
            self.app.server_close()
        self.thread.join(timeout=60)


def fastlane_path(card: str, root: Path, transformers: Path, built: Path,
                  device: str = "cuda") -> dict:
    """The BATCHER_MODELS float32 ``transformer-ae-512`` artifacts of
    :func:`batcher_path` (``transformers``) and ``pump-station-a`` (``built``)
    served by the default lane, then the fast lane's thread lane, then its
    event loop, each with batching forced on and then ``auto``; the clients
    in a child process (:func:`lane_client`). A run: BATCHER_USERS users on
    keep-alive connections, each sending LANE_REQUESTS anomaly requests of
    BATCHER_ROWS rows round robin over the Transformers, after a warm-up
    request to each model (its load, and auto's A/B); one request a
    Transformer, sequentially; BENCH_ROUNDS sequential bench requests
    (BENCH_ROWS x 4 rows) to ``pump-station-a`` over one connection, then
    over a new connection each. Gates: every answer 200; the sequential
    answers (each alone in its fused call, on every lane) byte-identical to
    the default lane's, the wall clock masked; the concurrent ones, whose
    fused calls differ by lane, within TOL_MODEL_REL of the default lane's;
    fewer connections accepted than requests, on the server's count; no
    plain attention; forced on, the forward launched once per block a fused
    Transformer call, with fewer fused calls than requests on the default
    and thread lanes, and on the event loop one fused call a request (fuse
    width 1). Returns the numbers; ``forward`` is the forced runs' forward
    launches."""
    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.models.spec import TransformerBlock
    from gordo_tpu_torch.server import batcher

    collection = root / "lanes" / "1"
    shutil.rmtree(collection.parent, ignore_errors=True)
    shutil.copytree(transformers, collection)
    shutil.copytree(built / LANE_BENCH_MODEL, collection / LANE_BENCH_MODEL)
    names = sorted(p.name for p in transformers.iterdir())
    spec = TransformerAutoEncoder(**CONFIG).build_spec(len(TAGS), len(TAGS))
    n_blocks = sum(isinstance(layer, TransformerBlock) for layer in spec.layers)
    n_out = BATCHER_ROWS - spec.lookback_window + 1
    rng = np.random.RandomState(SEED + 50)
    anomaly = "/gordo/v0/smoke/{}/anomaly/prediction"
    concurrent = [[anomaly.format(names[(u + r) % len(names)]),
                   _rect_body(_series(BATCHER_ROWS, 30000 + 700 * (r * BATCHER_USERS + u), rng))
                   .decode()]
                  for r in range(LANE_REQUESTS) for u in range(BATCHER_USERS)]
    sequential = [[anomaly.format(name),
                   _rect_body(_series(BATCHER_ROWS, 60000 + 700 * m, rng)).decode()]
                  for m, name in enumerate(names)]
    bench = [anomaly.format(LANE_BENCH_MODEL), _bench_body(4, SEED + 60).decode()]
    # the warm-up loads each model on the lane's server and runs auto's A/B
    warm = [[anomaly.format(name), sequential[0][1]] for name in names] + [bench]
    job = {"phases": [
        {"name": "warm", "requests": warm, "users": 1, "keep_alive": True, "bodies": 0},
        {"name": "concurrent", "requests": concurrent, "users": BATCHER_USERS,
         "keep_alive": True, "bodies": True},
        {"name": "sequential", "requests": sequential, "users": 1, "keep_alive": True,
         "bodies": True},
        {"name": "bench_keep_alive", "requests": [bench] * BENCH_ROUNDS, "users": 1,
         "keep_alive": True, "bodies": 3},
        {"name": "bench_new_connection", "requests": [bench] * BENCH_ROUNDS, "users": 1,
         "keep_alive": False, "bodies": 3}]}
    n_requests = sum(len(p["requests"]) for p in job["phases"])
    knobs = ("GORDO_TPU_SERVING_BATCH", "GORDO_TPU_BATCH_AB_ROUNDS")
    previous = {knob: os.environ.get(knob) for knob in knobs}
    os.environ["GORDO_TPU_BATCH_AB_ROUNDS"] = str(AB_ROUNDS)
    runs, reference = {}, {}
    try:
        for kind in FAST_LANES:
            for mode in ("1", "auto"):
                os.environ["GORDO_TPU_SERVING_BATCH"] = mode
                batcher.reset_batcher()
                lane = _Lane(kind, collection, device)
                try:
                    job["port"] = lane.port
                    _reset_launches()
                    with _PlainAttentionCalls() as plain:
                        out = _run_clients(job, root)
                    launches = _launches("float32")["forward"]
                    accepted = lane.server.accepted
                    openapi = _request(f"http://127.0.0.1:{lane.port}/gordo/v0/openapi.json")
                finally:
                    lane.close()
                fused = batcher.peek_batcher()
                stats = dict(fused.stats) if fused else {}
                tf_calls = fused.spec_calls.get(spec, 0) if fused else 0
                widths = sorted({n for n, _ in fused.calls}) if fused else []
                batcher.reset_batcher()
                label = f"{kind} lane, GORDO_TPU_SERVING_BATCH={mode}"
                statuses = [r[0] for p in out.values() for r in p["results"]]
                if any(status != 200 for status in statuses):
                    bad = next(r for p in out.values() for r in p["results"] if r[0] != 200)
                    raise AssertionError(f"{label}: statuses {statuses}, first failure {bad}")
                ms = sorted(r[1] for r in out["concurrent"]["results"])
                bench_ms = {key: sorted(r[1] for r in out[key]["results"])
                            for key in ("bench_keep_alive", "bench_new_connection")}
                run = {
                    "p50_ms": ms[len(ms) // 2], "p99_ms": ms[int(0.99 * len(ms))],
                    "windows_per_s": len(concurrent) * n_out / out["concurrent"]["wall_s"],
                    "bench": {key: {"p50_ms": v[len(v) // 2], "p95_ms": v[int(0.95 * len(v))]}
                              for key, v in bench_ms.items()},
                    "accepted": accepted, "requests": n_requests,
                    "forward_launches": launches, "transformer_fused_calls": tf_calls,
                    "fuse_widths": widths, "batcher": stats,
                    "self_ab": ({_spec_label(s): v for s, v in fused.calibrations.items()}
                                if fused else None),
                    "plain_attention_calls": plain.calls,
                    "openapi": {"status": openapi[0],
                                "paths": len(json.loads(openapi[1])["paths"])}}
                bodies = [_masked(r[2]) for key in ("sequential", "bench_keep_alive",
                                                    "bench_new_connection")
                          for r in out[key]["results"] if r[2] is not None]
                outputs = [_model_output(r[2]) for key in ("concurrent", "sequential")
                           for r in out[key]["results"]]
                if kind == "default":
                    reference[mode] = {"bodies": bodies, "outputs": outputs}
                run["max_rel_diff"] = _max_rel(outputs, reference[mode]["outputs"])
                run["identical_sequential"] = bodies == reference[mode]["bodies"]
                runs[f"{kind}/{mode}"] = run
                print(f"{label} on {card}: {run}", flush=True)
                # forced on, a sequential request is alone in its fused call on
                # every lane: the same arithmetic, so the same bytes; the
                # concurrent ones fuse differently by lane, and auto's A/B may
                # decide differently from run to run
                if mode == "1" and not run["identical_sequential"]:
                    raise AssertionError(f"{label}: the sequential answers are not the default "
                                         f"lane's bytes")
                if not run["max_rel_diff"] <= TOL_MODEL_REL:
                    raise AssertionError(f"{label}: answers off the default lane's by "
                                         f"{run['max_rel_diff']}")
                if not accepted < n_requests or plain.calls or openapi[0] != 200:
                    raise AssertionError(f"{label}: {accepted} connections for {n_requests} "
                                         f"requests, plain attention {plain.calls}, "
                                         f"openapi.json {openapi[0]}")
                if mode != "1":
                    continue
                n_tf = len(concurrent) + len(sequential) + len(names)
                if not (tf_calls and launches == n_blocks * tf_calls
                        and stats["items"] == n_requests
                        and not (stats["bisections"] or stats["serial_rescues"])):
                    raise AssertionError(f"{label}: {launches} forward launches for {tf_calls} "
                                         f"fused Transformer calls of {n_blocks} blocks; {stats}")
                if kind == "loop" and not (widths == [1] and tf_calls == n_tf):
                    raise AssertionError(f"{label}: fuse widths {widths}, {tf_calls} fused calls "
                                         f"for {n_tf} Transformer requests")
                if kind != "loop" and not tf_calls < n_tf:
                    raise AssertionError(f"{label}: {tf_calls} fused calls for {n_tf} requests")
    finally:
        batcher.reset_batcher()
        for knob, value in previous.items():
            if value is None:
                os.environ.pop(knob, None)
            else:
                os.environ[knob] = value
    forward = sum(run["forward_launches"] for key, run in runs.items() if key.endswith("/1"))
    return {"runs": runs, "forward": forward}


# ------------------------------------------------------ the KFCV fleet
# each of the KFold and the TimeSeriesSplit groups: at 256 each this phase
# and the fast lanes' added 71.6 s to the smoke run (47.4 s and 24.2 s on an
# H100 at 700 W), over the minute they are given, so each group is 128
KFCV_FLEET_MACHINES = 128
HELD_OUT_SAMPLE = 8  # machines of each group whose held-out error is read


def kfcv_machine_config(name: str, kfold: bool) -> dict:
    """bench.py's machine (:func:`bench_machine_config`) under a
    ``DiffBasedKFCVAnomalyDetector``, with ``KFold(5, shuffle=True,
    random_state=0)`` folds or the default TimeSeriesSplit(3)."""
    config = bench_machine_config(name)
    (_, detector), = config["model"].items()
    config["model"] = {"gordo_tpu.models.anomaly.diff.DiffBasedKFCVAnomalyDetector": detector}
    if kfold:
        config["evaluation"] = {"cv": {"sklearn.model_selection.KFold": {
            "n_splits": 5, "shuffle": True, "random_state": 0}}}
    return config


def _kfcv_reference_thresholds(y: np.ndarray, folds, preds, window: int,
                               percentile: float) -> tuple:
    """The serial KFCV detector's threshold math written out plainly, in
    float64: each fold's predictions of its test rows written onto them
    (a padded tail's leading rows dropped; unvisited rows 0), its squared
    errors scaled by the min and max of its train targets and averaged over
    the tags (unvisited rows NaN), both smoothed by a rolling median of
    ``window`` rows, then the ``percentile`` quantile, NaN skipped."""
    from numpy.lib.stride_tricks import sliding_window_view

    y = np.asarray(y, np.float64)
    y_pred, mse = np.zeros_like(y), np.full(len(y), np.nan)
    for (train, test), pred in zip(folds, preds):
        pred = np.asarray(pred, np.float64)[len(pred) - len(test):]
        low, high = y[train].min(axis=0), y[train].max(axis=0)
        span = np.where(high - low < 10 * np.finfo(np.float64).eps, 1.0, high - low)
        y_pred[test] = pred
        mse[test] = np.square((pred - low) / span - (y[test] - low) / span).mean(axis=1)

    def smoothed(values):
        out = np.full(values.shape, np.nan)
        out[window - 1:] = np.median(sliding_window_view(values, window, axis=0), axis=-1)
        return np.nanquantile(out, percentile, axis=0)

    return float(smoothed(mse)), smoothed(np.abs(y - y_pred))


def kfcv_fleet_path(card: str, root: Path, device: str = "cuda") -> dict:
    """``batch-build`` (``cli.batch_build``, in this process) of one config:
    examples/config.yaml's ``turbine-c`` and ``pump-station-a`` as written,
    KFCV_FLEET_MACHINES KFCV bench hourglass machines under KFold(5,
    shuffle=True, random_state=0) (1,008 rows: test folds of 202, 202, 202,
    201 and 201, padded to 202), as many under the default TimeSeriesSplit,
    and the FLEET_MACHINES float32 ``transformer-ae-512``. Gates: exit 0,
    every machine an artifact, no machine built by the serial builder; every
    stacked program of one fold geometry, the KFold ones running row
    permutations; each KFold machine's split metadata sklearn's KFold index
    for index (:func:`_kfold_reference`); sampled thresholds finite, and the
    held-out error below the seeded weights' (the example machines' each, the
    bench machines' as HELD_OUT_SAMPLE machines' mean); a KFold chunk's first
    machine's thresholds equal to :func:`_kfcv_reference_thresholds` on that
    program's fold predictions (1e-9, float64); one KFold machine built by
    the serial builder with thresholds within 1/3 to 3 times the fleet's;
    the Transformer bucket launching dQ and dK/dV once per block a stacked
    step and the hourglass buckets none."""
    import contextlib
    import io

    import torch

    from gordo_tpu_torch import cli, serializer
    from gordo_tpu_torch.builder import ModelBuilder
    from gordo_tpu_torch.machine import Machine
    from gordo_tpu_torch.models.anomaly.diff import TimeSeriesSplit
    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.models.spec import TransformerBlock
    from gordo_tpu_torch.ops.predict import n_train_samples
    from gordo_tpu_torch.parallel import batch_trainer as bt

    kfold = [f"kfcv-kfold-{i}" for i in range(KFCV_FLEET_MACHINES)]
    tss = [f"kfcv-tss-{i}" for i in range(KFCV_FLEET_MACHINES)]
    configs = (EXAMPLE_MACHINES + [kfcv_machine_config(n, True) for n in kfold]
               + [kfcv_machine_config(n, False) for n in tss] + fleet_configs())
    config = root / "kfcv.json"
    config.write_text(json.dumps({"machines": configs}))
    output = root / "kfcv"
    shutil.rmtree(output, ignore_errors=True)
    tf_spec = TransformerAutoEncoder(**CONFIG).build_spec(len(TAGS), len(TAGS))
    n_blocks = sum(isinstance(layer, TransformerBlock) for layer in tf_spec.layers)
    n_rows = _config_rows(fleet_configs()[0])
    steps = [math.ceil(n_train_samples(tf_spec, len(train_idx)) / BATCH)
             for train_idx, _ in TimeSeriesSplit(3).split(np.zeros(n_rows))]
    steps.append(math.ceil(n_train_samples(tf_spec, n_rows) / BATCH))
    chunks, serial = [], []  # (names, cv, kfcv, spec, program seconds, y0, fold preds of machine 0)
    run_bucket, build_chunk, serial_build = (bt.run_bucket, bt.BatchedModelBuilder._build_chunk,
                                             bt.BatchedModelBuilder._serial_build)
    programs = []

    def timed_bucket(spec, X, *args, **kwargs):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_bucket(spec, X, *args, **kwargs)
        if device == "cuda":
            torch.cuda.synchronize()
        programs.append((time.perf_counter() - t0, [p[0] for p in out[2]]))
        return out

    def recorded_chunk(self, group, *args, **kwargs):
        out = build_chunk(self, group, *args, **kwargs)
        seconds, preds = programs[-1]
        chunks.append({"names": [p.machine.name for p in group], "cv": group[0].cv,
                       "kfcv": group[0].kfcv, "spec": group[0].spec, "seconds": seconds,
                       "y0": group[0].y, "preds0": preds})
        return out

    def recorded_serial(self, machine):
        serial.append(machine.name)
        return serial_build(self, machine)

    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    bt.run_bucket = timed_bucket
    bt.BatchedModelBuilder._build_chunk = recorded_chunk
    bt.BatchedModelBuilder._serial_build = recorded_serial
    stdout = io.StringIO()
    try:
        with _PlainAttentionCalls() as plain, contextlib.redirect_stdout(stdout):
            t0 = time.perf_counter()
            code = cli.batch_build(str(config), str(output), "smoke-kfcv", device=device)
            seconds = time.perf_counter() - t0
    finally:
        bt.run_bucket = run_bucket
        bt.BatchedModelBuilder._build_chunk = build_chunk
        bt.BatchedModelBuilder._serial_build = serial_build
    launches = _launches("float32")
    peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else float("nan")
    built = [line for line in stdout.getvalue().splitlines() if line.startswith("built: ")]
    n_all = len(configs)
    artifacts = sum((output / c["name"] / "model.json").exists() for c in configs)
    groups = {}
    for chunk in chunks:
        names = chunk["names"]
        key = ("transformer" if chunk["spec"] == tf_spec else
               "kfcv-kfold" if all(n.startswith("kfcv-kfold") for n in names) else
               "kfcv-tss" if all(n.startswith("kfcv-tss") for n in names) else "/".join(names))
        group = groups.setdefault(key, {"programs": 0, "machines": 0, "seconds": 0.0,
                                        "cv": set(), "kfcv": set()})
        group["programs"] += 1
        group["machines"] += len(names)
        group["seconds"] += chunk["seconds"]
        group["cv"].add(chunk["cv"])
        group["kfcv"].add(chunk["kfcv"])
    result = {"machines": n_all, "seconds": seconds, "machines_per_minute": 60.0 * n_all / seconds,
              "stacked_programs": {k: {**v, "cv": sorted(map(str, v["cv"])),
                                       "kfcv": sorted(v["kfcv"])} for k, v in groups.items()},
              "peak_gib": peak, "launches": launches, "serial_built": serial}
    print(f"KFCV batch-build of {n_all} machines ({KFCV_FLEET_MACHINES} KFold + "
          f"{KFCV_FLEET_MACHINES} TimeSeriesSplit KFCV hourglass, turbine-c, pump-station-a, "
          f"{FLEET_MACHINES} transformer-ae-512) on {card}: exit {code} in {seconds:.2f} s "
          f"({result['machines_per_minute']:.1f} machines a minute), {len(built)} built, "
          f"{artifacts} artifacts, serial {serial}; stacked programs "
          f"{result['stacked_programs']}; peak device memory {peak:.2f} GiB; float32 launches "
          f"{launches}", flush=True)
    if code != 0 or len(built) != n_all or artifacts != n_all or serial:
        raise AssertionError(f"batch-build exited {code}: {len(built)} built, {artifacts} "
                             f"artifacts of {n_all}, serially built {serial}")
    kfold_cv = ("kfold", 5, True, 0)
    want = {"kfcv-kfold": ({kfold_cv}, KFCV_FLEET_MACHINES),
            "kfcv-tss": ({("tss", 3)}, KFCV_FLEET_MACHINES),
            "transformer": ({("tss", 3)}, FLEET_MACHINES),
            "turbine-c": ({kfold_cv}, 1), "pump-station-a": ({("tss", 3)}, 1)}
    if {k: (g["cv"], g["machines"]) for k, g in groups.items()} != want:
        raise AssertionError(f"the buckets did not keep their geometries apart: {groups}")
    if plain.calls or not launches["dq"] == launches["dkv"] == n_blocks * sum(steps):
        raise AssertionError(f"expected {n_blocks * sum(steps)} dQ and dK/dV launches, got "
                             f"{launches}; plain attention {plain.calls}")
    reference = _kfold_reference(EXAMPLE_ROWS, 5, 0)
    for name in kfold + ["turbine-c"]:
        splits = serializer.load_metadata(str(output / name))["metadata"]["build_metadata"][
            "model"]["cross_validation"]["splits"]
        for k, test in enumerate(reference, start=1):
            train = np.setdiff1d(np.arange(EXAMPLE_ROWS), test)
            expected = {f"fold-{k}-n-test": len(test), f"fold-{k}-n-train": len(train),
                        f"fold-{k}-test-start": _row_label(test[0]),
                        f"fold-{k}-test-end": _row_label(test[-1]),
                        f"fold-{k}-train-start": _row_label(train[0]),
                        f"fold-{k}-train-end": _row_label(train[-1])}
            if {key: splits[key] for key in expected} != expected:
                raise AssertionError(f"{name} fold {k}: {splits}, sklearn's KFold {expected}")
    # held-out error: the example machines' each (160 and 96 steps), the
    # bench machines' (40 steps, which barely move a 4-tag hourglass, so a
    # single machine can end above its seeded weights) as a sample's mean
    errors = {}
    for name in kfold[:HELD_OUT_SAMPLE] + tss[:HELD_OUT_SAMPLE] + ["turbine-c",
                                                                   "pump-station-a"]:
        model = serializer.load(str(output / name), device)
        tags = serializer.load_model_json(str(output / name))["tags"]
        thresholds = [*model.feature_thresholds_, model.aggregate_threshold_]
        errors[name] = _seeded_error(model, tags, EXAMPLE_ROWS, device)
        if not all(math.isfinite(x) for x in thresholds):
            raise AssertionError(f"{name}: thresholds {thresholds}")
    held_out = {group: {key: float(np.mean([errors[n][key] for n in names]))
                        for key in ("trained", "seeded")}
                for group, names in (("kfcv-kfold", kfold[:HELD_OUT_SAMPLE]),
                                     ("kfcv-tss", tss[:HELD_OUT_SAMPLE]),
                                     ("turbine-c", ["turbine-c"]),
                                     ("pump-station-a", ["pump-station-a"]))}
    result["held_out_mse"] = held_out
    if not all(e["trained"] < e["seeded"] for e in held_out.values()):
        raise AssertionError(f"held-out scaled MSE not below the seeded weights': {held_out}")
    first = next(c for c in chunks if c["cv"] == kfold_cv and c["names"][0].startswith("kfcv"))
    model = serializer.load(str(output / first["names"][0]), device)
    folds = bt.fold_geometry(kfold_cv, EXAMPLE_ROWS)[1]
    agg, feature = _kfcv_reference_thresholds(first["y0"], folds, first["preds0"], model.window,
                                              model.threshold_percentile)
    threshold_diff = max(abs(agg - model.aggregate_threshold_) / abs(agg), float(np.max(
        np.abs(feature - model.feature_thresholds_) / np.abs(feature))))
    result["threshold_math_rel_diff"] = threshold_diff
    machine = Machine.from_config(kfcv_machine_config(first["names"][0], True), "smoke-kfcv")
    t0 = time.perf_counter()
    serial_model, _ = ModelBuilder(machine, device).build()
    result["serial_build_s"] = time.perf_counter() - t0
    result["serial_build_x_kfcv_s"] = result["serial_build_s"] * 2 * KFCV_FLEET_MACHINES
    ratios = np.array([model.aggregate_threshold_ / serial_model.aggregate_threshold_,
                       *(np.asarray(model.feature_thresholds_)
                         / np.asarray(serial_model.feature_thresholds_))])
    result["serial_threshold_ratios"] = ratios.tolist()
    print(f"KFCV fleet on {card}: held-out scaled MSE {held_out}; the bucket's thresholds against "
          f"the plain threshold math on its fold predictions: max rel diff {threshold_diff:.3e} "
          f"(gate 1e-9); one serial KFCV build {result['serial_build_s']:.2f} s (x "
          f"{2 * KFCV_FLEET_MACHINES} = {result['serial_build_x_kfcv_s']:.1f} s), thresholds "
          f"fleet / serial {ratios.round(3).tolist()}", flush=True)
    if not threshold_diff <= 1e-9:
        raise AssertionError(f"the bucket's KFCV thresholds are off the plain math by "
                             f"{threshold_diff}")
    if not np.all((ratios > 1 / 3) & (ratios < 3)):
        raise AssertionError(f"fleet against serial KFCV thresholds: {ratios}")
    return result


# ------------------------------------------------------------ the LSTM and TCN families
# bench.py's windowed section (_WINDOWED_FAMILIES, _windowed_machine_config):
# 8 tags, lookback 144, 2 epochs, batch 64, the windowed fleets in bf16
# (BENCH_WINDOWED_DTYPE), BENCH_WINDOWED_MACHINES machines of each family
WINDOWED_FAMILIES = {
    "lstm_ae_144": ("LSTMAutoEncoder", {"kind": "lstm_symmetric", "dims": [64, 32],
                                        "funcs": ["tanh", "tanh"]}),
    "lstm_forecast_144": ("LSTMForecast", {"kind": "lstm_symmetric", "dims": [64, 32],
                                           "funcs": ["tanh", "tanh"]}),
    "tcn_144": ("TCNAutoEncoder", {"kind": "tcn_model"}),
    # the LSTM factory at its defaults (encoding 256, 128, 64, decoding 64,
    # 128, 256, tanh): the factories' default width on a served path and in
    # a build
    "lstm_model_144": ("LSTMAutoEncoder", {"kind": "lstm_model"}),
}
WINDOWED_FIT = {"lookback_window": 144, "epochs": 2, "batch_size": 64}
WINDOWED_DTYPE = "bfloat16"
# bench.py's 64 machines a family, cut to 32: the LSTM/TCN phases added
# ~113 s to the smoke run at 64 (over the ~90 s they may take), the fleet's
# N is the first cut
WINDOWED_FLEET_MACHINES = 32
WINDOWED_ROUNDS = 10  # sequential 1,535-row anomaly requests a windowed artifact
WINDOWED_REQUESTS = 2  # concurrent 1,535-row requests a model, batching forced on
LSTM_STEPS_TIMED = 200  # compressor-b's training steps timed on the kernels
LSTM_PLAIN_STEPS = 10  # and on the plain twin (the step loop in torch)


def _n_lstm(spec) -> int:
    from gordo_tpu_torch.models.spec import LSTMLayer

    return sum(isinstance(layer, LSTMLayer) for layer in spec.layers)


def _stage_steps(spec, n_rows: int, batch: int, epochs: int) -> int:
    """The optimizer steps of one build of ``spec`` on ``n_rows`` rows: the
    three TimeSeriesSplit folds, then the full fit, each its live steps
    (``stages_of``, ``run_masked_epoch``) for each epoch."""
    from gordo_tpu_torch.parallel import batch_trainer as bt

    stages = bt.stages_of(spec, n_rows, bt._fold_bounds(n_rows, 3), batch)
    return epochs * sum(max(math.ceil(stage.n_valid / stage.batch), 1) for stage in stages)


def _lstm_step_ms(spec, device: str, steps: int, plain: bool) -> float:
    """Host-clock ms a training step of ``spec`` at batch 1 (compressor-b's
    shape), after a warm-up: through the recurrence kernels, or with
    ``plain`` through the plain twin's step loop in torch on the card
    (autograd over its ops), which launches ~10 kernels a layer and step."""
    import torch

    from gordo_tpu_torch.ops import lstm, nn as port_nn, train
    from gordo_tpu_torch.ops.nn import TransformerModel, init_model_params

    model = TransformerModel(spec, init_model_params(spec, torch.Generator().manual_seed(SEED)),
                             torch.device(device))
    optimizer = train.make_optimizer(spec.optimizer, model.parameters())
    X = torch.rand((steps + spec.lookback_window + 16, spec.n_features),
                   generator=torch.Generator().manual_seed(SEED)).to(device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    kernel = port_nn.lstm_recurrence
    if plain:
        port_nn.lstm_recurrence = lambda zx, rk, act, rec, seqs: lstm.lstm_recurrence_forward_plain(
            zx, rk, act, rec, seqs)[0]
    try:
        train.run_epoch(model, optimizer, X, X, torch.arange(4), 1)  # warm-up
        sync()
        t0 = time.perf_counter()
        train.run_epoch(model, optimizer, X, X, torch.arange(steps), 1)
        sync()
        return 1e3 * (time.perf_counter() - t0) / steps
    finally:
        port_nn.lstm_recurrence = kernel


def lstm_example_build_path(card: str, root: Path, device: str = "cuda") -> dict:
    """``build`` of examples/config.yaml's compressor-b as written
    (``LSTM_EXAMPLE_MACHINE``: an LSTMAutoEncoder, lstm_hourglass of 4 tags,
    lookback 24, 3 epochs at the estimator's batch of 1) through the port's
    CLI (``cli.main``, in this process, so that its launches are counted).
    Gates: exit 0, finite thresholds, the offset 23, the held-out error
    below the seeded weights', the recurrence's backward kernel launched
    once per LSTM layer a step of every fold and the fit, and its forward
    at least as often. Then a step's host-clock ms on the kernels and on the
    plain twin, the launch cost the kernels remove."""
    import contextlib
    import io

    from gordo_tpu_torch import cli, serializer
    from gordo_tpu_torch.models.spec import LSTMLayer

    out = root / "compressor-b"
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--log-level", "WARNING", "build", json.dumps(LSTM_EXAMPLE_MACHINE), str(out),
            "--print-cv-scores"] + ([] if device == "cuda" else ["--device", device])
    stdout = io.StringIO()
    # the earlier phases' objects are frozen out of the collector's passes,
    # which the build's 7,284 steps of autograd objects trigger: a fresh
    # `python -m gordo_tpu_torch build` process holds none of them
    gc.collect()
    gc.freeze()
    _reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(stdout):
            code = cli.main(argv)
    finally:
        gc.unfreeze()
    seconds = time.perf_counter() - t0
    launches = _lstm_launches("float32")
    by_units = _lstm_unit_launches("float32")
    if code != 0:
        raise AssertionError(f"build compressor-b: exit {code}")
    model = serializer.load(str(out), device)
    built = serializer.load_metadata(str(out))["metadata"]["build_metadata"]
    estimator = model.base_estimator.steps[-1][1]
    spec = estimator.spec_
    steps = _stage_steps(spec, EXAMPLE_ROWS, 1, 3)
    tags = LSTM_EXAMPLE_MACHINE["dataset"]["tags"]
    mse = _seeded_error(model, tags, EXAMPLE_ROWS, device)
    thresholds = [float(x) for x in (*model.feature_thresholds_, model.aggregate_threshold_)]
    phases = built["phases"]
    result = {
        "seconds": seconds, "phases": phases, "offset": built["model"]["model_offset"],
        "launches_by_units": by_units,
        "units": [layer.units for layer in spec.layers if isinstance(layer, LSTMLayer)],
        "steps": steps, "launches": launches, "held_out_mse": mse,
        "aggregate_threshold": model.aggregate_threshold_,
        "ms_per_step_of_cv_and_fit": 1e3 * (phases["cross_validation"] + phases["fit"]) / steps,
        "score_lines": sum("_fold-" in line for line in stdout.getvalue().splitlines()),
    }
    print(f"LSTM example build compressor-b on {card}: exit {code} in {seconds:.2f} s, phases "
          f"{phases}, {steps} steps ({result['ms_per_step_of_cv_and_fit']:.3f} ms a step of CV "
          f"and fit, fold predicts included), LSTM units {result['units']}, offset "
          f"{result['offset']}, held-out scaled MSE {mse['trained']:.6f} (seeded "
          f"{mse['seeded']:.6f}), thresholds {thresholds}, recurrence launches {launches}",
          flush=True)
    n_lstm = _n_lstm(spec)
    if not (mse["trained"] < mse["seeded"] and all(math.isfinite(x) for x in thresholds)
            and result["offset"] == 23 and launches["backward"] == n_lstm * steps
            and launches["forward"] >= launches["backward"]):
        raise AssertionError(f"compressor-b: {result}, expected {n_lstm * steps} backward "
                             f"launches")
    before = _lstm_launches("float32")
    kernel_ms = _lstm_step_ms(spec, device, LSTM_STEPS_TIMED, plain=False)
    plain_before = _lstm_launches("float32")
    plain_ms = _lstm_step_ms(spec, device, LSTM_PLAIN_STEPS, plain=True)
    if device == "cuda" and (_lstm_launches("float32") != plain_before or plain_before == before):
        raise AssertionError("the timed steps did not take the paths they name")
    result.update({"step_ms": kernel_ms, "plain_twin_step_ms": plain_ms})
    print(f"compressor-b's training step at batch 1 on {card}: {kernel_ms:.3f} ms on the "
          f"recurrence kernels ({LSTM_STEPS_TIMED} steps), {plain_ms:.3f} ms on the plain twin's "
          f"step loop ({LSTM_PLAIN_STEPS} steps); the build's {steps} steps on the plain twin "
          f"would take ~{plain_ms * steps / 1e3:.0f} s of training", flush=True)
    return result


def windowed_served_path(card: str, root: Path, device: str = "cuda") -> dict:
    """bench.py's windowed families served: ``lstm_ae_144``,
    ``lstm_forecast_144`` and ``tcn_144`` artifacts (8 tags, lookback 144,
    seeded weights) in float32 and bf16, and a ``transformer-ae-512``
    artifact, in one collection served as ``run-server`` serves it
    (batching ``auto``): a 1,535-row anomaly request to each windowed
    artifact within its dtype's tolerance of the direct predict, then
    WINDOWED_ROUNDS sequential requests each (p50). Then, batching forced
    on, WINDOWED_REQUESTS 1,535-row requests to every model at once from 16
    users: every answer 200 and within its tolerance of the direct
    predict, no fused call of two specs, the recurrence's forward launched
    once per LSTM layer a fused LSTM call (and no backward), the flash
    forward once per block a fused Transformer call."""
    from gordo_tpu_torch.models.spec import TransformerBlock
    from gordo_tpu_torch.server import batcher
    from gordo_tpu_torch.server.server import make_server

    collection = root / "windowed_served"
    shutil.rmtree(collection, ignore_errors=True)
    collection.mkdir(parents=True)
    specs, tolerance = {}, {}
    for k, (family, (cls, kwargs)) in enumerate(WINDOWED_FAMILIES.items()):
        for dtype in ("float32", "bfloat16"):
            name = f"{family}-{dtype}"
            specs[name], _, _ = write_artifact(
                collection, device, name=name, seed=SEED + 50 + k, estimator_cls=cls,
                config={**kwargs, "lookback_window": WINDOWED_FIT["lookback_window"]},
                compute_dtype=dtype)
            tolerance[name] = TOL_MODEL_REL if dtype == "float32" else TOL_BF16_MODEL_REL
    specs["transformer-ae-512"], _, _ = write_artifact(collection, device)
    tolerance["transformer-ae-512"] = TOL_MODEL_REL
    n_blocks = sum(isinstance(layer, TransformerBlock)
                   for layer in specs["transformer-ae-512"].layers)
    rng = np.random.RandomState(SEED + 60)
    previous = os.environ.get("GORDO_TPU_SERVING_BATCH")
    os.environ["GORDO_TPU_SERVING_BATCH"] = "auto"
    batcher.reset_batcher()
    server = make_server("127.0.0.1", 0, device=device, collection_dir=str(collection))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    project = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/smoke"
    result = {"models": {}}

    def worst_diff(requests, results) -> dict:
        worst = {}
        for (name, body), (_, answer, _) in zip(requests, results):
            entry = server.models[name]
            out = _columns(json.loads(answer)["data"]["model-output"], entry.tags)
            want = _direct(entry.detector, np.asarray(json.loads(body)["X"]))
            if out.shape != want.shape:
                raise AssertionError(f"{name}: output {out.shape}, direct {want.shape}")
            worst[name] = max(worst.get(name, 0.0),
                              float(np.abs(out - want).max() / np.abs(want).max()))
        return worst

    try:
        for name in specs:
            if name == "transformer-ae-512":
                continue
            body = _rect_body(_series(FULL_ROWS, 60000, rng))
            results, _ = _drive(project, [(name, body)] * WINDOWED_ROUNDS, 1)
            if any(r[0] != 200 for r in results):
                raise AssertionError(f"{name}: statuses {[r[0] for r in results]}")
            diff = worst_diff([(name, body)], results[:1])[name]
            times = sorted(r[2] for r in results)
            result["models"][name] = {"p50_ms": times[len(times) // 2], "max_ms": times[-1],
                                      "max_rel_diff": diff,
                                      "offset": specs[name].output_offset}
            print(f"windowed served {name} ({FULL_ROWS} rows, batching auto) on {card}: "
                  f"{result['models'][name]}", flush=True)
            if not diff <= tolerance[name]:
                raise AssertionError(f"{name} off its direct predict: {diff}")
        fused = batcher.peek_batcher()
        result["self_ab"] = {_spec_label(s): v for s, v in fused.calibrations.items()}

        os.environ["GORDO_TPU_SERVING_BATCH"] = "1"
        batcher.reset_batcher()
        requests = [(name, _rect_body(_series(FULL_ROWS, 70000 + 2000 * i, rng)))
                    for i in range(WINDOWED_REQUESTS) for name in specs]
        _reset_launches()
        with _PlainAttentionCalls() as plain:
            results, wall = _drive(project, requests, 16)
        launches = {dtype: {**_launches(dtype), **{f"lstm_{k}": v for k, v in
                                                    _lstm_launches(dtype).items()}}
                    for dtype in ("float32", "bfloat16")}
        by_units = {dtype: _lstm_unit_launches(dtype) for dtype in ("float32", "bfloat16")}
        fused = batcher.peek_batcher()
        stats, spec_calls = dict(fused.stats), dict(fused.spec_calls)
        if any(r is None or r[0] != 200 for r in results):
            raise AssertionError(f"concurrent windowed requests: "
                                 f"{[r[0] if r else None for r in results]}")
        worst = worst_diff(requests, results)
        latencies = sorted(r[2] for r in results)
        lstm_calls = {dtype: sum(spec_calls.get(spec, 0) * _n_lstm(spec)
                                 for spec in specs.values()
                                 if _n_lstm(spec) and spec.compute_dtype == dtype)
                      for dtype in ("float32", "bfloat16")}
        result["concurrent"] = {
            "requests": len(requests), "users": 16, "wall_s": wall,
            "p50_ms": latencies[len(latencies) // 2], "max_ms": latencies[-1],
            "batcher": stats, "fused_calls_by_model": {
                name: spec_calls.get(spec, 0) for name, spec in specs.items()},
            "max_rel_diff": worst, "launches": launches, "lstm_launches_by_units": by_units,
            "lstm_layer_calls": lstm_calls, "plain_attention_calls": plain.calls}
        print(f"concurrent windowed requests (batching forced on) on {card}: "
              f"{result['concurrent']}", flush=True)
        if (stats["mixed_spec_calls"] or stats["items"] != len(requests) or stats["bisections"]
                or stats["serial_rescues"] or plain.calls):
            raise AssertionError(f"the windowed collection's fused calls: {stats}")
        if not all(worst[name] <= tolerance[name] for name in worst):
            raise AssertionError(f"fused answers off their direct predicts: {worst}")
        tf_calls = spec_calls.get(specs["transformer-ae-512"], 0)
        for dtype in ("float32", "bfloat16"):
            got = launches[dtype]
            if got["lstm_forward"] != lstm_calls[dtype] or got["lstm_backward"]:
                raise AssertionError(f"{dtype} recurrence launches {got} for "
                                     f"{lstm_calls[dtype]} fused LSTM layer calls")
            # lstm_model_144's two U-256 layers, the only ones of that width
            wide = 2 * spec_calls.get(specs[f"lstm_model_144-{dtype}"], 0)
            if not wide or by_units[dtype]["forward"].get(256, 0) != wide:
                raise AssertionError(f"{dtype} U-256 recurrence launches "
                                     f"{by_units[dtype]['forward']}, expected {wide}")
        if not (tf_calls and launches["float32"]["forward"] == n_blocks * tf_calls):
            raise AssertionError(f"{launches['float32']} flash forward launches for {tf_calls} "
                                 f"fused Transformer calls of {n_blocks} blocks")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        batcher.reset_batcher()
        if previous is None:
            os.environ.pop("GORDO_TPU_SERVING_BATCH", None)
        else:
            os.environ["GORDO_TPU_SERVING_BATCH"] = previous
    result["launches"] = launches
    result["lstm_launches_by_units"] = by_units
    return result


def windowed_machine_config(name: str, family: str) -> dict:
    """bench.py's windowed machine (``_windowed_machine_config``): ``family``
    over MinMaxScaler in a DiffBasedAnomalyDetector, 8 tags of 7 days of
    10-minute RandomDataset rows, lookback 144, 2 epochs, batch 64, bf16."""
    cls, kwargs = WINDOWED_FAMILIES[family]
    config = bench_machine_config(name)
    config["dataset"]["tags"] = [f"{name}-tag-{j}" for j in range(8)]
    (_, detector), = config["model"].items()
    detector["base_estimator"]["sklearn.pipeline.Pipeline"]["steps"][1] = {
        f"gordo_tpu.models.models.{cls}": {**kwargs, **WINDOWED_FIT,
                                           "compute_dtype": WINDOWED_DTYPE}}
    return config


def windowed_fleet_path(card: str, root: Path, device: str = "cuda") -> dict:
    """``batch-build`` (``cli.batch_build``, in this process) of
    WINDOWED_FLEET_MACHINES machines of each windowed family and the
    FLEET_MACHINES float32 ``transformer-ae-512``. Gates: exit 0, every
    machine an artifact, none built serially; each stacked program holds one
    family; the LSTM buckets launch the bf16 recurrence backward once per
    LSTM layer a stacked step for the whole bucket, and dQ and dK/dV come
    from the Transformer bucket alone (once per block a stacked step);
    every machine's thresholds finite and its held-out error below its
    seeded weights'. Then one serial build of a machine of each family, for
    the wall against the serial build x N."""
    import contextlib
    import io

    import torch

    from gordo_tpu_torch import cli, serializer
    from gordo_tpu_torch.builder import ModelBuilder
    from gordo_tpu_torch.machine import Machine
    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.models.spec import TransformerBlock
    from gordo_tpu_torch.parallel import batch_trainer as bt

    # machine names take no underscore: lstm_ae_144's are lstm-ae-144-0, ...
    names = {family: [f"{family.replace('_', '-')}-{i}" for i in range(WINDOWED_FLEET_MACHINES)]
             for family in WINDOWED_FAMILIES}
    configs = [windowed_machine_config(n, family) for family in names for n in names[family]]
    configs += fleet_configs()
    config = root / "windowed.json"
    config.write_text(json.dumps({"machines": configs}))
    output = root / "windowed"
    shutil.rmtree(output, ignore_errors=True)
    tf_spec = TransformerAutoEncoder(**CONFIG).build_spec(len(TAGS), len(TAGS))
    n_blocks = sum(isinstance(layer, TransformerBlock) for layer in tf_spec.layers)
    chunks, serial = [], []
    run_bucket, build_chunk, serial_build = (bt.run_bucket, bt.BatchedModelBuilder._build_chunk,
                                             bt.BatchedModelBuilder._serial_build)
    programs = []

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def timed_bucket(spec, X, *args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = run_bucket(spec, X, *args, **kwargs)
        sync()
        programs.append(time.perf_counter() - t0)
        return out

    def recorded_chunk(self, group, *args, **kwargs):
        out = build_chunk(self, group, *args, **kwargs)
        chunks.append({"names": [p.machine.name for p in group], "spec": group[0].spec,
                       "seconds": programs[-1], "n_rows": len(group[0].X),
                       "batch": group[0].batch_size, "epochs": group[0].epochs})
        return out

    def recorded_serial(self, machine):
        serial.append(machine.name)
        return serial_build(self, machine)

    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    bt.run_bucket = timed_bucket
    bt.BatchedModelBuilder._build_chunk = recorded_chunk
    bt.BatchedModelBuilder._serial_build = recorded_serial
    stdout = io.StringIO()
    try:
        with _PlainAttentionCalls() as plain, contextlib.redirect_stdout(stdout):
            t0 = time.perf_counter()
            code = cli.batch_build(str(config), str(output), "smoke-windowed", device=device)
            seconds = time.perf_counter() - t0
    finally:
        bt.run_bucket = run_bucket
        bt.BatchedModelBuilder._build_chunk = build_chunk
        bt.BatchedModelBuilder._serial_build = serial_build
    launches = {dtype: {**_launches(dtype), **{f"lstm_{k}": v for k, v in
                                                _lstm_launches(dtype).items()}}
                for dtype in ("float32", "bfloat16")}
    by_units = _lstm_unit_launches("bfloat16")
    peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else float("nan")
    built = [line for line in stdout.getvalue().splitlines() if line.startswith("built: ")]
    artifacts = sum((output / c["name"] / "model.json").exists() for c in configs)
    groups, tf_steps, lstm_layer_steps, wide_steps = {}, 0, 0, 0
    for chunk in chunks:
        family = ("transformer" if chunk["spec"] == tf_spec
                  else chunk["names"][0].rsplit("-", 1)[0].replace("-", "_"))
        if not all(n.rsplit("-", 1)[0] == chunk["names"][0].rsplit("-", 1)[0]
                   for n in chunk["names"]):
            raise AssertionError(f"a stacked program mixes families: {chunk['names']}")
        group = groups.setdefault(family, {"programs": 0, "machines": 0, "seconds": 0.0})
        group["programs"] += 1
        group["machines"] += len(chunk["names"])
        group["seconds"] += chunk["seconds"]
        steps = _stage_steps(chunk["spec"], chunk["n_rows"], chunk["batch"], chunk["epochs"])
        group["stacked_steps"] = group.get("stacked_steps", 0) + steps
        if family == "transformer":
            tf_steps += steps
        lstm_layer_steps += _n_lstm(chunk["spec"]) * steps
        if family == "lstm_model_144":
            wide_steps += 2 * steps  # its two U-256 layers
    n_all = len(configs)
    result = {"machines": n_all, "seconds": seconds,
              "machines_per_minute": 60.0 * n_all / seconds, "stacked_programs": groups,
              "peak_gib": peak, "launches": launches, "lstm_launches_by_units": by_units,
              "serial_built": serial}
    print(f"windowed batch-build of {n_all} machines ({WINDOWED_FLEET_MACHINES} each of "
          f"{sorted(WINDOWED_FAMILIES)} in {WINDOWED_DTYPE}, {FLEET_MACHINES} float32 "
          f"transformer-ae-512) on {card}: exit {code} in {seconds:.2f} s "
          f"({result['machines_per_minute']:.1f} machines a minute), {len(built)} built, "
          f"{artifacts} artifacts, serial {serial}; stacked programs {groups}; peak device "
          f"memory {peak:.2f} GiB; launches {launches}", flush=True)
    if code != 0 or len(built) != n_all or artifacts != n_all or serial:
        raise AssertionError(f"batch-build exited {code}: {len(built)} built, {artifacts} "
                             f"artifacts of {n_all}, serially built {serial}")
    if {k: g["machines"] for k, g in groups.items()} != {
            **{f: WINDOWED_FLEET_MACHINES for f in WINDOWED_FAMILIES},
            "transformer": FLEET_MACHINES}:
        raise AssertionError(f"the buckets did not keep the families apart: {groups}")
    bf16, f32 = launches["bfloat16"], launches["float32"]
    if not (bf16["lstm_backward"] == lstm_layer_steps and bf16["lstm_forward"] >= lstm_layer_steps
            and not f32["lstm_forward"] and not f32["lstm_backward"]):
        raise AssertionError(f"expected {lstm_layer_steps} bf16 recurrence backward launches, "
                             f"got {launches}")
    if not wide_steps or by_units["backward"].get(256, 0) != wide_steps:
        raise AssertionError(f"expected {wide_steps} U-256 bf16 recurrence backward launches "
                             f"from lstm_model_144's buckets, got {by_units}")
    if plain.calls or not (f32["dq"] == f32["dkv"] == n_blocks * tf_steps
                           and not bf16["dq"] and not bf16["dkv"]):
        raise AssertionError(f"expected {n_blocks * tf_steps} float32 dQ and dK/dV launches "
                             f"from the Transformer bucket alone, got {launches}; plain "
                             f"attention {plain.calls}")
    held_out = {}
    for family, members in names.items():
        errors = []
        for name in members:
            model = serializer.load(str(output / name), device)
            tags = serializer.load_model_json(str(output / name))["tags"]
            thresholds = [*model.feature_thresholds_, model.aggregate_threshold_]
            error = _seeded_error(model, tags, EXAMPLE_ROWS, device)
            if not (all(math.isfinite(x) for x in thresholds)
                    and error["trained"] < error["seeded"]):
                raise AssertionError(f"{name}: thresholds {thresholds}, held-out scaled MSE "
                                     f"{error} (trained against seeded weights)")
            errors.append(error)
        held_out[family] = {"trained_mean": float(np.mean([e["trained"] for e in errors])),
                            "seeded_mean": float(np.mean([e["seeded"] for e in errors])),
                            "worst_ratio": max(e["trained"] / e["seeded"] for e in errors)}
    result["held_out_mse"] = held_out
    serial_s = {}
    for family, members in names.items():
        machine = Machine.from_config(windowed_machine_config(members[0], family), "serial")
        t0 = time.perf_counter()
        ModelBuilder(machine, device).build()
        serial_s[family] = time.perf_counter() - t0
    result["serial_build_s"] = serial_s
    result["serial_build_x_n_s"] = sum(serial_s.values()) * WINDOWED_FLEET_MACHINES
    print(f"windowed fleet on {card}: held-out scaled MSE {held_out}; one serial build "
          f"{serial_s} s, x {WINDOWED_FLEET_MACHINES} = {result['serial_build_x_n_s']:.1f} s "
          f"against the fleet's {seconds:.2f} s (with the Transformer bucket)", flush=True)
    return result


# ------------------------------------------------------------ transformer-ae-512-d384
# transformer-ae-512 at d_model 384 over its 4 heads (dh 96, a head dim the
# kernels run through their padded classes) and ff 768; everything else as
# the main path: built by the CLI in float32 and bf16, served direct and
# fused, trained as a stacked two-machine bucket
D384 = {"d_model": 384, "ff_dim": 768}
D384_CONFIG = {**CONFIG, **D384}
D384_ROUNDS = 5  # sequential 1,535-row requests in each serving mode


def cli_model_build(card: str, root: Path, dtype: str, model: dict, label: str,
                    device: str = "cuda") -> dict:
    """``build`` of the ``label`` machine (``build_config`` with the
    TransformerAutoEncoder arguments ``model``, ``compute_dtype`` ``dtype``)
    through the port's CLI in this process (``cli.main``), so that its
    launches are counted. Gates: exit 0, every CV score line, finite
    thresholds, the held-out error below the seeded weights', the dtype's
    dQ and dK/dV launched once per block a step of every fold and the fit,
    the forward at least as often, no kernel of the other dtype and no
    plain attention. Returns the phases, ms a fit step, peak device memory
    and launches."""
    import contextlib
    import io

    import torch

    from gordo_tpu_torch import cli, serializer
    from gordo_tpu_torch.models.anomaly.diff import TimeSeriesSplit
    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.ops.predict import n_train_samples

    extra = {"compute_dtype": "bfloat16"} if dtype == "bfloat16" else {}
    name = label + ("-bf16" if extra else "")
    config = build_config(name, base=model, **extra)
    spec = TransformerAutoEncoder(**model, **extra).build_spec(len(TAGS), len(TAGS))
    other = next(d for d in COUNTERS if d != dtype)
    n_rows = _config_rows(config)
    steps = [math.ceil(n_train_samples(spec, len(train_idx)) / BATCH)
             for train_idx, _ in TimeSeriesSplit(3).split(np.zeros(n_rows))]
    steps.append(math.ceil(n_train_samples(spec, n_rows) / BATCH))
    n_blocks = _attention_blocks(spec)
    out = root / name
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--log-level", "WARNING", "build", json.dumps(config), str(out),
            "--print-cv-scores"] + ([] if device == "cuda" else ["--device", device])
    stdout = io.StringIO()
    gc.collect()
    gc.freeze()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    try:
        with _PlainAttentionCalls() as plain, contextlib.redirect_stdout(stdout):
            code = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        gc.unfreeze()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches, others = _launches(dtype), _launches(other)
    if code != 0:
        raise AssertionError(f"build {name}: exit {code}")
    built = serializer.load(str(out), device)
    phases = serializer.load_metadata(str(out))["metadata"]["build_metadata"]["phases"]
    mse = held_out_mse(built, spec, n_rows)
    thresholds = [float(x) for x in (*built.feature_thresholds_, built.aggregate_threshold_)]
    score_lines = sum("_fold-" in line for line in stdout.getvalue().splitlines())
    result = {"name": name, "seconds": seconds, "phases": phases, "steps": steps,
              "ms_per_fit_step": 1e3 * phases["fit"] / steps[3], "peak_gib": peak,
              "launches": launches, "held_out_mse": mse, "thresholds": thresholds,
              "score_lines": score_lines, "plain_attention_calls": plain.calls}
    print(f"build {name} ({dtype}, dh {model['d_model'] // model['num_heads']}) "
          f"through the CLI on {card}: exit {code} in {seconds:.2f} s; phases (s) {phases}; CV "
          f"{steps[:3]} steps, fit {steps[3]} steps, {result['ms_per_fit_step']:.2f} ms per fit "
          f"step; peak device memory {peak:.2f} GiB; {dtype} launches {launches}; held-out "
          f"scaled MSE {mse['trained']:.6f} (seeded {mse['seeded']:.6f}); aggregate threshold "
          f"{built.aggregate_threshold_:.6f}; {score_lines} score lines; plain attention "
          f"calls {plain.calls}", flush=True)
    expected_lines = 4 * (len(TAGS) + 1) * 7
    if not (launches["dq"] == launches["dkv"] == n_blocks * sum(steps)
            and launches["forward"] >= launches["dq"]):
        raise AssertionError(f"{name}: launches {launches}, expected {n_blocks * sum(steps)} "
                             f"dQ and dK/dV")
    if any(others.values()) or plain.calls:
        raise AssertionError(f"{name}: {other} launches {others}, plain calls {plain.calls}")
    if not (mse["trained"] < mse["seeded"] and all(math.isfinite(x) for x in thresholds)
            and score_lines == expected_lines):
        raise AssertionError(f"{name}: {result}")
    return result


def d384_served(card: str, collection: Path, names: dict, device: str = "cuda") -> dict:
    """The built transformer-ae-512-d384 artifacts (``names``: dtype ->
    name) served as ``run-server`` serves them, with
    ``GORDO_TPU_SERVING_BATCH`` 0 (direct), then 1 (the batcher forced on):
    D384_ROUNDS 1,535-row anomaly requests each (:func:`_served_run`'s
    checks: every answer 200, the native codec, no plain attention, the
    forward once per block a request or fused call). Gates: the fused
    answers within the dtype's tolerance (TOL_OUT_REL, TOL_BF16_MODEL_REL)
    of the direct ones, and the direct answer's model output within
    TOL_MODEL_REL (bf16 TOL_BF16_MODEL_REL) of the same model with the plain
    attention. Then the peak device memory a window of a direct predict and
    of one fused call of eight full-width requests (``fused_memory``).
    Returns p50s, errors, memory and the forward launches."""
    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.server import batcher
    from gordo_tpu_torch.server.server import make_server

    previous = os.environ.get("GORDO_TPU_SERVING_BATCH")
    server = make_server("127.0.0.1", 0, device=device, collection_dir=str(collection))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    project = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/smoke"
    rng = np.random.RandomState(SEED + 30)
    result = {}
    try:
        for dtype, name in names.items():
            tol = TOL_BF16_MODEL_REL if dtype == "bfloat16" else TOL_OUT_REL
            values = _series(FULL_ROWS, 80000, rng)
            body = _rect_body(values)
            n_out = FULL_ROWS - D384_CONFIG["lookback_window"] + 1
            runs = {mode: _served_run(card, project, [(name, body)] * D384_ROUNDS, 1, mode,
                                      dtype, D384_CONFIG["num_blocks"], n_out,
                                      f"transformer-ae-512-d384 ({FULL_ROWS} rows)",
                                      must_fuse=False)
                    for mode in ("0", "1")}
            os.environ["GORDO_TPU_SERVING_BATCH"] = "0"
            batcher.reset_batcher()
            detector = server.models[name].detector
            estimator, scaler = (detector.base_estimator.steps[-1][1],
                                 detector.base_estimator.steps[0][1])
            plain = TransformerAutoEncoder(**D384_CONFIG).load_params(
                _with_attention(estimator.spec_, "xla"), estimator.module_.params_numpy(), device)
            ref = plain.predict(scaler.transform(values))
            served = runs["0"]["outputs"][0]
            errors = {"fused_vs_direct": _max_rel(runs["1"]["outputs"], runs["0"]["outputs"]),
                      "direct_vs_plain_attention": float(np.abs(served - ref).max()
                                                         / np.abs(ref).max())}
            plain_tol = TOL_BF16_MODEL_REL if dtype == "bfloat16" else TOL_MODEL_REL
            print(f"transformer-ae-512-d384 served ({dtype}) on {card}: p50 direct "
                  f"{runs['0']['p50_ms']:.2f} ms, fused {runs['1']['p50_ms']:.2f} ms; max rel "
                  f"err {errors} (gates {tol:g}, {plain_tol:g})", flush=True)
            if not (errors["fused_vs_direct"] <= tol
                    and errors["direct_vs_plain_attention"] <= plain_tol):
                raise AssertionError(f"transformer-ae-512-d384 ({dtype}) answers: {errors}")
            memory = fused_memory(card, [estimator] * BATCHER_MODELS, dtype, rng, tol)
            result[dtype] = {
                "p50_ms": {"direct": runs["0"]["p50_ms"], "fused": runs["1"]["p50_ms"]},
                "max_ms": {"direct": runs["0"]["max_ms"], "fused": runs["1"]["max_ms"]},
                "errors": errors, "memory": memory,
                "forward_launches": runs["0"]["forward_launches"] + runs["1"]["forward_launches"],
                "fused_calls": runs["1"]["fused_calls"]}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        batcher.reset_batcher()
        if previous is None:
            os.environ.pop("GORDO_TPU_SERVING_BATCH", None)
        else:
            os.environ["GORDO_TPU_SERVING_BATCH"] = previous
    return result


def d384_path(card: str, root: Path, device: str = "cuda") -> dict:
    """transformer-ae-512-d384 on the card: built by the CLI in float32 and
    bf16 (:func:`cli_model_build`), both artifacts served direct and fused
    (:func:`d384_served`), and a stacked two-machine bucket of it against
    the serial trainer (:func:`fleet_loss_check`: one batch's output and
    gradients within TOL_GRAD_REL in float32 and TOL_BF16_MODEL_REL in bf16,
    LOSS_STEPS float32 losses within TOL_LOSS_REL), with no plain
    attention. Returns each part's numbers and the kernels' launches by
    dtype and part: every launch here is at dh 96."""
    shutil.rmtree(root, ignore_errors=True)
    collection = root / "collection"
    collection.mkdir(parents=True)
    builds = {dtype: cli_model_build(card, collection, dtype, D384_CONFIG,
                                     "transformer-ae-512-d384", device) for dtype in COUNTERS}
    served = d384_served(card, collection, {dtype: b["name"] for dtype, b in builds.items()},
                         device)
    _reset_launches()
    with _PlainAttentionCalls() as plain:
        stacked = fleet_loss_check(card, device, config=D384_CONFIG)
    stacked["launches"] = {dtype: _launches(dtype) for dtype in COUNTERS}
    print(f"transformer-ae-512-d384 stacked against serial: launches {stacked['launches']}, "
          f"plain attention calls {plain.calls}", flush=True)
    if plain.calls or not all(n["dq"] and n["dkv"] for n in stacked["launches"].values()):
        raise AssertionError(f"the d384 stacked check: {stacked['launches']}, plain calls "
                             f"{plain.calls}")
    launches = {dtype: {"build": builds[dtype]["launches"],
                        "served": {"forward": served[dtype]["forward_launches"]},
                        "stacked": stacked["launches"][dtype]} for dtype in COUNTERS}
    return {"build": builds, "served": served, "stacked": stacked, "launches": launches}


# ------------------------------------------------------------ the Switch-MoE Transformer
# moe-transformer-ae-512: transformer-ae-512 with each block's FFN swapped
# for 8 Switch experts of 512 (capacity factor 1.25, the load-balancing loss
# at the block's 0.01), float32 and bf16: built by the CLI, served direct and
# fused, trained as stacked buckets. moe_model_144: the JAX factory at its
# own defaults (lookback 144, d_model 64, 4 heads of 16, 8 experts of 128),
# which runs the kernels' dh-16 class
MOE = {"kind": "moe_transformer_model", "num_experts": 8, "expert_dim": 512,
       "capacity_factor": 1.25}
MOE_CONFIG = {**{k: v for k, v in CONFIG.items() if k != "ff_dim"}, **MOE}
MOE144_CONFIG = {"kind": "moe_transformer_model", "lookback_window": 144, "d_model": 64,
                 "num_heads": 4}
MOE_ROUNDS = 5  # sequential 1,535-row requests in each serving mode
# a routing flip (two computations of one model sending a token to different
# experts) is rounding when the reference's logit gap between the two
# experts is under absolute + relative x |its top logit|: 1e-5 in float32,
# one bf16 ulp (BF16_ULP of the top logit) in bf16
MOE_FLIP_GAP = {"float32": (1e-5, 0.0), "bfloat16": (0.0, BF16_ULP)}
MOE_FLEET_MACHINES = 2  # of each configuration in the MoE batch-build
MOE_TIMED_BH = (256,)  # moe_model_144's stacked step: 2 machines x batch 32 x 4 heads


def _routing_numpy(routing: list, lane=None) -> list:
    """MoE routing records (``forward_with_routing``) as numpy, lane
    ``lane`` of stacked ones."""
    return [{key: (value if lane is None else value[lane]).cpu().numpy()
             for key, value in record.items() if key != "capacity"}
            | {"capacity": record["capacity"]} for record in routing]


def routing_gate(ref: list, got: list, tokens_per_window: int, gap: tuple) -> tuple:
    """Two computations' routing of one model's tokens (numpy records of
    :func:`_routing_numpy`, block by block, tokens window-major), compared
    first, as every MoE gate compares. A flip (a token whose top-1 expert
    differs) must have a logit gap in ``ref`` between its two experts under
    ``gap`` (absolute, relative to the token's top logit) unless its window
    is already tainted; a capacity shift (one expert, kept by one side
    only) must follow a flip into or out of that expert earlier in token
    order in the same block. A window that holds a flip or a shift is
    tainted from then on (attention carries the difference along it).
    Raises on any other difference; returns the tainted windows (a bool
    array) and the counts."""
    n = ref[0]["top1"].shape[-1] if ref else 0
    windows = np.arange(n) // tokens_per_window
    tainted = np.zeros(n // tokens_per_window, bool)
    report = {"flips": [], "capacity_shifts": [], "max_flip_gap": 0.0}
    for block, (r, g) in enumerate(zip(ref, got)):
        flip = r["top1"] != g["top1"]
        idx = np.flatnonzero(flip)
        logits = r["logits"]
        gaps = logits[idx, r["top1"][idx]] - logits[idx, g["top1"][idx]]
        limit = gap[0] + gap[1] * np.abs(logits[idx, r["top1"][idx]])
        fresh = ~tainted[windows[idx]]
        if (fresh & (gaps >= limit)).any():
            worst = idx[fresh & (gaps >= limit)][0]
            raise AssertionError(
                f"block {block}: token {worst} routed to {r['top1'][worst]} and "
                f"{g['top1'][worst]}, logit gap {logits[worst, r['top1'][worst]] - logits[worst, g['top1'][worst]]:.3e} "
                f"above the rounding gate {gap}")
        shift = (r["keep"] != g["keep"]) & ~flip
        first_flip = np.full(logits.shape[-1], n)
        for experts in (r["top1"][idx], g["top1"][idx]):
            np.minimum.at(first_flip, experts, idx)
        unexplained = np.flatnonzero(shift)[first_flip[r["top1"][shift]] >= np.flatnonzero(shift)]
        if len(unexplained):
            raise AssertionError(f"block {block}: token {unexplained[0]} kept by one side only "
                                 f"with no earlier flip into or out of its expert")
        tainted[windows[flip | shift]] = True
        report["flips"].append(int(flip.sum()))
        report["capacity_shifts"].append(int(shift.sum()))
        if len(idx):
            report["max_flip_gap"] = max(report["max_flip_gap"], float(gaps.max()))
    report["windows_tainted"] = int(tainted.sum())
    return tainted, report


def moe_compare(label: str, ref: tuple, got: tuple, tokens_per_window: int, dtype: str,
                tol: float) -> dict:
    """``ref`` and ``got``, each (outputs by window, numpy routing records):
    :func:`routing_gate` first, then the outputs of the untainted windows
    within ``tol`` of ``ref``'s largest entry. Returns the counts and the
    error."""
    tainted, report = routing_gate(ref[1], got[1], tokens_per_window, MOE_FLIP_GAP[dtype])
    ref_out, got_out = np.asarray(ref[0]), np.asarray(got[0])
    clean = ~tainted[:len(ref_out)]
    err = float(np.abs(got_out[clean] - ref_out[clean]).max() / np.abs(ref_out).max())
    report.update(max_rel_err=err, windows_compared=int(clean.sum()),
                  max_rel_err_all_windows=float(np.abs(got_out - ref_out).max()
                                                / np.abs(ref_out).max()))
    print(f"{label}: routing flips by block {report['flips']} (largest logit gap "
          f"{report['max_flip_gap']:.3e}, gate {MOE_FLIP_GAP[dtype]}), capacity shifts "
          f"{report['capacity_shifts']}, {report['windows_tainted']} windows tainted; max rel "
          f"err {err:.3e} over {report['windows_compared']} windows (gate {tol:g}; over every "
          f"window, ungated: {report['max_rel_err_all_windows']:.3e})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{label}: max rel err {err} over the untainted windows")
    return report


def moe_load(routing: list) -> list:
    """Each block's capacity, tokens dropped (over capacity) and tokens
    routed to each expert, from numpy routing records."""
    return [{"capacity": r["capacity"], "tokens": int(r["top1"].size),
             "dropped": int((~r["keep"]).sum()),
             "dropped_share": float((~r["keep"]).mean()),
             "expert_load": np.bincount(r["top1"].ravel(),
                                        minlength=r["logits"].shape[-1]).tolist()}
            for r in routing]


def _moe_direct(module, X: np.ndarray, device: str) -> tuple:
    """A request's (outputs of its real windows, numpy routing) through the
    model's direct predict, as ``predict_fn`` pads it."""
    import torch

    from gordo_tpu_torch.ops.predict import pad_for_predict, unfold_windows

    X_pad, n_pad, n_keep = pad_for_predict(module.spec, X)
    with torch.inference_mode():
        windows = unfold_windows(module.spec, torch.from_numpy(X_pad).to(device), n_pad)
        out, routing = module.forward_with_routing(windows)
    return out[:n_keep].cpu().numpy(), _routing_numpy(routing)


def _moe_fused(spec, modules: list, inputs: list, device: str) -> list:
    """The fused call of these requests (one padded shape) recomputed as
    the batcher makes it, ``stacked_forward`` on the models' stacked
    parameters: each lane's (outputs of its real windows, numpy routing)."""
    import torch

    from gordo_tpu_torch.ops.nn import stacked_forward
    from gordo_tpu_torch.ops.predict import pad_for_predict, unfold_windows

    padded = [pad_for_predict(spec, X) for X in inputs]
    n_pad = padded[0][1]
    with torch.inference_mode():
        params = [{name: torch.stack([m.layer_params[i][name] for m in modules])
                   for name in layer} for i, layer in enumerate(modules[0].layer_params)]
        X = torch.from_numpy(np.stack([p[0] for p in padded])).to(device)
        routing: list = []
        out = stacked_forward(spec, params, unfold_windows(spec, X, n_pad), routing)
        out = out.cpu().numpy()
    return [(out[m, :p[2]], _routing_numpy(routing, m)) for m, p in enumerate(padded)]


def moe_served(card: str, collection: Path, names: dict, device: str = "cuda") -> dict:
    """The built moe-transformer-ae-512 artifacts (``names``: dtype ->
    name) served as ``run-server`` serves them, direct then with the
    batcher forced on: MOE_ROUNDS 1,535-row anomaly requests each
    (:func:`_served_run`'s checks). The served answers must be the model's
    direct predict and the same request's fused lane (recomputed with
    their routing); then, routing first (:func:`moe_compare`), the fused
    lane against the direct predict within the dtype's tolerance
    (TOL_OUT_REL, TOL_BF16_MODEL_REL), and the direct predict against the
    same model with plain attention within TOL_MODEL_REL (bf16
    TOL_BF16_MODEL_REL). Then one fused call of BATCHER_MODELS full-width
    requests (8,192 windows) against their direct predicts, lane by lane,
    with its peak device memory. Reports the tokens dropped per block and
    each expert's load. Returns p50s, the comparisons, the loads, memory
    and forward launches."""
    import torch

    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.server import batcher
    from gordo_tpu_torch.server.server import make_server

    previous = os.environ.get("GORDO_TPU_SERVING_BATCH")
    server = make_server("127.0.0.1", 0, device=device, collection_dir=str(collection))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    project = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/smoke"
    rng = np.random.RandomState(SEED + 40)
    lookback = MOE_CONFIG["lookback_window"]
    result = {}
    try:
        for dtype, name in names.items():
            tol = TOL_BF16_MODEL_REL if dtype == "bfloat16" else TOL_OUT_REL
            plain_tol = TOL_BF16_MODEL_REL if dtype == "bfloat16" else TOL_MODEL_REL
            values = _series(FULL_ROWS, 90000, rng)
            body = _rect_body(values)
            n_out = FULL_ROWS - lookback + 1
            runs = {mode: _served_run(card, project, [(name, body)] * MOE_ROUNDS, 1, mode,
                                      dtype, MOE_CONFIG["num_blocks"], n_out,
                                      f"moe-transformer-ae-512 ({FULL_ROWS} rows)",
                                      must_fuse=False)
                    for mode in ("0", "1")}
            os.environ["GORDO_TPU_SERVING_BATCH"] = "0"
            batcher.reset_batcher()
            detector = server.models[name].detector
            estimator, scaler = (detector.base_estimator.steps[-1][1],
                                 detector.base_estimator.steps[0][1])
            X = scaler.transform(values).astype(np.float32)
            direct = _moe_direct(estimator.module_, X, device)
            fused = _moe_fused(estimator.spec_, [estimator.module_], [X], device)[0]
            plain_model = TransformerAutoEncoder(**MOE_CONFIG).load_params(
                _with_attention(estimator.spec_, "xla"), estimator.module_.params_numpy(), device)
            plain = _moe_direct(plain_model.module_, X, device)
            served = {mode: _max_rel(runs[mode]["outputs"], [out] * MOE_ROUNDS)
                      for mode, out in (("0", direct[0]), ("1", fused[0]))}
            print(f"moe-transformer-ae-512 served ({dtype}) on {card}: p50 direct "
                  f"{runs['0']['p50_ms']:.2f} ms, fused {runs['1']['p50_ms']:.2f} ms; served "
                  f"answers against their recomputed direct and fused lanes, max rel "
                  f"{served}", flush=True)
            if not all(err <= 1e-6 for err in served.values()):
                raise AssertionError(f"moe ({dtype}): the served answers are not the "
                                     f"recomputed lanes: {served}")
            compared = {
                "fused_vs_direct": moe_compare(f"moe {dtype} fused lane vs direct", direct,
                                               fused, lookback, dtype, tol),
                "direct_vs_plain_attention": moe_compare(
                    f"moe {dtype} direct vs plain attention", plain, direct, lookback, dtype,
                    plain_tol)}
            load = moe_load(direct[1])
            print(f"moe-transformer-ae-512 ({dtype}) routing of one {FULL_ROWS}-row request "
                  f"({load[0]['tokens'] // lookback} padded windows): {load}", flush=True)
            lanes = moe_lanes(card, estimator, dtype, rng, tol, device)
            result[dtype] = {
                "p50_ms": {"direct": runs["0"]["p50_ms"], "fused": runs["1"]["p50_ms"]},
                "max_ms": {"direct": runs["0"]["max_ms"], "fused": runs["1"]["max_ms"]},
                "served_vs_recomputed": served, "compared": compared, "routing": load,
                "lanes": lanes,
                "forward_launches": runs["0"]["forward_launches"] + runs["1"]["forward_launches"]
                + lanes["forward_launches"],
                "fused_calls": runs["1"]["fused_calls"]}
            del plain_model
            torch.cuda.empty_cache()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        batcher.reset_batcher()
        if previous is None:
            os.environ.pop("GORDO_TPU_SERVING_BATCH", None)
        else:
            os.environ["GORDO_TPU_SERVING_BATCH"] = previous
    return result


def moe_lanes(card: str, estimator, dtype: str, rng, tol: float, device: str = "cuda") -> dict:
    """BATCHER_MODELS full-width requests of the model queued on a fresh
    batcher at once (one fused call of 8,192 windows, each lane at the
    direct predict's capacity) against their direct predicts: the call's
    peak device memory above its start, the answers equal to the call
    recomputed with its routing, and each lane against its direct predict
    routing first (:func:`moe_compare`, ``tol``). Returns the memory, the
    comparisons and the call's forward launches."""
    import torch

    from gordo_tpu_torch.server import batcher

    inputs = [_series(FULL_ROWS, 95000 + 2000 * m, rng).astype(np.float32)
              for m in range(BATCHER_MODELS)]
    fused = batcher.CrossModelBatcher()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    answers = _queued(fused, [(estimator, X) for X in inputs])
    seconds = time.perf_counter() - t0
    fused_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    launched = _launches(dtype)["forward"]
    calls = list(fused.calls)
    recomputed = _moe_fused(estimator.spec_, [estimator.module_] * len(inputs), inputs, device)
    same = _max_rel(answers, [lane[0] for lane in recomputed])
    if len(calls) != 1 or same > 1e-6:
        raise AssertionError(f"moe fused call: {calls}, answers against the recomputed call "
                             f"{same}")
    compared, dropped = [], []
    for m, X in enumerate(inputs):
        direct = _moe_direct(estimator.module_, X, device)
        compared.append(moe_compare(f"moe {dtype} fused lane {m} of {len(inputs)} vs direct",
                                    direct, recomputed[m], MOE_CONFIG["lookback_window"],
                                    dtype, tol))
        dropped.append([b["dropped"] for b in moe_load(recomputed[m][1])])
    out = {"fused_calls": calls, "fused_gib": fused_gib,
           "fused_mib_per_window": fused_gib * 1024 / calls[0][1], "fused_s": seconds,
           "dropped_by_lane": dropped, "compared": compared, "forward_launches": launched}
    print(f"moe fused call on {card} ({dtype}): (width, windows) {calls} peaks "
          f"{fused_gib:.3f} GiB above its start ({out['fused_mib_per_window']:.3f} MiB a "
          f"window) in {seconds:.3f} s; tokens dropped by lane and block {dropped}", flush=True)
    return out


def moe_fleet(card: str, root: Path, device: str = "cuda") -> dict:
    """A stacked two-machine bucket of each MoE configuration against the
    serial trainer (:func:`fleet_loss_check`, its one-batch gate routing
    first), then ``batch-build`` (``cli.batch_build``, in this process) of
    MOE_FLEET_MACHINES moe-transformer-ae-512 and as many moe_model_144
    machines: exit 0, every machine an artifact, none built serially, two
    stacked programs, one configuration each; float32 dQ and dK/dV once
    per block a stacked step of each, at dh 64 and dh 16 (the flash
    kernels' dh-16 class) by the wrapper's head-dim tally; no bf16 launch
    and no plain attention; each machine's thresholds finite and its
    held-out error below its seeded weights'. Returns the checks, the wall,
    the stacked programs and the launches by dh."""
    import contextlib
    import io

    import torch

    from gordo_tpu_torch import cli, serializer
    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.ops import flash_attention as fa
    from gordo_tpu_torch.parallel import batch_trainer as bt

    stacked = {}
    for label, model in (("moe-transformer-ae-512", MOE_CONFIG),
                         ("moe_model_144", MOE144_CONFIG)):
        _reset_launches()
        with _PlainAttentionCalls() as plain:
            stacked[label] = fleet_loss_check(card, device, config=model)
        stacked[label]["launches"] = {dtype: _launches(dtype) for dtype in COUNTERS}
        stacked[label]["launches_by_head_dim"] = {
            f"{name}@{dh}": n for (name, dh), n in sorted(fa.HEAD_DIM_LAUNCHES.items())}
        if plain.calls:
            raise AssertionError(f"the {label} stacked check reached plain attention")
    names = {label: [f"{label.replace('_', '-')}-{i}" for i in range(MOE_FLEET_MACHINES)]
             for label in ("moe-transformer-ae-512", "moe_model_144")}
    configs = [build_config(n, tags=[f"{n}-tag-{j}" for j in range(len(TAGS))],
                            base=MOE_CONFIG if label.startswith("moe-") else MOE144_CONFIG)
               for label, members in names.items() for n in members]
    config = root / "moe-fleet.json"
    config.write_text(json.dumps({"machines": configs}))
    output = root / "moe-fleet"
    shutil.rmtree(output, ignore_errors=True)
    specs = {label: TransformerAutoEncoder(**model).build_spec(len(TAGS), len(TAGS))
             for label, model in (("moe-transformer-ae-512", MOE_CONFIG),
                                  ("moe_model_144", MOE144_CONFIG))}
    chunks, serial = [], []
    build_chunk, serial_build = (bt.BatchedModelBuilder._build_chunk,
                                 bt.BatchedModelBuilder._serial_build)

    def recorded_chunk(self, group, *args, **kwargs):
        chunks.append({"names": [p.machine.name for p in group], "spec": group[0].spec,
                       "n_rows": len(group[0].X)})
        return build_chunk(self, group, *args, **kwargs)

    def recorded_serial(self, machine):
        serial.append(machine.name)
        return serial_build(self, machine)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    bt.BatchedModelBuilder._build_chunk = recorded_chunk
    bt.BatchedModelBuilder._serial_build = recorded_serial
    stdout = io.StringIO()
    try:
        with _PlainAttentionCalls() as plain, contextlib.redirect_stdout(stdout):
            t0 = time.perf_counter()
            code = cli.batch_build(str(config), str(output), "smoke-moe", device=device)
            seconds = time.perf_counter() - t0
    finally:
        bt.BatchedModelBuilder._build_chunk = build_chunk
        bt.BatchedModelBuilder._serial_build = serial_build
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {dtype: _launches(dtype) for dtype in COUNTERS}
    by_dh = dict(fa.HEAD_DIM_LAUNCHES)
    built = [line for line in stdout.getvalue().splitlines() if line.startswith("built: ")]
    artifacts = sum((output / c["name"] / "model.json").exists() for c in configs)
    expected = {}
    for chunk in chunks:
        label = next(k for k, spec in specs.items() if spec == chunk["spec"])
        if sorted(chunk["names"]) != names[label]:
            raise AssertionError(f"the MoE buckets: {[c['names'] for c in chunks]}")
        dh = specs[label].layers[2].d_model // specs[label].layers[2].num_heads
        expected[dh] = _attention_blocks(chunk["spec"]) * _stage_steps(
            chunk["spec"], chunk["n_rows"], BATCH, 1)
    result = {"stacked": stacked, "machines": len(configs), "seconds": seconds,
              "peak_gib": peak, "stacked_programs": [c["names"] for c in chunks],
              "launches": launches, "launches_by_head_dim": {
                  f"{name}@{dh}": n for (name, dh), n in sorted(by_dh.items())},
              "serial_built": serial}
    print(f"moe batch-build of {len(configs)} machines ({MOE_FLEET_MACHINES} "
          f"moe-transformer-ae-512, {MOE_FLEET_MACHINES} moe_model_144) on {card}: exit {code} "
          f"in {seconds:.2f} s, {len(built)} built, {artifacts} artifacts, serial {serial}; "
          f"stacked programs {result['stacked_programs']}; peak device memory {peak:.2f} GiB; "
          f"launches by head dim {result['launches_by_head_dim']}", flush=True)
    if code != 0 or len(built) != len(configs) or artifacts != len(configs) or serial:
        raise AssertionError(f"moe batch-build exited {code}: {len(built)} built, {artifacts} "
                             f"artifacts, serially built {serial}")
    if len(chunks) != 2 or any(launches["bfloat16"].values()) or plain.calls:
        raise AssertionError(f"moe batch-build: programs {result['stacked_programs']}, "
                             f"launches {launches}, plain attention {plain.calls}")
    for dh, n in expected.items():
        if not (by_dh.get(("DQ_LAUNCHES", dh)) == by_dh.get(("DKV_LAUNCHES", dh)) == n
                and by_dh.get(("LAUNCHES", dh), 0) >= n):
            raise AssertionError(f"expected {n} float32 dQ and dK/dV launches at dh {dh}, got "
                                 f"{result['launches_by_head_dim']}")
    held_out = {}
    for label, members in names.items():
        for name in members:
            model = serializer.load(str(output / name), device)
            spec = model.base_estimator.steps[-1][1].spec_
            mse = held_out_mse(model, spec, _config_rows(configs[0]),
                               tags=serializer.load_model_json(str(output / name))["tags"])
            thresholds = [*model.feature_thresholds_, model.aggregate_threshold_]
            if not (all(math.isfinite(x) for x in thresholds) and mse["trained"] < mse["seeded"]):
                raise AssertionError(f"{name}: thresholds {thresholds}, held-out {mse}")
            held_out[name] = mse
    result["held_out_mse"] = held_out
    print(f"moe fleet machines' held-out scaled MSE (trained, seeded) on {card}: "
          f"{ {n: (round(e['trained'], 6), round(e['seeded'], 6)) for n, e in held_out.items()} }",
          flush=True)
    return result


def moe_path(card: str, root: Path, device: str = "cuda") -> dict:
    """The Switch-MoE Transformer on the card: moe-transformer-ae-512 built
    by the CLI in float32 and bf16 (:func:`cli_model_build`: the dtype's
    flash forward, dQ and dK/dV at dh 64 and nothing else), both artifacts
    served direct and fused (:func:`moe_served`), the fleet
    (:func:`moe_fleet`: stacked buckets against serial, and a
    ``batch-build`` whose moe_model_144 bucket runs the dh-16 class), and
    the six flash kernels at dh 16 timed at that bucket's shape (BH 256, T
    144; :func:`head_dim_times`). Returns each part's numbers and the
    launches by dtype, part and head dim."""
    shutil.rmtree(root, ignore_errors=True)
    collection = root / "collection"
    collection.mkdir(parents=True)
    t0 = time.perf_counter()
    builds = {dtype: cli_model_build(card, collection, dtype, MOE_CONFIG,
                                     "moe-transformer-ae-512", device) for dtype in COUNTERS}
    served = moe_served(card, collection, {dtype: b["name"] for dtype, b in builds.items()},
                        device)
    dropped = sum(b["dropped"] for r in served.values() for b in r["routing"])
    if not dropped:
        raise AssertionError("no token of the served requests went over its expert's capacity")
    fleet = moe_fleet(card, root, device)
    times = {dtype: head_dim_times(card, dtype, dims=(16,), bhs=MOE_TIMED_BH,
                                   t=MOE144_CONFIG["lookback_window"]) for dtype in COUNTERS}
    seconds = time.perf_counter() - t0
    print(f"moe phase: {seconds:.1f} s", flush=True)
    stacked = fleet["stacked"]
    launches = {dtype: {
        "build": builds[dtype]["launches"],
        "served": {"forward": served[dtype]["forward_launches"]},
        "stacked_dh64": stacked["moe-transformer-ae-512"]["launches"][dtype],
        "stacked_dh16": stacked["moe_model_144"]["launches"][dtype]} for dtype in COUNTERS}
    return {"build": builds, "served": served, "fleet": fleet, "times_dh16": times,
            "launches": launches, "seconds": seconds}


def moe_entries(entries: list, moe: dict) -> list:
    """The MoE paths' launches in the ``kernels`` line: each of the six
    flash ``entries`` (dh 64) gets moe-transformer-ae-512's builds, serving
    (the forward), stacked checks and bucket of the MoE ``batch-build``;
    returns six entries of the same kernels at dh 16 (their class at
    moe_model_144's stacked step: timed by :func:`moe_path`, launched by its
    stacked checks and its bucket)."""
    fleet_by_dh = moe["fleet"]["launches_by_head_dim"]
    dh16_entries = []
    for entry in entries:
        dtype = entry["dtype"]
        kernel = next(k for k, n in ENTRY_NAMES.items() if entry["name"] in (n, n + "_bf16"))
        counter = COUNTERS[dtype][list(ENTRY_NAMES).index(kernel)]
        paths = moe["launches"][dtype]
        entry["launches_by_path"].update({
            "moe_build": paths["build"][kernel], "moe_stacked": paths["stacked_dh64"][kernel],
            "moe_fleet": fleet_by_dh.get(f"{counter}@64", 0)})
        if kernel == "forward":
            entry["launches_by_path"]["moe_served"] = paths["served"]["forward"]
        timed = moe["times_dh16"][dtype][kernel][16][MOE_TIMED_BH[0]]
        dh16_entries.append({
            "name": f"{entry['name']}_dh16", "route": "cuda", "source": entry["source"],
            "replaces": entry["replaces"], "dtype": dtype, "head_dim": 16,
            "head_dim_class": _head_dim_class(entry["name"], 16),
            "launches_by_path": {"moe_fleet": fleet_by_dh.get(f"{counter}@16", 0),
                                 "moe_stacked": paths["stacked_dh16"][kernel]},
            "max_abs_err": max(v["max_abs_err"] for k, v in timed["against_plain"].items()
                               if k != "lse"),
            **{key: timed[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                           "bound_by", "shape", "achieved_tflop_s",
                                           "bound_share", "plain_and_library_compute")}})
    return dh16_entries


# ------------------------------------------- telemetry and observability
OBS_USERS = 16
OBS_REQUESTS = 2  # full-width anomaly requests a user, the two dtypes' models in turn
OBS_TRACED_EVERY = 4  # every fourth request sends a traceparent
OBS_SLOW_S = "0.001"  # GORDO_TPU_FLIGHT_SLOW_S: a full-width request is slower
OBS_SLO_P99_MS = "250"
OBS_DEVICE_TRACE_S = 2.0
OBS_BUSY_TOL = 0.10  # busy seconds against the profiler's kernel union
OBS_BUSY_REQUESTS = 3  # a user, in the burst the busy gate profiles
OBS_MODELS = ("transformer-ae-512", "transformer-ae-512-bf16")
OBS_PROJECT = "smoke"
OBS_KNOBS = ("GORDO_TPU_DEBUG_ENDPOINTS", "ENABLE_PROMETHEUS", "PROJECT", "GORDO_TPU_SLO_P99_MS",
             "GORDO_TPU_LOG_FORMAT", "GORDO_TPU_FLIGHT_SLOW_S", "GORDO_TPU_FAST_LANE",
             "GORDO_TPU_FAST_LANE_EVENT_LOOP", "GORDO_TPU_SERVING_BATCH", "GORDO_TPU_PROFILE_DIR")
ANOMALY_RULE = "/gordo/v0/<gordo_project>/<gordo_name>/anomaly/prediction"
# the trace ids the traffic sends (every OBS_TRACED_EVERY-th request's)
OBS_SENT = {f"{0x0b5e0000 + i:032x}" for i in range(0, 4 * OBS_USERS * OBS_REQUESTS,
                                                     OBS_TRACED_EVERY)}


def _obs_post(url: str, body: bytes, traceparent: str = None) -> tuple:
    """``(status, X-Gordo-Trace, body, ms)`` of one POST."""
    headers = {"Content-Type": "application/json"}
    if traceparent:
        headers["traceparent"] = traceparent
    req = urllib.request.Request(url, data=body, headers=headers)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, trace, answer = resp.status, resp.headers.get("X-Gordo-Trace"), resp.read()
    except urllib.error.HTTPError as err:
        status, trace, answer = err.code, err.headers.get("X-Gordo-Trace"), err.read()
    return status, trace, answer, 1e3 * (time.perf_counter() - t0)


def _obs_get(url: str) -> tuple:
    """``(status, X-Gordo-Trace, body)`` of one GET, which must carry a trace
    id like every answer of the server."""
    status, body, headers, _ = _request(url)
    trace = headers.get("X-Gordo-Trace")
    if not trace or not re.fullmatch(r"[0-9a-f]{32}", trace):
        raise AssertionError(f"GET {url}: {status} without X-Gordo-Trace")
    return status, trace, body


def _obs_traffic(base: str, bodies: dict, models=OBS_MODELS, users: int = OBS_USERS,
                 requests: int = OBS_REQUESTS) -> list:
    """``users`` threads each POSTing ``requests`` full-width anomaly
    requests, the ``models`` in turn, every OBS_TRACED_EVERY-th with a
    traceparent of its own. Returns ``[(model, sent trace id or None,
    status, X-Gordo-Trace, ms)]``."""
    jobs = []
    for r in range(requests):
        for u in range(users):
            i = r * users + u
            trace = f"{0x0b5e0000 + i:032x}" if i % OBS_TRACED_EVERY == 0 else None
            jobs.append((models[i % len(models)], trace))
    results = [None] * len(jobs)

    def user(u):
        for i in range(u, len(jobs), users):
            model, trace = jobs[i]
            parent = f"00-{trace}-{'5a' * 8}-01" if trace else None
            status, echoed, _, ms = _obs_post(f"{base}/gordo/v0/{OBS_PROJECT}/{model}/"
                                              "anomaly/prediction", bodies[model], parent)
            results[i] = (model, trace, status, echoed, ms)

    threads = [threading.Thread(target=user, args=(u,)) for u in range(users)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return results


def _prom(text: str, family: str) -> dict:
    """``{labels: value}`` of one family's samples in a text exposition."""
    out = {}
    for line in text.splitlines():
        if line.startswith(family + "{") or line.startswith(family + " "):
            head, value = line.split(" # ", 1)[0].rsplit(" ", 1)
            labels = tuple(sorted(re.findall(r'(\w+)="([^"]*)"', head)))
            out[labels] = float(value)
    return out


def _percentiles(ms: list) -> dict:
    ms = sorted(ms)
    return {"p50_ms": ms[len(ms) // 2], "p99_ms": ms[min(len(ms) - 1, int(0.99 * len(ms)))],
            "requests": len(ms)}


def _kernel_union_s(trace: dict, symbol: str) -> tuple:
    """The union of the kernel intervals (seconds) on the stream that ran
    ``symbol`` in a ``torch.profiler`` Chrome trace, and that stream's
    kernel count."""
    kernels = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    streams = {e["args"].get("stream") for e in kernels if symbol in e["name"]}
    if len(streams) != 1:
        raise AssertionError(f"{symbol} ran on streams {streams} in the profiled burst")
    stream = streams.pop()
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels
                   if e["args"].get("stream") == stream)
    total, end = 0.0, None
    for start, stop in spans:
        if end is None or start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total / 1e6, len(spans)


class _ObsServer:
    """The collection served as ``run-server`` serves it (batching on), on
    the default lane or, with ``lane="loop"``, the fast lane's event loop."""

    def __init__(self, collection: Path, lane: str, device: str):
        from gordo_tpu_torch import cli
        from gordo_tpu_torch.server import batcher
        from gordo_tpu_torch.server.server import make_front_end

        cli.prepare_run_server(True)
        # batching forced on, as the batcher phases force it: run-server's
        # auto A/B may stand a spec down, and the phase's gates read fused calls
        os.environ["GORDO_TPU_SERVING_BATCH"] = "1"
        os.environ["GORDO_TPU_FAST_LANE"] = "1" if lane == "loop" else "0"
        os.environ["GORDO_TPU_FAST_LANE_EVENT_LOOP"] = "1"
        batcher.reset_batcher()
        self.app, self.server = make_front_end("127.0.0.1", 0, device, str(collection))
        port = getattr(self.server, "server_port", None) or self.server.server_address[1]
        self.base = f"http://127.0.0.1:{port}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        from gordo_tpu_torch.server import batcher

        self.server.shutdown()
        self.server.server_close()
        if self.app is not self.server:
            self.app.server_close()
        self.thread.join(timeout=60)
        batcher.reset_batcher()


def _obs_knobs_on() -> None:
    os.environ.update(GORDO_TPU_DEBUG_ENDPOINTS="1", ENABLE_PROMETHEUS="1", PROJECT=OBS_PROJECT,
                      GORDO_TPU_SLO_P99_MS=OBS_SLO_P99_MS, GORDO_TPU_LOG_FORMAT="json",
                      GORDO_TPU_FLIGHT_SLOW_S=OBS_SLOW_S)


def _obs_lane(card: str, collection: Path, bodies: dict, lane: str, device: str) -> dict:
    """One lane with every knob on: the traffic, the 404 and the 400, then
    the gates on its responses, ``/metrics``, the batcher's telemetry, the
    device block, ``/debug/flight`` and ``/debug/slo`` (module docstring,
    step 20). Returns the lane's numbers and, while it runs, the server."""
    import torch

    from gordo_tpu_torch.observability import device as device_telemetry
    from gordo_tpu_torch.observability import flight, profiler, shared, slo, telemetry
    from gordo_tpu_torch.observability import metrics as catalog
    from gordo_tpu_torch.ops import flops
    from gordo_tpu_torch.server import batcher

    for module in (telemetry, slo, flight):
        module.reset()
    profiler.reset()
    device_telemetry.reset_for_tests()
    shared.reset_for_tests()
    served = _ObsServer(collection, lane, device)
    try:
        base = served.base
        device_telemetry.sample()
        busy0 = catalog.DEVICE_BUSY_SECONDS.value()
        t0 = time.perf_counter()
        results = _obs_traffic(base, bodies)
        wall = time.perf_counter() - t0
        missing = _obs_post(f"{base}/gordo/v0/{OBS_PROJECT}/no-such-machine/anomaly/prediction",
                            bodies[OBS_MODELS[0]], f"00-{'e4' * 16}-{'5a' * 8}-01")
        malformed = _obs_post(f"{base}/gordo/v0/{OBS_PROJECT}/{OBS_MODELS[0]}/anomaly/"
                              "prediction", b'{"X": [[1.0, 2.0', f"00-{'e0' * 16}-{'5a' * 8}-01")
        statuses = [r[2] for r in results]
        if any(s != 200 for s in statuses) or (missing[0], malformed[0]) != (404, 400):
            raise AssertionError(f"observability traffic ({lane}): {statuses}, 404 -> "
                                 f"{missing[0]}, 400 -> {malformed[0]}")
        answers = [(r[1], r[3]) for r in results] + [("e4" * 16, missing[1]),
                                                      ("e0" * 16, malformed[1])]
        for sent, echoed in answers:
            if not echoed or not re.fullmatch(r"[0-9a-f]{32}", echoed) or (sent and echoed != sent):
                raise AssertionError(f"{lane}: X-Gordo-Trace {echoed!r} for traceparent {sent}")
        status, _, metrics = _obs_get(f"{base}/metrics")
        if status != 200:
            raise AssertionError(f"{lane}: /metrics answered {status}")
        text = metrics.decode()
        n_ok = len(results)
        # the reference's labels: every request by rule, status and model
        expected = {(("gordo_name", m), ("method", "POST"), ("path", ANOMALY_RULE),
                     ("project", OBS_PROJECT), ("status_code", "200")):
                    float(sum(r[0] == m for r in results)) for m in OBS_MODELS}
        expected[(("gordo_name", ""), ("method", "POST"), ("path", ANOMALY_RULE),
                  ("project", OBS_PROJECT), ("status_code", "404"))] = 1.0
        expected[(("gordo_name", OBS_MODELS[0]), ("method", "POST"), ("path", ANOMALY_RULE),
                  ("project", OBS_PROJECT), ("status_code", "400"))] = 1.0
        counted = _prom(text, "gordo_server_requests_total")
        fleet = _prom(text, "gordo_server_fleet_requests_total")
        fleet_expected = {(("endpoint", ANOMALY_RULE), ("status", "2xx")): float(n_ok),
                          (("endpoint", ANOMALY_RULE), ("status", "4xx")): 2.0}
        if counted != expected or fleet != fleet_expected:
            raise AssertionError(f"{lane}: /metrics counted {counted} and {fleet}, not "
                                 f"{expected} and {fleet_expected}")
        fused = batcher.peek_batcher()
        calls = fused.stats["device_calls"]
        widths = catalog.BATCHER_FUSE_WIDTH.count()
        fpp = flops.forward_flops_per_sample(next(iter(fused.spec_calls)))
        analytic = fpp * sum(windows for _, windows in fused.calls)
        achieved = catalog.DEVICE_FLOPS.value()
        if widths != calls or abs(achieved - analytic) > 1e-9 * analytic:
            raise AssertionError(f"{lane}: fuse widths {widths} for {calls} fused calls; "
                                 f"FLOPs {achieved} against {analytic}")
        status, _, body = _obs_get(f"{base}/debug/vars")
        device_block = json.loads(body)["device"]
        quiescent = torch.cuda.memory_allocated(0)
        in_use = catalog.DEVICE_MEMORY.value(device="0", stat="bytes_in_use")
        busy = catalog.DEVICE_BUSY_SECONDS.value() - busy0
        # the duty cycle and MFU of the sampling interval that /metrics closed:
        # the traffic's (a later sample covers the idle time after it)
        ratio = _prom(text, "gordo_server_device_busy_ratio")[()]
        mfu = _prom(text, "gordo_server_device_mfu")[()]
        if not (0 < ratio <= 1 and 0 < busy <= wall and 0 < mfu < 1):
            raise AssertionError(f"{lane}: busy ratio {ratio}, busy {busy} s in {wall} s, "
                                 f"MFU {mfu}")
        if in_use != quiescent:
            raise AssertionError(f"{lane}: bytes_in_use {in_use} != memory_allocated {quiescent}")
        status, _, body = _obs_get(f"{base}/debug/flight")
        doc = json.loads(body)
        kept = {(r["status"], r["class"]): r for r in doc["gordoFlight"]}
        slow = [r["trace_id"] for r in doc["gordoFlight"] if r["class"] == "slow"
                and r["trace_id"] in OBS_SENT]
        if (404, "error") not in kept or (400, "error") not in kept or not slow:
            raise AssertionError(f"{lane}: /debug/flight kept {sorted(kept)}")
        names = {}
        for trace_id in slow:  # a kept slow trace whose device call is linked into it
            names = {e["name"]: e for e in doc["traceEvents"]
                     if e["args"]["trace_id"] == trace_id}
            call, queue = names.get("serve_device_call"), names.get("serve_batch_queue")
            # on the default lane a fused call's span links its co-riders;
            # the event loop fuses no two requests
            if (call and queue and call["args"]["parent_span_id"] == queue["args"]["span_id"]
                    and (lane == "loop" or call["args"].get("links"))):
                break
        else:
            raise AssertionError(f"{lane}: no kept slow trace holds its linked device call: "
                                 f"{sorted(names)}")
        status, _, body = _obs_get(f"{base}/debug/slo")
        slo_models = json.loads(body)["local"]["models"]
        if not set(OBS_MODELS) <= set(slo_models):
            raise AssertionError(f"{lane}: /debug/slo reports {sorted(slo_models)}")
        lane_numbers = {
            "wall_s": wall, **_percentiles([r[4] for r in results]),
            "fused_calls": calls, "fuse_width_count": widths,
            "largest_batch": fused.stats["largest_batch"], "flops": achieved,
            "flops_analytic": analytic, "busy_s": busy, "busy_ratio": ratio, "online_mfu": mfu,
            "bytes_in_use": in_use, "peak_bytes_in_use": catalog.DEVICE_MEMORY.value(
                device="0", stat="peak_bytes_in_use"),
            "param_bank_bytes": device_block["param_bank_bytes"],
            "flight_kept": len(doc["gordoFlight"]), "slow_trace_spans": sorted(names),
            "slo_5m": {m: slo_models[m]["5m"] for m in OBS_MODELS}}
        print(f"observability ({lane} lane) on {card}: {len(results)} requests + 404 + 400 in "
              f"{wall:.3f} s, p50 {lane_numbers['p50_ms']:.1f} ms p99 "
              f"{lane_numbers['p99_ms']:.1f} ms; {calls} fused calls; busy {busy:.4f} s "
              f"(ratio {ratio:.4f}), online MFU {mfu:.5f}, FLOPs {achieved:.6g}; bytes_in_use "
              f"{in_use}; flight kept {len(doc['gordoFlight'])}", flush=True)
        return lane_numbers, served
    except BaseException:
        served.close()
        raise


def _obs_busy_burst(served: _ObsServer, bodies: dict, root: Path,
                    requests: int = OBS_BUSY_REQUESTS) -> dict:
    """One burst of full-width float32 requests (16 users x ``requests``)
    under a ``torch.profiler`` capture: the batcher's busy seconds, the
    union of the kernel intervals on the dispatcher's stream, and the
    burst's latencies."""
    import torch
    from torch.profiler import profile

    from gordo_tpu_torch.observability import metrics as catalog
    from gordo_tpu_torch.util import profiling

    with profiling.SESSION_LOCK:
        busy0 = catalog.DEVICE_BUSY_SECONDS.value()
        with profile(activities=profiling.activities()) as prof:
            results = _obs_traffic(served.base, bodies, models=OBS_MODELS[:1],
                                   requests=requests)
            torch.cuda.synchronize()
        busy = catalog.DEVICE_BUSY_SECONDS.value() - busy0
        written = profiling.export(prof, str(root / "busy_burst_trace.json"))
    with open(written["path"]) as fh:
        trace = json.load(fh)
    union, n_kernels = _kernel_union_s(trace, "flash_forward_f32")
    if any(r[2] != 200 for r in results):
        raise AssertionError(f"profiled burst statuses {[r[2] for r in results]}")
    return {"busy_s": busy, "kernel_union_s": union, "kernels": n_kernels,
            "rel_diff": abs(busy - union) / union, "trace_bytes": written["bytes"],
            "trace": written["path"], "latency": _percentiles([r[4] for r in results])}


def _obs_busy_against_trace(card: str, served: _ObsServer, bodies: dict, root: Path) -> dict:
    """One steady burst (:func:`_obs_busy_burst`, 16 users x
    OBS_BUSY_REQUESTS, so that the dispatcher launches most calls while the
    one before runs): the busy seconds within OBS_BUSY_TOL of the union of
    the kernel intervals on the dispatcher's stream."""
    out = _obs_busy_burst(served, bodies, root)
    print(f"busy seconds against the profiled kernels on {card}: {out['busy_s']:.6f} s busy, "
          f"{out['kernel_union_s']:.6f} s kernel union on the dispatcher's stream "
          f"({out['kernels']} kernels), rel diff {out['rel_diff']:.4f} (tolerance "
          f"{OBS_BUSY_TOL})", flush=True)
    if out["rel_diff"] > OBS_BUSY_TOL:
        raise AssertionError(f"busy {out['busy_s']} s against kernel union "
                             f"{out['kernel_union_s']} s")
    return out


def _obs_profiles_under_load(card: str, served: _ObsServer, bodies: dict) -> dict:
    """``/debug/profile?device=1&seconds=2`` and a burst ``/debug/profile``
    while both models serve a steady load."""
    stop = threading.Event()
    statuses = []

    def user(u):
        model = OBS_MODELS[u % len(OBS_MODELS)]
        url = f"{served.base}/gordo/v0/{OBS_PROJECT}/{model}/anomaly/prediction"
        while not stop.is_set():
            statuses.append(_obs_post(url, bodies[model])[0])

    users = [threading.Thread(target=user, args=(u,), daemon=True) for u in range(8)]
    for t in users:
        t.start()
    try:
        time.sleep(1.0)  # the load is on
        status, _, body = _obs_get(f"{served.base}/debug/profile?device=1&seconds="
                                   f"{OBS_DEVICE_TRACE_S}")
        trace = json.loads(body)["device_trace"]
        status_burst, _, burst = _obs_get(f"{served.base}/debug/profile?seconds=0.5&hz=200")
    finally:
        stop.set()
        for t in users:
            t.join(timeout=300)
    if status != 200 or "error" in trace:
        raise AssertionError(f"/debug/profile?device=1 answered {status}: {trace}")
    kernels = trace["kernels"]
    wanted = ("flash_forward_f32", WGMMA_KERNELS["flash_attention_forward_bf16"][2])
    named = {symbol: sum(n for name, n in kernels.items() if symbol in name) for symbol in wanted}
    threads = {line.split(";", 1)[0] for line in json.loads(burst)["collapsed"]}
    print(f"device trace under load on {card}: {trace['files']} file, {trace['bytes']} bytes, "
          f"export {trace['export_s']:.2f} s, {sum(kernels.values())} kernel launches of "
          f"{len(kernels)} kernels, flash forwards {named}; burst profile threads "
          f"{sorted(threads)}; load statuses {sorted(set(statuses))}", flush=True)
    if not all(named.values()):
        raise AssertionError(f"the device trace names no flash forward of a dtype: {named}")
    if status_burst != 200 or "gordo-batcher" not in threads:
        raise AssertionError(f"the burst profile names no dispatcher thread: {threads}")
    if set(statuses) != {200}:
        raise AssertionError(f"requests under the profiler answered {sorted(set(statuses))}")
    return {"device_trace_bytes": trace["bytes"], "device_trace_export_s": trace["export_s"],
            "device_trace_kernel_launches": sum(kernels.values()), "flash_forwards": named,
            "burst_threads": sorted(threads)}


def _obs_overhead(card: str, collection: Path, bodies: dict, device: str, rounds: int = 1,
                  requests: int = OBS_REQUESTS) -> dict:
    """p50 and p99 of the same 16-user traffic (``requests`` a user) to each
    dtype's model with every telemetry knob unset and with every knob on,
    in turns (off, on, on, off) repeated ``rounds`` times, on the default
    lane (printed, not gated). Each model's ``summary`` holds the medians of
    the like turns, the spread of the like turns (the larger of the two
    settings' max - min) and whether the knobs' difference exceeds it."""
    out = {}
    for model in OBS_MODELS:
        runs = {"off": [], "on": []}
        for rnd in range(rounds):
            for turn, knobs in enumerate(("off", "on", "on", "off")):  # in turns: ABBA
                for knob in OBS_KNOBS:
                    os.environ.pop(knob, None)
                if knobs == "on":
                    _obs_knobs_on()
                served = _ObsServer(collection, "default", device)
                try:
                    _obs_traffic(served.base, bodies, models=(model,), requests=1)  # warm
                    results = _obs_traffic(served.base, bodies, models=(model,),
                                           requests=requests)
                finally:
                    served.close()
                if any(r[2] != 200 for r in results):
                    raise AssertionError(f"overhead run ({model}, knobs {knobs}) statuses")
                run = 2 * rnd + 1 + turn // 2
                key = f"{model}_knobs_{knobs}_{run}"
                out[key] = _percentiles([r[4] for r in results])
                runs[knobs].append(out[key])
                print(f"telemetry overhead on {card}: {model}, knobs {knobs} (run {run}): "
                      f"{out[key]}", flush=True)
        summary = {}
        for q in ("p50_ms", "p99_ms"):
            like = {knobs: [r[q] for r in turns] for knobs, turns in runs.items()}
            medians = {knobs: float(np.median(v)) for knobs, v in like.items()}
            spread = max(max(v) - min(v) for v in like.values())
            diff = medians["on"] - medians["off"]
            summary[q] = {"off": like["off"], "on": like["on"], "median_off": medians["off"],
                          "median_on": medians["on"], "on_minus_off": diff,
                          "like_spread": spread, "resolved": abs(diff) > spread}
        out[f"{model}_summary"] = summary
        print(f"telemetry overhead on {card}: {model}, {rounds} round(s) of ABBA, "
              f"{OBS_USERS} users x {requests} requests a turn: {summary}", flush=True)
    return out


def _obs_build(card: str, root: Path, device: str = "cuda") -> dict:
    """``batch-build`` of two transformer-ae-512 machines (16 days of rows)
    through the port's CLI with ``--trace-file``, ``--metrics-file`` and
    ``GORDO_TPU_PROFILE_DIR``: the spans, the phase labels, and the
    profile's dQ and dK/dV kernels."""
    from gordo_tpu_torch import cli
    from gordo_tpu_torch.observability import telemetry
    from gordo_tpu_torch.util import profiling

    for knob in OBS_KNOBS:
        os.environ.pop(knob, None)
    machines = []
    for m in range(2):
        config = build_config(f"transformer-ae-512-obs{m}", tags=FLEET_TAGS[m])
        config["dataset"]["train_end_date"] = "2020-01-17T00:00:00+00:00"
        machines.append(config)
    root.mkdir(parents=True, exist_ok=True)
    (root / "fleet.json").write_text(json.dumps({"machines": machines}))
    trace_file, metrics_file = root / "build_trace.json", root / "build_metrics.prom"
    os.environ["GORDO_TPU_PROFILE_DIR"] = str(root / "profile")
    telemetry.reset()
    started = time.perf_counter()
    try:
        code = cli.main(["--log-level", "WARNING", "batch-build", str(root / "fleet.json"),
                         str(root / "built"), "--project-name", OBS_PROJECT, "--trace-file",
                         str(trace_file), "--metrics-file", str(metrics_file),
                         *(["--device", device] if device != "cuda" else [])])
    finally:
        os.environ.pop("GORDO_TPU_PROFILE_DIR", None)
        telemetry.reset()
    wall = time.perf_counter() - started
    with open(trace_file) as fh:
        spans = {e["name"] for e in json.load(fh)["traceEvents"]}
    phases = {dict(labels)["phase"] for labels in _prom(metrics_file.read_text(),
                                                        "gordo_build_phase_seconds_count")}
    written = profiling.LAST_PROFILE
    kernels = written["kernels"] if written else {}
    named = {symbol: sum(n for name, n in kernels.items() if symbol in name)
             for symbol in ("flash_bwd_dq_f32", "flash_bwd_dkv_f32")}
    wanted = {"batched_build", "fetch", "validate", "compile", "train", "assemble", "serialize"}
    print(f"profiled batch-build on {card}: exit {code} in {wall:.1f} s; spans {sorted(spans)}; "
          f"phase labels {sorted(phases)}; torch.profiler trace {written and written['bytes']} "
          f"bytes, export {written and written['export_s']:.2f} s, dQ/dK/dV launches {named}",
          flush=True)
    if code != 0 or not wanted <= spans or not wanted - {"batched_build"} <= phases:
        raise AssertionError(f"batch-build: exit {code}, spans {spans}, phases {phases}")
    if not written or written["label"] != "batched-build" or not all(named.values()):
        raise AssertionError(f"the profiled build names no dQ or dK/dV kernel: {named}")
    return {"wall_s": wall, "spans": sorted(spans), "phases": sorted(phases),
            "trace_bytes": written["bytes"], "trace_export_s": written["export_s"],
            "backward_launches": named}


def observability_path(card: str, root: Path, batcher_root: Path, device: str = "cuda") -> dict:
    """The telemetry plane on the card (module docstring, step 20):
    ``transformer-ae-512`` and ``transformer-ae-512-bf16`` (the batcher
    phases' first artifacts) served as ``run-server`` serves them, every
    knob on, on the default lane then the event loop (:func:`_obs_lane`);
    on the default lane the busy seconds against a profiled burst, the
    device trace and a burst profile under load, and the JSON logs; the
    overhead of the knobs; the profiled ``batch-build``. Returns the
    numbers and the launches of the phase's kernels."""
    import logging
    from io import StringIO

    from gordo_tpu_torch.observability import logs

    started = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    collection = root / "1"
    collection.mkdir(parents=True)
    for model, dtype in zip(OBS_MODELS, ("float32", "bfloat16")):
        os.symlink(batcher_root / dtype / "1" / "batcher-m0", collection / model)
    rng = np.random.RandomState(SEED + 17)
    body = _rect_body(_series(FULL_ROWS, 120000, rng))
    bodies = {model: body for model in OBS_MODELS}
    saved = {knob: os.environ.get(knob) for knob in OBS_KNOBS}
    root_logger = logging.getLogger()
    saved_handlers, saved_level = list(root_logger.handlers), root_logger.level
    server_logger = logging.getLogger("gordo_tpu_torch.server.server")
    log = StringIO()
    _reset_launches()
    try:
        _obs_knobs_on()
        # the JSON log lines of the phase, captured (run-server's CLI
        # configures the root logger the same way)
        root_logger.handlers = [logging.StreamHandler(log)]
        logs.maybe_configure()
        server_logger.setLevel(logging.DEBUG)
        lanes = {}
        lanes["default"], served = _obs_lane(card, collection, bodies, "default", device)
        try:
            busy = _obs_busy_against_trace(card, served, bodies, root)
            under_load = _obs_profiles_under_load(card, served, bodies)
        finally:
            served.close()
        lanes["loop"], served = _obs_lane(card, collection, bodies, "loop", device)
        served.close()
        server_logger.setLevel(logging.NOTSET)
        lines = [json.loads(line) for line in log.getvalue().splitlines()
                 if line.startswith("{")]
        traced = [line for line in lines if line.get("trace_id") and line.get("span_id")]
        if not any(line["trace_id"] in OBS_SENT for line in traced):
            raise AssertionError(f"no JSON log line carries a sent trace id ({len(lines)} lines)")
        overhead = _obs_overhead(card, collection, bodies, device)
        build = _obs_build(card, root / "build", device)
    finally:
        server_logger.setLevel(logging.NOTSET)
        root_logger.handlers, root_logger.level = saved_handlers, saved_level
        for knob, value in saved.items():
            if value is None:
                os.environ.pop(knob, None)
            else:
                os.environ[knob] = value
    launches = {dtype: _launches(dtype) for dtype in COUNTERS}
    print(f"observability phase: {time.perf_counter() - started:.1f} s; JSON log lines "
          f"{len(lines)} ({len(traced)} with trace ids); launches {launches}", flush=True)
    if not (launches["float32"]["forward"] and launches["bfloat16"]["forward"]
            and launches["float32"]["dq"] and launches["float32"]["dkv"]):
        raise AssertionError(f"the observability phase launched a kernel no time: {launches}")
    return {"lanes": lanes, "busy_against_trace": busy, "under_load": under_load,
            "overhead": overhead, "build": build, "json_log_lines": len(lines),
            "json_log_lines_traced": len(traced), "launches": launches,
            "phase_s": time.perf_counter() - started}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "gordo_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from gordo_tpu_torch import native
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
    # the codec's native library (g++) builds beside the kernels (nvcc)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native_build = pool.submit(native.load)
        libs = _build.build_all()
        native_build.result()
    print(f"built {sorted(libs)} and {native.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for stem, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"  {stem}: {line.strip()}")
    occupancy = _occupancy()
    mma = _sass_mma(libs)
    wgmma = wgmma_report(occupancy)
    lstm_instantiations = lstm_build_report(mma)

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
    t0 = time.perf_counter()
    head_dims = {dtype: {"gates": head_dim_gates(dtype), "times": head_dim_times(card, dtype)}
                 for dtype in COUNTERS}
    print(f"wide head-dim kernel phase: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lstm_entries = lstm_kernel_phase(card)
    print(f"LSTM recurrence kernel phase: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    collections = [REPO / "build" / "chip_smoke" / rev for rev in ("1", "2", "3")]
    fleet_root = REPO / "build" / "chip_smoke_fleet"
    batcher_root = REPO / "build" / "chip_smoke_batcher"
    for collection in collections + [fleet_root, batcher_root]:
        shutil.rmtree(collection, ignore_errors=True)
        collection.mkdir(parents=True)
    spec, layers, scaler = write_artifact(collections[0])
    serving = main_path(card, spec, layers, scaler, collections[0])
    torch.cuda.empty_cache()
    base_route = server_surface_path(card, spec, layers, scaler, collections[0])
    torch.cuda.empty_cache()
    batched = batcher_path(card, batcher_root / "float32")
    torch.cuda.empty_cache()
    build, serial_seconds = build_path(card, collections[1])
    torch.cuda.empty_cache()
    bf16_build, bf16_serial_seconds = bf16_build_path(card, collections[2])
    torch.cuda.empty_cache()
    bf16_batched = batcher_path(card, batcher_root / "bfloat16", compute_dtype="bfloat16")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fleet = fleet_path(card, fleet_root, serial_seconds)
    torch.cuda.empty_cache()
    bf16_fleet = fleet_path(card, fleet_root, bf16_serial_seconds, compute_dtype="bfloat16")
    torch.cuda.empty_cache()
    fleet_loss_check(card)
    cli_batch_build(fleet_root)
    print(f"fleet phase: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    ff_root = REPO / "build" / "chip_smoke_feedforward"
    shutil.rmtree(ff_root, ignore_errors=True)
    ff_root.mkdir(parents=True)
    t0 = time.perf_counter()
    ff_build = feedforward_build_path(card, ff_root / "built")
    ff_build["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ff_served = feedforward_served_path(card, ff_root, ff_root / "built")
    ff_served["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ff_fleet = feedforward_fleet_path(card, ff_root)
    ff_fleet["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print(f"feedforward phases: build {ff_build['phase_s']:.1f} s, served "
          f"{ff_served['phase_s']:.1f} s, fleet {ff_fleet['phase_s']:.1f} s", flush=True)
    t0 = time.perf_counter()
    lanes = fastlane_path(card, ff_root, batcher_root / "float32" / "1", ff_root / "built")
    lanes["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kfcv_fleet = kfcv_fleet_path(card, ff_root)
    kfcv_fleet["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print(f"fast lane phase {lanes['phase_s']:.1f} s, KFCV fleet phase "
          f"{kfcv_fleet['phase_s']:.1f} s", flush=True)
    windowed_root = REPO / "build" / "chip_smoke_windowed"
    shutil.rmtree(windowed_root, ignore_errors=True)
    windowed_root.mkdir(parents=True)
    windowed = {}
    for key, phase in (("lstm_example_build", lstm_example_build_path),
                       ("served", windowed_served_path), ("fleet", windowed_fleet_path)):
        t0 = time.perf_counter()
        windowed[key] = phase(card, windowed_root)
        windowed[key]["phase_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    print(f"LSTM/TCN phases: compressor-b build {windowed['lstm_example_build']['phase_s']:.1f} "
          f"s, windowed serving {windowed['served']['phase_s']:.1f} s, windowed fleet "
          f"{windowed['fleet']['phase_s']:.1f} s", flush=True)
    t0 = time.perf_counter()
    d384 = d384_path(card, REPO / "build" / "chip_smoke_d384")
    d384["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print(f"transformer-ae-512-d384 phase: {d384['phase_s']:.1f} s", flush=True)
    moe = moe_path(card, REPO / "build" / "chip_smoke_moe")
    torch.cuda.empty_cache()
    observed = observability_path(card, REPO / "build" / "chip_smoke_observability", batcher_root)
    torch.cuda.empty_cache()

    forward["launches_by_path"] = {"serving": serving, "server_surface": base_route,
                                   "batcher": batched["launches"],
                                   "build": build["forward"], "serving_built": build["serving"],
                                   "fleet": fleet["forward"],
                                   "feedforward_served": ff_served["forward"],
                                   "feedforward_fleet": ff_fleet["launches"]["forward"],
                                   "fastlane": lanes["forward"],
                                   "kfcv_fleet": kfcv_fleet["launches"]["forward"],
                                   "windowed_served":
                                       windowed["served"]["launches"]["float32"]["forward"],
                                   "windowed_fleet":
                                       windowed["fleet"]["launches"]["float32"]["forward"]}
    bf16_forward["launches_by_path"] = {"batcher": bf16_batched["launches"],
                                        "build": bf16_build["forward"],
                                        "serving_built": bf16_build["serving"],
                                        "fleet": bf16_fleet["forward"]}
    for entry, result in ((forward, batched), (bf16_forward, bf16_batched)):
        entry["batcher_shape"] = result["fused_forward"]
    print(json.dumps({"batcher_path": {dtype: {key: value for key, value in result.items()
                                              if key != "fused_forward"}
                                       for dtype, result in (("float32", batched),
                                                             ("bfloat16", bf16_batched))}}))
    print(json.dumps({"feedforward": {"build": ff_build, "served": ff_served,
                                      "fleet": ff_fleet}}, default=str))
    print(json.dumps({"fastlane": lanes, "kfcv_fleet": kfcv_fleet}, default=str))
    print(json.dumps({"windowed": windowed}, default=str))
    print(json.dumps({"transformer-ae-512-d384": {key: value for key, value in d384.items()
                                                  if key != "launches"}}, default=str))
    print(json.dumps({"moe": {key: value for key, value in moe.items()
                              if key not in ("launches", "times_dh16")}}, default=str))
    print(json.dumps({"observability": {key: value for key, value in observed.items()
                                        if key != "launches"}}, default=str))
    for entry, key, launches, fleet_launches in (
            (dq, "dq", build, fleet), (dkv, "dkv", build, fleet),
            (bf16_dq, "dq", bf16_build, bf16_fleet), (bf16_dkv, "dkv", bf16_build, bf16_fleet)):
        entry["launches_by_path"] = {"build": launches[key], "fleet": fleet_launches[key]}
        if entry is dq or entry is dkv:
            entry["launches_by_path"]["feedforward_fleet"] = ff_fleet["launches"][key]
            entry["launches_by_path"]["kfcv_fleet"] = kfcv_fleet["launches"][key]
            entry["launches_by_path"]["windowed_fleet"] = windowed["fleet"]["launches"][
                "float32"][key]
    # the observability phase's launches: the served forwards of each dtype,
    # and the float32 backward pair of its profiled batch-build
    for entry, dtype, key in ((forward, "float32", "forward"), (bf16_forward, "bfloat16", "forward"),
                              (dq, "float32", "dq"), (dkv, "float32", "dkv")):
        entry["launches_by_path"]["observability"] = observed["launches"][dtype][key]
    dh16_entries = moe_entries(entries, moe)
    for entry in entries:
        entry["fleet_shape"] = fleet_times[entry["name"]]
    # the wide head dims: each kernel's gates by dh and its times at dh 96
    # and 256; an entry of its own at dh 96, launched by the d384 path
    f32_ptxas = {"forward": ("flash_attention", "flash_forward_f32"),
                 "dq": ("flash_attention_bwd", "flash_bwd_dq_f32"),
                 "dkv": ("flash_attention_bwd", "flash_bwd_dkv_f32")}
    d384_entries = []
    for entry in entries:
        dtype = entry["dtype"]
        kernel = next(k for k, n in ENTRY_NAMES.items()
                      if entry["name"] in (n, n + "_bf16"))
        gates, times = head_dims[dtype]["gates"], head_dims[dtype]["times"][kernel]
        entry["head_dims"] = {"gates": gates[kernel], "lse": gates["lse"],
                              "max_abs_err": gates["max_abs"][kernel], "timed": times}
        if dtype == "float32":
            entry["ptxas_by_head_dim"] = _ptxas(*f32_ptxas[kernel])
        top = times[96][TIMED_BH[0] if kernel == "forward" else TIMED_BH[1]]
        paths = d384["launches"][dtype]
        d384_entries.append({
            "name": f"{entry['name']}_dh96", "route": "cuda", "source": entry["source"],
            "replaces": entry["replaces"], "dtype": dtype, "head_dim": 96,
            "head_dim_class": _head_dim_class(entry["name"], 96),
            "launches_by_path": (
                {"d384_build": paths["build"]["forward"],
                 "d384_served": paths["served"]["forward"]} if kernel == "forward" else
                {"d384_build": paths["build"][kernel], "d384_stacked": paths["stacked"][kernel]}),
            "max_abs_err": gates["max_abs"][kernel][96], "gate_err_at_dh96": gates[kernel][96],
            **{key: top[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                         "shape", "achieved_tflop_s", "bound_share",
                                         "plain_and_library_compute")},
            "timed_by_bh": times[96]})
    for entry in entries:
        for dh, built in sorted(entry.get("ptxas_by_head_dim", {}).items()):
            print(f"  {entry['name']} class {dh}: {built[0]} registers ({built[1]} B spilled), "
                  f"{entry['occupancy_by_head_dim'][dh]}", flush=True)
    # the recurrence kernels: float32 on compressor-b's build and the float32
    # served artifacts, bf16 on the bf16 served artifacts and the bf16 fleet
    example, served_l, fleet_l = (windowed["lstm_example_build"]["launches"],
                                  windowed["served"]["launches"], windowed["fleet"]["launches"])
    example_u, served_u, fleet_u = (windowed["lstm_example_build"]["launches_by_units"],
                                    windowed["served"]["lstm_launches_by_units"],
                                    windowed["fleet"]["lstm_launches_by_units"])
    for entry, paths, by_units in zip(lstm_entries, (
            {"lstm_example_build": example["forward"],
             "windowed_served": served_l["float32"]["lstm_forward"]},
            {"lstm_example_build": example["backward"]},
            {"windowed_served": served_l["bfloat16"]["lstm_forward"],
             "windowed_fleet": fleet_l["bfloat16"]["lstm_forward"]},
            {"windowed_fleet": fleet_l["bfloat16"]["lstm_backward"]}), (
            {"lstm_example_build": example_u["forward"],
             "windowed_served": served_u["float32"]["forward"]},
            {"lstm_example_build": example_u["backward"]},
            {"windowed_served": served_u["bfloat16"]["forward"],
             "windowed_fleet": fleet_u["forward"]},
            {"windowed_fleet": fleet_u["backward"]})):
        entry["launches_by_path"] = paths
        # by path, the launches of each width: U 256 from lstm_model_144
        entry["launches_by_path_and_units"] = by_units
        entry["instantiations"] = [i for i in lstm_instantiations
                                   if (i["kernel"], i["dtype"]) == (
                                       entry["name"].split("_")[2], entry["dtype"])]
    entries += d384_entries + dh16_entries + lstm_entries
    for entry in entries:
        entry["launches"] = sum(entry["launches_by_path"].values())
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
