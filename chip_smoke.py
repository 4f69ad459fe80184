"""
Drive the PyTorch/CUDA port (gordo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

1. Device: the card's name and power limit, CUDA version; TF32 is turned
   off for matmuls and cuDNN, so every reference below is float32.
2. Build: every kernel of ``gordo_tpu_torch/ops/csrc`` with nvcc.
3. Kernel phase: each kernel against its plain PyTorch version on the card
   at the main path's shapes (and a ragged, small-head shape), with the
   times of the kernel, the plain version and the PyTorch library call
   that computes the same function (timed here only as a yardstick).
4. Main path: a ``transformer-ae-512`` artifact (TransformerAutoEncoder,
   lookback 512, d_model 256, 4 heads, ff 512, 2 blocks, 8 tags; weights
   from a seed) is served by the port's HTTP server on the card, and three
   anomaly requests (1,535, 700 and 1,535 rows) are checked: status, blocks,
   row counts, finite values, one kernel launch per Transformer block per
   request, and the first answer's model output against the same model with
   the plain attention.
5. A ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failure raises, so the exit code is not 0 and no result line is
printed. Without CUDA, or outside a checkout, it exits 2 at once.
"""

import dataclasses
import json
import math
import shutil
import subprocess
import sys
import threading
import time
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
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# FLOP/s on the CUDA cores (the kernel does not use the tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TOL_OUT_REL = 1e-4  # kernel vs plain, float32, sums in another order
TOL_LSE_ABS = 1e-4
TOL_MODEL_REL = 1e-4  # served model output vs the same model with plain attention


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


def _flash_bound_ms(bh: int, t: int, dh: int, causal: bool):
    """(bound_ms, bound_by): q/k/v/out read or written once plus lse, and
    4*dh FLOP per visible (query, key) pair."""
    n_bytes = 4 * (4 * bh * t * dh + bh * t)
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4 * dh * bh * pairs
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes > by_ops else "operations"


def kernel_phase(card: str) -> dict:
    """Flash kernel vs its plain version at each shape; times at the main
    path's shape. Returns the kernel's entry of the ``kernels`` line."""
    import torch
    import torch.nn.functional as F

    from gordo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED)
    main_shape = (1024 * 4, 512, 64)  # 1,024 windows x 4 heads of the main path
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

    q, k, v = (torch.randn(main_shape, device="cuda", generator=g) for _ in range(3))
    ms = _time_ms(lambda: fa.flash_attention_forward(q, k, v, True), 20)
    plain_ms = _time_ms(lambda: fa.flash_attention_forward_plain(q, k, v, True), 5)
    library_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20
    )
    bound_ms, bound_by = _flash_bound_ms(*main_shape, causal=True)
    print(f"flash_attention {main_shape} causal on {card}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return {
        "name": "flash_attention_forward", "route": "cuda",
        "source": "gordo_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "gordo_tpu/ops/pallas_kernels/flash_attention.py:41",
        "launches": None, "max_abs_err": worst["out_abs"],
        "out_max_rel_err": worst["out_rel"], "lse_max_abs_err": worst["lse_abs"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "shape": list(main_shape), "causal": True,
    }


def _series(n_rows: int, offset: int, rng) -> np.ndarray:
    """Eight sine tags with noise, rows ``offset .. offset + n_rows``."""
    t = np.arange(offset, offset + n_rows)[:, None]
    period = 144.0 * (1.0 + np.arange(len(TAGS)) / 4.0)
    return np.sin(2 * np.pi * t / period) + 0.05 * rng.randn(n_rows, len(TAGS))


def write_artifact(collection: Path, device: str = "cuda"):
    """The transformer-ae-512 artifact: seeded weights, scalers fitted on a
    training span, thresholds from a held-out span (the JAX package's
    rule: the max over the span of the rolling(6) minimum of the error)."""
    import torch

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.models.anomaly.diff import _rolling
    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.models.scaler import MinMaxScaler
    from gordo_tpu_torch.ops.nn import init_model_params
    from gordo_tpu_torch.serializer.from_jax import detector_from_arrays

    rng = np.random.RandomState(SEED)
    train, held_out = _series(4096, 0, rng), _series(2048, 4096, rng)
    estimator = TransformerAutoEncoder(**CONFIG)
    spec = estimator.build_spec(len(TAGS), len(TAGS))
    params = init_model_params(spec, torch.Generator().manual_seed(SEED))
    scaler = MinMaxScaler().fit(train)
    layers = [{k: v.numpy() for k, v in p.items()} for p in params]
    detector = detector_from_arrays(
        spec, layers, scaler.min_, scaler.scale_, scaler.min_, scaler.scale_,
        estimator_kwargs={k: v for k, v in CONFIG.items() if k != "kind"}, device=device,
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


def main_path(card: str, spec, layers, scaler, collection: Path, device: str = "cuda"):
    """Serve three anomaly requests through the port's server on the card
    and check them. Returns the kernel launches the requests made."""
    import torch

    from gordo_tpu_torch.models.models import TransformerAutoEncoder
    from gordo_tpu_torch.models.spec import TransformerBlock
    from gordo_tpu_torch.ops import flash_attention as fa
    from gordo_tpu_torch.server.server import make_server

    server = make_server("127.0.0.1", 0, device=device, collection_dir=str(collection))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{server.server_address[1]}"
           "/gordo/v0/smoke/transformer-ae-512/anomaly/prediction")
    rng = np.random.RandomState(SEED + 1)
    start = datetime(2020, 1, 1, tzinfo=timezone.utc)
    expected = {"start", "end", "model-input", "model-output", "tag-anomaly-scaled",
                "total-anomaly-scaled", "tag-anomaly-unscaled", "total-anomaly-unscaled",
                "anomaly-confidence", "total-anomaly-confidence"}
    first = None
    try:
        fa.LAUNCHES = 0
        for i, n_rows in enumerate(REQUEST_ROWS):
            values = _series(n_rows, 8192 + 2000 * i, rng)
            before = fa.LAUNCHES
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
            launched = fa.LAUNCHES - before
            print(f"request {i}: {n_rows} rows -> {n_out} windows, status {status}, "
                  f"{latency_ms:.1f} ms on {card}, flash launches {launched}", flush=True)
            n_blocks = sum(isinstance(layer, TransformerBlock) for layer in spec.layers)
            if launched != n_blocks:
                raise AssertionError(f"{launched} flash launches, expected {n_blocks}")
            if first is None:
                first = (values, data["model-output"])
        launches = fa.LAUNCHES
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)

    # the first answer's model output against the same model with plain attention
    plain_spec = dataclasses.replace(spec, layers=tuple(
        dataclasses.replace(layer, attention_impl="xla")
        if isinstance(layer, TransformerBlock) else layer for layer in spec.layers))
    plain = TransformerAutoEncoder(**CONFIG).load_params(plain_spec, layers, device)
    before = fa.LAUNCHES
    ref = plain.predict(scaler.transform(first[0]))
    if fa.LAUNCHES != before:
        raise AssertionError("the plain reference launched the kernel")
    served = np.array([list(first[1][tag].values()) for tag in TAGS]).T
    err = np.abs(served - ref).max() / np.abs(ref).max()
    print(f"served model-output vs plain attention: max rel err {err:.3e}", flush=True)
    if not err <= TOL_MODEL_REL:
        raise AssertionError("served model output disagrees with the plain model")
    return launches


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

    entry = kernel_phase(card)
    torch.cuda.empty_cache()

    collection = REPO / "build" / "chip_smoke" / "1"
    shutil.rmtree(collection, ignore_errors=True)
    collection.mkdir(parents=True)
    spec, layers, scaler = write_artifact(collection)
    entry["launches"] = main_path(card, spec, layers, scaler, collection)
    if entry["launches"] < 1:
        raise AssertionError("the main path launched no flash kernel")

    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
