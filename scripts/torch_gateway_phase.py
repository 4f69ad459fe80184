"""
``chip_smoke.py``'s gateway phase alone, on one NVIDIA GPU: after the
kernels and the native codec are built, the batcher phases' eight
``transformer-ae-512`` artifacts of each dtype are written as those phases
write them (``write_artifact``, ``batcher-m0`` to ``batcher-m7``, seeded
weights), and ``gateway_path`` runs: two ``run-server --workers 1
--warmup`` nodes on the card behind ``run-gateway``, the routed and direct
load, the trace, the graceful leave, the crash and the metrics gate, with
the ``kill_node_mid_ramp`` drill on stub nodes beside them. A quicker way
than the whole smoke run to iterate on the gateway tier.

    python3 scripts/torch_gateway_phase.py           # from the repo root

It prints the card's name and power limit; the last line is one JSON object
of its results. The nodes', the gateway's and the drill's logs are copied
under ``chiprun_out/gateway/``. A failed gate raises.
"""

import concurrent.futures
import json
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_gateway_phase: no CUDA device", file=sys.stderr)
        return 2
    from gordo_tpu_torch import native
    from gordo_tpu_torch.ops import _build

    card = cs._card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native_build = pool.submit(native.load)
        _build.build_all()
        native_build.result()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    root = cs.REPO / "build" / "chip_smoke_gateway_alone"
    shutil.rmtree(root, ignore_errors=True)
    batcher_root = root / "batcher"
    for dtype in ("float32", "bfloat16"):
        estimator = {"compute_dtype": "bfloat16"} if dtype == "bfloat16" else {}
        for m in range(cs.BATCHER_MODELS):
            cs.write_artifact(batcher_root / dtype / "1", "cuda", name=f"batcher-m{m}",
                              seed=cs.SEED + 100 + m, **estimator)
    out = cs.REPO / "chiprun_out" / "gateway"
    try:
        result = cs.gateway_path(card, root / "gateway", batcher_root)
    finally:
        out.mkdir(parents=True, exist_ok=True)
        for log in sorted((root / "gateway").glob("*.log")):
            shutil.copy(log, out / log.name)
    print(card)
    print(json.dumps(result, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
