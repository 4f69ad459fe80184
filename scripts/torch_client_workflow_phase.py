"""
``chip_smoke.py``'s prediction-client and workflow-generator phase alone,
on one NVIDIA GPU: after the kernels and the native library are built,
``client_workflow_path`` renders a two-machine ``transformer-ae-512`` project
(float32 and bf16) with ``workflow generate``, validates it, and runs the
rendered stage-config, builder, server and client commands as rendered,
then the client CLI's parquet, metadata and download-model. A quicker way
than the whole smoke run to iterate on the client or the workflow.

    python3 scripts/torch_client_workflow_phase.py    # from the repo root

It prints the card's name and power limit; the last line is one JSON object
of its results. A failed gate raises; the processes' logs are under
``build/chip_smoke_client_workflow_alone/``.
"""

import concurrent.futures
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_client_workflow_phase: no CUDA device", file=sys.stderr)
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
    workflow = cs.client_workflow_path(card, cs.REPO / "build" /
                                       "chip_smoke_client_workflow_alone")
    print(card)
    print(json.dumps({"client_workflow": workflow}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
