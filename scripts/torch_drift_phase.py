"""
``chip_smoke.py``'s drift-loop phase alone, on one NVIDIA GPU: after the
kernels and the native codec are built, ``drift_path`` runs: four
``transformer-ae-512`` machines built by ``batch-build`` with the register,
served in this process with the drift detector and the hot swap on, two
of them drifted, rebuilt warm by ``drift-rebuilder --once`` in a subprocess
and swapped in under load, a third's swap failing once by an injected
fault, then a ``run-server --workers 2 --warmup`` pool swapping them all and
a fourth. A quicker way than the whole smoke run to iterate on the loop.

    python3 scripts/torch_drift_phase.py           # from the repo root

It prints the card's name and power limit; the last line is one JSON object
of its results. The rebuilder's log and the pool's are copied under
``chiprun_out/drift/``. A failed gate raises.
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
        print("torch_drift_phase: no CUDA device", file=sys.stderr)
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
    root = cs.REPO / "build" / "chip_smoke_drift_alone"
    out = cs.REPO / "chiprun_out" / "drift"
    try:
        result = cs.drift_path(card, root)
    finally:
        out.mkdir(parents=True, exist_ok=True)
        for log in ("rebuild.log", "pool-drift.log"):
            if (root / log).exists():
                shutil.copy(root / log, out / log)
    print(card)
    print(json.dumps(result, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
