"""
``chip_smoke.py``'s builds from real sensor data alone, on one NVIDIA GPU:
after the kernels and the native library are built, the
``transformer-ae-512`` machine is built from its config as the build phase
builds it (``build_and_check``: its phase seconds, ms a fit step and peak
device memory), then ``data_build_path`` runs: the file-backed float32
build with a row filter, named metrics and a TimeSeriesSplit with a gap and
a test size, the build whose row filter leaves no row, and the bf16 fleet
from an Influx stub under a fault plan. A quicker way than the whole smoke
run to iterate on the data layer and the fault ladder.

    python3 scripts/torch_data_build_phase.py           # from the repo root

It prints the card's name and power limit; the last line is one JSON object
of its results. A failed gate raises.
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
        print("torch_data_build_phase: no CUDA device", file=sys.stderr)
        return 2
    from gordo_tpu_torch import native
    from gordo_tpu_torch.models.models import TransformerAutoEncoder
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
    root = cs.REPO / "build" / "chip_smoke_data_alone"
    shutil.rmtree(root, ignore_errors=True)
    spec = TransformerAutoEncoder(**cs.CONFIG).build_spec(len(cs.TAGS), len(cs.TAGS))
    t0 = time.perf_counter()
    _, launches, seconds = cs.build_and_check(card, cs.BUILD_CONFIG, spec, root / "built",
                                              root / "register")
    build = {"seconds": seconds, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
             "launches": launches, "wall_s": time.perf_counter() - t0}
    torch.cuda.empty_cache()
    data = cs.data_build_path(card, root / "data")
    print(card)
    print(json.dumps({"build": build, "data_build": data}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
