"""
``chip_smoke.py``'s fast-lane and KFCV-fleet phases alone, on one NVIDIA
GPU: after the kernels and the native codec are built, the eight float32
batcher artifacts are written and examples/config.yaml's feedforward
machines built (``feedforward_build_path``), then ``fastlane_path`` and
``kfcv_fleet_path`` run. A quicker way than the whole smoke run to iterate
on those phases.

    python3 scripts/torch_fastlane_phases.py   # from the repo root

Each phase prints its gates and numbers as ``chip_smoke.py`` does; a phase
that fails prints its traceback and the next one runs. The last line is one
JSON object of the phases' results.
"""

import concurrent.futures
import json
import shutil
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_fastlane_phases: no CUDA device", file=sys.stderr)
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
    root = cs.REPO / "build" / "fastlane_phases"
    shutil.rmtree(root, ignore_errors=True)
    transformers = root / "batcher" / "1"
    for m in range(cs.BATCHER_MODELS):
        cs.write_artifact(transformers, name=f"batcher-m{m}", seed=cs.SEED + 100 + m)
    cs.feedforward_build_path(card, root / "built")
    out, failed = {}, False
    for name, fn in (("fastlane", lambda: cs.fastlane_path(card, root, transformers,
                                                           root / "built")),
                     ("kfcv_fleet", lambda: cs.kfcv_fleet_path(card, root))):
        t0 = time.perf_counter()
        try:
            out[name] = fn()
        except Exception as exc:  # noqa: BLE001 -- reported, then the next phase runs
            traceback.print_exc()
            out[name], failed = repr(exc), True
        print(f"PHASE {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(out, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
