"""
The feedforward phases of ``chip_smoke.py`` alone, on one NVIDIA GPU:
``feedforward_build_path``, ``feedforward_served_path`` and
``feedforward_fleet_path``, after the kernels and the native codec are
built. A quicker way than the whole smoke run to iterate on those phases.

    python3 scripts/torch_feedforward_phases.py   # from the repo root

Each phase prints its gates and numbers as ``chip_smoke.py`` does; a
phase that fails prints its traceback and the next one runs. The last
line is one JSON object of the phases' results.
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
        print("torch_feedforward_phases: no CUDA device", file=sys.stderr)
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
    root = cs.REPO / "build" / "feedforward_phases"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out, failed = {}, False
    for name, fn in (("build", lambda: cs.feedforward_build_path(card, root / "built")),
                     ("served", lambda: cs.feedforward_served_path(card, root, root / "built")),
                     ("fleet", lambda: cs.feedforward_fleet_path(card, root))):
        t0 = time.perf_counter()
        try:
            out[name] = fn()
        except Exception as exc:  # noqa: BLE001 -- reported, then the next phase runs
            traceback.print_exc()
            out[name], failed = repr(exc), True
        print(f"PHASE {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"feedforward": out}, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
