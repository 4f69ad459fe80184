"""
``chip_smoke.py``'s LSTM and TCN phases alone, on one NVIDIA GPU: after the
kernels and the native codec are built, ``lstm_example_build_path``
(examples/config.yaml's compressor-b through the CLI, and a step's ms on
the kernels and on the plain twin), ``windowed_served_path`` (the windowed
families served beside transformer-ae-512) and ``windowed_fleet_path``
(the windowed ``batch-build``) run. A quicker way than the whole smoke run
to iterate on those phases.

    python3 scripts/torch_windowed_phases.py [MACHINES]   # from the repo root

MACHINES sets the windowed fleet's machines of each family
(``chip_smoke.WINDOWED_FLEET_MACHINES`` unless named; bench.py's
BENCH_WINDOWED_MACHINES is 64). Each phase prints its gates and
numbers as ``chip_smoke.py`` does; a phase that fails prints its
traceback and the next one runs. The last line is one JSON object of the
phases' results, with each phase's seconds.
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
        print("torch_windowed_phases: no CUDA device", file=sys.stderr)
        return 2
    from gordo_tpu_torch import native
    from gordo_tpu_torch.ops import _build

    if len(sys.argv) > 1:
        cs.WINDOWED_FLEET_MACHINES = int(sys.argv[1])
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
    root = cs.REPO / "build" / "windowed_phases"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out, failed = {}, False
    for name, fn in (("lstm_example_build", cs.lstm_example_build_path),
                     ("served", cs.windowed_served_path), ("fleet", cs.windowed_fleet_path)):
        t0 = time.perf_counter()
        try:
            out[name] = fn(card, root)
        except Exception as exc:  # noqa: BLE001 -- reported, then the next phase runs
            traceback.print_exc()
            out[name] = {"failed": repr(exc)}
            failed = True
        out[name]["phase_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        print(f"{name} phase: {out[name]['phase_s']:.1f} s", flush=True)
    print(card)
    print(json.dumps({"windowed": out}, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
