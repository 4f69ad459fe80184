"""
What a new Python process of the port costs before its work, on the card's
machine: the interpreter alone, ``import torch``, torch and a first CUDA
kernel, the port's CLI, each without and then with its bytecode cached
under build/pycache (chip_smoke.py's ``_cache_bytecode``: the cache
written by a first run, read by the next).

    python3 scripts/torch_process_start.py   # from the repo root

Prints the card's name and power limit, then each command's seconds,
RUNS times each way.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
RUNS = 3
COMMANDS = {
    "python -c pass": ["-c", "pass"],
    "import torch": ["-c", "import torch"],
    "import torch, a CUDA kernel": ["-c", "import torch; torch.ones(1, device='cuda').sum()"],
    "python -m gordo_tpu_torch --help": ["-m", "gordo_tpu_torch", "--help"],
}


def main() -> int:
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    print(cs._card(), flush=True)
    base = {**os.environ, "PYTHONPATH": str(REPO)}
    cached = {k: v for k, v in base.items() if k != "PYTHONDONTWRITEBYTECODE"}
    cached["PYTHONPYCACHEPREFIX"] = str(REPO / "build" / "pycache-start")
    print(f"PYTHONDONTWRITEBYTECODE: {os.environ.get('PYTHONDONTWRITEBYTECODE')!r}", flush=True)
    for label, env in (("as the environment has it", base), ("bytecode cached", cached)):
        for name, argv in COMMANDS.items():
            seconds = []
            for _ in range(RUNS):
                t0 = time.perf_counter()
                subprocess.run([sys.executable, *argv], cwd=REPO, env=env, check=True,
                               stdout=subprocess.DEVNULL)
                seconds.append(time.perf_counter() - t0)
            print(f"{label}: {name}: " + ", ".join(f"{s:.2f}" for s in seconds) + " s",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
