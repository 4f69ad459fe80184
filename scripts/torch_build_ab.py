"""
The ``transformer-ae-512`` build (``chip_smoke.build_and_check``: 3-fold CV
and a fit over 6,144 RandomDataset rows, float32) of two trees of the repo
on one NVIDIA GPU, in turns: A, B, B, A, each in a process of its own that
builds once to warm up and then ``BUILDS`` times more. Printed for each
timed build: its seconds, its phases (from the artifact's build metadata)
and the peak device memory. The two trees' kernels are built before the
first turn (each tree in its own ``build/``).

    python3 scripts/torch_build_ab.py A_DIR B_DIR       # from the repo root

A_DIR and B_DIR are checkouts (``git archive`` of two commits, say). The
card's name and power limit come first; the last line is one JSON object
of every turn's builds.
"""

import json
import subprocess
import sys
from pathlib import Path

BUILDS = 2
CHILD = r"""
import json, shutil, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from gordo_tpu_torch import native, serializer
from gordo_tpu_torch.models.models import TransformerAutoEncoder
from gordo_tpu_torch.ops import _build

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
native.load()
_build.build_all()
if sys.argv[1] == "build-only":
    sys.exit(0)
card = cs._card()
spec = TransformerAutoEncoder(**cs.CONFIG).build_spec(len(cs.TAGS), len(cs.TAGS))
root = cs.REPO / "build" / "build_ab"
runs = []
for k in range(int(sys.argv[1]) + 1):
    shutil.rmtree(root, ignore_errors=True)
    _, launches, seconds = cs.build_and_check(card, cs.BUILD_CONFIG, spec, root / "built",
                                              root / "register")
    peak = torch.cuda.max_memory_allocated() / 2**30
    phases = serializer.load_metadata(str(root / "built"))["metadata"]["build_metadata"]["phases"]
    if k:  # the first build warms the process up
        runs.append({"seconds": seconds, "phases": phases, "peak_gib": peak,
                     "launches": launches})
    torch.cuda.empty_cache()
print("AB " + json.dumps(runs))
"""


def _run(tree: Path, arg: str) -> list:
    result = subprocess.run([sys.executable, "-c", CHILD, arg], cwd=tree, capture_output=True,
                            text=True, timeout=1800)
    if result.returncode != 0:
        print(result.stdout[-3000:], result.stderr[-3000:], file=sys.stderr)
        raise RuntimeError(f"the build in {tree} exited {result.returncode}")
    lines = [line for line in result.stdout.splitlines() if line.startswith("AB ")]
    return json.loads(lines[-1][3:]) if lines else []


def main() -> int:
    trees = [Path(arg).resolve() for arg in sys.argv[1:3]]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for tree in trees:
        _run(tree, "build-only")
    turns = []
    for label, tree in zip("ABBA", (trees[0], trees[1], trees[1], trees[0])):
        runs = _run(tree, str(BUILDS))
        for run in runs:
            print(f"{label} {tree.name}: {run['seconds']:.3f} s, phases {run['phases']}, "
                  f"peak {run['peak_gib']:.2f} GiB", flush=True)
        turns.append({"tree": label, "dir": str(tree), "builds": runs})
    print(json.dumps({"card": card, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
