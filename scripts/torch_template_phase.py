"""
``chip_smoke.py``'s configs-as-the-JAX-CLI-reads-them phase alone, on one
NVIDIA GPU: after the kernels and the native library are built,
``template_build_path`` runs: ``transformer-ae-512`` built through the CLI
from YAML text with its model a Jinja template filled by
``--model-parameter``, both reporters over stand-in client modules, three
refused builds, a build whose Postgres reporter finds no ``psycopg2``, and
``batch-build`` of examples/config.yaml's ``spec.config`` block as YAML. A
quicker way than the whole smoke run to iterate on config reading.

    python3 scripts/torch_template_phase.py           # from the repo root

It prints the card's name and power limit; the last line is one JSON object
of its results. A failed gate raises.
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
        print("torch_template_phase: no CUDA device", file=sys.stderr)
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
    template = cs.template_build_path(card, cs.REPO / "build" / "chip_smoke_template_alone")
    print(card)
    print(json.dumps({"template_build": template}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
