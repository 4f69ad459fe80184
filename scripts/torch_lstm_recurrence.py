"""
The LSTM recurrence kernels (``gordo_tpu_torch/ops/csrc/lstm_recurrence.cu``)
alone on one NVIDIA GPU: ``chip_smoke.py``'s ``lstm_kernel_phase``.

    python3 scripts/torch_lstm_recurrence.py   # from the repo root

Holds the forward and backward kernels against their plain twins in
float32 and bf16 at ``chip_smoke.LSTM_SHAPES`` (compressor-b's, bench.py's
lstm_ae_144 alone and as a 64-machine fleet step, the factories' default
width), then times each with CUDA events beside its bound, its twin and
cuDNN's ``torch.nn.LSTM``. Prints the registers and spills of the build,
the card's name and power limit and one JSON line of the four kernels'
entries.
"""

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_lstm_recurrence: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from gordo_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke._card()
    print(card, flush=True)
    _build.build_all()
    for line in _build.BUILD_LOGS.get("lstm_recurrence", "").splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"  lstm_recurrence: {line.strip()}")
    entries = chip_smoke.lstm_kernel_phase(card)
    print(card)
    print(json.dumps({"lstm_recurrence": entries}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
