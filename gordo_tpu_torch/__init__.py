"""
gordo_tpu_torch: the PyTorch/CUDA port of gordo_tpu for NVIDIA Hopper.

The JAX package ``gordo_tpu`` is the reference this package is held
against; this package imports none of it and no JAX. Its entry points run
on the card unless the caller asks for the CPU (``device="cpu"``), which
is how the tests run it.
"""

import torch

__version__ = "0.4.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    ``"cpu"``. Raises when CUDA is asked for (the default) and there is
    none: the port never quietly falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"gordo_tpu_torch runs on 'cuda' or 'cpu', not {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device
