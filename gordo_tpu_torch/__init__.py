"""
gordo_tpu_torch: the PyTorch/CUDA port of gordo_tpu for NVIDIA Hopper.

The JAX package ``gordo_tpu`` is the reference this package is held
against; this package imports none of it and no JAX. Its entry points run
on the card unless the caller asks for the CPU (``device="cpu"``), which
is how the tests run it.
"""

import torch

__version__ = "0.4.0"


def _parse_version(version: str):
    """``(major, minor, is_unstable)`` of a version string, as the JAX
    package parses its own.

    >>> _parse_version("1.2.3")
    (1, 2, False)
    >>> _parse_version("0.55.0.dev3+eaa2df2b")
    (0, 55, True)
    """
    parts = version.split(".")
    try:
        major, minor = int(parts[0]), int(parts[1])
    except (ValueError, IndexError):
        return 0, 0, True
    unstable = len(parts) > 3 or any(
        not p.isdigit() for p in parts[:3] if p
    ) or (len(parts) > 2 and not parts[2].isdigit())
    return major, minor, unstable


MAJOR_VERSION, MINOR_VERSION, IS_UNSTABLE_VERSION = _parse_version(__version__)


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
