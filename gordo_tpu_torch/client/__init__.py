"""
The prediction client: the port's counterpart of ``gordo_tpu/client/``,
without ``requests``, ``pandas`` or ``pyarrow``. ``Client`` predicts a time
range for some or all machines of a project over HTTP (JSON bodies), reads
their metadata and downloads their models; ``python -m
gordo_tpu_torch.client`` is its command line (client/cli.py).
"""

from .client import Client
from .utils import PredictionResult

__all__ = ["Client", "PredictionResult"]
