"""
A config in, trained ``(model, machine)`` pairs out: the port's counterpart
of ``gordo_tpu/builder/local_build.py``. The config is a dict or a JSON
string (JSON is a subset of YAML; the port reads no YAML).
"""

import json
from typing import Any, Iterable, Tuple, Union

from ..machine import Machine
from ..workflow.normalized_config import NormalizedConfig
from .build_model import ModelBuilder


def local_build(config: Union[str, dict], project_name: str = "local-build", device=None
                ) -> Iterable[Tuple[Any, Machine]]:
    """Build each machine of a (possibly multi-machine) config on ``device``
    (``cuda`` unless ``"cpu"``), yielding one (model, machine) pair each."""
    if isinstance(config, str):
        config = json.loads(config)
    for machine in NormalizedConfig(config, project_name=project_name).machines:
        yield ModelBuilder(machine, device=device).build()
