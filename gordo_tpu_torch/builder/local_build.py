"""
A config in, trained ``(model, machine)`` pairs out: the port's counterpart
of ``gordo_tpu/builder/local_build.py``. The config is a dict or YAML text
(JSON included), read as ``yaml.safe_load`` reads it (util/yaml_subset.py).
"""

from typing import Any, Iterable, Tuple, Union

from ..machine import Machine
from ..util import yaml_subset
from ..workflow.normalized_config import NormalizedConfig
from .build_model import ModelBuilder


def local_build(config: Union[str, dict], project_name: str = "local-build", device=None
                ) -> Iterable[Tuple[Any, Machine]]:
    """Build each machine of a (possibly multi-machine) config on ``device``
    (``cuda`` unless ``"cpu"``), yielding one (model, machine) pair each."""
    if isinstance(config, str):
        config = yaml_subset.load(config)
    for machine in NormalizedConfig(config, project_name=project_name).machines:
        yield ModelBuilder(machine, device=device).build()
