"""
``Machine``: one asset's dataset, model and evaluation settings, the unit a
build turns into an artifact. The port's counterpart of
``gordo_tpu/machine/machine.py``: the same merge of a machine block with the
project's ``globals``, the same ``to_dict``/``from_dict``. Reporters are not
ported (see ROADMAP.md queue A), so ``report`` raises if the runtime names one.
"""

import json
import logging
from datetime import datetime
from typing import Any, Dict, Optional, Union

import numpy as np

from ..dataset import GordoBaseDataset
from ..workflow.helpers import patch_dict
from .metadata import Metadata
from .validators import (
    ValidDataset, ValidMachineRuntime, ValidMetadata, ValidModel, ValidUrlString,
)

logger = logging.getLogger(__name__)

# How each section of a machine block merges with the project's globals:
# "machine" means the machine's keys override the globals, "globals" the
# reverse (the project forces the dataset window and provider on every machine).
_MERGE_POLICY = {
    "runtime": "machine",
    "evaluation": "machine",
    "dataset": "globals",
}


def _merged_section(section: str, machine_cfg: dict, globals_cfg: dict) -> dict:
    local = machine_cfg.get(section) or {}
    shared = globals_cfg.get(section) or {}
    if _MERGE_POLICY[section] == "machine":
        return patch_dict(shared, local)
    return patch_dict(local, shared)


class Machine:
    """One machine block from a project config, validated and coerced."""

    name = ValidUrlString()
    project_name = ValidUrlString()
    host = ValidUrlString()
    model = ValidModel()
    dataset = ValidDataset()
    metadata = ValidMetadata()
    runtime = ValidMachineRuntime()

    def __init__(
        self,
        name: str,
        model: dict,
        dataset: Union[GordoBaseDataset, dict],
        project_name: str,
        evaluation: Optional[dict] = None,
        metadata: Optional[Union[dict, Metadata]] = None,
        runtime=None,
    ):
        self.name = name
        self.project_name = project_name
        self.model = model
        self.dataset = (
            dataset if isinstance(dataset, GordoBaseDataset)
            else GordoBaseDataset.from_dict(dataset)
        )
        self.runtime = {} if runtime is None else runtime
        self.evaluation = {"cv_mode": "full_build"} if evaluation is None else evaluation
        metadata = {} if metadata is None else metadata
        self.metadata = metadata if isinstance(metadata, Metadata) else Metadata.from_dict(metadata)
        self.host = f"gordoserver-{project_name}-{name}"

    @classmethod
    def from_config(cls, config: Dict[str, Any], project_name: str = "project",
                    config_globals: Optional[dict] = None) -> "Machine":
        """A Machine from one machine block merged with ``globals``."""
        g = config_globals or {}
        user_metadata = {
            "global-metadata": g.get("metadata") or {},
            "machine-metadata": config.get("metadata") or {},
        }
        return cls(
            name=config["name"],
            model=config.get("model") or g.get("model"),
            dataset=_merged_section("dataset", config, g),
            project_name=project_name,
            evaluation=_merged_section("evaluation", config, g),
            metadata=Metadata(user_defined=user_metadata),
            runtime=_merged_section("runtime", config, g),
        )

    @classmethod
    def from_dict(cls, d: dict) -> "Machine":
        """Inverse of :meth:`to_dict`."""
        return cls(**d)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "dataset": self.dataset.to_dict(),
            "model": self.model,
            "metadata": self.metadata.to_dict(),
            "runtime": self.runtime,
            "project_name": self.project_name,
            "evaluation": self.evaluation,
        }

    def report(self):
        """Reporters are not ported: raises if the runtime names any."""
        if self.runtime.get("reporters"):
            raise NotImplementedError(
                "reporters are not ported yet: see the 'Training, the rest of the "
                "build path' item of ROADMAP.md queue A"
            )

    def __eq__(self, other):
        return self.to_dict() == other.to_dict()

    def __str__(self):
        return json.dumps(self.to_dict(), indent=2, cls=MachineEncoder)


# (predicate, converter) pairs tried in order by MachineEncoder
_JSON_FALLBACKS = (
    (lambda o: isinstance(o, datetime), lambda o: o.isoformat()),
    (lambda o: np.issubdtype(type(o), np.floating), float),
    (lambda o: np.issubdtype(type(o), np.integer), int),
)


class MachineEncoder(json.JSONEncoder):
    """JSON encoder tolerating datetimes and numpy scalars."""

    def default(self, obj):
        for accepts, convert in _JSON_FALLBACKS:
            if accepts(obj):
                return convert(obj)
        return super().default(obj)
