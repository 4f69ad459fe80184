from .machine import Machine, MachineEncoder
from .metadata import (
    BuildMetadata, CrossValidationMetaData, DatasetBuildMetadata, Metadata, ModelBuildMetadata,
)

__all__ = [
    "Machine",
    "MachineEncoder",
    "Metadata",
    "BuildMetadata",
    "ModelBuildMetadata",
    "CrossValidationMetaData",
    "DatasetBuildMetadata",
]
