"""
Build metadata records: the port's counterpart of
``gordo_tpu/machine/metadata.py``, plain dataclasses with the same fields
and their own ``to_dict``/``from_dict`` (nested records are built from
nested dicts; unknown keys are ignored).
"""

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


class _Record:
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: dict):
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in data:
                value = data[f.name]
                if dataclasses.is_dataclass(f.type) and isinstance(value, dict):
                    value = f.type.from_dict(value)
                kwargs[f.name] = value
        return cls(**kwargs)


@dataclass
class CrossValidationMetaData(_Record):
    scores: Dict[str, Any] = field(default_factory=dict)
    cv_duration_sec: Optional[float] = None
    splits: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ModelBuildMetadata(_Record):
    model_offset: int = 0
    model_creation_date: Optional[str] = None
    model_builder_version: Optional[str] = None
    cross_validation: CrossValidationMetaData = field(default_factory=CrossValidationMetaData)
    model_training_duration_sec: Optional[float] = None
    model_meta: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DatasetBuildMetadata(_Record):
    query_duration_sec: Optional[float] = None
    dataset_meta: Dict[str, Any] = field(default_factory=dict)


@dataclass
class BuildMetadata(_Record):
    model: ModelBuildMetadata = field(default_factory=ModelBuildMetadata)
    dataset: DatasetBuildMetadata = field(default_factory=DatasetBuildMetadata)
    # the fleet builder's quarantine and retry records: empty on this path
    fault_domain: Dict[str, Any] = field(default_factory=dict)
    # seconds per build phase: fetch, validate, cross_validation, fit
    phases: Dict[str, float] = field(default_factory=dict)


@dataclass
class Metadata(_Record):
    user_defined: Dict[str, Any] = field(default_factory=dict)
    build_metadata: BuildMetadata = field(default_factory=BuildMetadata)
