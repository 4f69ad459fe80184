"""
Sensor tags: the port's counterpart of ``gordo_tpu/dataset/sensor_tag.py``.
"""

from dataclasses import dataclass
from typing import List, Optional, Union


class SensorTagNormalizationError(ValueError):
    """Raised when a tag cannot be normalized into a SensorTag."""


@dataclass(frozen=True)
class SensorTag:
    name: str
    asset: Optional[str] = None

    def to_json(self):
        return {"name": self.name, "asset": self.asset}

    @classmethod
    def from_json(cls, obj: dict) -> "SensorTag":
        return cls(name=obj["name"], asset=obj.get("asset"))


TagLike = Union[str, dict, list, tuple, SensorTag]


def normalize_sensor_tag(tag: TagLike, asset: Optional[str] = None) -> SensorTag:
    """Any accepted tag form as a ``SensorTag``: a ``SensorTag``,
    ``"TAG-NAME"``, ``{"name": ..., "asset": ...}`` or ``["TAG-NAME", "asset"]``."""
    if isinstance(tag, SensorTag):
        return tag
    if isinstance(tag, str):
        return SensorTag(name=tag, asset=asset)
    if isinstance(tag, dict):
        if "name" not in tag:
            raise SensorTagNormalizationError(f"Tag dict missing 'name': {tag!r}")
        return SensorTag(name=str(tag["name"]), asset=tag.get("asset", asset))
    if isinstance(tag, (list, tuple)):
        if not tag:
            raise SensorTagNormalizationError("Empty tag list element")
        name = str(tag[0])
        tag_asset = str(tag[1]) if len(tag) > 1 else asset
        return SensorTag(name=name, asset=tag_asset)
    raise SensorTagNormalizationError(f"Unsupported tag representation: {tag!r}")


def normalize_sensor_tags(tags: List[TagLike], asset: Optional[str] = None
                          ) -> List[SensorTag]:
    return [normalize_sensor_tag(t, asset=asset) for t in tags]


def to_list_of_strings(tags: List[SensorTag]) -> List[str]:
    return [t.name for t in tags]
