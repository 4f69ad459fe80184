"""
Descriptor-based validation of Machine fields: the port's counterpart of
``gordo_tpu/machine/validators.py``. The runtime's pod-fragment schema
checks (``gordo_tpu/workflow/schemas.py``) are not ported: a port build
reads no pod runtime.
"""

import logging
import re

logger = logging.getLogger(__name__)


class BaseDescriptor:
    """Data descriptor validating on __set__."""

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, instance, owner):
        if instance is None:
            return self
        return instance.__dict__.get(self.name)

    def __set__(self, instance, value):
        raise NotImplementedError("Subclass must implement __set__")


class ValidUrlString(BaseDescriptor):
    """A valid k8s DNS label: lowercase alphanumerics and dashes, not
    starting or ending with a dash, at most 63 characters."""

    def __set__(self, instance, value):
        if value is not None and not self.valid_url_string(value):
            raise ValueError(
                f"{self.name}: '{value}' is not a valid name: must match "
                f"[a-z0-9]([-a-z0-9]*[a-z0-9])? and be at most 63 characters"
            )
        instance.__dict__[self.name] = value

    @staticmethod
    def valid_url_string(string: str) -> bool:
        """
        >>> ValidUrlString.valid_url_string("valid-name-here")
        True
        >>> ValidUrlString.valid_url_string("Not_a-valid-name")
        False
        """
        return len(string) <= 63 and bool(re.match(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$", string))


class ValidModel(BaseDescriptor):
    """A model definition that ``from_definition`` can build (a dry run)."""

    def __set__(self, instance, value):
        from ..serializer import from_definition

        if not isinstance(value, dict):
            raise ValueError(f"{self.name} must be a dict definition, got {value!r}")
        try:
            from_definition(value)
        except Exception as exc:
            raise ValueError(f"Invalid model definition: {exc}") from exc
        instance.__dict__[self.name] = value


class ValidDataset(BaseDescriptor):
    def __set__(self, instance, value):
        from ..dataset import GordoBaseDataset

        if not isinstance(value, GordoBaseDataset):
            raise ValueError(f"{self.name} must be a GordoBaseDataset")
        instance.__dict__[self.name] = value


class ValidMetadata(BaseDescriptor):
    def __set__(self, instance, value):
        from .metadata import Metadata

        if value is not None and not isinstance(value, (dict, Metadata)):
            raise ValueError(f"{self.name} must be a dict or Metadata instance")
        instance.__dict__[self.name] = value


def fix_resource_limits(resources: dict) -> dict:
    """Integer cpu/memory requests and limits, each request lowered to its
    limit where it exceeds it."""
    resources = dict(resources)
    for resource_type in ("requests", "limits"):
        if resources.get(resource_type) is not None:
            for key, val in resources[resource_type].items():
                if val is None:
                    continue
                try:
                    resources[resource_type][key] = int(val)
                except ValueError as e:
                    raise ValueError(
                        f"Resource {resource_type}.{key} value {val!r} is not an int"
                    ) from e
    requests = resources.get("requests", {}) or {}
    limits = resources.get("limits", {}) or {}
    for key in ("memory", "cpu"):
        request, limit = requests.get(key), limits.get(key)
        if request is not None and limit is not None and request > limit:
            logger.warning(
                "Resource request %s (%s) exceeds limit (%s); lowering request",
                key, request, limit,
            )
            requests[key] = limit
    return resources


class ValidMachineRuntime(BaseDescriptor):
    """A runtime dict, with the builder's and server's resources fixed up."""

    def __set__(self, instance, value):
        if not isinstance(value, dict):
            raise ValueError(f"{self.name} must be a dict")
        for section in ("builder", "server"):
            if isinstance(value.get(section), dict) and "resources" in value[section]:
                value[section]["resources"] = fix_resource_limits(value[section]["resources"])
        instance.__dict__[self.name] = value
