"""
The reporters' base class: the port's counterpart of
``gordo_tpu/reporters/base.py``. A reporter is declared in a machine's
``runtime.reporters`` as a definition, built through the serializer and
written back by it with the JAX package's path.
"""

import abc


class ReporterException(Exception):
    """A reporter failed (exit code 90 in the CLI)."""


class BaseReporter(abc.ABC):
    @abc.abstractmethod
    def report(self, machine):
        """Send the machine's metadata to the reporter's sink."""

    def get_params(self, deep=False):
        return dict(getattr(self, "_params", {}))

    def to_dict(self) -> dict:
        from ..serializer import into_definition

        return into_definition(self)

    @classmethod
    def from_dict(cls, config: dict) -> "BaseReporter":
        from ..serializer import from_definition

        obj = from_definition(config)
        if not isinstance(obj, BaseReporter):
            raise ReporterException(f"Expected a reporter, got {type(obj)}")
        return obj
