"""
Where a built machine is reported: the port's counterpart of
``gordo_tpu/reporters/``. ``runtime.reporters`` names them by the JAX
package's paths (serializer/resolver.py); ``Machine.report`` runs each
after the artifact is written.
"""

from .base import BaseReporter, ReporterException

__all__ = ["BaseReporter", "ReporterException"]
