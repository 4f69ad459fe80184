from .build_model import ModelBuilder
from .local_build import local_build

__all__ = ["ModelBuilder", "local_build"]
