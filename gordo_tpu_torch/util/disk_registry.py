"""
A file-per-key registry on disk, the build cache's index (a machine
config's content hash to the directory of its artifact): the port's
counterpart of ``gordo_tpu/util/disk_registry.py``.
"""

import logging
import re
from pathlib import Path
from typing import AnyStr, Optional, Union

logger = logging.getLogger(__name__)

_INVALID = re.compile(r"[^a-zA-Z0-9_.-]")


def _key_path(registry_dir: Union[Path, str], key: str) -> Path:
    return Path(registry_dir) / _INVALID.sub("_", key)


def write_key(registry_dir: Union[Path, str], key: str, val: AnyStr):
    """Register a key-value pair, overwriting any value the key had."""
    path = _key_path(registry_dir, key)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.exists():
        logger.warning("Key %s already exists in registry %s; overwriting", key, registry_dir)
    with path.open("wb" if isinstance(val, bytes) else "w") as f:
        f.write(val)


def get_value(registry_dir: Union[Path, str], key: str) -> Optional[str]:
    """The value stored under ``key``, or None if there is none."""
    path = _key_path(registry_dir, key)
    return path.read_text() if path.is_file() else None


def delete_value(registry_dir: Union[Path, str], key: str) -> bool:
    """Delete the stored key; True if something was deleted."""
    path = _key_path(registry_dir, key)
    if path.is_file():
        path.unlink()
        return True
    return False
