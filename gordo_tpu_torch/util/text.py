"""Text helpers: the port's copy of ``gordo_tpu/util/text.py``."""

import re

_non_ascii = re.compile(r"[^\x00-\x7F]")


def replace_all_non_ascii_chars(s: str, replacement: str = "?") -> str:
    """Every non-ASCII character of ``s`` replaced (a Kubernetes termination
    message must be ASCII)."""
    return _non_ascii.sub(replacement, s)
