"""
Small helpers: the port's copy of ``parse_service_uri`` from
``gordo_tpu/util/utils.py``.
"""

from typing import Tuple


def parse_service_uri(uri, default_host: str = "localhost", default_port: int = 8086,
                      default_path: str = "") -> Tuple[str, str, int, str]:
    """A service address in either grammar of gordo configs,
    ``scheme://host:port/path`` or the scheme-less ``host:port/path``, as
    ``(scheme, host, port, path)``; the scheme is ``''`` when none is given.
    Raises ValueError naming the uri when its port is not an integer."""
    scheme = ""
    rest = uri or ""
    if "://" in rest:
        scheme, _, rest = rest.partition("://")
    host_port, _, path = rest.partition("/")
    host, _, port_str = host_port.partition(":")
    try:
        port = int(port_str) if port_str else default_port
    except ValueError:
        raise ValueError(f"Invalid port in service uri {uri!r}: {port_str!r}")
    return scheme, host or default_host, port, path or default_path
