"""
Small helpers: the port's copies of ``capture_args`` and
``parse_service_uri`` from ``gordo_tpu/util/utils.py``.
"""

import functools
import inspect
from typing import Tuple


def capture_args(method):
    """Decorate an ``__init__`` so that the arguments of each call, the
    defaults included and ``**kwargs`` spread out, land in ``self._params``:
    the objects' ``get_params`` (the reporters')."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        bound = inspect.signature(method).bind(self, *args, **kwargs)
        bound.apply_defaults()
        params = dict(bound.arguments)
        params.pop("self", None)
        if "kwargs" in params:
            params.update(params.pop("kwargs"))
        self._params = params
        return method(self, *args, **kwargs)

    return wrapper


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
