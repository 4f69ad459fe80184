"""
Argument types of the port's command lines, which parse with argparse and
refuse a value in the words click's types use (``Invalid value for
'--port': ...``), with exit 2: the counterpart of
``gordo_tpu/cli/custom_types.py`` (``HostIP``, ``key_value_par``) and of the
click types the JAX CLIs declare (``IntRange``, ``INT``, ``Choice``, boolean
flags and their environment variables).
"""

import argparse
import ipaddress
import os
from typing import Sequence


def int_range(low: int, high: int):
    """An argparse type: an integer from ``low`` to ``high``, refused in
    click's ``IntRange`` words."""
    def parse(text: str) -> int:
        try:
            value = int(text)
        except ValueError:
            raise argparse.ArgumentTypeError(f"{text!r} is not a valid integer range.")
        if not low <= value <= high:
            raise argparse.ArgumentTypeError(
                f"{value} is not in the range {low}<=x<={high}.")
        return value

    return parse


def integer(text: str) -> int:
    """An argparse type: an integer, refused in click's ``INT`` words."""
    try:
        return int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{text!r} is not a valid integer.")


def choice(values: Sequence[str]):
    """An argparse type: one of ``values``, refused in click's ``Choice``
    words."""
    def parse(text: str) -> str:
        if text not in values:
            listed = ", ".join(repr(v) for v in values)
            raise argparse.ArgumentTypeError(f"{text!r} is not one of {listed}.")
        return text

    return parse


def key_value_par(text: str) -> tuple:
    """An argparse type: ``key,value`` as the pair ``(key, value)`` (the
    value may hold commas), refused as the JAX CLI's ``key_value_par``
    refuses a value without a comma."""
    parts = tuple(text.split(",", 1))
    if len(parts) != 2:
        raise argparse.ArgumentTypeError(
            f"{text!r} is not of the form 'key,value' (missing comma)")
    return parts


def host_ip(text: str) -> str:
    """An argparse type: an IP address, refused as the JAX CLI's ``HostIP``
    refuses what is not one."""
    try:
        ipaddress.ip_address(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{text!r} is not a valid IP address")
    return text


def env_flag(name: str, default: bool) -> bool:
    """A boolean environment variable as click reads one."""
    value = os.environ.get(name, "").strip().lower()
    if not value:
        return default
    if value in ("1", "true", "t", "yes", "y", "on"):
        return True
    if value in ("0", "false", "f", "no", "n", "off"):
        return False
    raise ValueError(f"{name}={value!r} is not a boolean")


def flag_pair(parser: argparse.ArgumentParser, on: str, off: str, default: bool,
              env: str = None, help: str = None) -> None:
    """click's ``--on/--off`` boolean option: both flags set one value, whose
    default is ``env``'s (read as click reads it) or ``default``."""
    dest = on.lstrip("-").replace("-", "_")
    value = env_flag(env, default) if env else default
    parser.add_argument(on, dest=dest, action="store_true", default=value, help=help)
    parser.add_argument(off, dest=dest, action="store_false")
