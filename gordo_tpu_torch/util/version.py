"""
Docker-tag version grammar: the port's copy of ``gordo_tpu/util/version.py``.
A tag is a Release (N, N.N or N.N.N with an optional suffix), a Special
(``latest``, ``stable``), a PR (``pr-N``) or a SHA (7 to 40 lower-case hex
digits); :func:`parse_version` raises ValueError for anything else.
"""

import re
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Optional


class Version(ABC):
    @abstractmethod
    def get_version(self) -> str:
        """The version rendered back as a docker tag."""


@dataclass(frozen=True)
class GordoRelease(Version):
    major: int
    minor: Optional[int] = None
    patch: Optional[int] = None
    suffix: str = ""

    def get_version(self) -> str:
        parts = [str(self.major)]
        if self.minor is not None:
            parts.append(str(self.minor))
        if self.patch is not None:
            parts.append(str(self.patch))
        return ".".join(parts) + self.suffix

    def only_major(self) -> bool:
        return self.minor is None and self.patch is None

    def only_major_minor(self) -> bool:
        return self.minor is not None and self.patch is None


@dataclass(frozen=True)
class GordoSpecial(Version):
    name: str  # "latest" | "stable"

    def get_version(self) -> str:
        return self.name


@dataclass(frozen=True)
class GordoPR(Version):
    number: int

    def get_version(self) -> str:
        return f"pr-{self.number}"


@dataclass(frozen=True)
class GordoSHA(Version):
    sha: str

    def get_version(self) -> str:
        return self.sha


SPECIALS = ("latest", "stable")
_RELEASE_RE = re.compile(
    r"^(\d+)(?:\.(\d+))?(?:\.(\d+))?((?:[-+.][0-9A-Za-z-.+]+)?)$"
)
_PR_RE = re.compile(r"^pr-(\d+)$")
_SHA_RE = re.compile(r"^[0-9a-f]{7,40}$")


def parse_version(value: str) -> Version:
    """Parse a docker tag into its Version form; ValueError when unparseable."""
    value = value.strip()
    if not value:
        raise ValueError("Empty version")
    if value in SPECIALS:
        return GordoSpecial(value)
    pr = _PR_RE.match(value)
    if pr:
        return GordoPR(int(pr.group(1)))
    release = _RELEASE_RE.match(value)
    if release:
        major, minor, patch, suffix = release.groups()
        return GordoRelease(
            int(major),
            int(minor) if minor is not None else None,
            int(patch) if patch is not None else None,
            suffix or "",
        )
    if _SHA_RE.match(value):
        return GordoSHA(value)
    raise ValueError(f"Unparseable version: {value!r}")
