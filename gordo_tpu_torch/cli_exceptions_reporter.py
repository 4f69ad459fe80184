"""
Exception to JSON report and exit code: the port's copy of
``gordo_tpu/cli/exceptions_reporter.py``.

``ExceptionsReporter`` maps an exception's class to an exit code (the most
derived class of its table wins) and writes a report file, the Kubernetes
``terminationMessagePath`` of a builder pod: at ``ReportLevel`` ``EXIT_CODE``
only ``exit_code``, at ``TYPE`` also ``type``, at ``MESSAGE`` also
``message``, at ``TRACEBACK`` also ``traceback``, every text made ASCII and,
with ``max_message_len``, the whole JSON document trimmed to that many
characters: the traceback keeps its innermost frames and the message its
head, each marked where it was cut.
"""

import enum
import json
import traceback
from typing import IO, List, Optional, Tuple, Type

from .util.text import replace_all_non_ascii_chars


class ReportLevel(enum.Enum):
    EXIT_CODE = 0
    TYPE = 1
    MESSAGE = 2
    TRACEBACK = 3

    @classmethod
    def get_by_name(cls, name: str, default: Optional["ReportLevel"] = None):
        for level in cls:
            if level.name == name.upper():
                return level
        return default

    @classmethod
    def get_names(cls) -> List[str]:
        return [level.name for level in cls]


DEFAULT_EXIT_CODE = 1
_TRIMMED = "...(trimmed)...\n"


class ExceptionsReporter:
    """Exit codes by exception class, and the JSON crash report."""

    def __init__(self, exceptions: Tuple[Tuple[Type[BaseException], int], ...],
                 default_exit_code: int = DEFAULT_EXIT_CODE):
        # the most derived classes first, so the first match is the closest
        self.exceptions = sorted(exceptions, key=lambda pair: len(pair[0].__mro__),
                                 reverse=True)
        self.default_exit_code = default_exit_code

    def exception_exit_code(self, exc_type: Optional[Type[BaseException]]) -> int:
        if exc_type is None:
            return 0
        for klass, exit_code in self.exceptions:
            if issubclass(exc_type, klass):
                return exit_code
        return self.default_exit_code

    def report(self, level: ReportLevel, exc_type, exc_value, exc_traceback,
               report_file: IO[str], max_message_len: Optional[int] = None) -> None:
        doc: dict = {}
        tb_original = ""
        if exc_type is not None:
            if level.value >= ReportLevel.TYPE.value:
                doc["type"] = exc_type.__name__
            if level.value >= ReportLevel.MESSAGE.value:
                doc["message"] = replace_all_non_ascii_chars(str(exc_value))
            if level.value >= ReportLevel.TRACEBACK.value and exc_traceback is not None:
                tb_original = replace_all_non_ascii_chars(
                    "".join(traceback.format_tb(exc_traceback)))
                doc["traceback"] = tb_original
        doc["exit_code"] = self.exception_exit_code(exc_type)
        if max_message_len is not None:
            _trim(doc, max_message_len, tb_original)
        json.dump(doc, report_file)

    def safe_report(self, level: ReportLevel, exc_type, exc_value, exc_traceback,
                    report_file_path: str, max_message_len: Optional[int] = None) -> None:
        """:meth:`report` into ``report_file_path``; a failure to write it
        is printed, never raised over the exception being reported."""
        try:
            with open(report_file_path, "w") as f:
                self.report(level, exc_type, exc_value, exc_traceback, f, max_message_len)
        except Exception:  # noqa: BLE001 -- reporting must not mask the failure
            traceback.print_exc()


def _trim(doc: dict, limit: int, tb_original: str) -> None:
    """Shrink ``doc`` until its JSON is at most ``limit`` characters: the
    traceback (its head, after the trim marker) to 200 characters, then the
    message (its tail) to 120, then each to nothing; a cut message ends in
    ``...``."""
    msg_original = doc.get("message", "")

    def doc_len() -> int:
        return len(json.dumps(doc))

    def shrink(key: str, keep_tail: bool, floor: int, prefix: int = 0) -> None:
        while doc_len() > limit:
            value = doc.get(key) or ""
            if len(value) <= floor:
                return
            cut = min(max((doc_len() - limit) // 2, 1), len(value) - floor)
            doc[key] = value[:prefix] + value[prefix + cut:] if keep_tail else value[:-cut]

    if doc.get("traceback"):
        doc["traceback"] = _TRIMMED + doc["traceback"]
    mark = len(_TRIMMED)
    shrink("traceback", keep_tail=True, floor=mark + 200, prefix=mark)
    shrink("message", keep_tail=False, floor=120)
    shrink("traceback", keep_tail=True, floor=mark, prefix=mark)
    shrink("message", keep_tail=False, floor=0)
    if doc.get("traceback") == _TRIMMED + tb_original:
        doc["traceback"] = tb_original  # nothing was cut: no marker
    if doc.get("message") and doc["message"] != msg_original:
        message = doc["message"]
        doc["message"] = message[:-3] + "..." if len(message) > 3 else "..."
