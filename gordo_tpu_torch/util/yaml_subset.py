"""
A YAML reader and writer for configs, without a YAML library: the port's
counterpart of ``yaml.safe_load`` / ``yaml.safe_load_all`` as the JAX
package calls them (PyYAML's ``SafeLoader``, YAML 1.1), and of the config
loader of ``gordo_tpu/workflow/workflow_generator.py``
(``get_dict_from_yaml``, with its tz-aware timestamps and its Gordo CRD
unwrap), which the workflow generator will use.

:func:`load` reads block and flow mappings and sequences (an indentless
sequence as a mapping's value too, and compact ``- key: value`` entries),
plain scalars over several lines, single- and double-quoted scalars with
their escapes and line folding, literal and folded block scalars (``|``,
``>``) with their chomping and indentation indicators, comments, and
``---`` / ``...`` documents. A plain scalar is typed as ``SafeLoader``
types it: ``yes``/``no``/``on``/``off`` and ``true``/``false`` in three
cases are booleans; ``~``, ``null`` and nothing are None; ints are decimal,
octal (``0123``), hex, binary or base 60 (``1:30``), with underscores;
floats need a dot (``1e3`` is a string, ``1.0e+3`` a float) and include
``.inf`` and ``.nan``; ``2019-01-01`` is a date and
``2019-01-01T00:00:00+00:00`` a datetime, tz-aware where it has a zone.
A quoted or block scalar is a string. JSON is YAML, so a JSON config reads
as it does in the JAX package (with YAML 1.1's types).

Refused, with a :class:`YAMLSubsetError` that names the construct, its
line and its column: anchors, aliases, tags, merge keys (``<<``), explicit
keys (``?``), flow collections as keys, single-pair mappings in flow
sequences, ``%`` directives, the ``=`` value key, tabs outside quoted and
block scalars, non-printable characters, and anything malformed. No config
of the repo uses any of them; each would change the result if it were read
as something else.

:func:`dump` writes block-style YAML that :func:`load` (and PyYAML) read
back equal: the templates' ``yaml`` filter (util/templates.py).
"""

import bisect
import datetime as _dt
import os
import re
from typing import Any, List, Optional

__all__ = ["YAMLSubsetError", "TimestampNotTZAware", "load", "load_all", "load_config", "dump"]


class YAMLSubsetError(ValueError):
    """A construct the reader refuses, or malformed YAML, at a 1-based line
    and column."""

    def __init__(self, construct: str, line: int, column: int):
        self.construct, self.line, self.column = construct, line, column
        super().__init__(f"{construct} at line {line}, column {column}")


class TimestampNotTZAware(ValueError):
    """A timestamp of a config has no timezone (the JAX loader's error)."""


_BLANKZ = " \t\n\0"
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_HEX = set("0123456789abcdefABCDEF")
# what YAML 1.1 readers take as characters at all (PyYAML's reader), less
# the three Unicode line breaks, which YAML 1.1 folds like "\n"
_NON_PRINTABLE = re.compile(
    "[^\x09\x0a\x0d\x20-\x7e\xa0-\u2027\u202a-\ud7ff\ue000-\ufffd\U00010000-\U0010ffff]")

# the implicit types of plain scalars, in SafeLoader's order of trial
_IMPLICIT = (
    ("bool", re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                        |true|True|TRUE|false|False|FALSE
                        |on|On|ON|off|Off|OFF)$""", re.X)),
    ("float", re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                         |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                         |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                         |[-+]?\.(?:inf|Inf|INF)
                         |\.(?:nan|NaN|NAN))$""", re.X)),
    ("int", re.compile(r"""^(?:[-+]?0b[0-1_]+
                       |[-+]?0[0-7_]+
                       |[-+]?(?:0|[1-9][0-9_]*)
                       |[-+]?0x[0-9a-fA-F_]+
                       |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)),
    ("merge", re.compile(r"^(?:<<)$")),
    ("null", re.compile(r"""^(?: ~
                        |null|Null|NULL
                        | )$""", re.X)),
    ("timestamp", re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                             |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                              (?:[Tt]|[ \t]+)[0-9][0-9]?
                              :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                              (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)),
    ("value", re.compile(r"^(?:=)$")),
)
_TIMESTAMP = re.compile(r"""^(?P<year>[0-9][0-9][0-9][0-9])
                         -(?P<month>[0-9][0-9]?)
                         -(?P<day>[0-9][0-9]?)
                         (?:(?:[Tt]|[ \t]+)
                         (?P<hour>[0-9][0-9]?)
                         :(?P<minute>[0-9][0-9])
                         :(?P<second>[0-9][0-9])
                         (?:\.(?P<fraction>[0-9]*))?
                         (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
                         (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)


def _signed(text: str):
    """(sign, digits) of an int or float scalar without its underscores."""
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    return sign, text[1:] if text[0] in "+-" else text


def _base60(digits: str, cast):
    value, base = cast(0), 1
    for part in reversed(digits.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def _construct_int(text: str) -> int:
    sign, digits = _signed(text)
    if digits == "0":
        return 0
    if digits.startswith("0b"):
        return sign * int(digits[2:], 2)
    if digits.startswith("0x"):
        return sign * int(digits[2:], 16)
    if digits[0] == "0":
        return sign * int(digits, 8)
    if ":" in digits:
        return sign * _base60(digits, int)
    return sign * int(digits)


def _construct_float(text: str) -> float:
    sign, digits = _signed(text.lower())
    if digits == ".inf":
        return sign * float("inf")
    if digits == ".nan":
        return float("nan")
    if ":" in digits:
        return sign * _base60(digits, float)
    return sign * float(digits)


def _construct_timestamp(text: str):
    v = _TIMESTAMP.match(text).groupdict()
    year, month, day = int(v["year"]), int(v["month"]), int(v["day"])
    if not v["hour"]:
        return _dt.date(year, month, day)
    fraction = int((v["fraction"] or "")[:6].ljust(6, "0"))
    tzinfo = None
    if v["tz_sign"]:
        delta = _dt.timedelta(hours=int(v["tz_hour"]), minutes=int(v["tz_minute"] or 0))
        tzinfo = _dt.timezone(-delta if v["tz_sign"] == "-" else delta)
    elif v["tz"]:
        tzinfo = _dt.timezone.utc
    return _dt.datetime(year, month, day, int(v["hour"]), int(v["minute"]), int(v["second"]),
                        fraction, tzinfo=tzinfo)


_CONSTRUCT = {
    "bool": lambda text: text.lower() in ("yes", "true", "on"),
    "float": _construct_float,
    "int": _construct_int,
    "null": lambda text: None,
    "timestamp": _construct_timestamp,
}


class _Reader:
    """One pass over a stream's text: ``pos`` is the next character."""

    def __init__(self, text: str, tz_aware: bool = False):
        if text.startswith("\ufeff"):
            text = text[1:]
        bad = _NON_PRINTABLE.search(text)
        text = text.replace("\r\n", "\n").replace("\r", "\n")
        self.s = text
        self.pos = 0
        self.tz_aware = tz_aware
        self.line_starts = [0] + [m.end() for m in re.finditer("\n", text)]
        if bad:
            self.fail(f"a non-printable character {bad.group()!r}", bad.start())

    # -- positions
    def ch(self, k: int = 0) -> str:
        i = self.pos + k
        return self.s[i] if i < len(self.s) else "\0"

    def line_start(self, pos: int) -> int:
        return self.line_starts[bisect.bisect_right(self.line_starts, pos) - 1]

    def col(self, pos: Optional[int] = None) -> int:
        pos = self.pos if pos is None else pos
        return pos - self.line_start(pos)

    def fail(self, construct: str, pos: Optional[int] = None):
        pos = self.pos if pos is None else pos
        raise YAMLSubsetError(construct, bisect.bisect_right(self.line_starts, pos),
                              self.col(pos) + 1)

    def at_marker(self, marker: Optional[str] = None) -> bool:
        """At ``---`` or ``...`` (or ``marker``) in the first column."""
        head = self.s[self.pos:self.pos + 3]
        return (self.col() == 0 and head in ((marker,) if marker else ("---", "..."))
                and self.ch(3) in _BLANKZ)

    # -- space and comments
    def skip_comment(self) -> None:
        while self.ch() not in "\n\0":
            self.pos += 1

    def skip_to_token(self) -> None:
        """Past spaces, comments and line breaks to the next token."""
        while True:
            c = self.ch()
            if c == " " or c == "\n":
                self.pos += 1
            elif c == "#":
                self.skip_comment()
            elif c == "\t":
                self.fail("a tab outside a quoted or block scalar")
            else:
                return

    def skip_inline(self) -> bool:
        """Past spaces and a comment on this line; True when the line ends."""
        while self.ch() == " ":
            self.pos += 1
        if self.ch() == "#":
            self.skip_comment()
        if self.ch() == "\t":
            self.fail("a tab outside a quoted or block scalar")
        return self.ch() in "\n\0"

    def line_end(self) -> None:
        """After a node that began on its key's or entry's line: only space
        and a comment before the line ends (or the node already ended at the
        start of a later line)."""
        if not self.skip_inline() and self.s[self.line_start(self.pos):self.pos].strip(" "):
            self.fail(f"unexpected {self.ch()!r} after a node")

    def refuse_properties(self, flow: bool = False) -> None:
        c = self.ch()
        if c == "&":
            self.fail("an anchor ('&')")
        if c == "*":
            self.fail("an alias ('*')")
        if c == "!":
            self.fail("a tag ('!')")
        if c == "?" and (flow or self.ch(1) in _BLANKZ):
            self.fail("an explicit key ('?')")
        if c in "@`":
            self.fail(f"a reserved indicator ({c!r})")

    # -- documents
    def documents(self) -> List[Any]:
        docs: List[Any] = []
        self.skip_to_token()
        while self.ch() != "\0":
            if self.ch() == "%" and self.col() == 0:
                self.fail("a directive ('%')")
            if self.at_marker("..."):
                self.pos += 3
                self.line_end()
                self.skip_to_token()
                continue
            if self.at_marker("---"):
                self.pos += 3
                if not self.skip_inline():
                    node = self.block_node(-1, "document")
                    self.line_end()
                else:
                    self.skip_to_token()
                    node = (None if self.ch() == "\0" or self.at_marker()
                            else self.block_node(-1, None))
            elif docs:
                self.fail("a document after another without '---'")
            else:
                node = self.block_node(-1, None)
            docs.append(node)
            self.skip_to_token()
            if self.at_marker("..."):
                self.pos += 3
                self.line_end()
                self.skip_to_token()
                if self.ch() != "\0" and not self.at_marker("---"):
                    self.fail("a document after '...' without '---'")
            elif self.ch() != "\0" and not self.at_marker("---"):
                self.fail(f"unexpected {self.ch()!r} after the document's root node")
        return docs

    # -- block structure
    def block_node(self, parent: int, after: Optional[str]):
        """The node at ``pos``: ``parent`` is the column of the enclosing
        block collection (-1 at the root); ``after`` says whether the node
        began on the line of a key (``"value"``), of a sequence entry
        (``"entry"``), of ``---`` (``"document"``) or on a line of its own."""
        self.refuse_properties()
        c, col = self.ch(), self.col()
        if c == "-" and self.ch(1) in _BLANKZ:
            if after in ("value", "document"):
                self.fail("a block sequence on the line of its key")
            return self.block_sequence(col)
        if c in "|>":
            return self.block_scalar(parent)
        if self.simple_key_ahead():
            if after in ("value", "document"):
                self.fail("a block mapping on the line of its key")
            return self.block_mapping(col)
        return self.flow_node(parent, flow=False)

    def simple_key_ahead(self) -> bool:
        """Whether a ``key:`` (a scalar, then ``:`` and a blank) starts at
        ``pos`` on this line."""
        start, c = self.pos, self.ch()
        try:
            if c in "\"'":
                self.quoted()
                if "\n" in self.s[start:self.pos]:
                    return False
            elif c in "[{":
                self.flow_collection()
                while self.ch() == " ":
                    self.pos += 1
                if self.ch() == ":" and self.ch(1) in _BLANKZ:
                    self.fail("a flow collection as a mapping key", start)
                return False
            else:
                while self.ch() not in "\n\0":
                    if self.ch() == ":" and self.ch(1) in _BLANKZ:
                        return True
                    if self.ch() == "#" and self.s[self.pos - 1] in " \t":
                        return False
                    self.pos += 1
                return False
            while self.ch() == " ":
                self.pos += 1
            return self.ch() == ":" and self.ch(1) in _BLANKZ
        except YAMLSubsetError as exc:
            if exc.construct == "a flow collection as a mapping key":
                raise
            return False
        finally:
            self.pos = start

    def key(self):
        """A block mapping's key, up to its ``:``."""
        start = self.pos
        self.refuse_properties()
        if self.ch() in "[{":
            self.fail("a flow collection as a mapping key")
        if self.ch() in "\"'":
            key = self.quoted()
        else:
            key = self.resolve(self.plain(0, flow=False), start)
        while self.ch() == " ":
            self.pos += 1
        if self.ch() != ":" or self.ch(1) not in _BLANKZ:
            self.fail("a mapping key without ':'", start)
        self.pos += 1
        return key

    def block_mapping(self, col: int) -> dict:
        out: dict = {}
        while True:
            key = self.key()
            if self.skip_inline():
                self.skip_to_token()
                if self.ch() == "\0" or self.at_marker():
                    value = None
                elif self.col() > col:
                    value = self.block_node(col, None)
                elif self.col() == col and self.ch() == "-" and self.ch(1) in _BLANKZ:
                    value = self.block_sequence(col)  # indentless, as PyYAML reads it
                else:
                    value = None
            else:
                value = self.block_node(col, "value")
                self.line_end()
            out[key] = value
            self.skip_to_token()
            if self.ch() == "\0" or self.at_marker() or self.col() < col:
                return out
            if self.col() > col:
                self.fail("a mapping entry indented more than its mapping")
            if not self.simple_key_ahead():
                self.refuse_properties()
                self.fail("a block mapping entry without a key")

    def block_sequence(self, col: int) -> list:
        out: list = []
        while True:
            self.pos += 1  # the '-'
            if self.skip_inline():
                self.skip_to_token()
                out.append(self.block_node(col, None) if (
                    self.ch() != "\0" and not self.at_marker() and self.col() > col) else None)
            else:
                out.append(self.block_node(col, "entry"))
                self.line_end()
            self.skip_to_token()
            if self.ch() == "\0" or self.at_marker() or self.col() < col:
                return out
            if self.col() > col:
                self.fail("a sequence entry indented more than its sequence")
            if not (self.ch() == "-" and self.ch(1) in _BLANKZ):
                return out

    def block_scalar(self, parent: int) -> str:
        start = self.pos
        folded = self.ch() == ">"
        self.pos += 1
        chomping = increment = None
        for _ in range(2):
            c = self.ch()
            if c in "+-" and chomping is None:
                chomping = c == "+"
            elif c in "0123456789" and increment is None:
                if c == "0":
                    self.fail("an indentation indicator of 0")
                increment = int(c)
            else:
                break
            self.pos += 1
        if not self.skip_inline():
            self.fail("text after a block scalar's header", start)
        if self.ch() == "\n":
            self.pos += 1
        min_indent = max(parent + 1, 1)
        if increment is None:
            breaks, max_indent = self._block_indentation()
            indent = max(min_indent, max_indent)
        else:
            indent = min_indent + increment - 1
            breaks = self._block_breaks(indent)
        chunks: List[str] = []
        line_break = ""
        while self.col() == indent and self.ch() != "\0":
            chunks.extend(breaks)
            leading_non_space = self.ch() not in " \t"
            end = self.s.find("\n", self.pos)
            end = len(self.s) if end < 0 else end
            chunks.append(self.s[self.pos:end])
            self.pos = end
            line_break = "\n" if self.ch() == "\n" else ""
            self.pos += len(line_break)
            breaks = self._block_breaks(indent)
            if not (self.col() == indent and self.ch() != "\0"):
                break
            if folded and line_break and leading_non_space and self.ch() not in " \t":
                if not breaks:
                    chunks.append(" ")
            else:
                chunks.append(line_break)
        if chomping is not False:
            chunks.append(line_break)
        if chomping is True:
            chunks.extend(breaks)
        return "".join(chunks)

    def _block_indentation(self):
        breaks, max_indent = [], 0
        while self.ch() in " \n":
            if self.ch() == " ":
                self.pos += 1
                max_indent = max(max_indent, self.col())
            else:
                breaks.append("\n")
                self.pos += 1
        return breaks, max_indent

    def _block_breaks(self, indent: int) -> List[str]:
        breaks = []
        while self.col() < indent and self.ch() == " ":
            self.pos += 1
        while self.ch() == "\n":
            breaks.append("\n")
            self.pos += 1
            while self.col() < indent and self.ch() == " ":
                self.pos += 1
        return breaks

    # -- flow nodes and scalars
    def flow_node(self, parent: int, flow: bool):
        self.refuse_properties(flow)
        c, start = self.ch(), self.pos
        if c in "[{":
            return self.flow_collection()
        if c in "\"'":
            return self.quoted()
        if c in "\0 \t\n,[]{}#|>%" or (c in "-?:" and (self.ch(1) in _BLANKZ or (
                flow and c != "-"))):
            self.fail(f"{c!r} cannot start a scalar")
        return self.resolve(self.plain(parent + 1, flow), start)

    def flow_skip(self) -> None:
        self.skip_to_token()
        if self.at_marker():
            self.fail("a document marker inside a flow collection")

    def flow_collection(self):
        start, opener = self.pos, self.ch()
        closer = "]" if opener == "[" else "}"
        out: Any = [] if opener == "[" else {}
        self.pos += 1
        while True:
            self.flow_skip()
            if self.ch() == closer:
                self.pos += 1
                return out
            if self.ch() == "\0":
                self.fail("an unterminated flow collection", start)
            item_pos = self.pos
            item = self.flow_node(0, flow=True)
            self.flow_skip()
            if opener == "{":
                if isinstance(item, (list, dict)):
                    self.fail("a flow collection as a mapping key", item_pos)
                value = None
                if self.ch() == ":":
                    self.pos += 1
                    self.flow_skip()
                    if self.ch() not in ",}":
                        value = self.flow_node(0, flow=True)
                        self.flow_skip()
                out[item] = value
            else:
                if self.ch() == ":":
                    self.fail("a single-pair mapping in a flow sequence", item_pos)
                out.append(item)
            if self.ch() == ",":
                self.pos += 1
            elif self.ch() != closer:
                self.fail(f"expected ',' or {closer!r} in a flow collection")

    def plain(self, indent: int, flow: bool) -> str:
        """A plain scalar's text, folded over lines indented at least
        ``indent`` (block context)."""
        chunks: List[str] = []
        spaces: List[str] = []
        stops = _BLANKZ + (",[]{}" if flow else "")
        while self.ch() != "#":
            n = 0
            while True:
                c = self.ch(n)
                if c in _BLANKZ or (c == ":" and self.ch(n + 1) in stops) or (
                        flow and c in ",?[]{}"):
                    break
                n += 1
            if n == 0:
                break
            chunks.extend(spaces)
            chunks.append(self.s[self.pos:self.pos + n])
            self.pos += n
            spaces = self._plain_spaces()
            if not spaces or self.ch() == "#" or (not flow and self.col() < indent):
                break
        return "".join(chunks)

    def _plain_spaces(self) -> List[str]:
        start = self.pos
        while self.ch() == " ":
            self.pos += 1
        white = self.s[start:self.pos]
        if self.ch() != "\n":
            return [white] if white else []
        self.pos += 1
        if self.at_marker():
            return []
        breaks = []
        while self.ch() in " \n":
            if self.ch() == " ":
                self.pos += 1
                continue
            breaks.append("\n")
            self.pos += 1
            if self.at_marker():
                return []
        return breaks or [" "]

    def quoted(self) -> str:
        start, quote = self.pos, self.ch()
        double = quote == '"'
        self.pos += 1
        chunks = self._quoted_non_spaces(double, start)
        while self.ch() != quote:
            chunks += self._quoted_spaces(start)
            chunks += self._quoted_non_spaces(double, start)
        self.pos += 1
        return "".join(chunks)

    def _quoted_non_spaces(self, double: bool, start: int) -> List[str]:
        chunks = []
        while True:
            n = 0
            while self.ch(n) not in "'\"\\ \t\n\0":
                n += 1
            if n:
                chunks.append(self.s[self.pos:self.pos + n])
                self.pos += n
            c = self.ch()
            if not double and c == "'" and self.ch(1) == "'":
                chunks.append("'")
                self.pos += 2
            elif (double and c == "'") or (not double and c in '"\\'):
                chunks.append(c)
                self.pos += 1
            elif double and c == "\\":
                self.pos += 1
                c = self.ch()
                if c in _ESCAPES:
                    chunks.append(_ESCAPES[c])
                    self.pos += 1
                elif c in _ESCAPE_CODES:
                    n = _ESCAPE_CODES[c]
                    digits = self.s[self.pos + 1:self.pos + 1 + n]
                    if len(digits) != n or not set(digits) <= _HEX:
                        self.fail(f"a \\{c} escape without {n} hex digits")
                    try:
                        chunks.append(chr(int(digits, 16)))
                    except ValueError:
                        self.fail(f"an escape of no character (\\{c}{digits})")
                    self.pos += 1 + n
                elif c == "\n":
                    self.pos += 1
                    chunks += self._quoted_breaks(start)
                else:
                    self.fail(f"an unknown escape (\\{c})")
            else:
                return chunks

    def _quoted_spaces(self, start: int) -> List[str]:
        begin = self.pos
        while self.ch() in " \t":
            self.pos += 1
        if self.ch() == "\0":
            self.fail("an unterminated quoted scalar", start)
        if self.ch() != "\n":
            return [self.s[begin:self.pos]]
        self.pos += 1
        return self._quoted_breaks(start) or [" "]

    def _quoted_breaks(self, start: int) -> List[str]:
        breaks = []
        while True:
            if self.at_marker():
                self.fail("a document marker inside a quoted scalar")
            while self.ch() in " \t":
                self.pos += 1
            if self.ch() != "\n":
                return breaks
            breaks.append("\n")
            self.pos += 1

    def resolve(self, text: str, pos: int):
        """A plain scalar typed as SafeLoader types it."""
        for tag, pattern in _IMPLICIT:
            if pattern.match(text):
                if tag == "merge":
                    self.fail("a merge key ('<<')", pos)
                if tag == "value":
                    self.fail("the value key ('=')", pos)
                try:
                    value = _CONSTRUCT[tag](text)
                except ValueError:
                    self.fail(f"a {tag} of no value ({text!r})", pos)
                if tag == "timestamp" and self.tz_aware:
                    _check_tz(value, text)
                return value
        return text


def _check_tz(value, text: str) -> None:
    if not isinstance(value, _dt.datetime):
        raise TimestampNotTZAware(
            f"Provide a full timezone-aware timestamp for {text!r} "
            "(e.g. '2019-01-01T00:00:00Z'), not a bare date")
    if value.tzinfo is None:
        raise TimestampNotTZAware(
            f"Provide timezone to timestamp {text!r} (e.g. '2019-01-01T00:00:00Z')")


def _text(stream) -> str:
    return stream.read() if hasattr(stream, "read") else stream


def load_all(stream) -> List[Any]:
    """Every document of a YAML stream (a string or a file), as
    ``yaml.safe_load_all`` gives them."""
    return _Reader(_text(stream)).documents()


def load(stream) -> Any:
    """The one document of a YAML stream, as ``yaml.safe_load`` gives it
    (None for an empty stream)."""
    reader = _Reader(_text(stream))
    docs = reader.documents()
    if len(docs) > 1:
        reader.fail("a second document where one is expected", len(reader.s))
    return docs[0] if docs else None


def load_config(config) -> dict:
    """A config mapping from a path, a file or YAML text, as the JAX
    workflow generator's ``get_dict_from_yaml`` reads it: every timestamp
    must carry a timezone (:class:`TimestampNotTZAware`), and a ``kind:
    Gordo`` resource gives its ``spec.config``."""
    if hasattr(config, "read"):
        content = config.read()
    elif isinstance(config, (str, os.PathLike)) and os.path.isfile(str(config)):
        with open(config) as fh:
            content = fh.read()
    else:
        content = str(config)
    try:
        docs = _Reader(_text(content), tz_aware=True).documents()
    except YAMLSubsetError as exc:
        raise ValueError(f"Invalid config YAML: {exc}") from exc
    if len(docs) > 1:
        raise ValueError("Invalid config YAML: a second document where one is expected")
    doc = docs[0] if docs else None
    if not isinstance(doc, dict):
        raise ValueError("Config must be a YAML mapping")
    if str(doc.get("kind", "")).lower() == "gordo":
        doc = doc.get("spec", {}).get("config", {})
        if not isinstance(doc, dict):
            raise ValueError("Gordo CRD has no spec.config mapping")
    return doc


# -- the writer
_PLAIN_SAFE = re.compile(r"^[A-Za-z_/][A-Za-z0-9_./ ()+=-]*$")


def _quote(text: str) -> str:
    out = []
    for c in text:
        code = ord(c)
        if c in '"\\':
            out.append("\\" + c)
        elif 0x20 <= code <= 0x7E:
            out.append(c)
        elif c == "\n":
            out.append("\\n")
        elif code <= 0xFF:
            out.append(f"\\x{code:02x}")
        elif code <= 0xFFFF:
            out.append(f"\\u{code:04x}")
        else:
            out.append(f"\\U{code:08x}")
    return '"' + "".join(out) + '"'


def _scalar(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    if isinstance(value, _dt.datetime):
        if value.utcoffset() is not None and value.utcoffset().seconds % 60:
            raise ValueError(f"a timezone offset in seconds cannot be written: {value!r}")
        return value.isoformat()
    if isinstance(value, _dt.date):
        return value.isoformat()
    if isinstance(value, str):
        plain = (_PLAIN_SAFE.fullmatch(value) and not value.endswith(" ")
                 and isinstance(_Reader(value).resolve(value, 0), str))
        return value if plain else _quote(value)
    raise ValueError(f"cannot write a {type(value).__name__} as YAML")


def _block(value) -> List[str]:
    """The lines of ``value`` at indentation 0."""
    if isinstance(value, dict) and value:
        lines = []
        for key, item in value.items():
            if isinstance(key, (dict, list, tuple)):
                raise ValueError("a collection as a mapping key cannot be written")
            if isinstance(item, (dict, list, tuple)) and item:
                lines.append(f"{_scalar(key)}:")
                lines.extend("  " + line for line in _block(item))
            else:
                lines.append(f"{_scalar(key)}: {_block(item)[0]}")
        return lines
    if isinstance(value, (list, tuple)) and value:
        lines = []
        for item in value:
            inner = _block(item)
            lines.append("- " + inner[0])
            lines.extend("  " + line for line in inner[1:])
        return lines
    if isinstance(value, dict):
        return ["{}"]
    if isinstance(value, (list, tuple)):
        return ["[]"]
    return [_scalar(value)]


def dump(value, indent: int = 0) -> str:
    """Block-style YAML of ``value`` (dicts, lists, strings, numbers,
    booleans, None, dates and datetimes) without a trailing line break,
    every line prefixed by ``indent`` spaces; :func:`load` reads it back
    equal."""
    pad = " " * indent
    return "\n".join(pad + line for line in _block(value))
