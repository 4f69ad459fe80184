"""
The Jinja subset that model templates and the workflow's manifests use,
rendered without Jinja: the port's counterpart of the
``jinja2.Environment(undefined=StrictUndefined)`` the JAX CLI renders a
string ``model`` with (``gordo_tpu/cli/cli.py`` ``expand_model``), and of
the workflow generator's environment (its ``yaml`` and ``tojson`` filters).

What renders, with Jinja's meaning:

- ``{{ expr }}`` where ``expr`` is built of names, attribute access
  (``a.b``) and item access (``a['b']``, ``a[0]``), string (adjacent ones
  joined), number, ``true``/``false``/``none`` and list literals, a unary
  minus, the comparisons ``==``, ``!=``, ``<``, ``<=``, ``>``, ``>=`` (also
  chained), ``in`` and ``not in``, ``and``, ``or``, ``not``, parentheses,
  and the filters ``default``, ``join``, ``tojson``, ``trim``, ``lower``,
  ``upper``, ``int``, ``float``, ``length`` and ``yaml`` (util/yaml_subset.py's
  writer, whose text the reader and PyYAML read back equal), with
  positional arguments;
- ``{% if %}`` / ``{% elif %}`` / ``{% else %}`` / ``{% endif %}``;
- ``{% for x in y %}`` / ``{% endfor %}`` with ``loop.index``, ``loop.first``
  and ``loop.last``; each iteration is a scope, as Jinja's are; and
  ``{% for k, v in m.items() %}`` over a mapping, the one call and the one
  unpacking of the subset;
- ``{% set name = expr %}``, ``{# comments #}`` and the ``-`` whitespace
  markers on every tag.

Jinja's whitespace rules hold: newlines are normalised to ``\\n``, one
trailing newline of the template is dropped (``keep_trailing_newline``
off), and ``trim_blocks`` and ``lstrip_blocks`` are off unless
:func:`render` is asked for them, as the workflow generator's environment
asks (workflow/workflow_generator.py). A name that is not
defined renders nothing and raises :class:`UndefinedError` where Jinja's
``StrictUndefined`` raises (printing it, testing its truth, iterating,
comparing, filtering it other than through ``default``). Anything outside
the subset (other statements and filters, calls, tests, math, ``+`` tag
markers, attributes of Python objects) raises :class:`TemplateSubsetError`.
Either error comes before any output: :func:`render` returns the whole text
or raises.
"""

import inspect
import json
import re
from typing import Any, Dict, List, Optional, Tuple

from . import yaml_subset

__all__ = ["TemplateSubsetError", "UndefinedError", "render"]


class TemplateSubsetError(ValueError):
    """A template construct outside the subset, or a malformed template."""


class UndefinedError(Exception):
    """A name the template uses was not given (Jinja's ``UndefinedError``)."""


class _Undefined:
    """A missing name: every use but ``default`` raises, as Jinja's
    ``StrictUndefined`` does."""

    def __init__(self, name: str):
        self._name = name

    def _fail(self, *args, **kwargs):
        raise UndefinedError(f"{self._name!r} is undefined")

    def __repr__(self):
        return "Undefined"

    __str__ = __bool__ = __iter__ = __len__ = __eq__ = __ne__ = __hash__ = _fail
    __contains__ = __lt__ = __le__ = __gt__ = __ge__ = __neg__ = __int__ = __float__ = _fail
    __getitem__ = _fail


class _Loop:
    """``loop`` inside a ``{% for %}``."""

    def __init__(self, index0: int, length: int):
        self.index = index0 + 1
        self.first, self.last = index0 == 0, index0 == length - 1


_LOOP_FIELDS = ("index", "first", "last")

# -- the lexer
_TAG_START = re.compile(r"\{\{|\{%|\{#")
_WHITESPACE = re.compile(r"\s+")
_FLOAT = re.compile(r"(?<!\.)(\d+_)*\d+((\.(\d+_)*\d+)?e[+\-]?(\d+_)*\d+|\.(\d+_)*\d+)", re.I)
_INTEGER = re.compile(r"(0b(_?[0-1])+|0o(_?[0-7])+|0x(_?[\da-f])+|[1-9](_?\d)*|0(_?0)*)", re.I)
_NAME = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")
_STRING = re.compile(r"""('([^'\\]*(?:\\.[^'\\]*)*)'|"([^"\\]*(?:\\.[^"\\]*)*)")""", re.S)
_OPERATORS = ("//", "**", "==", "!=", "<=", ">=", "+", "-", "/", "*", "%", "~", "[", "]", "(",
              ")", "{", "}", "=", ".", ":", "|", ",", ";", "<", ">")
_ENDS = {"{{": "}}", "{%": "%}"}


def _lex_expression(src: str, pos: int, end: str, line: int):
    """The tokens of one ``{{ }}`` or ``{% %}`` from ``pos``: returns
    (tokens, position after the tag, whether the tag ends with ``-``)."""
    tokens = []
    while True:
        ws = _WHITESPACE.match(src, pos)
        if ws:
            pos = ws.end()
        if src.startswith("-" + end, pos):
            return tokens, pos + 3, True
        if src.startswith(end, pos):
            return tokens, pos + 2, False
        if pos >= len(src):
            raise TemplateSubsetError(f"line {line}: a tag without its {end!r}")
        for kind, pattern in (("float", _FLOAT), ("int", _INTEGER), ("name", _NAME),
                              ("string", _STRING)):
            m = pattern.match(src, pos)
            if m:
                text = m.group()
                if kind == "float":
                    value: Any = float(text.replace("_", ""))
                elif kind == "int":
                    value = int(text.replace("_", ""), 0)
                elif kind == "string":
                    try:
                        value = text[1:-1].encode("ascii", "backslashreplace").decode(
                            "unicode-escape")
                    except UnicodeDecodeError as exc:
                        raise TemplateSubsetError(f"line {line}: {exc}") from None
                else:
                    value = text
                tokens.append((kind, value))
                pos = m.end()
                break
        else:
            op = next((o for o in _OPERATORS if src.startswith(o, pos)), None)
            if op is None:
                raise TemplateSubsetError(f"line {line}: unexpected {src[pos]!r} in a tag")
            tokens.append(("op", op))
            pos += len(op)


def _lex(source: str, trim_blocks: bool = False, lstrip_blocks: bool = False) -> List[tuple]:
    """("data", text) and ("var" | "block", tokens, line) items, Jinja's
    whitespace markers applied, and its ``trim_blocks`` (the first newline
    after a block or comment tag dropped) and ``lstrip_blocks`` (the spaces
    and tabs before a block or comment tag alone at the start of its line
    dropped) where asked for."""
    lines = re.split(r"\r\n|\r|\n", source)
    if lines[-1] == "":
        del lines[-1]
    src = "\n".join(lines)
    items: List[tuple] = []
    pos, strip_next = 0, False
    while pos < len(src):
        m = _TAG_START.search(src, pos)
        end = m.start() if m else len(src)
        while strip_next and pos < end and src[pos].isspace():
            pos += 1
        data = src[pos:end]
        if m and src.startswith("-", m.end()):
            data = data.rstrip()
        elif m and lstrip_blocks and m.group() != "{{":
            line_start = data.rfind("\n") + 1
            if (line_start > 0 or pos == 0 or src[pos - 1] == "\n") and re.fullmatch(
                    r"\s+", data[line_start:]):
                data = data[:line_start]
        if m and src.startswith("+", m.end()):
            raise TemplateSubsetError(f"line {src.count(chr(10), 0, m.start()) + 1}: "
                                      "the '+' whitespace marker is not in the subset")
        if data:
            items.append(("data", data))
        if not m:
            break
        line = src.count("\n", 0, m.start()) + 1
        start = m.end() + (1 if src.startswith("-", m.end()) else 0)
        if m.group() == "{#":
            close = src.find("#}", start)
            if close < 0:
                raise TemplateSubsetError(f"line {line}: a comment without its '#}}'")
            strip_next = src[close - 1] == "-" and close - 1 >= start
            pos = close + 2
        else:
            tokens, pos, strip_next = _lex_expression(src, start, _ENDS[m.group()], line)
            items.append(("var" if m.group() == "{{" else "block", tokens, line))
        if trim_blocks and m.group() != "{{" and not strip_next and src.startswith("\n", pos):
            pos += 1
    return items


# -- the parser
class _Tokens:
    def __init__(self, tokens: List[tuple], line: int):
        self.tokens, self.i, self.line = tokens, 0, line

    def peek(self, k: int = 0) -> tuple:
        i = self.i + k
        return self.tokens[i] if i < len(self.tokens) else ("end", None)

    def next(self) -> tuple:
        token = self.peek()
        self.i += 1
        return token

    def at(self, kind: str, value=None) -> bool:
        token = self.peek()
        return token[0] == kind and (value is None or token[1] == value)

    def skip(self, kind: str, value=None) -> bool:
        if self.at(kind, value):
            self.i += 1
            return True
        return False

    def expect(self, kind: str, value=None) -> Any:
        if not self.at(kind, value):
            self.fail(f"expected {value or kind}, got {self.peek()[1]!r}")
        return self.next()[1]

    def fail(self, what: str):
        raise TemplateSubsetError(f"line {self.line}: {what}")

    def done(self) -> None:
        if not self.at("end"):
            self.fail(f"unexpected {self.peek()[1]!r}")


_COMPARE = ("==", "!=", "<", "<=", ">", ">=")
_REFUSED_OPS = {"+": "math", "-": "math", "*": "math", "/": "math", "//": "math", "%": "math",
                "**": "math", "~": "the '~' concatenation", "{": "a dict literal",
                "(": "a call"}


def _expression(t: _Tokens, whole: bool = False) -> tuple:
    """An expression; ``whole`` where it is all of its tag (no tuple)."""
    node = _or(t)
    if t.at("name", "if"):
        t.fail("a conditional expression ('x if y else z') is not in the subset")
    if whole and t.at("op", ","):
        t.fail("a tuple is not in the subset")
    return node


def _or(t: _Tokens) -> tuple:
    node = _and(t)
    while t.skip("name", "or"):
        node = ("or", node, _and(t))
    return node


def _and(t: _Tokens) -> tuple:
    node = _not(t)
    while t.skip("name", "and"):
        node = ("and", node, _not(t))
    return node


def _not(t: _Tokens) -> tuple:
    if t.skip("name", "not"):
        return ("not", _not(t))
    return _compare(t)


def _compare(t: _Tokens) -> tuple:
    first = _unary(t)
    ops = []
    while True:
        if t.peek()[0] == "op" and t.peek()[1] in _COMPARE:
            ops.append((t.next()[1], _unary(t)))
        elif t.skip("name", "in"):
            ops.append(("in", _unary(t)))
        elif t.at("name", "not") and t.peek(1) == ("name", "in"):
            t.i += 2
            ops.append(("not in", _unary(t)))
        else:
            break
    kind, value = t.peek()
    if kind == "op" and value in _REFUSED_OPS:
        t.fail(f"{_REFUSED_OPS[value]} is not in the subset")
    return ("compare", first, ops) if ops else first


def _unary(t: _Tokens, with_filter: bool = True) -> tuple:
    if t.skip("op", "-"):
        node = ("neg", _unary(t, with_filter=False))
    elif t.at("op", "+"):
        t.fail("a unary '+' is not in the subset")
    else:
        node = _primary(t)
    node = _postfix(t, node)
    if not with_filter:
        return node
    while True:
        if t.skip("op", "|"):
            name = t.expect("name")
            if name not in FILTERS:
                t.fail(f"the filter {name!r} is not in the subset")
            args = []
            if t.skip("op", "("):
                while not t.skip("op", ")"):
                    if t.at("name") and t.peek(1) == ("op", "="):
                        t.fail("keyword arguments are not in the subset")
                    args.append(_expression(t))
                    if not t.skip("op", ","):
                        t.expect("op", ")")
                        break
            node = ("filter", node, name, args)
        elif t.at("name", "is"):
            t.fail("tests ('is') are not in the subset")
        elif t.at("op", "("):
            t.fail("calls are not in the subset")
        else:
            return node


def _primary(t: _Tokens) -> tuple:
    kind, value = t.next()
    if kind == "name":
        if value in _KEYWORDS:
            t.fail(f"the keyword {value!r} where a value belongs")
        if value in ("true", "True", "false", "False"):
            return ("const", value in ("true", "True"))
        if value in ("none", "None"):
            return ("const", None)
        return ("name", value)
    if kind == "string":
        while t.at("string"):
            value += t.next()[1]
        return ("const", value)
    if kind in ("int", "float"):
        return ("const", value)
    if kind == "op" and value == "(":
        node = _expression(t)
        t.expect("op", ")")
        return node
    if kind == "op" and value == "[":
        items = []
        while not t.skip("op", "]"):
            items.append(_expression(t))
            if not t.skip("op", ","):
                t.expect("op", "]")
                break
        return ("list", items)
    if kind == "op" and value in _REFUSED_OPS:
        t.fail(f"{_REFUSED_OPS[value]} is not in the subset")
    t.fail(f"unexpected {value!r}")


def _postfix(t: _Tokens, node: tuple) -> tuple:
    while True:
        if t.skip("op", "."):
            kind, name = t.next()
            if kind != "name" and kind != "int":
                t.fail(f"unexpected {name!r} after '.'")
            node = ("getattr", node, name) if kind == "name" else ("getitem", node,
                                                                   ("const", name))
        elif t.skip("op", "["):
            if t.at("op", ":"):
                t.fail("slices are not in the subset")
            key = _expression(t)
            if t.at("op", ":"):
                t.fail("slices are not in the subset")
            t.expect("op", "]")
            node = ("getitem", node, key)
        else:
            return node


_KEYWORDS = ("not", "and", "or", "in", "is", "if", "else", "elif")
_STATEMENTS = ("if", "elif", "else", "endif", "for", "endfor", "set")


def _parse(items: List[tuple]) -> list:
    """The template's nodes: ("text", s), ("output", expr),
    ("if", [(test, body)], else_body), ("for", name, expr, body),
    ("set", name, expr)."""
    body, rest = _parse_body(items, 0, ())
    if rest < len(items):
        raise TemplateSubsetError(f"line {items[rest][2]}: unexpected "
                                  f"{items[rest][1][0][1]!r}")
    return body


def _parse_body(items: List[tuple], i: int, ends: Tuple[str, ...]):
    body: list = []
    while i < len(items):
        item = items[i]
        if item[0] == "data":
            body.append(("text", item[1]))
            i += 1
            continue
        t = _Tokens(item[1], item[2])
        if item[0] == "var":
            body.append(("output", _expression(t, whole=True)))
            t.done()
            i += 1
            continue
        keyword = t.expect("name")
        if keyword not in _STATEMENTS:
            t.fail(f"the statement {keyword!r} is not in the subset")
        if keyword in ends:
            return body, i
        if keyword == "set":
            name = t.expect("name")
            if not t.skip("op", "="):
                t.fail("a block set ('{% set x %}...{% endset %}') is not in the subset")
            body.append(("set", name, _expression(t, whole=True)))
            t.done()
            i += 1
        elif keyword == "if":
            branches, orelse = [], []
            test = _expression(t, whole=True)
            t.done()
            while True:
                block, i = _parse_body(items, i + 1, ("elif", "else", "endif"))
                if i >= len(items):
                    t.fail("an 'if' without its 'endif'")
                branches.append((test, block))
                t = _Tokens(items[i][1], items[i][2])
                keyword = t.next()[1]
                if keyword == "elif":
                    test = _expression(t, whole=True)
                    t.done()
                    continue
                if keyword == "else":
                    t.done()
                    orelse, i = _parse_body(items, i + 1, ("endif",))
                    if i >= len(items):
                        t.fail("an 'if' without its 'endif'")
                    t = _Tokens(items[i][1], items[i][2])
                    t.next()
                t.done()
                break
            body.append(("if", branches, orelse))
            i += 1
        elif keyword == "for":
            name = t.expect("name")
            if t.skip("op", ","):
                name = (name, t.expect("name"))
                t.expect("name", "in")
                target = _postfix(t, _primary(t))
                if target[0] != "getattr" or target[2] != "items" or not t.skip("op", "("):
                    t.fail("unpacking in a 'for' is in the subset only over a mapping's "
                           "items()")
                t.expect("op", ")")
                iterable = ("items", target[1])
            else:
                t.expect("name", "in")
                iterable = _or(t)
            if t.at("name", "if") or t.at("name", "recursive"):
                t.fail(f"a 'for ... {t.peek()[1]}' is not in the subset")
            t.done()
            block, i = _parse_body(items, i + 1, ("endfor", "else"))
            if i >= len(items):
                t.fail("a 'for' without its 'endfor'")
            end = _Tokens(items[i][1], items[i][2])
            if end.next()[1] == "else":
                end.fail("a 'for ... else' is not in the subset")
            end.done()
            body.append(("for", name, iterable, block))
            i += 1
        else:
            t.fail(f"an '{keyword}' without its opening statement")
    return body, i


# -- evaluation
def _getattr(obj, name: str):
    if isinstance(obj, _Undefined):
        obj._fail()
    if isinstance(obj, _Loop):
        if name not in _LOOP_FIELDS:
            raise TemplateSubsetError(f"loop.{name} is not in the subset")
        return getattr(obj, name)
    if name.startswith("_") or hasattr(type(obj), name):
        raise TemplateSubsetError(f"the attribute {name!r} of a {type(obj).__name__} is not "
                                  "in the subset")
    try:
        return obj[name]
    except (TypeError, LookupError, AttributeError):
        return _Undefined(name)


def _getitem(obj, key):
    if isinstance(obj, _Undefined):
        obj._fail()
    if isinstance(obj, _Loop):
        raise TemplateSubsetError("item access on 'loop' is not in the subset")
    try:
        return obj[key]
    except (TypeError, LookupError, AttributeError):
        if isinstance(key, str) and (key.startswith("_") or hasattr(type(obj), key)):
            raise TemplateSubsetError(f"the attribute {key!r} of a {type(obj).__name__} is "
                                      "not in the subset")
        return _Undefined(key if isinstance(key, str) else repr(key))


def _defined(value):
    if isinstance(value, _Undefined):
        value._fail()
    return value


def _default(value, default_value="", boolean=False):
    if isinstance(value, _Undefined) or (boolean and not value):
        return default_value
    return value


def _join(value, d=""):
    return str(d).join(map(str, _defined(value)))


class Markup(str):
    """What Jinja's ``tojson`` returns: a copy of the parts of
    ``markupsafe.Markup`` that a rendering in the subset can reach. It
    prints as its text and shows as ``Markup('...')`` inside a printed list
    or dict; an index, ``trim``, ``lower`` and ``upper`` keep it a Markup.
    (Markup's ``+`` escapes what it adds; the subset refuses ``+`` and
    ``~``.)"""

    __slots__ = ()

    def __repr__(self) -> str:
        return f"Markup({super().__repr__()})"

    def __getitem__(self, key) -> "Markup":
        return Markup(super().__getitem__(key))

    def strip(self, chars=None) -> "Markup":
        return Markup(super().strip(chars))

    def lower(self) -> "Markup":
        return Markup(super().lower())

    def upper(self) -> "Markup":
        return Markup(super().upper())


def _text(value) -> str:
    """Jinja's ``soft_str``: a string as it is (a Markup stays one), else
    its ``str``."""
    value = _defined(value)
    return value if isinstance(value, str) else str(value)


def _tojson(value, indent=None):
    text = json.dumps(value, sort_keys=True, **({} if indent is None else {"indent": indent}))
    return Markup(text.replace("<", "\\u003c").replace(">", "\\u003e").replace("&", "\\u0026")
                  .replace("'", "\\u0027"))


def _check_json(value) -> None:
    if isinstance(value, _Undefined):
        value._fail()
    if isinstance(value, dict):
        for item in value.values():
            _check_json(item)
    elif isinstance(value, (list, tuple)):
        for item in value:
            _check_json(item)


def _int(value, default=0, base=10):
    try:
        if isinstance(value, str):
            return int(value, base)
        return int(value)
    except (TypeError, ValueError):
        try:
            return int(float(value))
        except (TypeError, ValueError):
            return default


def _float(value, default=0.0):
    try:
        return float(value)
    except (TypeError, ValueError):
        return default


def _yaml(value, indent=0):
    _check_json(value)
    return yaml_subset.dump(value, indent=indent)


FILTERS = {
    "default": _default,
    "join": _join,
    "tojson": _tojson,
    "trim": lambda value, chars=None: _text(value).strip(chars),
    "lower": lambda value: _text(value).lower(),
    "upper": lambda value: _text(value).upper(),
    "int": _int,
    "float": _float,
    "length": lambda value: len(value),
    "yaml": _yaml,
}


class _Scope:
    def __init__(self, params: Dict[str, Any]):
        self.frames: List[dict] = [dict(params)]

    def lookup(self, name: str):
        for frame in reversed(self.frames):
            if name in frame:
                return frame[name]
        return _Undefined(name)


def _eval(node: tuple, scope: _Scope):
    kind = node[0]
    if kind == "const":
        return node[1]
    if kind == "name":
        return scope.lookup(node[1])
    if kind == "list":
        return [_eval(item, scope) for item in node[1]]
    if kind == "getattr":
        return _getattr(_eval(node[1], scope), node[2])
    if kind == "getitem":
        return _getitem(_eval(node[1], scope), _eval(node[2], scope))
    if kind == "items":
        mapping = _defined(_eval(node[1], scope))
        if not isinstance(mapping, dict):
            raise TemplateSubsetError(f"items() of a {type(mapping).__name__} is not in the "
                                      "subset")
        return list(mapping.items())
    if kind == "neg":
        return -_eval(node[1], scope)
    if kind == "not":
        return not _eval(node[1], scope)
    if kind == "and":
        return _eval(node[1], scope) and _eval(node[2], scope)
    if kind == "or":
        return _eval(node[1], scope) or _eval(node[2], scope)
    if kind == "compare":
        left = _eval(node[1], scope)
        for op, right_node in node[2]:
            right = _eval(right_node, scope)
            if not _compare_op(op, left, right):
                return False
            left = right
        return True
    if kind == "filter":
        _, value, name, args = node
        value = _eval(value, scope)
        args = [_eval(a, scope) for a in args]
        try:
            inspect.signature(FILTERS[name]).bind(value, *args)
        except TypeError as exc:
            raise TemplateSubsetError(f"the filter {name!r}: {exc}") from None
        return FILTERS[name](value, *args)
    raise AssertionError(kind)


def _compare_op(op: str, left, right) -> bool:
    if op == "==":
        return left == right
    if op == "!=":
        return left != right
    if op == "<":
        return left < right
    if op == "<=":
        return left <= right
    if op == ">":
        return left > right
    if op == ">=":
        return left >= right
    if op == "in":
        return left in right
    return left not in right


def _run(body: list, scope: _Scope, out: List[str]) -> None:
    for node in body:
        kind = node[0]
        if kind == "text":
            out.append(node[1])
        elif kind == "output":
            out.append(str(_eval(node[1], scope)))
        elif kind == "set":
            scope.frames[-1][node[1]] = _eval(node[2], scope)
        elif kind == "if":
            for test, block in node[1]:
                if _eval(test, scope):
                    _run(block, scope, out)
                    break
            else:
                _run(node[2], scope, out)
        else:
            _, name, iterable, block = node
            items = list(_eval(iterable, scope))
            for index, item in enumerate(items):
                names = dict(zip(name, item)) if isinstance(name, tuple) else {name: item}
                scope.frames.append({**names, "loop": _Loop(index, len(items))})
                try:
                    _run(block, scope, out)
                finally:
                    scope.frames.pop()


def render(template: str, params: Optional[Dict[str, Any]] = None, trim_blocks: bool = False,
           lstrip_blocks: bool = False) -> str:
    """``template`` rendered with ``params`` as Jinja renders it with
    ``StrictUndefined`` (and with ``trim_blocks`` and ``lstrip_blocks`` where
    they are true); raises :class:`UndefinedError` for a missing name and
    :class:`TemplateSubsetError` for a construct outside the subset."""
    body = _parse(_lex(template, trim_blocks, lstrip_blocks))
    out: List[str] = []
    _run(body, _Scope(params or {}), out)
    return "".join(out)
