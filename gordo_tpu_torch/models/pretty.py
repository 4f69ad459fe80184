"""
sklearn's estimator repr, for the port's estimators: the strings that the
JAX package's detector writes into its metadata (``str(scaler)`` and
``str(base_estimator)``, gordo_tpu/models/anomaly/diff.py) come from
sklearn's ``BaseEstimator.__repr__``, and the port writes the same.

The rules are sklearn's ``_EstimatorPrettyPrinter`` (sklearn/utils/_pprint.py,
itself a ``pprint.PrettyPrinter``): only the parameters that differ from
the ``__init__`` defaults, sorted by name; ``Name(a=1, b=2)`` on one line
when it fits in 80 columns, else wrapped compactly with the continuation
lines indented to the opening parenthesis; sequences of more than 30
items and reprs of more than 700 non-blank characters elided with
``...``. An estimator here is an instance of :class:`EstimatorRepr`; its
parameters are ``repr_params()`` and their defaults ``repr_defaults()``.
"""

import inspect
import pprint
import re

N_CHAR_MAX = 700  # non-blank characters before the middle is elided
N_MAX_ELEMENTS = 30  # items of a sequence or parameters shown


class EstimatorRepr:
    """Gives a class sklearn's estimator repr over ``repr_params()``."""

    def repr_params(self) -> dict:
        return self.get_params(deep=False)

    def repr_defaults(self) -> dict:
        """The parameters' defaults: those of ``__init__``'s signature (a
        parameter without one is always shown)."""
        parameters = inspect.signature(type(self).__init__).parameters
        return {name: p.default for name, p in parameters.items()
                if p.default is not inspect.Parameter.empty}

    def __repr__(self) -> str:
        text = _Printer().pformat(self)
        if len("".join(text.split())) <= N_CHAR_MAX:
            return text
        regex = r"^(\s*\S){%d}" % (N_CHAR_MAX // 2)
        left = re.match(regex, text).end()
        right = re.match(regex, text[::-1]).end()
        if "\n" in text[left:-right]:
            # start the right part on a line of its own
            right = re.match(regex + r"[^\n]*\n", text[::-1]).end()
        if left + 3 < len(text) - right:
            text = text[:left] + "..." + text[-right:]
        return text


def changed_params(estimator: EstimatorRepr) -> dict:
    """The parameters that differ from their defaults (all that have none)."""
    defaults = estimator.repr_defaults()

    def changed(name, value):
        default = defaults.get(name, inspect.Parameter.empty)
        if default is inspect.Parameter.empty:
            return True
        if isinstance(value, EstimatorRepr) and type(value) is not type(default):
            return True
        return repr(value) != repr(default) and not (_is_nan(default) and _is_nan(value))

    return {k: v for k, v in estimator.repr_params().items() if changed(k, v)}


def _is_nan(x) -> bool:
    return isinstance(x, float) and x != x


class _DictItem(tuple):
    """A (key, value) pair of a dict, printed ``key: value``."""

    def __repr__(self):
        return super().__repr__()


class _KeyValue(_DictItem):
    """A (name, value) parameter pair, printed ``name=value``."""


def _safe_repr(obj, context, maxlevels, level):
    """pprint's ``_safe_repr`` with estimators, returning (repr, readable,
    recursive)."""
    typ = type(obj)
    if typ in pprint._builtin_scalars:
        return repr(obj), True, False
    r = getattr(typ, "__repr__", None)
    if issubclass(typ, dict) and r is dict.__repr__:
        items = sorted(obj.items(), key=pprint._safe_tuple)
        return _container(obj, "{%s}", [(k, v, ": ") for k, v in items], context,
                          maxlevels, level, empty="{}")
    if (issubclass(typ, list) and r is list.__repr__) or (
            issubclass(typ, tuple) and r is tuple.__repr__):
        if issubclass(typ, list):
            fmt, empty = "[%s]", "[]"
        else:
            fmt, empty = ("(%s,)" if len(obj) == 1 else "(%s)"), "()"
        return _container(obj, fmt, [(None, o, "") for o in obj], context, maxlevels,
                          level, empty=empty)
    if issubclass(typ, EstimatorRepr):
        items = sorted(changed_params(obj).items(), key=pprint._safe_tuple)
        return _container(obj, typ.__name__ + "(%s)", [(k, v, "=") for k, v in items],
                          context, maxlevels, level, empty=None)
    rep = repr(obj)
    return rep, bool(rep and not rep.startswith("<")), False


def _container(obj, fmt, entries, context, maxlevels, level, empty):
    """A dict, sequence or estimator of ``entries`` (key or None, value,
    separator) on one line."""
    if not entries and empty is not None:
        return empty, True, False
    objid = id(obj)
    if maxlevels and level >= maxlevels:
        return fmt % "...", False, objid in context
    if objid in context:
        return pprint._recursion(obj), False, True
    context[objid] = 1
    readable, recursive, parts = True, False, []
    for key, value, sep in entries:
        vrepr, vreadable, vrecur = _safe_repr(value, context, maxlevels, level + 1)
        if key is not None:
            krepr, kreadable, krecur = _safe_repr(key, context, maxlevels, level + 1)
            if sep == "=":
                krepr = krepr.strip("'")
            vrepr = krepr + sep + vrepr
            readable, recursive = readable and kreadable, recursive or krecur
        readable, recursive = readable and vreadable, recursive or vrecur
        parts.append(vrepr)
    del context[objid]
    return fmt % ", ".join(parts), readable, recursive


class _Printer(pprint.PrettyPrinter):
    """sklearn's ``_EstimatorPrettyPrinter`` with ``compact=True``,
    ``indent_at_name=True`` and 30 items at most."""

    def __init__(self):
        super().__init__(indent=1, width=80, compact=True)
        self._indent_per_level = 1

    def format(self, obj, context, maxlevels, level):
        return _safe_repr(obj, context, maxlevels, level)

    def _pprint_estimator(self, obj, stream, indent, allowance, context, level):
        stream.write(type(obj).__name__ + "(")
        indent += len(type(obj).__name__)
        items = sorted(changed_params(obj).items())
        self._format_entries(items, stream, indent, allowance + 1, context, level, _KeyValue)
        stream.write(")")

    def _format_items(self, items, stream, indent, allowance, context, level):
        self._format_entries(items, stream, indent, allowance, context, level, None)

    def _format_dict_items(self, items, stream, indent, allowance, context, level):
        # dicts take the same compact layout as parameters (pprint's own
        # gives each key a line of its own)
        self._format_entries(items, stream, indent, allowance, context, level, _DictItem)

    def _format_entries(self, entries, stream, indent, allowance, context, level, pair):
        """Items, or (key, value) pairs printed as ``pair`` says, separated
        by ", " while they fit, wrapped at ``width`` with ",\\n" and the
        indentation."""
        write = stream.write
        indent += self._indent_per_level
        delimnl = ",\n" + " " * indent
        delim = ""
        width = max_width = self._width - indent + 1
        entries = list(entries)
        for n, entry in enumerate(entries):
            if n == N_MAX_ELEMENTS:
                write(", ...")
                break
            last = n == len(entries) - 1
            if last:
                max_width -= allowance
                width -= allowance
            if pair is None:
                rep = self._repr(entry, context, level)
            else:
                rep = self._key(pair, entry[0], context, level)
                rep += self._repr(entry[1], context, level)
            w = len(rep) + 2
            if width < w:
                width = max_width
                if delim:
                    delim = delimnl
            if width >= w:
                width -= w
                write(delim)
                delim = ", "
                write(rep)
                continue
            write(delim)
            delim = delimnl
            entry = entry if pair is None else pair(entry)
            self._format(entry, stream, indent, allowance if last else 1, context, level)

    def _key(self, pair, key, context, level) -> str:
        """``name=`` of a parameter, ``'key': `` of a dict item."""
        rep = self._repr(key, context, level)
        return rep.strip("'") + "=" if pair is _KeyValue else rep + ": "

    def _pprint_pair(self, obj, stream, indent, allowance, context, level):
        rep = self._key(type(obj), obj[0], context, level)
        stream.write(rep)
        self._format(obj[1], stream, indent + len(rep), allowance, context, level)

    _dispatch = pprint.PrettyPrinter._dispatch.copy()
    _dispatch[EstimatorRepr.__repr__] = _pprint_estimator
    _dispatch[_DictItem.__repr__] = _pprint_pair
