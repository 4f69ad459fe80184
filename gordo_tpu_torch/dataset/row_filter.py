"""
``row_filter``: the pandas ``DataFrame.query`` expression a dataset's
config may give, evaluated over the joined columns without pandas.

The expression is read as pandas reads it: a name in backticks is a column
(tag names such as ``TRA-35TT8566.PV`` need them), ``&`` and ``|`` have the
precedence of ``and`` and ``or``, and ``not`` and ``~`` negate. It may hold:

- column names, bare or in backticks;
- int and float literals, and lists of them on the right of ``in`` and
  ``not in``;
- ``+ - * / // % **`` and unary minus, with numpy's float semantics;
- comparisons, chained ones too, and ``in`` / ``not in``;
- ``and``, ``or``, ``not``, ``&``, ``|``, ``~``;
- the functions of pandas' ``MATHOPS`` (``sin`` ... ``abs``, ``floor``,
  ``ceil``, ``arctan2``).

Anything else (attribute access, subscripts, other calls, ``@`` locals,
strings and other literals, names that are not columns) raises ValueError
naming the construct when the filter is made, before any data is read.
"""

import ast
import io
import re
import tokenize
from typing import Dict, List, Sequence

import numpy as np

MATHOPS = {
    "sin": np.sin, "cos": np.cos, "tan": np.tan, "exp": np.exp, "log": np.log,
    "expm1": np.expm1, "log1p": np.log1p, "sqrt": np.sqrt, "sinh": np.sinh, "cosh": np.cosh,
    "tanh": np.tanh, "arcsin": np.arcsin, "arccos": np.arccos, "arctan": np.arctan,
    "arccosh": np.arccosh, "arcsinh": np.arcsinh, "arctanh": np.arctanh, "abs": np.abs,
    "log10": np.log10, "floor": np.floor, "ceil": np.ceil, "arctan2": np.arctan2,
}
_BINOPS = {ast.Add: np.add, ast.Sub: np.subtract, ast.Mult: np.multiply,
           ast.Div: np.true_divide, ast.FloorDiv: np.floor_divide, ast.Mod: np.mod,
           ast.Pow: np.power}
_COMPARE = {ast.Eq: np.equal, ast.NotEq: np.not_equal, ast.Lt: np.less,
            ast.LtE: np.less_equal, ast.Gt: np.greater, ast.GtE: np.greater_equal}
_BACKTICKED = re.compile(r"`([^`]*)`")

# what an unsupported node is called in the error
_CONSTRUCTS = {ast.Attribute: "attribute access", ast.Subscript: "subscripts",
               ast.Lambda: "lambdas", ast.IfExp: "conditional expressions",
               ast.Dict: "dicts", ast.Set: "sets", ast.ListComp: "comprehensions",
               ast.SetComp: "comprehensions", ast.DictComp: "comprehensions",
               ast.GeneratorExp: "comprehensions", ast.Starred: "starred expressions",
               ast.JoinedStr: "f-strings", ast.NamedExpr: "assignment expressions",
               ast.Await: "await", ast.Yield: "yield", ast.Slice: "slices"}


class RowFilter:
    """A validated ``row_filter`` over ``columns``; :meth:`mask` gives the
    rows it keeps."""

    def __init__(self, expression: str, columns: Sequence[str]):
        self.expression = expression
        self.columns = list(columns)
        self._names: Dict[str, str] = {}  # identifier in the parsed source -> column
        source = _BACKTICKED.sub(self._backticked, expression)
        if "@" in source:
            raise ValueError(f"row_filter {expression!r}: local variables (@name) are not "
                             f"allowed")
        try:
            self._tree = ast.parse(_booleans_as_pandas_reads_them(source).strip(),
                                   mode="eval").body
        except (SyntaxError, tokenize.TokenError) as exc:
            raise ValueError(f"row_filter {expression!r} is not a valid expression: "
                             f"{exc}") from None
        self._check(self._tree)

    def _backticked(self, match: "re.Match") -> str:
        name = match.group(1)
        if name not in self.columns:
            raise ValueError(f"row_filter {self.expression!r}: {name!r} is not a column "
                             f"(columns: {self.columns})")
        key = f"__gordo_column_{len(self._names)}__"
        self._names[key] = name
        return f" {key} "

    def _refuse(self, what: str):
        raise ValueError(f"row_filter {self.expression!r}: {what} are not allowed")

    def _column(self, node: ast.Name) -> str:
        name = self._names.get(node.id, node.id)
        if name not in self.columns:
            raise ValueError(f"row_filter {self.expression!r}: {name!r} is not a column "
                             f"(columns: {self.columns})")
        return name

    def _check(self, node: ast.AST) -> None:
        if isinstance(node, ast.Name):
            self._column(node)
        elif isinstance(node, ast.Constant):
            if isinstance(node.value, bool) or not isinstance(node.value, (int, float)):
                self._refuse(f"{type(node.value).__name__} literals")
        elif isinstance(node, ast.BoolOp):
            for value in node.values:
                self._check(value)
        elif isinstance(node, ast.UnaryOp):
            self._check(node.operand)
        elif isinstance(node, ast.BinOp):
            if type(node.op) not in _BINOPS:
                self._refuse(f"the operator {type(node.op).__name__}")
            self._check(node.left)
            self._check(node.right)
        elif isinstance(node, ast.Compare):
            self._check(node.left)
            for op, right in zip(node.ops, node.comparators):
                if isinstance(op, (ast.In, ast.NotIn)):
                    if not isinstance(right, (ast.List, ast.Tuple)):
                        self._refuse("in / not in against anything but a list of numbers")
                    for element in right.elts:
                        self._number(element)
                elif type(op) in _COMPARE:
                    self._check(right)
                else:
                    self._refuse(f"the comparison {type(op).__name__}")
        elif isinstance(node, ast.Call):
            name = node.func.id if isinstance(node.func, ast.Name) else None
            if name not in MATHOPS:
                self._refuse(f"calls of {ast.unparse(node.func)!r} (only {sorted(MATHOPS)})")
            if node.keywords or len(node.args) != (2 if name == "arctan2" else 1):
                self._refuse(f"calls of {name} with these arguments")
            for arg in node.args:
                self._check(arg)
        elif isinstance(node, (ast.List, ast.Tuple)):
            self._refuse("lists outside in / not in")
        else:
            self._refuse(_CONSTRUCTS.get(type(node), f"{type(node).__name__} expressions"))

    def _number(self, node: ast.AST) -> float:
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
            value = self._number(node.operand)
            return -value if isinstance(node.op, ast.USub) else value
        if (isinstance(node, ast.Constant) and isinstance(node.value, (int, float))
                and not isinstance(node.value, bool)):
            return node.value
        self._refuse("in / not in against anything but a list of numbers")

    def mask(self, table: np.ndarray) -> np.ndarray:
        """The rows of ``table`` (rows x :attr:`columns`) the filter keeps."""
        data = {name: table[:, j] for j, name in enumerate(self.columns)}
        with np.errstate(all="ignore"):
            keep = self._eval(self._tree, data)
        keep = np.asarray(keep)
        if keep.dtype != np.bool_ or keep.shape != (len(table),):
            raise ValueError(f"row_filter {self.expression!r} gives no boolean a row")
        return keep

    def _eval(self, node: ast.AST, data: Dict[str, np.ndarray]):
        if isinstance(node, ast.Name):
            return data[self._column(node)]
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.BoolOp):
            combine = np.logical_and if isinstance(node.op, ast.And) else np.logical_or
            result = self._boolean(self._eval(node.values[0], data), "and / or")
            for value in node.values[1:]:
                result = combine(result, self._boolean(self._eval(value, data), "and / or"))
            return result
        if isinstance(node, ast.UnaryOp):
            operand = self._eval(node.operand, data)
            if isinstance(node.op, (ast.Not, ast.Invert)):
                return np.logical_not(self._boolean(operand, "not / ~"))
            return -operand if isinstance(node.op, ast.USub) else +operand
        if isinstance(node, ast.BinOp):
            left, right = self._eval(node.left, data), self._eval(node.right, data)
            return _BINOPS[type(node.op)](np.asarray(left, np.float64), right)
        if isinstance(node, ast.Compare):
            result, left = None, self._eval(node.left, data)
            for op, right_node in zip(node.ops, node.comparators):
                if isinstance(op, (ast.In, ast.NotIn)):
                    members = [self._number(e) for e in right_node.elts]
                    step = np.isin(left, members)
                    step = np.logical_not(step) if isinstance(op, ast.NotIn) else step
                    right = None
                else:
                    right = self._eval(right_node, data)
                    step = _COMPARE[type(op)](left, right)
                result = step if result is None else np.logical_and(result, step)
                left = right
            return result
        if isinstance(node, ast.Call):
            return MATHOPS[node.func.id](*(np.asarray(self._eval(arg, data), np.float64)
                                           for arg in node.args))
        raise AssertionError(f"unchecked node {type(node).__name__}")

    def _boolean(self, value, where: str):
        if np.asarray(value).dtype != np.bool_:
            raise ValueError(f"row_filter {self.expression!r}: {where} needs boolean operands")
        return value


def _booleans_as_pandas_reads_them(source: str) -> str:
    """``&`` and ``|`` read as ``and`` and ``or``, as pandas' expression
    parser rewrites them, so that ``a > 1 & b < 2`` means ``(a > 1) and
    (b < 2)``."""
    tokens: List[tuple] = []
    for tok in tokenize.generate_tokens(io.StringIO(source).readline):
        if tok.type == tokenize.OP and tok.string in ("&", "|"):
            tokens.append((tokenize.NAME, "and" if tok.string == "&" else "or"))
        else:
            tokens.append((tok.type, tok.string))
    return tokenize.untokenize(tokens)
