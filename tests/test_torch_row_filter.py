"""
``row_filter`` (``gordo_tpu_torch/dataset/row_filter.py``) against pandas'
``DataFrame.query``, which the JAX dataset runs: a hypothesis test of
generated expressions (backticked and bare names, literals and lists,
arithmetic, the MATHOPS functions, chained comparisons, ``in`` / ``not in``,
``and`` / ``or`` / ``not`` / ``&`` / ``|`` / ``~`` at pandas' precedence) over
generated frames keeps exactly the rows ``df.query`` keeps, or raises where
it raises; every refused construct raises ValueError naming it when the
filter is made, and a dataset refuses it before reading any data. Exact:
both evaluate the same numpy operations in float64.
"""

import numpy as np
import pandas as pd
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from gordo_tpu.dataset.datasets import TimeSeriesDataset as JaxTimeSeriesDataset
from gordo_tpu_torch.dataset import GordoBaseDataProvider, TimeSeriesDataset
from gordo_tpu_torch.dataset.row_filter import MATHOPS, RowFilter

COLUMNS = ["a", "b_1", "TRA-35TT8566.PV", "tag 4"]
BARE = {"a", "b_1"}  # names that parse without backticks

values = st.floats(min_value=-50, max_value=50, allow_nan=False, allow_infinity=False,
                   width=32).map(float)
literals = st.one_of(st.integers(-5, 5).map(str), st.sampled_from(["0.5", "2.25", "-1.5", "10"]))


def _name(column: str, quoted: bool) -> str:
    return column if column in BARE and not quoted else f"`{column}`"


columns = st.builds(_name, st.sampled_from(COLUMNS), st.booleans())


@st.composite
def arithmetic(draw, depth: int = 2):
    """A float-valued expression with at least one column."""
    kind = draw(st.sampled_from(["column", "binop", "call", "neg"] if depth else ["column"]))
    if kind == "column":
        return draw(columns)
    if kind == "neg":
        return f"-{draw(arithmetic(depth - 1))}"
    if kind == "call":
        name = draw(st.sampled_from(sorted(MATHOPS)))
        if name == "arctan2":
            return f"arctan2({draw(arithmetic(depth - 1))}, {draw(arithmetic(depth - 1))})"
        return f"{name}({draw(arithmetic(depth - 1))})"
    op = draw(st.sampled_from(["+", "-", "*", "/", "//", "%", "**"]))
    right = draw(st.one_of(arithmetic(depth - 1), literals))
    return f"({draw(arithmetic(depth - 1))} {op} {right})"


@st.composite
def comparison(draw):
    kind = draw(st.sampled_from(["cmp", "chain", "in"]))
    if kind == "in":
        members = ", ".join(draw(st.lists(literals, min_size=1, max_size=3)))
        return f"{draw(columns)} {draw(st.sampled_from(['in', 'not in']))} [{members}]"
    ops = ["<", "<=", ">", ">=", "==", "!="]
    left = draw(arithmetic())
    text = f"{left} {draw(st.sampled_from(ops))} {draw(st.one_of(arithmetic(1), literals))}"
    if kind == "chain":
        text += f" {draw(st.sampled_from(ops[:4]))} {draw(literals)}"
    return text


@st.composite
def boolean(draw, depth: int = 2):
    kind = draw(st.sampled_from(["cmp", "binary", "not"] if depth else ["cmp"]))
    if kind == "cmp":
        return draw(comparison())
    if kind == "not":
        inner = draw(boolean(depth - 1))
        return draw(st.sampled_from([f"not ({inner})", f"~({inner})"]))
    op = draw(st.sampled_from(["and", "or", "&", "|"]))
    # no parentheses: & and | take the precedence of and and or
    return f"{draw(boolean(depth - 1))} {op} {draw(boolean(depth - 1))}"


frames = st.integers(4, 25).flatmap(lambda n: st.lists(
    st.lists(values, min_size=len(COLUMNS), max_size=len(COLUMNS)), min_size=n, max_size=n))


@settings(max_examples=300, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(expression=boolean(), rows=frames)
def test_row_filter_keeps_the_rows_df_query_keeps(expression, rows):
    table = np.array(rows, np.float64)
    df = pd.DataFrame(table, columns=COLUMNS)
    try:
        with np.errstate(all="ignore"):
            expected = df.reset_index(drop=True).query(expression).index.to_numpy()
    except Exception as exc:  # noqa: BLE001 -- pandas refuses: so must the port
        with pytest.raises(Exception):
            RowFilter(expression, COLUMNS).mask(table)
        return
    mask = RowFilter(expression, COLUMNS).mask(table)
    np.testing.assert_array_equal(np.flatnonzero(mask), expected, err_msg=expression)


@pytest.mark.parametrize("expression, construct", [
    ("a.real > 0", "attribute access"),
    ("`TRA-35TT8566.PV`[0] > 1", "subscripts"),
    ("max(a) > 0", "calls of 'max'"),
    ("a.max() > 0", "calls of 'a.max'"),
    ("sin(a, b_1) > 0", "with these arguments"),
    ("a > @x", "local variables"),
    ("c > 0", "'c' is not a column"),
    ("`nope` > 0", "'nope' is not a column"),
    ("a > 'x'", "str literals"),
    ("a > True", "bool literals"),
    ("a in b_1", "in / not in"),
    ("a in ['x']", "in / not in"),
    ("[1, 2] == a", "lists outside"),
    ("(lambda: 1)() > a", "calls of"),
    ("a if b_1 else a", "conditional expressions"),
    ("{1: a} == a", "dicts"),
    ("a > 0 ^ b_1 > 0", "BitXor"),
    ("a is b_1", "IsNot|Is"),
    ("a >", "not a valid expression"),
])
def test_refused_constructs_raise_before_any_data_is_read(expression, construct):
    with pytest.raises(ValueError, match=construct):
        RowFilter(expression, COLUMNS)

    class Untouched(GordoBaseDataProvider):
        def load_series(self, *args, **kwargs):
            raise AssertionError("data was read")

    with pytest.raises(ValueError, match=construct):
        TimeSeriesDataset(train_start_date="2020-01-01T00:00:00+00:00",
                          train_end_date="2020-01-02T00:00:00+00:00", tags=COLUMNS,
                          data_provider=Untouched(), row_filter=expression)


def test_dataset_row_filter_matches_the_jax_dataset():
    config = dict(train_start_date="2020-01-01T00:00:00+00:00",
                  train_end_date="2020-01-04T00:00:00+00:00", tags=["tag-0", "tag-1", "tag-2"],
                  row_filter="(`tag-0` - `tag-1`) % 2 > 1 & `tag-1` < 100 | abs(`tag-2`) > 1e9")
    X, y = TimeSeriesDataset(**config).get_data()
    jX, jy = JaxTimeSeriesDataset(**config).get_data()
    assert 0 < len(X.index) < 432
    np.testing.assert_array_equal(X.index.view(np.int64), jX.index.as_unit("ns").asi8)
    np.testing.assert_array_equal(X.values, jX.to_numpy(np.float64))
    np.testing.assert_array_equal(y.values, jy.to_numpy(np.float64))
