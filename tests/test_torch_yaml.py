"""
The port's YAML reader and writer (``gordo_tpu_torch/util/yaml_subset.py``)
against PyYAML's ``safe_load`` / ``safe_load_all``, which the JAX package
reads every config with, and the config-reading fault it repairs (C2: the
port read configs with ``json.load``).

Every comparison is exact: the same Python objects, NaN equal to NaN, the
same types (a ``date`` is not a ``datetime``, ``True`` is not ``1``).
"""

import dataclasses
import datetime as dt
import glob
import json
import math
import os
import re

import pytest
import yaml
from click.testing import CliRunner
from hypothesis import HealthCheck, given, settings, strategies as st

from gordo_tpu.cli.cli import gordo
from gordo_tpu.cli.workflow_generator import generate_workflow_docs
from gordo_tpu.workflow.normalized_config import NormalizedConfig as JaxNormalizedConfig
from gordo_tpu.workflow.workflow_generator import TimestampNotTZAware as JaxNotTZAware
from gordo_tpu.workflow.workflow_generator import get_dict_from_yaml
from gordo_tpu_torch import cli
from gordo_tpu_torch.chaos import scenario as scn
from gordo_tpu_torch.serializer import load_metadata
from gordo_tpu_torch.util import yaml_subset
from gordo_tpu_torch.workflow.normalized_config import NormalizedConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_YAML = sorted([os.path.join(REPO, "examples", "config.yaml")]
                   + glob.glob(os.path.join(REPO, "resources", "chaos", "*.yaml")))
CHAOS_DRILLS = sorted(os.path.splitext(os.path.basename(p))[0]
                      for p in glob.glob(os.path.join(REPO, "resources", "chaos", "*.yaml")))


def same(a, b) -> bool:
    """Equal objects of equal types, NaN equal to NaN, keys in order."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def _both(text: str):
    """(PyYAML's documents, the port's), each ("ok", docs) or ("error", type)."""
    out = []
    for load in (lambda t: list(yaml.safe_load_all(t)), yaml_subset.load_all):
        try:
            out.append(("ok", load(text)))
        except Exception as exc:  # noqa: BLE001 -- the outcome is compared
            out.append(("error", type(exc).__name__))
    return out


@pytest.mark.parametrize("path", REPO_YAML, ids=os.path.basename)
def test_every_yaml_file_of_the_repo_reads_as_pyyaml_reads_it(path):
    with open(path) as fh:
        text = fh.read()
    assert same(yaml_subset.load_all(text), list(yaml.safe_load_all(text)))
    assert same(yaml_subset.load(text), yaml.safe_load(text))


@pytest.mark.parametrize("clients", [False, True])
def test_the_documents_the_jax_workflow_generator_renders(clients):
    dates = ({"client_start_date": "2019-01-01T00:00:00Z",
              "client_end_date": "2019-01-02T00:00:00Z", "split_workflows": 1}
             if clients else {"enable_clients": False})
    text = generate_workflow_docs(os.path.join(REPO, "examples", "config.yaml"),
                                  project_name="example", **dates)
    theirs = list(yaml.safe_load_all(text))
    assert len(theirs) >= 1 and same(yaml_subset.load_all(text), theirs)


# YAML 1.1 as SafeLoader reads it, where JSON habits mislead
QUIRKS = [
    "on: off\nyes: no\n~: null\nTrue: FALSE",
    "octal: 0123\nnot_octal: 09\nhex: 0x1f\nbinary: 0b101\nunderscores: 1_000\n"
    "base60: 1:30\nnegative: -1:30\nfloat60: 1:30.5",
    "exp_str: 1e3\nexp_float: 1.0e+3\ndot_exp: 1.e3\nhalf: .5\nneg_half: -.5\n"
    "inf: .inf\nneg_inf: -.Inf\nnan: .NaN",
    "date: 2019-01-01\nstamp: 2019-01-01T00:00:00+00:00\nspaced: 2019-01-01 10:00:00.5\n"
    "zulu: 2019-1-1T1:00:00Z\noffset: 2019-01-01T00:00:00-05:30\n"
    "naive: 2019-01-01T00:00:00\nquoted: '2019-01-01T00:00:00+00:00'",
    "keep: |+\n  x\n\nstrip: |-\n  x\n\nclip: |\n  x\n\nlast: 1",
    "folded: >\n  a\n  b\n\n  c\n   more\n  d\nfolded_strip: >-\n  x\n\n",
    "indent_indicator: |2-\n   x\n  y\nplain: a\n  b\n\n  c",
    "empty:\nnull_tilde: ~\nquoted_empty: ''\ndouble: \"a\\tb\\u00e9\\x41\\\n   c\"",
    "single: 'it''s'\nfolded_single: 'a\n  b\n\n  c'\ncolon: x:y\ndash: -x\nhash: a#b",
    "indentless:\n- a\n- b\nnext: 1\nflow: {a: [1, {b: c}], d: }\ntrailing: [1, 2, ]",
    "- - a\n  - b\n- c: 1\n  d: 2\n-\n- e",
    '{"json": [1, 2.5, "x", null, true, false], "nested": {"a": {}}, "e": 1e-05}',
    "a: 1\na: 2\n",
    "---\na\n...\n---\nb\n",
    "",
    "# only a comment\n",
    "\ufeffbom: 1",
]


@pytest.mark.parametrize("text", QUIRKS)
def test_yaml_1_1_as_safe_load_reads_it(text):
    (kind, theirs), (kind_ours, ours) = _both(text)
    assert kind == kind_ours == "ok", (theirs, ours)
    assert same(ours, theirs)


# each refused construct: the text, what the error names, its line and column
REFUSED = [
    ("a: &anchor 1", "an anchor", 1, 4),
    ("a: 1\nb: *alias", "an alias", 2, 4),
    ("a: !!int 1", "a tag", 1, 4),
    ("base:\n  <<: {a: 1}", "a merge key", 2, 3),
    ("? a\n: b", "an explicit key", 1, 1),
    ("%YAML 1.1\n---\na: 1", "a directive", 1, 1),
    ("[a, b]: c", "a flow collection as a mapping key", 1, 1),
    ("a: [b, c: d]", "a single-pair mapping in a flow sequence", 1, 8),
    ("a: =", "the value key", 1, 4),
    ("a:\tb", "a tab", 1, 3),
    ("a: \"x\x07\"", "a non-printable character", 1, 6),
]


@pytest.mark.parametrize("text, construct, line, column", REFUSED)
def test_refused_constructs_raise_with_their_line(text, construct, line, column):
    with pytest.raises(yaml_subset.YAMLSubsetError) as refused:
        yaml_subset.load(text)
    assert refused.value.construct.startswith(construct)
    assert (refused.value.line, refused.value.column) == (line, column)
    assert f"line {line}, column {column}" in str(refused.value)


@pytest.mark.parametrize("text", [
    "a: b: c", "a: 1\n b: 2", "a: 'x' y", "a: [1, 2", "a: 'open",
    "a: 'x\n---\ny'", "a:\n  - b\n  c: d", "--- a: b", "a\n---\nb: [", "x\ny: 1",
])
def test_malformed_yaml_is_refused_where_pyyaml_refuses_it(text):
    (kind, _), (kind_ours, ours) = _both(text)
    assert kind == "error" and kind_ours == "error" and ours == "YAMLSubsetError"


# -- generated objects, dumped by PyYAML in several styles and read by both
def _dumper(style):
    class Dumper(yaml.SafeDumper):
        pass

    def represent(dumper, text):
        chosen = style if style in "\"'" or "\n" in text else None
        return dumper.represent_scalar("tag:yaml.org,2002:str", text, style=chosen)

    Dumper.add_representer(str, represent)
    return Dumper


DUMPS = {
    "block": lambda o: yaml.safe_dump(o, default_flow_style=False, allow_unicode=True),
    "flow": lambda o: yaml.safe_dump(o, default_flow_style=True, allow_unicode=True),
    "double": lambda o: yaml.dump(o, Dumper=_dumper('"'), default_flow_style=False),
    "single": lambda o: yaml.dump(o, Dumper=_dumper("'"), allow_unicode=True),
    "literal": lambda o: yaml.dump(o, Dumper=_dumper("|"), default_flow_style=False),
    "folded": lambda o: yaml.dump(o, Dumper=_dumper(">"), default_flow_style=False),
    "narrow": lambda o: yaml.safe_dump(o, default_flow_style=False, width=20, indent=4),
}
_TEXT = st.text(alphabet=st.sampled_from(
    list("abcXYZ019 :-#'\"\n\t{}[],.!&*?|>%@`~_/\\") + ["é", "€", "\U0001f600"]), max_size=20)
_KEYS = st.text(alphabet=st.sampled_from(list("abcXYZ019 :-#'\".é_")), min_size=1, max_size=12)
_ZONES = st.sampled_from([dt.timezone.utc, dt.timezone(dt.timedelta(hours=5, minutes=30)),
                          dt.timezone(-dt.timedelta(hours=3))])
_STAMPS = st.builds(lambda d, z: d.replace(tzinfo=z),
                    st.datetimes(min_value=dt.datetime(1900, 1, 1),
                                 max_value=dt.datetime(2100, 1, 1)), _ZONES)
_SCALARS = st.one_of(st.none(), st.booleans(), st.integers(-10**12, 10**12),
                     st.floats(allow_nan=False), _TEXT, _STAMPS)
_TREES = st.recursive(_SCALARS, lambda inner: st.one_of(
    st.lists(inner, max_size=4), st.dictionaries(_KEYS, inner, max_size=4)), max_leaves=12)
_TAG = re.compile(r"(?:^|[ \[{,])!![a-z]+ ", re.M)


@settings(max_examples=300, deadline=None, suppress_health_check=list(HealthCheck))
@given(_TREES, st.sampled_from(sorted(DUMPS)))
def test_generated_objects_read_back_as_pyyaml_reads_them(obj, style):
    text = DUMPS[style](obj)
    if _TAG.search(text):
        # PyYAML tags a timestamp it cannot write plain (flow style): refused
        with pytest.raises(yaml_subset.YAMLSubsetError, match="a tag"):
            yaml_subset.load(text)
        return
    assert same(yaml_subset.load(text), yaml.safe_load(text)), text


@settings(max_examples=200, deadline=None, suppress_health_check=list(HealthCheck))
@given(_TREES, st.integers(0, 4))
def test_the_writer_reads_back_equal_in_both_readers(obj, indent):
    text = yaml_subset.dump(obj, indent=indent)
    assert same(yaml_subset.load(text), obj) and same(yaml.safe_load(text), obj), text


# -- the config loader of the workflow generator
CRD = """
apiVersion: equinor.com/v1
kind: Gordo
spec:
  config:
    machines:
      - name: m
        dataset:
          train_start_date: 2019-01-01T00:00:00+00:00
"""


def test_load_config_is_get_dict_from_yaml(tmp_path):
    assert same(yaml_subset.load_config(CRD), get_dict_from_yaml(CRD))
    path = tmp_path / "config.yaml"
    path.write_text(CRD)
    assert same(yaml_subset.load_config(str(path)), get_dict_from_yaml(str(path)))
    assert same(yaml_subset.load_config(os.path.join(REPO, "examples", "config.yaml")),
                get_dict_from_yaml(os.path.join(REPO, "examples", "config.yaml")))
    for naive, match in (("t: 2019-01-01T00:00:00", "Provide timezone"),
                         ("t: 2019-01-01", "not a bare date")):
        with pytest.raises(yaml_subset.TimestampNotTZAware, match=match) as ours:
            yaml_subset.load_config(naive)
        with pytest.raises(JaxNotTZAware) as theirs:
            get_dict_from_yaml(naive)
        assert str(ours.value) == str(theirs.value)
    for broken in ("- a list", "a: [1"):
        with pytest.raises(ValueError):
            get_dict_from_yaml(broken)
        with pytest.raises(ValueError):
            yaml_subset.load_config(broken)


# -- C2: a YAML project config through both packages' batch-build
def _spec_config_block(unquoted: bool) -> str:
    """The ``spec.config`` block of examples/config.yaml as YAML text (its
    lines as written, dedented), its training window cut to one day for
    the CPU, the dates quoted as written or unquoted."""
    with open(os.path.join(REPO, "examples", "config.yaml")) as fh:
        lines = fh.read().splitlines()
    start = lines.index("  config:") + 1
    text = "\n".join(line[4:] for line in lines[start:]) + "\n"
    text = text.replace("2019-01-08T00:00:00+00:00", "2019-01-02T00:00:00+00:00")
    if unquoted:
        text = re.sub(r'"(2019-01-0[12]T00:00:00\+00:00)"', r"\1", text)
    return text


@pytest.mark.parametrize("unquoted", [False, True], ids=["quoted_dates", "unquoted_dates"])
def test_c2_a_yaml_project_config_builds_in_both_packages(tmp_path, unquoted):
    text = _spec_config_block(unquoted)
    assert ("2019-01-01T00:00:00+00:00\n" in text) == unquoted
    config_file = tmp_path / "config.yaml"
    config_file.write_text(text)
    ours = NormalizedConfig(yaml_subset.load(text), project_name="batch").machines
    theirs = JaxNormalizedConfig(yaml.safe_load(text), project_name="batch").machines
    assert [m.name for m in ours] == [m.name for m in theirs] == [
        "pump-station-a", "compressor-b", "turbine-c"]
    for mine, jax_machine in zip(ours, theirs):
        assert json.dumps(mine.model, sort_keys=True) == json.dumps(jax_machine.model,
                                                                     sort_keys=True)
        assert mine.dataset.to_dict()["train_start_date"] == "2019-01-01T00:00:00+00:00"

    result = CliRunner().invoke(gordo, ["batch-build", str(config_file), "--output-dir",
                                        str(tmp_path / "jax")], catch_exceptions=False)
    assert result.exit_code == 0, result.output
    assert cli.main(["batch-build", str(config_file), str(tmp_path / "port"),
                     "--device", "cpu"]) == 0
    built = sorted(os.listdir(tmp_path / "port"))
    assert built == sorted(os.listdir(tmp_path / "jax")) == sorted(m.name for m in ours)
    for name in built:
        port_meta = load_metadata(str(tmp_path / "port" / name))
        with open(tmp_path / "jax" / name / "metadata.json") as fh:
            jax_meta = json.load(fh)
        assert port_meta["model"] == jax_meta["model"]
        assert port_meta["dataset"]["train_start_date"] == jax_meta["dataset"][
            "train_start_date"]


@pytest.mark.parametrize("drill", CHAOS_DRILLS)
def test_each_chaos_yaml_scenario_reads_as_its_json_copy(drill):
    yaml_path = os.path.join(REPO, "resources", "chaos", f"{drill}.yaml")
    json_path = os.path.join(scn.SCENARIO_DIR, f"{drill}.json")
    with open(yaml_path) as fh, open(json_path) as copy:
        assert same(yaml_subset.load(fh), json.load(copy))
    assert _fields(scn.load_scenario(yaml_path)) == _fields(scn.load_scenario(json_path))


def _fields(spec) -> dict:
    out = dataclasses.asdict(spec)
    out.pop("path")
    return out
