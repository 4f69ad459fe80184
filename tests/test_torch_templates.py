"""
Model templates: the port's Jinja subset (``gordo_tpu_torch/util/templates.py``),
``expand_model`` and ``build --model-parameter`` (``gordo_tpu_torch/cli.py``)
against ``jinja2`` with ``StrictUndefined`` and the JAX CLI
(``gordo_tpu/cli/cli.py``).

Rendered text is held equal character for character; a template either
renders in both or fails in both (an undefined name in both as Jinja's
``UndefinedError``). Built models are held to equal definitions, and the
JAX build's weights carried into the port (serializer/from_jax.py) predict
within TOL_PREDICT of the JAX predict on the same rows.
"""

import json
import pickle

import jinja2
import numpy as np
import pytest
import yaml
from click.testing import CliRunner
from hypothesis import HealthCheck, given, settings, strategies as st

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.cli.cli import expand_model as jax_expand_model, gordo
from gordo_tpu.cli.custom_types import key_value_par as jax_key_value_par
from gordo_tpu.workflow.workflow_generator import _yaml_filter as jax_yaml_filter
from gordo_tpu_torch import cli, serializer
from gordo_tpu_torch.serializer.from_jax import detector_from_arrays, spec_from_dataclass
from gordo_tpu_torch.util import templates, yaml_subset

TOL_PREDICT = 1e-5  # float32 feedforward predicts, the same weights, two frameworks
_JINJA = jinja2.Environment(loader=jinja2.BaseLoader(), undefined=jinja2.StrictUndefined)

# tests/gordo_tpu/test_cli.py's two string models, as written there
JAX_CASES = {
    "expansion": ("""
            gordo_tpu.models.models.AutoEncoder:
                kind: feedforward_hourglass
                epochs: {{ n_epochs }}
        """, {"n_epochs": "1"}),
    "parameterless": ("gordo_tpu.models.models.AutoEncoder:\n"
                      "  kind: feedforward_hourglass\n"
                      "  epochs: 1\n", {}),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_jax_cli_template_cases_expand_alike(case):
    template, parameters = JAX_CASES[case]
    assert cli.expand_model(template, dict(parameters)) == jax_expand_model(template,
                                                                             dict(parameters))


def test_a_missing_parameter_raises_the_jax_value_error():
    with pytest.raises(ValueError, match="^Model parameter missing value!$") as ours:
        cli.expand_model("model: {{ missing }}", {})
    with pytest.raises(ValueError) as theirs:
        jax_expand_model("model: {{ missing }}", {})
    assert str(ours.value) == str(theirs.value)
    assert isinstance(ours.value.__cause__, templates.UndefinedError)


# a detector over the JAX test's AutoEncoder (the port's artifact holds a
# detector), with an {% if %}, a filter and typed parameters
DETECTOR_TEMPLATE = """
gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector:
  base_estimator:
    sklearn.pipeline.Pipeline:
      steps:
        - sklearn.preprocessing.MinMaxScaler
        - gordo_tpu.models.models.AutoEncoder:
            kind: {{ kind | default('feedforward_hourglass') | lower }}
            epochs: {{ n_epochs }}
{%- if batch %}
            batch_size: {{ batch | int }}
{%- endif %}
"""
BUILD_CASES = {
    "parameters": (DETECTOR_TEMPLATE, ["n_epochs,2", "batch,16", "kind,FEEDFORWARD_HOURGLASS"]),
    "parameterless": (DETECTOR_TEMPLATE.replace("{{ n_epochs }}", "1").replace(
        "{%- if batch %}", "{%- if false %}"), []),
}


def _machine(name: str, model: str) -> dict:
    return {
        "name": name,
        "dataset": {"type": "RandomDataset", "tags": ["tag-0", "tag-1", "tag-2"],
                    "train_start_date": "2019-01-01T00:00:00+00:00",
                    "train_end_date": "2019-01-02T00:00:00+00:00"},
        "model": model,
    }


def _flags(pairs):
    return [flag for pair in pairs for flag in ("--model-parameter", pair)]


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_build_model_parameter_through_both_clis(case, tmp_path):
    template, pairs = BUILD_CASES[case]
    config = yaml.safe_dump(_machine(f"tpl-{case}", template))
    result = CliRunner().invoke(gordo, ["build", config, str(tmp_path / "jax"), *_flags(pairs)],
                                catch_exceptions=False)
    assert result.exit_code == 0, result.output
    assert cli.main(["build", config, str(tmp_path / "port"), "--device", "cpu",
                     *_flags(pairs)]) == 0
    ours = serializer.load_metadata(str(tmp_path / "port"))
    theirs = jax_serializer.load_metadata(str(tmp_path / "jax"))
    assert ours["model"] == theirs["model"]
    estimator = ours["model"]["gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector"][
        "base_estimator"]["sklearn.pipeline.Pipeline"]["steps"][1][
        "gordo_tpu.models.models.AutoEncoder"]
    assert estimator["epochs"] == (2 if pairs else 1)
    assert estimator.get("batch_size") == (16 if pairs else theirs["model"][
        "gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector"]["base_estimator"][
        "sklearn.pipeline.Pipeline"]["steps"][1]["gordo_tpu.models.models.AutoEncoder"].get(
        "batch_size"))

    # the JAX build's weights in the port predict as the JAX model does
    with open(tmp_path / "jax" / "model.pkl", "rb") as fh:
        jax_model = pickle.load(fh)
    (_, in_scaler), (_, jax_estimator) = jax_model.base_estimator.steps
    carried = detector_from_arrays(
        spec_from_dataclass(jax_estimator.spec_),
        [{k: np.asarray(v) for k, v in p.items()} for p in jax_estimator.params_],
        in_scaler.min_, in_scaler.scale_, jax_model.scaler.min_, jax_model.scaler.scale_,
        estimator="AutoEncoder", kind="feedforward_hourglass",
        feature_thresholds=np.asarray(jax_model.feature_thresholds_),
        aggregate_threshold=jax_model.aggregate_threshold_, device="cpu")
    X = np.random.RandomState(0).rand(64, 3)
    np.testing.assert_allclose(carried.predict(X), np.asarray(jax_model.predict(X)),
                               rtol=TOL_PREDICT, atol=TOL_PREDICT)


def test_a_missing_parameter_exits_1_with_the_same_report_through_both_clis(tmp_path):
    config = yaml.safe_dump(_machine("tpl-missing", DETECTOR_TEMPLATE))
    reports = []
    for name, run in (("jax", lambda argv: CliRunner().invoke(gordo, argv).exit_code),
                      ("port", lambda argv: cli.main([*argv, "--device", "cpu"]))):
        report = tmp_path / f"{name}.json"
        assert run(["build", config, str(tmp_path / name), "--exceptions-reporter-file",
                    str(report)]) == 1
        reports.append(json.loads(report.read_text()))
    assert reports[0] == reports[1] == {"type": "ValueError", "exit_code": 1,
                                        "message": "Model parameter missing value!"}


def test_key_value_par_splits_as_jax_does():
    for text in ("a,b", "a,b,c", ",", "key,"):
        assert cli.key_value_par(text) == jax_key_value_par(text)


def test_key_value_par_refuses_a_value_without_a_comma_through_both_clis(capsys):
    reason = "'nocomma' is not of the form 'key,value' (missing comma)"
    result = CliRunner().invoke(gordo, ["build", "{}", "out", "--model-parameter", "nocomma"])
    assert result.exit_code == 2 and reason in result.output, result.output
    with pytest.raises(SystemExit) as exited:
        cli.main(["build", "{}", "out", "--model-parameter", "nocomma"])
    assert exited.value.code == 2 and reason in capsys.readouterr().err


# -- the subset's text against jinja2's
def _outcome(render):
    try:
        return ("ok", render())
    except (jinja2.UndefinedError, templates.UndefinedError):
        return ("undefined",)
    except (jinja2.TemplateSyntaxError, templates.TemplateSubsetError):
        return ("syntax",)
    except Exception as exc:  # noqa: BLE001 -- the outcome is compared
        return ("error", type(exc).__name__)


def _both(template: str, params: dict):
    return (_outcome(lambda: _JINJA.from_string(template).render(**params)),
            _outcome(lambda: templates.render(template, params)))


WHITESPACE = [
    "a\n{% if true %}\nb\n{% endif %}\nc\n",
    "a\n{%- if true %}\nb\n{%- endif %}\nc\n\n",
    "a  {%- if true -%}  b  {%- endif %}  c",
    "{# a comment #}x{#- another -#}\n  y",
    "{% for i in [1, 2, 3] %}\n- {{ i }}{% if not loop.last %},{% endif %}\n{% endfor %}\n",
    "{%- set n = 2 -%}\n  {{ n }}\n",
    "{{ p -}}\n  {{- p }}\r\nend\r\n",
    "kind: {{ p | default('x') }}\n\n",
    # tojson's Markup inside a printed list (ROADMAP C5), and after a filter
    "{{ [0 | tojson] }}",
    "{{ [p | tojson | trim, p | tojson | upper] }}\n",
]


@pytest.mark.parametrize("template", WHITESPACE)
def test_jinja_whitespace_rules_hold(template):
    ours, theirs = _both(template, {"p": "v"})
    assert ours == theirs and ours[0] == "ok"


_LEAVES = st.one_of(
    st.integers(-5, 20).map(str),
    st.sampled_from(["1.5", "0.25", "1e3", "'x'", '"y z"', "'a,b'", "' pad '", "'MiXed'",
                     "'3'", "'4.7'", "'x' 'y'", "true", "false", "none", "[]", "[1, 2]",
                     "['p', 'q']"]),
    st.sampled_from(["a", "b", "s", "items", "cfg", "missing", "v", "loop.index",
                     "loop.first", "loop.last"]),
    st.sampled_from(["cfg.p", "cfg.q", "cfg.missing", "items[0]", "items[-1]", "cfg['q']",
                     "items[5]", "missing.p", "items[missing]"]),
)
_FILTERS = ["default(3)", "default('d')", "default(none)", "default(0, true)", "join(', ')",
            "join", "tojson", "trim", "lower", "upper", "int", "int(7)", "float", "length"]
_EXPR = st.recursive(_LEAVES, lambda e: st.one_of(
    st.tuples(e, st.sampled_from(["==", "!=", "<", ">=", "in", "not in", "and", "or"]), e).map(
        lambda t: f"({t[0]} {t[1]} {t[2]})"),
    e.map(lambda x: f"(not {x})"),
    st.tuples(e, st.sampled_from(_FILTERS)).map(lambda t: f"{t[0]} | {t[1]}"),
    st.lists(e, max_size=3).map(lambda xs: "[" + ", ".join(xs) + "]"),
), max_leaves=5)
_OPEN = st.sampled_from(["{%", "{%-"])
_CLOSE = st.sampled_from(["%}", "-%}"])
_TEXT = st.sampled_from(["", "x", " ", "\n", "  \n  ", "k: v\n", "}", "-", "a:\n  - "])
_OUTPUT = st.tuples(st.sampled_from(["{{", "{{-"]), _EXPR, st.sampled_from(["}}", "-}}"])).map(
    lambda t: f"{t[0]} {t[1]} {t[2]}")
_SET = st.tuples(_OPEN, st.sampled_from(["a", "b", "s"]), _EXPR, _CLOSE).map(
    lambda t: f"{t[0]} set {t[1]} = {t[2]} {t[3]}")


def _if(body):
    return st.tuples(_OPEN, _EXPR, _CLOSE, body, st.lists(st.tuples(_EXPR, body), max_size=2),
                     st.one_of(st.none(), body)).map(
        lambda t: (f"{t[0]} if {t[1]} {t[2]}{t[3]}"
                   + "".join(f"{{% elif {test} %}}{block}" for test, block in t[4])
                   + ("" if t[5] is None else f"{{%- else %}}{t[5]}") + "{% endif %}"))


def _for(body):
    return st.tuples(_OPEN, _EXPR, _CLOSE, body).map(
        lambda t: f"{t[0]} for v in {t[1]} {t[2]}{t[3]}{{% endfor -%}}")


_TEMPLATES = st.recursive(st.one_of(_TEXT, _OUTPUT, _SET), lambda body: st.one_of(
    st.lists(body, max_size=4).map("".join), _if(body), _for(body)), max_leaves=8)
_PARAMS = st.fixed_dictionaries({
    "a": st.integers(-3, 3), "b": st.sampled_from(["", "1", "two", "Three 3"]),
    "s": st.sampled_from(["x", "4.5", " spaced ", "a,b"]),
    "items": st.lists(st.sampled_from([0, 1, "p", "q", "2"]), max_size=3),
    "cfg": st.fixed_dictionaries({"p": st.integers(0, 3), "q": st.sampled_from(["q", "Q q"])}),
})


@settings(max_examples=300, deadline=None, suppress_health_check=list(HealthCheck))
@given(_TEMPLATES, _PARAMS)
def test_the_subset_renders_as_jinja_renders(template, params):
    ours, theirs = _both(template, params)
    assert ours == theirs, template


@pytest.mark.parametrize("template", [
    "{% raw %}x{% endraw %}", "{{ a + 1 }}", "{{ a ~ 'x' }}", "{{ a is defined }}",
    "{{ range(3) }}", "{% macro m() %}{% endmacro %}", "{{ a if a else 1 }}",
    "{%+ if a %}x{% endif %}", "{{ a | nosuch }}", "{{ a | default(1, 2, 3) }}",
    "{% for k, v in cfg %}{% endfor %}", "{% for v in items %}{% else %}{% endfor %}",
    "{% set x %}y{% endset %}", "{{ cfg.items }}", "{{ a.__class__ }}", "{{ items[1:2] }}",
    "{{ {'k': 1} }}", "{{ 1, 2 }}", "{% include 'x' %}",
    "{% for v in items %}{{ loop.cycle }}{% endfor %}", "{{ '1f' | int(0, base=16) }}",
])
def test_constructs_outside_the_subset_raise_before_any_output(template):
    params = {"a": 1, "items": [1, 2], "cfg": {"p": 1}}
    with pytest.raises(templates.TemplateSubsetError):
        templates.render("text before " + template, params)
    if "loop" not in template:
        assert _outcome(lambda: _JINJA.from_string(template).render(**params))[0] in (
            "ok", "syntax", "error")


@pytest.mark.parametrize("value", [
    {"a": [1, {"b": "c: d"}], "e": None, "f": 1.5, "g": "yes", "h": "", "i": "multi\nline"},
    ["x", 1, True, [], {}],
    "2019-01-01T00:00:00+00:00",
])
@pytest.mark.parametrize("indent", [0, 4])
def test_the_yaml_filter_reads_back_equal(value, indent):
    text = templates.render("{{ v | yaml(%d) }}" % indent, {"v": value})
    assert yaml.safe_load(text) == yaml_subset.load(text) == value
    assert yaml.safe_load(text) == yaml.safe_load(jax_yaml_filter(value, indent))
    if indent:
        assert all(line.startswith(" " * indent) for line in text.splitlines())


def test_a_rendered_model_reads_its_parameters_as_yaml_types():
    template = "m:\n  epochs: {{ e }}\n  flag: {{ f }}\n  name: '{{ n }}'\n  rate: {{ r }}"
    params = {"e": "3", "f": "on", "n": "on", "r": "1e-3"}
    assert cli.expand_model(template, params) == jax_expand_model(template, params) == {
        "m": {"epochs": 3, "flag": True, "name": "on", "rate": "1e-3"}}
