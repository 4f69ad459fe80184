"""
The port's workflow generator (workflow/workflow_generator.py, the card's
``gpu-workflow.yml.template``, workflow/validate.py, ``workflow generate`` and
``workflow validate``) held against the JAX one: every toggle branch of
tests/gordo_tpu/test_workflow_template_render.py is rendered by both, JAX's
documents are put through the stated TPU→card mapping (:func:`to_card`),
and the two are equal; the validators give the same messages for the same
broken documents; the TPU options exit 2 naming their counterpart; the
version grammar and the helpers answer alike. Also the Jinja subset's
``trim_blocks``/``lstrip_blocks`` and ``items()`` against ``jinja2``.
"""

import copy
import itertools
import json

import jinja2
import pytest
import yaml
from click.testing import CliRunner
from hypothesis import HealthCheck, given, settings, strategies as st

from gordo_tpu.cli import workflow_generator as jax_cli_gen
from gordo_tpu.cli.cli import gordo as jax_gordo
from gordo_tpu.util import version as jax_version
from gordo_tpu.workflow import validate as jax_validate
from gordo_tpu.workflow import workflow_generator as jax_gen
from gordo_tpu_torch import cli
from gordo_tpu_torch.util import templates, version as port_version
from gordo_tpu_torch.workflow import validate as port_validate
from gordo_tpu_torch.workflow import workflow_generator as port_gen
from test_torch_templates import _PARAMS, _TEMPLATES, _outcome

GPU = port_gen.DEFAULT_GPU_PRODUCT
DATES = dict(client_start_date="2019-01-01T00:00:00Z", client_end_date="2019-01-02T00:00:00Z")
GPU_TOLERATION = {"key": "nvidia.com/gpu", "operator": "Exists", "effect": "NoSchedule"}
CONFIG_EOF = "<<'GORDO_TPU_CONFIG_EOF'\n"


def _config_yaml(n_machines: int) -> str:
    machines = [
        {
            "name": f"machine-{i}",
            "dataset": {
                "type": "RandomDataset",
                "tags": [f"tag-{i}-{j}" for j in range(4)],
                "train_start_date": "2019-01-01T00:00:00+00:00",
                "train_end_date": "2019-01-08T00:00:00+00:00",
            },
            "model": {"gordo_tpu.models.models.AutoEncoder": {"kind": "feedforward_hourglass"}},
        }
        for i in range(n_machines)
    ]
    return yaml.safe_dump({"machines": machines})


@pytest.fixture(scope="module")
def config_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("render") / "config.yml"
    p.write_text(_config_yaml(3))
    return str(p)


def _normalized(doc: dict) -> dict:
    """``doc`` with each resource manifest and the staged config parsed:
    their text is YAML that the two generators dump in their own styles."""
    doc = copy.deepcopy(doc)
    for tmpl in doc["spec"]["templates"]:
        if "resource" in tmpl:
            tmpl["resource"]["manifest"] = yaml.safe_load(tmpl["resource"]["manifest"])
        if tmpl["name"] == "stage-config":
            source = tmpl["script"]["source"]
            start = source.index(CONFIG_EOF) + len(CONFIG_EOF)
            end = source.index("\nGORDO_TPU_CONFIG_EOF")
            tmpl["script"]["source"] = (source[:start], yaml.safe_load(source[start:end]),
                                        source[end:])
    return doc


def to_card(doc: dict, gpu_product: str = GPU) -> dict:
    """A JAX document (normalized) through the TPU→card mapping: the builder
    template and its tasks renamed ``gpu-batch-builder``, the node selector
    ``nvidia.com/gpu.product``, the ``nvidia.com/gpu`` toleration and one
    card in place of the TPU's, no JAX_PLATFORMS, the port's commands, the
    server pod on a card too, and the client's ``--scheme=http`` (C4)."""
    doc = copy.deepcopy(doc)
    rename = lambda name: name.replace("tpu-batch-builder", "gpu-batch-builder")  # noqa: E731
    for tmpl in doc["spec"]["templates"]:
        name = tmpl["name"]
        if name == "tpu-batch-builder":
            tmpl["name"] = rename(name)
            tmpl["nodeSelector"] = {"nvidia.com/gpu.product": gpu_product}
            tmpl["tolerations"][0] = dict(GPU_TOLERATION)
            container = tmpl["container"]
            container["args"] = [arg.replace("exec gordo-tpu batch-build",
                                             "exec python -m gordo_tpu_torch batch-build")
                                 for arg in container["args"]]
            container["env"] = [e for e in container["env"] if e["name"] != "JAX_PLATFORMS"]
            for part in ("requests", "limits"):
                resources = container["resources"][part]
                del resources["google.com/tpu"]
                resources["nvidia.com/gpu"] = 1
        elif name == "gordo-server-deployment":
            pod = tmpl["resource"]["manifest"]["spec"]["template"]["spec"]
            pod["nodeSelector"] = {"nvidia.com/gpu.product": gpu_product}
            pod["tolerations"] = [dict(GPU_TOLERATION)]
            server = pod["containers"][0]
            server["command"] = ["python", "-m", "gordo_tpu_torch", "run-server"]
            for part in ("requests", "limits"):
                server["resources"][part]["nvidia.com/gpu"] = 1
        elif name == "gordo-client":
            container = tmpl["container"]
            container["command"] = ["python", "-m", "gordo_tpu_torch.client"]
            args = container["args"]
            args.insert(args.index("--port=80") + 1, "--scheme=http")
        elif name == "gordo-grafana":
            provision = tmpl["resource"]["manifest"]["spec"]["template"]["spec"][
                "initContainers"][0]
            provision["args"] = [arg.replace("gordo_tpu.observability.grafana",
                                             "gordo_tpu_torch.observability.grafana")
                                 for arg in provision["args"]]
        elif "dag" in tmpl:
            for task in tmpl["dag"]["tasks"]:
                task["name"], task["template"] = rename(task["name"]), rename(task["template"])
                if "dependencies" in task:
                    task["dependencies"] = [rename(d) for d in task["dependencies"]]
    return doc


def _both(config: str, gpu_product: str = GPU, machines_per_gpu_worker: int = 256,
          **overrides):
    """(JAX's documents through :func:`to_card`, the port's documents), both
    normalized, of one rendering."""
    kwargs = dict(DATES, **overrides)
    theirs = jax_cli_gen.generate_workflow_docs(
        machine_config=config, project_name="render-gate",
        machines_per_tpu_worker=machines_per_gpu_worker, **kwargs)
    ours = port_gen.generate_workflow_docs(
        machine_config=config, project_name="render-gate", gpu_product=gpu_product,
        machines_per_gpu_worker=machines_per_gpu_worker, **kwargs)
    port_validate.validate_workflow_docs(ours)
    return ([to_card(_normalized(d), gpu_product) for d in yaml.safe_load_all(theirs) if d],
            [_normalized(d) for d in yaml.safe_load_all(ours) if d])


_BOOL_TOGGLES = ("enable_clients", "enable_postgres", "enable_influx", "enable_grafana",
                 "spot_tolerations")


@pytest.mark.parametrize(
    "flags",
    list(itertools.product([True, False], repeat=len(_BOOL_TOGGLES))),
    ids=lambda flags: "".join("ty"[f] for f in flags),
)
@pytest.mark.parametrize("hpa", ["cpu", "keda"])
def test_every_toggle_branch_renders_as_jax_under_the_card_mapping(config_file, flags, hpa):
    theirs, ours = _both(config_file, ml_server_hpa_type=hpa, **dict(zip(_BOOL_TOGGLES, flags)))
    assert ours and ours == theirs


@pytest.mark.parametrize("overrides", [
    dict(machines_per_gpu_worker=1),
    dict(owner_references='[{"apiVersion": "v1", "kind": "Deployment", "name": "x", "uid": "1"}]',
         custom_model_builder_envs='[{"name": "EXTRA", "value": "1"}, {"name": "FROM", '
                                   '"valueFrom": {"secretKeyRef": {"name": "s", "key": "k"}}}]',
         postgres_host="pg.example.com", resource_labels=(("team", "abc"), ("tier", "x y"))),
    dict(project_revision="7", gordo_version="pr-12", docker_registry="r.example",
         docker_image="img", image_pull_policy="Never", retries=2, server_replicas=3,
         server_workers=1, ml_server_max_replicas=9, ml_server_min_replicas=1,
         ml_server_hpa_cpu_target=70, storage_claim_name="claim", service_account="sa",
         deadline_seconds=60, exceptions_report_level="TRACEBACK", split_workflows=2),
], ids=["chunks", "owner-envs-postgres-labels", "options"])
def test_the_other_branches_render_as_jax_under_the_card_mapping(config_file, overrides):
    theirs, ours = _both(config_file, **overrides)
    assert ours and ours == theirs


def test_a_gpu_product_lands_in_the_builder_and_server_selectors(config_file):
    theirs, ours = _both(config_file, gpu_product="NVIDIA-A100-SXM4-80GB")
    assert ours == theirs


def test_split_workflows_and_the_project_wide_hpa_ceiling():
    theirs, ours = _both(_config_yaml(35), split_workflows=30)
    assert len(ours) == 2 and ours == theirs


# -- the validators
def _first_doc(config_file, generate) -> dict:
    content = generate(machine_config=config_file, project_name="test-proj", **DATES)
    return yaml.safe_load(content.split("\n---\n")[0])


def _undefined_template(doc):
    next(t for t in doc["spec"]["templates"] if "dag" in t)["dag"]["tasks"][0]["template"] = (
        "no-such-template")


def _cycle(doc):
    tasks = next(t for t in doc["spec"]["templates"] if "dag" in t)["dag"]["tasks"]
    tasks[0]["dependencies"], tasks[1]["dependencies"] = [tasks[1]["name"]], [tasks[0]["name"]]


def _bad_name(doc):
    doc["spec"]["templates"][0]["name"] = "Not_A_Valid_Name"


def _numeric_env(doc):
    for t in doc["spec"]["templates"]:
        if "container" in t and t["container"].get("env"):
            t["container"]["env"][0]["value"] = 42
            break


def _no_entrypoint(doc):
    del doc["spec"]["entrypoint"]


def _steps(doc):
    doc["spec"]["templates"].append({"name": "stepper", "steps": [
        [{"name": "a", "template": "nope"}, {"name": "a", "template": "do-all"}], ["junk"]]})


def _many(doc):
    doc["apiVersion"], doc["kind"] = "v1", "Pod"
    doc["metadata"] = {}
    doc["spec"]["onExit"] = "missing"
    doc["spec"]["templates"][1]["script"]["volumeMounts"].append({"name": "ghost",
                                                                 "mountPath": "/x"})


BROKEN = {"undefined_template": _undefined_template, "cycle": _cycle, "dns1123": _bad_name,
          "numeric_env": _numeric_env, "entrypoint": _no_entrypoint, "steps": _steps,
          "many": _many}


def _verdict(validate, text: str):
    try:
        validate(text)
    except ValueError as exc:
        return type(exc).__name__, str(exc)
    return ("ok",)


@pytest.mark.parametrize("breakage", list(BROKEN))
@pytest.mark.parametrize("source", ["jax", "port"])
def test_both_validators_give_the_same_messages_for_a_broken_document(config_file, breakage,
                                                                      source):
    generate = (jax_cli_gen.generate_workflow_docs if source == "jax"
                else port_gen.generate_workflow_docs)
    doc = _first_doc(config_file, generate)
    text = yaml.safe_dump(doc)
    assert _verdict(port_validate.validate_workflow_docs, text) == ("ok",)
    BROKEN[breakage](doc)
    text = yaml.safe_dump(doc)
    ours = _verdict(port_validate.validate_workflow_docs, text)
    assert ours[0] == "WorkflowValidationError"
    assert ours == _verdict(jax_validate.validate_workflow_docs, text)


@pytest.mark.parametrize("text", ["", "---\n", "- a\n- b\n", "kind: Workflow\n"])
def test_both_validators_refuse_odd_streams_alike(text):
    assert _verdict(port_validate.validate_workflow_docs, text) == _verdict(
        jax_validate.validate_workflow_docs, text)


# -- the command lines
@pytest.mark.parametrize("option,named", [
    ("--machines-per-tpu-worker", "--machines-per-gpu-worker"),
    ("--tpu-accelerator-type", "--gpu-product"),
    ("--tpu-topology", "--gpu-product"),
    ("--tpu-chips-per-worker", "nvidia.com/gpu: 1"),
    ("--tpu-workers-per-slice", "A7"),
])
def test_each_tpu_option_exits_2_naming_its_counterpart(config_file, option, named, capsys):
    with pytest.raises(SystemExit) as exited:
        cli.main(["workflow", "generate", "--machine-config", config_file, "--project-name", "p",
                  option, "8"])
    assert exited.value.code == 2
    err = capsys.readouterr().err
    assert option in err and named in err


def test_generate_through_both_clis(config_file, tmp_path, capsys):
    common = ["--machine-config", config_file, "--project-name", "cli-proj",
              "--client-start-date", DATES["client_start_date"],
              "--client-end-date", DATES["client_end_date"], "--resource-labels", "team,abc"]
    jax_out, port_out = tmp_path / "jax.yaml", tmp_path / "port.yaml"
    result = CliRunner().invoke(jax_gordo, ["workflow", "generate", *common,
                                            "--machines-per-tpu-worker", "2",
                                            "--output-file", str(jax_out)])
    assert result.exit_code == 0, result.output
    assert cli.main(["workflow", "generate", *common, "--machines-per-gpu-worker", "2",
                     "--output-file", str(port_out)]) == 0
    assert ([_normalized(d) for d in yaml.safe_load_all(port_out.read_text()) if d]
            == [to_card(_normalized(d)) for d in yaml.safe_load_all(jax_out.read_text()) if d])
    assert cli.main(["workflow", "validate", str(port_out)]) == 0
    assert capsys.readouterr().out.strip() == "workflow documents OK"
    broken = tmp_path / "broken.yaml"
    broken.write_text(port_out.read_text().replace("entrypoint: do-all", "entrypoint: nope"))
    jax_result = CliRunner().invoke(jax_gordo, ["workflow", "validate", str(broken)])
    assert cli.main(["workflow", "validate", str(broken)]) == jax_result.exit_code == 1
    assert capsys.readouterr().err == jax_result.output


def _generate_errors(generate, refused, **kwargs):
    try:
        generate(**kwargs)
    except refused as exc:
        return str(exc.message if hasattr(exc, "message") else exc)
    return None


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(client_start_date="banana", client_end_date="2019-01-02T00:00:00Z"),
    dict(client_start_date="2019-01-01T00:00:00", client_end_date="2019-01-02T00:00:00Z"),
    dict(client_start_date="2019-01-01T00:00:00Z", client_end_date="2019-01-02"),
    dict(enable_clients=False, project_revision="r1"),
    dict(enable_clients=False, custom_model_builder_envs="{"),
    dict(enable_clients=False, custom_model_builder_envs='{"name": "A"}'),
    dict(enable_clients=False, custom_model_builder_envs='[{"value": "1"}]'),
    dict(enable_clients=False, custom_model_builder_envs='[{"name": "A"}]'),
    dict(enable_clients=False, custom_model_builder_envs='[{"name": "A", "value": 1}]'),
], ids=["no-dates", "banana", "naive", "bare-end", "revision", "envs-json", "envs-list",
        "envs-name", "envs-value", "envs-type"])
def test_refused_options_give_the_jax_message(kwargs):
    import click

    config = _config_yaml(2)
    theirs = _generate_errors(jax_cli_gen.generate_workflow_docs, click.ClickException,
                              machine_config=config, project_name="d-proj", **kwargs)
    ours = _generate_errors(port_gen.generate_workflow_docs, port_gen.WorkflowGeneratorError,
                            machine_config=config, project_name="d-proj", **kwargs)
    assert theirs is not None and ours == theirs


@pytest.mark.parametrize("text", [
    "machines: []\nstart: 2019-01-01 00:00:00\n",
    "machines:\n  - name: m\n    start: 2019-01-01\n",
])
def test_tz_naive_and_bare_dates_are_refused_as_in_jax(tmp_path, text):
    path = tmp_path / "bad.yml"
    path.write_text(text)
    with pytest.raises(jax_gen.TimestampNotTZAware) as theirs:
        jax_gen.get_dict_from_yaml(str(path))
    with pytest.raises(port_gen.TimestampNotTZAware) as ours:
        port_gen.get_dict_from_yaml(str(path))
    assert str(ours.value) == str(theirs.value)


def test_the_helpers_answer_as_jax():
    for tag in ("latest", "stable", "pr-12", "1.2.3", "abc123f"):
        assert port_gen.default_image_pull_policy(tag) == jax_gen.default_image_pull_policy(tag)
    for tag in ("feature/x y", "..-lead", "", "ok_1.2", "x" * 200):
        assert port_gen.sanitize_docker_tag(tag) == jax_gen.sanitize_docker_tag(tag)
    for items, size in ((list(range(5)), 2), ([], 3), (list(range(4)), 4)):
        assert port_gen.chunk_machines(items, size) == jax_gen.chunk_machines(items, size)
    with pytest.raises(ValueError):
        port_gen.chunk_machines([1], 0)
    good = [{"uid": "1", "name": "x", "kind": "Deployment", "apiVersion": "v1"}]
    assert port_gen.validate_generate_owner_ref(good) == good
    for bad in ([{"name": "x"}], [], "x", [None]):
        with pytest.raises(TypeError) as ours:
            port_gen.validate_generate_owner_ref(bad)
        with pytest.raises(TypeError) as theirs:
            jax_gen.validate_generate_owner_ref(bad)
        assert str(ours.value) == str(theirs.value)
    for base in ("short", "x" * 63, "p" * 40 + "-r12-g0c0" + "y" * 30, "a-" * 40):
        assert port_gen._bounded_k8s_name(base) == jax_cli_gen._bounded_k8s_name(base)
    doc = yaml.safe_dump({"kind": "Gordo", "spec": {"config": {"machines": []}}})
    assert port_gen.get_dict_from_yaml(doc) == jax_gen.get_dict_from_yaml(doc) == {"machines": []}


# -- the version grammar
VERSIONS = [("latest", "GordoSpecial", ("latest",)), ("stable", "GordoSpecial", ("stable",)),
            ("pr-42", "GordoPR", (42,)), ("1", "GordoRelease", (1,)),
            ("1.2", "GordoRelease", (1, 2)), ("1.2.3", "GordoRelease", (1, 2, 3)),
            ("1.2.3-rc1", "GordoRelease", (1, 2, 3, "-rc1")),
            ("1.2.3.dev1", "GordoRelease", (1, 2, 3, ".dev1")),
            ("deadbeefcafe", "GordoSHA", ("deadbeefcafe",))]


@pytest.mark.parametrize("module", [jax_version, port_version], ids=["jax", "port"])
@pytest.mark.parametrize("value,cls,args", VERSIONS)
def test_parse_version(module, value, cls, args):
    parsed = module.parse_version(value)
    assert parsed == getattr(module, cls)(*args)
    assert parsed.get_version() == value


@pytest.mark.parametrize("module", [jax_version, port_version], ids=["jax", "port"])
def test_release_shape_predicates(module):
    assert module.GordoRelease(1).only_major()
    assert module.GordoRelease(1, 2).only_major_minor()
    assert not module.GordoRelease(1, 2, 3).only_major()


@pytest.mark.parametrize("module", [jax_version, port_version], ids=["jax", "port"])
@pytest.mark.parametrize("bad", ["", "???", "v", "pr-", "xyz!"])
def test_parse_version_invalid(module, bad):
    with pytest.raises(ValueError):
        module.parse_version(bad)


@given(st.text(alphabet="0123456789abcdefpr-.+ ", max_size=12))
@settings(max_examples=200, deadline=None)
def test_both_grammars_parse_any_tag_alike(value):
    outcomes = []
    for module in (jax_version, port_version):
        try:
            parsed = module.parse_version(value)
            outcomes.append((type(parsed).__name__, parsed.get_version()))
        except ValueError as exc:
            outcomes.append(("ValueError", str(exc)))
    assert outcomes[0] == outcomes[1]


# -- the workflow's Jinja environment
_JINJA = jinja2.Environment(undefined=jinja2.StrictUndefined, trim_blocks=True,
                            lstrip_blocks=True)
_BLOCKS = st.sampled_from([
    "  {% if a %}x{% endif %}\n", "\n\t {# c #}\n", "  {%- if b %}\n  y\n  {% endif %}\n",
    "{% for k, v in cfg.items() %}  {{ k }}={{ v }}\n{% endfor %}\n",
    "{% for k, v in cfg.items() %}\n  - {{ k }}\n{% endfor %}", "  {{ a }}\n  {% set b = 1 %}\n",
])
_WORKFLOW_TEMPLATES = st.recursive(st.one_of(_TEMPLATES, _BLOCKS),
                                   lambda b: st.lists(b, max_size=4).map("".join), max_leaves=6)


@settings(max_examples=300, deadline=None, suppress_health_check=list(HealthCheck))
@given(_WORKFLOW_TEMPLATES, _PARAMS)
def test_trim_and_lstrip_blocks_render_as_jinja_renders(template, params):
    theirs = _outcome(lambda: _JINJA.from_string(template).render(**params))
    ours = _outcome(lambda: templates.render(template, params, trim_blocks=True,
                                             lstrip_blocks=True))
    assert ours == theirs, template


@pytest.mark.parametrize("template", [
    "{% for k, v in cfg %}{% endfor %}", "{% for k, v in cfg.values() %}{% endfor %}",
    "{% for k, v in items.items() %}{% endfor %}", "{{ cfg.items() }}",
])
def test_unpacking_is_in_the_subset_only_over_a_mappings_items(template):
    with pytest.raises(templates.TemplateSubsetError):
        templates.render(template, {"cfg": {"p": 1}, "items": [1]})


def test_the_card_template_renders_every_label_as_jinja_does(config_file):
    """``labels.items()`` (the one call of the template), with the whole
    template rendered by jinja2 and by the subset from one context."""
    with open(port_gen.os.path.join(port_gen._TEMPLATE_DIR, port_gen.DEFAULT_TEMPLATE)) as fh:
        text = fh.read()
    captured = {}
    original = port_gen.WorkflowTemplate.render

    def capture(self, **context):
        captured.update(context)
        return original(self, **context)

    port_gen.WorkflowTemplate.render = capture
    try:
        ours = port_gen.generate_workflow_docs(
            config_file, "labels", resource_labels=(("a", "1"), ("b c", "d")), **DATES)
    finally:
        port_gen.WorkflowTemplate.render = original
    env = jinja2.Environment(undefined=jinja2.StrictUndefined, trim_blocks=True,
                             lstrip_blocks=True)
    env.filters["yaml"] = jax_gen._yaml_filter
    theirs = env.from_string(text).render(**captured) + "\n"
    assert [_normalized(d) for d in yaml.safe_load_all(ours)] == [
        _normalized(d) for d in yaml.safe_load_all(theirs)]
    assert json.dumps(yaml.safe_load(ours)["metadata"]["labels"], sort_keys=True).count('"a"') == 1
