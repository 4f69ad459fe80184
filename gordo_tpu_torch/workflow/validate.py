"""
Schema-level validation of rendered Argo Workflow documents: the port's
copy of ``gordo_tpu/workflow/validate.py``, with the same checks and
messages, reading the documents with util/yaml_subset.py. It stands in for
``argo lint``, which needs a live cluster: CRD shape, template-name
uniqueness and reference integrity (DAG dependency cycles included), k8s
DNS-1123 naming, container/env/volume sanity.

Wired into ``python -m gordo_tpu_torch workflow validate`` (a file or
stdin) and callable as :func:`validate_workflow_docs`.
"""

import re
from typing import Any, Dict, List

from ..util import yaml_subset

DNS1123 = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
ENV_NAME = re.compile(r"^[-._a-zA-Z][-._a-zA-Z0-9]*$")

_TEMPLATE_KINDS = ("container", "script", "dag", "steps", "resource", "suspend")


class WorkflowValidationError(ValueError):
    """Raised with every problem found, one per line."""


def _check_name(value: str, what: str, errors: List[str], max_len: int = 63):
    if not isinstance(value, str) or not value:
        errors.append(f"{what}: missing or empty name")
        return
    if len(value) > max_len:
        errors.append(f"{what}: name {value!r} exceeds {max_len} chars")
    if not DNS1123.match(value):
        errors.append(f"{what}: name {value!r} is not DNS-1123")


def _check_container(c: Dict[str, Any], where: str, errors: List[str]):
    if not c.get("image"):
        errors.append(f"{where}: container has no image")
    for env in c.get("env") or []:
        name = env.get("name")
        if not name or not ENV_NAME.match(str(name)):
            errors.append(f"{where}: invalid env var name {name!r}")
        if "value" in env and env["value"] is not None and not isinstance(
            env["value"], str
        ):
            errors.append(
                f"{where}: env {name} value must be a string, got "
                f"{type(env['value']).__name__} (quote it in the template)"
            )
    for vm in c.get("volumeMounts") or []:
        if not vm.get("name") or not vm.get("mountPath"):
            errors.append(f"{where}: volumeMount needs name and mountPath")


def _check_template_ref(entry: Dict[str, Any], where: str,
                        template_names: set, errors: List[str]):
    """One task/step must reference a template by name, templateRef, or
    (Argo >= 3.2) an inline definition; a named ref must exist."""
    template_ref = entry.get("templateRef")
    if template_ref is not None and not isinstance(template_ref, dict):
        errors.append(
            f"{where}: templateRef must be a mapping with a name, got "
            f"{template_ref!r}"
        )
        template_ref = None
    ref = (
        entry.get("template")
        or (template_ref or {}).get("name")
        or entry.get("inline")
    )
    if entry.get("template") and entry["template"] not in template_names:
        errors.append(
            f"{where}: references undefined template {entry['template']!r}"
        )
    elif not ref:
        errors.append(f"{where}: no template ref")


def _check_dag(dag: Dict[str, Any], tmpl_name: str, template_names: set,
               errors: List[str]):
    tasks = dag.get("tasks") or []
    task_names = set()
    deps: Dict[str, List[str]] = {}
    for task in tasks:
        t_name = task.get("name")
        _check_name(t_name, f"dag {tmpl_name} task", errors)
        if not isinstance(t_name, str):
            # name error already recorded; an unhashable name would crash
            # the duplicate/dependency bookkeeping below
            continue
        if t_name in task_names:
            errors.append(f"dag {tmpl_name}: duplicate task name {t_name!r}")
        task_names.add(t_name)
        _check_template_ref(
            task, f"dag {tmpl_name} task {t_name}", template_names, errors
        )
        raw = task.get("dependencies") or []
        if isinstance(raw, str):
            raw = raw.split()
        deps[t_name] = list(raw)
    for t_name, dd in deps.items():
        for d in dd:
            if d not in task_names:
                errors.append(
                    f"dag {tmpl_name} task {t_name}: depends on undefined "
                    f"task {d!r}"
                )
    # cycle detection (iterative DFS, 3-color)
    color: Dict[str, int] = {}

    def visit(node: str) -> bool:
        stack = [(node, iter(deps.get(node, ())))]
        color[node] = 1
        while stack:
            cur, it = stack[-1]
            advanced = False
            for nxt in it:
                if color.get(nxt, 0) == 1:
                    return True
                if color.get(nxt, 0) == 0 and nxt in deps:
                    color[nxt] = 1
                    stack.append((nxt, iter(deps.get(nxt, ()))))
                    advanced = True
                    break
            if not advanced:
                color[cur] = 2
                stack.pop()
        return False

    for t_name in deps:
        if color.get(t_name, 0) == 0 and visit(t_name):
            errors.append(f"dag {tmpl_name}: dependency cycle involving {t_name!r}")
            break


def validate_workflow_doc(doc: Dict[str, Any]) -> List[str]:
    """Validate one parsed Workflow document; returns a list of problems."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return ["document is not a mapping"]
    if doc.get("apiVersion") != "argoproj.io/v1alpha1":
        errors.append(f"unexpected apiVersion {doc.get('apiVersion')!r}")
    if doc.get("kind") != "Workflow":
        errors.append(f"unexpected kind {doc.get('kind')!r}")
    meta = doc.get("metadata") or {}
    name = meta.get("name")
    gen_name = meta.get("generateName")
    if name:
        _check_name(name, "metadata", errors)
    elif gen_name:
        _check_name(gen_name.rstrip("-"), "metadata.generateName", errors)
    else:
        errors.append("metadata: needs name or generateName")

    spec = doc.get("spec") or {}
    templates = spec.get("templates") or []
    names: List[str] = []
    for tmpl in templates:
        t_name = tmpl.get("name")
        _check_name(str(t_name), "template", errors)
        names.append(t_name)
        kinds = [k for k in _TEMPLATE_KINDS if tmpl.get(k) is not None]
        if len(kinds) != 1:
            errors.append(
                f"template {t_name}: needs exactly one of {_TEMPLATE_KINDS}, "
                f"has {kinds or 'none'}"
            )
    dupes = {n for n in names if names.count(n) > 1}
    for d in dupes:
        errors.append(f"duplicate template name {d!r}")
    template_names = set(names)

    entrypoint = spec.get("entrypoint")
    if not entrypoint:
        errors.append("spec.entrypoint missing")
    elif entrypoint not in template_names:
        errors.append(f"spec.entrypoint {entrypoint!r} not a defined template")
    on_exit = spec.get("onExit")
    if on_exit and on_exit not in template_names:
        errors.append(f"spec.onExit {on_exit!r} not a defined template")

    spec_volumes = {v.get("name") for v in spec.get("volumes") or []}
    for tmpl in templates:
        t_name = tmpl.get("name")
        for kind in ("container", "script"):
            if tmpl.get(kind):
                _check_container(tmpl[kind], f"template {t_name}", errors)
                local_volumes = {
                    v.get("name") for v in tmpl.get("volumes") or []
                }
                for vm in tmpl[kind].get("volumeMounts") or []:
                    if vm.get("name") not in spec_volumes | local_volumes:
                        errors.append(
                            f"template {t_name}: volumeMount "
                            f"{vm.get('name')!r} has no matching volume"
                        )
        if tmpl.get("dag"):
            _check_dag(tmpl["dag"], t_name, template_names, errors)
        if tmpl.get("steps"):
            # steps templates carry the same template references as dag
            # tasks (a list of parallel-step lists) — an unchecked steps
            # template would ship a workflow Argo rejects despite this
            # gate passing
            step_names: set = set()
            for group in tmpl["steps"]:
                for step in group if isinstance(group, list) else [group]:
                    if not isinstance(step, dict):
                        errors.append(
                            f"steps {t_name}: step entry must be a "
                            f"mapping, got {step!r}"
                        )
                        continue
                    s_name = step.get("name")
                    _check_name(s_name, f"steps {t_name} step", errors)
                    if isinstance(s_name, str):
                        if s_name in step_names:
                            errors.append(
                                f"steps {t_name}: duplicate step name "
                                f"{s_name!r}"
                            )
                        step_names.add(s_name)
                    _check_template_ref(
                        step, f"steps {t_name} step {s_name}",
                        template_names, errors,
                    )
    return errors


def validate_workflow_docs(text: str) -> None:
    """Validate every YAML document in ``text``; raise with all problems."""
    problems: List[str] = []
    docs = [d for d in yaml_subset.load_all(text) if d is not None]
    if not docs:
        raise WorkflowValidationError("no YAML documents found")
    for i, doc in enumerate(docs):
        for problem in validate_workflow_doc(doc):
            problems.append(f"doc[{i}]: {problem}")
    if problems:
        raise WorkflowValidationError(
            f"{len(problems)} problem(s):\n" + "\n".join(problems)
        )
