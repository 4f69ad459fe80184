"""
The workflow generator: a project config rendered into Argo Workflow
documents for NVIDIA GPUs. The port's counterpart of
``gordo_tpu/workflow/workflow_generator.py`` (template loading, image pull
policy, docker tags, owner references, machine chunks) and of
``generate_workflow_docs`` in ``gordo_tpu/cli/workflow_generator.py``, with
every check in the same words, rendered through the Jinja subset
(util/templates.py, with ``StrictUndefined``, ``trim_blocks`` and
``lstrip_blocks`` as the JAX environment has them) from
``resources/gpu-workflow.yml.template``.

The TPU options map onto the card: ``machines_per_tpu_worker`` is
``machines_per_gpu_worker`` (default 256, the same chunks);
``tpu_accelerator_type`` and ``tpu_topology`` are ``gpu_product``
(``NVIDIA-H100-80GB-HBM3``, the node selector ``nvidia.com/gpu.product``);
a builder or server pod takes one card, so ``tpu_chips_per_worker`` has no
counterpart, and multi-worker chunks (``tpu_workers_per_slice``) are the
parallel axes item's (A7). Every other option keeps its name and default.
"""

import hashlib
import json
import logging
import os
from datetime import datetime, timezone
from typing import Any, Dict, Iterable, List, Optional

from .. import __version__
from ..util import templates, yaml_subset
from ..util.yaml_subset import TimestampNotTZAware  # noqa: F401 -- the JAX module's name
from .normalized_config import NormalizedConfig

logger = logging.getLogger(__name__)

_TEMPLATE_DIR = os.path.join(os.path.dirname(__file__), "resources")
DEFAULT_TEMPLATE = "gpu-workflow.yml.template"
DEFAULT_GPU_PRODUCT = "NVIDIA-H100-80GB-HBM3"

# a config as the JAX generator reads it: tz-aware timestamps, a Gordo CRD's
# spec.config
get_dict_from_yaml = yaml_subset.load_config


class WorkflowGeneratorError(Exception):
    """A refused option or config: the JAX generator's ``ClickException``,
    its message the same (the CLI prints ``Error: <message>``, exit 1)."""


class WorkflowTemplate:
    """A workflow template rendered as the JAX generator's ``jinja2``
    environment renders it."""

    def __init__(self, text: str):
        self.text = text

    def render(self, **context) -> str:
        return templates.render(self.text, context, trim_blocks=True, lstrip_blocks=True)


def load_workflow_template(template_path: Optional[str] = None) -> WorkflowTemplate:
    """The template at ``template_path`` (the card's by default)."""
    if template_path is None:
        template_path = os.path.join(_TEMPLATE_DIR, DEFAULT_TEMPLATE)
    with open(template_path) as fh:
        return WorkflowTemplate(fh.read())


def default_image_pull_policy(tag: str) -> str:
    """'Always' for mutable tags (latest/stable/pr-*), else 'IfNotPresent'."""
    if tag in ("latest", "stable") or tag.startswith("pr-"):
        return "Always"
    return "IfNotPresent"


_DOCKER_TAG_ALLOWED = set(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-"
)


def sanitize_docker_tag(tag: str, max_len: int = 128) -> str:
    """Replace characters docker tags disallow and clamp the length."""
    cleaned = "".join(c if c in _DOCKER_TAG_ALLOWED else "-" for c in tag)
    return cleaned.lstrip(".-")[:max_len] or "latest"


def validate_generate_owner_ref(owner_ref: Any) -> List[dict]:
    """Validate a list of k8s ownerReferences: each must carry the four
    required keys."""
    if not isinstance(owner_ref, list) or not owner_ref:
        raise TypeError("owner-references must be a non-empty list")
    required = {"uid", "name", "kind", "apiVersion"}
    for ref in owner_ref:
        if not isinstance(ref, dict) or not required.issubset(ref):
            raise TypeError(
                f"owner-reference {ref!r} missing keys "
                f"{sorted(required - set(ref or {}))}"
            )
    return owner_ref


def chunk_machines(machines: Iterable[Any], chunk_size: int) -> List[List[Any]]:
    """Split machines into batched-builder chunks of at most ``chunk_size``."""
    if chunk_size < 1:
        raise ValueError("chunk_size must be >= 1")
    out: List[List[Any]] = []
    bucket: List[Any] = []
    for machine in machines:
        bucket.append(machine)
        if len(bucket) == chunk_size:
            out.append(bucket)
            bucket = []
    if bucket:
        out.append(bucket)
    return out


def utc_now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


def _bounded_k8s_name(base: str, limit: int = 63) -> str:
    """Truncate a k8s name/label value to the 63-char cap, keeping it
    unique via a short hash of the full string."""
    if len(base) <= limit:
        return base
    digest = hashlib.sha1(base.encode()).hexdigest()[:8]
    return base[: limit - 9].rstrip("-") + "-" + digest


def _parse_custom_envs(raw: str) -> List[dict]:
    if not raw:
        return []
    try:
        envs = json.loads(raw)
    except json.JSONDecodeError as exc:
        raise WorkflowGeneratorError(
            f"--custom-model-builder-envs is not valid JSON: {exc}"
        )
    if not isinstance(envs, list):
        raise WorkflowGeneratorError(
            "--custom-model-builder-envs must be a JSON list"
        )
    for env in envs:
        if not isinstance(env, dict) or "name" not in env:
            raise WorkflowGeneratorError(f"invalid EnvVar entry: {env!r}")
        if "value" not in env and "valueFrom" not in env:
            raise WorkflowGeneratorError(
                f"EnvVar entry {env['name']!r} needs 'value' or 'valueFrom'"
            )
        if (
            "value" in env
            and env["value"] is not None  # explicit null = unset (k8s, and
            # the render-time validator, both allow it)
            and not isinstance(env["value"], str)
        ):
            # fail at the flag with the actionable message — the render-time
            # validator's generic error points the user at the template,
            # not at their CLI input
            raise WorkflowGeneratorError(
                f"EnvVar {env['name']!r} value must be a JSON string, got "
                f"{type(env['value']).__name__} (quote it)"
            )
    return envs


def _check_client_dates(client_start_date: str, client_end_date: str) -> None:
    if not (client_start_date and client_end_date):
        # the rendered client tasks run `predict <start> <end>`; empty dates
        # would make every client task fail its date parse, Argo retry each
        # 5x, and the whole client layer of the DAG fail — on any default
        # invocation. Fail HERE with the actionable knob.
        raise WorkflowGeneratorError(
            "--client-start-date and --client-end-date are required when "
            "clients are enabled (use --disable-clients to generate a "
            "workflow without prediction clients)"
        )
    for knob, value in (
        ("--client-start-date", client_start_date),
        ("--client-end-date", client_end_date),
    ):
        try:
            parsed = datetime.fromisoformat(value.replace("Z", "+00:00"))
        except ValueError:
            raise WorkflowGeneratorError(
                f"{knob} {value!r} is not an ISO-8601 timestamp"
            )
        if parsed.tzinfo is None:
            raise WorkflowGeneratorError(
                f"{knob} {value!r} needs a timezone (e.g. trailing Z)"
            )


def generate_workflow_docs(
    machine_config: str,
    project_name: str,
    project_revision: str = "1",
    workflow_template: Optional[str] = None,
    docker_registry: str = "ghcr.io/gordo-tpu",
    docker_image: str = "gordo-tpu",
    gordo_version: str = __version__,
    image_pull_policy: str = "",
    retries: int = 5,
    machines_per_gpu_worker: int = 256,
    gpu_product: str = DEFAULT_GPU_PRODUCT,
    server_replicas: int = 2,
    server_workers: int = 2,
    ml_server_hpa_type: str = "cpu",
    ml_server_max_replicas: Optional[int] = None,
    ml_server_min_replicas: Optional[int] = None,
    ml_server_hpa_cpu_target: int = 50,
    prometheus_server_address: str = "http://prometheus:9090",
    keda_threshold: str = "10",
    resource_labels: tuple = (),
    custom_model_builder_envs: str = "",
    owner_references: Optional[str] = None,
    storage_claim_name: str = "gordo-storage",
    service_account: str = "gordo-tpu",
    deadline_seconds: int = 86400,
    enable_clients: bool = True,
    client_start_date: str = "",
    client_end_date: str = "",
    split_workflows: int = 30,
    exceptions_report_level: str = "MESSAGE",
    postgres_host: Optional[str] = None,
    enable_postgres: bool = True,
    enable_influx: bool = True,
    enable_grafana: bool = True,
    spot_tolerations: bool = True,
    output_file: Optional[str] = None,
) -> str:
    """Render one or more Workflow documents (joined by '---') as a string;
    raises :class:`WorkflowGeneratorError` where the JAX generator raises
    its ``ClickException``."""
    if not str(project_revision).isdigit():
        raise WorkflowGeneratorError(
            f"--project-revision must be numeric, got {project_revision!r} "
            "(it is ordered numerically by the single-workflow guard)"
        )
    if enable_clients:
        _check_client_dates(client_start_date, client_end_date)
    config = get_dict_from_yaml(machine_config)
    norm = NormalizedConfig(config, project_name=project_name)

    # postgres sink: an external host wins; otherwise the in-cluster
    # per-project StatefulSet (enable_postgres) provides it
    enable_postgres_deploy = enable_postgres and not postgres_host
    effective_postgres_host = postgres_host or (
        f"gordo-postgres-{project_name}" if enable_postgres else None
    )
    # influx side-deployment: CLI gate ANDed with the config's
    # globals.runtime.influx.enable (reference behavior)
    influx_cfg_enabled = bool(
        (norm.globals.get("runtime", {}).get("influx") or {}).get("enable", True)
    )
    enable_influx = enable_influx and influx_cfg_enabled

    if effective_postgres_host:
        for machine in norm.machines:
            reporters = machine.runtime.setdefault("reporters", [])
            reporters.append(
                {
                    "gordo_tpu.reporters.postgres.PostgresReporter": {
                        "host": effective_postgres_host
                    }
                }
            )

    tag = sanitize_docker_tag(str(gordo_version))
    image = f"{docker_registry}/{docker_image}:{tag}"
    pull_policy = image_pull_policy or default_image_pull_policy(tag)

    owner_refs = None
    if owner_references:
        owner_refs = validate_generate_owner_ref(yaml_subset.load(owner_references))

    template = load_workflow_template(workflow_template)

    # split the full machine list into per-Workflow groups, then bucket each
    # group into batched builder chunks, one card each
    if split_workflows and split_workflows > 0:
        workflow_groups = chunk_machines(norm.machines, split_workflows)
    else:
        workflow_groups = [list(norm.machines)]

    # the server HPA is ONE shared per-project resource: its default
    # ceiling scales with the project's machine count, never a
    # split-workflow group's (whichever doc applied last would set it)
    max_replicas = (
        ml_server_max_replicas
        if ml_server_max_replicas is not None
        else 10 * len(norm.machines)
    )

    docs: List[str] = []
    for group_idx, group in enumerate(workflow_groups):
        chunks = chunk_machines(group, machines_per_gpu_worker)
        builder_chunks = []
        machine_ctx: List[Dict[str, Any]] = []
        for chunk_idx, chunk in enumerate(chunks):
            chunk_id = f"g{group_idx}c{chunk_idx}"
            builder_chunks.append(
                {
                    "id": chunk_id,
                    "machine_names": [m.name for m in chunk],
                    "n_machines": len(chunk),
                    # revision-scoped + 63-char-bounded, as the JAX chunks'
                    # (the multi-worker chunks' coordinator, A7, names by it)
                    "label": _bounded_k8s_name(
                        f"{project_name}-r{project_revision}-{chunk_id}"
                    ),
                }
            )
            for m in chunk:
                machine_ctx.append(
                    {
                        "name": m.name,
                        "chunk_task": f"gpu-batch-builder-{chunk_id}",
                    }
                )
        # the full group config is staged onto shared storage by the
        # stage-config task; chunk tasks only carry machine names
        group_config = {"machines": [m.to_dict() for m in group]}
        staged_config_path = (
            f"/gordo/config/{project_name}/{project_revision}/"
            f"group-{group_idx}.yaml"
        )
        expected_models_path = (
            f"/gordo/config/{project_name}/{project_revision}/"
            f"expected-models.json"
        )

        context = {
            "project_name": project_name,
            # the whole PROJECT's machine list (not this split-workflow
            # group's): the server's EXPECTED_MODELS/readiness gate must be
            # identical in every doc
            "all_machine_names": [m.name for m in norm.machines],
            "project_revision": project_revision,
            "project_version": __version__,
            "labels": dict(resource_labels),
            "owner_references": owner_refs,
            "image": image,
            "image_pull_policy": pull_policy,
            "builder_retries": retries,
            "builder_chunks": builder_chunks,
            "group_config": group_config,
            "staged_config_path": staged_config_path,
            "expected_models_path": expected_models_path,
            "machines": machine_ctx,
            "enable_clients": enable_clients,
            "enable_influx": enable_influx,
            "enable_postgres_deploy": enable_postgres_deploy,
            "enable_grafana": enable_grafana,
            "client_start_date": client_start_date,
            "client_end_date": client_end_date,
            "client_max_instances": norm.globals["runtime"]["client"][
                "max_instances"
            ],
            "gpu": {"product": gpu_product},
            "builder_resources": norm.globals["runtime"]["builder"][
                "resources"
            ],
            "server_resources": norm.globals["runtime"]["server"]["resources"],
            "client_resources": norm.globals["runtime"]["client"]["resources"],
            "server_replicas": server_replicas,
            "server_workers": server_workers,
            "ml_server_hpa": {
                "type": ml_server_hpa_type,
                # --server-replicas feeds the floor (the Deployment pins
                # no replica count; the autoscaler owns scaling)
                "min_replicas": (
                    ml_server_min_replicas
                    if ml_server_min_replicas is not None
                    else server_replicas
                ),
                "max_replicas": max_replicas,
                "cpu_target": ml_server_hpa_cpu_target,
                "cooldown": 300,
                "prometheus_server_address": prometheus_server_address,
                "keda_query": (
                    "sum(rate(gordo_server_requests_total{project="
                    f'"{project_name}"'
                    "}[1m]))"
                ),
                "keda_threshold": keda_threshold,
            },
            "storage_claim_name": storage_claim_name,
            "service_account": service_account,
            "deadline_seconds": deadline_seconds,
            "exceptions_report_level": exceptions_report_level,
            "custom_builder_envs": _parse_custom_envs(
                custom_model_builder_envs
            ),
            "spot_tolerations": spot_tolerations,
        }
        docs.append(template.render(**context))

    return "\n---\n".join(docs) + "\n"
