"""
The runtime's pod-fragment schemas, checked when a machine's config is
loaded: the port's copy of ``gordo_tpu/workflow/schemas.py``, with its
checks, its messages and its deliberate differences from the reference's
pydantic models (``gordo/workflow/config_elements/schemas.py:5-66``):

- unknown keys in the closed schemas (env vars, volume mounts, resources)
  are errors, so a typo'd ``mountPth:`` fails at load instead of passing
  to deploy time;
- a ``Volume`` takes any one volume-source mapping (``hostPath``,
  ``emptyDir``, ...) beside the modelled ``csi``, where the reference
  drops unmodelled sources.

Every :class:`RuntimeConfigError` names the config path of the offence
(``runtime.volumes[0].mountPath``), as the JAX package's does.
``machine/validators.py`` ``ValidMachineRuntime`` calls
:func:`validate_runtime` as the JAX descriptor does.
"""

from typing import Any, Dict, List


class RuntimeConfigError(ValueError):
    """A runtime fragment failed schema validation; message carries the
    config path (e.g. ``runtime.volumes[0].mountPath``)."""


def _expect_mapping(value, path: str) -> Dict[str, Any]:
    if not isinstance(value, dict):
        raise RuntimeConfigError(
            f"{path}: expected a mapping, got {type(value).__name__}"
        )
    return value


def _expect_list(value, path: str) -> List[Any]:
    if not isinstance(value, list):
        raise RuntimeConfigError(
            f"{path}: expected a list, got {type(value).__name__}"
        )
    return value


def _expect_str(value, path: str) -> str:
    if not isinstance(value, str) or not value:
        raise RuntimeConfigError(
            f"{path}: expected a non-empty string, got {value!r}"
        )
    return value


def _check_keys(obj: Dict[str, Any], allowed: Dict[str, bool], path: str) -> None:
    """``allowed``: key -> required. Unknown keys error (typo protection)."""
    unknown = set(obj) - set(allowed)
    if unknown:
        raise RuntimeConfigError(
            f"{path}: unknown key(s) {sorted(unknown)}; allowed: "
            f"{sorted(allowed)}"
        )
    missing = [k for k, required in allowed.items() if required and k not in obj]
    if missing:
        raise RuntimeConfigError(f"{path}: missing required key(s) {missing}")


_QUANTITY_KEYS = {"memory", "cpu"}


def validate_resources(value, path: str) -> Dict[str, Any]:
    """ResourceRequirements: requests/limits of quantity mappings
    (reference schemas.py:5-7; keys beyond memory/cpu — accelerator counts
    such as ``nvidia.com/gpu`` or ``google.com/tpu`` — pass through)."""
    obj = _expect_mapping(value, path)
    _check_keys(obj, {"requests": False, "limits": False}, path)
    for section in ("requests", "limits"):
        if section not in obj or obj[section] is None:
            continue
        entries = _expect_mapping(obj[section], f"{path}.{section}")
        for key, qty in entries.items():
            if not isinstance(qty, (int, float, str)):
                raise RuntimeConfigError(
                    f"{path}.{section}.{key}: expected a quantity "
                    f"(number or string), got {type(qty).__name__}"
                )
    return obj


def validate_env_var(value, path: str) -> Dict[str, Any]:
    """EnvVar with optional valueFrom configMapKeyRef/secretKeyRef
    (reference schemas.py:10-28)."""
    obj = _expect_mapping(value, path)
    _check_keys(obj, {"name": True, "value": False, "valueFrom": False}, path)
    _expect_str(obj["name"], f"{path}.name")
    if "value" in obj and not isinstance(obj["value"], (str, int, float, bool)):
        raise RuntimeConfigError(
            f"{path}.value: expected a scalar, got {type(obj['value']).__name__}"
        )
    if "valueFrom" in obj:
        src = _expect_mapping(obj["valueFrom"], f"{path}.valueFrom")
        _check_keys(
            src,
            {"configMapKeyRef": False, "secretKeyRef": False, "fieldRef": False},
            f"{path}.valueFrom",
        )
        if not src:
            raise RuntimeConfigError(
                f"{path}.valueFrom: needs one of configMapKeyRef/"
                f"secretKeyRef/fieldRef"
            )
        for ref_name, ref in src.items():
            ref_obj = _expect_mapping(ref, f"{path}.valueFrom.{ref_name}")
            for key in ("name", "key", "fieldPath"):
                if key in ref_obj:
                    _expect_str(
                        ref_obj[key], f"{path}.valueFrom.{ref_name}.{key}"
                    )
    return obj


def validate_volume_mount(value, path: str) -> Dict[str, Any]:
    """VolumeMount: name + mountPath (+readOnly/subPath), closed schema
    (reference schemas.py:47-50) — a typo'd key is an error here."""
    obj = _expect_mapping(value, path)
    _check_keys(
        obj,
        {"name": True, "mountPath": True, "readOnly": False, "subPath": False},
        path,
    )
    _expect_str(obj["name"], f"{path}.name")
    _expect_str(obj["mountPath"], f"{path}.mountPath")
    if not str(obj["mountPath"]).startswith("/"):
        raise RuntimeConfigError(
            f"{path}.mountPath: must be an absolute path, got "
            f"{obj['mountPath']!r}"
        )
    if "readOnly" in obj and not isinstance(obj["readOnly"], bool):
        raise RuntimeConfigError(
            f"{path}.readOnly: expected a bool, got "
            f"{type(obj['readOnly']).__name__}"
        )
    return obj


def validate_volume(value, path: str) -> Dict[str, Any]:
    """Volume: a name plus exactly one volume-source mapping. ``csi`` is
    modelled in detail (reference schemas.py:35-44); other k8s sources
    (hostPath, emptyDir, persistentVolumeClaim, …) pass through as opaque
    mappings rather than being silently dropped."""
    obj = _expect_mapping(value, path)
    if "name" not in obj:
        raise RuntimeConfigError(f"{path}: missing required key(s) ['name']")
    _expect_str(obj["name"], f"{path}.name")
    sources = [k for k in obj if k != "name"]
    if len(sources) != 1:
        raise RuntimeConfigError(
            f"{path}: expected exactly one volume source besides 'name', "
            f"got {sorted(sources)}"
        )
    source = sources[0]
    src_obj = _expect_mapping(obj[source], f"{path}.{source}")
    if source == "csi":
        _check_keys(
            src_obj,
            {
                "driver": True,
                "readOnly": False,
                "fsType": False,
                "volumeAttributes": False,
            },
            f"{path}.csi",
        )
        _expect_str(src_obj["driver"], f"{path}.csi.driver")
    return obj


def validate_pod_runtime(
    value, path: str, *, builder: bool = False
) -> Dict[str, Any]:
    """PodRuntime fragment: image/resources/metadata/env/volumeMounts
    (+remote_logging for the builder) — reference schemas.py:53-66."""
    obj = _expect_mapping(value, path)
    allowed = {
        "image": False,
        "resources": False,
        "metadata": False,
        "env": False,
        "volumeMounts": False,
        # knobs our runtime carries beyond the reference pod model
        "max_instances": False,
        "parallelism": False,
    }
    if builder:
        allowed["remote_logging"] = False
    # standard pod-spec keys pass through unvalidated (kept in the runtime
    # dict; whether a template renders them is the template's choice): the
    # reference's pydantic v1 silently IGNORED any unmodelled key, so
    # configs carrying these deployed fine — rejecting them here would
    # break those configs on switch-over, and they are not plausible typos
    # of the modelled keys (the typo protection this schema exists for)
    for passthrough in (
        "nodeSelector", "affinity", "tolerations", "imagePullPolicy",
        "serviceAccountName", "securityContext", "annotations", "labels",
        "priorityClassName",
    ):
        allowed[passthrough] = False
    _check_keys(obj, allowed, path)
    if "image" in obj:
        _expect_str(obj["image"], f"{path}.image")
    if obj.get("resources") is not None:
        validate_resources(obj["resources"], f"{path}.resources")
    if obj.get("env") is not None:
        for i, item in enumerate(_expect_list(obj["env"], f"{path}.env")):
            validate_env_var(item, f"{path}.env[{i}]")
    if obj.get("volumeMounts") is not None:
        mounts = _expect_list(obj["volumeMounts"], f"{path}.volumeMounts")
        for i, item in enumerate(mounts):
            validate_volume_mount(item, f"{path}.volumeMounts[{i}]")
    if builder and obj.get("remote_logging") is not None:
        rl = _expect_mapping(obj["remote_logging"], f"{path}.remote_logging")
        _check_keys(rl, {"enable": False}, f"{path}.remote_logging")
        if "enable" in rl and not isinstance(rl["enable"], bool):
            raise RuntimeConfigError(
                f"{path}.remote_logging.enable: expected a bool"
            )
    return obj


_POD_SECTIONS = ("server", "builder", "client", "prometheus_metrics_server")


def validate_runtime(runtime, path: str = "runtime") -> Dict[str, Any]:
    """Check a machine's or the globals' ``runtime:`` mapping, which is
    returned as it is: malformed env, volume, mount or resource fragments
    fail with the offending path when the machine is made (the reference
    checks at ``normalized_config.py:147-159``), before anything is built or
    rendered."""
    if runtime is None:
        return {}
    obj = _expect_mapping(runtime, path)
    for section in _POD_SECTIONS:
        if obj.get(section) is not None:
            validate_pod_runtime(
                obj[section], f"{path}.{section}", builder=section == "builder"
            )
    if obj.get("volumes") is not None:
        for i, item in enumerate(_expect_list(obj["volumes"], f"{path}.volumes")):
            validate_volume(item, f"{path}.volumes[{i}]")
    if obj.get("env") is not None:
        for i, item in enumerate(_expect_list(obj["env"], f"{path}.env")):
            validate_env_var(item, f"{path}.env[{i}]")
    return obj
