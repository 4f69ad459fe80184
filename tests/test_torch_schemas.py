"""
The runtime's pod-fragment schemas (``gordo_tpu_torch/workflow/schemas.py``,
called from ``machine/validators.py``) against the JAX package's: every case
of ``tests/gordo_tpu/test_schemas.py`` through both packages, and a grid of
env, volume, mount and resource fragments (valid, a typo'd key, a wrong
type, a missing name) accepted or refused alike, with the same config path
in the same message.
"""

import copy
import importlib.util
import itertools
import os

import pytest

from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.workflow import schemas as jax_schemas
from gordo_tpu.workflow.normalized_config import NormalizedConfig as JaxNormalizedConfig
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.workflow import schemas
from gordo_tpu_torch.workflow.normalized_config import NormalizedConfig

HERE = os.path.dirname(os.path.abspath(__file__))


def _jax_cases():
    spec = importlib.util.spec_from_file_location(
        "jax_schema_cases", os.path.join(HERE, "gordo_tpu", "test_schemas.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX = _jax_cases()
MALFORMED = JAX.test_malformed_runtime_fails_config_load.pytestmark[0].args[1]


def _outcome(check):
    """("ok", result) or ("refused", message)."""
    try:
        return ("ok", check())
    except ValueError as exc:
        return ("refused", str(exc))


def _both_configs(config: dict):
    ours = _outcome(lambda: [m.runtime for m in NormalizedConfig(
        copy.deepcopy(config), project_name="p").machines])
    theirs = _outcome(lambda: [m.runtime for m in JaxNormalizedConfig(
        copy.deepcopy(config), project_name="p").machines])
    return ours, theirs


def test_the_jax_valid_fragments_load_alike():
    runtime = """
    builder:
      resources:
        requests: {memory: 1000, cpu: 500}
        limits: {memory: 2000}
      env:
        - name: PLAIN
          value: "1"
        - name: FROM_SECRET
          valueFrom:
            secretKeyRef: {name: creds, key: token}
      volumeMounts:
        - name: data
          mountPath: /gordo/data
          readOnly: true
    volumes:
      - name: data
        csi: {driver: secrets-store.csi.k8s.io}
      - name: scratch
        emptyDir: {}
"""
    ours, theirs = _both_configs(JAX._config(runtime))
    assert ours == theirs and ours[0] == "ok"
    assert ours[1][0]["builder"]["env"][0]["name"] == "PLAIN"
    assert ours[1][0]["volumes"][1]["emptyDir"] == {}


@pytest.mark.parametrize("runtime_yaml, match", MALFORMED)
def test_each_jax_malformed_case_fails_alike(runtime_yaml, match):
    ours, theirs = _both_configs(JAX._config(runtime_yaml))
    assert ours[0] == "refused" and match in ours[1]
    assert ours == theirs


def test_a_machine_level_runtime_is_checked_too():
    config = JAX._config("    influx: {enable: true}")
    config["machines"][0]["runtime"] = {
        "builder": {"volumeMounts": [{"name": "v", "mountPth": "/x"}]}}
    ours, theirs = _both_configs(config)
    assert ours == theirs and "runtime.builder.volumeMounts[0]: unknown key" in ours[1]


def test_none_and_empty_runtimes_pass():
    for runtime in (None, {}):
        assert schemas.validate_runtime(runtime) == jax_schemas.validate_runtime(runtime) == {}


@pytest.mark.parametrize("runtime", [
    {"builder": {"resources": {"limits": {"google.com/tpu": 8}}}},
    {"builder": {"resources": {"limits": {"nvidia.com/gpu": 1}}}},
    {"builder": {"nodeSelector": {"cloud.google.com/gke-tpu-topology": "2x2"},
                 "tolerations": [{"key": "tpu", "operator": "Exists"}],
                 "imagePullPolicy": "Always", "affinity": {"nodeAffinity": {}}},
     "server": {"serviceAccountName": "gordo-server"}},
    {"builder": {"nodeSelectr": {"a": "b"}}},
])
def test_accelerator_quantities_and_pod_keys_as_in_jax(runtime):
    ours = _outcome(lambda: schemas.validate_runtime(copy.deepcopy(runtime)))
    theirs = _outcome(lambda: jax_schemas.validate_runtime(copy.deepcopy(runtime)))
    assert ours == theirs


# -- a generated grid: each fragment valid and mutated, at each place it goes
FRAGMENTS = {
    "env": {"name": "KNOB", "value": "1"},
    "env_from": {"name": "SECRET", "valueFrom": {"secretKeyRef": {"name": "s", "key": "k"}}},
    "volume_csi": {"name": "data", "csi": {"driver": "d", "readOnly": True}},
    "volume_other": {"name": "scratch", "emptyDir": {}},
    "mount": {"name": "data", "mountPath": "/data", "readOnly": False},
    "resources": {"requests": {"memory": 1000, "cpu": 100}, "limits": {"memory": 2000}},
}
PLACES = {
    "env": [("env",), ("builder", "env"), ("server", "env")],
    "env_from": [("env",), ("client", "env")],
    "volume_csi": [("volumes",)],
    "volume_other": [("volumes",)],
    "mount": [("builder", "volumeMounts"), ("server", "volumeMounts")],
    "resources": [("builder", "resources"), ("prometheus_metrics_server", "resources")],
}


def _mutated(kind: str, fragment: dict, mutation: str):
    out = copy.deepcopy(fragment)
    key = next(iter(k for k in out if k != "name"), "name")
    if mutation == "typo" and kind == "volume_csi":
        out["csi"]["drivr"] = out["csi"].pop("driver")
    elif mutation == "typo" and kind == "volume_other":
        # any one source passes (a deliberate difference): typo the name
        out["nmae"] = out.pop("name")
    elif mutation == "typo":
        out[key[:-1] + key[-1:] * 2 if key != "name" else "nmae"] = out.pop(key)
    elif mutation == "wrong_type":
        if kind == "resources":
            out["requests"] = ["memory", 1000]
        elif kind == "mount":
            out["readOnly"] = "yes"
        else:
            out["name"] = 5
    elif mutation == "missing_name":
        out.pop("name", None)
        if kind == "resources":
            out["limits"] = {"cpu": {"oops": 1}}
    return out


GRID = [(kind, place, mutation) for kind, mutation in itertools.product(
    FRAGMENTS, ("valid", "typo", "wrong_type", "missing_name")) for place in PLACES[kind]]


def _runtime(kind: str, place: tuple, fragment):
    value = fragment if kind == "resources" else [fragment]
    runtime: dict = {}
    node = runtime
    for step in place[:-1]:
        node = node.setdefault(step, {})
    node[place[-1]] = value
    return runtime


@pytest.mark.parametrize("kind, place, mutation", GRID,
                         ids=["-".join((k, ".".join(p), m)) for k, p, m in GRID])
def test_the_grid_is_accepted_or_refused_alike_with_the_same_path(kind, place, mutation):
    runtime = _runtime(kind, place, _mutated(kind, FRAGMENTS[kind], mutation))
    ours = _outcome(lambda: schemas.validate_runtime(copy.deepcopy(runtime)))
    theirs = _outcome(lambda: jax_schemas.validate_runtime(copy.deepcopy(runtime)))
    assert ours == theirs
    assert (ours[0] == "ok") == (mutation == "valid"), ours
    if mutation != "valid":
        assert ours[1].startswith("runtime." + ".".join(place)), ours[1]
    # and where a machine is made: the descriptor checks it, as JAX's does
    config = {"name": "m", "model": {"gordo_tpu.models.models.AutoEncoder": {
        "kind": "feedforward_hourglass"}}, "runtime": copy.deepcopy(runtime),
        "dataset": {"type": "RandomDataset", "tags": ["a", "b"],
                    "train_start_date": "2019-01-01T00:00:00+00:00",
                    "train_end_date": "2019-01-02T00:00:00+00:00"}}
    made = _outcome(lambda: Machine.from_config(copy.deepcopy(config), "p").runtime)
    jax_made = _outcome(lambda: JaxMachine.from_config(copy.deepcopy(config), "p").runtime)
    assert made == jax_made
