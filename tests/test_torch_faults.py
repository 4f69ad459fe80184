"""
The port's fault vocabulary (``gordo_tpu_torch/util/faults.py``) against
the JAX package's (``gordo_tpu/util/faults.py``): the same exceptions
classify alike, the same plan fires at the same sites and calls, the
policy's backoff and the retry loop agree, and the validation helpers give
the same reports. Exact: both modules are plain Python over the same
inputs.
"""

import json
import os

import numpy as np
import pytest
import torch

from gordo_tpu.util import faults as jax_faults
from gordo_tpu_torch.models.utils import Frame
from gordo_tpu_torch.util import faults


@pytest.fixture(autouse=True)
def _no_plan(monkeypatch):
    monkeypatch.delenv(faults.PLAN_ENV, raising=False)
    monkeypatch.delenv("GORDO_TPU_PROCESS_ID", raising=False)
    faults.reset_plan()
    jax_faults.reset_plan()
    yield
    faults.reset_plan()
    jax_faults.reset_plan()


class ReadTimeout(Exception):
    """A requests-style type, recognised by its name."""


def _cases(module):
    """One instance of each exception class that the two modules classify,
    built from ``module``'s own fault types where it has them."""
    return [
        module.TransientFault("x"), module.PermanentFault("x"),
        module.InjectedOOM("RESOURCE_EXHAUSTED: injected"), module.NonFiniteDataError("x"),
        module.DivergedModelError("x"), TimeoutError("x"), ConnectionError("x"), OSError("x"),
        ValueError("x"), KeyError("x"), MemoryError(), ReadTimeout("x"),
        RuntimeError("RESOURCE_EXHAUSTED: out of memory on device"),
        RuntimeError("Allocator ran OOM trying to allocate 2GiB"),
        RuntimeError("shape mismatch"),
    ]


def test_the_same_exceptions_classify_alike():
    ours, theirs = _cases(faults), _cases(jax_faults)
    assert [faults.is_transient(e) for e in ours] == [jax_faults.is_transient(e) for e in theirs]
    assert [faults.is_oom(e) for e in ours] == [jax_faults.is_oom(e) for e in theirs]
    assert ([faults.FaultPolicy().classify(e) for e in ours]
            == [jax_faults.FaultPolicy().classify(e) for e in theirs])
    assert faults.KNOWN_SITES == jax_faults.KNOWN_SITES
    assert (faults.EXIT_ALL_BUILT, faults.EXIT_PARTIAL, faults.EXIT_NONE_BUILT) == (
        jax_faults.EXIT_ALL_BUILT, jax_faults.EXIT_PARTIAL, jax_faults.EXIT_NONE_BUILT)


def test_a_cuda_out_of_memory_is_an_oom():
    """The card's allocation failure is recognised by type, whatever its
    message."""
    assert faults.is_oom(torch.OutOfMemoryError("CUDA error: allocation failed"))
    assert not faults.is_transient(torch.OutOfMemoryError("x"))


PLAN = {"rules": [
    {"site": "serve_predict", "machine": "m-1", "times": 2, "error": "transient"},
    {"site": "serve_model_load", "machine": "m-2", "times": -1, "error": "permanent"},
    {"site": "serve_device_call", "machine": "m-3", "after": 2, "times": 1,
     "error": "resource_exhausted"},
    {"site": "serve_poison_nan", "machine": "m-4"},
    {"site": "diverge", "machine": "m-5", "times": 2},
    {"site": "serve_encode", "machine": "m-6", "error": "wedge", "seconds": 0.0},
]}
CALLS = ([("fire", "serve_predict", "m-1", ())] * 4
         + [("fire", "serve_model_load", "m-2", ())] * 3
         + [("fire", "serve_device_call", None, ("m-1", "m-3"))] * 4
         + [("fire", "serve_device_call", None, ("m-1",))]
         + [("should", "serve_poison_nan", "m-4", ())] * 3
         + [("should", "diverge", "m-5", ())] * 3
         + [("fire", "serve_encode", "m-6", ())] * 2
         + [("fire", "serve_predict", "m-9", ()), ("fire", "data_fetch", "m-1", ())])


def _script(module, raw: str) -> list:
    """What each call of CALLS did under the plan: the error's class name
    and message, True/False for a boolean site, None for nothing."""
    plan = module.FaultPlan.parse(raw)
    out = []
    for kind, site, machine, machines in CALLS:
        if kind == "should":
            out.append(plan.should_fire(site, machine))
            continue
        try:
            plan.fire(site, machine=machine, machines=machines)
            out.append(None)
        except Exception as exc:  # noqa: BLE001 -- recorded
            out.append((type(exc).__name__, str(exc)))
    return out


@pytest.mark.parametrize("source", ["json", "file", "env"])
def test_the_same_plan_fires_at_the_same_sites_and_calls(tmp_path, monkeypatch, source):
    raw = json.dumps(PLAN)
    if source == "file":
        path = tmp_path / "plan.json"
        path.write_text(raw)
        raw = f"@{path}"
    if source == "env":
        monkeypatch.setenv(faults.PLAN_ENV, raw)
        ours, theirs = [], []
        for module, out in ((faults, ours), (jax_faults, theirs)):
            for kind, site, machine, machines in CALLS:
                if kind == "should":
                    out.append(module.should_fire(site, machine))
                    continue
                try:
                    module.fault_point(site, machine=machine, machines=machines)
                    out.append(None)
                except Exception as exc:  # noqa: BLE001 -- recorded
                    out.append((type(exc).__name__, str(exc)))
    else:
        ours, theirs = _script(faults, raw), _script(jax_faults, raw)
    assert ours == theirs
    blip = ("TransientFault", "injected transient fault at serve_predict for m-1")
    assert ours[:4] == [blip, blip, None, None]
    assert ours[7:11] == [None, None, ("InjectedOOM", "RESOURCE_EXHAUSTED: injected "
                                       "resource_exhausted fault at serve_device_call for m-3"),
                          None]


def test_maybe_poison_poisons_the_first_column_alike(monkeypatch):
    monkeypatch.setenv(faults.PLAN_ENV, json.dumps(
        {"rules": [{"site": "serve_poison_nan", "machine": "m", "times": 1}]}))
    X = np.arange(12, dtype=np.float64).reshape(4, 3)
    ours = faults.maybe_poison("m", X, site="serve_poison_nan")
    theirs = jax_faults.maybe_poison("m", X, site="serve_poison_nan")
    np.testing.assert_array_equal(ours, theirs)
    assert np.isnan(ours[:, 0]).all() and not np.isnan(X).any()
    # the budget (times 1) is spent in both
    assert faults.maybe_poison("m", X, site="serve_poison_nan") is X
    assert jax_faults.maybe_poison("m", X, site="serve_poison_nan") is X


def test_maybe_poison_takes_the_ports_request_frame(monkeypatch):
    monkeypatch.setenv(faults.PLAN_ENV, json.dumps(
        {"rules": [{"site": "serve_poison_nan", "machine": "m"}]}))
    frame = Frame(np.ones((3, 2)), ["a", "b"], [0, 1, 2])
    poisoned = faults.maybe_poison("m", frame, site="serve_poison_nan")
    assert isinstance(poisoned, Frame)
    assert poisoned.columns == ["a", "b"] and list(poisoned.index) == [0, 1, 2]
    assert np.isnan(poisoned.values[:, 0]).all() and np.isfinite(frame.values).all()
    assert faults.maybe_poison("other", frame, site="serve_poison_nan") is frame


@pytest.mark.parametrize("X, y", [
    (np.ones((4, 2)), None),
    (np.array([[1.0, np.nan], [np.inf, 2.0]]), None),
    (np.ones((3, 2)), np.array([[np.nan], [1.0], [2.0]])),
    (np.arange(6).reshape(3, 2), None),
])
def test_non_finite_report_agrees(X, y):
    assert faults.non_finite_report(X, y) == jax_faults.non_finite_report(X, y)


def test_params_non_finite_agrees_over_the_ports_parameters():
    good = [{"kernel": np.ones((2, 2), np.float32), "bias": np.zeros(2, np.float32)}]
    bad = [{"kernel": np.ones((2, 2), np.float32)}, {"bias": np.array([np.nan], np.float32)}]
    for params in (good, bad):
        assert faults.params_non_finite(params) == jax_faults.params_non_finite(params)
        as_tensors = [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in params]
        assert faults.params_non_finite(as_tensors) == jax_faults.params_non_finite(params)
    losses = [1.0, np.nan]
    assert (faults.params_non_finite(good, losses=losses)
            == jax_faults.params_non_finite(good, losses=losses) == "non-finite training loss")


def test_policy_backoff_and_retry_call_agree(monkeypatch):
    for name, value in (("MAX_ATTEMPTS", "4"), ("BACKOFF_BASE", "0.25"), ("JITTER", "0.3")):
        monkeypatch.setenv(f"GORDO_TPU_FAULT_{name}", value)
    ours, theirs = faults.FaultPolicy.from_env(), jax_faults.FaultPolicy.from_env()
    assert ours.__dict__ == theirs.__dict__
    assert ([ours.backoff(a, "m-7") for a in range(1, 8)]
            == [theirs.backoff(a, "m-7") for a in range(1, 8)])

    def run(module, policy):
        slept, calls = [], {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise module.TransientFault("blip")
            return "ok"

        return module.retry_call(flaky, policy, key="m-7", sleep=slept.append), slept

    assert run(faults, ours) == run(jax_faults, theirs) == (("ok", 3), [
        ours.backoff(1, "m-7"), ours.backoff(2, "m-7")])


def test_quarantine_record_attribution(monkeypatch):
    monkeypatch.setenv("GORDO_TPU_HOST_ID", "host-a")
    record = faults.QuarantineRecord("m", faults.STAGE_TRAINING, "diverged", attempts=2)
    theirs = jax_faults.QuarantineRecord("m", jax_faults.STAGE_TRAINING, "diverged", attempts=2)
    assert record.to_dict() == theirs.to_dict()
    assert record.to_dict()["host"] == "host-a" and record.process_index == 0
    monkeypatch.setenv("GORDO_TPU_PROCESS_ID", "3")
    assert faults.QuarantineRecord("m", "s", "r").process_index == 3


def test_process_index_reads_an_initialised_process_group(tmp_path):
    """Without the multi-host flag, the rank of the initialised
    ``torch.distributed`` group (gloo, one process)."""
    import torch.distributed as dist

    if dist.is_initialized():  # an earlier test's group: read its rank
        assert faults.QuarantineRecord("m", "s", "r").process_index == dist.get_rank()
        return
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        assert faults.QuarantineRecord("m", "s", "r").process_index == 0
    finally:
        dist.destroy_process_group()


def test_builder_error_is_the_fault_vocabularys():
    from gordo_tpu_torch.builder import build_model
    from gordo_tpu_torch.parallel import batch_trainer

    assert build_model.NonFiniteDataError is faults.NonFiniteDataError
    assert batch_trainer.NonFiniteDataError is faults.NonFiniteDataError
    assert build_model.non_finite_report is faults.non_finite_report
    assert os.path.basename(faults.__file__) == "faults.py"
