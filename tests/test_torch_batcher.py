"""
The port's cross-model batcher (gordo_tpu_torch/server/batcher.py) on the
CPU, with small Transformer specs (lookback 32, d_model 32, 2 heads) whose
parameters come from the JAX side through ``serializer/from_jax.py``:

- fused answers against the JAX ``CrossModelBatcher`` (forced on) and the
  port's direct predict, float32 and bf16;
- the parameter bank (capacity buckets, LRU eviction in place, replace, the
  hot swap's ``swap_params`` and a rider whose slot a swap replaced before
  its launch, which takes the retry ladder),
  the window cap, the bisection ladder and serial rescue, abandoned items,
  the pipeline switch, the auto mode's A/B, and the dispatcher's re-entry
  guard;
- through the port's server: concurrent anomaly and base requests over 3
  models against the JAX ``build_app`` with batching on, and concurrent
  requests to one model (no per-model lock);
- ``run-server --batch-predicts/--no-batch-predicts``.
"""

import dataclasses
import json
import os
import pickle
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

import jax
import numpy as np
import pytest
import torch

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder.local_build import local_build
from gordo_tpu.models.factories import transformer_model as jax_transformer_model
from gordo_tpu.ops import nn as jax_nn
from gordo_tpu.server import batcher as jax_batcher
from gordo_tpu.server.server import build_app
from gordo_tpu_torch import cli, serializer
from gordo_tpu_torch.models.models import TransformerAutoEncoder
from gordo_tpu_torch.ops.predict import pad_for_predict
from gordo_tpu_torch.serializer.from_jax import (
    detector_from_arrays,
    params_from_numpy,
    spec_from_dataclass,
)
from gordo_tpu_torch.server import batcher
from gordo_tpu_torch.server.server import make_server

# float32: the frameworks, and a fused lane against a single predict, sum in
# other orders; bf16: the JAX package's own bf16 tolerance
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
SMALL = dict(lookback_window=32, d_model=32, num_heads=2, ff_dim=64, num_blocks=2)


def _jax_spec(compute_dtype="float32"):
    spec = jax_transformer_model(n_features=4, n_features_out=4, **SMALL)
    return dataclasses.replace(spec, compute_dtype=compute_dtype)


def _models(n, compute_dtype="float32"):
    """``n`` (JAX spec, JAX params, port estimator) triples of one spec, each
    its own seeded weights, the port's loaded from the JAX arrays."""
    spec = _jax_spec(compute_dtype)
    port_spec = spec_from_dataclass(spec)
    out = []
    for seed in range(n):
        params = [{k: np.asarray(v) for k, v in p.items()}
                  for p in jax_nn.init_model_params(jax.random.PRNGKey(seed), spec)]
        est = TransformerAutoEncoder(kind="transformer_model", **SMALL).load_params(
            port_spec, params_from_numpy(port_spec, params), "cpu")
        out.append((spec, params, est))
    return out


@pytest.fixture(scope="module")
def models():
    return _models(4)


@pytest.fixture(autouse=True)
def _no_process_batcher(monkeypatch):
    """Every test starts and ends without the process batcher."""
    for knob in ("GORDO_TPU_SERVING_BATCH", "GORDO_TPU_DEVICE_PIPELINE",
                 "GORDO_TPU_BATCH_WINDOW_MS", "GORDO_TPU_PARAM_BANK_MAX"):
        monkeypatch.delenv(knob, raising=False)
    batcher.reset_batcher()
    yield
    batcher.reset_batcher()


def _X(seed, rows=60):
    return np.random.RandomState(seed).rand(rows, 4).astype(np.float32)


def _concurrently(fn, n):
    results, errors = [None] * n, []

    def run(i):
        try:
            results[i] = fn(i)
        except Exception as exc:  # noqa: BLE001 -- asserted below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


def _queued(fused, pairs):
    """Queue ``(estimator, X)`` pairs before the dispatcher starts, so that
    its first drain takes them in order; the results."""
    items = []
    for est, X in pairs:
        X_pad, n_pad, n_keep = pad_for_predict(est.spec_, X)
        items.append(batcher._Item(est.spec_, est.module_, X_pad, n_pad, n_keep,
                                   batcher._device_of(est.module_)))
        fused._ring.put(items[-1])
    fused._ensure_thread()
    for item in items:
        assert item.done.wait(timeout=60)
    fused.close()
    return [item.error or item.result for item in items]


def test_fused_answers_match_the_jax_batcher_and_direct_predicts(models):
    """Concurrent submits over four models (and two shapes) fuse, and each
    answer matches the JAX CrossModelBatcher's and the port's direct one."""
    # a collection window, so that the eight threads' submits surely meet
    jax_fused = jax_batcher.CrossModelBatcher(window_ms=200, max_batch=8)
    ours = batcher.CrossModelBatcher(window_ms=200, max_batch=8)
    cases = [(i % len(models), _X(i, rows=60 if i % 3 else 100)) for i in range(8)]
    theirs = _concurrently(lambda i: jax_fused.submit(
        models[cases[i][0]][0], jax.device_put(models[cases[i][0]][1]), cases[i][1]), 8)
    got = _concurrently(lambda i: ours.submit(
        models[cases[i][0]][2].spec_, models[cases[i][0]][2].module_, cases[i][1]), 8)
    ours.close()
    for (m, X), mine, jax_out in zip(cases, got, theirs):
        direct = models[m][2].predict(X)
        assert mine.shape == direct.shape == (len(X) - 31, 4)
        np.testing.assert_allclose(mine, direct, **TOL)
        np.testing.assert_allclose(mine, np.asarray(jax_out), **TOL)
    assert ours.stats["items"] == 8 and ours.stats["device_calls"] < 8
    assert ours.stats["largest_batch"] >= 2


def test_many_producers_under_a_short_switch_interval(models):
    """32 threads (more than the cores) submitting at once, with the
    interpreter switching threads every microsecond: every answer is its
    own request's, and no item is lost from the counts."""
    import sys

    fused = batcher.CrossModelBatcher()
    cases = [(models[i % 4][2], _X(200 + i)) for i in range(32)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = _concurrently(lambda i: [fused.submit(cases[i][0].spec_, cases[i][0].module_,
                                                    cases[i][1]) for _ in range(3)], 32)
    finally:
        sys.setswitchinterval(interval)
        fused.close()
    assert fused.stats["items"] == 96 and sum(n for n, _ in fused.calls) == 96
    for (est, X), answers in zip(cases, got):
        for answer in answers:
            np.testing.assert_allclose(answer, est.predict(X), **TOL)


def test_bf16_lanes_match_single_bf16_predicts():
    bf16 = _models(3, compute_dtype="bfloat16")
    assert bf16[0][2].spec_.compute_dtype == "bfloat16"
    pairs = [(bf16[i % 3][2], _X(10 + i)) for i in range(6)]
    fused = batcher.CrossModelBatcher()
    lanes = _queued(fused, pairs)
    assert fused.calls[0] == (6, 6 * 32)
    for (est, X), lane in zip(pairs, lanes):
        single = est.predict(X)
        np.testing.assert_allclose(lane, single, **TOL_BF16)
        f32 = TransformerAutoEncoder(kind="transformer_model", **SMALL).load_params(
            dataclasses.replace(est.spec_, compute_dtype="float32"),
            est.module_.params_numpy(), "cpu")
        # and bf16, not float32, was computed
        assert np.abs(lane - f32.predict(X)).max() > 1e-5


def _block(layers):
    """The first Transformer block's parameters of a bank (or a list of layers)."""
    return next(p for p in getattr(layers, "stacked", layers) if "wq" in p)


def test_bank_grows_in_powers_of_two_from_eight():
    fleet = _models(9)
    fused = batcher.CrossModelBatcher()
    for spec, _, est in fleet:
        np.testing.assert_allclose(fused.submit(est.spec_, est.module_, _X(0)),
                                   est.predict(_X(0)), **TOL)
    bank = fused.bank(fleet[0][2].spec_, torch.device("cpu"))
    fused.close()
    assert len(bank) == 9 and bank.capacity == 16 and bank.restacks == 2
    assert bank.evictions == 0 and bank.generation == 0
    assert _block(bank)["wq"].shape == (16, 32, 32)


def test_bank_evicts_the_least_recently_used_in_place(monkeypatch):
    monkeypatch.setenv("GORDO_TPU_PARAM_BANK_MAX", "2")
    fleet = _models(5)
    fused = batcher.CrossModelBatcher()
    X = _X(1)
    direct = [est.predict(X) for _, _, est in fleet]
    for _round in range(2):
        for (_, _, est), want in zip(fleet, direct):
            np.testing.assert_allclose(fused.submit(est.spec_, est.module_, X), want, **TOL)
    bank = fused.bank(fleet[0][2].spec_, torch.device("cpu"))
    assert bank.capacity == 8 and bank.restacks == 1  # no restack at an eviction
    assert len(bank) == len(bank.slots) == 2 and bank.evictions == 8
    assert bank.generation == 8
    # the two most recently used are resident, in slots 0 and 1
    assert sorted(bank.slots.values()) == [0, 1]
    assert set(bank.slots) == {id(fleet[3][2].module_), id(fleet[4][2].module_)}
    # an evicted model comes back into a freed slot
    np.testing.assert_allclose(fused.submit(fleet[0][2].spec_, fleet[0][2].module_, X),
                               direct[0], **TOL)
    fused.close()
    assert id(fleet[3][2].module_) not in bank.slots


def test_replace_overwrites_a_slot_in_place(models):
    (_, _, old), (_, _, new) = models[0], models[1]
    fused = batcher.CrossModelBatcher()
    X = _X(2)
    fused.submit(old.spec_, old.module_, X)
    bank = fused.bank(old.spec_, torch.device("cpu"))
    slot = bank.slots[id(old.module_)]
    assert bank.replace(new.module_, old.module_) is None  # new is not resident
    assert bank.replace(old.module_, new.module_) == slot
    assert bank.generation == 1 and bank.capacity == 8 and bank.restacks == 1
    assert id(old.module_) not in bank.slots and bank.slots[id(new.module_)] == slot
    np.testing.assert_array_equal(_block(bank)["wq"][slot].numpy(),
                                  _block(new.module_.params_numpy())["wq"])
    np.testing.assert_allclose(fused.submit(new.spec_, new.module_, X), new.predict(X), **TOL)
    fused.close()
    assert bank.restacks == 1


def test_swap_params_keeps_capacity_and_frees_the_warm_slot(models):
    """A hot swap whose warm-up already gave the rebuilt model a slot: the
    old slot is rewritten in place, the warm slot freed and taken by the
    next newcomer, with no restack and no change of capacity."""
    (_, _, old), (_, _, new), (_, _, other) = models[0], models[1], models[2]
    fused = batcher.CrossModelBatcher()
    X = _X(3)
    for est in (old, new):  # new: the swap's warm-up predicts through the bank
        np.testing.assert_allclose(fused.submit(est.spec_, est.module_, X), est.predict(X), **TOL)
    bank = fused.bank(old.spec_, torch.device("cpu"))
    slot, warm_slot = bank.slots[id(old.module_)], bank.slots[id(new.module_)]
    assert fused.swap_params(old.spec_, old.module_, new.module_)
    assert bank.slots[id(new.module_)] == slot and bank.free == [warm_slot]
    assert len(bank) == 1 and bank.capacity == 8 and bank.restacks == 1
    assert not fused.swap_params(old.spec_, old.module_, new.module_)  # no longer resident
    np.testing.assert_allclose(fused.submit(new.spec_, new.module_, X), new.predict(X), **TOL)
    # the old model, still held by a request in flight, comes back into the freed slot
    np.testing.assert_allclose(fused.submit(old.spec_, old.module_, X), old.predict(X), **TOL)
    assert bank.slots[id(old.module_)] == warm_slot and bank.free == []
    np.testing.assert_allclose(fused.submit(other.spec_, other.module_, X), other.predict(X),
                               **TOL)
    fused.close()
    assert bank.capacity == 8 and bank.restacks == 1 and bank.evictions == 0


@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_a_rider_whose_slot_is_replaced_before_its_launch_retries(models, monkeypatch,
                                                                   pipeline):
    """A swap that lands between a fused call's slot resolution and its
    gather would hand the old model's rider the new parameters: the call
    sees the bank's generation move, the group takes the retry ladder, and
    every rider answers with its own model's output."""
    monkeypatch.setenv("GORDO_TPU_DEVICE_PIPELINE", pipeline)
    (_, _, old), (_, _, new), (_, _, other) = models[0], models[1], models[3]
    fused = batcher.CrossModelBatcher()
    X = _X(4)
    fused.register_params(old.spec_, old.module_)
    fused.register_params(other.spec_, other.module_)
    bank = fused.bank(old.spec_, torch.device("cpu"))
    staged = batcher.CrossModelBatcher._stacked_inputs
    swaps, stagings = [], []

    def staging_then_swap(self, items, slots, device):
        stagings.append(list(slots))
        out = staged(self, items, slots, device)
        if not swaps:  # once: the swap lands after the slots were resolved
            swaps.append(bank.replace(old.module_, new.module_))
        return out

    monkeypatch.setattr(batcher.CrossModelBatcher, "_stacked_inputs", staging_then_swap)
    got = _queued(fused, [(old, X), (other, X)])
    assert swaps == [0]
    # the retry resolved the old model again: out of the slot the swap rewrote
    assert len(stagings) >= 2 and stagings[0] == [0, 1] and 0 not in stagings[-1]
    np.testing.assert_allclose(got[0], old.predict(X), **TOL)
    np.testing.assert_allclose(got[1], other.predict(X), **TOL)
    assert not np.allclose(got[0], new.predict(X), **TOL)
    assert bank.capacity == 8 and bank.restacks == 1


def test_the_window_cap_splits_a_group(models, monkeypatch):
    monkeypatch.setattr(batcher, "MAX_WINDOWS", 64)
    fused = batcher.CrossModelBatcher()
    pairs = [(models[i % 4][2], _X(20 + i)) for i in range(5)]  # 32 windows each
    lanes = _queued(fused, pairs)
    assert list(fused.calls) == [(2, 64), (2, 64), (1, 32)]
    for (est, X), lane in zip(pairs, lanes):
        np.testing.assert_allclose(lane, est.predict(X), **TOL)
    # a request above the cap runs alone
    monkeypatch.setattr(batcher, "MAX_WINDOWS", 16)
    fused = batcher.CrossModelBatcher()
    _queued(fused, pairs[:2])
    assert list(fused.calls) == [(1, 32), (1, 32)]


@pytest.mark.parametrize("poisoned, bisections, rescues", [(None, 3, 4), (2, 2, 1)],
                         ids=["every fused call fails", "one request fails"])
def test_bisection_ladder_and_serial_rescue(models, monkeypatch, poisoned, bisections, rescues):
    """A fused call that raises is bisected down to single requests, which
    the serial rescue answers through their own models; a request that
    fails every way fails alone, and its cohort is answered."""
    marker = 1e6
    real = batcher._stacked_apply

    def failing(spec, bank, idx, X, n_pad):
        if poisoned is None or bool((X == marker).any()):
            raise RuntimeError("injected fused-call failure")
        return real(spec, bank, idx, X, n_pad)

    real_single = batcher._single_apply

    def single(item):
        if (item.X_pad == marker).any():
            raise RuntimeError("injected rescue failure")
        return real_single(item)

    monkeypatch.setattr(batcher, "_stacked_apply", failing)
    monkeypatch.setattr(batcher, "_single_apply", single)
    fused = batcher.CrossModelBatcher()
    pairs = [(models[i][2], np.full((60, 4), marker, np.float32) if i == poisoned else _X(30 + i))
             for i in range(4)]
    lanes = _queued(fused, pairs)
    assert fused.stats["bisections"] == bisections
    assert fused.stats["serial_rescues"] == rescues
    for i, ((est, X), lane) in enumerate(zip(pairs, lanes)):
        if i == poisoned:
            assert isinstance(lane, RuntimeError) and "rescue" in str(lane)
        else:
            np.testing.assert_allclose(lane, est.predict(X), **TOL)


def test_a_timed_out_waiter_abandons_its_item(models, monkeypatch, caplog):
    """A wedged fused call: both waiters time out, the item queued behind
    the wedge is skipped, and the batcher serves again afterwards."""
    real = batcher._stacked_apply
    wedged = threading.Event()

    def wedge(*args):
        if not wedged.is_set():
            wedged.set()
            time.sleep(1.0)
        return real(*args)

    monkeypatch.setattr(batcher, "_stacked_apply", wedge)
    fused = batcher.CrossModelBatcher(timeout_s=0.2)
    errors = {}

    def submit(key, i):
        try:
            fused.submit(models[i][2].spec_, models[i][2].module_, _X(40 + i))
        except TimeoutError as exc:
            errors[key] = exc

    t1 = threading.Thread(target=submit, args=("wedged", 0))
    t1.start()
    assert wedged.wait(timeout=10)
    t2 = threading.Thread(target=submit, args=("queued", 1))
    t2.start()
    t1.join(timeout=10)
    t2.join(timeout=10)
    assert set(errors) == {"wedged", "queued"}
    assert fused.stats["abandoned"] == 2
    deadline = time.monotonic() + 10
    while fused.stats["device_calls"] < 1 and time.monotonic() < deadline:
        time.sleep(0.02)
    time.sleep(0.1)
    assert fused.stats["items"] == 1  # the queued item was skipped, not computed
    assert sum("abandoned by its waiter" in r.message for r in caplog.records) == 1
    est = models[2][2]
    np.testing.assert_allclose(fused.submit(est.spec_, est.module_, _X(3)), est.predict(_X(3)),
                               **TOL)
    fused.close()


def test_pipeline_on_and_off_give_identical_outputs(models, monkeypatch):
    pairs = [(models[i % 4][2], _X(50 + i)) for i in range(12)]
    outs, stats = {}, {}
    for flag in ("0", "1"):
        monkeypatch.setenv("GORDO_TPU_DEVICE_PIPELINE", flag)
        fused = batcher.CrossModelBatcher(max_batch=4)
        outs[flag] = _queued(fused, pairs)
        stats[flag] = (dict(fused.stats), list(fused.calls))
    assert stats["0"][1] == stats["1"][1] == [(4, 128)] * 3
    assert stats["0"][0]["pipeline_overlaps"] == 0 and stats["1"][0]["pipeline_overlaps"] == 2
    for a, b in zip(outs["0"], outs["1"]):
        np.testing.assert_array_equal(a, b)


def test_auto_mode_records_its_decision_once(models, monkeypatch):
    monkeypatch.setenv("GORDO_TPU_BATCH_AB_USERS", "2")
    monkeypatch.setenv("GORDO_TPU_BATCH_AB_ROUNDS", "1")
    fused = batcher.CrossModelBatcher(self_ab=True)
    est, X = models[0][2], _X(4)
    out = fused.submit(est.spec_, est.module_, X)
    decision = fused._spec_on[est.spec_]
    record = fused.calibrations[est.spec_]
    assert record["batching"] is decision and record["users"] == 2
    assert record["p50_direct_ms"] > 0 and record["p50_batched_ms"] > 0
    if decision:
        np.testing.assert_allclose(out, est.predict(X), **TOL)
    else:
        assert out is None
    assert fused.decision_counts() == ((1, 0) if decision else (0, 1))
    monkeypatch.setattr(fused, "_calibrate", lambda *a: pytest.fail("calibrated twice"))
    fused.submit(est.spec_, est.module_, X)
    fused.close()


def test_auto_mode_stands_down_when_the_batched_arm_loses(models, monkeypatch):
    monkeypatch.setenv("GORDO_TPU_BATCH_AB_USERS", "2")
    monkeypatch.setenv("GORDO_TPU_BATCH_AB_ROUNDS", "2")
    monkeypatch.setenv("GORDO_TPU_BATCH_AB_HOSTWORK_MS", "0")
    monkeypatch.setenv("GORDO_TPU_SERVING_BATCH", "auto")
    fused = batcher.get_batcher()
    assert fused is not None and fused.self_ab
    real = fused._force_submit

    def slow(spec, model, X):
        time.sleep(0.05)
        return real(spec, model, X)

    monkeypatch.setattr(fused, "_force_submit", slow)
    est, X = models[1][2], _X(5)
    assert fused.submit(est.spec_, est.module_, X) is None
    assert fused._spec_on[est.spec_] is False and fused.decision_counts() == (0, 1)
    monkeypatch.setattr(fused, "_force_submit", real)
    calls = fused.stats["device_calls"]
    # the estimator's predict goes direct through maybe_submit
    np.testing.assert_allclose(est.predict(X), batcher.predict_fn(est.module_)(X), **TOL)
    assert fused.stats["device_calls"] == calls


def test_maybe_submit_is_off_by_default_and_never_reenters(models, monkeypatch):
    est, X = models[0][2], _X(6)
    assert batcher.maybe_submit(est.spec_, est.module_, X) is None  # unset: off
    monkeypatch.setenv("GORDO_TPU_SERVING_BATCH", "0")
    assert batcher.maybe_submit(est.spec_, est.module_, X) is None
    assert batcher.peek_batcher() is None
    monkeypatch.setenv("GORDO_TPU_SERVING_BATCH", "1")
    np.testing.assert_allclose(batcher.maybe_submit(est.spec_, est.module_, X),
                               est.predict(X), **TOL)
    assert not batcher.peek_batcher().self_ab
    # the dispatcher thread predicts direct
    seen = []
    thread = threading.Thread(target=lambda: seen.append(
        batcher.maybe_submit(est.spec_, est.module_, X)), name="gordo-batcher")
    thread.start()
    thread.join(timeout=10)
    assert seen == [None]
    # as do specs that cannot run stacked: ring attention, a parallel axis
    ring = dataclasses.replace(est.spec_, layers=tuple(
        dataclasses.replace(layer, attention_impl="ring") if hasattr(layer, "attention_impl")
        else layer for layer in est.spec_.layers))
    assert batcher.maybe_submit(ring, est.module_, X) is None
    assert batcher.maybe_submit(dataclasses.replace(est.spec_, tensor_parallel=2),
                                est.module_, X) is None


def test_run_server_exports_the_batching_mode(monkeypatch):
    from gordo_tpu_torch.server import server

    seen = []
    monkeypatch.setattr(server, "run_server",
                        lambda *args: seen.append(os.environ["GORDO_TPU_SERVING_BATCH"]))
    for argv, env, mode in ((["run-server"], None, "auto"),
                            (["run-server", "--no-batch-predicts"], None, "0"),
                            (["run-server"], "false", "0"),
                            (["run-server", "--batch-predicts"], "0", "auto")):
        if env is None:
            monkeypatch.delenv("GORDO_SERVER_BATCH_PREDICTS", raising=False)
        else:
            monkeypatch.setenv("GORDO_SERVER_BATCH_PREDICTS", env)
        assert cli.main(argv + ["--device", "cpu"]) == 0
        assert seen[-1] == mode, (argv, env)


# ------------------------------------------------------------- the server
NAMES = ["m-0", "m-1", "m-2"]
CONFIG = """
machines:
  - name: tf-machine
    dataset:
      tags: [tag-0, tag-1, tag-2, tag-3]
      target_tag_list: [tag-0, tag-1, tag-2, tag-3]
      train_start_date: '2019-01-01T00:00:00+00:00'
      train_end_date: '2019-01-03T00:00:00+00:00'
      asset: asgb
      data_provider:
        type: RandomDataProvider
    model:
      gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector:
        base_estimator:
          sklearn.pipeline.Pipeline:
            steps:
            - sklearn.preprocessing.MinMaxScaler
            - gordo_tpu.models.models.TransformerAutoEncoder:
                kind: transformer_model
                lookback_window: 32
                d_model: 32
                num_heads: 2
                ff_dim: 64
                num_blocks: 2
                epochs: 1
"""


def _port_artifact(jax_dir: str, port_dir: str) -> None:
    """The port's artifact of a JAX artifact."""
    with open(os.path.join(jax_dir, "model.pkl"), "rb") as f:
        jax_model = pickle.load(f)
    (_, in_scaler), (_, estimator) = jax_model.base_estimator.steps
    spec = spec_from_dataclass(estimator.spec_)
    detector = detector_from_arrays(
        spec, [{k: np.asarray(v) for k, v in p.items()} for p in estimator.params_],
        in_scaler.min_, in_scaler.scale_, jax_model.scaler.min_, jax_model.scaler.scale_,
        estimator_kwargs=estimator.kwargs,
        feature_thresholds=np.asarray(jax_model.feature_thresholds_),
        aggregate_threshold=jax_model.aggregate_threshold_, device="cpu")
    metadata = jax_serializer.load_metadata(jax_dir)
    serializer.dump(detector, port_dir, tags=[t["name"] for t in metadata["dataset"]["tags"]],
                    metadata=metadata)


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    """(JAX collection, port collection): one built machine dumped as three
    models, each its own weights (the built ones plus seeded noise)."""
    root = tmp_path_factory.mktemp("batcher")
    jax_coll, port_coll = root / "jax" / "7", root / "port" / "7"
    (model, machine), = local_build(CONFIG)
    estimator = model.base_estimator.steps[1][1]
    built = [{k: np.asarray(v) for k, v in p.items()} for p in estimator.params_]
    rng = np.random.RandomState(0)
    for i, name in enumerate(NAMES):
        estimator.params_ = [{k: v + 0.05 * i * rng.randn(*v.shape).astype(v.dtype)
                              for k, v in p.items()} for p in built]
        jax_serializer.dump(model, str(jax_coll / name), metadata=machine.to_dict())
        _port_artifact(str(jax_coll / name), str(port_coll / name))
    return str(jax_coll), str(port_coll)


@pytest.fixture
def port_server(collections):
    server = make_server("127.0.0.1", 0, device="cpu", collection_dir=collections[1])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server, f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/proj"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _payload(seed, n_rows=60):
    rng = np.random.RandomState(seed)
    t0 = datetime(2020, 1, 1, tzinfo=timezone.utc)
    stamps = [(t0 + timedelta(minutes=10 * i)).isoformat() for i in range(n_rows)]
    frame = lambda: {f"tag-{j}": dict(zip(stamps, rng.rand(n_rows).tolist()))  # noqa: E731
                     for j in range(4)}
    return {"X": frame(), "y": frame()}


def _post(url: str, payload) -> tuple:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _assert_same(ours: dict, theirs: dict, tol=1e-5) -> None:
    """The same structure, key for key and in order; floats within ``tol``."""
    assert list(ours) == list(theirs)
    for top in theirs:
        assert list(ours[top]) == list(theirs[top]), top
        for sub, column in theirs[top].items():
            assert list(ours[top][sub]) == list(column), (top, sub)
            mine = [ours[top][sub][key] for key in column]
            if top in ("start", "end"):
                assert mine == list(column.values())
            else:
                np.testing.assert_allclose(mine, list(column.values()), rtol=tol, atol=tol)


def test_concurrent_requests_answer_like_the_jax_server_with_batching(
        collections, port_server, monkeypatch):
    """Anomaly and base requests over three models at once, with batching on
    in both servers: the port's answers have the JAX server's structure and
    its values, and the port fused them."""
    monkeypatch.setenv("GORDO_TPU_SERVING_BATCH", "1")
    monkeypatch.setenv("GORDO_TPU_BATCH_WINDOW_MS", "200")
    monkeypatch.setattr(jax_batcher, "_batcher", None)
    server, url = port_server
    requests = [(NAMES[i % 3], "anomaly/prediction" if i % 2 == 0 else "prediction",
                 _payload(i)) for i in range(12)]
    app = build_app({"MODEL_COLLECTION_DIR": collections[0]})
    theirs = _concurrently(lambda i: app.test_client().post(
        f"/gordo/v0/proj/{requests[i][0]}/{requests[i][1]}", json=requests[i][2]), 12)
    ours = _concurrently(lambda i: _post(f"{url}/{requests[i][0]}/{requests[i][1]}",
                                         requests[i][2]), 12)
    fused = batcher.peek_batcher()
    assert fused.stats["items"] == 12 and fused.stats["device_calls"] < 12
    assert jax_batcher.peek_batcher().stats["items"] == 12
    for (name, route, _), (status, body), jax_resp in zip(requests, ours, theirs):
        assert status == jax_resp.status_code == 200, (name, route)
        jax_body = jax_resp.get_json()
        assert list(body) == list(jax_body) == ["data", "time-seconds", "revision"]
        _assert_same(body["data"], jax_body["data"])
    monkeypatch.setattr(jax_batcher, "_batcher", None)


@pytest.mark.parametrize("mode", ["0", "1"], ids=["batching off", "batching on"])
def test_one_model_answers_concurrent_requests(port_server, monkeypatch, mode):
    """Eight requests to one model at once are all inside the model
    together (a per-model lock would break the barrier), and each gets the
    answer it gets alone: the same bytes unbatched, within float32 rounding
    when fused."""
    monkeypatch.setenv("GORDO_TPU_SERVING_BATCH", mode)
    monkeypatch.setenv("GORDO_TPU_BATCH_WINDOW_MS", "200")
    server, url = port_server
    path = f"{url}/{NAMES[1]}/anomaly/prediction"
    payloads = [_payload(100 + i) for i in range(8)]
    alone = [_post(path, p) for p in payloads]
    entry = server.models[NAMES[1]]
    barrier = threading.Barrier(8, timeout=30)
    real = entry.detector.anomaly_raw

    def together(*args, **kwargs):
        barrier.wait()
        return real(*args, **kwargs)

    monkeypatch.setattr(entry.detector, "anomaly_raw", together)
    answers = _concurrently(lambda i: _post(path, payloads[i]), 8)
    for (status, body), (alone_status, alone_body) in zip(answers, alone):
        assert status == alone_status == 200
        if mode == "0":
            assert body["data"] == alone_body["data"]
        else:
            _assert_same(body["data"], alone_body["data"])
    if mode == "1":
        assert batcher.peek_batcher().stats["largest_batch"] >= 2
