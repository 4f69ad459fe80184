"""
The port's fleet trainer (gordo_tpu_torch/parallel/batch_trainer.py, the
stacked model of ops/nn.py, the masked epoch of ops/train.py and
``batch-build``) against the JAX package's on the CPU:

- ``_machine_seed``, ``_fold_bounds`` and the planner's batched-or-serial
  decision: identical;
- the stacked model at M = 3 against three ``TransformerModel``s at the
  same parameters, and one masked epoch at M = 2 against two serial
  ``run_epoch``s with the same orders, for every optimizer rule;
- the bucket program and a whole 3-machine fleet build against the JAX
  ``_bucket_program`` and ``BatchedModelBuilder``, handed the JAX program's
  own draws: parameters, losses, fold predictions, thresholds, CV scores
  and split metadata; once more at dh 64 with the JAX side on the Pallas
  kernels in interpret mode;
- chunking, checkpoint and resume, quarantine and the exit codes, and
  ``batch-build``'s artifacts served by the port's server.

Float32 on both sides, summed in another order. Tolerances, each from the
numbers of ``tests/test_torch_train.py`` for Adam steps of a small model:
TOL_PARAM_ABS 1e-4 on parameters (but the key biases ``bk``, held as that
file holds them: their true gradient is 0, so Adam turns rounding noise
into different values, and the check is that they change no output),
TOL_LOSS_REL 1e-4 on epoch losses,
TOL_PRED_ABS 1e-4 on fold predictions (outputs of order 1), and
TOL_THRESHOLD_REL 1e-3 on thresholds and scores, which are statistics of
those predictions' errors (a few 1e-4 of an error of order 0.1-1 is
1e-3 of it).
"""

import dataclasses
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.ops import nn as jax_nn
from gordo_tpu.parallel import batch_trainer as jax_bt
from gordo_tpu_torch import cli
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.models.models import TransformerAutoEncoder
from gordo_tpu_torch.models.spec import OptimizerSpec
from gordo_tpu_torch.ops import nn, train
from gordo_tpu_torch.parallel import batch_trainer as bt
from gordo_tpu_torch.serializer.from_jax import params_from_numpy, spec_from_dataclass
from gordo_tpu_torch.server.server import make_server

TOL_PARAM_ABS = 1e-4
TOL_LOSS_REL = 1e-4
TOL_PRED_ABS = 1e-4
TOL_THRESHOLD_REL = 1e-3
TOL_STACKED = dict(atol=1e-6, rtol=1e-5)  # one model's arithmetic, batched another way
TOL_OUTPUT = dict(atol=1e-5, rtol=1e-5)  # one model, two bk values

ESTIMATOR = {"kind": "transformer_model", "lookback_window": 16, "d_model": 16,
             "num_heads": 2, "ff_dim": 32, "num_blocks": 1, "epochs": 2, "batch_size": 32}
# the kernel path: dh 64, T 16, one block, the flash kernels named on both sides
FLASH_ESTIMATOR = dict(ESTIMATOR, d_model=64, num_heads=1, ff_dim=64, epochs=1,
                       attention="flash")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The comparisons run on torch's calling thread alone, as
    ``tests/test_torch_flash_attention.py`` runs its plain twins."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def machine_config(name, estimator=ESTIMATOR, tags=None, evaluation=None, **detector):
    """A small Transformer machine on 2 days of RandomDataset rows (288),
    tags named after the machine so that the machines' data differ."""
    return {
        "name": name,
        "dataset": {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00+00:00",
                    "train_end_date": "2020-01-03T00:00:00+00:00",
                    "tags": tags or [f"{name}-tag-{j}" for j in range(4)],
                    "resolution": "10min"},
        "model": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {
            "window": 6, **detector,
            "base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
                "sklearn.preprocessing.MinMaxScaler",
                {"gordo_tpu.models.models.TransformerAutoEncoder": estimator}]}}}},
        "evaluation": evaluation or {"cv_mode": "full_build", "seed": 0,
                                     "scoring_scaler": "sklearn.preprocessing.MinMaxScaler"},
    }


def _assert_same_params(spec, ours, theirs, atol, n_features=4):
    """Every parameter within ``atol`` but ``bk``; the model with the other
    side's ``bk`` gives the same output."""
    for i, (mine, layer) in enumerate(zip(ours, theirs)):
        for name, value in layer.items():
            if name != "bk":
                np.testing.assert_allclose(mine[name], np.asarray(value), rtol=0, atol=atol,
                                           err_msg=f"{i}/{name}")
    swapped = [dict(p, **({"bk": np.asarray(t["bk"])} if "bk" in p else {}))
               for p, t in zip(ours, theirs)]
    x = torch.as_tensor(np.random.RandomState(9).rand(3, spec.lookback_window, n_features)
                        .astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(
            nn.TransformerModel(spec, swapped, torch.device("cpu"))(x).numpy(),
            nn.TransformerModel(spec, ours, torch.device("cpu"))(x).numpy(), **TOL_OUTPUT)


def _machines(configs):
    return ([Machine.from_config(c, "proj") for c in configs],
            [JaxMachine.from_config(c, "proj") for c in configs])


# ------------------------------------------------------------ seeds, bounds
@pytest.mark.parametrize("name, seed", [("m-0", 0), ("a-much-longer-machine-name", 7),
                                        ("x", 2**31 - 1), ("tag", -3)])
def test_machine_seed_is_jax_bit_identical(name, seed):
    config = machine_config(name, evaluation={"cv_mode": "full_build", "seed": seed})
    ours, theirs = _machines([config])
    assert bt._machine_seed(ours[0]) == jax_bt._machine_seed(theirs[0])


@pytest.mark.parametrize("n_rows, n_splits", [(288, 3), (6144, 3), (100, 5), (7, 2)])
def test_fold_bounds_are_jax_bit_identical(n_rows, n_splits):
    assert bt._fold_bounds(n_rows, n_splits) == jax_bt.BatchedModelBuilder._fold_bounds(
        None, n_rows, n_splits)


PLAN_CASES = {
    "plain transformer": machine_config("m"),
    "cross_val_only": machine_config("m", evaluation={"cv_mode": "cross_val_only"}),
    "unknown metric": machine_config("m", evaluation={
        "metrics": ["sklearn.metrics.max_error"]}),
    "TimeSeriesSplit(gap=1)": machine_config("m", evaluation={
        "cv": {"sklearn.model_selection.TimeSeriesSplit": {"n_splits": 3, "gap": 1}}}),
    "TimeSeriesSplit(4)": machine_config("m", evaluation={
        "cv": {"sklearn.model_selection.TimeSeriesSplit": {"n_splits": 4}}}),
    "non-MinMax scaler": machine_config("m", scaler="sklearn.preprocessing.StandardScaler"),
    "shuffled detector": machine_config("m", shuffle=True),
    "callbacks": machine_config("m", estimator=dict(ESTIMATOR, callbacks=[
        {"tensorflow.keras.callbacks.EarlyStopping": {"monitor": "loss", "patience": 1}}])),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_decisions_match_jax(case):
    ours, theirs = _machines([PLAN_CASES[case]])
    plan, jax_plan = bt._plan_machine(ours[0]), jax_bt._plan_machine(theirs[0])
    assert (plan is None) == (jax_plan is None)
    assert (plan is None) == (case not in ("plain transformer", "TimeSeriesSplit(4)"))
    if plan is not None:
        for key in ("scale_x", "wrap_anomaly", "epochs", "batch_size", "shuffle", "n_splits"):
            assert getattr(plan, key) == getattr(jax_plan, key), key
        assert plan.anomaly_kwargs == jax_plan.anomaly_kwargs
        assert plan.spec == spec_from_dataclass(jax_plan.spec)


# ------------------------------------------------------ stacked model, epoch
def _port_spec(**estimator):
    return TransformerAutoEncoder(**{**ESTIMATOR, **estimator}).build_spec(4, 4)


def _machine_params(spec, m):
    return [{k: v.numpy() for k, v in p.items()}
            for p in nn.init_model_params(spec, torch.Generator().manual_seed(m))]


def test_stacked_model_equals_transformer_models():
    spec = _port_spec(num_blocks=2)
    per_machine = [_machine_params(spec, m) for m in range(3)]
    stacked = nn.StackedTransformerModel(spec, nn.stack_params(per_machine),
                                         torch.device("cpu"))
    x = torch.as_tensor(np.random.RandomState(0).rand(3, 5, 16, 4).astype(np.float32))
    out = stacked(x)
    assert out.shape == (3, 5, 4)
    for m in range(3):
        ref = nn.TransformerModel(spec, per_machine[m], torch.device("cpu"))(x[m])
        torch.testing.assert_close(out[m], ref, **TOL_STACKED)
        for got, want in zip(stacked.machine_params(m), per_machine[m]):
            assert all(np.array_equal(got[k], want[k]) for k in want)
    one = nn.StackedTransformerModel(spec, nn.stack_params(per_machine[:1]),
                                     torch.device("cpu"))
    torch.testing.assert_close(one(x[:1])[0], nn.TransformerModel(
        spec, per_machine[0], torch.device("cpu"))(x[0]), **TOL_STACKED)


# one batch's output and parameter gradients, stacked against serial, each
# relative to the serial one's largest entry: float32 as TOL_STACKED; bf16
# at chip_smoke.py's TOL_BF16_MODEL_REL (each product rounded to bf16, the
# stacked and serial matmuls sum in another order before rounding)
TOL_BATCH_REL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", sorted(TOL_BATCH_REL))
def test_stacked_batch_gradients_equal_serial(dtype):
    spec = _port_spec(num_blocks=2, compute_dtype=dtype)
    per_machine = [_machine_params(spec, m) for m in range(2)]
    stacked = nn.StackedTransformerModel(spec, nn.stack_params(per_machine),
                                         torch.device("cpu"))
    X = torch.as_tensor(np.random.RandomState(3).rand(2, 60, 4).astype(np.float32))
    idx = torch.stack([torch.randperm(40, generator=torch.Generator().manual_seed(m))[:8]
                       for m in range(2)])
    xb, yb = train._gather_batch(spec, X, X, idx)
    wb = torch.ones(2, 8)
    grads = torch.autograd.grad(train._loss_terms(spec, stacked, xb, yb, wb).sum(),
                                list(stacked.parameters()))
    tol = TOL_BATCH_REL[dtype]
    for m in range(2):
        model = nn.TransformerModel(spec, per_machine[m], torch.device("cpu"))
        with torch.no_grad():
            ref = model(xb[m])
            assert ((stacked(xb)[m] - ref).abs().max() / ref.abs().max()).item() <= tol
        want = torch.autograd.grad(train._loss_terms(spec, model, xb[m], yb[m], wb[m]),
                                   list(model.parameters()))
        for (name, _), got, ref in zip(model.named_parameters(), grads, want):
            if not name.endswith(".bk"):  # its true gradient is 0: rounding noise
                assert ((got[m] - ref).abs().max() / ref.abs().max()).item() <= tol, name


OPTIMIZERS = {
    "adam": {}, "sgd": {"momentum": 0.9, "nesterov": True}, "rmsprop": {"momentum": 0.5},
    "adagrad": {}, "nadam": {}, "adamw": {}, "adamax": {},
}


@pytest.mark.parametrize("rule", sorted(OPTIMIZERS))
def test_masked_epoch_equals_serial_epochs(rule):
    """Every rule of make_optimizer: one optimizer over two stacked
    machines steps each as its own optimizer over its own model does."""
    assert set(OPTIMIZERS) == set(train.RULES)
    spec = _port_spec(num_blocks=1)
    spec = dataclasses.replace(spec, optimizer=OptimizerSpec.create(
        rule, {"learning_rate": 0.01, **OPTIMIZERS[rule]}))
    per_machine = [_machine_params(spec, m) for m in range(2)]
    rng = np.random.RandomState(1)
    X = torch.as_tensor(rng.rand(2, 80, 4).astype(np.float32))
    n_max, n_valid, batch = 65, 40, 16  # 3 live steps, the last one short
    orders = torch.stack([torch.cat([torch.randperm(n_valid, generator=torch.Generator()
                                                    .manual_seed(m)),
                                     torch.arange(n_valid, n_max)]) for m in range(2)])
    stacked = nn.StackedTransformerModel(spec, nn.stack_params(per_machine), torch.device("cpu"))
    optimizer = train.make_optimizer(spec.optimizer, stacked.parameters())
    epoch_losses, step_losses = train.run_masked_epoch(stacked, optimizer, X, X, orders,
                                                       n_valid, batch)
    assert step_losses.shape == (3, 2)
    for m in range(2):
        model = nn.TransformerModel(spec, per_machine[m], torch.device("cpu"))
        serial_optimizer = train.make_optimizer(spec.optimizer, model.parameters())
        loss, losses = train.run_epoch(model, serial_optimizer, X[m], X[m], orders[m, :n_valid],
                                       batch)
        torch.testing.assert_close(step_losses[:, m], losses, **TOL_STACKED)
        assert epoch_losses[m].item() == pytest.approx(loss, rel=1e-6)
        _assert_same_params(spec, stacked.machine_params(m), model.params_numpy(),
                            TOL_STACKED["atol"])


def test_masked_epoch_refuses_orders_that_are_not_valid_first():
    spec = _port_spec()
    stacked = nn.StackedTransformerModel(spec, nn.stack_params([_machine_params(spec, 0)]),
                                         torch.device("cpu"))
    X = torch.zeros(1, 40, 4)
    orders = torch.arange(25).flip(0)[None]  # sample 24 in a live slot
    with pytest.raises(ValueError, match="valid-first"):
        train.run_masked_epoch(stacked, train.make_optimizer(spec.optimizer, stacked.parameters()),
                               X, X, orders, 10, 8)


# ---------------------------------------------------- the JAX program's draws
def jax_draws(jax_spec, unrolled=False):
    """A stand-in for ``draw_inputs`` that draws as the JAX bucket program
    does: ``fold_in(PRNGKey(0), seed)``, then ``split(fold_in(rng, k))``
    into the stage's init and fit keys, ``init_model_params(k_init)``, and
    per epoch of ``split(k_fit, epochs)`` the argsort of the valid-first
    uniform keys (the unrolled program: ``permutation`` of the stage's
    samples)."""

    def draw(seeds, spec, stages, epochs, shuffle):
        assert shuffle
        inits, orders = [], []
        for k, stage in enumerate(stages):
            params, per_epoch = [], [[] for _ in range(epochs)]
            for seed in seeds:
                rng = jax.random.fold_in(jax.random.PRNGKey(0), np.uint32(seed))
                k_init, k_fit = jax.random.split(jax.random.fold_in(rng, k))
                params.append([{n: np.asarray(v) for n, v in p.items()}
                               for p in jax_nn.init_model_params(k_init, jax_spec)])
                pos = jnp.arange(stage.n_max)
                for e, epoch_rng in enumerate(jax.random.split(k_fit, epochs)):
                    if unrolled:
                        per_epoch[e].append(np.asarray(
                            jax.random.permutation(epoch_rng, stage.n_valid)))
                        continue
                    keys = jax.random.uniform(epoch_rng, (stage.n_max,))
                    per_epoch[e].append(np.asarray(
                        jnp.argsort(jnp.where(pos < stage.n_valid, keys, keys + 2.0))))
            inits.append(nn.stack_params([params_from_numpy(spec, p) for p in params]))
            orders.append([torch.as_tensor(np.stack(o)).long() for o in per_epoch])
        return inits, orders

    return draw


def _fleet_data(n_machines, n_rows=288, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n_rows)[None, :, None]
    X = np.sin(t / (10.0 + rng.rand(n_machines, 1, 4) * 20)) + 0.1 * rng.randn(n_machines, n_rows, 4)
    return X.astype(np.float32)


@pytest.mark.parametrize("estimator, n_machines", [(ESTIMATOR, 3), (FLASH_ESTIMATOR, 2)],
                         ids=["dh8", "dh64-flash-kernels"])
def test_bucket_program_matches_jax(estimator, n_machines):
    config = machine_config("m", estimator=estimator)
    _, (jax_machine,) = _machines([config])
    jax_plan = jax_bt._plan_machine(jax_machine)
    spec = spec_from_dataclass(jax_plan.spec)
    X = _fleet_data(n_machines)
    seeds = [jax_bt._machine_seed(JaxMachine.from_config(machine_config(f"m-{m}"), "p"))
             for m in range(n_machines)]
    bounds = bt._fold_bounds(len(X[0]), 3)
    program = jax_bt._bucket_program(jax_plan.spec, len(X[0]), bounds, jax_plan.epochs,
                                     jax_plan.batch_size, True, True)
    jax_params, jax_losses, jax_preds = program(jnp.asarray(X), jnp.asarray(X),
                                                jnp.asarray(np.array(seeds, np.uint32)))
    stages = bt.stages_of(spec, len(X[0]), bounds, jax_plan.batch_size)
    inits, orders = jax_draws(jax_plan.spec)(seeds, spec, stages, jax_plan.epochs, True)
    model, losses, preds = bt.run_bucket(spec, X, X, stages, jax_plan.epochs, True, inits,
                                         orders, torch.device("cpu"))
    np.testing.assert_allclose(losses, np.asarray(jax_losses), rtol=TOL_LOSS_REL)
    for ours, theirs in zip(preds, jax_preds):
        assert ours.shape == theirs.shape == (n_machines, 72 - 15, 4)
        np.testing.assert_allclose(ours, np.asarray(theirs), atol=TOL_PRED_ABS)
    for m in range(n_machines):
        _assert_same_params(spec, model.machine_params(m),
                            [{k: np.asarray(v)[m] for k, v in p.items()} for p in jax_params],
                            TOL_PARAM_ABS)


def test_unrolled_program_matches_jax():
    """Fold test slices of unequal lengths: each fold a fit of its own
    samples and batch, as the JAX unrolled program runs it."""
    config = machine_config("m")
    _, (jax_machine,) = _machines([config])
    jax_plan = jax_bt._plan_machine(jax_machine)
    spec = spec_from_dataclass(jax_plan.spec)
    X = _fleet_data(2)
    seeds = [11, 12]
    bounds = ((100, 100, 180), (180, 180, 288))
    program = jax_bt._bucket_program(jax_plan.spec, len(X[0]), bounds, jax_plan.epochs,
                                     jax_plan.batch_size, True, True)
    jax_params, jax_losses, jax_preds = program(jnp.asarray(X), jnp.asarray(X),
                                                jnp.asarray(np.array(seeds, np.uint32)))
    stages = bt.stages_of(spec, len(X[0]), bounds, jax_plan.batch_size)
    assert [s.n_max for s in stages] == [s.n_valid for s in stages] == [85, 165, 273]
    inits, orders = jax_draws(jax_plan.spec, unrolled=True)(seeds, spec, stages,
                                                            jax_plan.epochs, True)
    model, losses, preds = bt.run_bucket(spec, X, X, stages, jax_plan.epochs, True, inits,
                                         orders, torch.device("cpu"))
    np.testing.assert_allclose(losses, np.asarray(jax_losses), rtol=TOL_LOSS_REL)
    assert [p.shape[1] for p in preds] == [65, 93]
    for ours, theirs in zip(preds, jax_preds):
        np.testing.assert_allclose(ours, np.asarray(theirs), atol=TOL_PRED_ABS)
    for m in range(2):
        _assert_same_params(spec, model.machine_params(m),
                            [{k: np.asarray(v)[m] for k, v in p.items()} for p in jax_params],
                            TOL_PARAM_ABS)


def test_unequal_test_slices_take_the_unrolled_geometry():
    spec = _port_spec()
    bounds = ((50, 50, 100), (100, 100, 130))
    folds = bt.stages_of(spec, 130, bounds, 32)
    assert [(s.n_valid, s.n_max, s.batch, s.test_len) for s in folds] == [
        (35, 35, 32, 50), (85, 85, 32, 30), (115, 115, 32, 0)]
    fused = bt.stages_of(spec, 150, ((50, 50, 100), (100, 100, 150)), 32)
    assert [(s.n_valid, s.n_max) for s in fused] == [(35, 135), (85, 135), (135, 135)]


# ----------------------------------------------------- a whole fleet build
def _jax_fleet(configs):
    _, jax_machines = _machines(configs)
    return jax_bt.BatchedModelBuilder(jax_machines, serial_fallback=False).build()


def _close(ours, theirs, rel=TOL_THRESHOLD_REL):
    np.testing.assert_allclose(np.asarray(ours, np.float64), np.asarray(theirs, np.float64),
                               rtol=rel, atol=rel * 1e-2)


def test_fleet_build_matches_jax_batched_builder(monkeypatch):
    configs = [machine_config(f"m-{m}") for m in range(3)]
    theirs = _jax_fleet(configs)
    jax_plan = jax_bt._plan_machine(JaxMachine.from_config(configs[0], "proj"))
    monkeypatch.setattr(bt, "draw_inputs", jax_draws(jax_plan.spec))
    machines, _ = _machines(configs)
    builder = bt.BatchedModelBuilder(machines, serial_fallback=False, device="cpu")
    ours = builder.build()
    assert not builder.serial_built and not builder.quarantine_records
    assert [m.name for _, m in ours] == [m.name for _, m in theirs] == ["m-0", "m-1", "m-2"]
    for (model, machine), (jax_model, jax_machine) in zip(ours, theirs):
        estimator = model.base_estimator.steps[1][1]
        jax_estimator = jax_model.base_estimator.steps[1][1]
        _assert_same_params(estimator.spec_, estimator.module_.params_numpy(),
                            jax_estimator.params_, TOL_PARAM_ABS)
        np.testing.assert_allclose(estimator.history["loss"], jax_estimator.history["loss"],
                                   rtol=TOL_LOSS_REL)
        assert estimator.history["params"] == jax_estimator.history["params"]
        _close(model.feature_thresholds_, jax_model.feature_thresholds_)
        _close(model.aggregate_threshold_, jax_model.aggregate_threshold_)
        _close(model.smooth_feature_thresholds_, jax_model.smooth_feature_thresholds_)
        _close(model.smooth_aggregate_threshold_, jax_model.smooth_aggregate_threshold_)
        for fold, value in jax_model.aggregate_thresholds_per_fold_.items():
            _close(model.aggregate_thresholds_per_fold_[fold], value)
        jax_per_fold = jax_model.feature_thresholds_per_fold_
        for fold in jax_per_fold.index:
            _close(model.feature_thresholds_per_fold_[fold], jax_per_fold.loc[fold].to_numpy())
        built = machine.metadata.build_metadata.model
        jax_built = jax_machine.metadata.build_metadata.model
        assert built.model_offset == jax_built.model_offset == 15
        scores, jax_scores = built.cross_validation.scores, jax_built.cross_validation.scores
        assert sorted(scores) == sorted(jax_scores) and len(scores) == 4 * 5
        for key, entry in jax_scores.items():
            assert sorted(scores[key]) == sorted(entry)
            _close([scores[key][k] for k in sorted(entry)], [entry[k] for k in sorted(entry)])
        splits = built.cross_validation.splits
        assert splits == {k: v if isinstance(v, int) else str(v)
                          for k, v in jax_built.cross_validation.splits.items()}


def test_chunked_build_equals_unchunked():
    configs = [machine_config(f"m-{m}", estimator=dict(ESTIMATOR, epochs=1)) for m in range(3)]
    builds = []
    for chunk_size in (3, 2):
        machines, _ = _machines(configs)
        builds.append(bt.BatchedModelBuilder(machines, chunk_size=chunk_size,
                                             device="cpu").build())
    for (model, _), (again, _) in zip(*builds):
        estimator = model.base_estimator.steps[1][1]
        _assert_same_params(estimator.spec_, again.base_estimator.steps[1][1].module_.params_numpy(),
                            estimator.module_.params_numpy(), TOL_STACKED["atol"])
        _close(again.aggregate_threshold_, model.aggregate_threshold_, rel=1e-5)


def test_out_of_memory_chunk_is_bisected(monkeypatch):
    """A chunk that runs out of device memory is halved until it fits (here
    one machine a program: 3 -> 1 + 2 -> 1 + 1), every machine still from
    the stacked program and as the unchunked build trains it; a single
    machine that runs out goes to the serial builder."""
    configs = [machine_config(f"m-{m}", estimator=dict(ESTIMATOR, epochs=1)) for m in range(3)]
    reference = bt.BatchedModelBuilder(_machines(configs)[0], device="cpu").build()
    run_bucket, sizes = bt.run_bucket, []

    def small_card(spec, X, *args):
        sizes.append(len(X))
        if len(X) > 1:
            raise torch.OutOfMemoryError("CUDA out of memory (a test's card)")
        return run_bucket(spec, X, *args)

    monkeypatch.setattr(bt, "run_bucket", small_card)
    builder = bt.BatchedModelBuilder(_machines(configs)[0], device="cpu")
    built = builder.build()
    assert sizes == [3, 1, 2, 1, 1] and builder.oom_bisections == 2
    assert not builder.serial_built and not builder.quarantine_records
    for (model, machine), (want, _) in zip(built, reference):
        estimator = want.base_estimator.steps[1][1]
        _assert_same_params(estimator.spec_, model.base_estimator.steps[1][1].module_
                            .params_numpy(), estimator.module_.params_numpy(),
                            TOL_STACKED["atol"])
    assert [m.name for _, m in built] == ["m-0", "m-1", "m-2"]

    monkeypatch.setattr(bt, "run_bucket", lambda *a: (_ for _ in ()).throw(
        torch.OutOfMemoryError("CUDA out of memory (a test's card)")))
    builder = bt.BatchedModelBuilder(_machines(configs[:1])[0], device="cpu")
    assert len(builder.build()) == 1
    assert builder.serial_built == ["m-0"] and builder.oom_bisections == 0


def test_checkpoint_resume_and_replace_cache(tmp_path, monkeypatch):
    configs = [machine_config(f"m-{m}", estimator=dict(ESTIMATOR, epochs=1)) for m in range(2)]
    calls = []
    run_bucket = bt.run_bucket
    monkeypatch.setattr(bt, "run_bucket", lambda *a, **k: calls.append(1) or run_bucket(*a, **k))
    out, register = str(tmp_path / "out"), str(tmp_path / "register")

    def build(**kwargs):
        machines, _ = _machines(configs)
        builder = bt.BatchedModelBuilder(machines, output_dir=out, model_register_dir=register,
                                         device="cpu", **kwargs)
        return builder, builder.build()

    builder, first = build()
    assert len(calls) == 1 and not builder.from_cache
    assert sorted(os.listdir(out)) == ["m-0", "m-1"]
    builder, second = build()
    assert len(calls) == 1 and builder.from_cache == ["m-0", "m-1"]
    for (model, _), (cached, machine) in zip(first, second):
        assert machine.metadata.user_defined["build-metadata"] == {"from_cache": True}
        np.testing.assert_array_equal(cached.predict(np.ones((20, 4))),
                                      model.predict(np.ones((20, 4))))
    builder, _ = build(replace_cache=True)
    assert len(calls) == 2 and not builder.from_cache


def _write_config(path, machines):
    with open(path, "w") as f:
        json.dump({"machines": machines}, f)
    return str(path)


def test_quarantine_and_exit_codes(tmp_path, capsys):
    short = machine_config("m-short", estimator=dict(ESTIMATOR, epochs=1))
    short["dataset"]["n_samples_threshold"] = 10_000  # 288 rows: too few
    good = [machine_config(f"m-{m}", estimator=dict(ESTIMATOR, epochs=1)) for m in range(2)]
    partial = _write_config(tmp_path / "partial.json", good + [short])
    assert cli.main(["batch-build", partial, str(tmp_path / "a"), "--device", "cpu"]) == 81
    err = capsys.readouterr().err
    assert ("quarantined: m-short stage=data_fetch reason=permanent_fetch_failure attempts=1 "
            "error=InsufficientDataError" in err)
    assert "InsufficientDataError" in err
    assert sorted(os.listdir(tmp_path / "a")) == ["m-0", "m-1"]

    none = _write_config(tmp_path / "none.json", [short])
    assert cli.main(["batch-build", none, str(tmp_path / "b"), "--device", "cpu"]) == 82
    # --fail-fast: the first fault stops the build with its exception's code
    assert cli.main(["batch-build", partial, str(tmp_path / "c"), "--device", "cpu",
                     "--fail-fast"]) == 80
    machines, _ = _machines(good + [short])
    with pytest.raises(ValueError, match="threshold"):
        bt.BatchedModelBuilder(machines, fail_fast=True, device="cpu").build()
    records = bt.BatchedModelBuilder(machines, device="cpu")
    records.build()
    record = records.quarantine_records[0]
    assert [r.to_dict() for r in records.quarantine_records] == [{
        "quarantined": True, "machine": "m-short", "stage": "data_fetch",
        "reason": "permanent_fetch_failure", "error": record.error, "attempts": 1,
        "host": record.host, "process_index": record.process_index}]


def test_batch_build_artifacts_are_served(tmp_path, capsys):
    tags = [f"tag-{j}" for j in range(4)]
    machines = [machine_config(f"m-{m}", estimator=dict(ESTIMATOR, epochs=1), tags=tags)
                for m in range(2)]
    machines.append(machine_config("serial", estimator=dict(ESTIMATOR, epochs=1), tags=tags,
                                   evaluation={"cv_mode": "full_build", "metrics": ["r2_score"]}))
    machines[-1]["model"]["gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector"][
        "shuffle"] = True  # the serial builder's
    config = _write_config(tmp_path / "fleet.json", machines)
    out = tmp_path / "collection" / "1"
    assert cli.main(["batch-build", config, str(out), "--device", "cpu",
                     "--project-name", "proj"]) == 0
    assert capsys.readouterr().out.count("built: ") == 3
    server = make_server("127.0.0.1", 0, device="cpu", collection_dir=str(out))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/proj"
        values = np.random.RandomState(3).rand(40, 4).tolist()
        for name in ("m-0", "serial"):
            for route, payload in (("prediction", {"X": values}),
                                   ("anomaly/prediction", {"X": values, "y": values})):
                req = urllib.request.Request(f"{url}/{name}/{route}",
                                             data=json.dumps(payload).encode(),
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as resp:
                    body = json.loads(resp.read())
                assert resp.status == 200 and len(body["data"]["model-output"]["tag-0"]) == 25
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.mark.parametrize("bh, t, dh, limit", [
    (8 * 32 * 4, 512, 64, None),          # a fleet step: 8 machines x batch 32 x 4 heads
    (8 * 1024 * 4, 512, 64, None),        # a fold predict at the serving chunk
    (2**31 // 8, 512, 64, "32-bit work counters"),
    (4, 512, 264, "head dims"),
])
def test_kernel_launch_limits_are_named(bh, t, dh, limit):
    """The flash wrappers refuse a shape the kernels cannot count before any
    launch, naming the limit; the fleet's shapes are far inside it."""
    from gordo_tpu_torch.ops.flash_attention import check_launch_limits

    if limit is None:
        check_launch_limits(bh, t, dh)
    else:
        with pytest.raises(ValueError, match=limit):
            check_launch_limits(bh, t, dh)
