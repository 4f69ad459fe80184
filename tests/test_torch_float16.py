"""
``compute_dtype: float16`` in the port against the JAX package on the CPU:

- the flash kernels' plain twins on fp16 inputs against the Pallas kernels
  in interpret mode (``_flash_forward``, and the VJP of ``flash_attention``);
- ``TransformerModel`` at fp16 against ``apply_model`` with the same
  parameters, with the flash and the plain attention;
- a few fp16 Adam steps on both sides, from the same parameters in the same
  sample order;
- ``stacked_forward`` against ``apply_model`` under a ``vmap`` over models;
- a Switch-MoE model at fp16 (dh 16, its router float32), routing compared
  first;
- the slice as a whole: a float16 machine config built by both builders,
  and the JAX package's float16 artifact carried across and served by both
  servers (the same blocks, model outputs within the fp16 tolerance);
- the dispatcher sending fp16 to the flash path, and the one float16
  configuration the port refuses (an LSTM layer);
- the fp16 kernels' arithmetic, emulated: P and dS split into three fp16
  parts after a power-of-two scale per row keep the forward, dV, dQ and dK
  within one fp16 ulp, with dO at unit scale and at 1e-4, and the same
  split without the scale does not (the CUDA kernels themselves are held
  against the twins in tests/test_torch_kernels_cuda.py and
  chip_smoke.py).

Inputs come from numpy seeds; the JAX package's parameters go to the port
as numpy. Each tolerance is stated where it is defined: fp16 keeps three
more significand bits than bf16, so each sits well inside its bf16
counterpart in tests/test_torch_bf16.py or at most equals it.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder import ModelBuilder as JaxModelBuilder
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.models.factories import transformer as jax_factories
from gordo_tpu.models.factories import transformer_model as jax_transformer_model
from gordo_tpu.ops import nn as jax_nn
from gordo_tpu.ops import train as jax_train
from gordo_tpu.ops.pallas_kernels.flash_attention import _flash_forward
from gordo_tpu.ops.pallas_kernels.flash_attention import flash_attention as jax_flash
from gordo_tpu.server.server import build_app
from gordo_tpu_torch import serializer
from gordo_tpu_torch.builder import ModelBuilder
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.models.models import LSTMAutoEncoder, TransformerAutoEncoder
from gordo_tpu_torch.ops import attention
from gordo_tpu_torch.ops import flash_attention as fa
from gordo_tpu_torch.ops import nn, train
from gordo_tpu_torch.serializer.from_jax import (
    detector_from_arrays,
    params_from_numpy,
    spec_from_dataclass,
)
from test_torch_bf16 import TAGS, _keys, _served_by_port
from test_torch_moe import jax_routing

F16_MANTISSA = 10  # bits after the leading one
TOL_LSE = 1e-5  # float32 on both sides, sums in another order
# the fp16 model against apply_model, relative to the largest output: half
# of bf16's 2e-2 (the two frameworks round fp16 intermediates at other
# places; 4.8e-3 with flash and 5.1e-3 with the plain attention measured)
TOL_MODEL_REL = 1e-2
SMALL = dict(n_features=4, lookback_window=32, d_model=32, num_heads=2, ff_dim=64,
             num_blocks=2)
BATCH = 8
N_SAMPLES = 45
# six fp16 Adam steps (learning rate 1e-3) from the same parameters in the
# same order, bf16's gates: the epoch losses agree to 1.9e-3 relative and
# the parameters (``bk`` left out: its true gradient is 0) to 2.1e-3, Adam
# turning rounding near a zero gradient into whole updates of ~1e-3; the
# trained models' outputs are then held to TOL_MODEL_REL
TOL_LOSS_REL = 5e-3
TOL_PARAM_ABS = 4e-3
# the stacked models against apply_model under vmap (1.5e-3 measured)
TOL_STACKED_REL = 5e-3
# the MoE model's untainted windows (chip_smoke.moe_compare): fp16's one
# ulp of a top logit gates a routing flip (chip_smoke.MOE_FLIP_GAP)
TOL_MOE_REL = 1e-2
# the emulated kernels against float64 rounded to fp16: chip_smoke.py's
# gate (every element within one fp16 ulp, at least fp16's least subnormal,
# plus an absolute 1e-6 times the scale of dO; at most 1% of them different
# at all)
TOL_SHARE = 1e-2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run on torch's calling thread alone, as tests/test_torch_bf16.py
    does: torch's CPU ``exp`` on an intra-op worker thread has come out up to
    1.5e-4 off on a loaded machine (scripts/torch_cpu_exp_threads.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _f16_ulp(x: float) -> float:
    """One fp16 ulp at |x| (a normal fp16 value)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - F16_MANTISSA)


def _assert_within_ulp_of_max(ours: np.ndarray, theirs: np.ndarray, name: str) -> None:
    ulp = _f16_ulp(np.abs(theirs).max())
    err = np.abs(ours - theirs).max()
    assert err <= ulp, (name, err, ulp)


def _f16_pair(shape, seed):
    """The same fp16 values as a JAX array and a torch tensor."""
    x = jnp.asarray(np.random.RandomState(seed).randn(*shape), jnp.float32).astype(jnp.float16)
    return x, torch.from_numpy(np.asarray(x.astype(jnp.float32))).half()


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("causal", [False, True])
def test_plain_twins_match_the_pallas_kernels_in_fp16(causal):
    """out, dq, dk and dv within one fp16 ulp of the largest entry, lse
    within TOL_LSE."""
    shape = (2, 2, 256, 64)
    t, dh = shape[-2:]
    (jq, q), (jk, k), (jv, v), (jg, g) = (_f16_pair(shape, seed) for seed in range(4))
    ref_out, ref_lse = _flash_forward(*(x.reshape(-1, t, dh) for x in (jq, jk, jv)),
                                      causal, True)
    out, lse = fa.flash_attention_forward(q, k, v, causal)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    _assert_within_ulp_of_max(_f32(out), _f32(ref_out).reshape(shape), "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0].reshape(shape[:-1]),
                               rtol=0, atol=TOL_LSE)

    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal, interpret=True), jq, jk, jv)
    theirs = vjp(jg)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ours = torch.autograd.grad(fa.flash_attention(*leaves, causal), leaves, g)
    for name, mine, ref in zip(("dq", "dk", "dv"), ours, theirs):
        assert mine.dtype == torch.float16
        _assert_within_ulp_of_max(_f32(mine), _f32(ref), name)


def _jax_setup(attention_impl: str, seed=0):
    spec = dataclasses.replace(jax_transformer_model(**SMALL, attention=attention_impl),
                               compute_dtype="float16")
    params = jax_nn.init_model_params(jax.random.PRNGKey(seed), spec)
    return spec, [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _port_model(jax_spec, params):
    spec = spec_from_dataclass(jax_spec)
    assert spec.compute_dtype == "float16"
    return nn.TransformerModel(spec, params_from_numpy(spec, params), torch.device("cpu"))


def _jnp(params):
    return [{k: jnp.asarray(v) for k, v in p.items()} for p in params]


def _rel(ours, theirs) -> float:
    theirs = np.asarray(theirs)
    return float(np.abs(np.asarray(ours) - theirs).max() / np.abs(theirs).max())


@pytest.mark.parametrize("attention_impl", ["flash", "xla"])
def test_transformer_model_matches_apply_model_in_fp16(attention_impl):
    jax_spec, params = _jax_setup(attention_impl)
    x = np.random.RandomState(1).rand(3, SMALL["lookback_window"], 4).astype(np.float32)
    ref, _ = jax_nn.apply_model(jax_spec, _jnp(params), jnp.asarray(x))
    model = _port_model(jax_spec, params)
    assert model.compute_dtype == torch.float16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    assert _rel(out.numpy(), ref) <= TOL_MODEL_REL


def test_fp16_training_steps_match_jax():
    jax_spec, params = _jax_setup("flash")
    X = np.random.RandomState(0).rand(N_SAMPLES + SMALL["lookback_window"] - 1, 4)
    X = X.astype(np.float32)
    result = jax_train.fit_arrays(jax_spec, _jnp(params), X, X, epochs=1, batch_size=BATCH,
                                  shuffle=True, rng=jax.random.PRNGKey(1))
    # the JAX package's epoch order (ops/train.py: split, then permutation)
    _, epoch_key = jax.random.split(jax.random.PRNGKey(1))
    order = np.array(jax.random.permutation(epoch_key, N_SAMPLES))

    model = _port_model(jax_spec, params)
    optimizer = train.make_optimizer(model.spec.optimizer, model.parameters())
    Xt = torch.from_numpy(X)
    loss, _ = train.run_epoch(model, optimizer, Xt, Xt, torch.from_numpy(order), BATCH)
    theirs = result.history["loss"][0]
    assert abs(loss - theirs) <= TOL_LOSS_REL * abs(theirs), (loss, theirs)
    for i, (mine, ref) in enumerate(zip(model.params_numpy(), result.params)):
        for name, value in ref.items():
            assert mine[name].dtype == np.float32
            if name != "bk":
                np.testing.assert_allclose(mine[name], np.asarray(value), rtol=0,
                                           atol=TOL_PARAM_ABS, err_msg=f"{i}/{name}")
    x = np.stack([X[i:i + SMALL["lookback_window"]] for i in range(3)])
    ref, _ = jax_nn.apply_model(jax_spec, result.params, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert _rel(out, ref) <= TOL_MODEL_REL


def test_stacked_forward_matches_vmapped_apply_model_in_fp16():
    jax_spec, _ = _jax_setup("flash")
    per_machine = [_jax_setup("flash", seed=10 + m)[1] for m in range(3)]
    x = np.stack([np.random.RandomState(20 + m).rand(5, SMALL["lookback_window"], 4)
                  for m in range(3)]).astype(np.float32)
    stacked = nn.stack_params(per_machine)
    theirs, _ = jax.vmap(lambda p, xm: jax_nn.apply_model(jax_spec, p, xm))(
        _jnp(stacked), jnp.asarray(x))
    with torch.no_grad():
        ours = nn.stacked_forward(spec_from_dataclass(jax_spec),
                                  [{k: torch.from_numpy(v) for k, v in p.items()}
                                   for p in stacked], torch.from_numpy(x))
    assert ours.dtype == torch.float32
    for m in range(3):
        assert _rel(ours[m].numpy(), theirs[m]) <= TOL_STACKED_REL, m


def test_moe_model_matches_apply_model_in_fp16(monkeypatch):
    """A Switch-MoE model (4 heads of dh 16, the flash path's twins;
    experts in fp16, each block's router float32 as ``apply_model`` keeps
    it): routing compared first (chip_smoke.moe_compare), then the
    untainted windows."""
    jspec = dataclasses.replace(jax_factories.moe_transformer_model(
        4, lookback_window=16, d_model=64, num_heads=4, num_experts=4, expert_dim=16,
        num_blocks=2, capacity_factor=1.25), compute_dtype="float16")
    params = [{k: np.asarray(v) for k, v in p.items()}
              for p in jax_nn.init_model_params(jax.random.PRNGKey(5), jspec)]
    x = np.random.RandomState(6).rand(8, 16, 4).astype(np.float32)
    theirs = jax_routing(jspec, params, x)
    dtypes = []
    apply_block = nn._apply_moe_block

    def recorded(layer, p, *args, **kwargs):
        dtypes.append((p["router"].dtype, p["w1"].dtype, p["wq"].dtype))
        return apply_block(layer, p, *args, **kwargs)

    monkeypatch.setattr(nn, "_apply_moe_block", recorded)
    model = nn.TransformerModel(spec_from_dataclass(jspec), params, torch.device("cpu"))
    with torch.no_grad():
        out, routing = model.forward_with_routing(torch.from_numpy(x))
    assert dtypes and all(d == (torch.float32, torch.float16, torch.float16) for d in dtypes)
    assert all(r["logits"].dtype == torch.float32 for r in routing)
    chip_smoke.moe_compare("fp16 MoE model", theirs,
                           (out.numpy(), chip_smoke._routing_numpy(routing)), 16, "float16",
                           TOL_MOE_REL)


def test_fp16_estimator_trains_and_predicts_through_its_entry_points():
    rng = np.random.RandomState(2)
    X = np.sin(np.arange(80)[:, None] / (3.0 + np.arange(4))) + 0.05 * rng.randn(80, 4)
    est = TransformerAutoEncoder(lookback_window=16, d_model=16, num_heads=2, ff_dim=32,
                                 num_blocks=1, epochs=2, compute_dtype="float16",
                                 device="cpu")
    np.random.seed(0)
    est.fit(X, X)
    assert est.spec_.compute_dtype == "float16"
    assert all(np.isfinite(est.history["loss"]))
    pred = est.predict(X)
    assert pred.dtype == np.float32 and pred.shape == (80 - 15, 4)
    assert np.isfinite(pred).all()


F16_MACHINE = {
    "name": "fp16-machine",
    "dataset": {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00+00:00",
                "train_end_date": "2020-01-03T00:00:00+00:00", "tags": TAGS,
                "resolution": "10min"},
    "model": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {
        "base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler",
            {"gordo_tpu.models.models.TransformerAutoEncoder": {
                "kind": "transformer_model", "lookback_window": 16, "d_model": 32,
                "num_heads": 2, "ff_dim": 32, "num_blocks": 1, "epochs": 1,
                "compute_dtype": "float16"}}]}}}},
    "evaluation": {"cv_mode": "full_build", "seed": 0},
}


def test_fp16_slice_builds_and_serves_like_jax(tmp_path):
    model, machine = ModelBuilder(Machine.from_config(F16_MACHINE, "proj"), device="cpu").build()
    jax_model, jax_machine = JaxModelBuilder(JaxMachine.from_config(F16_MACHINE, "proj")).build()
    assert model.base_estimator.steps[-1][1].spec_.compute_dtype == "float16"
    ours = machine.metadata.build_metadata.to_dict()
    theirs = jax_machine.metadata.build_metadata.to_dict()
    assert _keys(ours) == _keys(theirs)
    assert ours["model"]["model_offset"] == theirs["model"]["model_offset"] == 15
    splits = theirs["model"]["cross_validation"]["splits"]
    assert ours["model"]["cross_validation"]["splits"] == {
        k: v if isinstance(v, int) else str(v) for k, v in splits.items()}
    for key in ("scaler", "base_estimator"):
        assert ours["model"]["model_meta"][key] == theirs["model"]["model_meta"][key]
    assert "compute_dtype='float16'" in ours["model"]["model_meta"]["base_estimator"]

    # the JAX package's float16 artifact (float32 parameters at rest),
    # carried across as it is, served by both servers
    jax_dir, port_dir = tmp_path / "jax" / "1", tmp_path / "port" / "1"
    jax_serializer.dump(jax_model, str(jax_dir / "m"), metadata=jax_machine.to_dict())
    with open(jax_dir / "m" / "model.pkl", "rb") as f:
        carried = pickle.load(f)
    (_, in_scaler), (_, estimator) = carried.base_estimator.steps
    assert estimator.spec_.compute_dtype == "float16"
    assert all(np.asarray(v).dtype == np.float32 for p in estimator.params_ for v in p.values())
    detector = detector_from_arrays(
        spec_from_dataclass(estimator.spec_),
        [{k: np.asarray(v) for k, v in p.items()} for p in estimator.params_],
        in_scaler.min_, in_scaler.scale_, carried.scaler.min_, carried.scaler.scale_,
        estimator_kwargs=estimator.kwargs, feature_thresholds=carried.feature_thresholds_,
        aggregate_threshold=carried.aggregate_threshold_, device="cpu")
    serializer.dump(detector, str(port_dir / "m"), tags=TAGS,
                    metadata=jax_serializer.load_metadata(str(jax_dir / "m")))
    loaded = serializer.load(str(port_dir / "m"), device="cpu")
    assert loaded.base_estimator.steps[-1][1].module_.compute_dtype == torch.float16

    rng = np.random.RandomState(5)
    from datetime import datetime, timedelta, timezone

    t0 = datetime(2020, 1, 1, tzinfo=timezone.utc)
    stamps = [(t0 + timedelta(minutes=10 * i)).isoformat() for i in range(60)]
    frame = {tag: dict(zip(stamps, rng.rand(60).tolist())) for tag in TAGS}
    path = "/gordo/v0/proj/m/anomaly/prediction"
    jax_resp = build_app({"MODEL_COLLECTION_DIR": str(jax_dir)}).test_client().post(
        path, json={"X": frame, "y": frame})
    assert jax_resp.status_code == 200
    theirs = jax_resp.get_json()["data"]
    ours = _served_by_port(str(port_dir), path, {"X": frame, "y": frame})["data"]
    assert {k: sorted(v) for k, v in ours.items()} == {k: sorted(v) for k, v in theirs.items()}
    out = np.array([list(ours["model-output"][t].values()) for t in TAGS])
    ref = np.array([list(theirs["model-output"][t].values()) for t in TAGS])
    assert np.abs(out - ref).max() / np.abs(ref).max() <= TOL_MODEL_REL


def test_dispatcher_sends_fp16_to_the_flash_path(monkeypatch):
    q, k, v = (torch.from_numpy(np.random.RandomState(s).randn(1, 2, 24, 16)).half()
               for s in range(3))
    assert attention._flash_ok(q, k)
    calls = []
    plain = attention.dot_product_attention_plain
    monkeypatch.setattr(attention, "dot_product_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    flash = attention.dot_product_attention(q, k, v, True, impl="auto")
    assert flash.dtype == torch.float16 and not calls
    torch.testing.assert_close(flash, fa.flash_attention(q, k, v, True), rtol=0, atol=0)


@pytest.mark.parametrize("make", [
    lambda: LSTMAutoEncoder("lstm_model", lookback_window=8, compute_dtype="float16",
                            device="cpu", epochs=1),
    lambda: LSTMAutoEncoder("lstm_hourglass", lookback_window=4, compute_dtype="float16",
                            device="cpu", epochs=1),
])
def test_an_lstm_layer_at_float16_is_refused_by_name(make):
    """The LSTM recurrence kernel has no fp16 form: the model refuses the
    spec when it is made, on the CPU as on the card, naming ROADMAP.md."""
    X = np.random.RandomState(0).rand(40, 4).astype(np.float32)
    with pytest.raises(NotImplementedError, match="LSTM.*float16.*ROADMAP"):
        make().fit(X, X)


# --------------------------------------------------------- the fp16 split


def _truncated_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 values rounded to float32 toward zero, as the tensor core
    rounds its float32 sums."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def _wgmma_chain(acc: torch.Tensor, products) -> torch.Tensor:
    """acc (float32) plus each (a, b) product in turn, a k16 step of one
    wgmma chain: products of fp16 values are exact, and every step's sum is
    truncated to float32."""
    for a, b in products:
        acc = _truncated_f32(acc.double() + a.double() @ b.double())
    return acc


def _f16_truncation(x: torch.Tensor) -> torch.Tensor:
    """float32 x with its low 13 bits cleared (csrc/wgmma_bf16.cuh,
    ``truncate_f16``)."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _three_f16_parts(x: torch.Tensor) -> list:
    """float32 x as the fp16 kernels split it (``split3_f16``), in the order
    they are issued: lo, mid, hi, each packed to fp16 with round-to-nearest
    (torch's conversion, subnormals included) and read back."""
    hi = _f16_truncation(x)
    mid = _f16_truncation(x - hi)
    lo = x - hi - mid
    return [part.half().float() for part in (lo, mid, hi)]


def _scale_exp(m: torch.Tensor) -> torch.Tensor:
    """The biased exponent of the power of two that takes m into
    [2^14, 2^15), within [27, 227] (``f16_scale_exp``)."""
    e = (m.float().view(torch.int32) >> 23) & 0xFF
    return torch.clamp(268 - e, 27, 227)


def _pow2(b: torch.Tensor) -> torch.Tensor:
    return (b.to(torch.int32) << 23).view(torch.float32)


def _scaled_rows(x: torch.Tensor, running: torch.Tensor, acc: torch.Tensor, scaled: bool):
    """``RowScale.update`` and ``scale_rows``: the rows' running scale falls
    to the tile's where that is lower, the accumulator's rows with it.
    Returns (x scaled, the new scale, the accumulator rescaled)."""
    if not scaled:
        return x, running, acc
    new = torch.minimum(running, _scale_exp(x.abs().amax(-1)))
    acc = acc * _pow2(torch.clamp(127 + new - running, min=0))[..., None]
    return x * _pow2(new)[..., None], new, acc


def _unscaled(acc, running, scaled):
    return acc * _pow2(254 - running)[..., None] if scaled else acc


def _emulated_forward(q, k, v, bn=64, rescale=8.0, shift=7.0):
    """The fp16 forward's arithmetic (csrc/flash_attention_bf16.cu), causal:
    per 64-key tile, S one chain over dh; the online softmax in log2 units,
    its max moving only where a row of a 16-row group grows by more than
    ``rescale``; P = exp2(x - m + shift) (below 2^15); O *= the rescale,
    then O += P V as one chain over the whole loop, P in three fp16 parts,
    lo parts first."""
    bh, t, dh = q.shape
    scale_log2 = torch.tensor((1.0 / dh**0.5) * np.log2(np.e), dtype=torch.float32)
    rows = torch.arange(t)
    m = torch.full((bh, t), fa.NEG_INF, dtype=torch.float32)
    l = torch.zeros((bh, t), dtype=torch.float32)
    o = torch.zeros((bh, t, dh), dtype=torch.float32)
    for k0 in range(0, t, bn):
        keys = slice(k0, k0 + bn)
        s = _wgmma_chain(torch.zeros((bh, t, bn)), [
            (q[..., c:c + 16], k[:, keys, c:c + 16].transpose(-1, -2)) for c in range(0, dh, 16)])
        visible = (rows[k0:k0 + bn] <= rows[:, None])[None]
        s = torch.where(visible, s, fa.NEG_INF)
        mx = s.amax(-1) * scale_log2
        grow = (mx > m + rescale).view(bh, t // 16, 16).any(-1, keepdim=True)
        grow = grow.expand(bh, t // 16, 16).reshape(bh, t)
        m_new = torch.where(grow, torch.maximum(m, mx), m)
        c = torch.where(grow, torch.exp2(m - m_new), torch.ones_like(m))
        m = m_new
        p = torch.exp2((s.double() * scale_log2.double()
                        - (m.double() - shift)[..., None]).float())
        p = torch.where(visible, p, 0.0)
        l = l * c + p.sum(-1)
        o = _wgmma_chain(o * c[..., None], [
            (part[..., j:j + 16], v[:, k0 + j:k0 + j + 16])
            for part in _three_f16_parts(p) for j in range(0, bn, 16)])
    return o * (1.0 / l)[..., None]


def _emulated_dq(q, k, v, o, lse, do, scaled=True, bn=64):
    """The fp16 dQ kernel's arithmetic (csrc/flash_attention_bwd_bf16.cu),
    causal: per 64-key tile, S = Q K^T and dP = dO V^T each one chain over
    dh; P = exp2(S scale log2(e) - lse log2(e)), 0 past the diagonal;
    dS = P (dP - D) with D = rowsum(dO O) (:func:`_diagonal_d`); dQ
    += dS K as one chain over the whole key loop, dS in three fp16 parts
    after each query's running scale (``scaled``), lo parts first; dQ times
    the scale and the scale's inverse at the end."""
    bh, t, dh = q.shape
    scale = torch.tensor(1.0 / dh**0.5, dtype=torch.float32)
    log2e = torch.tensor(np.log2(np.e), dtype=torch.float32)
    d = _diagonal_d(o, do)
    rows = torch.arange(t)
    dq = torch.zeros((bh, t, dh), dtype=torch.float32)
    running = torch.full((bh, t), 227, dtype=torch.int32)
    for k0 in range(0, t, bn):
        keys = slice(k0, k0 + bn)
        s, dp = (_wgmma_chain(torch.zeros((bh, t, bn)), [
            (a[..., c:c + 16], b[:, keys, c:c + 16].transpose(-1, -2)) for c in range(0, dh, 16)])
            for a, b in ((q, k), (do, v)))
        p = torch.exp2(s * (scale * log2e) - (lse * log2e)[..., None])
        p = torch.where((rows[k0:k0 + bn] <= rows[:, None])[None], p, 0.0)
        ds, running, dq = _scaled_rows(p * (dp - d[..., None]), running, dq, scaled)
        dq = _wgmma_chain(dq, [(part[..., j:j + 16], k[:, k0 + j:k0 + j + 16])
                               for part in _three_f16_parts(ds) for j in range(0, bn, 16)])
    return _unscaled(dq, running, scaled) * scale


def _diagonal_d(o, do):
    """D = rowsum(dO O) as the fp16 kernels take it: one chain over dh on
    the tensor cores, as dP is summed."""
    return _wgmma_chain(torch.zeros(o.shape[:-1] + (1, 1)), [
        (do[..., c:c + 16].unsqueeze(-2), o[..., c:c + 16].unsqueeze(-1))
        for c in range(0, o.shape[-1], 16)])[..., 0, 0]


def _emulated_dkv(q, k, v, o, lse, do, scaled=True, bq=64):
    """The fp16 dK/dV kernel's arithmetic at dh 64, causal: per 64-query
    tile, S^T and dP^T each one chain over dh; P^T and dS^T = P^T (dP^T - D)
    (D the diagonal of O dO^T, :func:`_diagonal_d`); dV += P^T dO as one
    chain over the whole query
    loop after each key's running scale, dK += dS^T Q a tile at a time in a
    fresh chain after the tile's own scale per key, taken off as it is
    added (``scaled``); both in three fp16 parts, lo first."""
    bh, t, dh = q.shape
    scale = torch.tensor(1.0 / dh**0.5, dtype=torch.float32)
    log2e = torch.tensor(np.log2(np.e), dtype=torch.float32)
    d = _diagonal_d(o, do)
    rows = torch.arange(t)
    dk = torch.zeros((bh, t, dh), dtype=torch.float32)
    dv = torch.zeros((bh, t, dh), dtype=torch.float32)
    running = torch.full((bh, t), 227, dtype=torch.int32)
    for q0 in range(0, t, bq):
        queries = slice(q0, q0 + bq)
        st, dpt = (_wgmma_chain(torch.zeros((bh, t, bq)), [
            (a[..., c:c + 16], b[:, queries, c:c + 16].transpose(-1, -2))
            for c in range(0, dh, 16)]) for a, b in ((k, q), (v, do)))
        pt = torch.exp2(st * (scale * log2e) - (lse[:, queries] * log2e)[:, None, :])
        pt = torch.where((rows[:, None] <= rows[None, queries])[None], pt, 0.0)
        dst = pt * (dpt - d[:, None, queries])
        pts, running, dv = _scaled_rows(pt, running, dv, scaled)
        dv = _wgmma_chain(dv, [(part[..., j:j + 16], do[:, q0 + j:q0 + j + 16])
                               for part in _three_f16_parts(pts) for j in range(0, bq, 16)])
        tile = _scale_exp(dst.abs().amax(-1)) if scaled else torch.full((bh, t), 127)
        fresh = _wgmma_chain(torch.zeros((bh, t, dh)), [
            (part[..., j:j + 16], q[:, q0 + j:q0 + j + 16])
            for part in _three_f16_parts(dst * _pow2(tile)[..., None]) for j in range(0, bq, 16)])
        dk = dk + fresh * _pow2(254 - tile)[..., None]
    return dk * scale, _unscaled(dv, running, scaled)


def _chip_gate(got: torch.Tensor, ref: torch.Tensor, atol: float):
    """chip_smoke.py's fp16 gate (``_f16_gate``): (elements more than one
    fp16 ulp apart, share of elements that differ at all)."""
    a, b = got.float(), ref.float()
    bound = torch.clamp(2.0 ** -F16_MANTISSA * torch.maximum(a.abs(), b.abs()),
                        min=2.0 ** -24) + atol
    return int(((a - b).abs() > bound).sum()), float((a != b).float().mean())


def _inputs(do_scale: float, bh=4, t=512, dh=64, seed=1):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(bh, t, dh)) for _ in range(4))
    do = do * do_scale
    return [x.half().float() for x in (q, k, v, do)]


def _backward_case(do_scale: float):
    """The stored fp16 O and float32 lse, as the forward kernel leaves them,
    and the float64 plain backward on them."""
    q, k, v, do = _inputs(do_scale)
    o, lse = fa.flash_attention_forward_plain(q.double(), k.double(), v.double(), True)
    o, lse = o.half().float(), lse.float()
    exact = fa.flash_attention_backward_plain(*(x.double() for x in (q, k, v, o, lse, do)), True)
    return (q, k, v, o, lse, do), exact


def test_fp16_forward_split_is_float32_accurate():
    """The forward's P, shifted by 2^7 and split in three fp16 parts, the
    sums truncated as the tensor core truncates them: every output within
    one fp16 ulp of the float64 result rounded to fp16, at most 1% of them
    different at all."""
    q, k, v, _ = _inputs(1.0)
    s = (q.double() @ k.double().transpose(-1, -2)) / q.shape[-1] ** 0.5
    s = s.masked_fill(~torch.ones(s.shape[-1], s.shape[-1], dtype=torch.bool).tril(),
                      fa.NEG_INF)
    exact = (torch.softmax(s, dim=-1) @ v.double()).half()
    outside, share = _chip_gate(_emulated_forward(q, k, v).half(), exact, 1e-6)
    assert outside == 0 and share <= TOL_SHARE, (outside, share)


@pytest.mark.parametrize("do_scale", [1.0, 1e-4])
@pytest.mark.parametrize("product", ["dq", "dk", "dv"])
def test_scaled_fp16_split_keeps_the_backward_within_one_ulp(product, do_scale):
    """dQ, dK and dV with P and dS split after their rows' power-of-two
    scales, as the fp16 kernels run them: within one fp16 ulp of the float64
    result rounded to fp16 (plus 1e-6 times dO's scale), at most 1%
    different, with dO at unit scale and at 1e-4 (dS then lies about
    2^-13 below P, where an unscaled part would be subnormal)."""
    inputs, exact = _backward_case(do_scale)
    got = dict(zip(("dk", "dv"), _emulated_dkv(*inputs)))
    got["dq"] = _emulated_dq(*inputs)
    ref = exact[("dq", "dk", "dv").index(product)]
    outside, share = _chip_gate(got[product].half(), ref.half(), 1e-6 * do_scale)
    assert outside == 0 and share <= TOL_SHARE, (outside, share)


@pytest.mark.parametrize("product", ["dq", "dk", "dv"])
def test_unscaled_fp16_split_misses_the_gate(product):
    """The same three-part split without the scales: with dO at 1e-4, dS's
    parts fall into fp16's subnormals and dQ and dK move well over the gate;
    dV's P (at most 1) keeps its elements within one ulp at unit scale, but
    its lost low bits move more than the gate's 1% of them."""
    do_scale = 1.0 if product == "dv" else 1e-4
    inputs, exact = _backward_case(do_scale)
    if product == "dq":
        got = _emulated_dq(*inputs, scaled=False)
    else:
        got = _emulated_dkv(*inputs, scaled=False)[("dk", "dv").index(product)]
    ref = exact[("dq", "dk", "dv").index(product)]
    outside, share = _chip_gate(got.half(), ref.half(), 1e-6 * do_scale)
    if product == "dv":
        assert share > TOL_SHARE, share
    else:
        assert outside > 0 and share > 0.1, (outside, share)
