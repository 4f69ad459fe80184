"""
``compute_dtype: bfloat16`` in the port against the JAX package on the CPU:

- the flash kernels' plain twins on bf16 inputs against the Pallas kernels
  in interpret mode (``_flash_forward``, and the VJP of ``flash_attention``);
- ``TransformerModel`` at bf16 against ``apply_model`` with the same
  parameters, with the flash and the plain attention;
- a few training steps of the bf16 model on both sides, from the same
  parameters in the same sample order;
- the slice as a whole: a bf16 machine config built by both builders (the
  same metadata structure, splits, offset and ``model_meta`` strings), and
  the JAX package's bf16 artifact carried across and served by both
  servers (the same blocks, model outputs within the bf16 tolerance);
- what the wrappers and the model refuse (float64, mixed dtypes; an LSTM
  layer at float16, tests/test_torch_float16.py holding the rest of
  float16);
- the bf16 kernels' arithmetic, emulated: P (or dS) split into three bf16
  parts is float32-accurate, and fewer parts are not; and the wgmma
  kernels' order of summation (truncated float32 sums, chains as deep as
  built, P and dS split by truncation) keeps the forward, dV and dQ within
  one bf16 ulp (the CUDA kernels themselves are held against the twins in
  tests/test_torch_kernels_cuda.py and chip_smoke.py).

Inputs come from numpy seeds; the JAX package's parameters go to the port
as numpy.
"""

import dataclasses
import json
import pickle
import threading
import urllib.request
from datetime import datetime, timedelta, timezone

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder import ModelBuilder as JaxModelBuilder
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.models.factories import transformer_model as jax_transformer_model
from gordo_tpu.ops import nn as jax_nn
from gordo_tpu.ops import train as jax_train
from gordo_tpu.ops.pallas_kernels.flash_attention import _flash_forward
from gordo_tpu.ops.pallas_kernels.flash_attention import flash_attention as jax_flash
from gordo_tpu.server.server import build_app
from gordo_tpu_torch import serializer
from gordo_tpu_torch.builder import ModelBuilder
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.models.models import TransformerAutoEncoder
from gordo_tpu_torch.ops import flash_attention as fa
from gordo_tpu_torch.ops import nn, train
from gordo_tpu_torch.ops.attention import dot_product_attention
from gordo_tpu_torch.serializer.from_jax import (
    detector_from_arrays,
    params_from_numpy,
    spec_from_dataclass,
)
from gordo_tpu_torch.server.server import make_server

BF16_MANTISSA = 7  # bits after the leading one
TOL_LSE = 1e-5  # float32 on both sides, sums in another order
# the bf16 model against apply_model, relative to the largest output: the
# JAX package's own bf16 tolerance (tests/gordo_tpu/test_attention_models.py);
# the two frameworks round bf16 intermediates at other places
TOL_MODEL_REL = 2e-2
SMALL = dict(n_features=4, lookback_window=32, d_model=32, num_heads=2, ff_dim=64,
             num_blocks=2)
BATCH = 8
N_SAMPLES = 45
# six bf16 Adam steps (learning rate 1e-3) from the same parameters in the
# same order. The epoch losses agree to ~4e-4 relative. Adam moves every
# parameter by ~1e-3 a step whatever its gradient's size, so where a
# gradient is near 0 the two frameworks' bf16 roundings can turn single
# updates around: parameters moved up to 6e-3 and differ by up to 3.3e-3
# (the key biases ``bk``, whose true gradient is 0, are left out as in
# tests/test_torch_train.py). The trained models' outputs are then held
# to TOL_MODEL_REL.
TOL_LOSS_REL = 5e-3
TOL_PARAM_ABS = 4e-3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run on torch's calling thread alone, as tests/test_torch_flash_attention.py
    does: torch's CPU ``exp`` on an intra-op worker thread has come out up to
    1.5e-4 off on a loaded machine (scripts/torch_cpu_exp_threads.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x|."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - BF16_MANTISSA)


def _assert_within_ulp_of_max(ours: np.ndarray, theirs: np.ndarray, name: str) -> None:
    ulp = _bf16_ulp(np.abs(theirs).max())
    err = np.abs(ours - theirs).max()
    assert err <= ulp, (name, err, ulp)


def _bf16_pair(shape, seed):
    """The same bf16 values as a JAX array and a torch tensor."""
    x = jnp.asarray(np.random.RandomState(seed).randn(*shape), jnp.float32).astype(jnp.bfloat16)
    return x, torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16()


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("causal", [False, True])
def test_plain_twins_match_the_pallas_kernels_in_bf16(causal):
    shape = (2, 2, 256, 64)
    t, dh = shape[-2:]
    (jq, q), (jk, k), (jv, v), (jg, g) = (_bf16_pair(shape, seed) for seed in range(4))
    ref_out, ref_lse = _flash_forward(*(x.reshape(-1, t, dh) for x in (jq, jk, jv)),
                                      causal, True)
    out, lse = fa.flash_attention_forward(q, k, v, causal)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _assert_within_ulp_of_max(_f32(out), _f32(ref_out).reshape(shape), "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0].reshape(shape[:-1]),
                               rtol=0, atol=TOL_LSE)

    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal, interpret=True), jq, jk, jv)
    theirs = vjp(jg)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ours = torch.autograd.grad(fa.flash_attention(*leaves, causal), leaves, g)
    for name, mine, ref in zip(("dq", "dk", "dv"), ours, theirs):
        assert mine.dtype == torch.bfloat16
        _assert_within_ulp_of_max(_f32(mine), _f32(ref), name)


def _jax_setup(attention: str, seed=0):
    spec = dataclasses.replace(jax_transformer_model(**SMALL, attention=attention),
                               compute_dtype="bfloat16")
    params = jax_nn.init_model_params(jax.random.PRNGKey(seed), spec)
    return spec, [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _port_model(jax_spec, params):
    spec = spec_from_dataclass(jax_spec)
    assert spec.compute_dtype == "bfloat16"
    return nn.TransformerModel(spec, params_from_numpy(spec, params), torch.device("cpu"))


@pytest.mark.parametrize("attention", ["flash", "xla"])
def test_transformer_model_matches_apply_model_in_bf16(attention):
    jax_spec, params = _jax_setup(attention)
    x = np.random.RandomState(1).rand(3, SMALL["lookback_window"], 4).astype(np.float32)
    ref, _ = jax_nn.apply_model(jax_spec, [{k: jnp.asarray(v) for k, v in p.items()}
                                           for p in params], jnp.asarray(x))
    model = _port_model(jax_spec, params)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    rel = np.abs(out.numpy() - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max()
    assert rel <= TOL_MODEL_REL, rel


def test_bf16_training_steps_match_jax():
    jax_spec, params = _jax_setup("flash")
    X = np.random.RandomState(0).rand(N_SAMPLES + SMALL["lookback_window"] - 1, 4)
    X = X.astype(np.float32)
    result = jax_train.fit_arrays(
        jax_spec, [{k: jnp.asarray(v) for k, v in p.items()} for p in params], X, X,
        epochs=1, batch_size=BATCH, shuffle=True, rng=jax.random.PRNGKey(1),
    )
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
    rel = np.abs(out - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max()
    assert rel <= TOL_MODEL_REL, rel


def test_bf16_estimator_trains_and_predicts_through_its_entry_points():
    rng = np.random.RandomState(2)
    X = np.sin(np.arange(80)[:, None] / (3.0 + np.arange(4))) + 0.05 * rng.randn(80, 4)
    est = TransformerAutoEncoder(lookback_window=16, d_model=16, num_heads=2, ff_dim=32,
                                 num_blocks=1, epochs=2, compute_dtype="bfloat16",
                                 device="cpu")
    np.random.seed(0)
    est.fit(X, X)
    assert est.spec_.compute_dtype == "bfloat16"
    assert all(np.isfinite(est.history["loss"]))
    pred = est.predict(X)
    assert pred.dtype == np.float32 and pred.shape == (80 - 15, 4)
    assert np.isfinite(pred).all()


TAGS = [f"tag-{i}" for i in range(4)]
BF16_MACHINE = {
    "name": "bf16-machine",
    "dataset": {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00+00:00",
                "train_end_date": "2020-01-03T00:00:00+00:00", "tags": TAGS,
                "resolution": "10min"},
    "model": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {
        "base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler",
            {"gordo_tpu.models.models.TransformerAutoEncoder": {
                "kind": "transformer_model", "lookback_window": 16, "d_model": 32,
                "num_heads": 2, "ff_dim": 32, "num_blocks": 1, "epochs": 1,
                "compute_dtype": "bfloat16"}}]}}}},
    "evaluation": {"cv_mode": "full_build", "seed": 0},
}


def _keys(tree, path=""):
    if not isinstance(tree, dict):
        return set()
    return {f"{path}/{k}" for k in tree} | {
        key for k, v in tree.items() for key in _keys(v, f"{path}/{k}")}


def _served_by_port(collection: str, path: str, payload: dict) -> dict:
    server = make_server("127.0.0.1", 0, device="cpu", collection_dir=collection)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}{path}",
            data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            return json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_bf16_slice_builds_and_serves_like_jax(tmp_path):
    model, machine = ModelBuilder(Machine.from_config(BF16_MACHINE, "proj"), device="cpu").build()
    jax_model, jax_machine = JaxModelBuilder(JaxMachine.from_config(BF16_MACHINE, "proj")).build()
    assert model.base_estimator.steps[-1][1].spec_.compute_dtype == "bfloat16"
    ours = machine.metadata.build_metadata.to_dict()
    theirs = jax_machine.metadata.build_metadata.to_dict()
    assert _keys(ours) == _keys(theirs)
    assert ours["model"]["model_offset"] == theirs["model"]["model_offset"] == 15
    splits = theirs["model"]["cross_validation"]["splits"]
    assert ours["model"]["cross_validation"]["splits"] == {
        k: v if isinstance(v, int) else str(v) for k, v in splits.items()}
    for key in ("scaler", "base_estimator"):
        assert ours["model"]["model_meta"][key] == theirs["model"]["model_meta"][key]
    assert "compute_dtype='bfloat16'" in ours["model"]["model_meta"]["base_estimator"]

    # the JAX package's bf16 artifact, carried across, served by both servers
    jax_dir, port_dir = tmp_path / "jax" / "1", tmp_path / "port" / "1"
    jax_serializer.dump(jax_model, str(jax_dir / "m"), metadata=jax_machine.to_dict())
    with open(jax_dir / "m" / "model.pkl", "rb") as f:
        carried = pickle.load(f)
    (_, in_scaler), (_, estimator) = carried.base_estimator.steps
    detector = detector_from_arrays(
        spec_from_dataclass(estimator.spec_),
        [{k: np.asarray(v) for k, v in p.items()} for p in estimator.params_],
        in_scaler.min_, in_scaler.scale_, carried.scaler.min_, carried.scaler.scale_,
        estimator_kwargs=estimator.kwargs, feature_thresholds=carried.feature_thresholds_,
        aggregate_threshold=carried.aggregate_threshold_, device="cpu")
    serializer.dump(detector, str(port_dir / "m"), tags=TAGS,
                    metadata=jax_serializer.load_metadata(str(jax_dir / "m")))
    loaded = serializer.load(str(port_dir / "m"), device="cpu")
    assert loaded.base_estimator.steps[-1][1].module_.compute_dtype == torch.bfloat16

    rng = np.random.RandomState(5)
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


def test_dispatcher_sends_bf16_to_the_flash_path():
    q, k, v = (torch.from_numpy(np.random.RandomState(s).randn(1, 2, 24, 16)).bfloat16()
               for s in range(3))
    flash = dot_product_attention(q, k, v, True, impl="auto")
    assert flash.dtype == torch.bfloat16
    torch.testing.assert_close(flash, fa.flash_attention(q, k, v, True), rtol=0, atol=0)


@pytest.mark.parametrize(
    "make",
    [
        lambda q: (q.double(),) * 3,  # float64: no kernel takes it
        lambda q: (q.bfloat16(), q, q),  # mixed dtypes
        lambda q: (q, q.bfloat16(), q.bfloat16()),
    ],
)
def test_wrappers_refuse_float16_and_mixed_dtypes(make):
    q = torch.zeros(2, 16, 16)
    with pytest.raises(TypeError, match="dtype|float32, bfloat16 or float16"):
        fa.flash_attention_forward(*make(q))


def test_backward_wrapper_refuses_mixed_dtypes():
    q = torch.zeros(2, 16, 16, dtype=torch.bfloat16)
    lse = torch.zeros(2, 16)
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention_backward(q, q, q, q.float(), lse, q)


def test_transformer_model_refuses_float16():
    """float16 runs everywhere but in an LSTM layer, whose recurrence kernel
    has no fp16 form: a spec with one is refused on the CPU too."""
    from gordo_tpu_torch.models.factories.lstm_autoencoder import lstm_model

    spec = dataclasses.replace(lstm_model(4, lookback_window=8), compute_dtype="float16")
    params = nn.init_model_params(spec, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="LSTM.*ROADMAP"):
        nn.TransformerModel(spec, params, torch.device("cpu"))
    transformer = dataclasses.replace(spec_from_dataclass(_jax_setup("flash")[0]),
                                      compute_dtype="float16")
    nn.TransformerModel(transformer, nn.init_model_params(transformer), torch.device("cpu"))


def _split(x: torch.Tensor, parts: int) -> list:
    """x (float64) as ``parts`` bf16 values, each the rest rounded to bf16:
    the split by rounding, which holds as many bits as the kernels' split by
    truncation (csrc/wgmma_bf16.cuh)."""
    out, rest = [], x
    for _ in range(parts):
        part = rest.to(torch.bfloat16).double()
        out.append(part)
        rest = rest - part
    return out


def _chip_gate(got: torch.Tensor, ref: torch.Tensor):
    """chip_smoke.py's bf16 gate: (elements more than one bf16 ulp apart,
    share of elements that differ at all)."""
    a, b = got.float(), ref.float()
    bound = 2.0 ** -BF16_MANTISSA * torch.maximum(a.abs(), b.abs()) + 1e-6
    return int(((a - b).abs() > bound).sum()), float((a != b).float().mean())


def test_three_part_split_of_p_is_float32_accurate():
    """O = P V / l with P in 1, 2 or 3 bf16 parts (the products exact, the
    sums in float64), against the float64 result, both rounded to bf16:
    three parts pass chip_smoke.py's gate, two leave elements where the sum
    cancels more than an ulp off, one moves a third of the outputs."""
    rng = np.random.RandomState(0)
    bh, t, dh = 16, 512, 64
    q, k, v = (torch.from_numpy(rng.randn(bh, t, dh)).bfloat16().double() for _ in range(3))
    s = (q @ k.transpose(-1, -2)) / dh**0.5
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), fa.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    exact = ((p @ v) / l).to(torch.bfloat16)
    gates = {n: _chip_gate((sum(part @ v for part in _split(p, n)) / l).to(torch.bfloat16),
                           exact) for n in (1, 2, 3)}
    assert gates[3][0] == 0 and gates[3][1] <= 1e-3, gates
    assert gates[2][0] > 0, gates
    assert gates[1][1] > 0.25, gates


def _truncated_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 values rounded to float32 toward zero, as the tensor core
    rounds its float32 sums."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def _bf16_truncation(x: torch.Tensor) -> torch.Tensor:
    """float32 x with its low 16 bits cleared: bf16, exact in float32."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _three_truncated_parts(x: torch.Tensor) -> list:
    """float32 x as the wgmma kernels split it (csrc/wgmma_bf16.cuh,
    ``split3``), in the order they are issued: lo, mid, hi, each a bf16
    truncation and exact in float32."""
    hi = _bf16_truncation(x)
    mid = _bf16_truncation(x - hi)
    lo = _bf16_truncation(x - hi - mid)
    assert torch.equal(hi + mid + lo, x)  # nothing is lost
    return [lo, mid, hi]


def _wgmma_chain(acc: torch.Tensor, products) -> torch.Tensor:
    """acc (float32) plus each (a, b) product in turn, a k16 step of one
    wgmma chain: products of bf16 values are exact, and every step's sum is
    truncated to float32."""
    for a, b in products:
        acc = _truncated_f32(acc.double() + a.double() @ b.double())
    return acc


def _emulated_forward(q, k, v, bn=64, rescale=8.0):
    """The bf16 forward's arithmetic (csrc/flash_attention_bf16.cu), causal:
    per 64-key tile, S as one chain over dh; the online softmax in log2
    units, its max moving only where a row of a 16-row group grows by more
    than ``rescale``; O *= the rescale, then O += P V as one chain over the
    whole loop, P in three truncated parts, lo parts first."""
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
        p = torch.exp2((s.double() * scale_log2.double() - m.double()[..., None]).float())
        p = torch.where(visible, p, 0.0)
        l = l * c + p.sum(-1)
        o = _wgmma_chain(o * c[..., None], [
            (part[..., j:j + 16], v[:, k0 + j:k0 + j + 16])
            for part in _three_truncated_parts(p) for j in range(0, bn, 16)])
    return o * (1.0 / l)[..., None]


def _emulated_dv(p, do, bq=64):
    """dK/dV's dV += P^T dO (csrc/flash_attention_bwd_bf16.cu): one chain over
    every query tile of the loop, P^T in three truncated parts, lo first."""
    bh, t, dh = do.shape
    dv = torch.zeros((bh, t, dh), dtype=torch.float32)
    pt = p.transpose(-1, -2).contiguous()
    for q0 in range(0, t, bq):
        parts = _three_truncated_parts(pt[..., q0:q0 + bq].contiguous())
        dv = _wgmma_chain(dv, [(part[..., j:j + 16], do[:, q0 + j:q0 + j + 16])
                               for part in parts for j in range(0, bq, 16)])
    return dv


def _emulated_dq(q, k, v, o, lse, do, bn=64):
    """The bf16 dQ kernel's arithmetic (csrc/flash_attention_bwd_bf16.cu),
    causal: per 64-key tile, S = Q K^T and dP = dO V^T each one chain over
    dh; P = exp2(S scale log2(e) - lse log2(e)), 0 past the diagonal;
    dS = P (dP - D) with D = rowsum(dO O) in float32; dQ += dS K as one
    chain over the whole key loop, dS in three truncated parts, lo parts
    first; dQ times the scale at the end."""
    bh, t, dh = q.shape
    scale = torch.tensor(1.0 / dh**0.5, dtype=torch.float32)
    log2e = torch.tensor(np.log2(np.e), dtype=torch.float32)
    lse2 = lse * log2e
    d = (do * o).sum(-1)
    rows = torch.arange(t)
    dq = torch.zeros((bh, t, dh), dtype=torch.float32)
    for k0 in range(0, t, bn):
        keys = slice(k0, k0 + bn)
        s, dp = (_wgmma_chain(torch.zeros((bh, t, bn)), [
            (a[..., c:c + 16], b[:, keys, c:c + 16].transpose(-1, -2)) for c in range(0, dh, 16)])
            for a, b in ((q, k), (do, v)))
        p = torch.exp2(s * (scale * log2e) - lse2[..., None])
        p = torch.where((rows[k0:k0 + bn] <= rows[:, None])[None], p, 0.0)
        ds = p * (dp - d[..., None])
        dq = _wgmma_chain(dq, [(part[..., j:j + 16], k[:, k0 + j:k0 + j + 16])
                               for part in _three_truncated_parts(ds) for j in range(0, bn, 16)])
    return dq * scale


@pytest.mark.parametrize("product", ["forward", "dv", "dq"])
def test_wgmma_accumulation_order_is_float32_accurate(product):
    """The order the wgmma kernels sum in, emulated at a small size beside
    the split emulation above: truncated float32 sums, the chains as deep as
    built (S and dP a tile, P V, P^T dO and dS K the whole loop), P and dS
    in three truncated parts. Against the float64 result, both rounded to
    bf16, it passes chip_smoke.py's gate: no element more than one ulp off,
    and at most 0.1% of them different at all (1% for dQ, chip_smoke.py's
    own share: float32 arithmetic in any order moves ~0.1% of dQ's bf16
    elements off the float64 result's)."""
    rng = np.random.RandomState(1)
    bh, t, dh = 4, 512, 64
    q, k, v, do = (torch.from_numpy(rng.randn(bh, t, dh)).bfloat16().float() for _ in range(4))
    s = (q.double() @ k.double().transpose(-1, -2)) / dh**0.5
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), fa.NEG_INF)
    p = torch.softmax(s, dim=-1)
    share_limit = 1e-3
    if product == "forward":
        got, exact = _emulated_forward(q, k, v), p @ v.double()
    elif product == "dv":
        p32 = p.float()
        got, exact = _emulated_dv(p32, do), p32.double().transpose(-1, -2) @ do.double()
    else:
        # the stored bf16 O and float32 lse, as the forward kernel leaves them
        o, lse = (x.to(dtype) for x, dtype in zip(
            fa.flash_attention_forward_plain(q.double(), k.double(), v.double(), True),
            (torch.bfloat16, torch.float32)))
        o = o.float()
        got = _emulated_dq(q, k, v, o, lse, do)
        exact = fa.flash_attention_backward_plain(
            *(x.double() for x in (q, k, v, o, lse, do)), True)[0]
        share_limit = 1e-2
    outside, share = _chip_gate(got.to(torch.bfloat16), exact.to(torch.bfloat16))
    assert outside == 0 and share <= share_limit, (outside, share)
