"""
The port's serving slice end to end: a small Transformer detector built by
the JAX package is carried into a port artifact, and the same anomaly
request goes to the JAX server and to the port's server on the CPU. Also:
the port's frames, smoothing and scaler against pandas/sklearn, its
artifact round trip, its request errors, and its import boundary (no JAX,
nothing of gordo_tpu, none of pandas/sklearn/werkzeug/yaml).
"""

import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

import numpy as np
import pandas as pd
import pytest
import torch

import gordo_tpu_torch
from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder.local_build import local_build
from gordo_tpu.models import utils as jax_utils
from gordo_tpu.server.server import build_app
from gordo_tpu.server.utils import dataframe_to_dict
from gordo_tpu_torch import serializer
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector, _ewm_mean, _rolling
from gordo_tpu_torch.models.scaler import MinMaxScaler
from gordo_tpu_torch.models.utils import RawFrame
from gordo_tpu_torch.serializer.from_jax import detector_from_arrays, spec_from_dataclass
from gordo_tpu_torch.server.server import make_server

# float32 model on both sides; the two frameworks sum in different orders
TOL = dict(atol=1e-5, rtol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "tf-machine"
CONFIG = f"""
machines:
  - name: {NAME}
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
        window: 6
        base_estimator:
          sklearn.pipeline.Pipeline:
            steps:
            - sklearn.preprocessing.MinMaxScaler
            - gordo_tpu.models.models.TransformerAutoEncoder:
                kind: transformer_model
                lookback_window: 16
                d_model: 32
                num_heads: 2
                ff_dim: 64
                num_blocks: 2
                epochs: 1
"""


def _port_from_jax_artifact(jax_dir: str, port_dir: str) -> None:
    """Unpickle a JAX artifact and write the port's artifact of it."""
    with open(os.path.join(jax_dir, "model.pkl"), "rb") as f:
        jax_model = pickle.load(f)
    metadata = jax_serializer.load_metadata(jax_dir)
    (_, in_scaler), (_, estimator) = jax_model.base_estimator.steps
    spec = spec_from_dataclass(estimator.spec_)
    detector = detector_from_arrays(
        spec,
        [{k: np.asarray(v) for k, v in p.items()} for p in estimator.params_],
        in_scaler.min_, in_scaler.scale_,
        jax_model.scaler.min_, jax_model.scaler.scale_,
        estimator=type(estimator).__name__,
        estimator_kwargs=estimator.kwargs,
        feature_thresholds=np.asarray(jax_model.feature_thresholds_),
        aggregate_threshold=jax_model.aggregate_threshold_,
        require_thresholds=jax_model.require_thresholds,
        window=jax_model.window,
        smoothing_method=jax_model.smoothing_method,
        device="cpu",
    )
    tags = [t["name"] for t in metadata["dataset"]["tags"]]
    serializer.dump(detector, port_dir, tags=tags, metadata=metadata)


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    """(JAX collection dir, port collection dir), one revision each."""
    root = tmp_path_factory.mktemp("slice")
    jax_coll, port_coll = root / "jax" / "111", root / "port" / "111"
    (model, machine), = local_build(CONFIG)
    jax_serializer.dump(model, str(jax_coll / NAME), metadata=machine.to_dict())
    _port_from_jax_artifact(str(jax_coll / NAME), str(port_coll / NAME))
    return str(jax_coll), str(port_coll)


@pytest.fixture(scope="module")
def port_url(collections):
    server = make_server("127.0.0.1", 0, device="cpu", collection_dir=collections[1])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(url: str, payload) -> tuple:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _payload(n_rows=60, seed=0):
    rng = np.random.RandomState(seed)
    t0 = datetime(2020, 1, 1, tzinfo=timezone.utc)
    stamps = [(t0 + timedelta(minutes=10 * i)).isoformat() for i in range(n_rows)]
    frame = lambda: {  # noqa: E731
        f"tag-{j}": dict(zip(stamps, rng.rand(n_rows).tolist())) for j in range(4)
    }
    return {"X": frame(), "y": frame()}


def _assert_same_data(ours: dict, theirs: dict) -> None:
    assert sorted(ours) == sorted(theirs)
    for top in theirs:
        assert sorted(ours[top]) == sorted(theirs[top]), top
        for sub, column in theirs[top].items():
            assert list(ours[top][sub]) == list(column), (top, sub)
            for key, value in column.items():
                mine = ours[top][sub][key]
                if isinstance(value, float):
                    assert math.isclose(mine, value, rel_tol=1e-5, abs_tol=1e-5), (
                        top, sub, key, mine, value)
                else:
                    assert mine == value, (top, sub, key)


@pytest.mark.parametrize("query", ["", "?all_columns"])
def test_port_server_answers_like_jax_server(collections, port_url, query):
    path = f"/gordo/v0/proj/{NAME}/anomaly/prediction{query}"
    payload = _payload()
    jax_resp = build_app({"MODEL_COLLECTION_DIR": collections[0]}).test_client().post(
        path, json=payload
    )
    assert jax_resp.status_code == 200
    theirs = jax_resp.get_json()
    status, ours = _post(port_url + path, payload)
    assert status == 200
    assert ours["revision"] == theirs["revision"] == "111"
    assert set(ours) == set(theirs)
    assert any(top.startswith("smooth-") for top in ours["data"]) == bool(query)
    _assert_same_data(ours["data"], theirs["data"])


def test_port_server_errors_and_routes(port_url):
    path = f"{port_url}/gordo/v0/proj/{NAME}/anomaly/prediction"
    payload = _payload(40)
    assert _post(path, {"X": payload["X"]})[0] == 400  # no y
    assert _post(path, {"y": payload["y"]})[0] == 400  # no X
    bad = {"X": {"tag-0": payload["X"]["tag-0"]}, "y": payload["y"]}
    assert _post(path, bad)[0] == 400  # wrong columns
    assert _post(path, {"X": {"t": {"not-a-time": 1.0}}, "y": payload["y"]})[0] == 400
    status, body = _post(path, {"X": [[0.5] * 4] * 40, "y": [[0.5] * 4] * 40})
    assert status == 200 and list(body["data"]["model-output"]["tag-0"])[0] == "15"
    assert _post(f"{port_url}/gordo/v0/proj/nope/anomaly/prediction", payload)[0] == 404
    with urllib.request.urlopen(f"{port_url}/healthcheck", timeout=10) as resp:
        assert resp.status == 200
    with urllib.request.urlopen(f"{port_url}/gordo/v0/proj/{NAME}/metadata") as resp:
        meta = json.loads(resp.read())
    assert meta["metadata"]["name"] == NAME and meta["revision"] == "111"


def _get(url: str, headers=None) -> tuple:
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), resp.headers.get("revision")
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read()), err.headers.get("revision")


def _sibling_revision(collections, revision: str, model_meta=None):
    """Copy both collections to a sibling revision directory. With
    ``model_meta``, both get the JAX artifact's metadata.json with it merged
    into the build metadata, so that both servers read the same file."""
    siblings = [os.path.join(os.path.dirname(c), revision) for c in collections]
    for current, sibling in zip(collections, siblings):
        shutil.rmtree(sibling, ignore_errors=True)
        shutil.copytree(current, sibling)
    if model_meta is not None:
        with open(os.path.join(collections[0], NAME, "metadata.json")) as f:
            metadata = json.load(f)
        metadata["metadata"]["build_metadata"]["model"]["model_meta"].update(model_meta)
        for sibling in siblings:
            with open(os.path.join(sibling, NAME, "metadata.json"), "w") as f:
                json.dump(metadata, f)  # NaN as the port's serializer writes it
    return siblings


def _jax_get(collection: str, path: str, headers=None) -> tuple:
    resp = build_app({"MODEL_COLLECTION_DIR": collection}).test_client().get(
        path, headers=headers or {})
    return resp.status_code, resp.get_json(), resp.headers.get("revision")


def test_metadata_with_nan_thresholds_is_answered_like_jax(collections, port_url,
                                                          monkeypatch):
    """NaN in the metadata (smooth thresholds of a fold shorter than the
    window) is answered 200 with null, as the JAX server's ``json_body``
    writes it (simplejson's ``ignore_nan``). The port's serializer writes
    NaN into metadata.json; the JAX package's simplejson neither writes
    nor reads NaN, so its server reads the file here as Python's json
    does, which hands the NaN to its encoder."""
    from gordo_tpu.server import utils as jax_server_utils

    def load_metadata(directory):
        with open(os.path.join(directory, "metadata.json")) as f:
            return json.load(f)

    monkeypatch.setattr(jax_server_utils.serializer, "load_metadata", load_metadata)
    nan = float("nan")
    _sibling_revision(collections, "333", {"smooth-aggregate-threshold": nan,
                                           "smooth-feature-thresholds": [nan, 1.0, nan, 2.0]})
    path = f"/gordo/v0/proj/{NAME}/metadata?revision=333"
    status, theirs, _ = _jax_get(collections[0], path)
    mine_status, ours, revision = _get(port_url + path)
    assert status == mine_status == 200 and revision == "333"
    meta = ours["metadata"]["metadata"]["build_metadata"]["model"]["model_meta"]
    assert meta["smooth-aggregate-threshold"] is None
    assert meta["smooth-feature-thresholds"] == [None, 1.0, None, 2.0]
    assert ours["metadata"] == theirs["metadata"]
    assert ours["revision"] == theirs["revision"] == "333"


@pytest.mark.parametrize("how", ["query", "header"])
def test_revisions_are_served_or_gone_like_jax(collections, port_url, how):
    # revision 222 holds one metadata file in both trees, marked as its own
    _sibling_revision(collections, "222", {"revision-marker": "222"})
    for revision, expected in (("222", 200), ("111", 200), ("nope", 410), ("..", 410)):
        path = f"/gordo/v0/proj/{NAME}/metadata"
        if how == "query":
            path, headers = f"{path}?revision={revision}", None
        else:
            headers = {"revision": revision}
        theirs = _jax_get(collections[0], path, headers)
        ours = _get(port_url + path, headers)
        assert ours[0] == theirs[0] == expected, (revision, ours, theirs)
        assert ours[2] == theirs[2] == revision  # the revision header
        if expected == 410:
            assert ours[1] == theirs[1] == {"error": f"Revision '{revision}' not found."}
        else:
            assert ours[1]["revision"] == theirs[1]["revision"] == revision
            meta = ours[1]["metadata"]["metadata"]["build_metadata"]["model"]["model_meta"]
            assert ("revision-marker" in meta) == (revision == "222")
            if revision == "222":
                assert ours[1]["metadata"] == theirs[1]["metadata"]
    # a prediction from the pinned revision
    path = f"/gordo/v0/proj/{NAME}/anomaly/prediction?revision=222"
    status, body = _post(port_url + path, _payload())
    assert status == 200 and body["revision"] == "222"


def test_unhandled_error_is_answered_like_jax(collections, port_url):
    """Fewer rows than the lookback window: the predict raises on both
    sides, and both answer the generic 500 without a revision key."""
    path = f"/gordo/v0/proj/{NAME}/anomaly/prediction"
    payload = _payload(10)
    jax_resp = build_app({"MODEL_COLLECTION_DIR": collections[0]}).test_client().post(
        path, json=payload)
    status, body = _post(port_url + path, payload)
    assert status == jax_resp.status_code == 500
    assert body == jax_resp.get_json() == {"error": "Internal server error"}


def test_artifact_round_trip_keeps_predictions(collections, tmp_path):
    detector = serializer.load(os.path.join(collections[1], NAME), device="cpu")
    X = np.random.RandomState(1).rand(50, 4)
    serializer.dump(detector, str(tmp_path / "m"), tags=["a", "b", "c", "d"])
    again = serializer.load(str(tmp_path / "m"), device="cpu")
    np.testing.assert_array_equal(
        again.base_estimator.predict(X), detector.base_estimator.predict(X)
    )
    assert again.window == 6 and again.aggregate_threshold_ == detector.aggregate_threshold_


@pytest.mark.parametrize("window", [1, 4, 200])
def test_rolling_and_ewm_match_pandas(window):
    values = np.random.RandomState(2).rand(50, 3)
    frame = pd.DataFrame(values)
    np.testing.assert_allclose(
        _rolling(values, window, np.median), frame.rolling(window).median().to_numpy()
    )
    np.testing.assert_allclose(
        _rolling(values, window, np.mean), frame.rolling(window).mean().to_numpy(),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        _ewm_mean(values, window), frame.ewm(span=window).mean().to_numpy(), rtol=1e-12
    )


def test_raw_frame_to_dict_is_dataframe_to_dict():
    t0 = datetime(2020, 1, 1, tzinfo=timezone.utc)
    index = [t0 + timedelta(minutes=10 * i) for i in range(3)]
    groups = [("model-output", ["a", "b"], np.arange(6.0).reshape(3, 2)),
              ("total", ("",), np.array([[1.0], [np.nan], [3.0]]))]
    theirs = dataframe_to_dict(
        jax_utils.RawFrame(groups, pd.DatetimeIndex(index), timedelta(minutes=10)).to_pandas()
    )
    ours = RawFrame(groups, index, timedelta(minutes=10)).to_dict()
    theirs["total"][""] = {k: (None if v != v else v) for k, v in theirs["total"][""].items()}
    assert ours == theirs


def test_minmax_scaler_matches_sklearn():
    from sklearn.preprocessing import MinMaxScaler as SkMinMaxScaler

    X = np.random.RandomState(3).randn(30, 4)
    X[:, 2] = 7.0  # a constant column
    ours, theirs = MinMaxScaler().fit(X), SkMinMaxScaler().fit(X)
    np.testing.assert_allclose(ours.scale_, theirs.scale_)
    np.testing.assert_allclose(ours.min_, theirs.min_)
    np.testing.assert_allclose(ours.transform(X), theirs.transform(X))


def test_require_thresholds_without_thresholds_raises():
    detector = DiffBasedAnomalyDetector(base_estimator=None, scaler=MinMaxScaler())
    with pytest.raises(AttributeError, match="require_thresholds"):
        detector.anomaly_raw(None, None)


def test_resolve_device_defaults_to_cuda_and_never_falls_back():
    assert gordo_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert gordo_tpu_torch.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            gordo_tpu_torch.resolve_device()


def test_port_imports_no_jax_and_nothing_of_gordo_tpu():
    code = """
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "pandas", "sklearn", "werkzeug", "yaml", "prometheus_client"):
    sys.modules[blocked] = None
import gordo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gordo_tpu_torch.__path__, "gordo_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the fleet trainer, the serving batcher and codec and the native library,
# and the CLI's fleet and server commands, as they load
import gordo_tpu_torch.parallel.batch_trainer
import gordo_tpu_torch.workflow.normalized_config
import gordo_tpu_torch.server.batcher
import gordo_tpu_torch.server.fast_codec
import gordo_tpu_torch.native
# the socket fast lane and the OpenAPI document
import gordo_tpu_torch.server.fastlane
import gordo_tpu_torch.server.openapi
# the feedforward family, the KFCV detector and the sklearn steps' copies
import gordo_tpu_torch.models.factories.feedforward_autoencoder
import gordo_tpu_torch.models.transformers.imputer
import gordo_tpu_torch.models.transformer_funcs.general
from gordo_tpu_torch.models.anomaly.diff import DiffBasedKFCVAnomalyDetector, KFold
from gordo_tpu_torch.models.models import AutoEncoder, RawModelRegressor
from gordo_tpu_torch.models.scaler import PCA, FeatureUnion, RobustScaler, StandardScaler
# the LSTM and TCN families and the LSTM recurrence's kernel wrappers
import gordo_tpu_torch.ops.activations
import gordo_tpu_torch.ops.lstm
import gordo_tpu_torch.models.factories.lstm_autoencoder
import gordo_tpu_torch.models.factories.tcn
from gordo_tpu_torch.models.models import LSTMAutoEncoder, LSTMForecast, TCNAutoEncoder, TCNForecast
# the telemetry plane: spans, catalog, traces, logs, flight recorder, SLOs,
# shards, device telemetry, profiler, FLOPs, torch.profiler hookup,
# /metrics without prometheus_client, and /debug/*
from gordo_tpu_torch.observability import (
    device, flight, latency, logs, metrics, profiler, shared, slo, telemetry, tracing)
import gordo_tpu_torch.ops.flops
import gordo_tpu_torch.util.profiling
import gordo_tpu_torch.server.prometheus.metrics
import gordo_tpu_torch.server.debug
from gordo_tpu_torch import cli
for argv in (["batch-build", "fleet.json", "out", "--device", "cpu", "--fail-fast"],
             ["batch-build", "fleet.json", "out", "--trace-file", "t.json",
              "--metrics-file", "m.prom"],
             ["run-server", "--port", "5555", "--device", "cpu"],
             ["run-server", "--no-batch-predicts"]):
    assert cli._parser().parse_args(argv).command == argv[0]
assert cli._parser().parse_args(["run-server"]).batch_predicts is True
assert cli._parser().parse_args(["run-server", "--no-batch-predicts"]).batch_predicts is False
import chip_smoke
leaked = [m for m in sys.modules if m == "gordo_tpu" or m.startswith("gordo_tpu.")]
assert not leaked, leaked
print(len(names))
"""
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert result.returncode == 0, result.stderr
    assert int(result.stdout.split()[-1]) >= 64
