"""
The port's own copies of the scikit-learn steps that the JAX package's
definitions name, each against sklearn's object (and ``InfImputer`` and
``multiply_by`` against the JAX package's) on the CPU: fitted attributes
and transforms within 1e-6 (float64 on both sides; PCA's components in
sign too), ``KFold``'s folds index for index, shuffled and not, the reprs
and the definitions the JAX package writes, and the fitted state through
the port's artifact.
"""

import re

import numpy as np
import pytest
from sklearn import decomposition, model_selection, pipeline, preprocessing

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.models.transformer_funcs.general import multiply_by as jax_multiply_by
from gordo_tpu.models.transformers.imputer import InfImputer as JaxInfImputer
from gordo_tpu_torch import serializer
from gordo_tpu_torch.models import scaler
from gordo_tpu_torch.models.anomaly.diff import KFold, TimeSeriesSplit
from gordo_tpu_torch.models.transformer_funcs.general import multiply_by
from gordo_tpu_torch.models.transformers.imputer import InfImputer
from gordo_tpu_torch.serializer.resolver import locate

TOL = dict(rtol=1e-6, atol=1e-6)  # float64 on both sides


def _repr(obj) -> str:
    """The repr without the addresses of the functions in it."""
    return re.sub(r" at 0x[0-9a-f]+>", ">", repr(obj))


def _data(seed: int = 0, n: int = 60, d: int = 5) -> np.ndarray:
    X = np.random.RandomState(seed).randn(n, d) * [1.0, 10.0, 0.1, 3.0, 50.0][:d]
    X[:, 2] = 4.0  # a constant column
    return X


STEPS = {
    "StandardScaler": ({}, preprocessing.StandardScaler, ("mean_", "var_", "scale_")),
    "StandardScaler no mean": ({"with_mean": False}, preprocessing.StandardScaler,
                               ("var_", "scale_")),
    "RobustScaler": ({}, preprocessing.RobustScaler, ("center_", "scale_")),
    "RobustScaler (10, 90) unit variance": (
        {"quantile_range": (10.0, 90.0), "unit_variance": True}, preprocessing.RobustScaler,
        ("center_", "scale_")),
    "RobustScaler no centering": ({"with_centering": False}, preprocessing.RobustScaler,
                                  ("scale_",)),
    "MinMaxScaler (-1, 1)": ({"feature_range": (-1, 1)}, preprocessing.MinMaxScaler,
                             ("min_", "scale_")),
    "PCA": ({}, decomposition.PCA, ("mean_", "components_", "explained_variance_",
                                    "explained_variance_ratio_", "singular_values_")),
    "PCA 3": ({"n_components": 3}, decomposition.PCA, ("components_", "explained_variance_")),
    "PCA 0.9 whiten": ({"n_components": 0.9, "whiten": True}, decomposition.PCA,
                       ("components_", "explained_variance_")),
}


@pytest.mark.parametrize("case", list(STEPS))
def test_step_fits_and_transforms_like_sklearn(case):
    kwargs, sk_cls, attributes = STEPS[case]
    ours = getattr(scaler, sk_cls.__name__)(**kwargs)
    theirs = sk_cls(**kwargs)
    assert repr(ours) == repr(theirs)
    assert ours.get_params() == theirs.get_params(deep=False)
    X, X_new = _data(1), _data(2)
    ours.fit(X)
    theirs.fit(X)
    for name in attributes:
        np.testing.assert_allclose(getattr(ours, name), getattr(theirs, name), **TOL,
                                   err_msg=name)
    np.testing.assert_allclose(ours.transform(X_new), theirs.transform(X_new), **TOL)


@pytest.mark.parametrize("seed", range(4))
def test_pca_components_agree_in_sign(seed):
    X = np.random.RandomState(seed).randn(40, 4) @ np.random.RandomState(seed + 10).randn(4, 4)
    ours, theirs = scaler.PCA(4).fit(X), decomposition.PCA(4).fit(X)
    np.testing.assert_allclose(ours.components_, theirs.components_, **TOL)
    assert (np.sign(ours.components_) == np.sign(theirs.components_)).all()


@pytest.mark.parametrize("kw_args", [None, {"factor": 2.5}])
def test_function_transformer_multiply_by_matches_sklearn(kw_args):
    ours = scaler.FunctionTransformer(multiply_by, kw_args=kw_args)
    theirs = preprocessing.FunctionTransformer(jax_multiply_by, kw_args=kw_args)
    X = _data(3)
    np.testing.assert_allclose(ours.fit(X).transform(X), theirs.fit(X).transform(X), **TOL)
    assert repr(scaler.FunctionTransformer()) == repr(preprocessing.FunctionTransformer())
    np.testing.assert_array_equal(scaler.FunctionTransformer().fit(X).transform(X), X)


@pytest.mark.parametrize("weights", [None, {"pca": 2.0}])
def test_feature_union_matches_sklearn(weights):
    ours = scaler.FeatureUnion([("std", scaler.StandardScaler()), ("pca", scaler.PCA(2)),
                                ("times", scaler.FunctionTransformer(multiply_by,
                                                                     kw_args={"factor": 3})),
                                ("none", "drop")], transformer_weights=weights)
    theirs = pipeline.FeatureUnion(
        [("std", preprocessing.StandardScaler()), ("pca", decomposition.PCA(2)),
         ("times", preprocessing.FunctionTransformer(jax_multiply_by, kw_args={"factor": 3})),
         ("none", "drop")], transformer_weights=weights)
    X, X_new = _data(4), _data(5)
    np.testing.assert_allclose(ours.fit(X).transform(X_new), theirs.fit(X).transform(X_new),
                               **TOL)


IMPUTER_CASES = [{}, {"strategy": "extremes"}, {"delta": 0.5},
                 {"inf_fill_value": 9.0, "neg_inf_fill_value": -9.0}]


@pytest.mark.parametrize("kwargs", IMPUTER_CASES)
def test_inf_imputer_matches_jax(kwargs):
    X = _data(6)
    X[3, 0], X[7, 1], X[9, 4] = np.inf, -np.inf, np.inf
    X_new = X.copy()
    X_new[11, 3], X_new[12, 0] = -np.inf, np.inf
    ours, theirs = InfImputer(**kwargs).fit(X), JaxInfImputer(**kwargs).fit(X)
    assert repr(ours) == repr(theirs)
    np.testing.assert_allclose(ours.transform(X_new), theirs.transform(X_new), **TOL)
    assert np.isfinite(ours.transform(X_new)).all()


KFOLD_CASES = [dict(), dict(n_splits=3), dict(shuffle=True, random_state=0),
               dict(n_splits=5, shuffle=True, random_state=42),
               dict(n_splits=4, shuffle=True, random_state=np.int64(7))]


@pytest.mark.parametrize("kwargs", KFOLD_CASES)
@pytest.mark.parametrize("n", [10, 23, 1008])
def test_kfold_folds_equal_sklearn_index_for_index(kwargs, n):
    ours, theirs = KFold(**kwargs), model_selection.KFold(**kwargs)
    assert repr(ours) == repr(theirs)
    assert ours.get_n_splits() == theirs.get_n_splits()
    pairs = list(zip(ours.split(np.zeros(n)), theirs.split(np.zeros(n))))
    assert len(pairs) == kwargs.get("n_splits", 5)
    for (train, test), (sk_train, sk_test) in pairs:
        np.testing.assert_array_equal(train, sk_train)
        np.testing.assert_array_equal(test, sk_test)


def test_kfold_refuses_like_sklearn():
    with pytest.raises(ValueError, match="random_state has no effect"):
        KFold(random_state=0)
    with pytest.raises(ValueError, match="greater than the number of samples"):
        list(KFold(5).split(np.zeros(3)))


@pytest.mark.parametrize("n_splits", [2, 3, 5])
def test_time_series_split_equals_sklearn(n_splits):
    pairs = zip(TimeSeriesSplit(n_splits).split(np.zeros(100)),
                model_selection.TimeSeriesSplit(n_splits).split(np.zeros(100)))
    for (train, test), (sk_train, sk_test) in pairs:
        np.testing.assert_array_equal(train, sk_train)
        np.testing.assert_array_equal(test, sk_test)


DEFINITIONS = [
    {"sklearn.preprocessing.StandardScaler": {"with_mean": False}},
    {"sklearn.preprocessing.RobustScaler": {"quantile_range": [10.0, 90.0]}},
    {"sklearn.decomposition.PCA": {"n_components": 2, "whiten": True}},
    {"sklearn.preprocessing.FunctionTransformer": {
        "func": "gordo.machine.model.transformer_funcs.general.multiply_by",
        "kw_args": {"factor": 2}}},
    {"gordo.machine.model.transformers.imputer.InfImputer": {"strategy": "extremes"}},
    {"sklearn.pipeline.FeatureUnion": {"transformer_list": [
        "sklearn.preprocessing.MinMaxScaler", {"sklearn.decomposition.PCA": {"n_components": 1}}]}},
    {"sklearn.pipeline.Pipeline": {"steps": [
        "gordo_tpu.models.transformers.imputer.InfImputer",
        {"sklearn.pipeline.FeatureUnion": {"transformer_list": [
            "sklearn.preprocessing.StandardScaler", "sklearn.preprocessing.RobustScaler"]}},
        "sklearn.preprocessing.MinMaxScaler"]}},
    {"sklearn.model_selection.KFold": {"n_splits": 5, "shuffle": True, "random_state": 0}},
]


@pytest.mark.parametrize("definition", DEFINITIONS)
def test_definitions_build_and_round_trip_like_jax(definition):
    ours, theirs = serializer.from_definition(definition), jax_serializer.from_definition(
        definition)
    assert _repr(ours) == _repr(theirs)
    if not isinstance(theirs, model_selection.KFold):
        written = serializer.into_definition(ours)
        assert written == jax_serializer.into_definition(theirs)
        assert _repr(serializer.from_definition(written)) == _repr(theirs)


@pytest.mark.parametrize("path, obj", [
    ("sklearn.preprocessing._data.StandardScaler", scaler.StandardScaler),
    ("sklearn.preprocessing._data.RobustScaler", scaler.RobustScaler),
    ("sklearn.preprocessing._function_transformer.FunctionTransformer",
     scaler.FunctionTransformer),
    ("sklearn.decomposition._pca.PCA", scaler.PCA),
    ("sklearn.pipeline.FeatureUnion", scaler.FeatureUnion),
    ("sklearn.model_selection._split.KFold", KFold),
    ("gordo_tpu.models.transformers.imputer.InfImputer", InfImputer),
    ("gordo_tpu.models.transformer_funcs.general.multiply_by", multiply_by),
])
def test_paths_resolve_to_the_ports_copies(path, obj):
    assert locate(path) is obj
    assert locate(path.rsplit(".", 1)[-1]) in (obj, None)


def test_fitted_steps_round_trip_through_the_artifact(tmp_path):
    """A detector over InfImputer -> FeatureUnion[StandardScaler, PCA,
    multiply_by] -> RobustScaler -> AutoEncoder: written, read back, the
    same steps with the same fitted state and the same predictions."""
    from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
    from gordo_tpu_torch.models.models import AutoEncoder

    X = np.random.RandomState(7).rand(120, 4)
    steps = [("impute", InfImputer()),
             ("union", scaler.FeatureUnion([
                 ("std", scaler.StandardScaler()), ("pca", scaler.PCA(2)),
                 ("times", scaler.FunctionTransformer(multiply_by, kw_args={"factor": 2}))])),
             ("robust", scaler.RobustScaler(quantile_range=(20.0, 80.0))),
             ("ae", AutoEncoder("feedforward_hourglass", device="cpu", epochs=1))]
    np.random.seed(0)
    detector = DiffBasedAnomalyDetector(base_estimator=scaler.Pipeline(steps)).fit(X, X)
    serializer.dump(detector, str(tmp_path / "m"), tags=["a", "b", "c", "d"])
    again = serializer.load(str(tmp_path / "m"), device="cpu")
    assert repr(again) == repr(detector)
    np.testing.assert_array_equal(again.predict(X), detector.predict(X))
    union = again.base_estimator.steps[1][1]
    np.testing.assert_array_equal(union.transformer_list[1][1].components_,
                                  steps[1][1].transformer_list[1][1].components_)
    assert union.transformer_list[2][1].func is multiply_by
    assert again.base_estimator.steps[2][1].quantile_range == (20.0, 80.0)
