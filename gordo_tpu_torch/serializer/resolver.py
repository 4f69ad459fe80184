"""
Definition paths to the port's objects: the port's counterpart of
``gordo_tpu/serializer/resolver.py``.

Definitions name classes by the JAX package's import paths
(``gordo_tpu.models.models.TransformerAutoEncoder``), by scikit-learn's
(``sklearn.pipeline.Pipeline``), by the reference's aliases
(``gordo.machine.model.anomaly.diff.DiffBasedAnomalyDetector``,
``keras.callbacks.EarlyStopping``) or by short names. The port resolves
them from a table of what it has ported; nothing is imported by path.
``locate`` returns None for a path the table lacks, and
``from_definition`` then raises ``ImportError`` naming it.
``definition_path`` is the inverse: the path the JAX package's
``into_definition`` writes for the object's counterpart.
"""

from typing import Any, Optional

from ..models.anomaly.diff import (
    DiffBasedAnomalyDetector, DiffBasedKFCVAnomalyDetector, KFold, TimeSeriesSplit,
)
from ..models.callbacks import EarlyStopping
from ..models.metrics import REGRESSION_METRICS
from ..models.models import (
    AutoEncoder, LSTMAutoEncoder, LSTMForecast, RawModelRegressor, TCNAutoEncoder, TCNForecast,
    TransformerAutoEncoder, TransformerForecast,
)
from ..models.scaler import (
    PCA, FeatureUnion, FunctionTransformer, MinMaxScaler, Pipeline, RobustScaler,
    StandardScaler,
)
from ..models.transformer_funcs.general import multiply_by
from ..models.transformers.imputer import InfImputer
from ..reporters.mlflow import MlFlowReporter
from ..reporters.postgres import PostgresReporter

# Reference-path compatibility aliases, as the JAX package has them: old
# gordo import paths to the JAX package's
GORDO_COMPAT_ALIASES = {
    "gordo.machine.model.models.KerasAutoEncoder": "gordo_tpu.models.models.AutoEncoder",
    "gordo.machine.model.models.KerasLSTMAutoEncoder": "gordo_tpu.models.models.LSTMAutoEncoder",
    "gordo.machine.model.models.KerasLSTMForecast": "gordo_tpu.models.models.LSTMForecast",
    "gordo.machine.model.models.KerasRawModelRegressor": "gordo_tpu.models.models.RawModelRegressor",
    "gordo.machine.model.anomaly.diff.DiffBasedAnomalyDetector": "gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector",
    "gordo.machine.model.anomaly.diff.DiffBasedKFCVAnomalyDetector": "gordo_tpu.models.anomaly.diff.DiffBasedKFCVAnomalyDetector",
    "gordo.machine.model.transformers.imputer.InfImputer": "gordo_tpu.models.transformers.imputer.InfImputer",
    "gordo.machine.model.transformer_funcs.general.multiply_by": "gordo_tpu.models.transformer_funcs.general.multiply_by",
    "gordo.reporters.postgres.PostgresReporter": "gordo_tpu.reporters.postgres.PostgresReporter",
    "gordo.reporters.mlflow.MlFlowReporter": "gordo_tpu.reporters.mlflow.MlFlowReporter",
    "tensorflow.keras.callbacks.EarlyStopping": "gordo_tpu.models.callbacks.EarlyStopping",
    "keras.callbacks.EarlyStopping": "gordo_tpu.models.callbacks.EarlyStopping",
}
SHORT_ALIASES = {
    "AutoEncoder": "gordo_tpu.models.models.AutoEncoder",
    "KerasAutoEncoder": "gordo_tpu.models.models.AutoEncoder",
    "LSTMAutoEncoder": "gordo_tpu.models.models.LSTMAutoEncoder",
    "KerasLSTMAutoEncoder": "gordo_tpu.models.models.LSTMAutoEncoder",
    "LSTMForecast": "gordo_tpu.models.models.LSTMForecast",
    "KerasLSTMForecast": "gordo_tpu.models.models.LSTMForecast",
    "RawModelRegressor": "gordo_tpu.models.models.RawModelRegressor",
    "KerasRawModelRegressor": "gordo_tpu.models.models.RawModelRegressor",
    "DiffBasedAnomalyDetector": "gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector",
    "DiffBasedKFCVAnomalyDetector": "gordo_tpu.models.anomaly.diff.DiffBasedKFCVAnomalyDetector",
    "InfImputer": "gordo_tpu.models.transformers.imputer.InfImputer",
    "MinMaxScaler": "sklearn.preprocessing.MinMaxScaler",
    "RobustScaler": "sklearn.preprocessing.RobustScaler",
    "StandardScaler": "sklearn.preprocessing.StandardScaler",
    "Pipeline": "sklearn.pipeline.Pipeline",
    "FeatureUnion": "sklearn.pipeline.FeatureUnion",
    "FunctionTransformer": "sklearn.preprocessing.FunctionTransformer",
    "PCA": "sklearn.decomposition.PCA",
    "TimeSeriesSplit": "sklearn.model_selection.TimeSeriesSplit",
    "KFold": "sklearn.model_selection.KFold",
}

# what the port has: the path the JAX package's into_definition writes
# first, then the other paths that reach the same object
_PORTED = (
    *((cls, (f"gordo_tpu.models.models.{cls.__name__}",))
      for cls in (AutoEncoder, RawModelRegressor, LSTMAutoEncoder, LSTMForecast,
                  TransformerAutoEncoder, TransformerForecast, TCNAutoEncoder, TCNForecast)),
    *((cls, (f"gordo_tpu.models.anomaly.diff.{cls.__name__}",))
      for cls in (DiffBasedAnomalyDetector, DiffBasedKFCVAnomalyDetector)),
    (InfImputer, ("gordo_tpu.models.transformers.imputer.InfImputer",)),
    (multiply_by, ("gordo_tpu.models.transformer_funcs.general.multiply_by",)),
    (EarlyStopping, ("gordo_tpu.models.callbacks.EarlyStopping",)),
    (PostgresReporter, ("gordo_tpu.reporters.postgres.PostgresReporter",)),
    (MlFlowReporter, ("gordo_tpu.reporters.mlflow.MlFlowReporter",)),
    (Pipeline, ("sklearn.pipeline.Pipeline",)),
    (FeatureUnion, ("sklearn.pipeline.FeatureUnion",)),
    *((cls, (f"sklearn.preprocessing._data.{cls.__name__}",
             f"sklearn.preprocessing.{cls.__name__}"))
      for cls in (MinMaxScaler, StandardScaler, RobustScaler)),
    (FunctionTransformer, ("sklearn.preprocessing._function_transformer.FunctionTransformer",
                           "sklearn.preprocessing.FunctionTransformer")),
    (PCA, ("sklearn.decomposition._pca.PCA", "sklearn.decomposition.PCA")),
    *((cls, (f"sklearn.model_selection._split.{cls.__name__}",
             f"sklearn.model_selection.{cls.__name__}"))
      for cls in (TimeSeriesSplit, KFold)),
    *((func, (f"sklearn.metrics._regression.{name}", f"sklearn.metrics.{name}"))
      for name, func in REGRESSION_METRICS.items()),
)
TABLE = {path: obj for obj, paths in _PORTED for path in paths}
_PATHS = {obj: paths[0] for obj, paths in _PORTED}


def canonical_path(path: str) -> str:
    return GORDO_COMPAT_ALIASES.get(path) or SHORT_ALIASES.get(path) or path


def locate(path: str) -> Optional[Any]:
    """The port's class or function for a definition path, or None."""
    return TABLE.get(canonical_path(path))


def definition_path(obj) -> str:
    """The path a definition names ``obj`` (a class or function) by."""
    return _PATHS.get(obj) or f"{obj.__module__}.{obj.__qualname__}"
