"""
Declarative model specifications: the port's own copy of
``gordo_tpu/models/spec.py`` (same dataclasses, same fields and defaults),
plus the dict form the port's artifact stores them in.

``LSTMLayer``, ``TCNBlock`` and ``MoEBlock`` are kept so that any spec can
be read; applying them raises ``NotImplementedError`` (ops/nn.py).
"""

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Union


@dataclass(frozen=True)
class DenseLayer:
    units: int
    activation: str = "linear"
    l1_activity: float = 0.0


@dataclass(frozen=True)
class LSTMLayer:
    units: int
    activation: str = "tanh"
    recurrent_activation: str = "sigmoid"
    return_sequences: bool = False


@dataclass(frozen=True)
class PositionalEncoding:
    """Parameter-free sinusoidal positional encoding added to (B, T, D)."""

    max_wavelength: float = 10000.0


@dataclass(frozen=True)
class TransformerBlock:
    """Pre-LayerNorm Transformer encoder block: MHA + residual, FFN +
    residual. (B, T, d_model) in and out."""

    d_model: int
    num_heads: int = 4
    ff_dim: int = 128
    activation: str = "relu"
    causal: bool = False
    # auto | xla | flash | ring (ops/attention.py)
    attention_impl: str = "auto"
    # the port always runs the fused (d, 3d) QKV projection; the field is
    # kept so specs round-trip unchanged
    fuse_qkv: bool = True


@dataclass(frozen=True)
class MoEBlock:
    """Switch-style mixture-of-experts encoder block (not ported yet)."""

    d_model: int
    num_heads: int = 4
    num_experts: int = 8
    expert_dim: int = 128
    capacity_factor: float = 1.25
    activation: str = "relu"
    causal: bool = False
    attention_impl: str = "auto"
    fuse_qkv: bool = True
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class TCNBlock:
    """Temporal-convolutional residual block (not ported yet)."""

    filters: int
    kernel_size: int = 3
    dilation: int = 1
    activation: str = "relu"


@dataclass(frozen=True)
class PoolLayer:
    """Collapse the time axis: (B, T, D) -> (B, D). mode in {last, mean, max}."""

    mode: str = "last"


LayerSpec = Union[
    DenseLayer,
    LSTMLayer,
    PositionalEncoding,
    TransformerBlock,
    MoEBlock,
    TCNBlock,
    PoolLayer,
]

LAYER_TYPES = {
    cls.__name__: cls
    for cls in (
        DenseLayer,
        LSTMLayer,
        PositionalEncoding,
        TransformerBlock,
        MoEBlock,
        TCNBlock,
        PoolLayer,
    )
}


@dataclass(frozen=True)
class OptimizerSpec:
    name: str = "Adam"
    # a sorted tuple of (key, value) pairs, to stay hashable
    kwargs: Tuple[Tuple[str, Any], ...] = ()

    @classmethod
    def create(cls, name: str = "Adam", kwargs: Optional[Dict[str, Any]] = None):
        return cls(name=name, kwargs=tuple(sorted((kwargs or {}).items())))

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.kwargs)


@dataclass(frozen=True)
class ModelSpec:
    """An ordered tuple of layers plus IO dims, windowing and training
    configuration (same fields as the JAX package's ModelSpec)."""

    layers: Tuple[LayerSpec, ...]
    n_features: int
    n_features_out: int
    lookback_window: int = 1
    lookahead: int = 0
    optimizer: OptimizerSpec = field(default_factory=OptimizerSpec)
    loss: str = "mse"
    compute_dtype: str = "float32"
    tensor_parallel: int = 0
    remat: bool = False
    pipeline_parallel: int = 0
    expert_parallel: int = 0
    data_parallel: int = 0

    @property
    def is_recurrent(self) -> bool:
        return any(isinstance(layer, LSTMLayer) for layer in self.layers)

    @property
    def output_offset(self) -> int:
        """How many fewer rows the model outputs than it is given."""
        if self.lookback_window <= 1 and self.lookahead == 0:
            return 0
        return self.lookback_window - 1 + self.lookahead


def spec_to_dict(spec: ModelSpec) -> Dict[str, Any]:
    """JSON-safe dict form of a spec; :func:`spec_from_dict` inverts it.
    Reads only field and class names, so it takes any spec dataclass with
    this module's names (the JAX package's too)."""
    out: Dict[str, Any] = {
        "layers": [
            {"type": type(layer).__name__, **dataclasses.asdict(layer)}
            for layer in spec.layers
        ],
        "optimizer": {
            "name": spec.optimizer.name,
            "kwargs": spec.optimizer.as_dict(),
        },
    }
    for f in dataclasses.fields(spec):
        if f.name not in out:
            out[f.name] = getattr(spec, f.name)
    return out


def spec_from_dict(data: Dict[str, Any]) -> ModelSpec:
    """Inverse of :func:`spec_to_dict`. Unknown layer types or fields raise."""
    data = dict(data)
    layers = []
    for layer in data.pop("layers"):
        layer = dict(layer)
        kind = layer.pop("type")
        if kind not in LAYER_TYPES:
            raise ValueError(f"Unknown layer type {kind!r}")
        layers.append(LAYER_TYPES[kind](**layer))
    optimizer = data.pop("optimizer", None) or {}
    return ModelSpec(
        layers=tuple(layers),
        optimizer=OptimizerSpec.create(
            optimizer.get("name", "Adam"), optimizer.get("kwargs")
        ),
        **data,
    )
