"""
Feedforward autoencoder factories: the port's copy of
``gordo_tpu/models/factories/feedforward_autoencoder.py`` (the same kind
names, arguments and specs). Every encoder layer but the first carries the
l1 activity penalty ``_L1_ACTIVITY`` (ops/train.py adds it to the loss).
"""

from typing import Any, Dict, Optional, Tuple

from ..spec import DenseLayer, ModelSpec, OptimizerSpec
from .utils import check_dim_func_len, hourglass_calc_dims

# keras' l1(10e-5), as the reference sets it on non-first encoder layers
_L1_ACTIVITY = 10e-5


def _optimizer_spec(optimizer, optimizer_kwargs) -> OptimizerSpec:
    if isinstance(optimizer, OptimizerSpec):
        return optimizer
    return OptimizerSpec.create(str(optimizer), optimizer_kwargs)


def feedforward_model(
    n_features: int,
    n_features_out: int = None,
    encoding_dim: Tuple[int, ...] = (256, 128, 64),
    encoding_func: Tuple[str, ...] = ("tanh", "tanh", "tanh"),
    decoding_dim: Tuple[int, ...] = (64, 128, 256),
    decoding_func: Tuple[str, ...] = ("tanh", "tanh", "tanh"),
    out_func: str = "linear",
    optimizer: str = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    compile_kwargs: Optional[Dict[str, Any]] = None,
    **kwargs,
) -> ModelSpec:
    """Fully-specified dense autoencoder (encoder dims + decoder dims)."""
    n_features_out = n_features_out or n_features
    check_dim_func_len("encoding", encoding_dim, encoding_func)
    check_dim_func_len("decoding", decoding_dim, decoding_func)
    layers = [
        DenseLayer(units=int(units), activation=activation,
                   l1_activity=0.0 if i == 0 else _L1_ACTIVITY)
        for i, (units, activation) in enumerate(zip(encoding_dim, encoding_func))
    ]
    layers += [DenseLayer(units=int(units), activation=activation)
               for units, activation in zip(decoding_dim, decoding_func)]
    layers.append(DenseLayer(units=int(n_features_out), activation=out_func))
    return ModelSpec(
        layers=tuple(layers),
        n_features=int(n_features),
        n_features_out=int(n_features_out),
        optimizer=_optimizer_spec(optimizer, optimizer_kwargs),
        loss=(compile_kwargs or {}).get("loss", "mean_squared_error"),
    )


def feedforward_symmetric(
    n_features: int,
    n_features_out: int = None,
    dims: Tuple[int, ...] = (256, 128, 64),
    funcs: Tuple[str, ...] = ("tanh", "tanh", "tanh"),
    optimizer: str = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    compile_kwargs: Optional[Dict[str, Any]] = None,
    **kwargs,
) -> ModelSpec:
    """Symmetric autoencoder: the encoder dims mirrored for the decoder."""
    if len(dims) == 0:
        raise ValueError("Parameter dims must have len > 0")
    return feedforward_model(
        n_features,
        n_features_out,
        encoding_dim=tuple(dims),
        decoding_dim=tuple(dims[::-1]),
        encoding_func=tuple(funcs),
        decoding_func=tuple(funcs[::-1]),
        optimizer=optimizer,
        optimizer_kwargs=optimizer_kwargs,
        compile_kwargs=compile_kwargs,
        **kwargs,
    )


def feedforward_hourglass(
    n_features: int,
    n_features_out: int = None,
    encoding_layers: int = 3,
    compression_factor: float = 0.5,
    func: str = "tanh",
    optimizer: str = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    compile_kwargs: Optional[Dict[str, Any]] = None,
    **kwargs,
) -> ModelSpec:
    """
    Hourglass-shaped autoencoder.

    >>> [layer.units for layer in feedforward_hourglass(10).layers]
    [8, 7, 5, 5, 7, 8, 10]
    >>> [layer.units for layer in feedforward_hourglass(10, compression_factor=0.2).layers]
    [7, 5, 2, 2, 5, 7, 10]
    >>> [layer.units for layer in feedforward_hourglass(10, encoding_layers=1).layers]
    [5, 5, 10]
    """
    dims = hourglass_calc_dims(compression_factor, encoding_layers, n_features)
    return feedforward_symmetric(
        n_features,
        n_features_out,
        dims=dims,
        funcs=tuple([func] * len(dims)),
        optimizer=optimizer,
        optimizer_kwargs=optimizer_kwargs,
        compile_kwargs=compile_kwargs,
        **kwargs,
    )
