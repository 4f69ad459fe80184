"""
LSTM autoencoder/forecast factories: the port's copy of
``gordo_tpu/models/factories/lstm_autoencoder.py`` (the same kind names,
arguments and specs). A stacked LSTM encoder (every layer returning its
sequence), a stacked LSTM decoder (the last layer returning only its last
step), a Dense output; the spec carries the lookback window.
"""

from typing import Any, Dict, Optional, Tuple

from ..spec import DenseLayer, LSTMLayer, ModelSpec
from .feedforward_autoencoder import _optimizer_spec
from .utils import check_dim_func_len, hourglass_calc_dims


def lstm_model(
    n_features: int,
    n_features_out: int = None,
    lookback_window: int = 1,
    encoding_dim: Tuple[int, ...] = (256, 128, 64),
    encoding_func: Tuple[str, ...] = ("tanh", "tanh", "tanh"),
    decoding_dim: Tuple[int, ...] = (64, 128, 256),
    decoding_func: Tuple[str, ...] = ("tanh", "tanh", "tanh"),
    out_func: str = "linear",
    optimizer: str = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    compile_kwargs: Optional[Dict[str, Any]] = None,
    lookahead: int = 0,
    **kwargs,
) -> ModelSpec:
    """Fully-specified stacked-LSTM autoencoder."""
    n_features_out = n_features_out or n_features
    check_dim_func_len("encoding", encoding_dim, encoding_func)
    check_dim_func_len("decoding", decoding_dim, decoding_func)
    layers = [LSTMLayer(units=int(units), activation=activation, return_sequences=True)
              for units, activation in zip(encoding_dim, encoding_func)]
    layers += [LSTMLayer(units=int(units), activation=activation,
                         return_sequences=i != len(decoding_dim) - 1)
               for i, (units, activation) in enumerate(zip(decoding_dim, decoding_func))]
    layers.append(DenseLayer(units=int(n_features_out), activation=out_func))
    return ModelSpec(
        layers=tuple(layers),
        n_features=int(n_features),
        n_features_out=int(n_features_out),
        lookback_window=int(lookback_window),
        lookahead=int(lookahead),
        optimizer=_optimizer_spec(optimizer, optimizer_kwargs),
        loss=(compile_kwargs or {}).get("loss", "mse"),
    )


def lstm_symmetric(
    n_features: int,
    n_features_out: int = None,
    lookback_window: int = 1,
    dims: Tuple[int, ...] = (256, 128, 64),
    funcs: Tuple[str, ...] = ("tanh", "tanh", "tanh"),
    out_func: str = "linear",
    optimizer: str = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    compile_kwargs: Optional[Dict[str, Any]] = None,
    **kwargs,
) -> ModelSpec:
    """Symmetric stacked-LSTM autoencoder."""
    if len(dims) == 0:
        raise ValueError("Parameter dims must have len > 0")
    return lstm_model(
        n_features, n_features_out, lookback_window=lookback_window,
        encoding_dim=tuple(dims), decoding_dim=tuple(dims[::-1]),
        encoding_func=tuple(funcs), decoding_func=tuple(funcs[::-1]),
        out_func=out_func, optimizer=optimizer, optimizer_kwargs=optimizer_kwargs,
        compile_kwargs=compile_kwargs, **kwargs,
    )


def lstm_hourglass(
    n_features: int,
    n_features_out: int = None,
    lookback_window: int = 1,
    encoding_layers: int = 3,
    compression_factor: float = 0.5,
    func: str = "tanh",
    out_func: str = "linear",
    optimizer: str = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    compile_kwargs: Optional[Dict[str, Any]] = None,
    **kwargs,
) -> ModelSpec:
    """Hourglass-shaped stacked-LSTM autoencoder."""
    dims = hourglass_calc_dims(compression_factor, encoding_layers, n_features)
    return lstm_symmetric(
        n_features, n_features_out, lookback_window=lookback_window, dims=dims,
        funcs=tuple([func] * len(dims)), out_func=out_func, optimizer=optimizer,
        optimizer_kwargs=optimizer_kwargs, compile_kwargs=compile_kwargs, **kwargs,
    )
