"""
Temporal convolutional network factory: the port's copy of
``gordo_tpu/models/factories/tcn.py`` ``tcn_model``. Stacked causal
dilated-convolution residual blocks (dilations 1, 2, 4, ... by default), a
time pool and a Dense head.
"""

from typing import Any, Dict, Optional, Tuple

from ..spec import DenseLayer, ModelSpec, PoolLayer, TCNBlock
from .feedforward_autoencoder import _optimizer_spec


def tcn_model(
    n_features: int,
    n_features_out: int = None,
    lookback_window: int = 144,
    filters: int = 64,
    kernel_size: int = 3,
    num_blocks: int = 4,
    dilations: Optional[Tuple[int, ...]] = None,
    func: str = "relu",
    out_func: str = "linear",
    pool: str = "last",
    optimizer: str = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    compile_kwargs: Optional[Dict[str, Any]] = None,
    lookahead: int = 0,
    **kwargs,
) -> ModelSpec:
    """Windowed (many-to-one) TCN. Default dilations: 1, 2, 4, ... per block."""
    n_features_out = n_features_out or n_features
    if lookback_window < 2:
        raise ValueError(f"tcn_model requires lookback_window >= 2, got {lookback_window}")
    if dilations is None:
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        dilations = tuple(2**i for i in range(int(num_blocks)))
    elif not dilations:
        raise ValueError("dilations must be non-empty")
    layers = [TCNBlock(filters=int(filters), kernel_size=int(kernel_size), dilation=int(d),
                       activation=func) for d in dilations]
    layers.append(PoolLayer(mode=pool))
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
