"""
Transformer anomaly-model factory: the port's copy of
``gordo_tpu/models/factories/transformer.py`` ``transformer_model``.

Dense projection to ``d_model`` -> sinusoidal positional encoding -> N
pre-LN encoder blocks -> time-pool -> Dense head.
"""

from typing import Any, Dict, Optional

from ..spec import (
    DenseLayer,
    ModelSpec,
    OptimizerSpec,
    PoolLayer,
    PositionalEncoding,
    TransformerBlock,
)


def transformer_model(
    n_features: int,
    n_features_out: int = None,
    lookback_window: int = 144,
    d_model: int = 64,
    num_heads: int = 4,
    ff_dim: int = 128,
    num_blocks: int = 2,
    func: str = "relu",
    out_func: str = "linear",
    causal: bool = True,
    pool: str = "last",
    attention: str = "auto",
    optimizer: str = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    compile_kwargs: Optional[Dict[str, Any]] = None,
    lookahead: int = 0,
    **kwargs,
) -> ModelSpec:
    """Windowed (many-to-one) Transformer encoder."""
    n_features_out = n_features_out or n_features
    if num_blocks < 1:
        raise ValueError("num_blocks must be >= 1")
    if lookback_window < 2:
        raise ValueError(
            f"transformer_model requires lookback_window >= 2, got {lookback_window}"
        )
    if attention not in ("auto", "xla", "flash", "ring"):
        raise ValueError(
            f"attention must be one of auto|xla|flash|ring, got {attention!r}"
        )
    layers = [
        DenseLayer(units=int(d_model), activation="linear"),
        PositionalEncoding(),
    ]
    for _ in range(int(num_blocks)):
        layers.append(
            TransformerBlock(
                d_model=int(d_model),
                num_heads=int(num_heads),
                ff_dim=int(ff_dim),
                activation=func,
                causal=bool(causal),
                attention_impl=attention,
            )
        )
    layers.append(PoolLayer(mode=pool))
    layers.append(DenseLayer(units=int(n_features_out), activation=out_func))
    if not isinstance(optimizer, OptimizerSpec):
        optimizer = OptimizerSpec.create(str(optimizer), optimizer_kwargs)
    return ModelSpec(
        layers=tuple(layers),
        n_features=int(n_features),
        n_features_out=int(n_features_out),
        lookback_window=int(lookback_window),
        lookahead=int(lookahead),
        optimizer=optimizer,
        loss=(compile_kwargs or {}).get("loss", "mse"),
    )
