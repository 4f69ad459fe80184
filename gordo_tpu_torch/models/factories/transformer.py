"""
Transformer anomaly-model factories: the port's copies of
``gordo_tpu/models/factories/transformer.py`` ``transformer_model`` and
``moe_transformer_model``.

Dense projection to ``d_model`` -> sinusoidal positional encoding -> N
pre-LN encoder blocks (Transformer blocks, or Switch-MoE blocks) ->
time-pool -> Dense head.
"""

from typing import Any, Dict, Optional

from ..spec import (
    DenseLayer,
    ModelSpec,
    MoEBlock,
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
    _check("transformer_model", num_blocks, lookback_window, attention)
    block = TransformerBlock(
        d_model=int(d_model),
        num_heads=int(num_heads),
        ff_dim=int(ff_dim),
        activation=func,
        causal=bool(causal),
        attention_impl=attention,
    )
    return _encoder_spec(block, num_blocks, n_features, n_features_out, lookback_window,
                         d_model, pool, out_func, optimizer, optimizer_kwargs, compile_kwargs,
                         lookahead)


def moe_transformer_model(
    n_features: int,
    n_features_out: int = None,
    lookback_window: int = 144,
    d_model: int = 64,
    num_heads: int = 4,
    num_experts: int = 8,
    expert_dim: int = 128,
    capacity_factor: float = 1.25,
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
    """Windowed Transformer encoder with Switch-style MoE FFNs: each
    token's feedforward runs on its top-1 routed expert (hard capacity,
    over-capacity tokens pass through). The load-balancing loss weight is
    the block's default (``MoEBlock.aux_loss_weight``), as in the JAX
    factory."""
    _check("moe_transformer_model", num_blocks, lookback_window, attention)
    if num_experts < 2:
        raise ValueError("num_experts must be >= 2")
    block = MoEBlock(
        d_model=int(d_model),
        num_heads=int(num_heads),
        num_experts=int(num_experts),
        expert_dim=int(expert_dim),
        capacity_factor=float(capacity_factor),
        activation=func,
        causal=bool(causal),
        attention_impl=attention,
    )
    return _encoder_spec(block, num_blocks, n_features, n_features_out, lookback_window,
                         d_model, pool, out_func, optimizer, optimizer_kwargs, compile_kwargs,
                         lookahead)


def _check(name: str, num_blocks: int, lookback_window: int, attention: str) -> None:
    if num_blocks < 1:
        raise ValueError("num_blocks must be >= 1")
    if lookback_window < 2:
        raise ValueError(f"{name} requires lookback_window >= 2, got {lookback_window}")
    if attention not in ("auto", "xla", "flash", "ring"):
        raise ValueError(
            f"attention must be one of auto|xla|flash|ring, got {attention!r}"
        )


def _encoder_spec(block, num_blocks, n_features, n_features_out, lookback_window, d_model,
                  pool, out_func, optimizer, optimizer_kwargs, compile_kwargs, lookahead
                  ) -> ModelSpec:
    """Dense projection, positional encoding, ``num_blocks`` copies of
    ``block``, the pool and the Dense head."""
    n_features_out = n_features_out or n_features
    layers = (DenseLayer(units=int(d_model), activation="linear"), PositionalEncoding(),
              *([block] * int(num_blocks)), PoolLayer(mode=pool),
              DenseLayer(units=int(n_features_out), activation=out_func))
    if not isinstance(optimizer, OptimizerSpec):
        optimizer = OptimizerSpec.create(str(optimizer), optimizer_kwargs)
    return ModelSpec(
        layers=layers,
        n_features=int(n_features),
        n_features_out=int(n_features_out),
        lookback_window=int(lookback_window),
        lookahead=int(lookahead),
        optimizer=optimizer,
        loss=(compile_kwargs or {}).get("loss", "mse"),
    )
