"""
Layer init/apply in PyTorch: the port's counterpart of
``gordo_tpu/ops/nn.py`` for the layers of the Transformer family (Dense,
positional encoding, pre-LN Transformer block, pooling), at the spec's
``compute_dtype``: float32 or bfloat16.

Parameters use the JAX package's layout: one dict per layer, keyed as
there (``kernel``/``bias`` for Dense; ``ln1_scale``, ``wq`` ... ``b_ff2``
for a Transformer block), so weights carry across unchanged
(serializer/from_jax.py). :class:`TransformerModel` holds them on the
device and runs the forward pass, the counterpart of ``apply_model``.
:class:`StackedTransformerModel` holds M machines' parameters of one spec
with a leading machine axis and runs them as one model, the counterpart of
``apply_model`` under the fleet trainer's ``vmap`` over machines. The
layers take any leading axes before (time, features).
"""

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.spec import (
    DenseLayer,
    LSTMLayer,
    MoEBlock,
    ModelSpec,
    PoolLayer,
    PositionalEncoding,
    TCNBlock,
    TransformerBlock,
)
from .attention import multihead_attention

Params = List[Dict[str, torch.Tensor]]

ACTIVATIONS = {
    "linear": lambda x: x,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    "selu": F.selu,
    "softplus": F.softplus,
    "softsign": F.softsign,
    "swish": F.silu,
    # jax.nn.gelu is the tanh approximation by default
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "exponential": torch.exp,
    "hard_sigmoid": lambda x: F.relu6(x + 3.0) / 6.0,
}

# the compute dtypes the port runs; the parameters stay float32 at rest
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# layers the port cannot run yet, with the ROADMAP.md queue A item they wait for
NOT_PORTED = {
    LSTMLayer: "the LSTM/TCN families item",
    TCNBlock: "the LSTM/TCN families item",
    MoEBlock: "the MoE item",
}


def _activation(name: str):
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"Unknown activation {name!r}; available: {sorted(ACTIVATIONS)}"
        ) from None


def _not_ported(layer) -> NotImplementedError:
    return NotImplementedError(
        f"{type(layer).__name__} is not ported yet: see "
        f"{NOT_PORTED[type(layer)]} of ROADMAP.md queue A"
    )


def _glorot_uniform(generator, shape) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -limit, limit, generator=generator
    )


def _init_transformer_block(generator, in_dim: int, layer: TransformerBlock):
    if in_dim != layer.d_model:
        raise ValueError(
            f"TransformerBlock d_model={layer.d_model} but incoming dim is "
            f"{in_dim}; insert a Dense projection first"
        )
    d, ff = layer.d_model, layer.ff_dim
    zeros = lambda n: torch.zeros(n, dtype=torch.float32)  # noqa: E731
    return {
        "ln1_scale": torch.ones(d),
        "ln1_bias": zeros(d),
        "wq": _glorot_uniform(generator, (d, d)),
        "wk": _glorot_uniform(generator, (d, d)),
        "wv": _glorot_uniform(generator, (d, d)),
        "wo": _glorot_uniform(generator, (d, d)),
        "bq": zeros(d),
        "bk": zeros(d),
        "bv": zeros(d),
        "bo": zeros(d),
        "ln2_scale": torch.ones(d),
        "ln2_bias": zeros(d),
        "w_ff1": _glorot_uniform(generator, (d, ff)),
        "b_ff1": zeros(ff),
        "w_ff2": _glorot_uniform(generator, (ff, d)),
        "b_ff2": zeros(d),
    }


def init_model_params(spec: ModelSpec, generator: torch.Generator = None) -> Params:
    """Parameters for a spec, on the CPU: glorot-uniform kernels and zero
    biases, as the JAX package draws them (the same distributions and
    shapes, not the same numbers)."""
    params: Params = []
    in_dim = spec.n_features
    for layer in spec.layers:
        if isinstance(layer, DenseLayer):
            params.append({
                "kernel": _glorot_uniform(generator, (in_dim, layer.units)),
                "bias": torch.zeros(layer.units, dtype=torch.float32),
            })
            in_dim = layer.units
        elif isinstance(layer, TransformerBlock):
            params.append(_init_transformer_block(generator, in_dim, layer))
        elif isinstance(layer, (PositionalEncoding, PoolLayer)):
            params.append({})
        elif type(layer) in NOT_PORTED:
            raise _not_ported(layer)
        else:
            raise TypeError(f"Unknown layer spec: {layer!r}")
    return params


def _apply_dense(layer: DenseLayer, p, x):
    return _activation(layer.activation)(torch.matmul(x, p["kernel"]) + p["bias"])


def _layer_norm(x, scale, bias, eps: float = 1e-6):
    """Biased variance and eps 1e-6, as the JAX package (torch's LayerNorm
    defaults to 1e-5)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _apply_positional_encoding(layer: PositionalEncoding, x):
    """x: (..., time, d). The JAX package's sinusoid, added to x: its
    frequencies are exp(-log(max_wavelength) * i / max(half - 1, 1))."""
    t, d = x.shape[-2:]
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
    half = (d + 1) // 2
    log_wavelength = torch.log(torch.tensor(layer.max_wavelength, dtype=torch.float32))
    freqs = torch.exp(
        -log_wavelength.to(x.device)
        * torch.arange(half, dtype=torch.float32, device=x.device)
        / max(half - 1, 1)
    )[None, :]
    angles = pos * freqs
    pe = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    pe[:, 0::2] = torch.sin(angles)[:, : (d + 1) // 2]
    pe[:, 1::2] = torch.cos(angles)[:, : d // 2]
    return x + pe


def _attention_sublayer(layer, p, x):
    """Pre-LN multi-head attention + residual, with one fused (d, 3d) QKV
    projection (the params stay separate, as in the artifact)."""
    h = _layer_norm(x, p["ln1_scale"], p["ln1_bias"])
    w_qkv = torch.cat([p["wq"], p["wk"], p["wv"]], dim=-1)
    b_qkv = torch.cat([p["bq"], p["bk"], p["bv"]], dim=-1)
    q, k, v = torch.chunk(torch.matmul(h, w_qkv) + b_qkv, 3, dim=-1)
    attn = multihead_attention(
        q, k, v, layer.num_heads, causal=layer.causal, impl=layer.attention_impl
    )
    return x + torch.matmul(attn, p["wo"]) + p["bo"]


def _apply_transformer_block(layer: TransformerBlock, p, x):
    """Pre-LN encoder block. x: (..., time, d_model)."""
    x = _attention_sublayer(layer, p, x)
    h = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
    ff = _activation(layer.activation)(torch.matmul(h, p["w_ff1"]) + p["b_ff1"])
    return x + torch.matmul(ff, p["w_ff2"]) + p["b_ff2"]


def _apply_pool(layer: PoolLayer, x):
    if layer.mode == "last":
        return x[..., -1, :]
    if layer.mode == "mean":
        return x.mean(dim=-2)
    if layer.mode == "max":
        return x.amax(dim=-2)
    raise ValueError(f"Unknown pool mode {layer.mode!r}")


class TransformerModel(nn.Module):
    """A spec of Dense / PositionalEncoding / TransformerBlock / PoolLayer
    layers with its parameters resident on ``device``; ``forward`` is the
    counterpart of ``apply_model``'s output (float32). The parameters are
    float32 and trainable (ops/train.py); serving runs under
    ``torch.inference_mode``.

    Under ``compute_dtype: bfloat16`` each forward casts the input and every
    parameter to bf16, as ``apply_model`` does, so every layer, the
    attention kernels included, runs in bf16; autograd takes the gradients
    back through the casts to the float32 parameters, as the JAX package's
    gradient of its cast does. The output is cast to float32."""

    def __init__(self, spec: ModelSpec, params, device: torch.device):
        super().__init__()
        if spec.compute_dtype not in COMPUTE_DTYPES:
            raise NotImplementedError(
                f"compute_dtype {spec.compute_dtype!r} is not ported yet: see "
                f"the float16 item of ROADMAP.md queue A"
            )
        self.compute_dtype = COMPUTE_DTYPES[spec.compute_dtype]
        for layer in spec.layers:
            if type(layer) in NOT_PORTED:
                raise _not_ported(layer)
        if len(params) != len(spec.layers):
            raise ValueError(
                f"{len(params)} parameter dicts for {len(spec.layers)} layers"
            )
        self.spec = spec
        self.layer_params = nn.ModuleList(
            nn.ParameterDict({
                # a copy: training updates it in place, never the caller's array
                name: nn.Parameter(
                    torch.as_tensor(value, dtype=torch.float32).detach().clone()
                )
                for name, value in p.items()
            })
            for p in params
        )
        self.to(device)

    def _layer(self, p, ndim: int) -> Dict[str, torch.Tensor]:
        """A layer's parameters as the forward takes them at an input of
        ``ndim`` dims: cast to the compute dtype."""
        return {name: value.to(self.compute_dtype) for name, value in p.items()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x.to(self.compute_dtype)
        for layer, p in zip(self.spec.layers, self.layer_params):
            p = self._layer(p, out.dim())
            if isinstance(layer, DenseLayer):
                out = _apply_dense(layer, p, out)
            elif isinstance(layer, PositionalEncoding):
                out = _apply_positional_encoding(layer, out)
            elif isinstance(layer, TransformerBlock):
                out = _apply_transformer_block(layer, p, out)
            elif isinstance(layer, PoolLayer):
                out = _apply_pool(layer, out)
            else:
                raise TypeError(f"Unknown layer spec: {layer!r}")
        return out.float()

    def params_numpy(self):
        """The parameters in the JAX package's layout, as numpy arrays."""
        return [
            {name: value.detach().cpu().numpy() for name, value in p.items()}
            for p in self.layer_params
        ]


def stack_params(per_machine: List[List[Dict]]) -> List[Dict[str, np.ndarray]]:
    """M machines' parameters (each in the JAX package's layout) as one
    list of dicts of arrays with a leading machine axis."""
    return [
        {name: np.stack([np.asarray(machine[i][name], np.float32) for machine in per_machine])
         for name in layer}
        for i, layer in enumerate(per_machine[0])
    ]


class StackedTransformerModel(TransformerModel):
    """M models of one spec, each parameter with a leading machine axis M:
    ``forward`` takes (M, B, T, features) and returns (M, B, outputs),
    machine m's rows through machine m's parameters. The projections are
    batched matmuls, biases and layer-norm parameters broadcast over (B, T),
    and attention folds the machines into its batch, so each Transformer
    block launches the flash kernels once for all M machines, at BH = M x B
    x heads. With M = 1 it computes what :class:`TransformerModel` does."""

    def _layer(self, p, ndim: int) -> Dict[str, torch.Tensor]:
        """Each (M, *shape) parameter viewed as (M, 1, ..., *shape) so that
        it broadcasts against an (M, ..., features) input of ``ndim``
        dims: a kernel over the batch axes, a bias or scale over (B, T)."""
        return {
            name: value.reshape(value.shape[:1] + (1,) * (ndim - value.dim()) + value.shape[1:])
            for name, value in super()._layer(p, ndim).items()
        }

    def machine_params(self, m: int):
        """Machine ``m``'s parameters in the JAX package's layout, as numpy
        arrays."""
        return [{name: value[m] for name, value in p.items()} for p in self.params_numpy()]
