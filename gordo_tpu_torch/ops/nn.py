"""
Layer init/apply in PyTorch: the port's counterpart of
``gordo_tpu/ops/nn.py`` for the layers of the feedforward, Transformer,
LSTM and TCN families (Dense, positional encoding, pre-LN Transformer
block, LSTM, TCN block, pooling), at the spec's ``compute_dtype``: float32
or bfloat16. A Dense layer with an ``l1_activity`` adds its activity
penalty to the training loss (``forward_with_penalty``), as ``apply_model``
returns it.

Parameters use the JAX package's layout: one dict per layer, keyed as
there (``kernel``/``bias`` for Dense; ``kernel``/``recurrent_kernel``/
``bias`` for LSTM; ``conv1_kernel`` ... ``res_kernel`` for a TCN block;
``ln1_scale``, ``wq`` ... ``b_ff2`` for a Transformer block), so weights
carry across unchanged (serializer/from_jax.py). :class:`TransformerModel`
holds them on the device and runs the forward pass, the counterpart of
``apply_model``. :func:`stacked_forward` runs M models of one spec as one:
each parameter with a leading model axis M, the counterpart of
``apply_model`` under a ``vmap`` over models. :class:`StackedTransformerModel`
holds M machines' parameters that way for the fleet trainer; the serving
batcher (server/batcher.py) calls :func:`stacked_forward` on parameters
gathered from its bank. The layers take any leading axes before (time,
features).

An LSTM layer is the input projection of every step as one matmul, then
the recurrence as one launch of the port's CUDA kernel for all M stacked
models (ops/lstm.py); a TCN block is the JAX package's causal convolution,
one matmul against all taps and shifted adds, in plain torch.
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
from .activations import ACTIVATIONS, activation as _activation  # noqa: F401 (re-exported)
from .attention import multihead_attention
from .lstm import lstm_recurrence

Params = List[Dict[str, torch.Tensor]]

# the compute dtypes the port runs; the parameters stay float32 at rest
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# layers the port cannot run yet, with the ROADMAP.md queue A item they wait for
NOT_PORTED = {
    MoEBlock: "the MoE item",
}


def not_ported(layer) -> NotImplementedError:
    """The refusal of a layer (or layer class) the port cannot run yet."""
    cls = layer if isinstance(layer, type) else type(layer)
    return NotImplementedError(
        f"{cls.__name__} is not ported yet: see {NOT_PORTED[cls]} of ROADMAP.md queue A"
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


def _orthogonal(generator, shape) -> torch.Tensor:
    """An orthogonal matrix as the JAX package's initializer draws one: the
    Q of a standard normal (rows x cols, transposed when wide), its columns'
    signs fixed by R's diagonal; a wide shape has orthonormal rows."""
    rows, cols = shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=generator)
    # numpy's QR: torch's takes tens of ms on a small matrix on the CPU
    q, r = np.linalg.qr(a.double().numpy())
    q = q * np.sign(np.diag(r))
    return torch.from_numpy(np.ascontiguousarray(q.T if rows < cols else q, np.float32))


def init_lstm_layer(generator, in_dim: int, units: int):
    """``init_lstm_layer``: a glorot-uniform ``kernel`` (in, 4U), an
    orthogonal ``recurrent_kernel`` (U, 4U) and a zero ``bias`` with 1.0 on
    the forget gate's slice (gate order i, f, g, o; Keras'
    unit_forget_bias)."""
    bias = torch.zeros(4 * units, dtype=torch.float32)
    bias[units:2 * units] = 1.0
    return {
        "kernel": _glorot_uniform(generator, (in_dim, 4 * units)),
        "recurrent_kernel": _orthogonal(generator, (units, 4 * units)),
        "bias": bias,
    }


def init_tcn_block(generator, in_dim: int, layer: TCNBlock):
    """``init_tcn_block``: glorot-uniform conv kernels in WIO layout
    (width, in, out) and zero biases; ``res_kernel`` (1, in, filters) only
    where the channel count changes."""
    filters, width = layer.filters, layer.kernel_size
    params = {
        "conv1_kernel": _glorot_uniform(generator, (width, in_dim, filters)),
        "conv1_bias": torch.zeros(filters, dtype=torch.float32),
        "conv2_kernel": _glorot_uniform(generator, (width, filters, filters)),
        "conv2_bias": torch.zeros(filters, dtype=torch.float32),
    }
    if in_dim != filters:
        params["res_kernel"] = _glorot_uniform(generator, (1, in_dim, filters))
    return params


def layer_out_dim(layer, in_dim: int) -> int:
    """The feature dimension a layer gives from ``in_dim``."""
    if isinstance(layer, (DenseLayer, LSTMLayer)):
        return layer.units
    if isinstance(layer, (TransformerBlock, MoEBlock)):
        return layer.d_model
    if isinstance(layer, TCNBlock):
        return layer.filters
    if isinstance(layer, (PositionalEncoding, PoolLayer)):
        return in_dim
    raise TypeError(f"Unknown layer spec: {layer!r}")


def init_model_params(spec: ModelSpec, generator: torch.Generator = None) -> Params:
    """Parameters for a spec, on the CPU: glorot-uniform kernels, orthogonal
    recurrent kernels and zero biases (an LSTM's forget gate at 1), as the
    JAX package draws them (the same distributions and shapes, not the same
    numbers)."""
    params: Params = []
    in_dim = spec.n_features
    for layer in spec.layers:
        if isinstance(layer, DenseLayer):
            params.append({
                "kernel": _glorot_uniform(generator, (in_dim, layer.units)),
                "bias": torch.zeros(layer.units, dtype=torch.float32),
            })
        elif isinstance(layer, LSTMLayer):
            params.append(init_lstm_layer(generator, in_dim, layer.units))
        elif isinstance(layer, TransformerBlock):
            params.append(_init_transformer_block(generator, in_dim, layer))
        elif isinstance(layer, TCNBlock):
            params.append(init_tcn_block(generator, in_dim, layer))
        elif isinstance(layer, (PositionalEncoding, PoolLayer)):
            params.append({})
        elif type(layer) in NOT_PORTED:
            raise not_ported(layer)
        else:
            raise TypeError(f"Unknown layer spec: {layer!r}")
        in_dim = layer_out_dim(layer, in_dim)
    return params


def check_windowed(spec: ModelSpec) -> None:
    """An LSTM layer needs a time axis, which an unwindowed spec
    (``lookback_window <= 1`` and ``lookahead == 0``: the LSTM estimators'
    own defaults) does not give its batches. The JAX package fails there
    too, deep in its scan over a 2-D batch; the port refuses the spec with
    the cause."""
    if spec.is_recurrent and spec.lookback_window <= 1 and spec.lookahead == 0:
        raise ValueError(
            f"LSTM layers need windows: this spec is unwindowed (lookback_window="
            f"{spec.lookback_window}, lookahead={spec.lookahead}), so its batches have no "
            f"time axis; set lookback_window >= 2")


def _matmul(x, w):
    """x (..., K) times a kernel: a (K, N) one, or M stacked (M, K, N) ones
    against an x whose leading axis is M, as one batched product over
    everything between (no copy of a kernel per window)."""
    if w.dim() == 2:
        return torch.matmul(x, w)
    m, k, n = w.shape
    return torch.bmm(x.reshape(m, -1, k), w).reshape(*x.shape[:-1], n)


def _apply_dense(layer: DenseLayer, p, x):
    return _activation(layer.activation)(_matmul(x, p["kernel"]) + p["bias"])


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
    q, k, v = torch.chunk(_matmul(h, w_qkv) + b_qkv, 3, dim=-1)
    attn = multihead_attention(
        q, k, v, layer.num_heads, causal=layer.causal, impl=layer.attention_impl
    )
    return x + _matmul(attn, p["wo"]) + p["bo"]


def _apply_transformer_block(layer: TransformerBlock, p, x):
    """Pre-LN encoder block. x: (..., time, d_model)."""
    x = _attention_sublayer(layer, p, x)
    h = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
    ff = _activation(layer.activation)(_matmul(h, p["w_ff1"]) + p["b_ff1"])
    return x + _matmul(ff, p["w_ff2"]) + p["b_ff2"]


def _bias_view(bias, x, stacked: bool):
    """A bias (N,) as it is, or M stacked biases (M, N) viewed as (M, 1,
    ..., N) against an x of leading axis M."""
    if not stacked:
        return bias
    return bias.reshape(bias.shape[:1] + (1,) * (x.dim() - 2) + bias.shape[1:])


def _apply_lstm(layer: LSTMLayer, p, x, stacked: bool):
    """x: (..., T, in) (stacked: (M, ..., T, in) with (M, ...) parameters)
    to (..., T, U) with ``return_sequences``, else the last step's (..., U).
    The input projection of every step is one matmul, ``Zx = x @ kernel +
    bias`` in the compute dtype; the recurrence then runs over every
    leading index at once, one kernel launch for all M models
    (ops/lstm.py), c and h carried in float32."""
    if x.dim() < (4 if stacked else 3):
        raise ValueError(
            f"an LSTM layer takes (..., time, features) windows, got a batch of shape "
            f"{tuple(x.shape)}: the spec needs lookback_window >= 2")
    t, n_in = x.shape[-2:]
    lead = x.shape[:-2]
    m = x.shape[0] if stacked else 1
    units = layer.units
    kernel, rk = p["kernel"], p["recurrent_kernel"]
    if not stacked:
        kernel, rk = kernel[None], rk[None]
    xs = x.reshape(m, -1, n_in)
    zx = torch.bmm(xs, kernel).reshape(m, -1, t, 4 * units)
    bias = p["bias"].reshape(m, 1, 1, 4 * units)
    h = lstm_recurrence(zx + bias, rk, layer.activation, layer.recurrent_activation,
                        layer.return_sequences)
    return h.reshape(*lead, t, units) if layer.return_sequences else h.reshape(*lead, units)


def _causal_conv1d(x, kernel, dilation: int):
    """The JAX package's causal dilated convolution: x (..., T, c_in)
    against a (width, c_in, c_out) kernel (or M stacked (M, width, c_in,
    c_out) kernels against an x of leading axis M) as one matmul of the raw
    series against every tap's kernel, then the taps' outputs shifted and
    added: ``out[t] = sum_i x[t - (width - 1 - i) * dilation] @ W[i]``,
    rows before the start zero. A tap whose offset reaches the window's
    start is skipped (a short predict window); the last tap's offset is 0."""
    width, c_in, c_out = kernel.shape[-3:]
    t = x.shape[-2]
    taps = kernel.transpose(-3, -2).reshape(*kernel.shape[:-3], c_in, width * c_out)
    z = _matmul(x, taps).reshape(*x.shape[:-1], width, c_out)
    out = None
    for i in range(width):
        off = (width - 1 - i) * dilation
        if off >= t:
            continue
        zi = F.pad(z[..., : t - off, i, :], (0, 0, off, 0))
        out = zi if out is None else out + zi
    return out


def _apply_tcn_block(layer: TCNBlock, p, x, stacked: bool):
    """Two causal dilated convolutions with the activation, and the
    residual (the input, or its 1x1 projection where the channels
    change). x: (..., T, c_in) to (..., T, filters)."""
    act = _activation(layer.activation)
    h = act(_causal_conv1d(x, p["conv1_kernel"], layer.dilation)
            + _bias_view(p["conv1_bias"], x, stacked))
    h = act(_causal_conv1d(h, p["conv2_kernel"], layer.dilation)
            + _bias_view(p["conv2_bias"], x, stacked))
    res = x if "res_kernel" not in p else _causal_conv1d(x, p["res_kernel"], 1)
    return act(h + res)


def _apply_pool(layer: PoolLayer, x):
    if layer.mode == "last":
        return x[..., -1, :]
    if layer.mode == "mean":
        return x.mean(dim=-2)
    if layer.mode == "max":
        return x.amax(dim=-2)
    raise ValueError(f"Unknown pool mode {layer.mode!r}")


def _l1_activity(layer: DenseLayer, out: torch.Tensor, stacked: bool) -> torch.Tensor:
    """The layer's l1 activity penalty, as ``apply_model`` takes it: l1 times
    the sum of |output| in float32 over the whole batch (padding rows
    included), over the batch size; one per machine when ``stacked``."""
    batch = out.shape[1 if stacked else 0]
    return layer.l1_activity * out.float().abs().flatten(1 if stacked else 0).sum(-1) / batch


def _forward(spec: ModelSpec, layer_params, x: torch.Tensor, compute_dtype,
             stacked: bool, with_penalty: bool = False):
    """The layer walk: x and every parameter cast to ``compute_dtype``, the
    output cast to float32. ``stacked``: each parameter has a leading model
    axis; for the Dense and Transformer layers a vector (M, N) is viewed as
    (M, 1, ..., N) to broadcast against x and a kernel (M, K, N) goes to
    :func:`_matmul` as it is; the LSTM and TCN layers take their stacked
    parameters as they are and view them themselves (the TCN kernels are
    (M, width, in, out), the recurrence's tensors (M, B, ...)).
    ``with_penalty``: also the summed l1 activity penalty of the Dense
    layers that carry one (a scalar, or (M,) when ``stacked``)."""
    out = x.to(compute_dtype)
    penalty = torch.zeros(x.shape[:1] if stacked else (), device=x.device)
    for layer, p in zip(spec.layers, layer_params):
        p = {name: value.to(compute_dtype) for name, value in p.items()}
        if isinstance(layer, LSTMLayer):
            out = _apply_lstm(layer, p, out, stacked)
            continue
        if isinstance(layer, TCNBlock):
            out = _apply_tcn_block(layer, p, out, stacked)
            continue
        if stacked:
            p = {name: value.reshape(value.shape[:1] + (1,) * (out.dim() - 2) + value.shape[1:])
                 if value.dim() == 2 else value for name, value in p.items()}
        if isinstance(layer, DenseLayer):
            out = _apply_dense(layer, p, out)
            if with_penalty and layer.l1_activity > 0.0:
                penalty = penalty + _l1_activity(layer, out, stacked)
        elif isinstance(layer, PositionalEncoding):
            out = _apply_positional_encoding(layer, out)
        elif isinstance(layer, TransformerBlock):
            out = _apply_transformer_block(layer, p, out)
        elif isinstance(layer, PoolLayer):
            out = _apply_pool(layer, out)
        else:
            raise TypeError(f"Unknown layer spec: {layer!r}")
    return (out.float(), penalty) if with_penalty else out.float()


def stacked_forward(spec: ModelSpec, layer_params, x: torch.Tensor) -> torch.Tensor:
    """B models of one spec run as one: ``layer_params`` is one dict per
    layer of (B, ...) parameters (the JAX package's names, float32), x is
    (B, ..., T, features) (a serving batch: (B, n_pad, L, D) windows) and
    the output (B, ..., outputs) in float32, model b's rows through model
    b's parameters. Under ``compute_dtype: bfloat16`` x and the parameters
    are cast to bf16 as :class:`TransformerModel` casts them, so a lane
    computes what the single model computes. The projections are batched
    products, and attention folds the models into its batch, so each
    Transformer block launches the flash forward once for all B models; an
    LSTM layer launches the recurrence once for all of them."""
    return _forward(spec, layer_params, x, COMPUTE_DTYPES[spec.compute_dtype], stacked=True)


class TransformerModel(nn.Module):
    """A spec of Dense / PositionalEncoding / TransformerBlock / LSTM / TCN /
    PoolLayer layers (a feedforward autoencoder's Dense layers alone
    included; the name is the first family's) with its parameters resident
    on ``device``; ``forward`` is the counterpart of ``apply_model``'s
    output (float32). The parameters are float32 and trainable
    (ops/train.py); serving runs under ``torch.inference_mode``.

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
                raise not_ported(layer)
        check_windowed(spec)
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

    stacked = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _forward(self.spec, self.layer_params, x, self.compute_dtype, self.stacked)

    def forward_with_penalty(self, x: torch.Tensor):
        """``(output, penalty)``: the output and the l1 activity penalty the
        loss adds (``apply_model``'s pair)."""
        return _forward(self.spec, self.layer_params, x, self.compute_dtype, self.stacked,
                        with_penalty=True)

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
    machine m's rows through machine m's parameters (:func:`stacked_forward`),
    so each Transformer block launches the flash kernels once for all M
    machines, at BH = M x B x heads, and each LSTM layer the recurrence
    kernels once. With M = 1 it computes what
    :class:`TransformerModel` does."""

    stacked = True

    def machine_params(self, m: int):
        """Machine ``m``'s parameters in the JAX package's layout, as numpy
        arrays."""
        return [{name: value[m] for name, value in p.items()} for p in self.params_numpy()]
