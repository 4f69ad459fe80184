"""
Layer init/apply in PyTorch: the port's counterpart of
``gordo_tpu/ops/nn.py`` for the layers of the feedforward, Transformer,
Switch-MoE Transformer, LSTM and TCN families (Dense, positional encoding,
pre-LN Transformer block, MoE block, LSTM, TCN block, pooling), at the
spec's ``compute_dtype``: float32 or bfloat16. A Dense layer with an
``l1_activity`` and an MoE block with an ``aux_loss_weight`` add their
penalties to the training loss (``forward_with_penalty``), as
``apply_model`` returns them.

Parameters use the JAX package's layout: one dict per layer, keyed as
there (``kernel``/``bias`` for Dense; ``kernel``/``recurrent_kernel``/
``bias`` for LSTM; ``conv1_kernel`` ... ``res_kernel`` for a TCN block;
``ln1_scale``, ``wq`` ... ``b_ff2`` for a Transformer block; the same
attention keys and ``router``, ``w1``, ``b1``, ``w2``, ``b2`` with the
experts on a leading axis for an MoE block), so weights carry across
unchanged (serializer/from_jax.py). :class:`TransformerModel`
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
one matmul against all taps and shifted adds, in plain torch. An MoE
block's routed FFN is the JAX package's ``moe_dispatch_ffn`` in plain
torch (it has no Pallas kernel there): top-1 routing, each token's place
in its expert's buffer from a cumsum in token order, a fixed (experts x
capacity, d_model) buffer filled by gathering each slot's token, the
experts of all M models as two batched products, and a gather back. Its
shapes depend on the call's token count alone, never on the routing, so
nothing waits on the device. Capacity, routing and the load-balancing
loss are each model's own, over the tokens of its own rows (padding
included), as under the JAX package's ``vmap``.
"""

import math
from typing import Dict, List, NamedTuple, Optional

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

# the vectors of the attention sublayer, viewed against x when stacked
_ATTENTION_VECTORS = ("ln1_scale", "ln1_bias", "bq", "bk", "bv", "bo", "ln2_scale", "ln2_bias")


def _glorot_uniform(generator, shape) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -limit, limit, generator=generator
    )


def _check_d_model(in_dim: int, layer) -> None:
    if in_dim != layer.d_model:
        raise ValueError(
            f"{type(layer).__name__} d_model={layer.d_model} but incoming dim is "
            f"{in_dim}; insert a Dense projection first"
        )


def _init_attention_params(generator, d: int):
    """The pre-LN attention sublayer's parameters, shared by the
    Transformer and MoE blocks."""
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
    }


def _init_transformer_block(generator, in_dim: int, layer: TransformerBlock):
    _check_d_model(in_dim, layer)
    d, ff = layer.d_model, layer.ff_dim
    return {
        **_init_attention_params(generator, d),
        "w_ff1": _glorot_uniform(generator, (d, ff)),
        "b_ff1": torch.zeros(ff, dtype=torch.float32),
        "w_ff2": _glorot_uniform(generator, (ff, d)),
        "b_ff2": torch.zeros(d, dtype=torch.float32),
    }


def init_moe_block(generator, in_dim: int, layer: MoEBlock):
    """``init_moe_block``: the attention sublayer's parameters, a
    glorot-uniform ``router`` (D, E), the experts' glorot-uniform ``w1``
    (E, D, F) and ``w2`` (E, F, D) (each expert's own fans) and zero ``b1``
    (E, F) and ``b2`` (E, D)."""
    _check_d_model(in_dim, layer)
    d, f, e = layer.d_model, layer.expert_dim, layer.num_experts
    return {
        **_init_attention_params(generator, d),
        "router": _glorot_uniform(generator, (d, e)),
        "w1": _glorot_uniform(generator, (e, d, f)),
        "b1": torch.zeros((e, f), dtype=torch.float32),
        "w2": _glorot_uniform(generator, (e, f, d)),
        "b2": torch.zeros((e, d), dtype=torch.float32),
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
        elif isinstance(layer, MoEBlock):
            params.append(init_moe_block(generator, in_dim, layer))
        elif isinstance(layer, TCNBlock):
            params.append(init_tcn_block(generator, in_dim, layer))
        elif isinstance(layer, (PositionalEncoding, PoolLayer)):
            params.append({})
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


def moe_capacity(layer: MoEBlock, n_tokens: int) -> int:
    """Each expert's token capacity in a call of ``n_tokens`` tokens (its
    padding included): ``max(1, ceil(n_tokens * capacity_factor /
    num_experts))``, Switch Transformer semantics."""
    return max(1, math.ceil(n_tokens * layer.capacity_factor / layer.num_experts))


class MoERoute(NamedTuple):
    """The top-1 routing of (..., N, E) router probabilities: each token's
    expert ``top1`` and probability ``gate`` (..., N), its place ``pos`` in
    that expert's buffer (the tokens routed there before it, in token
    order), whether it fits (``keep = pos < capacity``), and the capacity."""

    top1: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


def moe_route(layer: MoEBlock, gates: torch.Tensor) -> MoERoute:
    """The routing of ``gates`` (..., N, E), each leading index over its own
    N tokens. ``argmax`` takes the first of tied experts, as ``jnp.argmax``
    does; the places come from an int32 cumsum of the one-hot, exact where
    the JAX package's float32 cumsum is (below 2^24 tokens). The one-hot
    is laid out expert-major, (..., E, N), so that the cumsum runs along
    the innermost axis, where CUDA scans in parallel (along the token axis
    of an (N, E) one-hot each expert's column is one thread's serial loop:
    ~50 ms a block at 524,288 tokens)."""
    capacity = moe_capacity(layer, gates.shape[-2])
    top1 = gates.argmax(dim=-1)
    gate = gates.gather(-1, top1[..., None])[..., 0]
    experts = torch.arange(layer.num_experts, device=gates.device)
    onehot = (top1[..., None, :] == experts[:, None]).to(torch.int32)
    pos = onehot.cumsum(dim=-1, dtype=torch.int32).gather(-2, top1[..., None, :])[..., 0, :] - 1
    return MoERoute(top1, gate, pos, pos < capacity, capacity)


def _leading(value: torch.Tensor, stacked: bool) -> torch.Tensor:
    return value if stacked else value[None]


def moe_dispatch_ffn(layer: MoEBlock, expert_w, h: torch.Tensor, route: MoERoute
                     ) -> torch.Tensor:
    """The routed FFN of ``moe_dispatch_ffn`` for M models at once: ``h``
    (M, N, D) post-LN tokens routed by ``route`` (:func:`moe_route` of their
    (M, N, E) router probabilities), ``expert_w`` ``w1`` (M, E, D, F), ``b1``
    (M, E, F), ``w2`` (M, E, F, D), ``b2`` (M, E, D). Returns (M, N, D):
    each kept token's expert output times its gate, zero for a token over
    its expert's capacity.

    The (M, E x C, D) expert buffer is gathered, not scattered: each kept
    token's slot (its expert, its place) is written with its index into an
    int map whose tail holds one cell for each token (a dropped token writes
    its own cell there, so no two writes meet), and each slot then reads its
    token; an empty slot reads a token spread by its slot index and is
    zeroed. The M x E experts run as two batched products with bias and
    activation, and each token reads its slot back (a dropped one a slot
    spread by its index, weighted 0). Every index is unique or spread, so
    the gathers' backward (a sort and an accumulate by index) never piles
    thousands of tokens onto one row, as one shared dump row would."""
    m, n, d = h.shape
    e, f, cap = layer.num_experts, layer.expert_dim, route.capacity
    rows = torch.arange(m, device=h.device)[:, None]
    tokens = torch.arange(n, device=h.device).expand(m, n)
    slot = route.top1 * cap + route.pos
    owner = torch.full((m, e * cap + n), -1, dtype=torch.long, device=h.device)
    owner.scatter_(1, torch.where(route.keep, slot, e * cap + tokens), tokens)
    owner = owner[:, :e * cap]
    filled = owner >= 0
    spread = torch.arange(e * cap, device=h.device) % n
    # in place: the gather's backward keeps its indices, not its output
    buf = h[rows, torch.where(filled, owner, spread)].masked_fill_(~filled[..., None], 0)
    buf = buf.reshape(m * e, cap, d)
    mid = _activation(layer.activation)(torch.baddbmm(
        expert_w["b1"].reshape(m * e, 1, f), buf, expert_w["w1"].reshape(m * e, d, f)))
    out_buf = torch.baddbmm(expert_w["b2"].reshape(m * e, 1, d), mid,
                            expert_w["w2"].reshape(m * e, f, d)).reshape(m, e * cap, d)
    tok_out = out_buf[rows, torch.where(route.keep, slot, tokens % (e * cap))]
    return tok_out * (route.gate * route.keep).to(tok_out.dtype)[..., None]


def moe_aux_loss(layer: MoEBlock, gates: torch.Tensor, top1: torch.Tensor) -> torch.Tensor:
    """The Switch load-balancing loss ``E * sum_e f_e * P_e`` of (..., N, E)
    router probabilities with their top-1 experts (f_e the share of tokens
    whose top-1 expert is e, P_e the mean probability of e), one per
    leading index."""
    share = F.one_hot(top1, layer.num_experts).float().mean(dim=-2)
    return layer.num_experts * (share * gates.mean(dim=-2)).sum(dim=-1)


def _apply_moe_block(layer: MoEBlock, p, x, stacked: bool, with_aux: bool = False,
                     routing: Optional[list] = None):
    """Pre-LN MoE encoder block. x: (..., time, d_model), or (M, ..., time,
    d_model) with (M, ...) parameters when ``stacked``; a model's tokens are
    every token of its rows. The router runs in float32 on the float32
    ``router`` (routing is a decision, not an activation). Returns the
    output and, with ``with_aux``, the weighted load-balancing loss (a
    scalar, or (M,) when stacked). ``routing``, a list, gets the block's
    ``{"logits", "top1", "keep", "capacity"}`` appended, (M, N, ...) when
    stacked, else (N, ...)."""
    vectors = {name: _bias_view(p[name], x, stacked) for name in _ATTENTION_VECTORS}
    x = _attention_sublayer(layer, {**p, **vectors}, x)
    h = _layer_norm(x, vectors["ln2_scale"], vectors["ln2_bias"])
    m = x.shape[0] if stacked else 1
    flat = h.reshape(m, -1, h.shape[-1])
    logits = torch.bmm(flat.float(), _leading(p["router"], stacked).float())
    gates = torch.softmax(logits, dim=-1)
    route = moe_route(layer, gates)
    ffn = moe_dispatch_ffn(layer, {name: _leading(p[name], stacked)
                                   for name in ("w1", "b1", "w2", "b2")}, flat, route)
    out = x + ffn.reshape(x.shape)
    if routing is not None:
        record = {"logits": logits, "top1": route.top1, "keep": route.keep}
        routing.append({**{key: value if stacked else value[0]
                           for key, value in record.items()}, "capacity": route.capacity})
    if not with_aux:
        return out
    weight = float(layer.aux_loss_weight or 0.0)
    aux = (weight * moe_aux_loss(layer, gates, route.top1) if weight > 0.0
           else torch.zeros(m, device=x.device))
    return out, aux if stacked else aux[0]


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
             stacked: bool, with_penalty: bool = False, routing: Optional[list] = None):
    """The layer walk: x and every parameter cast to ``compute_dtype`` (an
    MoE block's ``router`` excepted: it stays float32, as ``apply_model``
    keeps it), the output cast to float32. ``stacked``: each parameter has
    a leading model axis; for the Dense and Transformer layers a vector
    (M, N) is viewed as (M, 1, ..., N) to broadcast against x and a kernel
    (M, K, N) goes to :func:`_matmul` as it is; the LSTM, TCN and MoE layers
    take their stacked parameters as they are and view them themselves (the
    TCN kernels are (M, width, in, out), the recurrence's tensors (M, B,
    ...), the experts' (M, E, ...)). ``with_penalty``: also the summed l1
    activity penalty of the Dense layers that carry one and the weighted
    load-balancing losses of the MoE blocks (a scalar, or (M,) when
    ``stacked``). ``routing``: a list that each MoE block appends its
    routing to (:func:`_apply_moe_block`)."""
    out = x.to(compute_dtype)
    penalty = torch.zeros(x.shape[:1] if stacked else (), device=x.device)
    for layer, p in zip(spec.layers, layer_params):
        moe = isinstance(layer, MoEBlock)
        p = {name: value if moe and name == "router" else value.to(compute_dtype)
             for name, value in p.items()}
        if isinstance(layer, LSTMLayer):
            out = _apply_lstm(layer, p, out, stacked)
            continue
        if isinstance(layer, TCNBlock):
            out = _apply_tcn_block(layer, p, out, stacked)
            continue
        if moe:
            out = _apply_moe_block(layer, p, out, stacked, with_penalty, routing)
            if with_penalty:
                out, aux = out
                penalty = penalty + aux
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


def stacked_forward(spec: ModelSpec, layer_params, x: torch.Tensor,
                    routing: Optional[list] = None) -> torch.Tensor:
    """B models of one spec run as one: ``layer_params`` is one dict per
    layer of (B, ...) parameters (the JAX package's names, float32), x is
    (B, ..., T, features) (a serving batch: (B, n_pad, L, D) windows) and
    the output (B, ..., outputs) in float32, model b's rows through model
    b's parameters. Under ``compute_dtype: bfloat16`` x and the parameters
    are cast to bf16 as :class:`TransformerModel` casts them, so a lane
    computes what the single model computes. The projections are batched
    products, and attention folds the models into its batch, so each
    Transformer or MoE block launches the flash forward once for all B
    models; an LSTM layer launches the recurrence once for all of them. An
    MoE block routes each model's tokens apart (its own capacity, from its
    own token count) and runs the B x E experts as one batched product.
    ``routing``: a list that each MoE block appends its (B, ...) routing to."""
    return _forward(spec, layer_params, x, COMPUTE_DTYPES[spec.compute_dtype], stacked=True,
                    routing=routing)


class TransformerModel(nn.Module):
    """A spec of Dense / PositionalEncoding / TransformerBlock / MoEBlock /
    LSTM / TCN / PoolLayer layers (a feedforward autoencoder's Dense layers alone
    included; the name is the first family's) with its parameters resident
    on ``device``; ``forward`` is the counterpart of ``apply_model``'s
    output (float32). The parameters are float32 and trainable
    (ops/train.py); serving runs under ``torch.inference_mode``.

    Under ``compute_dtype: bfloat16`` each forward casts the input and every
    parameter but an MoE router to bf16, as ``apply_model`` does, so every layer, the
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
        """``(output, penalty)``: the output and the penalty the loss adds,
        the l1 activity penalty and the MoE load-balancing loss
        (``apply_model``'s pair)."""
        return _forward(self.spec, self.layer_params, x, self.compute_dtype, self.stacked,
                        with_penalty=True)

    def forward_with_routing(self, x: torch.Tensor):
        """``(output, routing)``: the output and each MoE block's routing,
        in layer order (:func:`_apply_moe_block`)."""
        routing: list = []
        out = _forward(self.spec, self.layer_params, x, self.compute_dtype, self.stacked,
                       routing=routing)
        return out, routing

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
