"""
The activations by name, the port's copy of ``ACTIVATIONS`` in
``gordo_tpu/ops/nn.py``, with each one's derivative for the LSTM
recurrence's plain backward (ops/lstm.py). ``ACTIVATION_CODES`` numbers
the names in the order of the ``Act`` enum of ``csrc/lstm_recurrence.cu``,
whose kernels take them as codes.
"""

import math

import torch
import torch.nn.functional as F

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

ACTIVATION_CODES = ("linear", "tanh", "relu", "sigmoid", "elu", "selu", "softplus",
                    "softsign", "swish", "gelu", "leaky_relu", "exponential", "hard_sigmoid")

_SELU_SCALE = 1.0507009873554804934193349852946
_SELU_ALPHA = 1.6732632423543772848170429916717
_GELU_K = math.sqrt(2.0 / math.pi)


def _sigmoid_grad(x):
    s = torch.sigmoid(x)
    return s * (1.0 - s)


def _swish_grad(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def _gelu_grad(x):
    t = torch.tanh(_GELU_K * (x + 0.044715 * x ** 3))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * _GELU_K * (1.0 + 3 * 0.044715 * x * x)


# each activation's derivative at x, with the JAX package's choices at the
# kinks (relu's 0 at 0, leaky_relu's 1 at 0, hard_sigmoid's 0 at +-3)
ACTIVATION_GRADS = {
    "linear": torch.ones_like,
    "tanh": lambda x: 1.0 - torch.tanh(x) ** 2,
    "relu": lambda x: (x > 0).to(x.dtype),
    "sigmoid": _sigmoid_grad,
    "elu": lambda x: torch.where(x > 0, torch.ones_like(x), torch.exp(x)),
    "selu": lambda x: _SELU_SCALE * torch.where(x > 0, torch.ones_like(x),
                                                _SELU_ALPHA * torch.exp(x)),
    "softplus": torch.sigmoid,
    "softsign": lambda x: 1.0 / (1.0 + x.abs()) ** 2,
    "swish": _swish_grad,
    "gelu": _gelu_grad,
    "leaky_relu": lambda x: torch.where(x >= 0, torch.ones_like(x), torch.full_like(x, 0.01)),
    "exponential": torch.exp,
    "hard_sigmoid": lambda x: ((x > -3.0) & (x < 3.0)).to(x.dtype) / 6.0,
}


def activation(name: str):
    """The activation of a name; an unknown one raises as the JAX package's
    ``_activation`` does."""
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"Unknown activation {name!r}; available: {sorted(ACTIVATIONS)}"
        ) from None
