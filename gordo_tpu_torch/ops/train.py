"""
The training loop: the port's counterpart of ``make_optimizer``,
``_loss_terms``, ``_gather_batch``, ``make_epoch_fn``, ``make_masked_epoch_fn``,
``evaluate_loss`` and ``fit_arrays`` in ``gordo_tpu/ops/train.py``.

X and y go to the model's device once per fit. Each step gathers its
(batch, lookback, features) windows on the device from the flat series:
window i covers rows [i, i + lookback) and its target is row
i + lookback - 1 + lookahead; an unwindowed model (a feedforward
autoencoder) takes its batch's rows as they are. An epoch runs in a fixed number of
equal-sized steps: the sample order is padded to whole batches with
zero-weighted repeats of sample 0, as the JAX package pads its index
stream, so the last short batch's loss and gradient are means over its
live samples only and every step hands the attention kernels one shape.
The per-step losses stay on the device until the epoch ends. The l1
activity penalty of a feedforward autoencoder's encoder layers is added to
each step's loss over the whole padded batch, as the JAX package adds it.

The fleet trainer's epoch, :func:`run_masked_epoch`, trains M machines of
one spec at once (a ``StackedTransformerModel``): X and y carry a leading
machine axis, each machine takes its own sample order, and the loss is the
sum over machines of each machine's weighted mean, so that each machine's
gradient is its own. Every optimizer rule of :func:`make_optimizer`
(``RULES``) is elementwise, so one optimizer over the stacked parameters
steps M independent optimizers.
"""

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.spec import ModelSpec, OptimizerSpec
from .predict import n_train_samples

EVAL_BATCH = 2048


class _OptaxRule(torch.optim.Optimizer):
    """One of optax's update rules as a torch optimizer: ``_init`` makes a
    parameter's state, ``_update`` returns its update (already scaled by
    -learning_rate), which is added to the parameter."""

    def __init__(self, params, **defaults):
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    self._init(state, p, group)
                state["step"] += 1
                p.add_(self._update(state, p, p.grad, group))
        return loss


def _bias_corrected(moment: torch.Tensor, decay: float, count: int) -> torch.Tensor:
    """moment / (1 - decay**count), the correction in float32 as optax has it."""
    return moment / (1 - np.float32(decay) ** np.float32(count))


class OptaxRMSprop(_OptaxRule):
    """``optax.rmsprop``: nu = decay nu + (1 - decay) g^2 from 0, update
    -lr g / sqrt(nu + eps) (eps inside the root), then a momentum trace
    t = u + momentum t."""

    def _init(self, state, p, group):
        state["nu"] = torch.zeros_like(p)
        state["trace"] = torch.zeros_like(p)

    def _update(self, state, p, g, group):
        decay = group["decay"]
        state["nu"].mul_(decay).add_((1.0 - decay) * g * g)
        u = -group["lr"] * g * torch.rsqrt(state["nu"] + group["eps"])
        state["trace"] = u + group["momentum"] * state["trace"]
        return state["trace"]


class OptaxAdagrad(_OptaxRule):
    """``optax.adagrad``: a sum of squares from 0.1, update
    -lr g / sqrt(sum + eps)."""

    def _init(self, state, p, group):
        state["sum_of_squares"] = torch.full_like(p, group["initial_accumulator_value"])

    def _update(self, state, p, g, group):
        sums = state["sum_of_squares"].add_(g * g)
        scale = torch.where(sums > 0, torch.rsqrt(sums + group["eps"]), torch.zeros_like(sums))
        return -group["lr"] * scale * g


class OptaxAdam(_OptaxRule):
    """``optax.adam`` with ``nesterov`` (``optax.nadam``: the Nesterov step,
    no momentum-decay schedule) and an optional decoupled weight decay
    added to the update before the learning rate (``optax.adamw``)."""

    def _init(self, state, p, group):
        state["mu"] = torch.zeros_like(p)
        state["nu"] = torch.zeros_like(p)

    def _update(self, state, p, g, group):
        b1, b2, count = group["b1"], group["b2"], state["step"]
        mu = state["mu"].mul_(b1).add_((1.0 - b1) * g)
        nu = state["nu"].mul_(b2).add_((1.0 - b2) * g * g)
        if group["nesterov"]:
            mu_hat = (b1 * _bias_corrected(mu, b1, count + 1)
                      + (1.0 - b1) * _bias_corrected(g, b1, count))
        else:
            mu_hat = _bias_corrected(mu, b1, count)
        u = mu_hat / (torch.sqrt(_bias_corrected(nu, b2, count)) + group["eps"])
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        return -group["lr"] * u


class OptaxAdamax(_OptaxRule):
    """``optax.adamax``: nu = max(|g| + eps, b2 nu) (eps outside the max),
    update -lr mu_hat / nu."""

    def _init(self, state, p, group):
        state["mu"] = torch.zeros_like(p)
        state["nu"] = torch.zeros_like(p)

    def _update(self, state, p, g, group):
        b1 = group["b1"]
        mu = state["mu"].mul_(b1).add_((1.0 - b1) * g)
        state["nu"] = torch.maximum(g.abs() + group["eps"], group["b2"] * state["nu"])
        return -group["lr"] * _bias_corrected(mu, b1, state["step"]) / state["nu"]


def _adam(params, lr, kwargs):
    return torch.optim.Adam(params, lr=lr,
                            betas=(kwargs.get("beta_1", 0.9), kwargs.get("beta_2", 0.999)),
                            eps=kwargs.get("epsilon", 1e-7))


def _sgd(params, lr, kwargs):
    # without momentum optax trains plain SGD whatever `nesterov` says
    momentum = kwargs.get("momentum", 0.0) or 0.0
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           nesterov=bool(kwargs.get("nesterov", False)) and momentum > 0)


def _rmsprop(params, lr, kwargs):
    return OptaxRMSprop(params, lr=lr, decay=kwargs.get("rho", 0.9),
                        eps=kwargs.get("epsilon", 1e-7),
                        momentum=kwargs.get("momentum", 0.0) or 0.0)


def _adam_family(nesterov: bool, weight_decay: float):
    def make(params, lr, kwargs):
        return OptaxAdam(params, lr=lr, b1=0.9, b2=0.999, eps=1e-8, nesterov=nesterov,
                         weight_decay=weight_decay)
    return make


# make_optimizer's rules by lower-cased name. Each one's update of an
# element reads only that element's gradient and state, so one optimizer
# over stacked machines' parameters steps each machine as its own optimizer
# would (the fleet trainer relies on it): a rule that is not elementwise
# does not belong here.
RULES = {
    "adam": _adam,
    "sgd": _sgd,
    "rmsprop": _rmsprop,
    "adagrad": lambda params, lr, _: OptaxAdagrad(params, lr=lr, initial_accumulator_value=0.1,
                                                  eps=1e-7),
    "nadam": _adam_family(nesterov=True, weight_decay=0.0),
    "adamw": _adam_family(nesterov=False, weight_decay=1e-4),
    "adamax": lambda params, lr, _: OptaxAdamax(params, lr=lr, b1=0.9, b2=0.999, eps=1e-8),
}


def make_optimizer(spec: OptimizerSpec, params) -> torch.optim.Optimizer:
    """A torch optimizer over ``params`` from a Keras-style optimizer spec,
    with the JAX package's arguments and optax's update rules.
    ``torch.optim.Adam`` and ``torch.optim.SGD`` apply the same updates as
    ``optax.adam`` and ``optax.sgd``; the others are written out above,
    where torch's own differ (RMSprop's eps, Adagrad's initial sum, NAdam's
    schedule, Adamax's eps, AdamW's default decay)."""
    kwargs = spec.as_dict()
    lr = kwargs.pop("learning_rate", kwargs.pop("lr", None))
    name = spec.name.lower()
    if name not in RULES:
        raise ValueError(f"Unknown optimizer {spec.name!r}")
    if lr is None:
        lr = 1e-2 if name == "sgd" else 1e-3
    return RULES[name](params, lr, kwargs)


def _loss_terms(spec: ModelSpec, model: torch.nn.Module, xb, yb, wb) -> torch.Tensor:
    """The loss of a batch: the per-sample loss averaged over the live
    samples (weight 1; padding has weight 0), plus the l1 activity penalty,
    which is unweighted: taken over the whole padded batch and divided by
    its size, as the JAX package's ``_loss_terms`` adds it. With stacked
    machines (``wb`` of shape (M, B)), one such loss per machine, each with
    its own machine's penalty."""
    out, penalty = model.forward_with_penalty(xb)
    if spec.loss in ("mse", "mean_squared_error"):
        per_sample = torch.mean((out - yb) ** 2, dim=-1)
    elif spec.loss in ("mae", "mean_absolute_error"):
        per_sample = torch.mean(torch.abs(out - yb), dim=-1)
    else:
        raise ValueError(f"Unknown loss {spec.loss!r}")
    loss = torch.sum(per_sample * wb, dim=-1) / torch.clamp(torch.sum(wb, dim=-1), min=1.0)
    return loss + penalty


def _gather_batch(spec: ModelSpec, X: torch.Tensor, y: torch.Tensor, idx: torch.Tensor):
    """A minibatch by sample (window-start) indices, gathered on the device.
    Stacked machines: X (M, rows, D), y (M, rows, D_out) and idx (M, B),
    machine m's batch from machine m's rows."""
    unwindowed = spec.lookback_window <= 1 and spec.lookahead == 0
    if X.dim() == 3:
        m = torch.arange(len(X), device=X.device)[:, None]
        if unwindowed:
            return X[m, idx], y[m, idx]  # (M, B, D)
        window = torch.arange(spec.lookback_window, device=X.device)
        target = idx + spec.lookback_window - 1 + spec.lookahead
        return X[m[..., None], idx[..., None] + window], y[m, target]  # (M, B, L, D)
    if unwindowed:
        return X[idx], y[idx]
    window = torch.arange(spec.lookback_window, device=X.device)
    target = idx + spec.lookback_window - 1 + spec.lookahead
    return X[idx[:, None] + window[None, :]], y[target]  # (B, L, D)


def _padded_stream(order: torch.Tensor, batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The order padded with zero-weighted repeats of sample 0 to whole
    batches, and its weights."""
    n = len(order)
    n_pad = max(math.ceil(n / batch_size), 1) * batch_size
    idx = torch.zeros(n_pad, dtype=torch.long, device=order.device)
    idx[:n] = order
    weights = torch.zeros(n_pad, dtype=torch.float32, device=order.device)
    weights[:n] = 1.0
    return idx, weights


def run_epoch(model: torch.nn.Module, optimizer: torch.optim.Optimizer, X: torch.Tensor,
              y: torch.Tensor, order: torch.Tensor, batch_size: int
              ) -> Tuple[float, torch.Tensor]:
    """One epoch of minibatch steps over the samples in ``order`` (window
    starts, on X's device), taken in that order. Returns the epoch loss
    (step losses weighted by live samples, as the JAX epoch returns it)
    and the step losses, each computed before its step's update."""
    spec = model.spec
    idx_stream, w_stream = _padded_stream(order.to(X.device), batch_size)
    step_losses, step_weights = [], []
    for start in range(0, len(idx_stream), batch_size):
        idx = idx_stream[start:start + batch_size]
        wb = w_stream[start:start + batch_size]
        xb, yb = _gather_batch(spec, X, y, idx)
        optimizer.zero_grad(set_to_none=True)
        loss = _loss_terms(spec, model, xb, yb, wb)
        loss.backward()
        optimizer.step()
        step_losses.append(loss.detach())
        step_weights.append(wb.sum())
    losses, weights = torch.stack(step_losses), torch.stack(step_weights)
    epoch_loss = (losses * weights).sum() / torch.clamp(weights.sum(), min=1.0)
    return float(epoch_loss), losses


def run_masked_epoch(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     X: torch.Tensor, y: torch.Tensor, orders: torch.Tensor, n_valid: int,
                     batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One epoch of M stacked machines (X (M, rows, D), y (M, rows, D_out)
    on the model's device), the counterpart of ``make_masked_epoch_fn``.
    ``orders`` (M, n_max) holds each machine's valid-first sample order:
    its first ``n_valid`` entries are the live samples, in the order they
    are taken. Slots past them point at sample 0 with weight 0, the stream
    is padded to whole batches, and only the ``ceil(n_valid / batch)`` live
    steps run (a bucket's machines share ``n_valid``). Returns each
    machine's epoch loss (M,) and the step losses (steps, M), each computed
    before its step's update."""
    spec = model.spec
    orders = orders.to(X.device)
    n_max = orders.shape[1]
    if not bool((orders[:, :n_valid] < n_valid).all()):
        raise ValueError(f"orders are not valid-first: a live slot is past n_valid={n_valid}")
    n_steps = max(math.ceil(n_max / batch_size), 1)
    live = orders < n_valid
    idx_stream = torch.zeros((len(orders), n_steps * batch_size), dtype=torch.long,
                             device=X.device)
    idx_stream[:, :n_max] = torch.where(live, orders, 0)
    w_stream = torch.zeros(idx_stream.shape, dtype=torch.float32, device=X.device)
    w_stream[:, :n_max] = live.float()
    n_live_steps = min(max(math.ceil(n_valid / batch_size), 1), n_steps)
    step_losses, step_weights = [], []
    for start in range(0, n_live_steps * batch_size, batch_size):
        idx = idx_stream[:, start:start + batch_size]
        wb = w_stream[:, start:start + batch_size]
        xb, yb = _gather_batch(spec, X, y, idx)
        optimizer.zero_grad(set_to_none=True)
        losses = _loss_terms(spec, model, xb, yb, wb)
        losses.sum().backward()
        optimizer.step()
        step_losses.append(losses.detach())
        step_weights.append(wb.sum(dim=-1))
    losses, weights = torch.stack(step_losses), torch.stack(step_weights)
    epoch_losses = (losses * weights).sum(dim=0) / torch.clamp(weights.sum(dim=0), min=1.0)
    return epoch_losses, losses


def evaluate_loss(model: torch.nn.Module, X: torch.Tensor, y: torch.Tensor,
                  batch_size: int = EVAL_BATCH) -> float:
    """The loss over every sample of (X, y), in batches of ``batch_size``
    without gradients, the last batch padded with zero-weighted repeats of
    sample 0, as the JAX package pads it (the activity penalty is taken
    over the padded batch)."""
    spec = model.spec
    n = n_train_samples(spec, len(X))
    loss_sum = torch.zeros((), device=X.device)
    with torch.no_grad():
        for start in range(0, n, batch_size):
            idx, wb = _padded_stream(
                torch.arange(start, min(start + batch_size, n), device=X.device), batch_size)
            xb, yb = _gather_batch(spec, X, y, idx)
            loss_sum += _loss_terms(spec, model, xb, yb, wb) * wb.sum()
    return float(loss_sum / max(n, 1))


@dataclass
class TrainResult:
    history: Dict[str, List[float]] = field(default_factory=dict)
    epochs_trained: int = 0


def fit_arrays(
    model: torch.nn.Module,
    X: np.ndarray,
    y: np.ndarray,
    *,
    epochs: int = 1,
    batch_size: int = 32,
    shuffle: bool = True,
    validation_split: float = 0.0,
    generator: Optional[torch.Generator] = None,
    callbacks: Optional[List] = None,
) -> TrainResult:
    """Train ``model`` (a TransformerModel, in place) on (X, y): a host loop
    over epochs with a Keras-style ``validation_split`` (the last rows are
    held out) and EarlyStopping-style callbacks. Each shuffled epoch's order
    is ``torch.randperm`` on ``generator`` (a CPU generator)."""
    spec: ModelSpec = model.spec
    device = next(model.parameters()).device
    X = torch.as_tensor(np.asarray(X, np.float32), device=device)
    y = torch.as_tensor(np.asarray(y, np.float32), device=device)
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    callbacks = callbacks or []

    n_rows = len(X)
    X_val = y_val = None
    if validation_split and 0.0 < validation_split < 1.0:
        split = max(int(n_rows * (1.0 - validation_split)), 1)
        X, X_val = X[:split], X[split:]
        y, y_val = y[:split], y[split:]

    n_samples = n_train_samples(spec, len(X))
    if n_samples <= 0:
        raise ValueError(
            f"Not enough rows ({len(X)}) for lookback_window="
            f"{spec.lookback_window} lookahead={spec.lookahead}"
        )
    batch_size = min(batch_size, n_samples)
    optimizer = make_optimizer(spec.optimizer, model.parameters())
    n_val = 0 if X_val is None else n_train_samples(spec, len(X_val))

    history: Dict[str, List[float]] = {"loss": []}
    if X_val is not None:
        history["val_loss"] = []
    for cb in callbacks:
        if hasattr(cb, "on_train_begin"):
            cb.on_train_begin()

    epochs_trained = 0
    for epoch in range(epochs):
        if shuffle:
            order = torch.randperm(n_samples, generator=generator)
        else:
            order = torch.arange(n_samples)
        loss, _ = run_epoch(model, optimizer, X, y, order, batch_size)
        logs = {"loss": loss}
        if n_val > 0:
            logs["val_loss"] = evaluate_loss(model, X_val, y_val)
        for key, value in logs.items():
            history.setdefault(key, []).append(value)
        epochs_trained = epoch + 1
        stop = False
        for cb in callbacks:
            if hasattr(cb, "on_epoch_end") and cb.on_epoch_end(epoch, logs, model):
                stop = True
        if stop:
            break

    for cb in callbacks:
        if hasattr(cb, "on_train_end"):
            restored = cb.on_train_end(model)
            if restored is not None:
                model.load_state_dict(restored)
    return TrainResult(history=history, epochs_trained=epochs_trained)
