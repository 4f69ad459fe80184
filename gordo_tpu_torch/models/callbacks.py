"""
Training callbacks for the epoch loop of ``ops/train.py``: the port's
counterpart of ``gordo_tpu/models/callbacks.py``.
"""

from typing import Optional

import numpy as np


class EarlyStopping:
    """Stop training when a monitored metric has stopped improving."""

    def __init__(
        self,
        monitor: str = "val_loss",
        min_delta: float = 0.0,
        patience: int = 0,
        mode: str = "auto",
        restore_best_weights: bool = False,
        **kwargs,
    ):
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.patience = patience
        self.restore_best_weights = restore_best_weights
        self.mode = mode
        self._wait = 0
        self._best: Optional[float] = None
        self._best_state = None

    def get_params(self, deep=False):
        return {
            "monitor": self.monitor,
            "min_delta": self.min_delta,
            "patience": self.patience,
            "restore_best_weights": self.restore_best_weights,
        }

    def on_train_begin(self):
        self._wait = 0
        self._best = None
        self._best_state = None

    def on_epoch_end(self, epoch: int, logs: dict, model) -> bool:
        current = logs.get(self.monitor, logs.get("loss"))
        if current is None or not np.isfinite(current):
            return False
        if self._best is None or current < self._best - self.min_delta:
            self._best = current
            self._wait = 0
            if self.restore_best_weights:
                # a copy: the optimizer updates the live tensors in place
                self._best_state = {
                    name: value.detach().clone()
                    for name, value in model.state_dict().items()
                }
            return False
        self._wait += 1
        return self._wait >= self.patience

    def on_train_end(self, model):
        """The best epoch's state dict when it is to be restored, else None."""
        if self.restore_best_weights and self._best_state is not None:
            return self._best_state
        return None
