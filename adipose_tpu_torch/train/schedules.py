"""Learning-rate schedules and early stopping mirroring the reference's
callbacks: a copy of ``adipose_tpu/train/schedules.py`` without the cyclic
schedule, which the U-Net trainer does not use.

* ``cosine_with_warmup`` (``CosineAnnealingWithWarmup``,
  ``train_adipose_unet_v3.py:368-407``): epoch-based; the warmup is linear
  from max_lr / warmup_epochs, then cosine from max_lr to min_lr.
* ``ReduceLROnPlateau`` (Keras, :1306-1315): factor 0.5, patience 5, max
  mode on the validation Dice.
* ``EarlyStopping`` (Keras, patience 15, :1279-1285).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


def cosine_with_warmup(max_lr: float, min_lr: float, warmup_epochs: int, total_epochs: int):
    """Epoch-indexed schedule function (reference :390-399 semantics)."""

    def schedule(epoch: int) -> float:
        if epoch < warmup_epochs:
            return (max_lr / warmup_epochs) * (epoch + 1)
        denom = max(total_epochs - warmup_epochs, 1)
        progress = (epoch - warmup_epochs) / denom
        return min_lr + 0.5 * (max_lr - min_lr) * (1 + math.cos(math.pi * progress))

    return schedule


@dataclass
class ReduceLROnPlateau:
    """Host-side plateau scheduler (Keras semantics, max mode). Call
    ``update(metric)`` once per epoch; read ``.lr``."""

    lr: float
    factor: float = 0.5
    patience: int = 5
    min_lr: float = 1e-7
    min_delta: float = 1e-4
    mode: str = "max"
    best: float = field(default=None)
    wait: int = 0

    def update(self, metric: float) -> float:
        if self.best is None:
            self.best = metric
            return self.lr
        improved = (metric > self.best + self.min_delta if self.mode == "max"
                    else metric < self.best - self.min_delta)
        if improved:
            self.best = metric
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.wait = 0
        return self.lr


@dataclass
class EarlyStopping:
    """Keras EarlyStopping (max mode; the trainer restores the best weights
    from its checkpoints)."""

    patience: int = 15
    min_delta: float = 0.0
    mode: str = "max"
    best: float = field(default=None)
    wait: int = 0
    stopped: bool = False
    best_epoch: int = -1

    def update(self, metric: float, epoch: int) -> bool:
        """Returns True when training should stop."""
        improved = self.best is None or (
            metric > self.best + self.min_delta if self.mode == "max"
            else metric < self.best - self.min_delta)
        if improved:
            self.best = metric
            self.best_epoch = epoch
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped = True
        return self.stopped
